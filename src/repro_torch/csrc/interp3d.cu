// Interpolation predictor kernels for Hopper (sm_90a): encode and decode.
//
// Replaces the TPU kernel src/repro/kernels/interp3d/interp3d.py::_kernel
// (pallas_call via interp3d_compress): fused hierarchical spline prediction
// plus error-bound quantization over a batch of closed 17^ndim blocks.
// The decode kernel is the replay of repro.core.predictor.decompress_blocks,
// which the TPU package runs as plain jnp.
//
// What bounds it on the H100: by bytes, device memory (encode reads the
// f32 block and writes the u8 codes, 5 B per block point, plus the f32
// recon when asked; decode reads the u8 codes, the block's few anchors and
// its outliers and writes the f32 recon); the arithmetic is at most 12
// multiply-adds per point, far below the card's fp32 rate. In practice the
// limit is instruction issue on the SM: every tap is a shared-memory load
// with its address math, and each point reads the step tables. So the
// design keeps all of that in shared memory and cuts the instructions per
// point:
//
// - The shape is a compile-time constant: both kernels are templates on the
//   block rank (1-3) and the anchor stride (16, 8, 4), so every division of
//   an index by 17 or a stride is a multiply by a constant.
// - One f32 tile per block, updated in place. Every non-anchor point is the
//   target of exactly one step, and every tap reads an anchor or the target
//   of an earlier step (pack_steps checks both), so the encoder loads the
//   original values and overwrites each target with its reconstruction, and
//   the decoder places anchors and outliers first and fills the rest.
// - The step tables live in shared memory, loaded once per CTA: per target
//   point 2 B (flat index | used-dims mask << 13; the blend weight is
//   1 / popcount(mask)); per level and operator row one 32-bit word (tap
//   count, columns and pattern); per level and pattern (distinct row, at
//   most 4) one float4 of coefficients, so that a warp's coefficient loads
//   touch few distinct words.
// - A step's points are ordered by used-dims mask (pack_steps), so that a
//   warp's threads take the same dims and do not diverge.
// - Persistent CTAs: the host launches as many CTAs as are resident at once
//   and each walks a contiguous run of blocks, so the tables are loaded once
//   per CTA and the decoder finds each block's outliers with a cursor that
//   only moves forward (one binary search per CTA).
// - A 3-D block takes the whole CTA (256 threads), with a barrier after
//   each step. 2-D and 1-D blocks take a warp and 8 lanes, so 8 or 32
//   blocks share a CTA and every step is warp-synchronous.
//
// Encode and decode run the same predict() with the same operation order
// and round every product and sum on its own (__fmul_rn / __fadd_rn: no FMA
// contraction), so on the card decode(encode(x)) reproduces the encoder's
// recon bit for bit, and both equal repro_torch.core.predictor's plain
// versions, which apply the taps in this order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 17;
constexpr int kThreads = 256;
constexpr float kRadius = 127.0f;
constexpr int kCenter = 128;
constexpr int kPatterns = 4;  // distinct rows of one level's operator

constexpr int ipow(int b, int e) { return e == 0 ? 1 : b * ipow(b, e - 1); }
constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }
constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Stride of dim d in a 17^NDIM block. Written as constants so that, in a
// loop over d the compiler unrolls, every use folds to an immediate (a
// call of the recursive ipow there stays a runtime loop and division).
template <int NDIM>
__device__ __forceinline__ int stride_of(int d) {
  return d == NDIM - 1 ? 1 : (d == NDIM - 2 ? kB : kB * kB);
}

// Everything the kernels know about one (rank, anchor stride) pair.
template <int NDIM, int EVERY>
struct Shape {
  static constexpr int V = ipow(kB, NDIM);                  // points per block
  static constexpr int A = (kB - 1) / EVERY + 1;            // anchors per dim
  static constexpr int NA = ipow(A, NDIM);                  // anchors per block
  static constexpr int NP = V - NA;                         // target points per block
  static constexpr int L = ilog2(EVERY);                    // levels (operators)
  static constexpr int MAXS = NDIM * L;                     // steps at most
  static constexpr int TPB = NDIM == 3 ? 256 : (NDIM == 2 ? 32 : 8);  // threads per block
  static constexpr int G = kThreads / TPB;                  // blocks per CTA
  static constexpr int GV = G * V;                          // tile points per CTA
  // the table image, int32 words in this order (ops.py packs the same):
  // coef [L][kPatterns][4] f32, meta [L][kB], step_off [MAXS + 1],
  // step_op [MAXS], pts [NP rounded up to even] u16; then the tile and the
  // codes
  static constexpr int kCoefWords = L * kPatterns * 4;
  static constexpr int kMetaWords = L * kB;
  static constexpr int kPtsWords = (NP + 1) / 2;
  static constexpr int kTableWords = kCoefWords + kMetaWords + (MAXS + 1) + MAXS + kPtsWords;
  static constexpr int kTableBytes = round_up(kTableWords * 4, 16);
  static constexpr int kTileBytes = round_up(GV * 4, 16);
  static constexpr int kCodeBytes = round_up(GV, 16);
};

template <int NDIM, int EVERY>
struct Tables {
  using S = Shape<NDIM, EVERY>;
  const float4* coef;  // [L][kPatterns]
  const int* meta;     // [L][kB]: tap count | column t << (3 + 5 t) | pattern << 23
  const int* step_off;
  const int* step_op;
  const uint16_t* pts;

  __device__ explicit Tables(const unsigned char* base)
      : coef(reinterpret_cast<const float4*>(base)),
        meta(reinterpret_cast<const int*>(base) + S::kCoefWords),
        step_off(meta + S::kMetaWords),
        step_op(step_off + S::MAXS + 1),
        pts(reinterpret_cast<const uint16_t*>(step_op + S::MAXS)) {}
};

// Copies the table image into shared memory (every thread takes a share).
template <int NDIM, int EVERY>
__device__ __forceinline__ void load_tables(unsigned char* smem, const int* __restrict__ image) {
  int* dst = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < Shape<NDIM, EVERY>::kTableWords; i += kThreads) dst[i] = image[i];
}

// pred = sum over used dims d (ascending) of w * (sum over taps of coef * tile[tap]),
// w = 1 / (number of used dims), each product and sum rounded to fp32 on its own.
template <int NDIM>
__device__ __forceinline__ float predict(const float* tile, int idx, int dmask, const float4* coef,
                                         const int* meta) {
  int c[NDIM];
  int rem = idx;
#pragma unroll
  for (int d = 0; d < NDIM; ++d) {
    const int sd = stride_of<NDIM>(d);
    c[d] = rem / sd;
    rem -= c[d] * sd;
  }
  const int used = __popc(dmask);
  const float w = used == 1 ? 1.0f : (used == 2 ? 0.5f : 0x1.555556p-2f);  // fp32(1/3), as the tables hold
  float pred = 0.0f;
#pragma unroll
  for (int d = 0; d < NDIM; ++d) {
    if (dmask & (1 << d)) {
      const int sd = stride_of<NDIM>(d);
      const int m = meta[c[d]];
      const float4 k = coef[(m >> 23) & (kPatterns - 1)];
      const int n = m & 7;
      const float* row = tile + (idx - c[d] * sd);
      float acc = 0.0f;
      // a target's row has 2 (linear), 3 or 4 taps (pack_steps checks): the
      // third and fourth sit behind a branch that a warp of linear rows skips
      acc = __fadd_rn(acc, __fmul_rn(k.x, row[((m >> 3) & 31) * sd]));
      acc = __fadd_rn(acc, __fmul_rn(k.y, row[((m >> 8) & 31) * sd]));
      if (n > 2) {
        acc = __fadd_rn(acc, __fmul_rn(k.z, row[((m >> 13) & 31) * sd]));
        if (n > 3) acc = __fadd_rn(acc, __fmul_rn(k.w, row[((m >> 18) & 31) * sd]));
      }
      pred = __fadd_rn(pred, __fmul_rn(w, acc));
    }
  }
  return pred;
}

// One step over one block's tile, points strided over `lanes` threads.
// Encode: quantize against the original value in the tile and write the
// reconstruction over it. Decode: replay the code; a code-0 point keeps the
// outlier value (or 0) placed before the first step.
template <int NDIM, int EVERY, bool ENCODE>
__device__ __forceinline__ void run_step(const Tables<NDIM, EVERY>& tb, int k, int lane, int lanes, float* tile,
                                         uint8_t* code, float twoeb, float inv2eb) {
  const int op = tb.step_op[k];
  const float4* coef = tb.coef + op * kPatterns;
  const int* meta = tb.meta + op * kB;
  const int end = tb.step_off[k + 1];
  for (int p = tb.step_off[k] + lane; p < end; p += lanes) {
    const int pt = tb.pts[p];
    const int idx = pt & 0x1FFF;
    if constexpr (ENCODE) {
      const float pred = predict<NDIM>(tile, idx, pt >> 13, coef, meta);
      const float o = tile[idx];
      // quantize_pred: q = rint((orig - pred) * inv2eb); outlier iff |q| > 127
      const float q = rintf(__fmul_rn(__fsub_rn(o, pred), inv2eb));
      const bool out = fabsf(q) > kRadius;
      tile[idx] = out ? o : __fadd_rn(pred, __fmul_rn(q, twoeb));
      code[idx] = out ? 0 : (uint8_t)((int)q + kCenter);
    } else {
      const int c = code[idx];
      if (c != 0) {
        const float pred = predict<NDIM>(tile, idx, pt >> 13, coef, meta);
        tile[idx] = __fadd_rn(pred, __fmul_rn((float)(c - kCenter), twoeb));
      }
    }
  }
}

// All steps over the CTA's tile; returns after a CTA barrier, so the tile
// is complete for every thread.
template <int NDIM, int EVERY, bool ENCODE>
__device__ __forceinline__ void run_steps(const Tables<NDIM, EVERY>& tb, int n_steps, float* tile, uint8_t* code,
                                          float twoeb, float inv2eb) {
  using S = Shape<NDIM, EVERY>;
  if constexpr (S::TPB <= 32) {
    // a block's threads share a warp: each block owns V points of the tile
    const int slot = threadIdx.x / S::TPB, lane = threadIdx.x % S::TPB;
    for (int k = 0; k < n_steps; ++k) {
      run_step<NDIM, EVERY, ENCODE>(tb, k, lane, S::TPB, tile + slot * S::V, code + slot * S::V, twoeb, inv2eb);
      __syncwarp();
    }
    __syncthreads();
  } else {
    for (int k = 0; k < n_steps; ++k) {
      run_step<NDIM, EVERY, ENCODE>(tb, k, threadIdx.x, kThreads, tile, code, twoeb, inv2eb);
      __syncthreads();
    }
  }
}

// The CTA's contiguous run of groups (G blocks each) out of ng.
__device__ __forceinline__ void group_range(long long ng, long long* begin, long long* end) {
  *begin = (long long)blockIdx.x * ng / gridDim.x;
  *end = ((long long)blockIdx.x + 1) * ng / gridDim.x;
}

template <int NDIM, int EVERY>
__global__ void __launch_bounds__(kThreads)
interp_encode_kernel(const float* __restrict__ blocks, uint8_t* __restrict__ codes, float* __restrict__ recon,
                     long long nb, float twoeb, float inv2eb, const int* __restrict__ image, int n_steps) {
  using S = Shape<NDIM, EVERY>;
  extern __shared__ __align__(16) unsigned char smem[];
  load_tables<NDIM, EVERY>(smem, image);
  const Tables<NDIM, EVERY> tb(smem);
  float* tile = reinterpret_cast<float*>(smem + S::kTableBytes);
  uint8_t* code = smem + S::kTableBytes + S::kTileBytes;
  // anchors keep the center code; every other point gets its code from its step
  for (int i = threadIdx.x; i < S::GV; i += kThreads) code[i] = kCenter;
  long long g0, g1;
  group_range((nb + S::G - 1) / S::G, &g0, &g1);
  const long long total = nb * S::V;
  for (long long g = g0; g < g1; ++g) {
    const long long base = g * S::GV;
    const int n = total - base < S::GV ? (int)(total - base) : S::GV;  // points of this group in the batch
    const float* src = blocks + base;
    // each thread loads and later stores the same tile points, so the store of
    // one block and the load of the next need no barrier between them
#pragma unroll 8
    for (int i = threadIdx.x; i < S::GV; i += kThreads) tile[i] = i < n ? src[i] : 0.0f;
    __syncthreads();
    run_steps<NDIM, EVERY, true>(tb, n_steps, tile, code, twoeb, inv2eb);
    for (int i = threadIdx.x; i < n; i += kThreads) codes[base + i] = code[i];
    if (recon != nullptr)
      for (int i = threadIdx.x; i < n; i += kThreads) recon[base + i] = tile[i];
  }
}

// The first index of the ascending keys[0, n) at or after key.
__device__ long long lower_bound(const long long* keys, long long n, long long key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int NDIM, int EVERY>
__device__ __forceinline__ bool is_anchor(int idx) {
#pragma unroll
  for (int d = 0; d < NDIM; ++d) {
    if ((idx % kB) % EVERY) return false;
    idx /= kB;
  }
  return true;
}

// Flat index in its block of anchor `slot` (row-major over A^NDIM anchors).
template <int NDIM, int EVERY>
__device__ __forceinline__ int anchor_index(int slot) {
  using S = Shape<NDIM, EVERY>;
  int idx = 0;
#pragma unroll
  for (int d = NDIM - 1; d >= 0; --d) {
    idx += (slot % S::A) * EVERY * stride_of<NDIM>(d);
    slot /= S::A;
  }
  return idx;
}

template <int NDIM, int EVERY>
__global__ void __launch_bounds__(kThreads)
interp_decode_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ anchors,
                     const long long* __restrict__ okeys, const float* __restrict__ ovals, long long n_out,
                     float* __restrict__ recon, long long nb, float twoeb, const int* __restrict__ image,
                     int n_steps) {
  using S = Shape<NDIM, EVERY>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long cursor0;
  load_tables<NDIM, EVERY>(smem, image);
  const Tables<NDIM, EVERY> tb(smem);
  float* tile = reinterpret_cast<float*>(smem + S::kTableBytes);
  uint8_t* code = smem + S::kTableBytes + S::kTileBytes;
  long long g0, g1;
  group_range((nb + S::G - 1) / S::G, &g0, &g1);
  const long long total = nb * S::V;
  if (threadIdx.x == 0) cursor0 = lower_bound(okeys, n_out, g0 * S::GV);
  __syncthreads();
  long long cur = cursor0;  // the first outlier not yet placed; keys ascend
  for (long long g = g0; g < g1; ++g) {
    const long long base = g * S::GV;
    const int n = total - base < S::GV ? (int)(total - base) : S::GV;  // points of this group in the batch
    const long long key_end = base + n;
    const uint8_t* src = codes + base;
#pragma unroll 8
    for (int i = threadIdx.x; i < S::GV; i += kThreads) {
      code[i] = i < n ? src[i] : kCenter;
      tile[i] = 0.0f;  // a code-0 point without a stored value replays as 0
    }
    long long k = cur + threadIdx.x;
    long long key = k < n_out ? okeys[k] : key_end;
    __syncthreads();
    for (int j = threadIdx.x; j < S::G * S::NA; j += kThreads) {
      const long long b = g * S::G + j / S::NA;
      if (b < nb) tile[(j / S::NA) * S::V + anchor_index<NDIM, EVERY>(j % S::NA)] = anchors[b * S::NA + j % S::NA];
    }
    // this group's outliers, in rounds of kThreads keys; the last round is short
    for (;;) {
      const bool mine = key < key_end;
      if (mine) {  // a code-0 point takes its value; anchors keep theirs, as in the plain replay
        const int at = (int)(key - base);
        if (code[at] == 0 && !is_anchor<NDIM, EVERY>(at % S::V)) tile[at] = ovals[k];
      }
      const int placed = __syncthreads_count(mine);
      cur += placed;
      if (placed < kThreads) break;
      k = cur + threadIdx.x;
      key = k < n_out ? okeys[k] : key_end;
    }
    run_steps<NDIM, EVERY, false>(tb, n_steps, tile, code, twoeb, 0.0f);
    for (int i = threadIdx.x; i < n; i += kThreads) recon[base + i] = tile[i];
  }
}

// Dynamic shared memory of both kernels: the tables, the tile and the codes.
template <int NDIM, int EVERY>
constexpr int smem_bytes() {
  using S = Shape<NDIM, EVERY>;
  return S::kTableBytes + S::kTileBytes + S::kCodeBytes;
}

// Launches `kern` with one CTA per resident slot (at most one per group),
// with the SM's L1/shared split set to the most shared memory, so that as
// many CTAs are resident as the occupancy query counts.
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kern, int smem, long long groups, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long slots = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(groups < slots ? groups : slots);
  kern<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int NDIM, int EVERY>
int encode(const float* blocks, uint8_t* codes, float* recon, long long nb, float twoeb, float inv2eb,
           const int* image, int n_steps, cudaStream_t stream) {
  using S = Shape<NDIM, EVERY>;
  return launch_persistent(interp_encode_kernel<NDIM, EVERY>, smem_bytes<NDIM, EVERY>(), (nb + S::G - 1) / S::G,
                           stream, blocks, codes, recon, nb, twoeb, inv2eb, image, n_steps);
}

template <int NDIM, int EVERY>
int decode(const uint8_t* codes, const float* anchors, const long long* okeys, const float* ovals, long long n_out,
           float* recon, long long nb, float twoeb, const int* image, int n_steps, cudaStream_t stream) {
  using S = Shape<NDIM, EVERY>;
  return launch_persistent(interp_decode_kernel<NDIM, EVERY>, smem_bytes<NDIM, EVERY>(), (nb + S::G - 1) / S::G,
                           stream, codes, anchors, okeys, ovals, n_out, recon, nb, twoeb, image, n_steps);
}

template <int NDIM, int EVERY>
bool steps_fit(int n_steps) {
  return n_steps >= 1 && n_steps <= Shape<NDIM, EVERY>::MAXS;
}

}  // namespace

// Dispatch over the nine (rank, anchor stride) instantiations; anything
// else is cudaErrorInvalidValue.
#define INTERP_DISPATCH(ndim, every, CALL, OTHERWISE) \
  switch ((ndim) * 100 + (every)) {                    \
    case 116: return CALL(1, 16);                      \
    case 108: return CALL(1, 8);                       \
    case 104: return CALL(1, 4);                       \
    case 216: return CALL(2, 16);                      \
    case 208: return CALL(2, 8);                       \
    case 204: return CALL(2, 4);                       \
    case 316: return CALL(3, 16);                      \
    case 308: return CALL(3, 8);                       \
    case 304: return CALL(3, 4);                       \
    default: return OTHERWISE;                         \
  }

// C interface (ctypes). Every pointer is device memory; the launch goes on
// `stream` and the return value is the first CUDA error of the launch
// (cudaGetLastError() right after it), 0 on success.

// Words of the step-table image for (ndim, every), -1 if unsupported.
extern "C" int interp_table_words(int ndim, int every) {
#define WORDS(N, E) Shape<N, E>::kTableWords
  INTERP_DISPATCH(ndim, every, WORDS, -1)
#undef WORDS
}

// `recon` may be null: the encoder then writes the codes only.
extern "C" int interp_encode(const float* blocks, uint8_t* codes, float* recon, long long nb, int ndim, int every,
                             float twoeb, float inv2eb, const int* image, int n_steps, void* stream) {
  if (nb <= 0) return (int)cudaErrorInvalidValue;
#define ENC(N, E)                                                                                          \
  (steps_fit<N, E>(n_steps)                                                                                \
       ? encode<N, E>(blocks, codes, recon, nb, twoeb, inv2eb, image, n_steps, (cudaStream_t)stream)       \
       : (int)cudaErrorInvalidValue)
  INTERP_DISPATCH(ndim, every, ENC, (int)cudaErrorInvalidValue)
#undef ENC
}

// `anchors`: nb x (16/every + 1)^ndim; `okeys` ascending, n_out of them.
extern "C" int interp_decode(const uint8_t* codes, const float* anchors, const long long* okeys, const float* ovals,
                             long long n_out, float* recon, long long nb, int ndim, int every, float twoeb,
                             const int* image, int n_steps, void* stream) {
  if (nb <= 0 || n_out < 0) return (int)cudaErrorInvalidValue;
#define DEC(N, E)                                                                                          \
  (steps_fit<N, E>(n_steps)                                                                                \
       ? decode<N, E>(codes, anchors, okeys, ovals, n_out, recon, nb, twoeb, image, n_steps,               \
                      (cudaStream_t)stream)                                                                \
       : (int)cudaErrorInvalidValue)
  INTERP_DISPATCH(ndim, every, DEC, (int)cudaErrorInvalidValue)
#undef DEC
}
