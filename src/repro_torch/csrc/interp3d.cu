// Interpolation predictor kernels for Hopper (sm_90a): encode and decode.
//
// Replaces the TPU kernel src/repro/kernels/interp3d/interp3d.py::_kernel
// (pallas_call via interp3d_compress): fused hierarchical spline prediction
// plus error-bound quantization over a batch of closed 17^ndim blocks.
// The decode kernel is the replay of repro.core.predictor.decompress_blocks,
// which the TPU package runs as plain jnp.
//
// What bounds it on the H100: memory. Encode reads the f32 block and writes
// the u8 codes (5 B per block point), plus the f32 recon (4 B more) when the
// caller asks for it; decode reads the u8 codes, the block's few anchors and
// its outliers, and writes the f32 recon (about 5 B per point). The
// arithmetic is at most 12 multiply-adds per point, about one operation per
// byte, far below the card's ~20 fp32 operations per byte. The TPU kernel
// contracts (17,17) banded matrices on the MXU; here each point reads its at
// most four taps per dim straight from shared memory.
//
// Design: one CTA per block. The block's reconstruction (17^3 f32, 19.6 KB)
// and its original values live in shared memory, loaded and stored with
// coalesced sweeps; a CTA walks the steps in order, with a barrier after
// each, and its threads stride over the step's target points. The host
// packs per (steps, anchor stride) a point list (flat index | used-dims
// mask << 16, one blend weight per point) and, per step, the banded row of
// the spline operator (tap count, columns, coefficients). The decoder takes
// the anchors per block, (16/every + 1)^ndim of them, and the outliers as
// ascending keys block * 17^ndim + cell with their values; a code-0 point
// finds its value by binary search, so no dense anchor or outlier grid is
// ever built.
//
// Encode and decode call the same __device__ predict() with the same
// operation order, and round every product and sum on its own
// (__fmul_rn / __fadd_rn: no FMA contraction), so on the card
// decode(encode(x)) reproduces the encoder's recon bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 17;
constexpr int kMaxV = kB * kB * kB;  // 4913 points in a 3-D block
constexpr int kThreads = 256;
constexpr float kRadius = 127.0f;
constexpr int kCenter = 128;
constexpr int kTaps = 4;

struct Tables {
  const int32_t* pts;       // per target point: flat index | used-dims mask << 16
  const float* wts;         // per target point: the blend weight shared by its used dims
  const int32_t* step_off;  // n_steps + 1 offsets into pts/wts
  const uint8_t* tapn;      // [n_steps][kB] taps in row c of the step's operator
  const int8_t* tapj;       // [n_steps][kB][kTaps] tap columns, ascending
  const float* tapw;        // [n_steps][kB][kTaps] tap coefficients
  int n_steps;
};

__device__ __forceinline__ int volume(int ndim) {
  return ndim == 3 ? kB * kB * kB : (ndim == 2 ? kB * kB : kB);
}

__device__ __forceinline__ bool is_anchor(int idx, int ndim, int every) {
  for (int d = 0; d < ndim; ++d) {
    if ((idx % kB) % every) return false;
    idx /= kB;
  }
  return true;
}

// Row-major slot of anchor point idx among the block's (16/every + 1)^ndim anchors.
__device__ __forceinline__ int anchor_slot(int idx, int ndim, int every) {
  const int na = (kB - 1) / every + 1;
  int slot = 0, scale = 1;
  for (int d = 0; d < ndim; ++d) {  // last dim first
    slot += ((idx % kB) / every) * scale;
    scale *= na;
    idx /= kB;
  }
  return slot;
}

// The value stored for the outlier at `key` (ascending keys), 0 if the
// container holds none: the value a dense outlier grid would give.
__device__ __forceinline__ float outlier_value(const long long* keys, const float* vals, long long n,
                                               long long key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return (lo < n && keys[lo] == key) ? vals[lo] : 0.0f;
}

// pred = sum over used dims d (ascending) of w * (sum over taps of coef * rec[tap]),
// each product and sum rounded to fp32 on its own.
__device__ __forceinline__ float predict(const float* rec, int idx, int dmask, float w,
                                         const uint8_t* tn, const int8_t* tj, const float* tw,
                                         int ndim) {
  float pred = 0.0f;
  int sd = ndim == 3 ? kB * kB : (ndim == 2 ? kB : 1);
  int rem = idx;
  for (int d = 0; d < ndim; ++d) {
    const int c = rem / sd;
    rem -= c * sd;
    if (dmask & (1 << d)) {
      const int base = idx - c * sd;
      float acc = 0.0f;
      const int n = tn[c];
      for (int t = 0; t < n; ++t) {
        acc = __fadd_rn(acc, __fmul_rn(tw[c * kTaps + t], rec[base + tj[c * kTaps + t] * sd]));
      }
      pred = __fadd_rn(pred, __fmul_rn(w, acc));
    }
    sd /= kB;
  }
  return pred;
}

__global__ void __launch_bounds__(kThreads)
interp_encode_kernel(const float* __restrict__ blocks, uint8_t* __restrict__ codes,
                     float* __restrict__ recon, int ndim, int every, float twoeb, float inv2eb,
                     Tables tb) {
  __shared__ float orig_s[kMaxV];
  __shared__ float rec_s[kMaxV];
  __shared__ uint8_t code_s[kMaxV];
  const int V = volume(ndim);
  const size_t base = (size_t)blockIdx.x * V;
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    const float v = blocks[base + i];
    orig_s[i] = v;
    rec_s[i] = is_anchor(i, ndim, every) ? v : 0.0f;
    code_s[i] = kCenter;
  }
  __syncthreads();
  for (int k = 0; k < tb.n_steps; ++k) {
    const uint8_t* tn = tb.tapn + k * kB;
    const int8_t* tj = tb.tapj + k * kB * kTaps;
    const float* tw = tb.tapw + k * kB * kTaps;
    const int end = tb.step_off[k + 1];
    for (int p = tb.step_off[k] + threadIdx.x; p < end; p += blockDim.x) {
      const int rec = tb.pts[p];
      const int idx = rec & 0xFFFF;
      const float pred = predict(rec_s, idx, rec >> 16, tb.wts[p], tn, tj, tw, ndim);
      const float o = orig_s[idx];
      // quantize_pred: q = rint((orig - pred) * inv2eb); outlier iff |q| > 127
      const float q = rintf(__fmul_rn(__fsub_rn(o, pred), inv2eb));
      const bool out = fabsf(q) > kRadius;
      rec_s[idx] = out ? o : __fadd_rn(pred, __fmul_rn(q, twoeb));
      code_s[idx] = out ? 0 : (uint8_t)((int)q + kCenter);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < V; i += blockDim.x) codes[base + i] = code_s[i];
  if (recon != nullptr) {
    for (int i = threadIdx.x; i < V; i += blockDim.x) recon[base + i] = rec_s[i];
  }
}

__global__ void __launch_bounds__(kThreads)
interp_decode_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ anchors,
                     const long long* __restrict__ okeys, const float* __restrict__ ovals,
                     long long n_out, float* __restrict__ recon, int ndim, int every, float twoeb,
                     Tables tb) {
  __shared__ float rec_s[kMaxV];
  __shared__ uint8_t code_s[kMaxV];
  const int V = volume(ndim);
  const size_t base = (size_t)blockIdx.x * V;
  int n_anchor = 1;
  for (int d = 0; d < ndim; ++d) n_anchor *= (kB - 1) / every + 1;
  const float* anc = anchors + (size_t)blockIdx.x * n_anchor;
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    code_s[i] = codes[base + i];
    rec_s[i] = is_anchor(i, ndim, every) ? anc[anchor_slot(i, ndim, every)] : 0.0f;
  }
  __syncthreads();
  for (int k = 0; k < tb.n_steps; ++k) {
    const uint8_t* tn = tb.tapn + k * kB;
    const int8_t* tj = tb.tapj + k * kB * kTaps;
    const float* tw = tb.tapw + k * kB * kTaps;
    const int end = tb.step_off[k + 1];
    for (int p = tb.step_off[k] + threadIdx.x; p < end; p += blockDim.x) {
      const int rec = tb.pts[p];
      const int idx = rec & 0xFFFF;
      const float pred = predict(rec_s, idx, rec >> 16, tb.wts[p], tn, tj, tw, ndim);
      const int c = code_s[idx];
      rec_s[idx] = c == 0 ? outlier_value(okeys, ovals, n_out, (long long)(base + idx))
                          : __fadd_rn(pred, __fmul_rn((float)(c - kCenter), twoeb));
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < V; i += blockDim.x) recon[base + i] = rec_s[i];
}

Tables make_tables(const int32_t* pts, const float* wts, const int32_t* step_off, int n_steps,
                   const uint8_t* tapn, const int8_t* tapj, const float* tapw) {
  Tables tb;
  tb.pts = pts;
  tb.wts = wts;
  tb.step_off = step_off;
  tb.tapn = tapn;
  tb.tapj = tapj;
  tb.tapw = tapw;
  tb.n_steps = n_steps;
  return tb;
}

}  // namespace

// C interface (ctypes). Every pointer is device memory; the launch goes on
// `stream` and the return value is cudaGetLastError() right after it.
// `recon` may be null: the encoder then writes the codes only.
extern "C" int interp_encode(const float* blocks, uint8_t* codes, float* recon, long long nb,
                             int ndim, int every, float twoeb, float inv2eb,
                             const int32_t* pts, const float* wts, const int32_t* step_off,
                             int n_steps, const uint8_t* tapn, const int8_t* tapj,
                             const float* tapw, void* stream) {
  if (nb <= 0 || ndim < 1 || ndim > 3 || every < 1 || (kB - 1) % every)
    return (int)cudaErrorInvalidValue;
  interp_encode_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      blocks, codes, recon, ndim, every, twoeb, inv2eb,
      make_tables(pts, wts, step_off, n_steps, tapn, tapj, tapw));
  return (int)cudaGetLastError();
}

// `anchors`: nb x (16/every + 1)^ndim; `okeys` ascending, n_out of them.
extern "C" int interp_decode(const uint8_t* codes, const float* anchors, const long long* okeys,
                             const float* ovals, long long n_out, float* recon, long long nb,
                             int ndim, int every, float twoeb, const int32_t* pts,
                             const float* wts, const int32_t* step_off, int n_steps,
                             const uint8_t* tapn, const int8_t* tapj, const float* tapw,
                             void* stream) {
  if (nb <= 0 || ndim < 1 || ndim > 3 || every < 1 || (kB - 1) % every || n_out < 0)
    return (int)cudaErrorInvalidValue;
  interp_decode_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      codes, anchors, okeys, ovals, n_out, recon, ndim, every, twoeb,
      make_tables(pts, wts, step_off, n_steps, tapn, tapj, tapw));
  return (int)cudaGetLastError();
}
