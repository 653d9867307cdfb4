// Canonical Huffman encode and decode for Hopper (sm_90a): the hf stage.
//
// Replaces no Pallas kernel. It replaces the JAX package's jitted device
// programs for the stage: the decode `_hf_dec`, a jax.lax.scan of 512 steps
// over all chunks in lockstep (src/repro/core/lossless/engine.py:357-384,
// driven by hf_decode_device at :387), and the encode `_hf_emit_a` /
// `_hf_emit_b`, per-pair word contributions reduced into the big-endian
// word stream (engine.py:182-300, driven by hf_encode_device at :311). The
// bitstream is the host coder's (repro_torch/core/lossless/huffman.py):
// 1024-symbol chunks, each starting on a byte boundary, codes MSB-first,
// at most 16 bits long; the payload is [256 code lengths][u16 bytes per
// chunk][bits].
//
// What bounds them on the H100: memory, in principle (decode: read the
// payload, write n bytes; encode: read n bytes, write the payload). What
// gets in the way is the serial dependence inside a chunk: a symbol's bit
// position is known only after every earlier symbol of its chunk, and a
// chunk's byte offset only after every earlier chunk's size.
//
// - hf_decode: one lane per chunk (the format gives no other entry point;
//   131,807 lanes at the 512^3 main path), two symbols a step through the
//   (len<<8 | sym) pair LUT exactly as _hf_dec and the plain version do, in
//   128-thread CTAs of at most 64 registers a thread, so that every lane is
//   resident at once (8 CTAs an SM). It replaces a first design whose lane
//   assembled each 32-bit word from four byte loads, kept the whole
//   2^maxlen LUT (128 KB at 16-bit codes) in shared memory (one CTA an SM)
//   and stored 8 bytes at a time to its own chunk, 1 KB from its neighbour's.
//   * Loads: aligned 16-byte words from the stream's base rounded down to 16
//     bytes (the bits start 256 + 2 * nchunks bytes into the payload, only
//     2-aligned when nchunks is odd), one word in flight ahead of a register
//     queue of big-endian words (__byte_perm); the peek is one
//     __funnelshift_l of a two-word window. A word not wholly inside the
//     stream is read bytewise, out of line, bytes outside as zero, so a
//     damaged offset or a cursor far past the end reads zeros and never
//     memory outside the tensor: what the plain version's clamp to its
//     zero-padded last word gives. The loads lean on L1 keeping each lane's
//     current line between its 16-byte reads.
//   * Tables: a first-level table of the top 11 peek bits in shared memory
//     (4 KB, built per CTA): small[p] = lut[p << (maxlen - 11)] where that
//     entry's code is 1..11 bits long, else 0. A canonical code of length
//     l <= 11 fills an aligned block of 2^(maxlen - l) LUT entries, so every
//     peek under such a p has that entry; the rest (longer codes, rare on
//     the main path, and the empty entries of an incomplete code)
//     escape to the full LUT through __ldg. The result is lut[peek >>
//     (32 - maxlen)] for every peek, damaged streams included.
//   * Stores: every 64 steps a lane's 128 decoded bytes go to its row in
//     shared memory, and the warp stores 16-byte pieces of 8 chunks' rows at
//     once: 8 lines a store instead of 32.
//   * Code size: one copy of the step (unrolled by 4), one advance a step
//     (two codes take at most 32 bits): the step loop stays small.
//   What bounds it then: instruction issue and latency of the 512 dependent
//   steps a lane (two shared-memory reads each), about 6x its byte bound.
// - hf_encode: one launch, one pass over the input. It replaces two
//   launches (a per-chunk bit count, then a 256-thread CTA per chunk that
//   read the input again) with a torch cumsum and a pageable 1 MB host read
//   between them. A CTA of 8 warps is a tile of 8 chunks, a warp a chunk, a
//   lane 32 consecutive symbols (two or three aligned 16-byte loads shifted
//   by the input's misalignment, which is the same in every lane, and a
//   ragged tail read bytewise). The codes and lengths come by value as a
//   kernel parameter into a 1 KB shared table. A shuffle-up warp scan of the
//   lanes' bit counts gives each lane's bit offset in its chunk; the chunk
//   sizes' byte offsets come from a single-pass decoupled look-back over
//   tiles, tile indices taken from an atomic ticket (a tile only waits on
//   tiles that started before it, so no order of CTAs can deadlock), status
//   words (flag and value in one 64-bit word) in the call's own scratch,
//   zeroed before the launch. Each lane ORs its codes, two at a time, into
//   its warp's chunk words in shared memory (2 KB + 4 B) with 32-bit
//   shifts only (a clamped funnel shift gives the part that spills into
//   the next word); the warp writes the chunk's bytes at their unaligned
//   byte offset with aligned 16-byte stores inside and byte stores at the
//   edges, so no two chunks write one word, and its u16 entry of the chunk
//   table. The caller sizes the payload from the symbol counts it already
//   holds (never written past `cap`) and reads back only the chunk table
//   and the bits' total (a plain i64 the last tile writes), copied to
//   pinned memory in the same call.
//   What bounds it then: latency through each tile's phases (load, scan,
//   look-back, emit, store) at 5 CTAs an SM, about 3.5x its byte bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;
constexpr int kMaxLen = 16;
constexpr int kSmallBits = 11;
constexpr int kDecThreads = 128;
constexpr int kStageBytes = 128;    // decoded bytes a lane between the warp's stores (64 steps)
constexpr int kStageStride = kStageBytes + 16;  // a lane's staging row, padded against bank conflicts
constexpr int kEncWarps = 8;
constexpr int kEncThreads = 32 * kEncWarps;
constexpr int kChunkWords = kChunk * kMaxLen / 32 + 1;
constexpr unsigned long long kAggregate = 1ull << 62, kPrefix = 2ull << 62, kValue = (1ull << 62) - 1;

__device__ __forceinline__ uint32_t bswap(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// load16's edge: the bytes of [s, s + 16) inside [0, nbytes), the rest
// zero. Out of line, so that the loops that inline load16 stay small.
__device__ __noinline__ uint4 load16_edge(const uint8_t* __restrict__ p, long long nbytes, long long s) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (s < nbytes && s + 16 > 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const long long b = s + i;
      if (b >= 0 && b < nbytes) w[i >> 2] |= (uint32_t)__ldg(p + b) << (8 * (i & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 16 bytes of `p` at [s, s + 16) as four little-endian words; bytes
// outside [0, nbytes) read as zero and are never loaded. `p + s` is
// 16-byte aligned whenever the range is inside.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p, long long nbytes, long long s) {
  if (s >= 0 && s + 16 <= nbytes) return __ldg(reinterpret_cast<const uint4*>(p + s));
  return load16_edge(p, nbytes, s);
}

__global__ void __launch_bounds__(kDecThreads, 8)
hf_decode_kernel(const uint8_t* __restrict__ bits, int align, long long nbytes, const uint32_t* __restrict__ offs,
                 const uint16_t* __restrict__ lut, int maxlen, long long n, long long nchunks,
                 uint8_t* __restrict__ out) {
  __shared__ uint16_t small[1 << kSmallBits];
  __shared__ __align__(16) uint8_t stage[kDecThreads * kStageStride];
  const int kb = maxlen < kSmallBits ? maxlen : kSmallBits;
  for (int p = threadIdx.x; p < (1 << kb); p += kDecThreads) {
    const uint32_t e = __ldg(lut + ((uint32_t)p << (maxlen - kb)));
    const uint32_t l = e >> 8;
    small[p] = (l >= 1 && l <= (uint32_t)kb) ? (uint16_t)e : (uint16_t)0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long cw = (long long)blockIdx.x * kDecThreads + (threadIdx.x & ~31);  // the warp's first chunk
  if (cw >= nchunks) return;
  const long long c = cw + lane;
  const bool live = c < nchunks;
  const int shift = 32 - maxlen, kshift = 32 - kb;
  // stream byte b sits at byte align + b of the 16-aligned base; 16-byte
  // word v of the base is wholly inside the stream for v in [v_lo, v_hi]
  const unsigned long long start = ((unsigned long long)align + (live ? offs[c] : 0u)) * 8ull;
  const uint4* base = reinterpret_cast<const uint4*>(bits - align);
  const long long v_lo = align ? 1 : 0, v_hi = (nbytes + align) / 16 - 1;
  auto word16 = [&](long long v) -> uint4 {
    return v >= v_lo && v <= v_hi ? __ldg(base + v) : load16_edge(bits, nbytes, v * 16 - align);
  };
  long long vq = (long long)(start >> 7);  // the 16-byte word the queue was filled from
  const uint4 v0 = word16(vq);
  uint4 ahead = word16(vq + 1);  // in flight until the queue runs dry
  uint32_t q0 = bswap(v0.x), q1 = bswap(v0.y), q2 = bswap(v0.z), q3 = bswap(v0.w);
  int nq = 4;
  auto pop = [&]() -> uint32_t {
    if (nq == 0) {
      q0 = bswap(ahead.x), q1 = bswap(ahead.y), q2 = bswap(ahead.z), q3 = bswap(ahead.w);
      nq = 4;
      ahead = word16(++vq + 1);
    }
    const uint32_t w = q0;
    q0 = q1, q1 = q2, q2 = q3, --nq;
    return w;
  };
  const int skip = (int)((start >> 5) & 3);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (i < skip) pop();
  uint32_t w0 = pop(), w1 = pop();
  int r = (int)(start & 31);  // the window is bits r.. of w0:w1
  auto entry = [&](uint32_t peek) -> uint32_t {
    const uint32_t e = small[peek >> kshift];
    return e ? e : (uint32_t)__ldg(lut + (peek >> shift));
  };
  auto step = [&]() -> uint32_t {
    const uint32_t peek = __funnelshift_l(w1, w0, r);
    const uint32_t e1 = entry(peek);
    const uint32_t e2 = entry(peek << (e1 >> 8));
    r += (int)((e1 >> 8) + (e2 >> 8));  // at most 32 bits: two codes of at most 16
    if (r >= 32) {
      r -= 32;
      w0 = w1;
      w1 = pop();
    }
    return (e1 & 255u) | ((e2 & 255u) << 8);
  };
  // every kStageBytes decoded bytes a lane go through shared memory, so the
  // warp stores 16-byte pieces of 8 chunks' contiguous segments at once
  const long long first_left = n - cw * kChunk;  // lane 0's chunk has the most symbols
  const int rounds = (int)(((first_left < kChunk ? first_left : kChunk) + kStageBytes - 1) / kStageBytes);
  uint8_t* mine = stage + (threadIdx.x & ~31) * kStageStride;
  constexpr int kPieces = kStageBytes / 16, kSegs = 32 / kPieces;
  for (int round = 0; round < rounds; ++round) {
#pragma unroll 1
    for (int g = 0; g < kPieces; ++g) {  // 8 steps, 16 symbols, a piece
      unsigned long long lo = 0, hi = 0;
#pragma unroll 4
      for (int t = 0; t < 8; ++t) {
        const unsigned long long v = (unsigned long long)step() << (16 * (t & 3));
        if (t < 4) lo |= v; else hi |= v;
      }
      *reinterpret_cast<uint4*>(mine + lane * kStageStride + 16 * g) =
          make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32));
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < kPieces; ++it) {
      const int seg = it * kSegs + lane / kPieces, piece = lane % kPieces;
      const long long sc = cw + seg;
      const long long left = n - sc * kChunk;
      const int pos = round * kStageBytes + 16 * piece;
      if (sc < nchunks && pos < left) {
        const uint4 v = *reinterpret_cast<const uint4*>(mine + seg * kStageStride + 16 * piece);
        uint8_t* o = out + sc * kChunk + pos;
        if (pos + 16 <= left) {
          *reinterpret_cast<uint4*>(o) = v;
        } else {
          const uint32_t b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int k = 0; k < 16; ++k)
            if (pos + k < left) o[k] = (uint8_t)(b[k >> 2] >> (8 * (k & 3)));
        }
      }
    }
    __syncwarp();
  }
}

// The 32 bytes at stream index s of a lane, from the 16-aligned words W
// (W[0] holds aligned bytes [s, s + 4)), for an input that starts Q words
// and `sh` bits into its first aligned word.
template <int Q>
__device__ __forceinline__ void take32(const uint32_t (&W)[12], uint32_t (&R)[8], int sh) {
#pragma unroll
  for (int j = 0; j < 8; ++j) R[j] = __funnelshift_r(W[j + Q], W[j + Q + 1], sh);
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

struct CodeTable {
  uint32_t e[256];  // code << 8 | length
};

__global__ void __launch_bounds__(kEncThreads, 5)
hf_encode_kernel(const uint8_t* __restrict__ data, int align, long long n, const __grid_constant__ CodeTable table,
                 long long nchunks, unsigned long long* __restrict__ status, unsigned int* __restrict__ ticket,
                 long long* __restrict__ total_bytes, uint8_t* __restrict__ payload, long long cap) {
  __shared__ uint32_t tab[256];
  __shared__ uint32_t words[kEncWarps][kChunkWords];
  __shared__ uint32_t chunk_bytes[kEncWarps];
  __shared__ long long tile_s;
  __shared__ unsigned long long excl_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 256; i += kEncThreads) tab[i] = table.e[i];
  if (tid == 0) tile_s = atomicAdd(ticket, 1u);
  uint32_t* buf = words[warp];
  for (int i = lane; i < kChunkWords; i += 32) buf[i] = 0;
  __syncthreads();
  const long long tile = tile_s;
  if (tile == 0)
    for (int i = tid; i < 256; i += kEncThreads) payload[i] = (uint8_t)(tab[i] & 255u);  // the code lengths
  const long long c = tile * kEncWarps + warp;
  const bool live = c < nchunks;
  // this lane's symbols: stream bytes [s, s + 32), at aligned bytes [align + s, ...)
  const long long s = c * kChunk + 32ll * lane;
  uint32_t R[8];
  {
    uint32_t W[12];
    const uint4 a = load16(data, n, s - align), b = load16(data, n, s + 16 - align);
    const uint4 d = align ? load16(data, n, s + 32 - align) : make_uint4(0u, 0u, 0u, 0u);
    W[0] = a.x, W[1] = a.y, W[2] = a.z, W[3] = a.w, W[4] = b.x, W[5] = b.y;
    W[6] = b.z, W[7] = b.w, W[8] = d.x, W[9] = d.y, W[10] = d.z, W[11] = d.w;
    const int sh = 8 * (align & 3);
    switch (align >> 2) {
      case 0: take32<0>(W, R, sh); break;
      case 1: take32<1>(W, R, sh); break;
      case 2: take32<2>(W, R, sh); break;
      default: take32<3>(W, R, sh); break;
    }
  }
  // each symbol's table entry; pad symbols past n carry zero-length codes
  uint32_t e[32];
  int nbits = 0;
  if (s + 32 <= n) {
#pragma unroll
    for (int k = 0; k < 32; ++k) e[k] = tab[__byte_perm(R[k >> 2], 0, 0x4440 + (k & 3))];
  } else {
#pragma unroll
    for (int k = 0; k < 32; ++k) e[k] = s + k < n ? tab[__byte_perm(R[k >> 2], 0, 0x4440 + (k & 3))] : 0u;
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) nbits += (int)(e[k] & 255u);
  int incl = nbits;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  const int nb = (total + 7) >> 3;
  if (lane == 0) {
    chunk_bytes[warp] = live ? (uint32_t)nb : 0u;
    if (live) reinterpret_cast<uint16_t*>(payload + 256)[c] = (uint16_t)nb;
  }
  __syncthreads();
  // the tile's aggregate, then (warp 0) the look-back for its exclusive prefix
  if (warp == 0) {
    unsigned long long agg = 0;
#pragma unroll
    for (int i = 0; i < kEncWarps; ++i) agg += chunk_bytes[i];
    if (lane == 0) atomicExch(status + tile, (tile == 0 ? kPrefix : kAggregate) | agg);
    unsigned long long ex = 0;
    for (long long top = tile - 1; top >= 0; top -= 32) {
      const long long j = top - lane;
      unsigned long long st = j >= 0 ? load_status(status + j) : kPrefix;
      while (__any_sync(0xffffffffu, (st >> 62) == 0))
        if ((st >> 62) == 0) st = load_status(status + j);
      const unsigned pre = __ballot_sync(0xffffffffu, (st >> 62) == 2);
      const int stop = pre ? __ffs(pre) - 1 : 31;
      unsigned long long v = lane <= stop ? (st & kValue) : 0ull;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
      ex += v;
      if (pre) break;
    }
    if (lane == 0) {
      excl_s = ex;
      if (tile > 0) atomicExch(status + tile, kPrefix | (ex + agg));
      if (tile == gridDim.x - 1) *total_bytes = (long long)(ex + agg);  // the bits' total, for the caller
    }
  }
  // codes two at a time (at most 32 bits) ORed into the chunk's words at
  // their bit offset: `cur` is word w from bit `nacc` on, `spill` what of the
  // pair passes its end
  if (live) {
    const int p = incl - nbits;
    int w = p >> 5, nacc = p & 31;
    uint32_t cur = 0;
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const uint32_t l2 = e[k + 1] & 255u, l = (e[k] & 255u) + l2;
      const uint32_t code = ((e[k] >> 8) << l2) | (e[k + 1] >> 8);
      const uint32_t top = l ? code << (32 - l) : 0u;  // the pair's bits from the word's top
      cur |= top >> nacc;
      const uint32_t spill = __funnelshift_rc(0u, top, (uint32_t)nacc);
      nacc += (int)l;
      if (nacc >= 32) {
        atomicOr(buf + w, cur);
        ++w, cur = spill, nacc -= 32;
      }
    }
    if (nacc > 0) atomicOr(buf + w, cur);
  }
  __syncthreads();
  if (!live || nb == 0) return;
  unsigned long long off = excl_s;
  for (int i = 0; i < warp; ++i) off += chunk_bytes[i];
  uint8_t* dst = payload + 256 + 2 * nchunks + off;
  auto put = [&](int i) { dst[i] = (uint8_t)(buf[i >> 2] >> (24 - 8 * (i & 3))); };
  if ((long long)(off + nb) > cap) {  // the caller's size was short: write only what fits
    for (int i = lane; (long long)(off + i) < cap && i < nb; i += 32) put(i);
    return;
  }
  int head = (int)((16 - ((uintptr_t)dst & 15)) & 15);
  if (head > nb) head = nb;
  const int blocks = (nb - head) >> 4, tail = head + 16 * blocks;
  if (lane < head) put(lane);
  if (tail + lane < nb) put(tail + lane);
  for (int b = lane; b < blocks; b += 32) {
    const int i0 = head + 16 * b, m = i0 >> 2, bs = 8 * (i0 & 3);
    uint32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = bswap(__funnelshift_l(buf[m + k + 1], buf[m + k], bs));
    *reinterpret_cast<uint4*>(dst + i0) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

long long grid_of(long long items, long long per_block) { return (items + per_block - 1) / per_block; }

}  // namespace

// C interface (ctypes). Every function launches on `stream` and returns
// cudaGetLastError() (0 on success); none synchronizes or allocates.

// `bits` nbytes device bytes (the payload after its chunk table, any
// alignment), `offs` nchunks device u32 byte offsets, `lut` 2^maxlen device
// u16 (len<<8 | sym, as the host coder's _pair_lut builds it), 1 <= maxlen
// <= 16; writes n device bytes to `out` (16-byte aligned).
extern "C" int hf_decode(const uint8_t* bits, long long nbytes, const uint32_t* offs, const uint16_t* lut,
                         int maxlen, long long n, long long nchunks, uint8_t* out, void* stream) {
  if (maxlen < 1 || maxlen > kMaxLen || nbytes < 0 || n < 0 || nchunks < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if ((uintptr_t)out & 15) return (int)cudaErrorMisalignedAddress;
  const int align = (int)((uintptr_t)bits & 15);
  hf_decode_kernel<<<(unsigned)grid_of(nchunks, kDecThreads), kDecThreads, 0, (cudaStream_t)stream>>>(
      bits, align, nbytes, offs, lut, maxlen, n, nchunks, out);
  return (int)cudaGetLastError();
}

// Bytes of device scratch hf_encode needs for `nchunks` chunks: the
// tiles' status words, the ticket and the bits' total.
extern "C" long long hf_encode_scratch_bytes(long long nchunks) { return (grid_of(nchunks, kEncWarps) + 2) * 8; }

// `data` n device bytes (any alignment), `table` 256 host u32 entries
// code << 8 | length (lengths <= 16, passed by value), `scratch`
// scratch_bytes >= hf_encode_scratch_bytes(nchunks) device bytes, 8-aligned
// (its status words and ticket are set to zero here, before the launch);
// writes the payload's 256 code lengths, its u16 chunk table (nchunks =
// max(1, ceil(n / 1024))) and at most `cap` bytes of bits after the table,
// then copies the chunk table to host_table[0, 2 * nchunks) and the bits'
// total size to *host_total (both pinned; the caller synchronizes). A total
// above `cap` means the caller sized the payload short.
extern "C" int hf_encode(const uint8_t* data, long long n, const uint32_t* table, long long nchunks,
                         long long* scratch, long long scratch_bytes, uint8_t* payload, long long cap,
                         uint8_t* host_table, long long* host_total, void* stream) {
  const long long tiles = grid_of(nchunks, kEncWarps);
  if (n < 0 || nchunks < 1 || cap < 0 || scratch_bytes < hf_encode_scratch_bytes(nchunks))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)payload & 1) || ((uintptr_t)scratch & 7)) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)(tiles + 1) * 8, st);
  if (err != cudaSuccess) return (int)err;
  CodeTable t;
  for (int i = 0; i < 256; ++i) t.e[i] = table[i];
  hf_encode_kernel<<<(unsigned)tiles, kEncThreads, 0, st>>>(
      data, (int)((uintptr_t)data & 15), n, t, nchunks, reinterpret_cast<unsigned long long*>(scratch),
      reinterpret_cast<unsigned int*>(scratch + tiles), scratch + tiles + 1, payload, cap);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = cudaMemcpyAsync(host_table, payload + 256, (size_t)nchunks * 2, cudaMemcpyDeviceToHost, st)) !=
      cudaSuccess)
    return (int)err;
  return (int)cudaMemcpyAsync(host_total, scratch + tiles + 1, 8, cudaMemcpyDeviceToHost, st);
}
