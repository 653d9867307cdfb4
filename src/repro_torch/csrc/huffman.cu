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
// position is known only after every earlier symbol of its chunk.
//
// Design:
// - hf_decode: one thread per chunk (131,807 lanes at the 512^3 main path,
//   one wave of 1024-thread CTAs on 132 SMs). Each lane walks from its byte
//   offset (the header's `offs` table), two symbols per 32-bit peek through
//   the (len<<8 | sym) pair LUT, exactly as _hf_dec and the plain version
//   do. It assembles big-endian words from bytes itself (no widened copy of
//   the stream) and keeps a two-word window in registers, so a word is read
//   about once. Every word read is clamped as the plain version clamps it
//   (q = min(cur >> 5, qmax) over the zero-padded words), so a damaged
//   stream gives both the same bytes. Each lane stops at its chunk's symbol
//   count and stores 8 decoded bytes at a time.
//   The LUT (2^maxlen u16, at most 128 KB at maxlen 16) always lives in
//   shared memory: maxlen <= 16 is a format check before the launch, so it
//   always fits in the 227 KB a CTA may opt into, and the two dependent LUT
//   reads of every step are the walk's latency.
// - hf_encode: two launches. hf_chunk_bytes sums the code lengths of each
//   chunk (a warp per chunk) into its byte count; the wrapper turns those
//   into exclusive byte offsets with one torch cumsum (131,807 values: glue,
//   not the kernel's body) and reads them to the host once, for the total
//   size. hf_emit then runs one CTA per chunk: a block scan of its symbols'
//   code lengths gives each code's bit position, each code is ORed into the
//   chunk's words in shared memory (at most 1024 x 16 bits = 2 KB), and the
//   CTA writes the chunk's bytes at its byte offset. Chunks start on byte
//   boundaries, so each CTA owns its byte range: no atomics across chunks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;
constexpr int kMaxLen = 16;
constexpr int kDecThreads = 1024;
constexpr int kLutBytesMax = (1 << kMaxLen) * 2;
constexpr int kSumThreads = 256;  // 8 warps, a chunk each
constexpr int kEmitThreads = 256;
constexpr int kPerThread = kChunk / kEmitThreads;
constexpr int kWords = kChunk * kMaxLen / 32 + 1;
static_assert(kSumThreads == 256 && kEmitThreads == 256, "one thread per code-table entry");

// The big-endian word q of the stream, bytes past `nbytes` read as zero.
__device__ __forceinline__ uint32_t be_word(const uint8_t* __restrict__ bits, long long nbytes, long long q) {
  const long long b = q * 4;
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) w = (w << 8) | (b + i < nbytes ? (uint32_t)__ldg(bits + b + i) : 0u);
  return w;
}

__global__ void __launch_bounds__(kDecThreads, 1)
hf_decode_kernel(const uint8_t* __restrict__ bits, long long nbytes, long long qmax,
                 const long long* __restrict__ offs, const uint32_t* __restrict__ lut_g, int maxlen,
                 long long n, long long nchunks, uint8_t* __restrict__ out) {
  extern __shared__ uint32_t lut_s[];
  for (int i = threadIdx.x; i < (1 << (maxlen - 1)); i += kDecThreads) lut_s[i] = __ldg(lut_g + i);
  __syncthreads();
  const uint16_t* lut = reinterpret_cast<const uint16_t*>(lut_s);
  const long long c = (long long)blockIdx.x * kDecThreads + threadIdx.x;
  if (c >= nchunks) return;
  const long long left = n - c * kChunk;
  const int cnt = left < kChunk ? (int)left : kChunk;
  const int steps = (cnt + 1) >> 1;
  const int shift = 32 - maxlen;
  uint8_t* o = out + c * kChunk;
  unsigned long long cur = (unsigned long long)offs[c] * 8ull;
  long long wq = -2;  // the window holds words wq and wq + 1
  uint32_t w0 = 0, w1 = 0;
  unsigned long long acc = 0;
  for (int t = 0; t < steps; ++t) {
    long long q = (long long)(cur >> 5);
    if (q > qmax) q = qmax;
    const int r = (int)(cur & 31);
    if (q != wq) {
      if (q == wq + 1) {
        w0 = w1;
      } else {
        w0 = be_word(bits, nbytes, q);
      }
      w1 = be_word(bits, nbytes, q + 1);
      wq = q;
    }
    const uint32_t peek = (w0 << r) | ((w1 >> 1) >> (31 - r));
    const uint32_t e1 = lut[peek >> shift];
    const uint32_t ls1 = e1 >> 8;
    const uint32_t e2 = lut[(peek << ls1) >> shift];
    cur += ls1 + (e2 >> 8);
    acc |= (unsigned long long)((e1 & 255u) | ((e2 & 255u) << 8)) << (16 * (t & 3));
    if ((t & 3) == 3) {
      const int base = 2 * (t - 3);
      if (base + 8 <= cnt) {
        *reinterpret_cast<unsigned long long*>(o + base) = acc;
      } else {
        for (int k = 0; base + k < cnt; ++k) o[base + k] = (uint8_t)(acc >> (8 * k));
      }
      acc = 0;
    }
  }
  if (steps & 3) {
    const int base = 2 * (steps & ~3);
    for (int k = 0; base + k < cnt; ++k) o[base + k] = (uint8_t)(acc >> (8 * k));
  }
}

__global__ void __launch_bounds__(kSumThreads)
hf_chunk_bytes_kernel(const uint8_t* __restrict__ data, long long n, const uint8_t* __restrict__ lens_g,
                      long long nchunks, long long* __restrict__ chunk_bytes) {
  __shared__ uint8_t lens[256];
  lens[threadIdx.x] = lens_g[threadIdx.x];
  __syncthreads();
  const long long c = (long long)blockIdx.x * (kSumThreads / 32) + (threadIdx.x >> 5);
  if (c >= nchunks) return;
  const int lane = threadIdx.x & 31;
  const long long base = c * kChunk;
  int bits = 0;
#pragma unroll 8
  for (int k = 0; k < kChunk / 32; ++k) {
    const long long i = base + lane + 32 * k;
    if (i < n) bits += lens[__ldg(data + i)];
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) bits += __shfl_xor_sync(0xffffffffu, bits, d);
  if (lane == 0) chunk_bytes[c] = (bits + 7) >> 3;
}

__global__ void __launch_bounds__(kEmitThreads)
hf_emit_kernel(const uint8_t* __restrict__ data, long long n, const uint8_t* __restrict__ lens_g,
               const uint32_t* __restrict__ codes_g, const long long* __restrict__ byte_off,
               long long nchunks, uint8_t* __restrict__ payload) {
  __shared__ uint32_t codes[256];
  __shared__ uint8_t lens[256];
  __shared__ uint32_t words[kWords];
  __shared__ int warp_tot[kEmitThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  codes[tid] = codes_g[tid];
  lens[tid] = lens_g[tid];
  for (int i = tid; i < kWords; i += kEmitThreads) words[i] = 0;
  __syncthreads();
  const long long c = blockIdx.x;
  const long long first = c * kChunk + (long long)tid * kPerThread;
  int sym[kPerThread], len[kPerThread], s = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = first + k;
    sym[k] = i < n ? __ldg(data + i) : 0;
    len[k] = i < n ? lens[sym[k]] : 0;  // pad symbols carry zero-length codes
    s += len[k];
  }
  // block-wide exclusive scan of the per-thread bit counts
  int incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kEmitThreads / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < kEmitThreads / 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    if (lane < kEmitThreads / 32) warp_tot[lane] = v;
  }
  __syncthreads();
  int p = incl - s + (warp ? warp_tot[warp - 1] : 0);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int l = len[k];
    if (l) {
      const int w = p >> 5;
      const unsigned long long v = (unsigned long long)codes[sym[k]] << (64 - (p & 31) - l);
      atomicOr(&words[w], (uint32_t)(v >> 32));
      if ((uint32_t)v) atomicOr(&words[w + 1], (uint32_t)v);
      p += l;
    }
  }
  __syncthreads();
  const int nbytes = (warp_tot[kEmitThreads / 32 - 1] + 7) >> 3;
  if (tid == 0) {
    payload[256 + 2 * c] = (uint8_t)(nbytes & 255);
    payload[257 + 2 * c] = (uint8_t)(nbytes >> 8);
  }
  uint8_t* dst = payload + 256 + 2 * nchunks + byte_off[c];
  for (int i = tid; i < nbytes; i += kEmitThreads) dst[i] = (uint8_t)(words[i >> 2] >> (24 - 8 * (i & 3)));
}

long long grid_of(long long items, long long per_block) { return (items + per_block - 1) / per_block; }

}  // namespace

// C interface (ctypes). Every function launches on `stream` and returns
// cudaGetLastError() (0 on success); none synchronizes or allocates.

// `bits` nbytes device bytes (the payload after its chunk table), `offs`
// nchunks device i64 byte offsets, `lut` 2^maxlen device u16 (len<<8 | sym),
// 1 <= maxlen <= 16; writes n device bytes to `out`.
extern "C" int hf_decode(const uint8_t* bits, long long nbytes, const long long* offs, const uint16_t* lut,
                         int maxlen, long long n, long long nchunks, uint8_t* out, void* stream) {
  if (maxlen < 1 || maxlen > kMaxLen || nbytes < 0 || n < 0 || nchunks < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  // the max is set, not the call's size: threads decoding other streams at once see one value
  cudaError_t err = cudaFuncSetAttribute(hf_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kLutBytesMax);
  if (err != cudaSuccess) return (int)err;
  const long long qmax = (nbytes + 11) / 4 - 1;  // the plain version's zero-padded words, less one
  const size_t smem = (size_t)1 << (maxlen + 1);  // the LUT: 2^maxlen u16
  hf_decode_kernel<<<(unsigned)grid_of(nchunks, kDecThreads), kDecThreads, smem,
                     (cudaStream_t)stream>>>(bits, nbytes, qmax, offs, reinterpret_cast<const uint32_t*>(lut),
                                             maxlen, n, nchunks, out);
  return (int)cudaGetLastError();
}

// `data` n device bytes, `lens` 256 device code lengths; writes nchunks
// device i64 byte counts (nchunks = max(1, ceil(n / 1024))).
extern "C" int hf_chunk_bytes(const uint8_t* data, long long n, const uint8_t* lens, long long nchunks,
                              long long* chunk_bytes, void* stream) {
  if (n < 0 || nchunks < 1) return (int)cudaErrorInvalidValue;
  hf_chunk_bytes_kernel<<<(unsigned)grid_of(nchunks, kSumThreads / 32), kSumThreads, 0, (cudaStream_t)stream>>>(
      data, n, lens, nchunks, chunk_bytes);
  return (int)cudaGetLastError();
}

// `codes` 256 device u32 canonical codes, `byte_off` nchunks device i64
// exclusive byte offsets of the chunks; writes the payload's chunk table
// and bits (`payload`'s first 256 bytes, the code lengths, are the caller's).
extern "C" int hf_emit(const uint8_t* data, long long n, const uint8_t* lens, const uint32_t* codes,
                       const long long* byte_off, long long nchunks, uint8_t* payload, void* stream) {
  if (n < 0 || nchunks < 1) return (int)cudaErrorInvalidValue;
  hf_emit_kernel<<<(unsigned)nchunks, kEmitThreads, 0, (cudaStream_t)stream>>>(data, n, lens, codes, byte_off,
                                                                               nchunks, payload);
  return (int)cudaGetLastError();
}
