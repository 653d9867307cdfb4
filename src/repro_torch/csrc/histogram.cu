// Exact 256-bin byte histogram for Hopper (sm_90a): the Huffman frequencies.
//
// Replaces the TPU kernel src/repro/kernels/histogram/histogram.py::_kernel
// (pallas_call via histogram256_raw), a one-hot contraction per 8192-byte
// tile accumulated across a sequential grid. Blocks on the GPU run in no
// order, so each CTA counts into its own shared-memory bins and adds them
// once into the 64-bit global counts at the end.
//
// What bounds it on the H100: memory, one read of the stream (n bytes).
// What gets in the way is instruction issue and contention: quantization-
// code streams are highly skewed (most bytes are the center code 128, on
// both predictors), and lanes adding to one shared bin would serialize.
//
// Design:
// - Each warp counts into its own copy of the 256 bins (16 KB per CTA of 16
//   warps; 8 warps measured 5 % slower); the copies are summed once per CTA.
// - Every byte is one shared atomicAdd of 1 on a 32-bit shared address:
//   ptxas makes it a warp-aggregated increment (ATOMS.POPC.INC), so the
//   lanes of a warp that hit one bin (the center code, or one value
//   everywhere) add once, and no per-byte test or warp match is needed.
//   Counting the center code in registers (an exact SWAR mask per word)
//   and leaving it out of the atomics measured slower (PERF.md).
// - Every thread keeps kUnroll 16-B loads in flight before it counts them,
//   and the grid is as many CTAs as are resident at once (the occupancy
//   query), each striding over the stream.
// - The unaligned head and the ragged tail (under 16 bytes each) are
//   counted by CTA 0 byte by byte; no padding and no pad correction, exact
//   for any n and any alignment, including n == 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-B loads in flight per thread

// Adds 1 to the bin of each byte of w; `bins` is the shared-space address
// of the warp's 256 bins.
__device__ __forceinline__ void count_word(unsigned bins, uint32_t w) {
  unsigned* b0 = reinterpret_cast<unsigned*>(__cvta_shared_to_generic(bins));
#pragma unroll
  for (int b = 0; b < 4; ++b) atomicAdd(b0 + __byte_perm(w, 0, 0x4440 + b), 1u);
}

__global__ void __launch_bounds__(kThreads)
histogram256_kernel(const uint8_t* __restrict__ data, long long n, long long head,
                    long long nvec, unsigned long long* __restrict__ out) {
  __shared__ unsigned bins[kWarps][256];
  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) (&bins[0][0])[i] = 0;
  __syncthreads();
  unsigned* mine = bins[threadIdx.x >> 5];
  const unsigned mine_s = (unsigned)__cvta_generic_to_shared(mine);
  const uint4* vec = reinterpret_cast<const uint4*>(data + head);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nvec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * stride;
      if (j < nvec) v[u] = __ldg(vec + j);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * stride < nvec) {
        count_word(mine_s, v[u].x);
        count_word(mine_s, v[u].y);
        count_word(mine_s, v[u].z);
        count_word(mine_s, v[u].w);
      }
    }
  }
  if (blockIdx.x == 0) {
    const long long tail0 = head + 16 * nvec;
    if (threadIdx.x < head) atomicAdd(&mine[data[threadIdx.x]], 1u);
    if (threadIdx.x < n - tail0) atomicAdd(&mine[data[tail0 + threadIdx.x]], 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += kThreads) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += bins[w][b];
    if (sum) atomicAdd(&out[b], sum);
  }
}

}  // namespace

// C interface (ctypes): `data` n device bytes, `out` 256 device u64 counts
// (zeroed here). Launches on `stream`; returns cudaGetLastError().
extern "C" int histogram256(const uint8_t* data, long long n, unsigned long long* out,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, 256 * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  const long long head = n < 0 ? 0 : (long long)((16 - ((uintptr_t)data & 15)) & 15);
  const long long h = head < n ? head : (n < 0 ? 0 : n);
  const long long nvec = (n - h) / 16;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, histogram256_kernel, kThreads, 0)) != cudaSuccess)
    return (int)err;
  long long grid = (nvec + (long long)kThreads * kUnroll - 1) / ((long long)kThreads * kUnroll);
  const long long resident = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (grid > resident) grid = resident;
  if (grid < 1) grid = 1;
  histogram256_kernel<<<(unsigned)grid, kThreads, 0, st>>>(data, n, h, nvec, out);
  return (int)cudaGetLastError();
}
