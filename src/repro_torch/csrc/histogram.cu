// Exact 256-bin byte histogram for Hopper (sm_90a): the Huffman frequencies.
//
// Replaces the TPU kernel src/repro/kernels/histogram/histogram.py::_kernel
// (pallas_call via histogram256_raw), a one-hot contraction per 8192-byte
// tile accumulated across a sequential grid. Blocks on the GPU run in no
// order, so each CTA counts into its own shared-memory bins and adds them
// once into the 64-bit global counts at the end.
//
// What bounds it on the H100: memory, one read of the stream (n bytes).
// What gets in the way is contention: quantization-code streams are highly
// skewed (most bytes are the center code 128), and 32 lanes adding to one
// shared bin serialize. So each warp first groups equal bytes with
// __match_any_sync and one leader lane adds the group's size.
//
// Design: grid-stride over 16-byte vector loads with a warp-uniform trip
// count (so every lane takes part in the match), unaligned head and ragged
// tail bytes counted by CTA 0 with plain shared atomics, no padding and no
// pad correction; exact for any n, including 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kNone = 256;  // sentinel byte value of idle lanes

__device__ __forceinline__ void count_byte(unsigned* bins, unsigned v) {
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, v);
  if (v != kNone && (threadIdx.x & 31) == (unsigned)(__ffs(peers) - 1)) {
    atomicAdd(&bins[v], (unsigned)__popc(peers));
  }
}

__global__ void __launch_bounds__(kThreads)
histogram256_kernel(const uint8_t* __restrict__ data, long long n, long long head,
                    long long nvec, unsigned long long* __restrict__ out) {
  __shared__ unsigned bins[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  const uint4* vec = reinterpret_cast<const uint4*>(data + head);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long warp0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31u);
  const int lane = threadIdx.x & 31;
  for (long long w = warp0; w < nvec; w += stride) {  // same trip count for the whole warp
    const long long i = w + lane;
    const bool ok = i < nvec;
    const uint4 v = ok ? vec[i] : make_uint4(0, 0, 0, 0);
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int b = 0; b < 4; ++b) count_byte(bins, ok ? (words[k] >> (8 * b)) & 0xFFu : kNone);
    }
  }
  if (blockIdx.x == 0) {
    const long long tail0 = head + 16 * nvec;
    if (threadIdx.x < head) atomicAdd(&bins[data[threadIdx.x]], 1u);
    if (threadIdx.x < n - tail0) atomicAdd(&bins[data[tail0 + threadIdx.x]], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    if (bins[i]) atomicAdd(&out[i], (unsigned long long)bins[i]);
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
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long grid = (nvec + kThreads - 1) / kThreads;
  const long long cap = (long long)(sms > 0 ? sms : 1) * 8;
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  histogram256_kernel<<<(unsigned)grid, kThreads, 0, st>>>(data, n, h, nvec, out);
  return (int)cudaGetLastError();
}
