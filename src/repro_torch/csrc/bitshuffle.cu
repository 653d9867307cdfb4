// Bit-plane shuffle for Hopper (sm_90a): BIT1 encode and its inverse.
//
// Replaces the TPU kernels src/repro/kernels/bitshuffle/bitshuffle.py::_kernel
// and ::_inv_kernel (pallas_call via bitshuffle_pallas_raw and
// bitunshuffle_pallas_raw, which the JAX engine calls on 8192-byte blocks,
// tile_blocks=1). Within a block, plane p (p = 0 the MSB) fills bytes
// [p * block/8, (p+1) * block/8); byte q of plane p holds bit 7-p of input
// bytes 8q..8q+7, MSB first, in np.packbits order.
//
// What bounds it on the H100: memory. Each byte is read once and written
// once (2 B moved per byte); the arithmetic is about 30 integer operations
// per 8 bytes. The TPU kernel spreads every bit over an int32 lane and packs
// the planes back with a weight contraction; here one thread transposes an
// 8x8 bit matrix held in one 64-bit register.
//
// Design: a thread owns four consecutive 8-byte groups of one block (the
// block is a multiple of 32 bytes). The forward kernel loads them as 64-bit
// words and maps each through F(v) = bswap(T(bswap(v))), T being the 8x8
// bit-matrix transpose by three masked delta swaps; byte p of F(v) is the
// group's byte of plane p. It stores one 32-bit word per plane, so
// consecutive threads write consecutive words of a plane. The byte
// swaps fix the bit order: a little-endian load puts byte 8q in the low bits,
// while np.packbits puts it in the high bit of each plane byte. F is its own
// inverse, so the inverse kernel gathers one word from each plane, applies F
// and stores the groups' bytes contiguously. The forward kernel reads the
// ragged tail byte by byte and takes bytes past n as zero, so the caller
// pads nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kG = 4;  // 8-byte groups per thread

__device__ __forceinline__ uint64_t bswap64(uint64_t v) {
  const uint32_t lo = (uint32_t)v, hi = (uint32_t)(v >> 32);
  return ((uint64_t)__byte_perm(lo, 0, 0x0123) << 32) | __byte_perm(hi, 0, 0x0123);
}

// Bit (8r + c) <-> bit (8c + r): swap off-diagonal 1x1, 2x2, then 4x4 blocks.
__device__ __forceinline__ uint64_t transpose8x8(uint64_t x) {
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x ^= t ^ (t << 28);
  return x;
}

// 8 input bytes <-> their 8 plane bytes (byte p = plane p); F(F(v)) == v.
__device__ __forceinline__ uint64_t shuffle8(uint64_t v) { return bswap64(transpose8x8(bswap64(v))); }

// A thread owns kG consecutive 8-byte groups of one block.
__global__ void __launch_bounds__(kThreads)
bitshuffle_kernel(const uint8_t* __restrict__ in, long long n, uint8_t* __restrict__ out,
                  long long nthreads, int block) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= nthreads) return;
  const int per_block = block / (8 * kG);
  const long long b = tid / per_block;
  const int q0 = (int)(tid - b * per_block) * kG;  // first group of this thread in block b
  const long long base = b * block + 8LL * q0;
  uint64_t w[kG];
  if (base + 8 * kG <= n) {
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(in + base);
    const ulonglong2 a = src[0], c = src[1];
    w[0] = a.x;
    w[1] = a.y;
    w[2] = c.x;
    w[3] = c.y;
  } else {  // the ragged tail: bytes past n are the zero padding
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      uint64_t v = 0;
      for (int j = 0; j < 8; ++j) {
        const long long i = base + 8 * g + j;
        if (i < n) v |= (uint64_t)in[i] << (8 * j);
      }
      w[g] = v;
    }
  }
#pragma unroll
  for (int g = 0; g < kG; ++g) w[g] = shuffle8(w[g]);
  const int plane = block / 8;
  uint8_t* dst = out + b * block + q0;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    uint32_t word = 0;
#pragma unroll
    for (int g = 0; g < kG; ++g) word |= (uint32_t)((w[g] >> (8 * p)) & 0xFFu) << (8 * g);
    *reinterpret_cast<uint32_t*>(dst + (long long)p * plane) = word;
  }
}

__global__ void __launch_bounds__(kThreads)
bitunshuffle_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, long long nthreads, int block) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= nthreads) return;
  const int per_block = block / (8 * kG);
  const long long b = tid / per_block;
  const int q0 = (int)(tid - b * per_block) * kG;
  const int plane = block / 8;
  const uint8_t* src = in + b * block + q0;
  uint64_t w[kG] = {0, 0, 0, 0};
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const uint32_t word = *reinterpret_cast<const uint32_t*>(src + (long long)p * plane);
#pragma unroll
    for (int g = 0; g < kG; ++g) w[g] |= (uint64_t)((word >> (8 * g)) & 0xFFu) << (8 * p);
  }
  ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + b * block + 8LL * q0);
  dst[0] = make_ulonglong2(shuffle8(w[0]), shuffle8(w[1]));
  dst[1] = make_ulonglong2(shuffle8(w[2]), shuffle8(w[3]));
}

long long threads_of(long long nblocks, int block) { return nblocks * (block / (8 * kG)); }
long long grid_of(long long nthreads) { return (nthreads + kThreads - 1) / kThreads; }

}  // namespace

// C interface (ctypes). `block` is a positive multiple of 32; the wrapper
// passes 16-byte-aligned device pointers. Launch on `stream`; return
// cudaGetLastError().
//
// bitshuffle: `in` n device bytes, `out` nblocks * block bytes with
// nblocks = ceil(n / block); bytes past n shuffle as zeros.
extern "C" int bitshuffle(const uint8_t* in, long long n, uint8_t* out, long long nblocks, int block,
                          void* stream) {
  if (nblocks <= 0) return 0;
  const long long nt = threads_of(nblocks, block);
  bitshuffle_kernel<<<(unsigned)grid_of(nt), kThreads, 0, (cudaStream_t)stream>>>(in, n, out, nt, block);
  return (int)cudaGetLastError();
}

// bitunshuffle: `in` and `out` nblocks * block device bytes.
extern "C" int bitunshuffle(const uint8_t* in, uint8_t* out, long long nblocks, int block, void* stream) {
  if (nblocks <= 0) return 0;
  const long long nt = threads_of(nblocks, block);
  bitunshuffle_kernel<<<(unsigned)grid_of(nt), kThreads, 0, (cudaStream_t)stream>>>(in, out, nt, block);
  return (int)cudaGetLastError();
}
