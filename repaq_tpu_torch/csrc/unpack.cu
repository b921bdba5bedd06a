// 2-bit base unpack for Hopper (sm_90a).
//
// Replaces: repaq_tpu/ops/pallas_tpu.py `_unpack_kernel`, as reached
// through `unpack_bases_pallas` on the decode path. Each packed byte
// becomes four base chars, low bits first: 0->G 1->A 2->T 3->C.
//
// What bounds it on the card: memory. It reads 1 byte and writes 4 per
// packed byte, about 15 MB for a 12-Mbase chunk, so at 3.35 TB/s it cannot
// take less than about 4.4 us. A kernel that keeps one 4-byte load a
// thread in flight reached ~40% of that on an NVIDIA H100 80GB HBM3 at
// 700 W: each SM holds only ~8 KB of reads in flight, and the grid runs in
// ~3 waves that each ramp up and drain.
// So here each thread loads 4 words (16 packed bytes) before it uses any,
// and a 12-Mbase chunk's grid is less than one wave of resident blocks:
// every load of the chunk is issued at once. The words a thread takes are
// a block's width apart, so a warp's loads (4 bytes a thread) and stores
// (16 bytes a thread) each cover consecutive addresses.
//
// A word becomes 16 chars with no table in memory: its 2-bit codes are
// spread into nibbles (three shift-or-mask rounds for two bytes), and one
// byte permute of the 32-bit constant kChars turns four nibbles into four
// chars. The TPU kernel's u32 word output was a relayout dodge for the
// TPU; here the chars are bytes. The m % 4 bytes past the last word are
// done by the last block's first threads, in the same launch.
//
// The wrapper (repaq_tpu_torch/ops/kernels.py) guarantees 16-byte aligned
// buffers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kChars = 0x43544147u;  // bytes 'G' 'A' 'T' 'C', code order
constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;
constexpr int kWordsPerBlock = kThreads * kWordsPerThread;

// the eight 2-bit fields of x's low 16 bits, field k moved to bits 4k..4k+1
__device__ __forceinline__ uint32_t spread(uint32_t x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  return (x | (x << 2)) & 0x33333333u;
}

// the chars of one packed byte, whose fields spread() has put in nibbles
__device__ __forceinline__ uint32_t chars(uint32_t nibbles) {
  return __byte_perm(kChars, 0u, nibbles);
}

__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint32_t* __restrict__ packed, uint4* __restrict__ out,
              long long words, const uint8_t* __restrict__ tail_in,
              uint32_t* __restrict__ tail_out, int tail) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kWordsPerBlock + threadIdx.x;
  uint32_t w[kWordsPerThread];
#pragma unroll
  for (int r = 0; r < kWordsPerThread; ++r) {
    const long long g = base + r * kThreads;
    w[r] = g < words ? __ldg(packed + g) : 0u;
  }
#pragma unroll
  for (int r = 0; r < kWordsPerThread; ++r) {
    const long long g = base + r * kThreads;
    if (g < words) {
      const uint32_t lo = spread(w[r] & 0xFFFFu);
      const uint32_t hi = spread(w[r] >> 16);
      out[g] = make_uint4(chars(lo), chars(lo >> 16), chars(hi),
                          chars(hi >> 16));
    }
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < tail) {
    tail_out[threadIdx.x] = chars(spread(tail_in[threadIdx.x]));
  }
}

}  // namespace

extern "C" int repaq_unpack_bases(const void* packed, void* out, long long m,
                                  void* stream) {
  const long long words = m >> 2;
  const int tail = static_cast<int>(m & 3);
  long long blocks = (words + kWordsPerBlock - 1) / kWordsPerBlock;
  if (blocks < 1) blocks = 1;
  unpack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<uint4*>(out), words,
      static_cast<const uint8_t*>(packed) + 4 * words,
      static_cast<uint32_t*>(out) + 4 * words, tail);
  return static_cast<int>(cudaGetLastError());
}
