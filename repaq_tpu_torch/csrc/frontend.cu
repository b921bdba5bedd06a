// Fused encode frontend and pack-only kernel for Hopper (sm_90a).
//
// Replaces: repaq_tpu/ops/pallas_tpu.py `_frontend_kernel`, as reached
// through `encode_frontend_meta32` on the SE encode path and through
// `encode_frontend_pallas` (the byte form) on the PE encode path; and
// `_pack_kernel`, as reached through `pack_bases_pallas`.
//
// frontend_kernel: one pass over the seq and qual bytes of a chunk. Per
// base it writes
//   * the 2-bit code (A=1 T=2 C=3, anything else 0), four bases per
//     packed byte with base k in bits 2k..2k+1;
//   * one meta byte: the quality bin id in bits 0-6 (0..B-1 for a palette
//     entry, B for an escape, B+1 for the major qual) and bit 7 set when
//     the base is 'N'.
// The TPU needed two entry points for this kernel because of its u32 word
// relayout; here both forms launch the same kernel for any n, and both
// encode paths read its meta byte (the byte form's (nmask, bid), for the
// tests, are the meta byte's two fields, split by the wrapper).
//
// pack_kernel: the 2-bit codes alone, for any n; bases past n pack as 'G'
// (code 0), so the last byte of a ragged tail is zero-padded as the
// reference pads it.
//
// What bounds both on the card: memory. The frontend reads 2 bytes and
// writes 1.25 bytes per base, the pack 1 and 0.25, with a handful of
// integer operations each, so at 3.35 TB/s a 12-Mbase chunk cannot take
// less than about 13 us and 5 us. The design keeps every access coalesced
// and wide: each thread step loads 16 seq (and 16 qual) bytes as 16-byte
// vectors and stores 4 packed bytes as one 4-byte word (and 16 meta bytes
// as one 16-byte vector). The TPU's compare chain against the palette
// becomes a 256-entry byte LUT that each block builds in shared memory from
// `bins`/`major`; all lanes of a warp that read the same qual char hit one
// shared-memory word, which the hardware broadcasts.
//
// A ragged n costs no padding copy: the 16-byte steps cover n / 16 whole
// groups and block 0 finishes the last n % 16 bases byte by byte. The
// wrapper (repaq_tpu_torch/ops/kernels.py) guarantees 16-byte aligned seq,
// qual and meta buffers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t base_code(uint32_t b) {
  return b == 'A' ? 1u : b == 'T' ? 2u : b == 'C' ? 3u : 0u;
}

// the packed byte of the four bases in a little-endian word
__device__ __forceinline__ uint32_t pack4(uint32_t w) {
  return base_code(w & 0xFFu) | (base_code((w >> 8) & 0xFFu) << 2) |
         (base_code((w >> 16) & 0xFFu) << 4) | (base_code(w >> 24) << 6);
}

__global__ void frontend_kernel(const uint8_t* __restrict__ seq,
                                const uint8_t* __restrict__ qual,
                                const uint8_t* __restrict__ bins, int nbins,
                                int major, uint8_t* __restrict__ packed,
                                uint8_t* __restrict__ meta, long long n) {
  __shared__ uint8_t lut[256];
  for (int c = threadIdx.x; c < 256; c += blockDim.x) {
    int id = nbins;  // escape unless the palette names it
    for (int j = 0; j < nbins; ++j) {
      if (bins[j] == c) id = j;  // the last match wins, as in the TPU chain
    }
    if (c == major) id = nbins + 1;
    lut[c] = static_cast<uint8_t>(id);
  }
  __syncthreads();

  const long long groups = n >> 4;  // 16 bases per thread step
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    const uint4 s = reinterpret_cast<const uint4*>(seq)[g];
    const uint4 q = reinterpret_cast<const uint4*>(qual)[g];
    const uint32_t sw[4] = {s.x, s.y, s.z, s.w};
    const uint32_t qw[4] = {q.x, q.y, q.z, q.w};
    uint32_t pk = 0;
    uint32_t mw[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      pk |= pack4(sw[w]) << (8 * w);
      uint32_t m = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t b = (sw[w] >> (8 * k)) & 0xFFu;
        const uint32_t c = (qw[w] >> (8 * k)) & 0xFFu;
        m |= (static_cast<uint32_t>(lut[c]) | (b == 'N' ? 0x80u : 0u))
             << (8 * k);
      }
      mw[w] = m;
    }
    reinterpret_cast<uint32_t*>(packed)[g] = pk;
    reinterpret_cast<uint4*>(meta)[g] = make_uint4(mw[0], mw[1], mw[2], mw[3]);
  }

  // tail of n % 16 bases: one packed byte per 4 bases, the missing bases
  // of the last one as code 0 ('G'); no meta past n
  if (blockIdx.x == 0) {
    const long long nbytes = (n + 3) >> 2;
    for (long long j = (groups << 2) + threadIdx.x; j < nbytes;
         j += blockDim.x) {
      uint32_t pk = 0;
      for (int k = 0; k < 4; ++k) {
        const long long i = 4 * j + k;
        if (i >= n) break;
        const uint32_t b = seq[i];
        pk |= base_code(b) << (2 * k);
        meta[i] = static_cast<uint8_t>(lut[qual[i]] | (b == 'N' ? 0x80u : 0u));
      }
      packed[j] = static_cast<uint8_t>(pk);
    }
  }
}

__global__ void pack_kernel(const uint8_t* __restrict__ seq,
                            uint8_t* __restrict__ packed, long long n) {
  const long long groups = n >> 4;  // 16 bases per thread step
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    const uint4 s = reinterpret_cast<const uint4*>(seq)[g];
    reinterpret_cast<uint32_t*>(packed)[g] =
        pack4(s.x) | (pack4(s.y) << 8) | (pack4(s.z) << 16) |
        (pack4(s.w) << 24);
  }

  // tail of n % 16 bases: one packed byte per 4 bases, 'G' past n
  if (blockIdx.x == 0) {
    const long long nbytes = (n + 3) >> 2;
    for (long long j = (groups << 2) + threadIdx.x; j < nbytes;
         j += blockDim.x) {
      uint32_t pk = 0;
      for (int k = 0; k < 4; ++k) {
        const long long i = 4 * j + k;
        pk |= (i < n ? base_code(seq[i]) : 0u) << (2 * k);
      }
      packed[j] = static_cast<uint8_t>(pk);
    }
  }
}

unsigned grid_for(long long n) {
  const long long threads = 256;
  long long blocks = ((n >> 4) + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride past this
  return static_cast<unsigned>(blocks);
}

}  // namespace

extern "C" int repaq_encode_frontend(const void* seq, const void* qual,
                                     const void* bins, int nbins, int major,
                                     void* packed, void* meta, long long n,
                                     void* stream) {
  frontend_kernel<<<grid_for(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), static_cast<const uint8_t*>(qual),
      static_cast<const uint8_t*>(bins), nbins, major,
      static_cast<uint8_t*>(packed), static_cast<uint8_t*>(meta), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repaq_pack_bases(const void* seq, void* packed, long long n,
                                void* stream) {
  pack_kernel<<<grid_for(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), static_cast<uint8_t*>(packed), n);
  return static_cast<int>(cudaGetLastError());
}
