// Encode frontend kernels for Hopper (sm_90a).
//
// Replaces: repaq_tpu/ops/pallas_tpu.py `_frontend_kernel`, as reached
// through `encode_frontend_meta32` on the SE and PE encode paths
// (frontend_kernel) and through `encode_frontend_pallas`, the byte form
// (frontend_bytes_kernel); and `_pack_kernel`, as reached through
// `pack_bases_pallas` (pack_kernel).
//
// frontend_kernel: one pass over the seq and qual bytes of a chunk. Per
// base it writes
//   * the 2-bit code (A=1 T=2 C=3, anything else 0), four bases per
//     packed byte with base k in bits 2k..2k+1;
//   * one meta byte: the quality bin id in bits 0-6 (0..B-1 for a palette
//     entry, B for an escape, B+1 for the major qual) and bit 7 set when
//     the base is 'N'.
// Both encode paths read its meta byte.
//
// frontend_bytes_kernel: the byte form's three outputs straight from the
// same quality LUT, in one launch: the packed codes, the N mask as 0/1
// bytes (a bool tensor's storage) and the bin id as int32.
//
// pack_kernel: the 2-bit codes alone, for any n; bases past n pack as 'G'
// (code 0), so the last byte of a ragged tail is zero-padded as the
// reference pads it.
//
// What bounds them on the card: memory. The meta frontend reads 2 bytes
// and writes 1.25 per base, the byte form 2 and 5.25, the pack 1 and 0.25,
// so at 3.35 TB/s a 12-Mbase chunk cannot take less than about 12, 26 and
// 4.5 us. Every access is coalesced and wide: a thread step loads 16 seq
// (and 16 qual) bytes as 16-byte vectors and stores the 4 packed bytes as
// one word, the meta or N-mask bytes as one 16-byte vector and the bin
// ids as four, staged in shared memory so that each warp store is
// contiguous. The TPU's compare chain against the palette becomes a
// 256-entry byte LUT that each block builds in shared memory from
// `bins`/`major`; all lanes of a warp that read the same qual char hit one
// shared-memory word, which the hardware broadcasts.
//
// frontend_kernel compares each base against 'A', 'T' and 'C' in turn.
// pack_kernel and frontend_bytes_kernel are shaped like the unpack kernel
// (unpack.cu): each thread has kVecs groups of 16 bases in flight before it
// uses any, the groups a block's width apart so that every warp load and
// store covers consecutive addresses, and the grid is one wave of resident
// blocks (the SM count and the occupancy asked of the runtime), striding
// past it. They classify a 32-bit word of four bases at once (pack_word):
// an exact per-byte equality in the word's low 7 bits, where adding 0x7F
// to each byte cannot carry into the next, with bit 7 of the word itself
// ruling out bytes 0x80-0xFF; the four codes are then gathered into one
// byte by a multiply. That is about 14 integer operations for four bases,
// against about 9 a base for the compare chain.
//
// A ragged n costs no padding copy. frontend_kernel covers n / 16 whole
// groups and block 0 finishes the last n % 16 bases byte by byte; in the
// other two the last block's first threads do. The wrappers
// (repaq_tpu_torch/ops/kernels.py) guarantee 16-byte aligned buffers.
//
// Build switches, for tools/profile_frontend.py: REPAQ_FRONT_VECS (groups a
// thread keeps in flight), REPAQ_FRONT_BLOCKS_PER_SM (a cap on the wave's
// resident blocks an SM) and REPAQ_FRONT_ABLATE (1: the classification
// replaced by a plain copy of the loaded bytes; 2: the loads alone, their
// results stored only on a value they never take; both wrong on purpose).

#include <cstdint>
#include <cuda_runtime.h>

#ifndef REPAQ_FRONT_VECS
#define REPAQ_FRONT_VECS 2
#endif
#ifndef REPAQ_FRONT_BLOCKS_PER_SM
#define REPAQ_FRONT_BLOCKS_PER_SM 0
#endif
#ifndef REPAQ_FRONT_ABLATE
#define REPAQ_FRONT_ABLATE 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = REPAQ_FRONT_VECS;
constexpr int kGroupsPerBlock = kThreads * kVecs;  // 16 bases a group
constexpr uint32_t kLow7 = 0x7F7F7F7Fu;
constexpr uint32_t kHigh = 0x80808080u;
#if REPAQ_FRONT_ABLATE == 2
constexpr uint32_t kNever = 0x5A17C0DEu;  // the loads-only build's store key
#endif

__device__ __forceinline__ uint32_t base_code(uint32_t b) {
  return b == 'A' ? 1u : b == 'T' ? 2u : b == 'C' ? 3u : 0u;
}

// the packed byte of the four bases in a little-endian word
__device__ __forceinline__ uint32_t pack4(uint32_t w) {
  return base_code(w & 0xFFu) | (base_code((w >> 8) & 0xFFu) << 2) |
         (base_code((w >> 16) & 0xFFu) << 4) | (base_code(w >> 24) << 6);
}

// bit 7 of each byte set where the byte's low 7 bits (lo7, bit 7 clear)
// differ from c4's byte (the same in all four, below 0x80)
__device__ __forceinline__ uint32_t differs7(uint32_t lo7, uint32_t c4) {
  return (lo7 ^ c4) + kLow7;
}

// the packed byte of the four bases in a little-endian word w, in bits
// 24..31 (the bits below are not zero): exact for all 256 byte values
__device__ __forceinline__ uint32_t pack_word(uint32_t w) {
  const uint32_t lo7 = w & kLow7;
  // 'A' (0x41) and 'C' (0x43) differ in bit 1 alone
  const uint32_t ac = differs7(lo7 | 0x02020202u, 0x43434343u);
  const uint32_t t = differs7(lo7, 0x54545454u);
  const uint32_t c = differs7(lo7, 0x43434343u);
  const uint32_t bit0 = ~(ac | w) & kHigh;       // A or C
  const uint32_t bit1 = ~((t & c) | w) & kHigh;  // T or C
  // byte k's code in bits 8k+6..8k+7, moved to 24+2k by the multiply; the
  // other products land on disjoint bits, so nothing carries
  return ((bit0 >> 1) | bit1) * 0x00041041u;
}

// the 4 packed bytes of 16 bases
__device__ __forceinline__ uint32_t pack16(uint4 s) {
  const uint32_t lo = __byte_perm(pack_word(s.x), pack_word(s.y), 0x0073);
  const uint32_t hi = __byte_perm(pack_word(s.z), pack_word(s.w), 0x0073);
  return __byte_perm(lo, hi, 0x5410);
}

// 1 in each byte of w that is 'N', else 0
__device__ __forceinline__ uint32_t n_bytes(uint32_t w) {
  return (~(differs7(w & kLow7, 0x4E4E4E4Eu) | w) & kHigh) >> 7;
}

// quality char -> bin id, built by the block's threads
__device__ __forceinline__ void build_lut(uint8_t* lut,
                                          const uint8_t* __restrict__ bins,
                                          int nbins, int major) {
  for (int c = threadIdx.x; c < 256; c += blockDim.x) {
    int id = nbins;  // escape unless the palette names it
    for (int j = 0; j < nbins; ++j) {
      if (bins[j] == c) id = j;  // the last match wins, as in the TPU chain
    }
    if (c == major) id = nbins + 1;
    lut[c] = static_cast<uint8_t>(id);
  }
  __syncthreads();
}

__global__ void frontend_kernel(const uint8_t* __restrict__ seq,
                                const uint8_t* __restrict__ qual,
                                const uint8_t* __restrict__ bins, int nbins,
                                int major, uint8_t* __restrict__ packed,
                                uint8_t* __restrict__ meta, long long n) {
  __shared__ uint8_t lut[256];
  build_lut(lut, bins, nbins, major);

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

// the packed byte of seq[4j..4j+3], bases at or past n as 'G'
__device__ __forceinline__ uint8_t packed_tail_byte(
    const uint8_t* __restrict__ seq, long long j, long long n) {
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = 4 * j + k;
    w |= (i < n ? static_cast<uint32_t>(seq[i]) : uint32_t{'G'}) << (8 * k);
  }
  return static_cast<uint8_t>(pack_word(w) >> 24);
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint4* __restrict__ seq, uint32_t* __restrict__ packed,
            long long n) {
  const long long groups = n >> 4;
  for (long long base = static_cast<long long>(blockIdx.x) * kGroupsPerBlock;
       base < groups;
       base += static_cast<long long>(gridDim.x) * kGroupsPerBlock) {
    uint4 s[kVecs];
#pragma unroll
    for (int r = 0; r < kVecs; ++r) {
      const long long g = base + r * kThreads + threadIdx.x;
      s[r] = g < groups ? __ldg(seq + g) : make_uint4(0, 0, 0, 0);
    }
#if REPAQ_FRONT_ABLATE == 2
    uint32_t acc = 0;
#pragma unroll
    for (int r = 0; r < kVecs; ++r) acc ^= s[r].x ^ s[r].y ^ s[r].z ^ s[r].w;
    if (acc == kNever && base + threadIdx.x < groups) {
      packed[base + threadIdx.x] = acc;
    }
#else
#pragma unroll
    for (int r = 0; r < kVecs; ++r) {
      const long long g = base + r * kThreads + threadIdx.x;
      if (g >= groups) continue;
#if REPAQ_FRONT_ABLATE == 1
      packed[g] = s[r].x ^ s[r].y ^ s[r].z ^ s[r].w;
#else
      packed[g] = pack16(s[r]);
#endif
    }
#endif
  }

  // the n % 16 tail: up to 4 packed bytes, one a thread of the last block
  const long long j = (groups << 2) + threadIdx.x;
  if (blockIdx.x == gridDim.x - 1 && j < ((n + 3) >> 2)) {
    reinterpret_cast<uint8_t*>(packed)[j] =
        packed_tail_byte(reinterpret_cast<const uint8_t*>(seq), j, n);
  }
}

// The bin ids of a round's kThreads groups (16 KB, contiguous in bid) pass
// through shared memory: each thread stages its group's four 16-byte
// vectors, then the block stores the round's vectors in order, each warp
// store covering 512 consecutive bytes. Stored straight from each thread,
// a warp store covered 16 bytes of every 64, and the kernel took about 1.5
// times as long on an H100 (tools/profile_frontend.py). Each thread's
// vectors start 5 vectors after the previous thread's, so the 8 lanes of
// a quarter-warp stage into distinct banks.
__global__ void __launch_bounds__(kThreads)
frontend_bytes_kernel(const uint4* __restrict__ seq,
                      const uint4* __restrict__ qual,
                      const uint8_t* __restrict__ bins, int nbins, int major,
                      uint32_t* __restrict__ packed, uint4* __restrict__ nmask,
                      uint4* __restrict__ bid, long long n) {
  __shared__ uint8_t lut[256];
  __shared__ uint4 stage[kThreads * 5];
  build_lut(lut, bins, nbins, major);

  const long long groups = n >> 4;
  for (long long base = static_cast<long long>(blockIdx.x) * kGroupsPerBlock;
       base < groups;
       base += static_cast<long long>(gridDim.x) * kGroupsPerBlock) {
    uint4 s[kVecs], q[kVecs];
#pragma unroll
    for (int r = 0; r < kVecs; ++r) {
      const long long g = base + r * kThreads + threadIdx.x;
      const bool in = g < groups;
      s[r] = in ? __ldg(seq + g) : make_uint4(0, 0, 0, 0);
      q[r] = in ? __ldg(qual + g) : make_uint4(0, 0, 0, 0);
    }
#if REPAQ_FRONT_ABLATE == 2
    uint32_t acc = 0;
#pragma unroll
    for (int r = 0; r < kVecs; ++r) {
      acc ^= s[r].x ^ s[r].y ^ s[r].z ^ s[r].w ^ q[r].x ^ q[r].y ^ q[r].z ^
             q[r].w;
    }
    if (acc == kNever && base + threadIdx.x < groups) {
      packed[base + threadIdx.x] = acc;
    }
#else
#pragma unroll
    for (int r = 0; r < kVecs; ++r) {
      const long long first = base + r * kThreads;  // the round's groups
      const long long g = first + threadIdx.x;
#if REPAQ_FRONT_ABLATE == 1
      if (g < groups) {
        packed[g] = s[r].x ^ s[r].y ^ s[r].z ^ s[r].w;
        nmask[g] = s[r];
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) stage[threadIdx.x * 5 + w] = q[r];
#else
      if (g < groups) {
        packed[g] = pack16(s[r]);
        nmask[g] = make_uint4(n_bytes(s[r].x), n_bytes(s[r].y),
                              n_bytes(s[r].z), n_bytes(s[r].w));
      }
      const uint32_t qw[4] = {q[r].x, q[r].y, q[r].z, q[r].w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        stage[threadIdx.x * 5 + w] =
            make_uint4(lut[qw[w] & 0xFFu], lut[(qw[w] >> 8) & 0xFFu],
                       lut[(qw[w] >> 16) & 0xFFu], lut[qw[w] >> 24]);
      }
#endif
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = threadIdx.x + j * kThreads;  // vector k of the round
        if (first + (k >> 2) < groups) {
          bid[4 * first + k] = stage[(k >> 2) * 5 + (k & 3)];
        }
      }
      __syncthreads();
    }
#endif
  }

  // the n % 16 tail: a base a thread of the last block, and the up to 4
  // packed bytes on its first threads
  if (blockIdx.x == gridDim.x - 1) {
    const uint8_t* s8 = reinterpret_cast<const uint8_t*>(seq);
    const long long i = (groups << 4) + threadIdx.x;
    if (i < n) {
      reinterpret_cast<uint8_t*>(nmask)[i] = s8[i] == 'N';
      reinterpret_cast<int32_t*>(bid)[i] =
          lut[reinterpret_cast<const uint8_t*>(qual)[i]];
    }
    const long long j = (groups << 2) + threadIdx.x;
    if (j < ((n + 3) >> 2)) {
      reinterpret_cast<uint8_t*>(packed)[j] = packed_tail_byte(s8, j, n);
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

// The blocks of one wave of `kernel` on the current device (its SMs times
// the resident blocks an SM, asked of the runtime once a device and kernel).
template <int Which>
cudaError_t wave_blocks(const void* kernel, long long* blocks) {
  static long long cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev]) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  if (REPAQ_FRONT_BLOCKS_PER_SM > 0 && per_sm > REPAQ_FRONT_BLOCKS_PER_SM) {
    per_sm = REPAQ_FRONT_BLOCKS_PER_SM;
  }
  *blocks = static_cast<long long>(sms) * per_sm;
  if (dev < 64) cached[dev] = *blocks;
  return cudaSuccess;
}

// the grid of a streaming kernel: the blocks n bases need, at most one wave
long long stream_grid(long long n, long long wave) {
  const long long need = ((n >> 4) + kGroupsPerBlock - 1) / kGroupsPerBlock;
  return need < 1 ? 1 : need < wave ? need : wave;
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

// Bases one wave of each streaming kernel covers on the current device
// (the card tests place their edge cases by it); 0 on an error.
extern "C" long long repaq_pack_wave_bases() {
  long long blocks = 0;
  wave_blocks<0>(reinterpret_cast<const void*>(pack_kernel), &blocks);
  return 16LL * kGroupsPerBlock * blocks;
}

extern "C" long long repaq_frontend_bytes_wave_bases() {
  long long blocks = 0;
  wave_blocks<1>(reinterpret_cast<const void*>(frontend_bytes_kernel),
                 &blocks);
  return 16LL * kGroupsPerBlock * blocks;
}

extern "C" int repaq_encode_frontend_bytes(const void* seq, const void* qual,
                                           const void* bins, int nbins,
                                           int major, void* packed,
                                           void* nmask, void* bid, long long n,
                                           void* stream) {
  long long wave = 0;
  const cudaError_t err = wave_blocks<1>(
      reinterpret_cast<const void*>(frontend_bytes_kernel), &wave);
  if (err != cudaSuccess) return static_cast<int>(err);
  frontend_bytes_kernel<<<static_cast<unsigned>(stream_grid(n, wave)),
                          kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(seq), static_cast<const uint4*>(qual),
      static_cast<const uint8_t*>(bins), nbins, major,
      static_cast<uint32_t*>(packed), static_cast<uint4*>(nmask),
      static_cast<uint4*>(bid), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repaq_pack_bases(const void* seq, void* packed, long long n,
                                void* stream) {
  long long wave = 0;
  const cudaError_t err =
      wave_blocks<0>(reinterpret_cast<const void*>(pack_kernel), &wave);
  if (err != cudaSuccess) return static_cast<int>(err);
  pack_kernel<<<static_cast<unsigned>(stream_grid(n, wave)), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(seq), static_cast<uint32_t*>(packed), n);
  return static_cast<int>(cudaGetLastError());
}
