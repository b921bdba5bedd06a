// The first chunk's quality scan for Hopper (sm_90a): the quality
// histogram and the N-policy reductions the header is made from, in one
// launch over the chunk's bases.
//
// Replaces: XLA code of the JAX package, not a Pallas kernel: the
// `stats_step` of DeviceEngine.quality_stats,
// repaq_tpu/codec/device_engine.py:172-235 (its sort-based histogram
// and six reductions). The port ran it as torch.bincount, whose global
// atomics crowd onto the 4 addresses of NovaSeq's 4-bin qualities, and
// about 20 elementwise and reduction passes.
//
// The function (reference rfqheader.cpp:130-237). Over seq and qual of n
// bases: the count of each quality value below 128, and six scalars:
// quals >= 128; bases that are none of A, C, G, T, N; Ns; the qual at the
// first N (at base 0 when there is none, as torch.argmax gives); Ns whose
// qual differs from it; non-N bases at or after the first N with that
// qual. With f the first N and q its qual, the last is
// hist[q] - histN[q] - pre[q]: every base with qual q, less the Ns with
// qual q (all at or after f) and the bases before f with qual q (pre), or
// hist[q] when there is no N.
//
// What bounds it on the card: memory: one read of seq and qual, 2 bytes a
// base (24 MB for a 12-Mbase chunk, ~0.0072 ms at 3.35 TB/s).
//
// The design: a persistent grid of one wave, each block taking tiles of
// kTile bases in ticket order (an atomic counter). Per tile:
//   1. Each thread loads its bases (16-byte loads of seq and qual) and
//      counts its Ns, its invalid bases and its first N; the block's first
//      N by a shared atomicMin.
//   2. Each qual is counted in the block's histogram in shared memory,
//      one copy a lane (hist[v][(lane + v) % 32], so that the lanes of a
//      warp never meet on an address or a bank), kept across the block's
//      tiles: no global atomic an element. An N's qual goes into a second
//      histogram.
//   3. Whether an earlier tile holds an N, by a look-back over one status
//      word a tile (a tile with an N publishes "N up to here" at once, one
//      without publishes "none here", then its inclusive value). A tile
//      with no N before it counts its quals before its first N (all of
//      them if it has none) into pre; the one holding the first N writes
//      its position.
// At its end each block adds its histograms' non-zero bins and its counts
// into global words; the last block to finish (a done counter) writes
// the 128 counts and the six scalars. The output, the global words and
// the status words lie in one buffer the wrapper zero-fills: a call is
// two device operations, that fill and this kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 16;                          // bases a load
constexpr int kSteps = 4;                         // loads a thread a tile
constexpr int kTile = kThreads * kVec * kSteps;   // bases a tile
constexpr int kCopies = 32;                       // histogram copies, one a lane
constexpr int kOut = 128 + 6;                     // int64 output words
// 32-bit global words after the output: hist, histN, pre (256 each), then
// the counters
constexpr int kHist = 0, kHistN = 256, kPre = 512, kTicket = 768, kDone = 769,
              kFirst = 770, kNCount = 771, kInvalid = 772, kStatus = 776;
constexpr uint32_t kNone = 1, kInclNone = 2, kInclN = 3;  // a tile's status
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kHead = (8 * kOut + 15) & ~15;  // the output's bytes, aligned

__device__ __forceinline__ void store_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t load_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// byte k of a 16-byte vector
__device__ __forceinline__ uint32_t byte_of(const uint4& v, int k) {
  const uint32_t w = (k >> 2) == 0 ? v.x : (k >> 2) == 1 ? v.y : (k >> 2) == 2 ? v.z : v.w;
  return (w >> (8 * (k & 3))) & 0xFF;
}

__device__ __forceinline__ bool is_base(uint32_t c) {
  return c == 'A' || c == 'C' || c == 'G' || c == 'T';
}

struct Params {
  const uint8_t* seq;
  const uint8_t* qual;
  long long n;
  long long tiles;
  int64_t* out;    // kOut words
  uint32_t* glob;  // the global words and the status words
};

__global__ void __launch_bounds__(kThreads) stats_kernel(Params p) {
  __shared__ uint32_t hist[256 * kCopies];
  __shared__ uint32_t hist_n[256];
  __shared__ uint32_t pre[256];
  __shared__ long long ticket;
  __shared__ int first_n;       // the tile's first N, kTile when none
  __shared__ int n_before;      // an N in an earlier tile
  __shared__ uint32_t counts[2];  // Ns, invalid bases
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int w = tid; w < 256 * kCopies; w += kThreads) hist[w] = 0;
  for (int w = tid; w < 256; w += kThreads) hist_n[w] = 0, pre[w] = 0;
  if (tid < 2) counts[tid] = 0;
  uint32_t* status = p.glob + kStatus;

  for (;;) {
    __syncthreads();
    if (tid == 0) {
      ticket = atomicAdd(p.glob + kTicket, 1u);
      first_n = kTile;
    }
    __syncthreads();
    const long long t = ticket;
    if (t >= p.tiles) break;
    const long long base = t * kTile;

    // 1. the loads, and each thread's Ns, invalid bases and first N
    uint4 sv[kSteps], qv[kSteps];
    int my_first = kTile;
    uint32_t my_n = 0, my_bad = 0;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int at = (s * kThreads + tid) * kVec;  // within the tile
      const long long i = base + at;
      if (i + kVec <= p.n && (reinterpret_cast<uintptr_t>(p.seq + i) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(p.qual + i) & 15) == 0) {
        sv[s] = *reinterpret_cast<const uint4*>(p.seq + i);
        qv[s] = *reinterpret_cast<const uint4*>(p.qual + i);
      } else {
        alignas(16) uint8_t sb[kVec];
        alignas(16) uint8_t qb[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          // past n: a G with qual 0, counted nowhere below
          sb[k] = i + k < p.n ? p.seq[i + k] : 'G';
          qb[k] = i + k < p.n ? p.qual[i + k] : 0;
        }
        sv[s] = *reinterpret_cast<const uint4*>(sb);
        qv[s] = *reinterpret_cast<const uint4*>(qb);
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const uint32_t c = byte_of(sv[s], k);
        if (c == 'N') {
          ++my_n;
          my_first = min(my_first, at + k);
        } else if (!is_base(c)) {
          ++my_bad;
        }
      }
    }
    if (my_first < kTile) atomicMin(&first_n, my_first);
    __syncthreads();
    const int tile_first = first_n;
    if (tid == 0 && tile_first < kTile) store_relaxed(status + t, kInclN);
    if (tid == 0 && tile_first == kTile) store_relaxed(status + t, t == 0 ? kInclNone : kNone);

    // 3. (warp 0, while the others count) an N before this tile?
    if (warp == 0) {
      bool found = false;
      for (long long hi = t - 1; hi >= 0; hi -= 32) {
        const long long k = hi - lane;
        uint32_t st = k < 0 ? kInclNone : 0;
        while (!__all_sync(kFull, st != 0)) {
          if (st == 0) st = load_relaxed(status + k);
        }
        const unsigned incls = __ballot_sync(kFull, st >= kInclNone);
        if (incls) {
          const int nearest = __ffs(incls) - 1;
          found = __shfl_sync(kFull, st, nearest) == kInclN;
          break;
        }
      }
      if (lane == 0) {
        n_before = found;
        if (tile_first == kTile && t > 0) store_relaxed(status + t, found ? kInclN : kInclNone);
      }
    }

    // 2. the histograms
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const long long i = base + (s * kThreads + tid) * kVec;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (i + k >= p.n) break;
        const uint32_t q = byte_of(qv[s], k);
        atomicAdd(&hist[q * kCopies + ((lane + q) & 31)], 1u);
        if (byte_of(sv[s], k) == 'N') atomicAdd(&hist_n[q], 1u);
      }
    }
    // the counts a warp, into the block's
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      my_n += __shfl_down_sync(kFull, my_n, d);
      my_bad += __shfl_down_sync(kFull, my_bad, d);
    }
    if (lane == 0 && (my_n | my_bad)) {
      atomicAdd(&counts[0], my_n);
      atomicAdd(&counts[1], my_bad);
    }
    __syncthreads();

    // the quals before the first N, in the tiles up to it
    if (!n_before) {
      if (tid == 0 && tile_first < kTile) {
        p.glob[kFirst] = static_cast<uint32_t>(base + tile_first + 1);
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int at = (s * kThreads + tid) * kVec;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          if (at + k >= tile_first || base + at + k >= p.n) break;
          atomicAdd(&pre[byte_of(qv[s], k)], 1u);
        }
      }
    }
  }

  // the block's histograms and counts into the global words
  {
    uint32_t sum = 0;
#pragma unroll 8
    for (int c = 0; c < kCopies; ++c) sum += hist[tid * kCopies + ((c + tid) & 31)];
    if (sum) atomicAdd(p.glob + kHist + tid, sum);
    if (hist_n[tid]) atomicAdd(p.glob + kHistN + tid, hist_n[tid]);
    if (pre[tid]) atomicAdd(p.glob + kPre + tid, pre[tid]);
    if (tid == 0 && counts[0]) atomicAdd(p.glob + kNCount, counts[0]);
    if (tid == 0 && counts[1]) atomicAdd(p.glob + kInvalid, counts[1]);
  }
  static_assert(kThreads == 256, "a thread a histogram bin");
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (tid == 0) last = atomicAdd(p.glob + kDone, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: the counts and the scalars
  const uint32_t h = __ldcg(p.glob + kHist + tid);
  if (tid < 128) p.out[tid] = h;
  uint32_t hi = tid >= 128 ? h : 0;
  __shared__ uint32_t warp_hi[kWarps];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) hi += __shfl_down_sync(kFull, hi, d);
  if (lane == 0) warp_hi[warp] = hi;
  __syncthreads();
  if (tid == 0) {
    uint32_t ge128 = 0;
    for (int w = 0; w < kWarps; ++w) ge128 += warp_hi[w];
    const uint32_t first = __ldcg(p.glob + kFirst);
    const uint32_t n_count = __ldcg(p.glob + kNCount);
    const long long f = first ? first - 1LL : 0LL;
    const uint32_t q = p.qual[f];
    const uint32_t hq = __ldcg(p.glob + kHist + q);
    const uint32_t nq = __ldcg(p.glob + kHistN + q);
    const uint32_t pq = __ldcg(p.glob + kPre + q);
    p.out[128] = ge128;
    p.out[129] = __ldcg(p.glob + kInvalid);
    p.out[130] = n_count;
    p.out[131] = q;
    p.out[132] = static_cast<int64_t>(n_count) - nq;
    p.out[133] = n_count ? static_cast<int64_t>(hq) - nq - pq : static_cast<int64_t>(hq);
  }
}

long long stats_tiles(long long n) { return (n + kTile - 1) / kTile; }

// one wave of the kernel on the current device, asked of the runtime once
cudaError_t wave_blocks(long long* blocks) {
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stats_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *blocks = static_cast<long long>(sms) * per_sm;
  if (dev < 64) cached[dev] = *blocks;
  return cudaSuccess;
}

}  // namespace

// Bases per tile (the card tests place their edge cases by it).
extern "C" long long repaq_stats_tile() { return kTile; }

// Bytes of the zeroed buffer the kernel needs for n bases (a multiple of
// 16): the kOut int64 output words, then the 32-bit global words and one
// status word a tile.
extern "C" long long repaq_stats_buffer_bytes(long long n) {
  return kHead + 4 * ((kStatus + stats_tiles(n) + 3) & ~3LL);
}

// The quality scan of seq and qual (n bytes each) into buf (zeroed,
// repaq_stats_buffer_bytes(n) bytes, 16-byte aligned): its first 134 int64
// words are the counts of quals 0..127, then quals >= 128, invalid bases,
// Ns, the qual at the first N (at base 0 without one), Ns of another
// qual, and non-N bases at or after the first N with its qual.
extern "C" int repaq_qual_stats(const void* seq, const void* qual, long long n, void* buf,
                                void* stream) {
  if (n < 1 || n >= (1LL << 31) - kTile) return static_cast<int>(cudaErrorInvalidValue);
  long long wave = 0;
  cudaError_t err = wave_blocks(&wave);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = stats_tiles(n);
  const long long blocks = tiles < wave ? tiles : wave;
  Params p{static_cast<const uint8_t*>(seq), static_cast<const uint8_t*>(qual), n, tiles,
           static_cast<int64_t*>(buf),
           reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(buf) + kHead)};
  stats_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
