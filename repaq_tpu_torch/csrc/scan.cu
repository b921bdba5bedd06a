// Run-boundary scans for Hopper (sm_90a): the inclusive running maximum of
// an int32 row from its start, and the inclusive running minimum from its
// end (the suffix minimum), over a 1-D array or each row of a 2-D one.
//
// Replaces: XLA code of the JAX package, not a Pallas kernel. `_cummax`
// (`jax.lax.cummax`) and `_suffix_min` (`jax.lax.cummin` between two flips)
// of repaq_tpu/ops/device_streams.py:33-38, and the row-wise pair in
// `coords_encode2_device`. The port's callers (repaq_tpu_torch/ops/
// device_streams.py) find, for each position, the last run start at or
// before it and the first run end at or after it in every quality and
// N-position stream, the repeat runs of X and Y, and the decode's segment
// bases.
//
// What bounds it on the card: memory. The function reads each int32 once
// and writes one: 8 bytes an element. At 3.35 TB/s a 2,359,296-element
// stream cannot take less than ~5.6 us, a 12-Mbase chunk's ~28 us. The
// work per element is one max or min and a share of a few shuffles.
//
// The design is one kernel, one pass, nothing of size n in device memory
// but the input and the output: a single-pass scan over tiles with
// decoupled look-back (Merrill and Garland), as csrc/token_fsm.cu. A tile
// is kThreads threads' kVecs 16-byte vectors; each warp owns a contiguous
// span of 32 * 4 * kVecs elements. Per tile:
//   1. Each warp loads its span with 16-byte vector loads at consecutive
//      addresses (vector q of lane l holds elements 128q + 4l .. +3), all
//      loads issued before any use.
//   2. Per vector: a thread scans its four elements, the warp scans the
//      threads' totals with five shuffles, and a running value carries the
//      warp's earlier vectors into the later ones. The suffix minimum runs
//      every step from the high end: its vectors, lanes and elements are
//      taken in reverse, so it reads backwards with no flipped copy.
//   3. The warps' totals are scanned by warp 0, which gives each warp the
//      value of the warps before it in scan order and the tile its total.
//   4. Look-back for the value of the tiles before this one. Tiles take
//      their index from an atomic counter in launch order, so a tile waits
//      only on tiles that have started; the counter runs over the rows,
//      row r's tiles after row r - 1's. Each tile publishes its total
//      (flag 1) as soon as it has it, then its inclusive value (flag 2)
//      once it knows the value before it, in one 64-bit status word (flag
//      above the 32-bit value) stored with release semantics; warp 0 reads
//      the 32 tiles before (one status word a lane) with acquire loads and
//      folds them back to the nearest inclusive value, or folds all 32 and
//      reads the 32 before those. Max and min are commutative and
//      idempotent, so the fold takes any order, and a row's first tile
//      reads the identity (INT32_MIN for max, INT32_MAX for min).
//   5. Each element takes the max (min) of itself and the value before its
//      warp, and the warp stores its span with 16-byte vector stores.
// A 2-D input is one launch: the row rides in the tile index. Rows whose
// start is not 16-byte aligned (n % 4 != 0, rows after the first) and the
// ragged end of a row go element by element.
// The wrapper (repaq_tpu_torch/ops/kernels.py) zeroes the status words and
// the counter and guarantees a 16-byte aligned, contiguous input.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Profiling switches, unset in every build of the package
// (tools/profile_scan.py builds them): -DREPAQ_SCAN_THREADS=t and
// -DREPAQ_SCAN_VECS=v set a tile's threads and each thread's vectors;
// -DREPAQ_SCAN_NO_LOOKBACK makes every tile start from the identity (its
// output wrong on purpose).
#ifndef REPAQ_SCAN_THREADS
#define REPAQ_SCAN_THREADS 256
#endif
#ifndef REPAQ_SCAN_VECS
#define REPAQ_SCAN_VECS 4
#endif
#ifdef REPAQ_SCAN_NO_LOOKBACK
constexpr bool kLookBack = false;
#else
constexpr bool kLookBack = true;
#endif

constexpr int kThreads = REPAQ_SCAN_THREADS;  // threads per tile
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = REPAQ_SCAN_VECS;        // 16-byte vectors a thread holds
static_assert(kThreads % 32 == 0 && kWarps <= 32, "a tile is 1-32 warps");
constexpr int kWarpSpan = 32 * 4 * kVecs;    // elements a warp owns
constexpr long long kTile = static_cast<long long>(kWarps) * kWarpSpan;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint64_t kFlagTotal = 1ull << 32;  // status: the tile's total
constexpr uint64_t kFlagIncl = 2ull << 32;   // status: its inclusive value

// kMin: the suffix minimum (scan from the high end); else the running max
template <bool kMin>
struct Scan {
  static constexpr int32_t kIdentity = kMin ? INT_MAX : INT_MIN;
  __device__ static __forceinline__ int32_t op(int32_t a, int32_t b) {
    return kMin ? min(a, b) : max(a, b);
  }
  // the value of the lane `d` before this one in scan order (identity for
  // none); the shuffle runs on every lane
  __device__ static __forceinline__ int32_t before(int32_t v, int d,
                                                   int lane) {
    const int32_t o = kMin ? __shfl_down_sync(kFull, v, d)
                           : __shfl_up_sync(kFull, v, d);
    return (kMin ? lane + d < 32 : lane >= d) ? o : kIdentity;
  }
};

__device__ __forceinline__ void store_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t load_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint64_t status_word(uint64_t flag, int32_t v) {
  return flag | static_cast<uint32_t>(v);
}

template <bool kMin>
__global__ void __launch_bounds__(kThreads)
run_boundary_scan_kernel(const int32_t* __restrict__ x,
                         int32_t* __restrict__ out, long long n,
                         long long tiles_per_row,
                         uint64_t* __restrict__ status,
                         unsigned* __restrict__ counter) {
  using S = Scan<kMin>;
  __shared__ int32_t warp_vals[kWarps];
  __shared__ unsigned shared_ticket;
  __shared__ int32_t shared_before;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  if (t == 0) shared_ticket = atomicAdd(counter, 1u);
  __syncthreads();
  const long long ticket = shared_ticket;
  const long long row = ticket / tiles_per_row;
  const long long j = ticket % tiles_per_row;  // place in the row's scan order
  const long long tile = kMin ? tiles_per_row - 1 - j : j;
  const int32_t* xr = x + row * n;
  int32_t* orow = out + row * n;
  const long long warp_at = tile * kTile + static_cast<long long>(warp) * kWarpSpan;
  // whole vectors: the row starts 16-byte aligned and the span is in it
  const bool whole = (row * n) % 4 == 0 && warp_at + kWarpSpan <= n;

  // 1. the warp's span, 4 elements a vector
  int32_t v[kVecs][4];
  if (whole) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const int4 w = *reinterpret_cast<const int4*>(xr + warp_at + 128 * q + 4 * lane);
      v[q][0] = w.x, v[q][1] = w.y, v[q][2] = w.z, v[q][3] = w.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long i = warp_at + 128 * q + 4 * lane + k;
        v[q][k] = i < n ? xr[i] : S::kIdentity;
      }
    }
  }

  // 2. scan each vector across the warp, carrying the earlier vectors
  int32_t carry = S::kIdentity;
#pragma unroll
  for (int s = 0; s < kVecs; ++s) {
    const int q = kMin ? kVecs - 1 - s : s;
    if (kMin) {
      v[q][2] = S::op(v[q][2], v[q][3]);
      v[q][1] = S::op(v[q][1], v[q][2]);
      v[q][0] = S::op(v[q][0], v[q][1]);
    } else {
      v[q][1] = S::op(v[q][1], v[q][0]);
      v[q][2] = S::op(v[q][2], v[q][1]);
      v[q][3] = S::op(v[q][3], v[q][2]);
    }
    int32_t incl = kMin ? v[q][0] : v[q][3];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) incl = S::op(incl, S::before(incl, d, lane));
    const int32_t prior = S::op(carry, S::before(incl, 1, lane));
#pragma unroll
    for (int k = 0; k < 4; ++k) v[q][k] = S::op(v[q][k], prior);
    carry = S::op(carry, __shfl_sync(kFull, incl, kMin ? 0 : 31));
  }
  if (lane == 0) warp_vals[warp] = carry;
  __syncthreads();

  // 3. across the warps, by warp 0 (kWarps <= 32)
  if (warp == 0) {
    // lanes past the warps hold the identity, so a scan over all 32 lanes
    // in scan order is the scan over the warps
    const int32_t own = lane < kWarps ? warp_vals[lane] : S::kIdentity;
    int32_t wincl = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) wincl = S::op(wincl, S::before(wincl, d, lane));
    const int32_t wbefore = S::before(wincl, 1, lane);
    // the tile's total: the fold of every warp's (commutative)
    int32_t total = own;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) total = S::op(total, __shfl_xor_sync(kFull, total, d));
    __syncwarp();
    if (lane < kWarps) warp_vals[lane] = wbefore;

    // 4. publish the tile's total, then look back for the value before it
    uint64_t* row_status = status + row * tiles_per_row;
    if (lane == 0) {
      store_release(row_status + j, status_word(j == 0 ? kFlagIncl : kFlagTotal, total));
    }
    int32_t acc = S::kIdentity;
    long long hi = kLookBack ? j - 1 : -1;
    while (hi >= 0) {
      // lane l reads the tile hi - l of this row; before the row's first
      // tile, the identity reads as an inclusive value
      const long long k = hi - lane;
      uint64_t sw = k < 0 ? status_word(kFlagIncl, S::kIdentity)
                          : load_acquire(row_status + k);
      while (!__all_sync(kFull, (sw >> 32) != 0)) {
        if ((sw >> 32) == 0) sw = load_acquire(row_status + k);
      }
      const unsigned incls = __ballot_sync(kFull, (sw >> 32) == 2);
      const int nearest = incls ? __ffs(incls) - 1 : 31;
      int32_t val = lane <= nearest ? static_cast<int32_t>(static_cast<uint32_t>(sw))
                                    : S::kIdentity;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) val = S::op(val, __shfl_xor_sync(kFull, val, d));
      acc = S::op(acc, val);
      if (incls) break;
      hi -= 32;
    }
    if (lane == 0) {
      if (j > 0) store_release(row_status + j, status_word(kFlagIncl, S::op(acc, total)));
      shared_before = acc;
    }
  }
  __syncthreads();

  // 5. the value before this warp, then the stores
  const int32_t prior = S::op(shared_before, warp_vals[warp]);
  if (whole) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      *reinterpret_cast<int4*>(orow + warp_at + 128 * q + 4 * lane) =
          make_int4(S::op(v[q][0], prior), S::op(v[q][1], prior),
                    S::op(v[q][2], prior), S::op(v[q][3], prior));
    }
  } else {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long i = warp_at + 128 * q + 4 * lane + k;
        if (i < n) orow[i] = S::op(v[q][k], prior);
      }
    }
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Elements per tile (the card tests place their edge cases by it).
extern "C" long long repaq_scan_tile() { return kTile; }

// 64-bit words of zeroed status repaq_scan_i32 needs for `rows` rows of n
// elements: one per tile, then the tile counter.
extern "C" long long repaq_scan_status_words(long long rows, long long n) {
  return rows * tiles_of(n) + 1;
}

// out = the running max of each row of x from its start (suffix_min == 0)
// or the running min from its end (suffix_min == 1); x and out hold `rows`
// contiguous rows of n int32, x 16-byte aligned.
extern "C" int repaq_scan_i32(const void* x, void* out, long long rows,
                              long long n, int suffix_min, void* status,
                              void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const long long tiles = rows * tiles_of(n);
  if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint64_t* words = static_cast<uint64_t*>(status);
  unsigned* counter = reinterpret_cast<unsigned*>(words + tiles);
  const int32_t* xi = static_cast<const int32_t*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  if (suffix_min) {
    run_boundary_scan_kernel<true><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        xi, o, n, tiles_of(n), words, counter);
  } else {
    run_boundary_scan_kernel<false><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        xi, o, n, tiles_of(n), words, counter);
  }
  return static_cast<int>(cudaGetLastError());
}
