// Run-boundary kernels for Hopper (sm_90a): the run offsets of the stream
// coders' encode and the segmented positions of their decode, two
// operators of one single-pass scan with decoupled look-back.
//
// Replaces: XLA code of the JAX package, not a Pallas kernel. In
// repaq_tpu/ops/device_streams.py, `_cummax` and `_suffix_min` (:33, :37:
// lax.cummax and lax.cummin between two flips) with the arithmetic around
// them at their call sites, :275-278 (`_classify_stream_positions`) and
// :726-730 (`coords_encode2_device`), and the segment bases of the decode,
// :1001 (`decode_positions_device`) and :1138 (`qualcol_decode_device`).
//
// run_offsets: over a row of n mask bytes (0 or 1), for each i
//   off[i]    = i - (the start of i's run of set bytes), 0 where unset;
//   to_end[i] = min(32, (the first unset j >= i, or n) - i), 0 where unset.
// The callers need no more of a run than these: a run token every 32
// elements from its start, covering at most 32. So the suffix minimum the
// JAX code takes over the whole row becomes a look-ahead of 32 elements,
// and the running maximum of run starts a running maximum of the last
// unset position, over bits.
// seg_positions: over n (adv int32, start byte) pairs, pos[i] = raw[i] -
// max(0, B[i]) - 1, with raw the inclusive prefix sum of adv and B[i] the
// largest raw[j] - adv[j] over starts j <= i: a segmented prefix sum. The
// scan's operator is the pair (sum, base) with (s1, b1).(s2, b2) =
// (s1 + s2, max(b1, s1 + b2)), b = INT32_MIN for a span without a start.
// It is exact while no prefix sum of adv leaves int32.
//
// What bounds them on the card: memory. run_offsets reads 1 byte an
// element and writes 8; seg_positions reads 5 and writes 4. At 3.35 TB/s,
// 9 bytes an element: ~5.6 us for the 2,097,152-element quality stream of
// a 12-Mbase chunk, ~6.3 us for its 2,359,296 decode tokens. A launch
// carries ~5.5 us of fixed cost beside that, so the design spends one
// launch a call: all the arithmetic around the scan runs in it, and the
// status words need no zero fill of their own (step 6).
//
// The design: a tile is kThreads threads; tiles take their index from an
// atomic ticket in launch order, rows one after another, so a tile waits
// only on tiles that have started. Per tile:
//   1. Loads, all issued before any use, at consecutive addresses.
//      run_offsets: each lane one 16-byte vector of mask bytes per vector
//      step (lane l of step q: elements 512 q + 16 l .. + 15 of its warp's
//      span), packed to 16 bits by one multiply per 4 bytes; lanes 0 and 1
//      also load the 32 elements past the span (the look-ahead halo, cut
//      at the row's end, depending on no other tile). seg_positions: each
//      lane one 16-byte vector of adv and the 4 start bytes beside it.
//   2. Scan within the warp. run_offsets: each lane's last unset position
//      (from __clz of its inverted bits), a max-scan over the lanes by
//      shuffles, carried from step to step. seg_positions: the pair
//      operator over the lane's 4 elements, then over the lanes.
//   3. The warps' totals are scanned by warp 0, which gives each warp the
//      value of the warps before it and the tile its total.
//   4. Look-back (Merrill and Garland) for the value of the tiles before
//      this one in its row. Each tile publishes its total (flag 1) at once,
//      then its inclusive value (flag 2) once it knows the one before it,
//      in 64-bit status words (flag above a 32-bit value; the pair takes
//      two, read as one value only when both carry the same flag) stored
//      with release semantics; warp 0 reads the 32 tiles before it, one a
//      lane with acquire loads, and folds them in order back to the
//      nearest inclusive value, or folds all 32 and reads the 32 before
//      those. A row's first tile reads the identity: -1 (the unset
//      position before the row) or (0, no base).
//   5. Outputs, with 16-byte vector stores at consecutive addresses.
//      run_offsets: store s of step q covers elements 128 s + 4 l .. + 3;
//      each lane takes from the lane that loaded them their 16 bits with
//      the 32 after (two lanes on and the next step's first two, or the
//      halo) and the last unset position before them. Then off comes from
//      __clz of the unset bits at or below the element, to_end from __ffsll
//      of the unset bits from it on.
//   6. The block that finishes last (a second atomic counter) zeroes the
//      status words and both counters, so the next launch finds them clean.
// A 2-D run_offsets input is one launch: the row rides in the ticket and
// a row's first tile resets the carry. Rows whose start is not aligned
// (n % 16 != 0 for the mask loads, n % 4 != 0 for the stores) and the
// ragged end of a row go element by element.
// The wrappers (repaq_tpu_torch/ops/kernels.py) keep one buffer of status
// words a CUDA stream, zeroed when it is made and left zeroed by every
// launch (launches on one stream run one after another), and pass 16-byte
// aligned, contiguous inputs. The buffer: the ticket counter, the counter
// of finished tiles, then each tile's words.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Profiling switches, unset in every build of the package
// (tools/profile_scan.py builds them): -DREPAQ_RUN_VECS=v and
// -DREPAQ_SEG_VECS=v set the vector steps of a lane in run_offsets (16
// elements each) and seg_positions (4 each); -DREPAQ_SCAN_NO_LOOKBACK makes
// every tile start from the identity (its output wrong on purpose).
#ifndef REPAQ_RUN_VECS
#define REPAQ_RUN_VECS 2
#endif
#ifndef REPAQ_SEG_VECS
#define REPAQ_SEG_VECS 8
#endif
#ifdef REPAQ_SCAN_NO_LOOKBACK
constexpr bool kLookBack = false;
#else
constexpr bool kLookBack = true;
#endif

constexpr int kThreads = 256;  // threads per tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kFlagTotal = 1;  // status: the tile's total
constexpr uint32_t kFlagIncl = 2;   // status: its inclusive value

constexpr int kRunVecs = REPAQ_RUN_VECS;
constexpr int kRunWarpSpan = 512 * kRunVecs;  // mask elements a warp owns
constexpr long long kRunTile = static_cast<long long>(kWarps) * kRunWarpSpan;
constexpr int kSegVecs = REPAQ_SEG_VECS;
constexpr int kSegWarpSpan = 128 * kSegVecs;  // elements a warp owns
constexpr long long kSegTile = static_cast<long long>(kWarps) * kSegWarpSpan;
static_assert(kRunVecs >= 1 && kSegVecs >= 1, "a lane takes one step or more");

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// run_offsets' operator: the last unset position so far, -1 before a row
struct LastUnset {
  using T = int32_t;
  static constexpr int kWords = 1;
  __device__ static T identity() { return -1; }
  __device__ static T op(T older, T newer) { return max(older, newer); }
  __device__ static uint32_t word(T v, int) { return static_cast<uint32_t>(v); }
  __device__ static T from(const uint32_t* w) { return static_cast<int32_t>(w[0]); }
};

// seg_positions' operator: a span's sum of adv and, relative to the span's
// start, the sum before its last segment start (kNoBase: none)
struct SumBase {
  int32_t s, b;
};
constexpr int32_t kNoBase = INT_MIN;

struct SegBase {
  using T = SumBase;
  static constexpr int kWords = 2;
  __device__ static T identity() { return {0, kNoBase}; }
  __device__ static T op(T older, T newer) {
    return {wrap_add(older.s, newer.s),
            newer.b == kNoBase ? older.b : max(older.b, wrap_add(older.s, newer.b))};
  }
  __device__ static uint32_t word(T v, int k) {
    return static_cast<uint32_t>(k ? v.b : v.s);
  }
  __device__ static T from(const uint32_t* w) {
    return {static_cast<int32_t>(w[0]), static_cast<int32_t>(w[1])};
  }
};

__device__ __forceinline__ int32_t shfl(int32_t v, int src) {
  return __shfl_sync(kFull, v, src);
}
__device__ __forceinline__ int32_t shfl_up(int32_t v, int d) {
  return __shfl_up_sync(kFull, v, d);
}
__device__ __forceinline__ int32_t shfl_down(int32_t v, int d) {
  return __shfl_down_sync(kFull, v, d);
}
__device__ __forceinline__ SumBase shfl(SumBase v, int src) {
  return {shfl(v.s, src), shfl(v.b, src)};
}
__device__ __forceinline__ SumBase shfl_up(SumBase v, int d) {
  return {shfl_up(v.s, d), shfl_up(v.b, d)};
}
__device__ __forceinline__ SumBase shfl_down(SumBase v, int d) {
  return {shfl_down(v.s, d), shfl_down(v.b, d)};
}

// inclusive scan over the warp's lanes in lane order
template <class Op>
__device__ __forceinline__ typename Op::T warp_scan(typename Op::T v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const typename Op::T o = shfl_up(v, d);
    if (lane >= d) v = Op::op(o, v);
  }
  return v;
}

// the inclusive value of the lane before (the identity at lane 0)
template <class Op>
__device__ __forceinline__ typename Op::T lane_before(typename Op::T incl, int lane) {
  const typename Op::T o = shfl_up(incl, 1);
  return lane ? o : Op::identity();
}

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

template <class Op>
__device__ __forceinline__ void publish(uint64_t* p, uint32_t flag,
                                        typename Op::T v) {
#pragma unroll
  for (int k = Op::kWords - 1; k >= 0; --k) {
    store_release(p + k, static_cast<uint64_t>(flag) << 32 | Op::word(v, k));
  }
}

// a tile's flag (0 until all its words carry one flag) and value
template <class Op>
__device__ __forceinline__ uint32_t read_status(const uint64_t* p,
                                                typename Op::T* v) {
  uint32_t w[Op::kWords];
  uint32_t flag = 0;
#pragma unroll
  for (int k = 0; k < Op::kWords; ++k) {
    const uint64_t x = load_acquire(p + k);
    w[k] = static_cast<uint32_t>(x);
    const uint32_t f = static_cast<uint32_t>(x >> 32);
    flag = k == 0 ? f : (f == flag ? flag : 0);
  }
  *v = Op::from(w);
  return flag;
}

constexpr int kCounters = 2;  // status words before the tiles' own

// the tile's index in launch order, from the ticket counter
__device__ __forceinline__ long long take_ticket(uint64_t* status) {
  __shared__ unsigned ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(reinterpret_cast<unsigned*>(status), 1u);
  __syncthreads();
  return ticket;
}

// Step 6: the last block to finish zeroes the launch's `words` status
// words, counters included. Every other block counted itself finished only
// after its look-back's last read, so nothing reads them any more.
__device__ __forceinline__ void clear_if_last(uint64_t* status, long long words) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(reinterpret_cast<unsigned*>(status + 1), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (long long k = threadIdx.x; k < words; k += blockDim.x) status[k] = 0;
}

// Steps 3 and 4: the value of everything before this warp in its row,
// from the warps' totals and the row's tiles before tile j (`tiles`: the
// row's status words). Every thread of the block calls it.
template <class Op>
__device__ typename Op::T prior_of_warp(typename Op::T warp_total,
                                        uint64_t* tiles, long long j) {
  using T = typename Op::T;
  __shared__ T warp_vals[kWarps];
  __shared__ T tile_before;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_vals[warp] = warp_total;
  __syncthreads();
  if (warp == 0) {
    const T own = lane < kWarps ? warp_vals[lane] : Op::identity();
    const T incl = warp_scan<Op>(own, lane);
    const T before = lane_before<Op>(incl, lane);
    const T total = shfl(incl, kWarps - 1);
    if (lane < kWarps) warp_vals[lane] = before;
    if (lane == 0) {
      publish<Op>(tiles + j * Op::kWords, j == 0 ? kFlagIncl : kFlagTotal, total);
    }
    T acc = Op::identity();
    for (long long hi = kLookBack ? j - 1 : -1; hi >= 0; hi -= 32) {
      // lane l reads tile hi - l; before the row's first tile, the
      // identity reads as an inclusive value
      const long long k = hi - lane;
      T val = Op::identity();
      uint32_t flag = kFlagIncl;
      if (k >= 0) flag = read_status<Op>(tiles + k * Op::kWords, &val);
      while (!__all_sync(kFull, flag != 0)) {
        if (flag == 0) flag = read_status<Op>(tiles + k * Op::kWords, &val);
      }
      const unsigned incls = __ballot_sync(kFull, flag == kFlagIncl);
      const int nearest = incls ? __ffs(incls) - 1 : 31;
      if (lane > nearest) val = Op::identity();
      // fold in order, lane 0 the newest: lane l ends holding lanes l..31
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const T o = shfl_down(val, d);
        if (lane + d < 32) val = Op::op(o, val);
      }
      acc = Op::op(shfl(val, 0), acc);
      if (incls) break;
    }
    if (lane == 0) {
      if (j > 0) publish<Op>(tiles + j * Op::kWords, kFlagIncl, Op::op(acc, total));
      tile_before = acc;
    }
  }
  __syncthreads();
  return Op::op(tile_before, warp_vals[warp]);
}

// 4 mask bytes (0 or 1) to 4 bits, byte k to bit k: the multiply moves
// byte k's bit to bit 28 + k, and no other product reaches bits 28-31
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return (x * 0x10204080u) >> 28;
}

// the mask bits of the 16 elements at `at` of a row of n (bit e: element
// at + e; 0 past the row's end)
__device__ __forceinline__ uint32_t chunk_bits(const uint8_t* row, long long at,
                                               long long n, bool vec) {
  if (vec && at + 16 <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + at);
    return pack4(v.x) | pack4(v.y) << 4 | pack4(v.z) << 8 | pack4(v.w) << 12;
  }
  uint32_t b = 0;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    if (at + e < n && row[at + e]) b |= 1u << e;
  }
  return b;
}

__global__ void __launch_bounds__(kThreads)
run_offsets_kernel(const uint8_t* __restrict__ mask, int32_t* __restrict__ off,
                   int32_t* __restrict__ to_end, long long n,
                   long long tiles_per_row, uint64_t* __restrict__ status) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ticket = take_ticket(status);
  const long long row = ticket / tiles_per_row;
  const long long j = ticket % tiles_per_row;
  const uint8_t* mrow = mask + row * n;
  const long long warp_at = j * kRunTile + static_cast<long long>(warp) * kRunWarpSpan;

  // 1. each lane's 16 elements of every step; step kRunVecs is the halo,
  // the 32 elements past the span, in lanes 0 and 1
  const bool vec_in = (row * n) % 16 == 0;
  uint32_t bits[kRunVecs + 1];
#pragma unroll
  for (int q = 0; q <= kRunVecs; ++q) {
    bits[q] = q < kRunVecs || lane < 2
                  ? chunk_bits(mrow, warp_at + 512 * q + 16 * lane, n, vec_in)
                  : 0u;
  }

  // 2. the last unset position before each lane's elements, within the
  // warp, and the warp's total
  int32_t before[kRunVecs];
  int32_t carry = LastUnset::identity();
#pragma unroll
  for (int q = 0; q < kRunVecs; ++q) {
    const uint32_t unset = ~bits[q] & 0xFFFFu;
    const long long at = warp_at + 512 * q + 16 * lane;
    const int32_t last = unset ? static_cast<int32_t>(at + 31 - __clz(unset)) : -1;
    const int32_t incl = warp_scan<LastUnset>(last, lane);
    before[q] = max(carry, lane_before<LastUnset>(incl, lane));
    carry = max(carry, shfl(incl, 31));
  }

  // 3-4. the warps and tiles before
  const int32_t prior = prior_of_warp<LastUnset>(
      carry, status + kCounters + row * tiles_per_row * LastUnset::kWords, j);
  clear_if_last(status, kCounters + static_cast<long long>(gridDim.x) * LastUnset::kWords);

  // 5. store s of step q: elements 128 s + 4 lane .. + 3, which lane
  // 8 s + lane / 4 loaded
  const bool vec_out = (row * n) % 4 == 0;
  int32_t* orow = off + row * n;
  int32_t* trow = to_end + row * n;
#pragma unroll
  for (int q = 0; q < kRunVecs; ++q) {
    // the lane's 16 bits and the 32 after them, from the next two lanes
    // or the next step's first two (the halo after the last step)
    const uint32_t next1 = shfl_down(static_cast<int32_t>(bits[q]), 1);
    const uint32_t next2 = shfl_down(static_cast<int32_t>(bits[q]), 2);
    const uint32_t step0 = shfl(static_cast<int32_t>(bits[q + 1]), 0);
    const uint32_t step1 = shfl(static_cast<int32_t>(bits[q + 1]), 1);
    const uint32_t c1 = lane < 31 ? next1 : step0;
    const uint32_t c2 = lane < 30 ? next2 : (lane == 30 ? step0 : step1);
    const unsigned long long unset =
        ~(static_cast<unsigned long long>(bits[q]) | static_cast<unsigned long long>(c1) << 16 |
          static_cast<unsigned long long>(c2) << 32) & 0xFFFFFFFFFFFFull;
    const int32_t last_before = max(prior, before[q]);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int owner = 8 * s + (lane >> 2);
      const unsigned long long u = __shfl_sync(kFull, unset, owner);
      const int32_t lb = shfl(last_before, owner);
      const long long chunk = warp_at + 512 * q + 16 * owner;
      int32_t o[4], t[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = 4 * (lane & 3) + k;  // the element's bit in the chunk
        const unsigned long long ahead = u >> p;
        const uint32_t at_or_below = static_cast<uint32_t>(u) & ((2u << p) - 1u);
        const int32_t last = at_or_below
                                 ? static_cast<int32_t>(chunk + 31 - __clz(at_or_below))
                                 : lb;
        o[k] = ahead & 1 ? 0 : static_cast<int32_t>(chunk + p - last - 1);
        t[k] = ahead ? min(__ffsll(static_cast<long long>(ahead)) - 1, 32) : 32;
      }
      const long long i = warp_at + 512 * q + 128 * s + 4 * lane;
      if (vec_out && i + 4 <= n) {
        *reinterpret_cast<int4*>(orow + i) = make_int4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<int4*>(trow + i) = make_int4(t[0], t[1], t[2], t[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (i + k < n) {
            orow[i + k] = o[k];
            trow[i + k] = t[k];
          }
        }
      }
    }
  }
}

// element k of a lane's step: its adv, and a base of 0 (the sum before it,
// relative to itself) where its start byte is set
__device__ __forceinline__ SumBase element(int32_t adv, uint32_t starts, int k) {
  return {adv, (starts >> (8 * k)) & 0xFFu ? 0 : kNoBase};
}

__global__ void __launch_bounds__(kThreads)
seg_positions_kernel(const int32_t* __restrict__ adv,
                     const uint8_t* __restrict__ seg_start,
                     int32_t* __restrict__ pos, long long n,
                     uint64_t* __restrict__ status) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long j = take_ticket(status);
  const long long warp_at = j * kSegTile + static_cast<long long>(warp) * kSegWarpSpan;

  // 1. each lane's 4 elements of every step: adv and the start bytes
  int32_t a[kSegVecs][4];
  uint32_t st[kSegVecs];
#pragma unroll
  for (int q = 0; q < kSegVecs; ++q) {
    const long long i = warp_at + 128 * q + 4 * lane;
    if (i + 4 <= n) {
      const int4 v = *reinterpret_cast<const int4*>(adv + i);
      a[q][0] = v.x, a[q][1] = v.y, a[q][2] = v.z, a[q][3] = v.w;
      st[q] = *reinterpret_cast<const uint32_t*>(seg_start + i);
    } else {
      st[q] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[q][k] = i + k < n ? adv[i + k] : 0;
        if (i + k < n && seg_start[i + k]) st[q] |= 1u << (8 * k);
      }
    }
  }

  // 2. each step's lane totals (their 4 elements in order), scanned over
  // the lanes and carried over the steps: what comes before each lane's
  // first element of a step, relative to the warp's span (kept alone, so
  // that the elements are folded in again at the end from the loads)
  SumBase before[kSegVecs];
  SumBase carry = SegBase::identity();
#pragma unroll
  for (int q = 0; q < kSegVecs; ++q) {
    SumBase total = SegBase::identity();
#pragma unroll
    for (int k = 0; k < 4; ++k) total = SegBase::op(total, element(a[q][k], st[q], k));
    const SumBase incl = warp_scan<SegBase>(total, lane);
    before[q] = SegBase::op(carry, lane_before<SegBase>(incl, lane));
    carry = SegBase::op(carry, shfl(incl, 31));
  }

  // 3-4. the warps and tiles before
  const SumBase prior = prior_of_warp<SegBase>(carry, status + kCounters, j);
  clear_if_last(status, kCounters + static_cast<long long>(gridDim.x) * SegBase::kWords);

  // 5. pos = raw - max(0, base) - 1, element by element from the lane's
  // absolute prefix
#pragma unroll
  for (int q = 0; q < kSegVecs; ++q) {
    SumBase v = SegBase::op(prior, before[q]);
    int32_t p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v = SegBase::op(v, element(a[q][k], st[q], k));
      p[k] = wrap_add(v.s, -max(0, v.b) - 1);
    }
    const long long i = warp_at + 128 * q + 4 * lane;
    if (i + 4 <= n) {
      *reinterpret_cast<int4*>(pos + i) = make_int4(p[0], p[1], p[2], p[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i + k < n) pos[i + k] = p[k];
      }
    }
  }
}

long long run_tiles(long long n) { return (n + kRunTile - 1) / kRunTile; }
long long seg_tiles(long long n) { return (n + kSegTile - 1) / kSegTile; }

}  // namespace

// Elements per tile (the card tests place their edge cases by them).
extern "C" long long repaq_run_offsets_tile() { return kRunTile; }
extern "C" long long repaq_seg_positions_tile() { return kSegTile; }

// 64-bit words of zeroed status each kernel needs (and leaves zeroed): the
// two counters, then its tiles' words.
extern "C" long long repaq_run_offsets_status_words(long long rows, long long n) {
  return kCounters + rows * run_tiles(n) * LastUnset::kWords;
}
extern "C" long long repaq_seg_positions_status_words(long long n) {
  return kCounters + seg_tiles(n) * SegBase::kWords;
}

// off and to_end of each of `rows` contiguous rows of n mask bytes (0 or
// 1, 16-byte aligned); off and to_end hold rows x n int32. status: zeroed
// words, at least repaq_run_offsets_status_words(rows, n), zeroed again
// when the kernel ends.
extern "C" int repaq_run_offsets(const void* mask, void* off, void* to_end,
                                 long long rows, long long n, void* status,
                                 void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const long long tiles = rows * run_tiles(n);
  // positions are int32 up to a tile past the row's end
  if (tiles > 0x7FFFFFFFLL || n > INT_MAX - kRunTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  run_offsets_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<int32_t*>(off),
      static_cast<int32_t*>(to_end), n, run_tiles(n),
      static_cast<uint64_t*>(status));
  return static_cast<int>(cudaGetLastError());
}

// pos of n (adv int32, start byte) pairs, adv 16-byte aligned, seg_start
// 4-byte aligned; status as for repaq_run_offsets.
extern "C" int repaq_seg_positions(const void* adv, const void* seg_start,
                                   void* pos, long long n, void* status,
                                   void* stream) {
  if (n <= 0) return 0;
  const long long tiles = seg_tiles(n);
  if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  seg_positions_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(adv), static_cast<const uint8_t*>(seg_start),
      static_cast<int32_t*>(pos), n, static_cast<uint64_t*>(status));
  return static_cast<int>(cudaGetLastError());
}
