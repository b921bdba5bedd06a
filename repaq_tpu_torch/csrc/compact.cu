// Stable bucket compaction for Hopper (sm_90a): of n elements, each with a
// bucket id (a bool mask: True bucket 0, False dropped; or uint8 ids, ids
// >= nbuckets dropped), write the kept indices i ordered by (bucket id, i)
// into idx[0, cap), fill past the kept ones, with payload[i] beside each
// in pay (0 past them), and each bucket's full count into counts.
//
// Replaces: XLA code of the JAX package, not a Pallas kernel. The TPU has
// no compaction, so repaq_tpu/ops/device_streams.py sorts: the count >= 2
// compactions of the emission (:136, :187, :237), the N flags' group and
// position sorts (:403-419), the grouping of the quality positions by bin
// on the key bid << 24 | pos (:502), the escape compaction (:536) and the
// decode's token compaction with each token's window riding (:1094). Each
// is a full radix sort of int32 keys that keeps a fraction of them: the
// grouping sorts a chunk's 12,582,912 bases to keep ~13%.
//
// What bounds it on the card: memory. It must read every bucket byte and,
// for the kept elements, write the index and read and write the payload:
// for an SE chunk's grouping, 12.6 MB read and ~8.4 MB written, ~0.006 ms
// at 3.35 TB/s. Beside that, a launch carries a fixed cost of a few us, so
// the design spends as few launches as the function allows. Three routes,
// chosen by the call's form:
//
// mask (a bool tensor): one launch, one pass. A persistent grid (one wave
//   of resident blocks) takes tiles from an atomic ticket in launch order,
//   so a tile waits only on tiles already taken by running blocks. Per
//   tile, each warp owns kVecs steps of 512 elements, and each lane issues
//   one 16-byte load a step (lane l: the step's elements 16 l .. 16 l +
//   15) before it uses any; their set bytes become 16 bits. A step's round
//   t, its elements 32 t .. 32 t + 31, has the bits of lanes 2t and 2t + 1
//   for its ballot, one shuffle away. The warps' counts, summed over the
//   block, give the tile's total, which is published, then its inclusive
//   sum, by decoupled look-back (Merrill and Garland, as csrc/scan.cu:
//   64-bit status words, flag above the value, warp 0 reading 32 tiles a
//   step). A payload is loaded before the look-back, where an element is
//   kept, as the stores write it. Then round by round in element order the
//   kept lanes write their index (and payload) at consecutive places: one
//   coalesced store a round, no stage; a step that keeps nothing is
//   skipped. Tiles are of 4,096 elements (kVecs 1) up to kMaskSwitch of
//   them, so a dense call's copy spreads over a block a tile, as in the
//   match route's scatter (a real chunk's decode tokens, a 98% dense head
//   over 71% of 2.36 M starts: 576 tiles; tiles four times larger left a
//   block an SM, and lost to three passes); a larger call (the N flags of
//   12.6 M bases) takes tiles of 16,384 (kVecs 4), since its blocks take
//   several tiles each and a tile's fixed work (ticket, barriers,
//   look-back) then weighs more than its copy. When the tickets run out,
//   each block waits for the last tile's inclusive sum (taken by a running
//   block, so the wait ends), writes its grid-stride share of fill over
//   [kept, cap), and the last block to finish zeroes the status words.
// ids up to kRegMax buckets (the register route): two launches. A bucket's
//   place in the output needs the totals of the buckets below it, so
//   1. count: a persistent grid streams the ids, kIdVecs 16-byte loads a
//      lane in flight, and counts each bucket in a register: 4 bytes at a
//      time, the bytes equal to b marked in their top bit by a carry-free
//      compare (equal4) and popcounted. A block writes its lanes' sums to
//      the call's scratch, and the last block to finish adds them up into
//      counts (the totals stay out of the stream's status words, which
//      another call's launch may use between this call's two);
//   2. scatter: tiles of kIdTile elements by ticket, each warp owning a
//      span of 512 kIdVecs consecutive elements, 16 a lane a load step.
//      Per step and bucket, the lane's 16 bytes give a 16-bit mask
//      (equal16) and its popcount; a warp scan of those counts, two
//      buckets a scan in 16-bit halves, gives each lane's first place among
//      the warp's elements of the bucket. One barrier turns the warps'
//      totals into each warp's first place in the tile and the tile's
//      totals; bucket b's total goes through its own look-back (warp b
//      mod 8); its base is the exclusive sum of the buckets' counts plus
//      the tiles before. Then each lane writes its elements of each bucket
//      in order at consecutive places (the set bits of its mask), so the
//      lanes of one bucket write next to each other. The kept total is
//      known before the scatter starts, so its blocks write the fill
//      without waiting.
//   No __match_any_sync and no one-block scan on this route; its work is
//   a compare a bucket for every 4 bytes, so it stops at kRegMax buckets.
// ids above kRegMax buckets: three launches, the match route: a count pass
//   (a block a kTile tile, the lanes of one id found by __match_any_sync,
//   counters in shared memory, each tile's counts bucket-major in int32
//   scratch), one block's exclusive scan of those counts, and a scatter
//   pass over the same tiles in element order (match masks and counters in
//   shared memory), its blocks writing the fill after it. Under
//   REPAQ_COMPACT_THREE_PASS masks take it too (a ballot a round), for the
//   profiler's ablation.
// In every route the order within a warp's span is the element order, the
// spans and tiles follow each other, and a tile's place within each bucket
// follows the tile order, so the result is the stable order, the same
// from launch to launch. The wrapper passes 16-byte aligned bucket and
// payload tensors and one buffer of zeroed status words per (device,
// stream), which every launch leaves zeroed (launches on one stream run in
// order).
//
// The launch has a plain C entry (repaq_bucket_compact); ops/kernels.py
// binds it with ctypes and counts one launch a call.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Profiling switches, unset in every build of the package
// (tools/profile_compact.py --ablate builds them): -DREPAQ_COMPACT_REG_MAX=k
// sends ids above k buckets to the match route (0: every id call), and
// -DREPAQ_COMPACT_THREE_PASS sends every call there, masks too.
#ifndef REPAQ_COMPACT_REG_MAX
#define REPAQ_COMPACT_REG_MAX 8
#endif

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The mask route's tiles: one 16-byte load a lane (4,096 elements) while
// a call has at most kMaskSwitch of them, about one wave (8 blocks an SM
// on 132 SMs: 1,056), else four (16,384 elements).
constexpr long long kMaskSmall = 16LL * kThreads;
constexpr long long kMaskSwitch = 1024;
constexpr int kIdVecs = 4;  // 16-byte loads a lane makes a register-route tile
constexpr int kIdSpan = 512 * kIdVecs;  // elements a warp owns a tile
constexpr long long kIdTile = static_cast<long long>(kWarps) * kIdSpan;
constexpr int kRegSlots = 8;  // bucket counts the register route is built for
constexpr int kRegMax = REPAQ_COMPACT_REG_MAX;
static_assert(kRegMax >= 0 && kRegMax <= kRegSlots, "a register route kernel a count");

// status words: the ticket counter, the counter of finished blocks, then
// the tiles' words
constexpr int kCounters = 2;
constexpr uint32_t kFlagTotal = 1;  // status: the tile's total
constexpr uint32_t kFlagIncl = 2;   // status: its inclusive sum

// the match route: three passes
constexpr int kRounds = 16;
constexpr int kWarpSpan = 32 * kRounds;  // elements a warp owns in its scatter
constexpr long long kTile = static_cast<long long>(kThreads) * kRounds;
constexpr int kMaxBuckets = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanBatch = 16;  // chunks whose loads the scan issues together

enum Route { kRouteMask, kRouteReg, kRouteMatch };

Route route_of(int is_mask, int nbuckets) {
#ifdef REPAQ_COMPACT_THREE_PASS
  (void)is_mask;
  (void)nbuckets;
  return kRouteMatch;
#else
  if (is_mask) return kRouteMask;
  return nbuckets <= kRegMax ? kRouteReg : kRouteMatch;
#endif
}

// the 16 bucket bytes at `at` (16-byte aligned), those past n as `pad`
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ bucket,
                                        long long at, long long n,
                                        uint32_t pad) {
  if (at + 16 <= n) return *reinterpret_cast<const uint4*>(bucket + at);
  uint32_t w[4] = {0, 0, 0, 0};
  for (int e = 0; e < 16; ++e) {
    const uint32_t b = at + e < n ? bucket[at + e] : pad;
    w[e >> 2] |= b << (8 * (e & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bit 7 of each byte k of hi (the others 0) to bit k: the multiply moves
// byte k's bit 0 to bit 28 + k, and no other product reaches bits 28-31
__device__ __forceinline__ uint32_t bits4(uint32_t hi) {
  return ((hi >> 7) * 0x10204080u) >> 28;
}

// 4 bytes to 4 bits, bit k set where byte k is not 0
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  return bits4((((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u);
}

__device__ __forceinline__ uint32_t nonzero16(uint4 v) {
  return nonzero4(v.x) | nonzero4(v.y) << 4 | nonzero4(v.z) << 8 |
         nonzero4(v.w) << 12;
}

__device__ __forceinline__ uint32_t warp_inclusive(uint32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// A status word carries its value itself, and nothing else that its
// writer wrote is read by the tile that reads it, so it is stored and read
// relaxed at gpu scope (through the L2): an acquire load would also
// invalidate the SM's L1 at every read of a spin.
__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint64_t status_word(uint32_t flag, uint32_t v) {
  return static_cast<uint64_t>(flag) << 32 | v;
}

// Decoupled look-back by one warp (every lane calls it): publishes tile
// j's total in words[j], then its inclusive sum once the tiles before it
// are known; returns the sum of the tiles before j. A step reads the 32
// kLook tiles before `hi`, lane l tiles hi - l - 32 u; the warp folds back
// to the nearest inclusive sum, or over all of them and steps on. (The
// register route reads 128 tiles a step, the mask route 32: each was the
// faster on the card.)
template <int kLook>
__device__ uint32_t look_back(uint64_t* words, long long j, uint32_t total) {
  constexpr int kStep = 32 * kLook;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    store_relaxed(words + j, status_word(j == 0 ? kFlagIncl : kFlagTotal, total));
  }
  uint32_t acc = 0;
  for (long long hi = j - 1; hi >= 0; hi -= kStep) {
    uint64_t w[kLook];
#pragma unroll
    for (int u = 0; u < kLook; ++u) {
      const long long k = hi - 32 * u - lane;
      // before the first tile, 0 reads as an inclusive sum
      w[u] = k >= 0 ? load_relaxed(words + k) : status_word(kFlagIncl, 0);
    }
    bool ready;
    do {
      ready = true;
#pragma unroll
      for (int u = 0; u < kLook; ++u) {
        if ((w[u] >> 32) == 0) {
          w[u] = load_relaxed(words + hi - 32 * u - lane);
          ready = ready && (w[u] >> 32) != 0;
        }
      }
    } while (!__all_sync(kFull, ready));
    int nearest = kStep;  // past the step: no inclusive sum in it
#pragma unroll
    for (int u = kLook - 1; u >= 0; --u) {
      const unsigned incls = __ballot_sync(kFull, (w[u] >> 32) == kFlagIncl);
      if (incls) nearest = 32 * u + __ffs(incls) - 1;
    }
    uint32_t part = 0;
#pragma unroll
    for (int u = 0; u < kLook; ++u) {
      if (32 * u + lane <= nearest) part += static_cast<uint32_t>(w[u]);
    }
    acc += __reduce_add_sync(kFull, part);
    if (nearest < kStep) break;
  }
  if (lane == 0 && j > 0) store_relaxed(words + j, status_word(kFlagIncl, acc + total));
  return acc;
}

// The tile's index in launch order, from the ticket counter; every thread
// calls it, and it ends with a barrier.
__device__ __forceinline__ long long take_ticket(uint64_t* status) {
  __shared__ unsigned ticket;
  __syncthreads();  // the last ticket is read by every thread
  if (threadIdx.x == 0) ticket = atomicAdd(reinterpret_cast<unsigned*>(status), 1u);
  __syncthreads();
  return ticket;
}

// Whether this block is the last of the launch to get here (every thread
// calls it): a barrier, then one thread's fence and count of finished
// blocks, so the stores that any thread of every block made before its
// call are visible to the last block after it.
__device__ __forceinline__ bool last_block(uint64_t* status) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(reinterpret_cast<unsigned*>(status + 1), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The last block to finish zeroes the launch's `words` status words,
// counters included. Every other block counted itself finished after its
// last read of them.
__device__ __forceinline__ void clear_if_last(uint64_t* status, long long words) {
  if (!last_block(status)) return;
  for (long long k = threadIdx.x; k < words; k += blockDim.x) status[k] = 0;
}

// fill and 0 over [from, cap), the block's grid-stride share
__device__ __forceinline__ void fill_tail(long long from, long long cap,
                                          int32_t fill, int32_t* __restrict__ idx,
                                          int32_t* __restrict__ pay) {
  for (long long k = from + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       k < cap; k += static_cast<long long>(gridDim.x) * kThreads) {
    idx[k] = fill;
    if (pay) pay[k] = 0;
  }
}

// ---------------------------------------------------------------------------
// the mask route: one pass
// ---------------------------------------------------------------------------

// kPay: a payload rides, loaded before the look-back where an element is
// kept, as the stores write it (lane l: element 32 t + l of round t)
template <bool kPay, int kVecs>
__global__ void __launch_bounds__(kThreads)
compact_mask_kernel(const uint8_t* __restrict__ bucket, long long n,
                    long long tiles, long long cap, int32_t fill,
                    const int32_t* __restrict__ payload,
                    int32_t* __restrict__ idx, int32_t* __restrict__ pay,
                    int32_t* __restrict__ counts, uint64_t* __restrict__ status) {
  __shared__ uint32_t warp_before[kWarps];
  __shared__ uint32_t tile_before;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  uint64_t* words = status + kCounters;
  for (;;) {
    const long long j = take_ticket(status);
    if (j >= tiles) break;
    const long long span = (j * kWarps + warp) * 512 * kVecs;
    uint4 v[kVecs];
#pragma unroll
    for (int q = 0; q < kVecs; ++q) v[q] = load16(bucket, span + 512 * q + 16 * lane, n, 0);
    // step q's round t is its elements 32 t .. 32 t + 31: their kept bits
    // are lanes 2t's 16 and 2t + 1's, so on an even lane `pair` is the
    // ballot of round lane / 2
    uint32_t pair[kVecs];
    uint32_t own = 0;
    unsigned live = 0;  // bit q: step q keeps an element (the same in every lane)
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const uint32_t bits = nonzero16(v[q]);
      own += __popc(bits);
      pair[q] = bits | __shfl_down_sync(kFull, bits, 1) << 16;
      live |= static_cast<unsigned>(__any_sync(kFull, bits != 0)) << q;
    }
    const uint32_t warp_total = __reduce_add_sync(kFull, own);
    int32_t pw[kPay ? kVecs : 1][16];
    if (kPay) {
#pragma unroll
      for (int q = 0; q < kVecs; ++q) {
        if (!(live >> q & 1u)) continue;
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          const uint32_t hit = __shfl_sync(kFull, pair[q], 2 * t);
          pw[q][t] = hit >> lane & 1u ? payload[span + 512 * q + 32 * t + lane] : 0;
        }
      }
    }
    if (lane == 0) warp_before[warp] = warp_total;
    __syncthreads();
    if (warp == 0) {
      const uint32_t mine = lane < kWarps ? warp_before[lane] : 0;
      const uint32_t incl = warp_inclusive(mine, lane);
      const uint32_t total = __shfl_sync(kFull, incl, kWarps - 1);
      if (lane < kWarps) warp_before[lane] = incl - mine;
      const uint32_t prior = look_back<1>(words, j, total);
      if (lane == 0) {
        tile_before = prior;
        if (j == tiles - 1) counts[0] = static_cast<int32_t>(prior + total);
      }
    }
    __syncthreads();
    // round by round in element order: a round's kept lanes write next to
    // each other, one coalesced store
    long long at = static_cast<long long>(tile_before) + warp_before[warp];
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      if (!(live >> q & 1u)) continue;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const uint32_t hit = __shfl_sync(kFull, pair[q], 2 * t);
        const long long place = at + __popc(hit & lower);
        if ((hit >> lane & 1u) && place < cap) {
          idx[place] = static_cast<int32_t>(span + 512 * q + 32 * t + lane);
          if (kPay) pay[place] = pw[q][t];
        }
        at += __popc(hit);
      }
    }
  }
  // the tickets ran out: the last tile's inclusive sum is the kept total
  __shared__ uint32_t kept;
  if (threadIdx.x == 0) {
    uint64_t w;
    for (;;) {
      w = load_relaxed(words + tiles - 1);
      if ((w >> 32) == kFlagIncl) break;
    }
    kept = static_cast<uint32_t>(w);
  }
  __syncthreads();
  fill_tail(min(static_cast<long long>(kept), cap), cap, fill, idx, kPay ? pay : nullptr);
  clear_if_last(status, kCounters + tiles);
}

// ---------------------------------------------------------------------------
// the register route: ids up to kRegMax buckets, two launches
// ---------------------------------------------------------------------------

// 0x80 in each byte of w equal to b, 0 in the others
__device__ __forceinline__ uint32_t equal4(uint32_t w, uint32_t b) {
  const uint32_t x = w ^ (b * 0x01010101u);
  return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// bit e set where byte e of the 16 is b
__device__ __forceinline__ uint32_t equal16(uint4 v, uint32_t b) {
  return bits4(equal4(v.x, b)) | bits4(equal4(v.y, b)) << 4 |
         bits4(equal4(v.z, b)) << 8 | bits4(equal4(v.w, b)) << 12;
}

template <int kNB>
__global__ void __launch_bounds__(kThreads)
compact_reg_count_kernel(const uint8_t* __restrict__ bucket, long long n,
                         uint32_t* __restrict__ part, int32_t* __restrict__ counts,
                         uint64_t* __restrict__ status) {
  __shared__ uint32_t block_cnt[kNB];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < kNB) block_cnt[threadIdx.x] = 0;
  __syncthreads();
  const long long row = static_cast<long long>(gridDim.x) * kThreads * 16;
  uint32_t c[kNB];
#pragma unroll
  for (int b = 0; b < kNB; ++b) c[b] = 0;
  for (long long at = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 16;
       at < n; at += kIdVecs * row) {
    uint4 v[kIdVecs];  // all loads issued before any is used
#pragma unroll
    for (int q = 0; q < kIdVecs; ++q) v[q] = load16(bucket, at + q * row, n, 0xFFu);
#pragma unroll
    for (int q = 0; q < kIdVecs; ++q) {
#pragma unroll
      for (int b = 0; b < kNB; ++b) {
        c[b] += __popc(equal4(v[q].x, b)) + __popc(equal4(v[q].y, b)) +
                __popc(equal4(v[q].z, b)) + __popc(equal4(v[q].w, b));
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kNB; ++b) {
    const uint32_t t = __reduce_add_sync(kFull, c[b]);
    if (lane == 0 && t) atomicAdd(&block_cnt[b], t);
  }
  __syncthreads();
  if (threadIdx.x < kNB) part[blockIdx.x * kNB + threadIdx.x] = block_cnt[threadIdx.x];
  // the last block to finish sums the blocks' counts into counts (warp b:
  // bucket b) and leaves the counter of finished blocks at 0 again
  if (!last_block(status)) return;
  if (warp < kNB) {
    uint32_t t = 0;
    for (unsigned k = lane; k < gridDim.x; k += 32) t += __ldcg(part + k * kNB + warp);
    t = __reduce_add_sync(kFull, t);
    if (lane == 0) counts[warp] = static_cast<int32_t>(t);
  }
  if (threadIdx.x == 0) status[1] = 0;
}

template <int kNB>
__global__ void __launch_bounds__(kThreads)
compact_reg_scatter_kernel(const uint8_t* __restrict__ bucket, long long n,
                           long long tiles, long long cap, int32_t fill,
                           const int32_t* __restrict__ payload,
                           int32_t* __restrict__ idx, int32_t* __restrict__ pay,
                           int32_t* __restrict__ counts,
                           uint64_t* __restrict__ status) {
  __shared__ uint32_t first[kWarps][kNB];  // each warp's count, then first place, a bucket
  __shared__ uint32_t tile_total[kNB];
  __shared__ uint32_t tile_base[kNB];
  __shared__ uint32_t bucket_base[kNB];
  __shared__ uint32_t kept;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint64_t* words = status + kCounters;
  if (warp == 0) {  // the buckets' bases: the exclusive sum of their counts
    const uint32_t t = lane < kNB ? static_cast<uint32_t>(counts[lane]) : 0;
    const uint32_t incl = warp_inclusive(t, lane);
    if (lane < kNB) bucket_base[lane] = incl - t;
    if (lane == 31) kept = incl;
  }
  for (;;) {
    const long long j = take_ticket(status);
    if (j >= tiles) break;
    const long long span = j * kIdTile + static_cast<long long>(warp) * kIdSpan;
    uint4 v[kIdVecs];
#pragma unroll
    for (int q = 0; q < kIdVecs; ++q) v[q] = load16(bucket, span + 512 * q + 16 * lane, n, 0xFFu);
    // per load step and bucket: the lane's 16 bits, and the place of its
    // first one among the warp's elements of the bucket (the steps before,
    // then the lanes below: a warp scan of the lanes' counts, two buckets
    // a scan in 16-bit halves)
    uint32_t m[kIdVecs][kNB], before[kIdVecs][kNB];
    uint32_t warp_cnt[kNB];
#pragma unroll
    for (int b = 0; b < kNB; ++b) warp_cnt[b] = 0;
#pragma unroll
    for (int q = 0; q < kIdVecs; ++q) {
#pragma unroll
      for (int b = 0; b < kNB; b += 2) {
        m[q][b] = equal16(v[q], b);
        uint32_t c = __popc(m[q][b]);
        if (b + 1 < kNB) {
          m[q][b + 1] = equal16(v[q], b + 1);
          c |= static_cast<uint32_t>(__popc(m[q][b + 1])) << 16;
        }
        const uint32_t incl = warp_inclusive(c, lane);
        const uint32_t tot = __shfl_sync(kFull, incl, 31);
        before[q][b] = warp_cnt[b] + ((incl - c) & 0xFFFFu);
        warp_cnt[b] += tot & 0xFFFFu;
        if (b + 1 < kNB) {
          before[q][b + 1] = warp_cnt[b + 1] + ((incl - c) >> 16);
          warp_cnt[b + 1] += tot >> 16;
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int b = 0; b < kNB; ++b) first[warp][b] = warp_cnt[b];
    }
    __syncthreads();
    if (threadIdx.x < kNB) {  // each warp's first place in the tile
      uint32_t run = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t x = first[w][threadIdx.x];
        first[w][threadIdx.x] = run;
        run += x;
      }
      tile_total[threadIdx.x] = run;
    }
    __syncthreads();
    for (int b = warp; b < kNB; b += kWarps) {  // bucket b's look-back
      const uint32_t prior = look_back<4>(words + b * tiles, j, tile_total[b]);
      if (lane == 0) tile_base[b] = bucket_base[b] + prior;
    }
    __syncthreads();
    // each bucket's elements of the lane, in element order, at consecutive
    // places: lanes of one bucket write next to each other (staging them
    // by bucket in shared memory first was slower on the card)
#pragma unroll
    for (int b = 0; b < kNB; ++b) {
      const uint32_t start = tile_base[b] + first[warp][b];
#pragma unroll
      for (int q = 0; q < kIdVecs; ++q) {
        uint32_t bits = m[q][b];
        long long at = static_cast<long long>(start) + before[q][b];
        const long long i0 = span + 512 * q + 16 * lane;
        while (bits && at < cap) {
          const long long i = i0 + __ffs(bits) - 1;
          bits &= bits - 1;
          idx[at] = static_cast<int32_t>(i);
          if (pay) pay[at] = payload[i];
          ++at;
        }
      }
    }
  }
  fill_tail(min(static_cast<long long>(kept), cap), cap, fill, idx, pay);
  clear_if_last(status, kCounters + static_cast<long long>(kNB) * tiles);
}

// ---------------------------------------------------------------------------
// the match route: ids above kRegMax buckets, three launches
// ---------------------------------------------------------------------------

// an element's bucket from its id byte (nbuckets when it is dropped or,
// with in false, past n)
__device__ __forceinline__ int id_of(uint32_t byte, int nbuckets, bool in) {
  if (!in) return nbuckets;
  return byte < static_cast<uint32_t>(nbuckets) ? static_cast<int>(byte) : nbuckets;
}

__global__ void __launch_bounds__(kThreads)
bucket_compact_count_kernel(const uint8_t* __restrict__ bucket, int is_mask,
                            long long n, int nbuckets, long long tiles,
                            int32_t* __restrict__ scratch) {
  __shared__ int32_t cnt[kMaxBuckets];
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x; b < nbuckets; b += kThreads) cnt[b] = 0;
  __syncthreads();
  // 16 consecutive bytes a thread (the count takes them in any order)
  const long long at = static_cast<long long>(blockIdx.x) * kTile + 16 * threadIdx.x;
  const uint4 v = load16(bucket, at, n, 0);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if (is_mask) {  // one bucket: the thread's set bytes, summed over the warp
    int c = __reduce_add_sync(kFull, __popc(nonzero16(v)));
    if (lane == 0 && c) atomicAdd(&cnt[0], c);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int b = id_of((w[e >> 2] >> (8 * (e & 3))) & 0xFFu, nbuckets, at + e < n);
      const unsigned peers = __match_any_sync(kFull, b);
      if (b < nbuckets && lane == __ffs(peers) - 1) atomicAdd(&cnt[b], __popc(peers));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbuckets; b += kThreads) {
    scratch[static_cast<long long>(b) * tiles + blockIdx.x] = cnt[b];
  }
}

// the exclusive sum of v over the block's threads in thread order, and
// the block's total; every thread calls it
__device__ __forceinline__ int32_t block_exclusive(int32_t v, int32_t* total) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  __shared__ int32_t sum;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t incl = static_cast<int32_t>(warp_inclusive(v, lane));
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t w = warp_sums[lane];
    const int32_t wi = static_cast<int32_t>(warp_inclusive(w, lane));
    warp_sums[lane] = wi - w;  // the warps before
    if (lane == 31) sum = wi;
  }
  __syncthreads();
  const int32_t before = warp_sums[warp] + incl - v;
  *total = sum;
  __syncthreads();  // warp_sums and sum are free again
  return before;
}

// the exclusive prefix sum of scratch[0, entries) in place, by one block:
// chunks of kScanThreads entries, one a thread, kScanBatch chunks' loads
// issued together; then counts[b] and the kept total at scratch[entries]
__global__ void __launch_bounds__(kScanThreads)
bucket_compact_scan_kernel(int32_t* __restrict__ scratch, long long entries,
                           long long tiles, int nbuckets,
                           int32_t* __restrict__ counts) {
  int32_t carry = 0;
  for (long long c0 = 0; c0 < entries; c0 += kScanBatch * kScanThreads) {
    int32_t v[kScanBatch];
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      const long long e = c0 + k * kScanThreads + threadIdx.x;
      v[k] = e < entries ? scratch[e] : 0;
    }
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      if (c0 + k * kScanThreads >= entries) break;  // the same in every thread
      const long long e = c0 + k * kScanThreads + threadIdx.x;
      int32_t chunk;
      const int32_t before = block_exclusive(v[k], &chunk);
      if (e < entries) scratch[e] = carry + before;
      carry += chunk;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) scratch[entries] = carry;
  for (int b = threadIdx.x; b < nbuckets; b += kScanThreads) {
    const int32_t end = b + 1 < nbuckets ? scratch[(b + 1) * tiles] : carry;
    counts[b] = end - scratch[b * tiles];
  }
}

__global__ void __launch_bounds__(kThreads)
bucket_compact_scatter_kernel(const uint8_t* __restrict__ bucket, int is_mask,
                              long long n, int nbuckets, long long tiles,
                              long long cap, int32_t fill,
                              const int32_t* __restrict__ payload,
                              int32_t* __restrict__ idx, int32_t* __restrict__ pay,
                              const int32_t* __restrict__ scratch) {
  // a warp's count of each bucket, then the bucket's next place in it
  __shared__ int32_t place[kWarps][kMaxBuckets];
  __shared__ uint4 stage[kWarps][32];  // the warp's bytes, as loaded
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (int b = threadIdx.x; b < nbuckets; b += kThreads) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) place[w][b] = 0;
  }
  // the warp's kWarpSpan elements: round r, lane l is element 32 r + l,
  // read from the warp's bytes staged in shared memory (loaded 16 a lane)
  const long long span = static_cast<long long>(blockIdx.x) * kTile +
                         static_cast<long long>(warp) * kWarpSpan;
  const long long base = span + lane;
  stage[warp][lane] = load16(bucket, span + 16 * lane, n, 0);
  __syncwarp();
  const uint8_t* staged = reinterpret_cast<const uint8_t*>(stage[warp]);
  int32_t pv[kRounds];  // the kept elements' payload, loaded up front
  if (is_mask) {
    // one bucket: a round's kept lanes are one ballot, and the warp's next
    // place is one register
    unsigned hit[kRounds];
    int32_t own = 0;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const bool k = staged[32 * r + lane] && base + 32 * r < n;
      hit[r] = __ballot_sync(kFull, k);
      own += __popc(hit[r]);
      pv[r] = payload && k ? payload[base + 32 * r] : 0;
    }
    if (lane == 0) place[warp][0] = own;
    __syncthreads();
    int32_t next = scratch[blockIdx.x];
    for (int w = 0; w < warp; ++w) next += place[w][0];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (hit[r] >> lane & 1u) {
        const long long at = next + __popc(hit[r] & lower);
        if (at < cap) {
          idx[at] = static_cast<int32_t>(base + 32 * r);
          if (pay) pay[at] = pv[r];
        }
      }
      next += __popc(hit[r]);
    }
  } else {
    int bk[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      bk[r] = id_of(staged[32 * r + lane], nbuckets, base + 32 * r < n);
      pv[r] = payload && bk[r] < nbuckets ? payload[base + 32 * r] : 0;
    }
    __syncthreads();
    // 1. the warp's count of each bucket (the lanes of one bucket in a
    // round find each other; the lowest adds their number)
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const unsigned peers = __match_any_sync(kFull, bk[r]);
      if (bk[r] < nbuckets && lane == __ffs(peers) - 1) {
        place[warp][bk[r]] += __popc(peers);
      }
      __syncwarp();
    }
    __syncthreads();
    // 2. each bucket's first place in each warp: the tile's base for it,
    // then the warps before
    for (int b = threadIdx.x; b < nbuckets; b += kThreads) {
      int32_t run = scratch[static_cast<long long>(b) * tiles + blockIdx.x];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int32_t c = place[w][b];
        place[w][b] = run;
        run += c;
      }
    }
    __syncthreads();
    // 3. in element order: the bucket's next place, plus the lanes below
    // of the bucket in this round
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int b = bk[r];
      const unsigned peers = __match_any_sync(kFull, b);
      if (b < nbuckets) {
        const long long at = place[warp][b] + __popc(peers & lower);
        if (at < cap) {
          idx[at] = static_cast<int32_t>(base + 32 * r);
          if (pay) pay[at] = pv[r];
        }
      }
      __syncwarp();
      if (b < nbuckets && lane == __ffs(peers) - 1) place[warp][b] += __popc(peers);
      __syncwarp();
    }
  }
  // the fill past the kept elements
  const long long kept = scratch[static_cast<long long>(nbuckets) * tiles];
  fill_tail(min(kept, cap), cap, fill, idx, pay);
}

// ---------------------------------------------------------------------------
// launch geometry
// ---------------------------------------------------------------------------

long long tiles_of(long long n, long long tile) { return (n + tile - 1) / tile; }

// the 16-byte loads a lane makes a mask tile for a call of n elements
int mask_vecs(long long n) { return tiles_of(n, kMaskSmall) > kMaskSwitch ? 4 : 1; }

long long route_tile(Route r, long long n) {
  return r == kRouteMask ? kMaskSmall * mask_vecs(n) : r == kRouteReg ? kIdTile : kTile;
}

// The blocks of one wave of `kernel` on the current device (its SMs times
// the resident blocks an SM), asked of the runtime once a device and slot.
cudaError_t wave_blocks(const void* kernel, int slot, long long* blocks) {
  constexpr int kSlots = 4 + 2 * kRegSlots;
  static long long cached[64][kSlots];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev][slot]) {
    *blocks = cached[dev][slot];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *blocks = static_cast<long long>(sms) * per_sm;
  if (dev < 64) cached[dev][slot] = *blocks;
  return cudaSuccess;
}

// wave_blocks' slots: 0-3 the mask kernel without and with a payload, at
// one load a lane and at four,
// then the count and the scatter kernel of each bucket count
const void* mask_kernel(bool with_payload, int vecs) {
  if (vecs == 1) {
    return with_payload ? reinterpret_cast<const void*>(compact_mask_kernel<true, 1>)
                        : reinterpret_cast<const void*>(compact_mask_kernel<false, 1>);
  }
  return with_payload ? reinterpret_cast<const void*>(compact_mask_kernel<true, 4>)
                      : reinterpret_cast<const void*>(compact_mask_kernel<false, 4>);
}

int mask_slot(bool with_payload, int vecs) { return (with_payload ? 1 : 0) + (vecs == 1 ? 0 : 2); }

template <int kVecs>
cudaError_t launch_mask(const uint8_t* bucket, long long n, long long cap,
                        int32_t fill, const int32_t* payload, int32_t* idx,
                        int32_t* pay, int32_t* counts, uint64_t* status,
                        cudaStream_t s) {
  const long long tiles = tiles_of(n, kMaskSmall * kVecs);
  long long wave = 0;
  const bool with_payload = payload != nullptr;
  const cudaError_t err = wave_blocks(mask_kernel(with_payload, kVecs),
                                      mask_slot(with_payload, kVecs), &wave);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(tiles < wave ? tiles : wave);
  if (with_payload) {
    compact_mask_kernel<true, kVecs><<<grid, kThreads, 0, s>>>(
        bucket, n, tiles, cap, fill, payload, idx, pay, counts, status);
  } else {
    compact_mask_kernel<false, kVecs><<<grid, kThreads, 0, s>>>(
        bucket, n, tiles, cap, fill, payload, idx, pay, counts, status);
  }
  return cudaGetLastError();
}

// the register route's count launch: blocks n ids need, at most one wave
long long reg_count_blocks(long long n) { return tiles_of(n, 16LL * kThreads * kIdVecs); }

template <int kNB>
cudaError_t launch_reg(const uint8_t* bucket, long long n, long long cap,
                       int32_t fill, const int32_t* payload, int32_t* idx,
                       int32_t* pay, int32_t* counts, uint32_t* part,
                       uint64_t* status, cudaStream_t s) {
  const long long tiles = tiles_of(n, kIdTile);
  long long wave = 0;
  cudaError_t err = wave_blocks(reinterpret_cast<const void*>(compact_reg_count_kernel<kNB>),
                                2 * kNB + 2, &wave);
  if (err != cudaSuccess) return err;
  const long long blocks = reg_count_blocks(n);
  compact_reg_count_kernel<kNB><<<static_cast<unsigned>(blocks < wave ? blocks : wave),
                                  kThreads, 0, s>>>(bucket, n, part, counts, status);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = wave_blocks(reinterpret_cast<const void*>(compact_reg_scatter_kernel<kNB>),
                    2 * kNB + 3, &wave);
  if (err != cudaSuccess) return err;
  compact_reg_scatter_kernel<kNB><<<static_cast<unsigned>(tiles < wave ? tiles : wave),
                                    kThreads, 0, s>>>(
      bucket, n, tiles, cap, fill, payload, idx, pay, counts, status);
  return cudaGetLastError();
}

// the register route's launch and scatter kernel for each bucket count
// 1..kRegSlots (those above kRegMax are never taken)
template <int kNB = 1>
cudaError_t launch_reg_of(int nbuckets, const uint8_t* bucket, long long n,
                          long long cap, int32_t fill, const int32_t* payload,
                          int32_t* idx, int32_t* pay, int32_t* counts,
                          uint32_t* part, uint64_t* status, cudaStream_t s) {
  if (nbuckets == kNB || kNB == kRegSlots) {
    return launch_reg<kNB>(bucket, n, cap, fill, payload, idx, pay, counts, part, status,
                           s);
  }
  return launch_reg_of<(kNB < kRegSlots ? kNB + 1 : kNB)>(
      nbuckets, bucket, n, cap, fill, payload, idx, pay, counts, part, status, s);
}

template <int kNB = 1>
const void* reg_scatter_of(int nbuckets) {
  if (nbuckets == kNB || kNB == kRegSlots) {
    return reinterpret_cast<const void*>(compact_reg_scatter_kernel<kNB>);
  }
  return reg_scatter_of<(kNB < kRegSlots ? kNB + 1 : kNB)>(nbuckets);
}

}  // namespace

// Elements per tile of the route a call of this form and n elements takes
// (the card tests place their edge cases by it), and the most tiles of one
// load a lane a mask call takes before its tiles grow to four.
extern "C" long long repaq_bucket_compact_tile(int is_mask, int nbuckets, long long n) {
  return route_tile(route_of(is_mask, nbuckets), n);
}

extern "C" long long repaq_bucket_compact_mask_switch() { return kMaskSwitch; }

// Tiles that one wave of resident blocks takes at once on the current
// device, for the mask and register routes, whose blocks take tiles until
// none is left (the card tests give them more; a mask's kernel without a
// payload, at the tile of a call of n elements); 0 for the match route (a
// block a tile) or on an error.
extern "C" long long repaq_bucket_compact_wave(int is_mask, int nbuckets, long long n) {
  long long blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (route_of(is_mask, nbuckets)) {
    case kRouteMask:
      err = wave_blocks(mask_kernel(false, mask_vecs(n)), mask_slot(false, mask_vecs(n)),
                        &blocks);
      break;
    case kRouteReg:
      err = wave_blocks(reg_scatter_of(nbuckets), 2 * nbuckets + 3, &blocks);
      break;
    default:
      break;
  }
  return err == cudaSuccess ? blocks : 0;
}

// 64-bit words of zeroed status a launch needs (and leaves zeroed): the
// two counters, then its tiles' words.
extern "C" long long repaq_bucket_compact_status_words(long long n, int nbuckets,
                                                       int is_mask) {
  switch (route_of(is_mask, nbuckets)) {
    case kRouteMask:
      return kCounters + tiles_of(n, route_tile(kRouteMask, n));
    case kRouteReg:
      return kCounters + nbuckets * tiles_of(n, kIdTile);
    default:
      return 0;
  }
}

// int32 words of scratch a launch needs, any contents: for the match route
// each tile's count of each bucket, then the kept total; for the register
// route each count block's count of each bucket; 0 for a mask. A launch's
// own buffer: the count and the scatter of a call may have another call's
// launches between them on the stream.
extern "C" long long repaq_bucket_compact_scratch_words(long long n, int nbuckets,
                                                        int is_mask) {
  switch (route_of(is_mask, nbuckets)) {
    case kRouteReg:
      return reg_count_blocks(n) * nbuckets;
    case kRouteMatch:
      return tiles_of(n, kTile) * nbuckets + 1;
    default:
      return 0;
  }
}

// bucket: n bytes, 16-byte aligned (is_mask: bool, True kept as bucket 0;
// else bucket ids, those >= nbuckets dropped), nbuckets in 1..256; idx:
// cap int32; payload and pay: n and cap int32, or both null (pay may be
// null at cap 0), payload 16-byte aligned; counts: nbuckets int32;
// scratch: repaq_bucket_compact_scratch_words int32, any contents (null
// when 0); status: repaq_bucket_compact_status_words zeroed 64-bit words,
// zeroed again when the launch ends.
extern "C" int repaq_bucket_compact(const void* bucket, int is_mask, long long n,
                                    int nbuckets, long long cap, int fill,
                                    const void* payload, void* idx, void* pay,
                                    void* counts, void* scratch, void* status,
                                    void* stream) {
  if (n <= 0) return 0;
  if (n > INT_MAX || cap < 0 || cap > INT_MAX || nbuckets < 1 ||
      nbuckets > kMaxBuckets || (is_mask && nbuckets != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(bucket);
  const int32_t* pl = static_cast<const int32_t*>(payload);
  int32_t* ix = static_cast<int32_t*>(idx);
  int32_t* py = static_cast<int32_t*>(pay);
  int32_t* ct = static_cast<int32_t*>(counts);
  uint64_t* st = static_cast<uint64_t*>(status);
  const Route route = route_of(is_mask, nbuckets);
  if (route == kRouteMask) {
    return static_cast<int>(mask_vecs(n) == 1
                                ? launch_mask<1>(b, n, cap, fill, pl, ix, py, ct, st, s)
                                : launch_mask<4>(b, n, cap, fill, pl, ix, py, ct, st, s));
  }
  if (route == kRouteReg) {
    return static_cast<int>(launch_reg_of(nbuckets, b, n, cap, fill, pl, ix, py, ct,
                                          static_cast<uint32_t*>(scratch), st, s));
  }
  const long long tiles = tiles_of(n, kTile);
  int32_t* sc = static_cast<int32_t*>(scratch);
  bucket_compact_count_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      b, is_mask, n, nbuckets, tiles, sc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bucket_compact_scan_kernel<<<1, kScanThreads, 0, s>>>(
      sc, tiles * nbuckets, tiles, nbuckets, ct);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bucket_compact_scatter_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      b, is_mask, n, nbuckets, tiles, cap, fill, pl, ix, py, sc);
  return static_cast<int>(cudaGetLastError());
}
