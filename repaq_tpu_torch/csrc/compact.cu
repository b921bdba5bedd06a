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
// for an SE chunk's grouping, 12.6 MB read and ~6.8 MB written, ~0.006 ms
// at 3.35 TB/s. A sort of the same keys makes four or more passes over
// tens of MB.
//
// The design, three launches of one entry (a bucket's place in the output
// needs the totals of the buckets below it, so the counts come first):
//   1. count: a block a tile of kTile elements, 16 consecutive bytes a
//      thread in one vector load. A mask's set bytes are summed over the
//      warp and added to the tile's counter in shared memory; for ids,
//      byte by byte, the lanes of a warp holding one id find each other
//      (__match_any_sync) and the lowest adds their number to that id's
//      counter. Each tile writes its nbuckets counts to scratch,
//      bucket-major: scratch[b * tiles + j].
//   2. scan: one block takes the exclusive prefix sum of those counts in
//      place (in chunks of one entry a thread, a block-wide scan a chunk),
//      so scratch[b * tiles + j] becomes the output position of bucket
//      b's first element in tile j; it writes counts[b] and the kept total
//      (scratch[nbuckets * tiles]).
//   3. scatter: a block a tile again, each warp owning kWarpSpan
//      consecutive elements of it (round r, lane l: element 32 r + l of
//      the warp's span), its bytes loaded 16 a lane and staged in shared
//      memory, the kept elements' payload loaded before the first round.
//      Each warp counts its elements of each bucket (ids: as in 1, into
//      shared memory; a mask: one ballot a round, in a register); after
//      one barrier each bucket's first place in each warp is the tile's
//      base for it plus the warps before. Then, round by round in element
//      order, a kept element's place is its warp's next place for its
//      bucket plus the lanes below of that bucket (the match mask or the
//      ballot), and the round's count moves the next place on (ids: the
//      lowest of the lanes adds it in shared memory; a mask: every lane
//      adds it to its register). Places below cap get i and payload[i].
//      Then the blocks write fill and 0 over [kept total, cap), a
//      grid-stride loop.
// The order within a warp's span is the element order (rounds in turn,
// lanes in a round), the warps' spans follow each other, and the tiles'
// bases follow the tile order within each bucket, so the result is the
// stable order, and it is the same from launch to launch. A simple design
// first: one element a lane a round in the scatter, two barriers a tile.
// The wrapper passes a 16-byte aligned bucket tensor.
//
// The launch has a plain C entry (repaq_bucket_compact); ops/kernels.py
// binds it with ctypes and counts one launch a call.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kWarpSpan = 32 * kRounds;  // elements a warp owns in the scatter
constexpr long long kTile = static_cast<long long>(kThreads) * kRounds;
constexpr int kMaxBuckets = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanBatch = 16;  // chunks whose loads the scan issues together
constexpr unsigned kFull = 0xFFFFFFFFu;

// the 16 bucket bytes at `at` (16-byte aligned), those past n as 0
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ bucket,
                                        long long at, long long n) {
  if (at + 16 <= n) return *reinterpret_cast<const uint4*>(bucket + at);
  uint32_t w[4] = {0, 0, 0, 0};
  for (int e = 0; e < 16; ++e) {
    if (at + e < n) w[e >> 2] |= static_cast<uint32_t>(bucket[at + e]) << (8 * (e & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

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
  const uint4 v = load16(bucket, at, n);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if (is_mask) {  // one bucket: the thread's set bytes, summed over the warp
    int c = 0;
#pragma unroll
    for (int e = 0; e < 16; ++e) c += ((w[e >> 2] >> (8 * (e & 3))) & 0xFFu) != 0;
    c = __reduce_add_sync(kFull, c);
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
  int32_t incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t w = warp_sums[lane];
    int32_t wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t o = __shfl_up_sync(kFull, wi, d);
      if (lane >= d) wi += o;
    }
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
  stage[warp][lane] = load16(bucket, span + 16 * lane, n);
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
  for (long long k = min(kept, cap) + static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       k < cap; k += static_cast<long long>(gridDim.x) * kThreads) {
    idx[k] = fill;
    if (pay) pay[k] = 0;
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Elements per tile (the card tests place their edge cases by it).
extern "C" long long repaq_bucket_compact_tile() { return kTile; }

// int32 words of scratch a launch needs: each tile's count of each bucket,
// then the kept total.
extern "C" long long repaq_bucket_compact_scratch_words(long long n, int nbuckets) {
  return tiles_of(n) * nbuckets + 1;
}

// bucket: n bytes, 16-byte aligned (is_mask: bool, True kept as bucket 0;
// else bucket ids, those >= nbuckets dropped), nbuckets in 1..256; idx:
// cap int32; payload and pay: n and cap int32, or both null (pay may be
// null at cap 0); counts: nbuckets int32; scratch:
// repaq_bucket_compact_scratch_words(n, nbuckets) int32, any contents.
extern "C" int repaq_bucket_compact(const void* bucket, int is_mask, long long n,
                                    int nbuckets, long long cap, int fill,
                                    const void* payload, void* idx, void* pay,
                                    void* counts, void* scratch, void* stream) {
  if (n <= 0) return 0;
  if (n > INT_MAX || cap < 0 || cap > INT_MAX || nbuckets < 1 ||
      nbuckets > kMaxBuckets || (is_mask && nbuckets != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = tiles_of(n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(bucket);
  int32_t* sc = static_cast<int32_t*>(scratch);
  bucket_compact_count_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      b, is_mask, n, nbuckets, tiles, sc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bucket_compact_scan_kernel<<<1, kScanThreads, 0, s>>>(
      sc, tiles * nbuckets, tiles, nbuckets, static_cast<int32_t*>(counts));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bucket_compact_scatter_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      b, is_mask, n, nbuckets, tiles, cap, fill,
      static_cast<const int32_t*>(payload), static_cast<int32_t*>(idx),
      static_cast<int32_t*>(pay), sc);
  return static_cast<int>(cudaGetLastError());
}
