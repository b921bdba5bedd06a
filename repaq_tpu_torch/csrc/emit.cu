// Gap/run token emission for Hopper (sm_90a): the encode's by-column
// quality stream and its N-position stream, written whole by one kernel
// from the grouped positions. Two entries of one design.
//
// Replaces: XLA code of the JAX package, not a Pallas kernel. In
// repaq_tpu/ops/device_streams.py, everything qualcol_encode_device (:423)
// does after its grouping sort (the bin of each grouped element, the
// segment starts, `_classify_stream_positions` :258, `_stream_b0` :289,
// the offsets' cumsum, the escape gather, `_stream_tail_fn` :316, the
// length table, `_emit_sort_lazy` :210 and `_emit_sort_pay` :160 with
// their compaction of the multi-byte tokens and the layout sort of
// `_sorted_stream` :48), and the same chain of `_positions_from_gpos`
// (:366) under encode_positions_from_meta32 (:383). The port ran it as
// ~40 eager torch operations a stream, with two compactions, a run-offset
// scan and a layout write among them.
//
// The grammar (reference rfqcodec.cpp:625-765). Over grouped positions
// g[i], ascending within each segment (a quality bin; the N stream is one
// segment), with delta = g[i] + 1 at a segment's start and g[i] - g[i - 1]
// elsewhere, a stream element is adjacent when delta == 1 and g[i] > 1.
// A run of adjacent elements emits a run token at every 32nd element from
// its start, (covered - 1) | 0xC0 with covered = min(32, the run's
// elements from it on). Any other stream element emits a gap token of
// v = delta - 1: v (delta <= 128), v >> 8 | 0x80, v (<= 2^14), or
// v >> 24 | 0xE0, v >> 16, v >> 8, v (4 bytes). The quality stream puts a
// u32le byte length a bin in front (4 B bytes), and after the bins the
// escape records of its escape bucket: the quality char, then the
// position as u32le.
//
// What bounds it on the card: memory, in principle. It reads the kept
// grouped positions (4 bytes an element), a quality byte an escape and
// B + 1 bin counts, and writes the output buffer once (the zero fill, then
// the stream's bytes over it): for an SE chunk's quality call, ~1.7 M of
// 2,097,152 grouped elements and a 3 MB buffer, ~3 us at 3.35 TB/s. In
// practice a tile's chain of dependent round trips bounds it (the ticket,
// the loads, two look-backs, the stores): on an NVIDIA H100 (80GB HBM3,
// 700 W) the kernel takes ~26 us at that call and ~7 us for the N stream's
// 6 tiles, and neither tiles of 4,096 elements nor 128-thread tiles moved
// it (PERF.md; tools/profile_emit.py --tree times a variant in turns).
//
// The design: one launch, a tile of kTile grouped elements a block, kPer
// consecutive ones a thread, tiles in ticket order (an atomic counter) so
// that a tile waits only on tiles that have started. Per tile:
//   1. Loads, issued first: each thread its kPer positions (16-byte loads)
//      and the one before them, warp 0 the 32 past the tile (the halo).
//      Meanwhile warp 0 scans the B + 1 bin counts into the bin starts
//      (the grouping's order: bins 0..B-1, then the escapes, then the
//      major's fill), which mark the segment starts in the tile and its
//      halo in a bitmap.
//   2. Each element is classified: nothing, a gap of 1, 2 or 4 bytes,
//      adjacent, or an escape. The adjacent flags go into a bitmap of
//      32-bit words, the halo's last.
//   3. The first dependent scan: the last non-adjacent element before each
//      thread, a max-scan over the threads and, by decoupled look-back
//      (Merrill and Garland), over the tiles before. A run token falls
//      where (i - last - 1) % 32 == 0, so a tile's byte count is known
//      only once the run carried into it is.
//   4. The second: each thread's byte count, a sum-scan over the threads
//      and by look-back over the tiles. Both look-backs publish a tile's
//      own value at once and its inclusive value when known (64-bit
//      status words, a flag above a 32-bit value), as csrc/scan.cu does.
//   5. The tile's bytes are built in shared memory, at the output's
//      16-byte phase: covered from the bitmap (the first clear bit after
//      the element, up to 32, the halo covering the last elements), gap
//      bytes from delta, escape records from the position and one gathered
//      quality byte. They are stored with 16-byte stores where a 16-byte
//      line is the tile's alone and byte stores at the two ends it shares
//      with the tiles either side. Bytes at offsets >= out_size are dropped.
//   6. The length table: each bin's bytes within the tile, from a table of
//      the elements' offsets in shared memory, added with one 32-bit atomic
//      a bin a tile into the table's word (the output is little-endian
//      and zeroed first). The last tile writes the total.
// The status words (the ticket counter and a pad word, then two words a
// tile) lie in front
// of the output in one buffer, so the one zero fill the output needs
// clears them too: a call is two device operations, that fill and this
// kernel. (The last block's clearing of csrc/scan.cu puts a fence and an
// atomic on every tile's path: 0.0388-0.0402 ms against 0.0351-0.0361 at
// a real chunk's quality call, fill included, on the same card.)

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;              // threads per tile
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                    // consecutive elements a thread
constexpr int kTile = kThreads * kPer;     // elements a tile
constexpr int kWords = kTile / 32;         // adjacent-flag words, + the halo's
constexpr int kStage = 5 * kTile + 16;     // an escape's 5 bytes the longest
constexpr int kMaxBins = 125;              // the quality stream's B < 125
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kFlagTotal = 1;  // status: the tile's own value
constexpr uint32_t kFlagIncl = 2;   // status: its inclusive value
constexpr int kCounters = 2;        // the ticket, a pad: 16-byte multiple
static_assert(32 % kPer == 0 && kPer % 4 == 0,
              "a thread's adjacent flags are a part of one 32-bit word, its "
              "positions whole 16-byte loads");
static_assert(kThreads >= kMaxBins && kWarps <= 32,
              "a thread a bin for the table (B < 125), warp 0 the scans");
static_assert(kStage < 65536, "element offsets within a tile are 16-bit");

// element kinds
constexpr uint8_t kNone = 0, kGap1 = 1, kGap2 = 2, kGap4 = 3, kAdj = 4,
                  kEsc = 5;

// the first scan: the last non-adjacent element, -1 before the stream
struct LastNa {
  using T = int32_t;
  __device__ static T identity() { return -1; }
  __device__ static T op(T older, T newer) { return max(older, newer); }
};

// the second: bytes
struct Bytes {
  using T = int32_t;
  __device__ static T identity() { return 0; }
  __device__ static T op(T older, T newer) { return older + newer; }
};

__device__ __forceinline__ int32_t shfl(int32_t v, int src) {
  return __shfl_sync(kFull, v, src);
}

template <class Op>
__device__ __forceinline__ int32_t warp_scan(int32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = Op::op(o, v);
  }
  return v;
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

__device__ __forceinline__ void publish(uint64_t* p, uint32_t flag, int32_t v) {
  store_release(p, static_cast<uint64_t>(flag) << 32 | static_cast<uint32_t>(v));
}

__device__ __forceinline__ void read_status(const uint64_t* p, uint32_t* flag,
                                            int32_t* v) {
  const uint64_t x = load_acquire(p);
  *flag = static_cast<uint32_t>(x >> 32);
  *v = static_cast<int32_t>(x);
}

// the tile's index in launch order, from the ticket counter
__device__ __forceinline__ long long take_ticket(uint64_t* status) {
  __shared__ unsigned ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(reinterpret_cast<unsigned*>(status), 1u);
  __syncthreads();
  return ticket;
}

template <class Op>
struct Prior {
  int32_t warp;   // everything before the calling warp
  int32_t tile;   // everything before the tile
  int32_t total;  // the tile's own value
};

// Steps 3 and 4: the value of everything before this warp, from the warps'
// totals and, by look-back, the tiles before tile j (`tiles`: one status
// word a tile). Every thread of the block calls it.
template <class Op>
__device__ Prior<Op> prior_of_warp(int32_t warp_total, uint64_t* tiles, long long j) {
  __shared__ int32_t warp_vals[kWarps];
  __shared__ int32_t tile_before, tile_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_vals[warp] = warp_total;
  __syncthreads();
  if (warp == 0) {
    const int32_t own = lane < kWarps ? warp_vals[lane] : Op::identity();
    const int32_t incl = warp_scan<Op>(own, lane);
    const int32_t up = __shfl_up_sync(kFull, incl, 1);
    const int32_t before = lane ? up : Op::identity();
    const int32_t total = shfl(incl, kWarps - 1);
    if (lane < kWarps) warp_vals[lane] = before;
    if (lane == 0) publish(tiles + j, j == 0 ? kFlagIncl : kFlagTotal, total);
    int32_t acc = Op::identity();
    for (long long hi = j - 1; hi >= 0; hi -= 32) {
      // lane l reads tile hi - l; before the first tile, the identity
      // reads as an inclusive value
      const long long k = hi - lane;
      int32_t val = Op::identity();
      uint32_t flag = kFlagIncl;
      if (k >= 0) read_status(tiles + k, &flag, &val);
      while (!__all_sync(kFull, flag != 0)) {
        if (flag == 0) read_status(tiles + k, &flag, &val);
      }
      const unsigned incls = __ballot_sync(kFull, flag == kFlagIncl);
      const int nearest = incls ? __ffs(incls) - 1 : 31;
      if (lane > nearest) val = Op::identity();
      // fold in order, lane 0 the newest: lane l ends holding lanes l..31
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t o = __shfl_down_sync(kFull, val, d);
        if (lane + d < 32) val = Op::op(o, val);
      }
      acc = Op::op(shfl(val, 0), acc);
      if (incls) break;
    }
    if (lane == 0) {
      if (j > 0) publish(tiles + j, kFlagIncl, Op::op(acc, total));
      tile_before = acc;
      tile_total = total;
    }
  }
  __syncthreads();
  return {Op::op(tile_before, warp_vals[warp]), tile_before, tile_total};
}

struct Stream {
  const int32_t* g_pos;
  int32_t m;           // grouped elements
  int32_t stream_end;  // elements before it are stream elements (bins)
  int32_t esc_end;     // [stream_end, esc_end): escape records
  int32_t limit;       // with by_value, a stream position is below it
  bool by_value;
};

// The kind of element i (< m) and its delta.
__device__ __forceinline__ uint8_t classify(const Stream& st, int32_t i,
                                            int32_t p, int32_t prev, bool seg,
                                            int32_t* delta) {
  *delta = 0;
  if (i >= st.m) return kNone;
  if (i >= st.stream_end) return i < st.esc_end ? kEsc : kNone;
  if (st.by_value && p >= st.limit) return kNone;
  // int32 arithmetic that wraps, as torch's does
  const int32_t d = static_cast<int32_t>(
      seg ? static_cast<uint32_t>(p) + 1u
          : static_cast<uint32_t>(p) - static_cast<uint32_t>(prev));
  *delta = d;
  if (d == 1 && p > 1) return kAdj;
  return d <= 128 ? kGap1 : d <= (1 << 14) ? kGap2 : kGap4;
}

__device__ __forceinline__ bool bit_at(const uint32_t* words, int b) {
  return (words[b >> 5] >> (b & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads)
emit_kernel(Stream st, const int32_t* __restrict__ bin_counts, int nbins,
            const uint8_t* __restrict__ qual, long long nq, long long esc_cap,
            uint8_t* __restrict__ out, long long out_size,
            int32_t* __restrict__ total, long long tiles,
            uint64_t* __restrict__ status) {
  __shared__ long long bin_start[kMaxBins + 2];
  __shared__ uint32_t seg_words[kWords + 1];
  __shared__ uint32_t adj_words[kWords + 1];
  __shared__ uint16_t local_off[kTile + 1];
  __shared__ __align__(16) uint8_t stage[kStage];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool table = bin_counts != nullptr;
  const long long hdr = table ? 4LL * nbins : 0;
  const long long j = take_ticket(status);
  // element indices are int32: m is at most INT_MAX - 2 kTile
  const int32_t s = static_cast<int32_t>(j * kTile);

  // 1. the loads first, so that they overlap the bin starts': each thread
  // its kPer positions and the one before them, warp 0 the halo
  const int32_t i0 = s + kPer * tid;
  int32_t p[kPer];
  if (i0 + kPer <= st.m) {
#pragma unroll
    for (int v = 0; v < kPer / 4; ++v) {
      const int4 a = *reinterpret_cast<const int4*>(st.g_pos + i0 + 4 * v);
      p[4 * v] = a.x, p[4 * v + 1] = a.y, p[4 * v + 2] = a.z, p[4 * v + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) p[k] = i0 + k < st.m ? st.g_pos[i0 + k] : 0;
  }
  const int32_t prev0 = i0 > 0 && i0 - 1 < st.m ? st.g_pos[i0 - 1] : 0;
  const int32_t ih = s + kTile + lane;
  int32_t ph = 0, prevh = 0;
  if (warp == 0) {
    ph = ih < st.m ? st.g_pos[ih] : 0;
    prevh = ih - 1 < st.m ? st.g_pos[ih - 1] : 0;
  }

  // the bin starts, and the segment starts in [s, s + kTile + 32)
  for (int w = tid; w <= kWords; w += kThreads) seg_words[w] = 0;
  if (table && warp == 0) {
    long long c[4], sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = 4 * lane + k;
      c[k] = b <= nbins ? bin_counts[b] : 0;
      sum += c[k];
    }
    long long incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    long long at = incl - sum;
    if (lane == 0) bin_start[0] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      at += c[k];
      if (4 * lane + k <= nbins) bin_start[4 * lane + k + 1] = at;
    }
  }
  __syncthreads();
  if (table) {
    st.stream_end = static_cast<int32_t>(min(bin_start[nbins], static_cast<long long>(st.m)));
    st.esc_end = static_cast<int32_t>(min(bin_start[nbins + 1], static_cast<long long>(st.m)));
    // a stream element starts a segment where a bin starts; elements at or
    // past stream_end never read it
    if (tid >= 1 && tid <= nbins) {
      const long long q = bin_start[tid] - s;
      if (q >= 0 && q < kTile + 32) atomicOr(&seg_words[q >> 5], 1u << (q & 31));
    }
  }
  __syncthreads();

  // 2. kinds
  const uint32_t seg_bits =
      seg_words[kPer * tid >> 5] >> (kPer * tid & 31);  // kPer <= 16 bits
  uint8_t kind[kPer];
  int32_t delta[kPer];
  uint32_t adj = 0;
  int last_na = -1;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int32_t i = i0 + k;
    const bool seg = i == 0 || (seg_bits >> k & 1u);
    kind[k] = classify(st, i, p[k], k ? p[k - 1] : prev0, seg, &delta[k]);
    if (kind[k] == kAdj) {
      adj |= 1u << k;
    } else {
      last_na = k;
    }
  }
  {
    // a word is 32 / kPer threads' flags
    constexpr int kShare = 32 / kPer;
    uint32_t word = adj;
#pragma unroll
    for (int r = 1; r < kShare; ++r) {
      word |= __shfl_down_sync(kFull, adj, r) << (r * kPer % 32);
    }
    if (lane % kShare == 0) adj_words[tid / kShare] = word;
  }
  if (warp == 0) {  // the halo: the 32 elements past the tile
    int32_t dh;
    const uint8_t kh = classify(st, ih, ph, prevh, bit_at(seg_words, kTile + lane), &dh);
    const unsigned halo = __ballot_sync(kFull, kh == kAdj);
    if (lane == 0) adj_words[kWords] = halo;
  }

  // 3. the last non-adjacent element before each thread's first
  const int32_t na = last_na >= 0 ? static_cast<int32_t>(i0 + last_na) : -1;
  const int32_t na_incl = warp_scan<LastNa>(na, lane);
  const int32_t na_up = __shfl_up_sync(kFull, na_incl, 1);
  const Prior<LastNa> rp = prior_of_warp<LastNa>(
      shfl(na_incl, 31), status + kCounters, j);
  int32_t last = max(rp.warp, lane ? na_up : LastNa::identity());

  // 4. bytes: a run token where the run's offset is a multiple of 32
  uint8_t cnt[kPer];
  int32_t sum = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int32_t i = static_cast<int32_t>(i0 + k);
    uint8_t c;
    switch (kind[k]) {
      case kGap1: c = 1; break;
      case kGap2: c = 2; break;
      case kGap4: c = 4; break;
      case kEsc: c = 5; break;
      case kAdj: c = ((i - last - 1) & 31) == 0; break;
      default: c = 0;
    }
    if (kind[k] != kAdj) last = i;
    cnt[k] = c;
    sum += c;
  }
  const int32_t b_incl = warp_scan<Bytes>(sum, lane);
  const Prior<Bytes> bp = prior_of_warp<Bytes>(
      shfl(b_incl, 31), status + kCounters + tiles, j);
  const int32_t tile_bytes = bp.total;
  const long long g0 = hdr + bp.tile;  // the tile's first byte in out
  const int lead = static_cast<int>(g0 & 15);

  // 5. the tile's bytes in shared memory
  int32_t o = bp.warp + b_incl - sum - bp.tile;  // within the tile
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = kPer * tid + k;
    local_off[e] = static_cast<uint16_t>(o);
    uint8_t* d = stage + lead + o;
    const uint32_t v = static_cast<uint32_t>(delta[k]) - 1u;
    switch (cnt[k] ? kind[k] : kNone) {
      case kGap1: d[0] = v; break;
      case kGap2: d[0] = v >> 8 | 0x80u; d[1] = v; break;
      case kGap4:
        d[0] = static_cast<uint32_t>(static_cast<int32_t>(v) >> 24) | 0xE0u;
        d[1] = v >> 16;
        d[2] = v >> 8;
        d[3] = v;
        break;
      case kAdj: {
        // covered: the elements of the run from this one on, up to 32
        const unsigned long long w =
            (static_cast<unsigned long long>(adj_words[(e >> 5) + 1]) << 32 |
             adj_words[e >> 5]) >> (e & 31);
        const unsigned long long clear = ~w;
        const int covered =
            clear ? min(32, __ffsll(static_cast<long long>(clear)) - 1) : 32;
        d[0] = static_cast<uint8_t>((covered - 1) | 0xC0);
        break;
      }
      case kEsc: {
        // the char only for the first esc_cap escapes, as the torch
        // composition gathers them; no record without escape room
        const int32_t ek = i0 + k - st.stream_end;
        const uint32_t pos = esc_cap > 0 ? static_cast<uint32_t>(p[k]) : 0u;
        long long qi = p[k] < 0 ? 0 : p[k];
        qi = qi < nq ? qi : nq - 1;
        d[0] = esc_cap > 0 && ek < esc_cap ? qual[qi] : 0;
        d[1] = pos;
        d[2] = pos >> 8;
        d[3] = pos >> 16;
        d[4] = pos >> 24;
        break;
      }
      default: break;
    }
    o += cnt[k];
  }
  if (tid == 0) local_off[kTile] = static_cast<uint16_t>(tile_bytes);
  __syncthreads();

  // stored whole: 16-byte lines the tile owns, bytes at its two ends
  const long long end = min(g0 + tile_bytes, out_size);
  const long long a0 = g0 & ~15LL;
  for (long long c = a0 + 16LL * tid; c < end; c += 16LL * kThreads) {
    if (c >= g0 && c + 16 <= end) {
      *reinterpret_cast<uint4*>(out + c) = *reinterpret_cast<const uint4*>(stage + (c - a0));
    } else {
      for (long long x = max(c, g0); x < min(c + 16, end); ++x) out[x] = stage[x - a0];
    }
  }

  // 6. this tile's bytes of each bin into the length table
  if (table && tid < nbins) {
    const long long hi_end = min(s + kTile, st.m);
    const long long lo = min(max(bin_start[tid], static_cast<long long>(s)), hi_end);
    const long long hi = min(max(bin_start[tid + 1], static_cast<long long>(s)), hi_end);
    const int32_t add = static_cast<int32_t>(local_off[hi - s]) -
                        static_cast<int32_t>(local_off[lo - s]);
    if (add) atomicAdd(reinterpret_cast<unsigned*>(out) + tid, static_cast<unsigned>(add));
  }
  if (j == tiles - 1 && tid == 0) *total = static_cast<int32_t>(g0 + tile_bytes);
}

long long emit_tiles(long long m) { return m > 0 ? (m + kTile - 1) / kTile : 1; }

}  // namespace

// Grouped elements per tile (the card tests place their edge cases by it).
extern "C" long long repaq_emit_tile() { return kTile; }

// 64-bit words of zeroed status the kernel needs (an even count): the
// ticket counter and a pad word, then two words a tile.
extern "C" long long repaq_emit_status_words(long long m) {
  return kCounters + 2 * emit_tiles(m);
}

// The gap/run stream of the m int32 grouped positions g_pos (16-byte
// aligned) into out (out_size bytes, 16-byte aligned, zeroed by the
// caller), its byte length into *total (int32).
// With bin_counts (nbins + 1 int32: the grouping's counts of bins
// 0..nbins-1 and of the escapes): the quality stream, a 4 * nbins byte
// u32le length table (out_size must hold it), the bins' tokens and the
// escape records, whose char is read from qual (nq bytes); limit unused.
// Without: one segment of the elements whose position is below `limit`
// (the N stream's n).
// status: zeroed words, at least repaq_emit_status_words(m), left as the
// kernel used them (the wrappers zero them with out, in one buffer).
extern "C" int repaq_emit_tokens(const void* g_pos, long long m,
                                 const void* bin_counts, int nbins,
                                 const void* qual, long long nq,
                                 long long limit, long long esc_cap, void* out,
                                 long long out_size, void* total, void* status,
                                 void* stream) {
  const bool table = bin_counts != nullptr;
  if (m < 0 || m > INT_MAX - 2LL * kTile || out_size < 0 ||
      out_size >= (1LL << 30) || nbins < 0 || nbins > kMaxBins - 1 ||
      (table && (out_size < 4LL * nbins || nq <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = emit_tiles(m);
  // the N stream (no bin counts) is one segment of the positions below
  // limit; the quality stream's bins and escapes come from its counts
  Stream st{static_cast<const int32_t*>(g_pos), static_cast<int32_t>(m),
            static_cast<int32_t>(m), static_cast<int32_t>(m),
            static_cast<int32_t>(limit < INT_MAX ? limit : INT_MAX), !table};
  emit_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      st, static_cast<const int32_t*>(bin_counts), nbins,
      static_cast<const uint8_t*>(qual), nq, esc_cap,
      static_cast<uint8_t*>(out), out_size, static_cast<int32_t*>(total),
      tiles, static_cast<uint64_t*>(status));
  return static_cast<int>(cudaGetLastError());
}
