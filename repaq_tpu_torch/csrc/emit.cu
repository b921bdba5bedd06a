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
// elements from it on): ceil(L / 32) bytes for a run of L. Any other
// stream element emits a gap token of v = delta - 1: v (delta <= 128),
// v >> 8 | 0x80, v (<= 2^14), or v >> 24 | 0xE0, v >> 16, v >> 8, v (4
// bytes). The quality stream puts a u32le byte length a bin in front (4 B
// bytes), and after the bins the escape records of its escape bucket: the
// quality char, then the position as u32le. Every element that is not
// adjacent (a gap, an escape record, fill) ends a run, and a segment's
// first element is never adjacent (delta = g + 1 is 1 only at g = 0).
//
// One associative operator carries the runs across tiles, as in
// csrc/coords.cu. For a stretch of elements:
//   brk    whether it holds an element that is not adjacent,
//   lead   the adjacent elements before its first such element (all of
//          them if none),
//   mid    its bytes from that element through the last such one (1, 2 or
//          4 a gap, 5 an escape, 0 fill, ceil(L / 32) a run closed inside),
//   trail  the adjacent elements after its last such element,
// combined as A then B: the run where A's trail meets B's lead closes at
// B's first break, adding ceil((A.trail + B.lead) / 32) bytes. A prefix
// from element 0 always has brk set (element 0 starts a segment), so it
// is carried as a state (u, r): u = mid + ceil(trail / 32), the offset of
// the next element's first byte past the table, and r = trail mod 32, the
// next adjacent element emitting a run token at u when r is 0.
//
// What bounds it on the card: memory, in principle. It reads the kept
// grouped positions (4 bytes an element), a quality byte an escape and
// B + 1 bin counts, and writes the output buffer once: for an SE chunk's
// quality call, ~1.7 M of 2,097,152 grouped elements and a 3 MB buffer,
// ~3 us at 3.35 TB/s. In practice the SMs' issue of the per-element work
// (classifying each element, building its bytes) and the chain of the
// slowest tile set the time: its ticket and load, its classification while
// the SM's other tiles take their turns at the same work, its bytes, the
// look-back that waits on the slowest tile's value, the store; the zeros
// past the total wait on the last kept tile (PERF.md: the times, the steps
// of a tile, and the designs that lost in turns).
//
// The design: one persistent wave of blocks (the blocks the SMs hold at
// once, no more than the tiles or the tail needs), a tile at a time, in
// ticket order (an atomic counter) so that a tile waits only on tiles
// whose tickets were drawn before. The quality stream's tiles are of
// 4,096 grouped elements, 16 consecutive ones a thread: the wave holds a
// real chunk's call in one turn. The N stream's are of 1,024, 4 a thread:
// a real chunk's dozen tiles each take a short chain. A block scans the
// B + 1 bin counts once into the bin starts (the grouping's order: bins
// 0..B-1, the escapes, the major's fill): they give the kept count K (the
// elements up to the escapes' end). The N stream's kept elements are the
// positions below n, a prefix of the ascending g_pos. Per tile:
//   1. The tile's positions, the 4 before and the 32 past it (the halo)
//      were staged into shared memory by 16-byte cp.async while the tile
//      before was stored. A tile at or past K (for the N stream: whose
//      first position is n or more) is fill: its block leaves the loop.
//   2. The segment starts in the tile and its halo go into a bitmap (a
//      thread a bin) and each element is classified (nothing, a gap of 1,
//      2 or 4 bytes, adjacent, an escape; 3 bits, kept in a register), a
//      quad of positions at a time; the adjacent flags go into a bitmap of
//      32-bit words, the halo's last. Each thread counts its bytes from its
//      first break on: the runs that start in it.
//   3. Two integer scans across the tile: the last break before each
//      thread (with the tile's first and last), then the bytes, each
//      thread's head (its elements before its first break) adding the run
//      tokens of the run it continues, a closed form. The tile's value
//      (brk, lead, mid, trail) is published at once (a self-validating
//      64-bit record, flagged as the tile's own value or as its inclusive
//      state).
//   4. The bytes from the tile's first break on, built in shared memory
//      past the lead's room: none of them hangs on the run carried into
//      the tile, so they are built while the tiles before finish. A run
//      token where the run's offset is a multiple of 32 (covered from the
//      bitmap: the first clear bit after the element, up to 32, the halo
//      covering the last elements), gap bytes from delta, escape records
//      from the position and one gathered quality byte; a segment start
//      keeps its offset for the length table.
//   5. One look-back: the block's threads read kLookR records each, the
//      kWindow tiles before, until one holds an inclusive state and every
//      newer one its value, and fold them in order (thread 0 alone or warp
//      0 alone when the record is that near); the tile publishes its
//      inclusive state. The tile holding the last kept element writes the
//      total (a record of its own, which the tail waits on). Then the next
//      ticket is drawn and its positions go on their way.
//   6. The lead run's tokens (where the carried run's offset is a multiple
//      of 32) go right in front of the rest, and the tile's bytes are
//      stored with 16-byte stores where a 16-byte line is the tile's alone
//      (funnel-shifted from the stage at any byte phase) and byte stores at
//      the two ends it shares with the tiles either side. Bytes at offsets
//      >= out_size are dropped. Each bin's bytes within the tile go into
//      the length table with one 32-bit atomic a bin a tile
//      (little-endian).
// Once its tickets run out, a block waits for the total and zeroes its
// share of [total, out_size). So the kernel writes every byte of out past
// the table: a call is two device operations, one memset of the status
// words and the 4 B-byte length table (contiguous in one buffer with out)
// and this kernel. When no element is kept, the block holding tile 0
// writes the total: 4 B, or 0 for the N stream.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;              // threads per tile
constexpr int kWarps = kThreads / 32;
constexpr int kPerQual = 16;               // elements a thread: the quality stream's
constexpr int kPerN = 4;                   //   and the N stream's (few tiles, short chains)
constexpr int kHalo = 32;                  // elements past a tile, for covered
constexpr int kMaxBins = 125;              // the quality stream's B < 125
constexpr int kLookR = 2;                  // records a thread reads a round
constexpr int kWindow = kThreads * kLookR; // tiles a look-back round
constexpr int kMinBlocks = 4;              // blocks an SM, the register cap
constexpr int kCounters = 32;              // the ticket's 128-byte line, the total's
constexpr int kTotalWord = 16;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint64_t kValid = 1ULL << 63;    // the total's record
constexpr uint64_t kAgg = 1ULL << 62;      // a tile's record: its own value
constexpr uint64_t kIncl = 2ULL << 62;     //   or its inclusive state
constexpr uint64_t kFlags = 3ULL << 62;
static_assert(kThreads >= kMaxBins && kWarps <= 32,
              "a thread a bin for the table (B < 125), warp 0 the scans");

// A tile of kThreads * kPer grouped elements, kPer consecutive ones a
// thread.
template <int kPer>
struct Tile {
  static constexpr int kTile = kThreads * kPer;
  static constexpr int kWords = kTile / 32;      // adjacent-flag words, + the halo's
  static constexpr int kIn = 4 + kTile + kHalo;  // positions staged a tile
  static constexpr int kInChunks = kIn / 4;      // their 16-byte chunks
  // room for the lead run's tokens, then the rest (5 bytes an escape)
  static constexpr int kLeadMax = ((kTile + 31) / 32 + 1 + 15) / 16 * 16;
  static constexpr int kStage = kLeadMax + 5 * kTile + 16;
  static_assert(kPer % 4 == 0 && 32 % kPer == 0 && 3 * kPer <= 64,
                "a thread's positions are whole 16-byte loads, its flags a part "
                "of one 32-bit word, its kinds one 64-bit word");
  static_assert(kStage < 65536 && kTile < 8192,
                "element offsets within a tile are 16-bit, a tile's lead and "
                "trail fit 13 bits of its record and its bytes 20");
};

// element kinds, 3 bits
constexpr uint32_t kNone = 0, kGap1 = 1, kGap2 = 2, kGap4 = 3, kAdj = 4,
                   kEsc = 5;

__device__ __forceinline__ uint32_t bytes_of(uint32_t kind) {
  // kNone 0, kGap1 1, kGap2 2, kGap4 4, kAdj 0 (its tokens apart), kEsc 5
  return (0x504210u >> (4 * kind)) & 0xFu;
}

__device__ __forceinline__ uint32_t ceil32(uint32_t x) { return (x + 31) >> 5; }

// the run tokens of L adjacent elements entering with r = run mod 32: the
// multiples of 32 in [r, r + L)
__device__ __forceinline__ uint32_t runs(uint32_t r, uint32_t L) {
  return ceil32(r + L) - (r != 0);
}

// a stretch's value; mid wraps as the torch composition's int32 sums do
struct Val {
  bool brk;
  uint32_t lead, mid, trail;
};

__device__ __forceinline__ Val identity() { return {false, 0, 0, 0}; }

// first A, then B
__device__ __forceinline__ Val combine(const Val& A, const Val& B) {
  if (!B.brk) {
    if (!A.brk) return {false, A.lead + B.lead, 0, A.lead + B.lead};
    return {true, A.lead, A.mid, A.trail + B.lead};
  }
  if (!A.brk) return {true, A.lead + B.lead, B.mid, B.trail};
  return {true, A.lead, A.mid + ceil32(A.trail + B.lead) + B.mid, B.trail};
}

// a prefix from element 0: the next element's first byte past the table,
// and the trailing run's length mod 32
struct State {
  uint32_t u, r;
};

// the state after a stretch of value V
__device__ __forceinline__ State apply(const State& S, const Val& V) {
  const uint32_t u = S.u + runs(S.r, V.lead);
  if (V.brk) return {u + V.mid + ceil32(V.trail), V.trail & 31};
  return {u, (S.r + V.lead) & 31};
}

__device__ __forceinline__ Val shfl_down(const Val& v, int d) {
  return {__shfl_down_sync(kFull, static_cast<int>(v.brk), d) != 0,
          __shfl_down_sync(kFull, v.lead, d), __shfl_down_sync(kFull, v.mid, d),
          __shfl_down_sync(kFull, v.trail, d)};
}

// fold in order within a warp, lane 0 the newest: lane 0 ends holding all
__device__ __forceinline__ Val fold_down(Val x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Val o = shfl_down(x, d);
    if (lane + d < 32) x = combine(o, x);
  }
  return x;
}

__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A tile's record, one word: its own value (lead and trail below 2^13,
// mid below 2^20), then its inclusive state.
__device__ __forceinline__ uint64_t agg_word(const Val& v) {
  return kAgg | static_cast<uint64_t>(v.brk) << 46 | static_cast<uint64_t>(v.lead) << 33 |
         static_cast<uint64_t>(v.trail) << 20 | v.mid;
}

__device__ __forceinline__ uint64_t incl_word(const State& s) {
  return kIncl | static_cast<uint64_t>(s.r) << 32 | s.u;
}

__device__ __forceinline__ Val agg_of(uint64_t w) {
  return {((w >> 46) & 1) != 0, static_cast<uint32_t>(w >> 33) & 0x1FFF,
          static_cast<uint32_t>(w) & 0xFFFFF, static_cast<uint32_t>(w >> 20) & 0x1FFF};
}

__device__ __forceinline__ State incl_of(uint64_t w) {
  return {static_cast<uint32_t>(w), static_cast<uint32_t>(w >> 32) & 31};
}

__device__ __forceinline__ unsigned smem_at(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_at(s)), "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The positions of the tile at s into the stage: the 4 before it, the
// tile, the halo; by cp.async inside [0, m), else element by element, 0
// outside.
template <int kPer>
__device__ __forceinline__ void stage_tile(int32_t* dst, const int32_t* g, int32_t m, int32_t s,
                                           int tid) {
  for (int c = tid; c < Tile<kPer>::kInChunks; c += kThreads) {
    const long long i = static_cast<long long>(s) - 4 + 4 * c;
    if (i >= 0 && i + 4 <= m) {
      cp_async16(dst + 4 * c, g + i);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[4 * c + k] = i + k >= 0 && i + k < m ? g[i + k] : 0;
    }
  }
}

// The run token of the adjacent element e: (covered - 1) | 0xC0, covered
// the elements of its run from it on, up to 32, from the adjacent flags
// (the halo's word last).
__device__ __forceinline__ uint8_t run_token(const uint32_t* adj_words, int e) {
  const unsigned long long w =
      (static_cast<unsigned long long>(adj_words[(e >> 5) + 1]) << 32 | adj_words[e >> 5]) >>
      (e & 31);
  const unsigned long long clear = ~w;
  const int covered = clear ? min(32, __ffsll(static_cast<long long>(clear)) - 1) : 32;
  return static_cast<uint8_t>((covered - 1) | 0xC0);
}

struct Params {
  const int32_t* g_pos;
  int32_t m;
  const int32_t* bin_counts;  // null: the N stream
  int nbins;
  const uint8_t* qual;
  long long nq;
  long long esc_cap;
  int32_t limit;              // the N stream: its positions are below it
  uint8_t* out;
  long long out_size;
  int32_t* total;
  uint64_t* status;           // kCounters words, then a record a tile
  int32_t tiles;
};

template <int kPer>
struct Shared {
  using T = Tile<kPer>;
  __align__(16) int32_t in[T::kIn];        // the tile's positions
  __align__(16) uint8_t stage[T::kStage];  // its bytes: the lead's, the rest
  uint16_t local_off[T::kTile + 1];
  long long bin_start[kMaxBins + 2];
  uint32_t seg_words[T::kWords + 1];
  uint32_t adj_words[T::kWords + 1];
  int32_t warp_last[kWarps];   // the warps' last and first breaks, bytes
  int32_t warp_first[kWarps];
  uint32_t warp_bytes[kWarps];
  Val fold[kWarps];
  int near[kWarps];
  State base, prefix;
  long long total;
  int ticket;
};

// The kind of element i (int32 arithmetic that wraps, as torch's does).
// kTable: the quality stream (no bound on the positions); kInStream: i is
// below stream_end (and so below m).
template <bool kTable, bool kInStream>
__device__ __forceinline__ uint32_t classify(int32_t m, int32_t stream_end, int32_t esc_end,
                                             int32_t limit, int32_t i, int32_t v, int32_t prev,
                                             bool seg) {
  if (!kInStream) {
    if (i >= m) return kNone;
    if (i >= stream_end) return i < esc_end ? kEsc : kNone;
  }
  if (!kTable && v >= limit) return kNone;
  const int32_t d = static_cast<int32_t>(
      seg ? static_cast<uint32_t>(v) + 1u : static_cast<uint32_t>(v) - static_cast<uint32_t>(prev));
  if (d == 1 && v > 1) return kAdj;
  return d <= 128 ? kGap1 : d <= (1 << 14) ? kGap2 : kGap4;
}

// A thread's kPer elements from the stage: their kinds (3 bits each),
// adjacent flags, first and last breaks (kPer and -1 for none) and the
// bytes from its first break on (the runs that start in the thread).
struct Kinds {
  uint64_t kinds;
  uint32_t adj, bytes;
  int first, last;
};

template <int kPer, bool kTable, bool kInStream>
__device__ __forceinline__ void classify_thread(const int32_t* in, int e0, int32_t s, int32_t m,
                                                int32_t stream_end, int32_t esc_end,
                                                int32_t limit, uint32_t seg_bits, Kinds& t) {
  int32_t prev = in[3 + e0];
  // a quad of positions at a time (the loop stays rolled: its code is
  // fetched once), its kinds and flags packed by constant shifts
#pragma unroll 1
  for (int q = 0; q < kPer; q += 4) {
    const int4 a = *reinterpret_cast<const int4*>(in + 4 + e0 + q);
    const int32_t v[4] = {a.x, a.y, a.z, a.w};
    const uint32_t sq = seg_bits >> q;
    uint32_t kq = 0, aq = 0;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int k = q + h;
      const uint32_t kind = classify<kTable, kInStream>(m, stream_end, esc_end, limit,
                                                        s + e0 + k, v[h], prev, sq >> h & 1u);
      kq |= kind << (3 * h);
      if (kind == kAdj) {
        aq |= 1u << h;
        t.bytes += t.last >= 0 && ((k - t.last - 1) & 31) == 0;
      } else {
        t.first = min(t.first, k);
        t.last = k;
        t.bytes += bytes_of(kind);
      }
      prev = v[h];
    }
    t.kinds |= static_cast<uint64_t>(kq) << (3 * q);
    t.adj |= aq << q;
  }
}

// Step 4: the state before tile j (j > 0), from the nearest inclusive
// record and the values of the tiles after it. Every thread calls it and
// gets the same state.
template <int kPer>
__device__ State look_back(const uint64_t* recs, int j, Shared<kPer>& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  Val acc = identity();  // the tiles read so far, newer than the window
  for (int hi = j - 1;; hi -= kWindow) {
    // thread t reads tiles hi - (kLookR t + q), q = 0 the newest; before
    // the first tile, the start state reads as an inclusive record
    const int k0 = hi - kLookR * tid;
    uint64_t w[kLookR];
#pragma unroll
    for (int q = 0; q < kLookR; ++q) w[q] = k0 - q >= 0 ? load_relaxed(recs + k0 - q) : kIncl;
    int qi, near;
    for (int round = 0;; ++round) {
      qi = kLookR;
#pragma unroll
      for (int q = kLookR - 1; q >= 0; --q) {
        if ((w[q] & kFlags) == kIncl) qi = q;
      }
      bool ready = true;
#pragma unroll
      for (int q = 0; q < kLookR; ++q) {
        if (q < qi && !(w[q] & kFlags)) ready = false;
      }
      const unsigned has = __ballot_sync(kFull, qi < kLookR);
      if (lane == 0) sh.near[warp] = has ? 32 * warp + __ffs(has) - 1 : kThreads;
      __syncthreads();
      near = kThreads;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) near = min(near, sh.near[v]);
      const bool wait = tid <= near && !ready;
      if (!__syncthreads_or(wait)) break;
      if (wait) {
        if (round) __nanosleep(200);
#pragma unroll
        for (int q = 0; q < kLookR; ++q) {
          if (q < qi && !(w[q] & kFlags)) w[q] = load_relaxed(recs + k0 - q);
        }
      }
    }
    // each thread's values up to the nearest inclusive record, oldest first
    Val x = identity();
    if (tid <= near) {
#pragma unroll
      for (int q = kLookR - 1; q >= 0; --q) {
        if (q < qi) x = combine(x, agg_of(w[q]));
      }
      if (tid == near) {
        uint64_t wi = 0;
#pragma unroll
        for (int q = 0; q < kLookR; ++q) {
          if (q == qi) wi = w[q];
        }
        sh.base = incl_of(wi);
      }
    }
    // folded in order: by thread 0 alone, by warp 0, or across the warps
    if (near == 0) {
      if (tid == 0) sh.prefix = apply(sh.base, combine(x, acc));
      break;
    }
    if (near < 32) {
      if (warp == 0) {
        x = fold_down(x, lane);
        __syncwarp();
        if (lane == 0) sh.prefix = apply(sh.base, combine(x, acc));
      }
      break;
    }
    x = fold_down(x, lane);
    if (lane == 0) sh.fold[warp] = x;
    __syncthreads();
    if (warp == 0) {
      Val f = lane < kWarps ? sh.fold[lane] : identity();
      f = fold_down(f, lane);
      if (lane == 0) {
        acc = combine(f, acc);
        if (near < kThreads) sh.prefix = apply(sh.base, acc);
      }
    }
    if (near < kThreads) break;
  }
  __syncthreads();
  return sh.prefix;
}

// kTable: the quality stream (bin counts, a length table, escapes), its
// tiles of kPerQual elements a thread; else the N stream's, of kPerN.
template <bool kTable>
__global__ void __launch_bounds__(kThreads, kMinBlocks) emit_kernel(Params p) {
  constexpr int kPer = kTable ? kPerQual : kPerN;
  using T = Tile<kPer>;
  constexpr int kTile = T::kTile, kWords = T::kWords, kLeadMax = T::kLeadMax;
  __shared__ Shared<kPer> sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr bool table = kTable;
  const int nb = table ? p.nbins : 0;
  const long long hdr = 4LL * nb;
  const int32_t m = p.m;
  const int32_t limit = table ? INT_MAX : p.limit;  // the quality stream: no bound
  unsigned* ticket = reinterpret_cast<unsigned*>(p.status);
  uint64_t* total_word = p.status + kTotalWord;
  uint64_t* recs = p.status + kCounters;

  // the first ticket, and the bin starts (the grouping's order)
  if (tid == 0) sh.ticket = static_cast<int>(atomicAdd(ticket, 1u));
  if (table && warp == 0) {
    long long c[4], sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = 4 * lane + k;
      c[k] = b <= nb ? p.bin_counts[b] : 0;
      sum += c[k];
    }
    long long incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    long long at = incl - sum;
    if (lane == 0) sh.bin_start[0] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      at += c[k];
      if (4 * lane + k <= nb) sh.bin_start[4 * lane + k + 1] = at;
    }
  }
  if (tid <= kWords) sh.seg_words[tid] = 0;
  __syncthreads();
  // elements before stream_end are the bins', then the escapes' up to
  // esc_end (the kept count); the N stream's are kept below limit
  int32_t stream_end = m, esc_end = m;
  if (table) {
    stream_end = static_cast<int32_t>(min(sh.bin_start[nb], static_cast<long long>(m)));
    esc_end = static_cast<int32_t>(min(sh.bin_start[nb + 1], static_cast<long long>(m)));
  }
  const int kept_tiles = table ? (esc_end + kTile - 1) / kTile : p.tiles;
  int j = sh.ticket;
  if (j < kept_tiles) stage_tile<kPer>(sh.in, p.g_pos, m, j * kTile, tid);
  cp_async_commit();

  const int e0 = kPer * tid;
  while (j < kept_tiles) {
    const int32_t s = j * kTile;
    cp_async_wait_all();
    __syncthreads();
    // 1. a tile of fill leaves (the N stream: its first position is n or
    // more, and so is every one after it)
    if (!table && sh.in[4] >= limit) break;
    const bool last =
        table ? s + kTile >= esc_end : (s + kTile >= m || sh.in[4 + kTile] >= limit);

    // 2. the segment starts in [s, s + kTile + 32), then the kinds
    int my_word = -1;
    if (table && tid >= 1 && tid <= nb) {
      const long long q = sh.bin_start[tid] - s;
      if (q >= 0 && q < kTile + kHalo) {
        atomicOr(&sh.seg_words[q >> 5], 1u << (q & 31));
        my_word = static_cast<int>(q >> 5);
      }
    }
    __syncthreads();
    // kPer bits; element 0 starts the stream's first segment
    const uint32_t seg_bits = sh.seg_words[e0 >> 5] >> (e0 & 31) | (s + e0 == 0);
    Kinds t{0, 0, 0, kPer, -1};
    if (s + e0 + kPer <= stream_end) {
      classify_thread<kPer, kTable, true>(sh.in, e0, s, m, stream_end, esc_end, limit, seg_bits,
                                          t);
    } else {
      classify_thread<kPer, kTable, false>(sh.in, e0, s, m, stream_end, esc_end, limit, seg_bits,
                                           t);
    }
    const uint64_t kinds = t.kinds;
    const uint32_t adj = t.adj;
    const int first = t.first;
    {
      // a word is 32 / kPer threads' flags
      constexpr int kShare = 32 / kPer;
      uint32_t word = adj;
#pragma unroll
      for (int r = 1; r < kShare; ++r) word |= __shfl_down_sync(kFull, adj, r) << (r * kPer);
      if (lane % kShare == 0) sh.adj_words[tid / kShare] = word;
    }
    if (warp == 0) {  // the halo: the 32 elements past the tile
      const int e = kTile + lane;
      const uint32_t kh = classify<kTable, false>(m, stream_end, esc_end, limit, s + e, sh.in[4 + e],
                                          sh.in[3 + e], (sh.seg_words[e >> 5] >> (e & 31)) & 1u);
      const unsigned halo = __ballot_sync(kFull, kh == kAdj);
      if (lane == 0) sh.adj_words[kWords] = halo;
    }

    // 3. within the tile: the last break before each thread (a max scan)
    // and the tile's first and last, then each thread's bytes from its
    // first break on (runs that start in the tile), summed
    int32_t na_before, tile_first = kTile, tile_last = -1;
    {
      int32_t a = t.last >= 0 ? e0 + t.last : -1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t o = __shfl_up_sync(kFull, a, d);
        if (lane >= d) a = max(a, o);
      }
      const int32_t up = __shfl_up_sync(kFull, a, 1);
      const int32_t fw = __reduce_min_sync(kFull, first < kPer ? e0 + first : kTile);
      if (lane == 31) sh.warp_last[warp] = a;
      if (lane == 0) sh.warp_first[warp] = fw;
      __syncthreads();
      na_before = lane ? up : -1;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int32_t wl = sh.warp_last[w];
        if (w < warp) na_before = max(na_before, wl);
        tile_last = max(tile_last, wl);
        tile_first = min(tile_first, sh.warp_first[w]);
      }
    }
    // the thread's head (its elements before its first break) continues
    // the run from the last break before it, if one lies in the tile
    const uint32_t bytes =
        t.bytes + (na_before >= 0 ? runs(static_cast<uint32_t>(e0 - na_before - 1) & 31, first) : 0);
    uint32_t b_before, tile_bytes_local = 0;
    {
      uint32_t b = bytes;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t o = __shfl_up_sync(kFull, b, d);
        if (lane >= d) b += o;
      }
      if (lane == 31) sh.warp_bytes[warp] = b;
      __syncthreads();
      b_before = b - bytes;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t wb = sh.warp_bytes[w];
        if (w < warp) b_before += wb;
        tile_bytes_local += wb;
      }
    }
    // the tile's value, published at once
    Val agg;
    if (tile_last >= 0) {
      const uint32_t trail = kTile - 1 - tile_last;
      agg = {true, static_cast<uint32_t>(tile_first), tile_bytes_local - ceil32(trail), trail};
    } else {
      agg = {false, kTile, 0, kTile};
    }
    if (tid == 0) {
      store_relaxed(recs + j, j == 0 ? incl_word(apply(State{0, 0}, agg)) : agg_word(agg));
    }

    // 4. the bytes from the tile's first break on into the stage, past the
    // lead's room (none of them hangs on the run carried in)
    {
      // a thread in the tile's lead starts at its first break
      const int from = na_before >= 0 ? 0 : first;
      uint32_t o = b_before;
      uint32_t r = na_before >= 0 ? static_cast<uint32_t>(e0 - na_before - 1) & 31 : 0;
      int32_t prev = sh.in[3 + e0];
#pragma unroll 1
      for (int q = 0; q < kPer; q += 4) {
        const int4 a = *reinterpret_cast<const int4*>(sh.in + 4 + e0 + q);
        const int32_t v[4] = {a.x, a.y, a.z, a.w};
        const uint32_t kq = static_cast<uint32_t>(kinds >> (3 * q)) & 0xFFFu;
        const uint32_t sq = seg_bits >> q;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int k = q + h;
          const int32_t pk = prev;
          prev = v[h];
          if (k < from) continue;
          const int e = e0 + k;
          const uint32_t kind = kq >> (3 * h) & 7u;
          uint8_t* b = sh.stage + kLeadMax + o;
          if (kind == kAdj) {
            // a run token where the run's offset is a multiple of 32
            if (r == 0) {
              b[0] = run_token(sh.adj_words, e);
              ++o;
            }
            r = (r + 1) & 31;
            continue;
          }
          r = 0;
          const bool seg = sq >> h & 1u;
          // a bin's edge (a segment start) keeps its offset for the table
          if (seg) sh.local_off[e] = static_cast<uint16_t>(o);
          const uint32_t x = (seg ? static_cast<uint32_t>(v[h]) + 1u
                                  : static_cast<uint32_t>(v[h]) - static_cast<uint32_t>(pk)) - 1u;
          if (kind == kGap1) {
            b[0] = x;
            o += 1;
          } else if (kind == kGap2) {
            b[0] = x >> 8 | 0x80u;
            b[1] = x;
            o += 2;
          } else if (kind == kGap4) {
            b[0] = static_cast<uint32_t>(static_cast<int32_t>(x) >> 24) | 0xE0u;
            b[1] = x >> 16;
            b[2] = x >> 8;
            b[3] = x;
            o += 4;
          } else if (kind == kEsc) {
            // the char only for the first esc_cap escapes, as the torch
            // composition gathers them; no record without escape room
            const int32_t ek = s + e - stream_end;
            const uint32_t pos = p.esc_cap > 0 ? static_cast<uint32_t>(v[h]) : 0u;
            long long qi = v[h] < 0 ? 0 : v[h];
            qi = qi < p.nq ? qi : p.nq - 1;
            b[0] = p.esc_cap > 0 && ek < p.esc_cap ? p.qual[qi] : 0;
            b[1] = pos;
            b[2] = pos >> 8;
            b[3] = pos >> 16;
            b[4] = pos >> 24;
            o += 5;
          }
        }
      }
    }

    // 5. the one look-back; the inclusive state, the total, the next ticket
    const State pre = j > 0 ? look_back<kPer>(recs, j, sh) : State{0, 0};
    const State after = apply(pre, agg);
    if (tid == 0) {
      if (j > 0) store_relaxed(recs + j, incl_word(after));
      if (last) {
        const long long t = hdr + after.u;
        *p.total = static_cast<int32_t>(t);
        store_relaxed(total_word, kValid | static_cast<uint64_t>(t));
      }
      // past the last kept tile every ticket is fill
      sh.ticket = last ? INT_MAX : static_cast<int>(atomicAdd(ticket, 1u));
    }
    // the lead's run tokens, where the carried run's offset is a multiple
    // of 32, right in front of the rest
    const uint32_t nlead = runs(pre.r, tile_first);
    const int base = kLeadMax - static_cast<int>(nlead);
    if (e0 < tile_first) {
#pragma unroll 1
      for (int k = 0; k < kPer; ++k) {
        const int e = e0 + k;
        if (e < tile_first && ((pre.r + e) & 31) == 0) {
          sh.stage[base + runs(pre.r, e)] = run_token(sh.adj_words, e);
        }
      }
    }
    __syncthreads();
    // the next tile's positions on their way while this one's are stored
    const int jn = sh.ticket;
    if (jn < kept_tiles) stage_tile<kPer>(sh.in, p.g_pos, m, jn * kTile, tid);
    cp_async_commit();

    // stored whole: 16-byte lines the tile owns (from the stage at any
    // byte phase, funnel-shifted), bytes at its two ends
    const long long gg0 = hdr + pre.u;  // the tile's first byte in out
    const long long end = min(gg0 + (after.u - pre.u), p.out_size);
    const long long shift = gg0 - base;  // out's byte c is the stage's c - shift
    for (long long c = (gg0 & ~15LL) + 16LL * tid; c < end; c += 16LL * kThreads) {
      if (c >= gg0 && c + 16 <= end) {
        const int src = static_cast<int>(c - shift);
        const uint32_t* w = reinterpret_cast<const uint32_t*>(sh.stage + (src & ~3));
        const uint32_t sh8 = 8 * (src & 3);
        uint4 q;
        q.x = __funnelshift_r(w[0], w[1], sh8);
        q.y = __funnelshift_r(w[1], w[2], sh8);
        q.z = __funnelshift_r(w[2], w[3], sh8);
        q.w = __funnelshift_r(w[3], w[4], sh8);
        *reinterpret_cast<uint4*>(p.out + c) = q;
      } else {
        for (long long x = max(c, gg0); x < min(c + 16, end); ++x) p.out[x] = sh.stage[x - shift];
      }
    }
    // 6. this tile's bytes of each bin into the length table
    if (table && tid < nb) {
      const long long hi_end = min(static_cast<long long>(s) + kTile, static_cast<long long>(m));
      const long long lo = min(max(sh.bin_start[tid], static_cast<long long>(s)), hi_end);
      const long long hi = min(max(sh.bin_start[tid + 1], static_cast<long long>(s)), hi_end);
      // a bin's edge is the tile's start, its end (no bytes past m), or a
      // segment start: a break, past the lead
      const auto off = [&](long long x) -> int32_t {
        return x == s ? 0
                      : static_cast<int32_t>(nlead + (x == hi_end ? tile_bytes_local
                                                                   : sh.local_off[x - s]));
      };
      const int32_t add = off(hi) - off(lo);
      if (add) atomicAdd(reinterpret_cast<unsigned*>(p.out) + tid, static_cast<unsigned>(add));
    }
    if (my_word >= 0) sh.seg_words[my_word] = 0;  // for the next tile
    __syncthreads();
    j = jn;
  }
  cp_async_wait_all();

  // No element kept: the block holding tile 0 writes the total.
  if (j == 0 && tid == 0) {
    *p.total = static_cast<int32_t>(hdr);
    store_relaxed(total_word, kValid | static_cast<uint64_t>(hdr));
  }
  // The block's tickets are done: its share of the zeros past the total,
  // once the last kept tile (drawn before this block's last ticket) wrote it.
  if (tid == 0) {
    uint64_t v = load_relaxed(total_word);
    while (!(v & kValid)) {
      __nanosleep(256);
      v = load_relaxed(total_word);
    }
    sh.total = static_cast<long long>(v & ~kValid);
  }
  __syncthreads();
  const long long lo = sh.total, hi = p.out_size;
  if (lo < hi) {
    const long long a = min((lo + 15) & ~15LL, hi);
    const long long b = max(hi & ~15LL, a);
    if (blockIdx.x == 0 && tid < 16) {
      if (lo + tid < a) p.out[lo + tid] = 0;
      if (b + tid < hi) p.out[b + tid] = 0;
    }
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long c = a / 16 + static_cast<long long>(blockIdx.x) * kThreads + tid; c < b / 16;
         c += stride) {
      reinterpret_cast<uint4*>(p.out)[c] = make_uint4(0, 0, 0, 0);
    }
  }
}

template <int kPer>
long long emit_tiles(long long m) {
  return m > 0 ? (m + Tile<kPer>::kTile - 1) / Tile<kPer>::kTile : 1;
}

// The blocks of one wave of a kernel on the current device (its SMs times
// the blocks an SM holds), asked of the runtime once a device.
template <bool kTable>
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, emit_kernel<kTable>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *blocks = static_cast<long long>(sms) * per_sm;
  if (dev < 64) cached[dev] = *blocks;
  return cudaSuccess;
}

template <bool kTable>
int launch(const Params& p, long long out_size, cudaStream_t s) {
  long long wave = 0;
  const cudaError_t err = wave_blocks<kTable>(&wave);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the tiles, or the tail's zeros at 16 KB a block, no more than a wave
  long long grid = p.tiles > out_size / 16384 + 1 ? p.tiles : out_size / 16384 + 1;
  if (grid > wave) grid = wave;
  emit_kernel<kTable><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Grouped elements per tile of the quality stream (table != 0) or the N
// stream (the card tests place their edge cases by it).
extern "C" long long repaq_emit_tile(int table) {
  return table ? Tile<kPerQual>::kTile : Tile<kPerN>::kTile;
}

// Blocks of the kernel's persistent wave on the current device (the SMs
// times the blocks an SM holds), or minus a cudaError_t.
extern "C" long long repaq_emit_wave(int table) {
  long long blocks = 0;
  const cudaError_t err = table ? wave_blocks<true>(&blocks) : wave_blocks<false>(&blocks);
  return err == cudaSuccess ? blocks : -static_cast<long long>(err);
}

// 64-bit status words in front of out (an even count): the ticket's and
// the total's 128-byte lines, then a record a tile.
extern "C" long long repaq_emit_status_words(long long m, int table) {
  const long long tiles = table ? emit_tiles<kPerQual>(m) : emit_tiles<kPerN>(m);
  return kCounters + tiles + (tiles & 1);
}

// The gap/run stream of the m int32 grouped positions g_pos (16-byte
// aligned) into buf: repaq_emit_status_words(m, table) status words, then out
// (out_size bytes); its byte length into *total (int32). With bin_counts
// (nbins + 1 int32: the grouping's counts of bins 0..nbins-1 and of the
// escapes): the quality stream, a 4 * nbins byte u32le length table
// (out_size must hold it), the bins' tokens and the escape records, whose
// char is read from qual (nq bytes); limit unused. Without: one segment of
// the positions below `limit` (the N stream's n), which must come first in
// g_pos (ascending, the compaction's fill of n or more after them). Bytes
// at offsets >= out_size are dropped; the rest of out is zero. One memset
// on the stream (the status words and the length table), then one launch.
extern "C" int repaq_emit_tokens(const void* g_pos, long long m, const void* bin_counts,
                                 int nbins, const void* qual, long long nq, long long limit,
                                 long long esc_cap, void* buf, long long out_size, void* total,
                                 void* stream) {
  const bool table = bin_counts != nullptr;
  if (m < 1 || m > INT_MAX - 2LL * Tile<kPerQual>::kTile || out_size < 0 ||
      out_size >= (1LL << 30) ||
      nbins < 0 || nbins > kMaxBins - 1 ||
      (table && (out_size < 4LL * nbins || nq <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = table ? emit_tiles<kPerQual>(m) : emit_tiles<kPerN>(m);
  const long long head = 8 * repaq_emit_status_words(m, table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(buf, 0, head + (table ? 4LL * nbins : 0), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint8_t* b = static_cast<uint8_t*>(buf);
  Params p{static_cast<const int32_t*>(g_pos), static_cast<int32_t>(m),
           static_cast<const int32_t*>(bin_counts), nbins, static_cast<const uint8_t*>(qual), nq,
           esc_cap, static_cast<int32_t>(limit < INT_MAX ? limit : INT_MAX), b + head, out_size,
           static_cast<int32_t*>(total), reinterpret_cast<uint64_t*>(b),
           static_cast<int32_t>(tiles)};
  return table ? launch<true>(p, out_size, s) : launch<false>(p, out_size, s);
}
