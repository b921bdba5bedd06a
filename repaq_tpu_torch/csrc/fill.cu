// Run writes for Hopper (sm_90a), in two designs.
//
// 1. fill_runs, a thread an entry: for each entry i with keep[i],
// out[start[i] + j] = value[i] for 0 <= j < count[i], each target kept
// only inside [0, out_n), into an output the caller filled.
//
// Replaces: the dump-slot scatters of the decode. The TPU has no masked
// scatter, so the JAX package (repaq_tpu/ops/device_streams.py:982, :992,
// :1211, :1228, :1257, and repaq_tpu/codec/device_engine.py:845, :982)
// aims every masked write at one spare element past the end (XLA's
// mode="drop"); torch's index_put_ ran the same writes. Here a masked
// entry writes nothing, and a run is written by the thread that holds its
// entry. Its callers: the N deltas and segment marks, the N bases, the
// escapes (which must land last) and the encode's layout writes.
//
// What bounds it on the card: memory. It must read keep for every entry
// (or, without keep, count: 4 bytes unless one count serves all), count
// for the kept ones, start (4 bytes) and the value's bytes (unless one
// value serves all) for the entries that write, and write the run
// elements. Each thread loads kEntriesPerThread entries a block's width
// apart before it writes any, so a warp's loads each cover consecutive
// addresses (start and value only where the count is above 0), then
// writes each kept entry's run element by element. Where two kept
// entries write one target, either value may land.
//
// 2. Sorted runs, output-stationary (fill_sorted_runs, concat_row_spans):
// a new uint8 output, background everywhere but where the runs of sorted
// segments write. fill_sorted_runs: for each segment s and entry i in
// [seg_off[s], seg_off[s + 1]), out[start[i] + j] = seg_value[s] for
// 0 <= j < count[i]; a later segment's byte lands over an earlier one's.
// concat_row_spans: for each row r of a (rows, width) uint8 source,
// out[dest_off[r] + j] = src[r, src_start[r] + j] for 0 <= j < span[r],
// where the source column lies in [0, width); the rows are one segment.
// Targets outside [0, length) are dropped.
//
// Replaces: the decode's quality writes, which the JAX package makes as a
// full fill, a token scatter and a (run_cap, 4, 31) run grid aimed at a
// dump slot (repaq_tpu/ops/device_streams.py:1160-1161, :1197) or a slot
// space rebuild (:1241-1242), and which the port made as torch.full, a
// per-token value gather and fill_runs; and the PE encode's elision, a
// two-operand sort by destination in JAX (repaq_tpu/codec/
// device_engine.py:606-618), one index_put_ into a dump slot in the port.
//
// What bounds it: the output written once, plus start and count of the
// entries inside the segments (the source bytes copied and three int32 a
// row for concat_row_spans): ~26 MB for an SE decode chunk's quality
// writes, ~7.8 us at 3.35 TB/s. The design writes every output byte
// exactly once, with 16-byte stores: a block owns a tile of kRunsTile
// output bytes in shared memory, fills it with the background, writes the
// runs that reach into it (clipped at its edges: a run across two tiles
// is written by both, each its own part), then stores it whole. fill_runs
// instead stores each run byte at a scattered address into an output
// torch.full wrote first.
//
// Finding a tile's entries: a segment is "ordered" where each entry's run
// ends at or before the next one's start (the decode's tokens and the
// elision's rows are, by construction); then its starts and ends both
// rise, and the entries that reach into a tile are the range from the
// first whose run ends past the tile's start up to the first whose run
// ends past its end. A check launch reads every entry of the segments
// once (which leaves them in the L2 for the tile launch) and marks each
// block of kCheckEntries entries that holds an out-of-order pair of one
// segment. For fill_sorted_runs it also writes, in clean blocks, for every
// tile edge k*T the first entry of each segment whose run ends past it
// (table[s][k]: one writer an edge, so no fill first), and a tile reads
// two table words a segment; for concat_row_spans (one segment) two warps
// of a tile find the same two entries by 32-way probes, a few L2 rounds,
// which costs less than the table's writes (-DREPAQ_RUNS_SEARCH=1 makes
// every call search). A segment that touches a marked block (a corrupt
// stream whose int32 positions wrap, for one) is read whole by every
// tile: the same bytes, slowly.
//
// Each round trip to memory costs a tile more than its arithmetic, so a
// tile starts the loads of its table words, offsets and marks at once,
// then stages its entries (up to kStageEntries of start and count) in
// shared memory by cp.async and writes each entry's run from one thread,
// segment by segment. concat_row_spans stages its tile's source rows
// whole (up to kStageBytes of them at a time, by 16-byte cp.async) and
// copies each row's span with a warp, a word a lane, funnel-shifting two
// staged words. Both launches are compiled for 6 blocks of 256 threads
// an SM.
//
// Each launch has a plain C entry; ops/kernels.py binds them with ctypes.
// fill_runs takes a type an entry (repaq_fill_runs_u8, _i32); a null
// count, value or keep pointer means the scalar count_all, value_all, or
// every entry kept. The sorted-run entries take int32 scratch of
// repaq_sorted_runs_scratch_words() words, written before it is read
// within the call (no fill), and are two kernels a call.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEntriesPerThread = 4;
constexpr int kEntriesPerBlock = kThreads * kEntriesPerThread;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fill_runs_kernel(T* __restrict__ out, long long out_n,
                 const int32_t* __restrict__ start,
                 const int32_t* __restrict__ count, int32_t count_all,
                 const T* __restrict__ value, T value_all,
                 const bool* __restrict__ keep, long long n) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kEntriesPerBlock + threadIdx.x;
  int32_t s[kEntriesPerThread], c[kEntriesPerThread];
  T v[kEntriesPerThread];
#pragma unroll
  for (int r = 0; r < kEntriesPerThread; ++r) {
    const long long i = base + r * kThreads;
    const bool live = i < n && (keep == nullptr || keep[i]);
    c[r] = live ? (count ? count[i] : count_all) : 0;
  }
  // start and value only for the entries that write: the decode's masked
  // entries (count 0, the tail of the token cap) cost their count alone
#pragma unroll
  for (int r = 0; r < kEntriesPerThread; ++r) {
    const long long i = base + r * kThreads;
    s[r] = c[r] > 0 ? start[i] : 0;
    v[r] = c[r] > 0 && value ? value[i] : value_all;
  }
#pragma unroll
  for (int r = 0; r < kEntriesPerThread; ++r) {
    if (c[r] <= 0) continue;
    long long lo = s[r];
    long long hi = lo + c[r];
    if (lo < 0) lo = 0;
    if (hi > out_n) hi = out_n;
    for (long long t = lo; t < hi; ++t) out[t] = v[r];
  }
}

template <typename T>
int launch(void* out, long long out_n, const void* start, const void* count,
           int count_all, const void* value, T value_all, const void* keep,
           long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kEntriesPerBlock - 1) / kEntriesPerBlock;
  fill_runs_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(out), out_n, static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(count), count_all,
      static_cast<const T*>(value), value_all,
      static_cast<const bool*>(keep), n);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// sorted runs, output-stationary
// ---------------------------------------------------------------------------

#ifndef REPAQ_RUNS_TILE
#define REPAQ_RUNS_TILE 16384
#endif
#ifndef REPAQ_RUNS_SEARCH
#define REPAQ_RUNS_SEARCH 0
#endif
// timing builds only (tools/profile_fill.py --ablate; the output is not
// whole): 1 returns after a tile's prologue, 2 skips the runs (the rows:
// stages them, copies none)
#ifndef REPAQ_RUNS_CUT
#define REPAQ_RUNS_CUT 0
#endif

constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

constexpr int kRunsThreads = 256;
constexpr int kRunsWarps = kRunsThreads / 32;
constexpr int kRunsTile = REPAQ_RUNS_TILE;  // output bytes a tile
constexpr int kLog2Tile = ilog2(kRunsTile);
constexpr int kCheckPerThread = 8;  // two 16-byte loads of start, of count
constexpr int kCheckEntries = kRunsThreads * kCheckPerThread;
// entries a tile stages in shared memory at once (start and count)
constexpr int kStageEntries = 3072;
// blocks an SM both launches are compiled to fit (40 registers a thread)
constexpr int kRunsBlocksPerSM = 6;
constexpr int kMaxSegments = 256;
constexpr int kScanPerThread = (kMaxSegments + kRunsThreads) / kRunsThreads;
constexpr int kRowTable = 256;  // rows a tile stages at once
constexpr int kStageBytes = 24576;  // their source bytes, at most
static_assert((1 << kLog2Tile) == kRunsTile && kRunsTile >= 1024,
              "a tile is a power of two of at least 1,024 bytes");
static_assert(8 * kStageEntries <= kStageBytes,
              "a rows tile stages its entries where it stages bytes");

__device__ __forceinline__ long long run_end(int32_t s, int32_t c) {
  return static_cast<long long>(s) + (c > 0 ? c : 0);
}

// a[0..cnt) replaced by its inclusive scan under max (kMax) or +, in
// shared memory; every thread of the block calls it, and it ends
// synchronised. cnt <= kMaxSegments + 1.
template <bool kMax>
__device__ void block_scan(int32_t* a, int cnt) {
  for (int d = 1; d < cnt; d <<= 1) {
    int32_t v[kScanPerThread];
#pragma unroll
    for (int r = 0; r < kScanPerThread; ++r) {
      const int i = threadIdx.x + r * kRunsThreads;
      v[r] = i < cnt && i >= d ? (kMax ? max(a[i], a[i - d]) : a[i] + a[i - d])
                               : (i < cnt ? a[i] : 0);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kScanPerThread; ++r) {
      const int i = threadIdx.x + r * kRunsThreads;
      if (i < cnt) a[i] = v[r];
    }
    __syncthreads();
  }
}

// The segment offsets in shared memory, off[0..nseg]: each clamped to
// [0, n], then raised to the largest before it, so the segments are
// disjoint ranges in order. A null seg_off is one segment of every entry.
// Ends synchronised.
__device__ void load_offsets(const int32_t* __restrict__ seg_off, int nseg,
                             long long n, int32_t* off) {
  for (int i = threadIdx.x; i <= nseg; i += kRunsThreads) {
    const long long v = seg_off ? seg_off[i] : (i ? n : 0);
    off[i] = static_cast<int32_t>(v < 0 ? 0 : (v > n ? n : v));
  }
  __syncthreads();
  block_scan<true>(off, nseg + 1);
}

// The largest i in [0, cnt) with a[i] <= x (a nondecreasing), or -1.
__device__ __forceinline__ int last_at_most(const int32_t* a, int cnt,
                                            long long x) {
  int lo = 0, hi = cnt;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

// Where a tile finds its entries' range by a warp's search rather than in
// the check's table: the rows of concat_row_spans (one segment: the search
// is a few L2 rounds, where the table's writes cost the check more;
// tools/profile_fill.py --ablate), and every call with
// -DREPAQ_RUNS_SEARCH=1.
__host__ __device__ constexpr bool runs_search(bool rows) {
  return REPAQ_RUNS_SEARCH || rows;
}

// The last tile edge k (at k * kRunsTile) below a run's end: -1 for an
// end at or before 0, at most tiles.
__device__ __forceinline__ int32_t edge_below(long long end, long long tiles) {
  return end <= 0 ? -1
                  : static_cast<int32_t>(min((end - 1) >> kLog2Tile, tiles));
}

// Launch 1: bad[b] = 1 where check block b holds an entry j whose run
// ends past the start of entry j + 1 of its segment; then, in clean
// blocks, table[s][k] = the first entry of segment s whose run ends past
// k * kRunsTile, for k in [0, tiles] (off[s + 1] where none does): entry j
// writes the edges in [end of j - 1, end of j), the segment's last entry
// also those past its end. A thread takes 8 consecutive entries (two
// 16-byte loads each of start and count) and the one before them, and
// follows the segments forward from its first entry's.
__global__ void __launch_bounds__(kRunsThreads, kRunsBlocksPerSM)
runs_check_kernel(const int32_t* __restrict__ start,
                  const int32_t* __restrict__ count, long long n,
                  const int32_t* __restrict__ seg_off, int nseg,
                  long long tiles, uint8_t* __restrict__ bad,
                  int32_t* __restrict__ table) {
  // table is null where the tiles search (see runs_search)
  __shared__ int32_t off[kMaxSegments + 1];
  load_offsets(seg_off, nseg, n, off);
  const long long b0 = static_cast<long long>(blockIdx.x) * kCheckEntries;
  if (b0 >= off[nseg] || min(b0 + kCheckEntries, n) <= off[0]) {
    if (threadIdx.x == 0) bad[blockIdx.x] = 0;  // past the segments
    return;
  }
  const long long j0 = b0 + threadIdx.x * kCheckPerThread;
  int32_t s[kCheckPerThread + 1], c[kCheckPerThread];
  if (j0 + kCheckPerThread <= n) {
#pragma unroll
    for (int q = 0; q < kCheckPerThread / 4; ++q) {
      const int4 vs = reinterpret_cast<const int4*>(start + j0)[q];
      const int4 vc = reinterpret_cast<const int4*>(count + j0)[q];
      s[4 * q] = vs.x; s[4 * q + 1] = vs.y; s[4 * q + 2] = vs.z;
      s[4 * q + 3] = vs.w;
      c[4 * q] = vc.x; c[4 * q + 1] = vc.y; c[4 * q + 2] = vc.z;
      c[4 * q + 3] = vc.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kCheckPerThread; ++r) {
      s[r] = j0 + r < n ? start[j0 + r] : 0;
      c[r] = j0 + r < n ? count[j0 + r] : 0;
    }
  }
  s[kCheckPerThread] = j0 + kCheckPerThread < n ? start[j0 + kCheckPerThread]
                                                 : 0;
  // the entry before j0, for the edges its end leaves to j0
  const bool has_prev = table && j0 > 0 && j0 <= n;
  const int32_t sp = has_prev ? start[j0 - 1] : 0;
  const int32_t cp = has_prev ? count[j0 - 1] : 0;
  const int seg0 = last_at_most(off, nseg + 1, j0);
  int seg = seg0;
  bool unordered = false;
#pragma unroll
  for (int r = 0; r < kCheckPerThread; ++r) {
    const long long j = j0 + r;
    while (seg < nseg && off[seg + 1] <= j) ++seg;
    if (j < n && seg >= 0 && seg < nseg && j + 1 < off[seg + 1] &&
        run_end(s[r], c[r]) > s[r + 1])
      unordered = true;
  }
  const bool any = __syncthreads_or(unordered);
  if (threadIdx.x == 0) bad[blockIdx.x] = any;
  if (any || !table) return;
  // entry j writes the edges its run's end passes and the entry before
  // it did not: (edge_below(end of j - 1), edge_below(end of j)]
  seg = seg0;
  int32_t kp = has_prev ? edge_below(run_end(sp, cp), tiles) : -1;
#pragma unroll
  for (int r = 0; r < kCheckPerThread; ++r) {
    const long long j = j0 + r;
    while (seg < nseg && off[seg + 1] <= j) ++seg;
    const int32_t kh = edge_below(run_end(s[r], c[r]), tiles);
    if (j < n && seg >= 0 && seg < nseg) {
      int32_t* row = table + seg * (tiles + 1);
      for (int32_t k = j > off[seg] ? kp + 1 : 0; k <= kh; ++k)
        row[k] = static_cast<int32_t>(j);
      if (j == off[seg + 1] - 1)
        for (int32_t k = kh + 1; k <= tiles; ++k) row[k] = off[seg + 1];
    }
    kp = kh;
  }
}

// The first i in [a, z) whose run ends past x, or z, where the ends rise on
// [a, z): a warp's lanes probe 32 points of the range left each round and
// the ballot keeps the gap before the first that holds.
__device__ long long first_end_past(const int32_t* __restrict__ start,
                                    const int32_t* __restrict__ count,
                                    long long a, long long z, long long x) {
  const int lane = threadIdx.x & 31;
  long long lo = a, hi = z;  // the answer is in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + lane * step;
    const bool probe = p < hi;
    const bool holds = probe && run_end(start[p], count[p]) > x;
    const unsigned m = __ballot_sync(0xffffffffu, holds);
    if (m) {
      const int f = __ffs(m) - 1;
      if (f == 0) return lo;
      hi = lo + f * step;
      lo += (f - 1) * step + 1;
    } else {
      const unsigned pm = __ballot_sync(0xffffffffu, probe);
      lo += (31 - __clz(pm)) * step + 1;
    }
  }
  return lo;
}

__device__ __forceinline__ void copy_async(void* smem, const void* gmem,
                                           int bytes) {
#ifdef __CUDA_ARCH__
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(at), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(at), "l"(gmem));
#else
  for (int i = 0; i < bytes; ++i)
    static_cast<uint8_t*>(smem)[i] = static_cast<const uint8_t*>(gmem)[i];
#endif
}

__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// A tile's runs written entry-driven into the tile: the tile's entries of
// every segment (first[s] onward, cum the exclusive scan of their counts)
// copied into shared memory by cp.async, kStageEntries at a time, then
// written a thread an entry, segment by segment with a barrier between, so
// a later segment's byte lands last. kRows: each entry copies its source
// row's bytes, else the segment's value.
template <bool kRows>
__device__ void write_entries(uint8_t* tile, long long t0, long long t1,
                              const int32_t* first, const int32_t* cum,
                              int segs, int32_t* ent_s, int32_t* ent_c,
                              const int32_t* __restrict__ start,
                              const int32_t* __restrict__ count,
                              const uint8_t* __restrict__ seg_value,
                              const uint8_t* __restrict__ src, long long ld,
                              long long width,
                              const int32_t* __restrict__ src_start) {
  const int total = cum[segs];
  for (int base = 0; base < total; base += kStageEntries) {
    const int m = min(kStageEntries, total - base);
    int seg = last_at_most(cum, segs + 1, base + threadIdx.x);
    for (int i = threadIdx.x; i < m; i += kRunsThreads) {
      while (cum[seg + 1] <= base + i) ++seg;
      const int32_t j = first[seg] + (base + i - cum[seg]);
      copy_async(ent_s + i, start + j, 4);
      copy_async(ent_c + i, count + j, 4);
    }
    copy_async_wait();
    __syncthreads();
    const int s0 = last_at_most(cum, segs + 1, base);
    const int s1 = last_at_most(cum, segs + 1, base + m - 1);
    for (int s = s0; s <= s1; ++s) {
      const uint8_t v = kRows ? 0 : seg_value[s];
      const int hi = min(cum[s + 1], base + m) - base;
      for (int i = max(cum[s], base) - base + threadIdx.x; i < hi;
           i += kRunsThreads) {
        const int32_t c = ent_c[i];
        if (c <= 0) continue;
        const int32_t st = ent_s[i];
        long long e0 = max(static_cast<long long>(st), t0);
        long long e1 = min(run_end(st, c), t1);
        if (kRows) {
          const long long j = first[s] + (base + i - cum[s]);
          const long long col = static_cast<long long>(st) - src_start[j];
          e0 = max(e0, col);
          e1 = min(e1, col + width);
          const long long b = j * ld - col;
          for (long long x = e0; x < e1; ++x) tile[x - t0] = src[b + x];
        } else {
          for (long long x = e0; x < e1; ++x) tile[x - t0] = v;
        }
      }
      if (s < s1) __syncthreads();
    }
    __syncthreads();
  }
}

// Source rows [lo, hi) in order copied into the tile, in groups whose
// source bytes (whole rows, first to last) fit the stage: a group's bytes
// staged by 16-byte cp.async (bytes at its ends), its rows' clipped spans
// in a row table, then a warp a row copies the span a word a lane, each
// word two staged words funnel-shifted.
__device__ void copy_rows(uint8_t* tile, uint8_t* stage, long long t0,
                          int tlen, long long lo, long long hi,
                          const int32_t* __restrict__ start,
                          const int32_t* __restrict__ count,
                          const uint8_t* __restrict__ src, long long ld,
                          long long width,
                          const int32_t* __restrict__ src_start,
                          int32_t* row_e0, int32_t* row_e1,
                          long long* row_src) {
  const long long per = min(static_cast<long long>(kRowTable),
                            (kStageBytes - 32 - width) / max(ld, 1LL) + 1);
  const long long mis = static_cast<long long>(
      reinterpret_cast<uintptr_t>(src) & 15);
  const int lane = threadIdx.x & 31;
  for (long long g0 = lo; g0 < hi; g0 += per) {
    const long long g1 = min(g0 + per, hi);
    const int nrows = static_cast<int>(g1 - g0);
    // in byte offsets from src: [o0, o1) staged from ob, 16-aligned
    const long long o0 = g0 * ld;
    const long long o1 = (g1 - 1) * ld + width;
    const long long ob = ((o0 + mis) & ~15LL) - mis;
    const long long v0 = ((o0 + mis + 15) & ~15LL) - mis;
    const long long v1 = ((o1 + mis) & ~15LL) - mis;
    for (long long o = v0 + 16 * threadIdx.x; o < v1; o += 16 * kRunsThreads)
      copy_async(stage + (o - ob), src + o, 16);
    for (long long o = o0 + threadIdx.x; o < min(v0, o1); o += kRunsThreads)
      stage[o - ob] = src[o];
    for (long long o = max(v1, v0) + threadIdx.x; o < o1; o += kRunsThreads)
      stage[o - ob] = src[o];
    for (int i = threadIdx.x; i < nrows; i += kRunsThreads) {
      const long long r = g0 + i;
      const int32_t sr = start[r], cr = count[r];
      const long long col = sr - static_cast<long long>(src_start[r]);
      long long e0 = max(max(static_cast<long long>(sr), col), t0);
      long long e1 = min(min(run_end(sr, cr), col + width), t0 + tlen);
      if (e1 <= e0) e0 = e1 = t0;
      row_e0[i] = static_cast<int32_t>(e0 - t0);
      row_e1[i] = static_cast<int32_t>(e1 - t0);
      row_src[i] = r * ld - ob - col + t0;  // stage index of tile offset 0
    }
    copy_async_wait();
    __syncthreads();
#if REPAQ_RUNS_CUT != 2
    for (int i = threadIdx.x >> 5; i < nrows; i += kRunsWarps) {
      const int e0 = row_e0[i], e1 = row_e1[i];
      const long long sb = row_src[i];
      const int c0 = min((e0 + 3) & ~3, e1), f1 = max(e1 & ~3, c0);
      for (int x = c0 + 4 * lane; x < f1; x += 128) {
        const long long so = sb + x;
        const uint32_t* p = reinterpret_cast<const uint32_t*>(stage +
                                                               (so & ~3LL));
        *reinterpret_cast<uint32_t*>(tile + x) =
            __funnelshift_r(p[0], p[1], static_cast<int>(so & 3) * 8);
      }
      if (lane < c0 - e0)
        tile[e0 + lane] = stage[sb + e0 + lane];
      else if (lane >= 4 && lane - 4 < e1 - f1)
        tile[f1 + lane - 4] = stage[sb + f1 + lane - 4];
    }
#endif
    __syncthreads();
  }
}

// Launch 2: one block a tile of kRunsTile output bytes, built in shared
// memory and stored with 16-byte stores. The block starts the loads of its
// table words, marks and offsets at once (where it searches, its warps
// search after); each segment's entries that reach into the tile are then
// [first, first + count) (a marked segment: all its entries); the tile is
// filled with the background and its runs written: source rows in order
// by copy_rows, anything else by write_entries. kRows: concat_row_spans
// (one segment of source rows).
template <bool kRows>
__global__ void __launch_bounds__(kRunsThreads, kRunsBlocksPerSM)
runs_tile_kernel(uint8_t* __restrict__ out, long long length,
                 int background, const int32_t* __restrict__ start,
                 const int32_t* __restrict__ count, long long n,
                 const int32_t* __restrict__ seg_off,
                 const uint8_t* __restrict__ seg_value, int nseg,
                 const uint8_t* __restrict__ src, long long ld,
                 long long width, const int32_t* __restrict__ src_start,
                 const uint8_t* __restrict__ bad,
                 const int32_t* __restrict__ table, long long tiles) {
  constexpr int kSegs = kRows ? 1 : kMaxSegments;
  constexpr int kRowSlots = kRows ? kRowTable : 1;
  // the tile, then the staged entries (start, count), or, for source
  // rows, the staged source bytes
  constexpr int kPool = kRunsTile + (kRows ? kStageBytes + 16
                                           : 8 * kStageEntries);
  __shared__ __align__(16) uint8_t pool[kPool];
  __shared__ int32_t off[kSegs + 1], first[kSegs], cum[kSegs + 1];
  __shared__ uint8_t flag[kSegs];
  __shared__ int32_t row_e0[kRowSlots], row_e1[kRowSlots];
  __shared__ long long row_src[kRowSlots];
  uint8_t* tile = pool;

  const long long k = blockIdx.x;
  const long long t0 = k * kRunsTile;
  const int tlen = static_cast<int>(min(static_cast<long long>(kRunsTile),
                                        length - t0));
  const int segs = kRows ? 1 : nseg;
  // loaded together: the table words, the marks, the offsets
  constexpr bool kSearch = runs_search(kRows);
  if (!kSearch) {
    for (int s = threadIdx.x; s < segs; s += kRunsThreads) {
      first[s] = table[s * (tiles + 1) + k];
      cum[s + 1] = table[s * (tiles + 1) + k + 1];
    }
  }
  const long long nbad = (n + kCheckEntries - 1) / kCheckEntries;
  int any = 0;
  for (long long b0 = threadIdx.x; b0 < nbad; b0 += 16 * kRunsThreads) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const long long b = b0 + r * kRunsThreads;
      any |= b < nbad ? bad[b] : 0;
    }
  }
  const uint32_t bg4 = 0x01010101u * static_cast<uint8_t>(background);
  for (int i = threadIdx.x; i < kRunsTile / 16; i += kRunsThreads)
    reinterpret_cast<uint4*>(tile)[i] = make_uint4(bg4, bg4, bg4, bg4);
  load_offsets(kRows ? nullptr : seg_off, segs, n, off);
  if (__syncthreads_or(any)) {
    // a segment that touches a marked check block reads all its entries
    for (int s = threadIdx.x; s < segs; s += kRunsThreads) {
      int f = 0;
      if (off[s] < off[s + 1])
        for (long long b = off[s] / kCheckEntries;
             b <= (off[s + 1] - 1) / kCheckEntries; ++b)
          f |= bad[b];
      flag[s] = f;
    }
  } else {
    for (int s = threadIdx.x; s < segs; s += kRunsThreads) flag[s] = 0;
  }
  __syncthreads();
  if (kSearch) {
    for (int s = threadIdx.x >> 5; s < segs; s += kRunsWarps) {
      const int a = off[s], z = off[s + 1];
      long long lo = a, hi = a;
      if (a < z && !flag[s]) {
        lo = first_end_past(start, count, a, z, t0);
        hi = first_end_past(start, count, a, z, t0 + kRunsTile);
      }
      if ((threadIdx.x & 31) == 0) {
        first[s] = static_cast<int32_t>(lo);
        cum[s + 1] = static_cast<int32_t>(hi);
      }
    }
    __syncthreads();
  }
  // each segment's entries that reach into the tile: [first, first + cnt)
  // (the table and the search give the first entry ending past the tile's
  // start and past its end; the latter may start inside it)
  for (int s = threadIdx.x; s < segs; s += kRunsThreads) {
    const int a = off[s], z = off[s + 1];
    long long lo = a, hi = a;
    if (a < z && flag[s]) {
      hi = z;
    } else if (a < z) {
      lo = first[s];
      hi = min(static_cast<long long>(cum[s + 1]) + 1,
               static_cast<long long>(z));
    }
    first[s] = static_cast<int32_t>(lo);
    cum[s + 1] = static_cast<int32_t>(max(hi - lo, 0LL));
  }
  if (threadIdx.x == 0) cum[0] = 0;
  __syncthreads();
  block_scan<false>(cum, segs + 1);
#if REPAQ_RUNS_CUT == 1
  return;
#endif
  if (kRows && !flag[0] && width + 32 <= kStageBytes) {
    copy_rows(tile, pool + kRunsTile, t0, tlen, first[0], first[0] + cum[1],
              start, count, src, ld, width, src_start, row_e0, row_e1,
              row_src);
  } else {
#if REPAQ_RUNS_CUT != 2
    int32_t* ent = reinterpret_cast<int32_t*>(pool + kRunsTile);
    write_entries<kRows>(tile, t0, t0 + tlen, first, cum, segs, ent,
                         ent + kStageEntries, start, count, seg_value, src,
                         ld, width, src_start);
#endif
  }
  __syncthreads();
  uint8_t* dst = out + t0;
  const int full = tlen / 16;
  for (int i = threadIdx.x; i < full; i += kRunsThreads)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(tile)[i];
  for (int i = full * 16 + threadIdx.x; i < tlen; i += kRunsThreads)
    dst[i] = tile[i];
}

long long runs_tiles(long long length) {
  return (length + kRunsTile - 1) / kRunsTile;
}

long long runs_check_blocks(long long n) {
  return (n + kCheckEntries - 1) / kCheckEntries;
}

// scratch: table (nseg x (tiles + 1) int32), then bad (a byte a check
// block)
int launch_runs(bool rows, void* out, long long length, int background,
                const void* start, const void* count, long long n,
                const void* seg_off, const void* seg_value, int nseg,
                const void* src, long long ld, long long width,
                const void* src_start, void* scratch, void* stream) {
  if (length <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = runs_tiles(length);
  int32_t* table = static_cast<int32_t*>(scratch);
  uint8_t* bad = reinterpret_cast<uint8_t*>(table + nseg * (tiles + 1));
  const int32_t* s = static_cast<const int32_t*>(start);
  const int32_t* c = static_cast<const int32_t*>(count);
  const int32_t* so = static_cast<const int32_t*>(seg_off);
  if (n > 0) {
    runs_check_kernel<<<static_cast<unsigned>(runs_check_blocks(n)),
                        kRunsThreads, 0, st>>>(
        s, c, n, so, nseg, tiles, bad, runs_search(rows) ? nullptr : table);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto kernel = rows ? runs_tile_kernel<true> : runs_tile_kernel<false>;
  kernel<<<static_cast<unsigned>(tiles), kRunsThreads, 0, st>>>(
      static_cast<uint8_t*>(out), length, background, s, c, n, so,
      static_cast<const uint8_t*>(seg_value), nseg,
      static_cast<const uint8_t*>(src), ld, width,
      static_cast<const int32_t*>(src_start), bad, table, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repaq_fill_runs_u8(void* out, long long out_n,
                                  const void* start, const void* count,
                                  int count_all, const void* value,
                                  int value_all, const void* keep,
                                  long long n, void* stream) {
  return launch<uint8_t>(out, out_n, start, count, count_all, value,
                         static_cast<uint8_t>(value_all), keep, n, stream);
}

extern "C" int repaq_fill_runs_i32(void* out, long long out_n,
                                   const void* start, const void* count,
                                   int count_all, const void* value,
                                   int value_all, const void* keep,
                                   long long n, void* stream) {
  return launch<int32_t>(out, out_n, start, count, count_all, value,
                         static_cast<int32_t>(value_all), keep, n, stream);
}

extern "C" long long repaq_sorted_runs_tile() { return kRunsTile; }

extern "C" long long repaq_sorted_runs_scratch_words(long long n, int nseg,
                                                     long long length) {
  const long long words = nseg * (runs_tiles(length) + 1) +
                          (runs_check_blocks(n) + 3) / 4;
  return words > 0 ? words : 1;
}

extern "C" int repaq_fill_sorted_runs(void* out, long long length,
                                      int background, const void* start,
                                      const void* count, long long n,
                                      const void* seg_off,
                                      const void* seg_value, int nseg,
                                      void* scratch, void* stream) {
  return launch_runs(false, out, length, background, start, count, n,
                     seg_off, seg_value, nseg, nullptr, 0, 0, nullptr,
                     scratch, stream);
}

extern "C" int repaq_concat_row_spans(void* out, long long length,
                                      int background, const void* src,
                                      long long ld, long long width,
                                      const void* src_start,
                                      const void* span, const void* dest_off,
                                      long long rows, void* scratch,
                                      void* stream) {
  return launch_runs(true, out, length, background, dest_off, span, rows,
                     nullptr, nullptr, 1, src, ld, width, src_start, scratch,
                     stream);
}
