// Coordinate streams for Hopper (sm_90a): the encode's X and Y streams of
// a chunk, both rows written whole by one launch.
//
// Replaces: XLA code of the JAX package, not a Pallas kernel:
// coords_encode2_device, repaq_tpu/ops/device_streams.py:691-787 (the
// classification of both rows, the run-boundary scans `_cummax` and
// `_suffix_min` at :724-731, the counts' cumsum, the (2, B, 3) byte planes
// and the layout sort of `_emit_sort` with its compaction of the multi-byte
// elements). The port ran it as ~90 eager torch operations a chunk, with a
// run-offset scan, a compaction and a layout write among them.
//
// The grammar (reference rfqcodec.cpp:1262-1330). Over a row v[0..B) with
// prev = 1000 before v[0] and diff = v[i] - prev (int32, wrapping), an
// element at i < n_valid is a repeat when diff == 0; any other emits a
// delta (diff - 1) | 0x80 for 0 < diff <= 64, else v >> 8, v & 0xFF for
// v <= 32767, else (v >> 16) | 0xE0, v >> 8, v (arithmetic shifts, each
// byte the low 8 bits). A run of repeats emits 0xC0 | 31 at every 32nd
// repeat and (rem - 1) | 0xC0 at its last one when rem = its length mod 32
// is not 0: ceil(length / 32) bytes. Elements at i >= n_valid emit nothing
// and end a run; a run also ends at B.
//
// What bounds it on the card: memory, in principle: the rows read once
// (8 B bytes) and the output written once (the zero fill of 2 out_cap
// bytes, then the streams over it); for an SE chunk's (2, 98304) rows
// ~0.0004 ms at 3.35 TB/s. In practice a launch and one tile's chain of
// round trips (the loads, the look-back, the stores) set it.
//
// The design: one launch over tiles of kTile elements of a row, kPer
// consecutive ones a thread, the two rows' tiles interleaved in ticket
// order (an atomic counter) so that a tile waits only on tiles that have
// started. A repeat run's bytes hang on its length carried in from the
// tiles before, so a tile's byte offset is known only once that carry is.
// One associative operator carries both: for a segment of elements,
//   brk    whether it holds an element that is not a repeat,
//   lead   the repeats before its first such element (all of them if none),
//   mid    its bytes from that element up to its trailing run,
//   trail  the repeats after its last such element,
// combined as A then B: the runs that close where B's first break meets
// A's trailing run add ceil((A.trail + B.lead) / 32) bytes. Per tile:
//   1. Each thread loads its kPer values and the ones either side of them,
//      classifies its elements and folds them into one value.
//   2. The values are scanned across the warps and the tile, and the
//      tile's value is published at once (self-validating 64-bit words,
//      each with a valid bit), its inclusive value when known.
//   3. One look-back: warp 0 reads the records of the 32 tiles of the row
//      before, each lane one tile's four words in one round trip, until
//      one holds an inclusive value, and folds them in order.
//   4. Each thread then knows the run carried into its first element and
//      the byte offset of its first byte, walks its elements again and
//      stores their bytes; the row's last tile writes the row's length.
// The status words, the lengths and the output lie in one buffer that the
// wrapper zero-fills, so a call is two device operations,
// that fill and this kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // threads per tile
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                  // consecutive elements a thread
constexpr int kTile = kThreads * kPer;   // elements a tile
constexpr int kCounters = 2;             // the ticket, a pad word
constexpr int kRec = 4;                  // words a tile: its value, its inclusive one
constexpr uint64_t kValid = 1ULL << 63;
constexpr uint64_t kBrk = 1ULL << 62;
constexpr uint64_t kLow31 = (1ULL << 31) - 1;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int32_t kFirstPrev = 1000;     // the value before a row's first
static_assert(kPer % 4 == 0, "a thread's values are whole 16-byte loads");

// element kinds
constexpr uint8_t kNone = 0, kRep = 1, kDelta = 2, kAbs2 = 3, kAbs3 = 4;

struct Val {
  bool brk;
  int32_t lead;
  int64_t mid;
  int32_t trail;
};

__device__ __forceinline__ Val identity() { return {false, 0, 0, 0}; }

__device__ __forceinline__ int64_t ceil32(int64_t x) { return (x + 31) >> 5; }

// first A, then B
__device__ __forceinline__ Val combine(const Val& A, const Val& B) {
  if (!B.brk) {
    if (!A.brk) return {false, A.lead + B.lead, 0, A.lead + B.lead};
    return {true, A.lead, A.mid, A.trail + B.lead};
  }
  if (!A.brk) return {true, A.lead + B.lead, B.mid, B.trail};
  return {true, A.lead, A.mid + ceil32(static_cast<int64_t>(A.trail) + B.lead) + B.mid,
          B.trail};
}

// Val through a shuffle: up (delta > 0), down (delta < 0), or from a lane
__device__ __forceinline__ Val shfl_val(const Val& v, int delta) {
  Val o;
  int b;
  if (delta > 0) {
    b = __shfl_up_sync(kFull, static_cast<int>(v.brk), delta);
    o.lead = __shfl_up_sync(kFull, v.lead, delta);
    o.mid = __shfl_up_sync(kFull, v.mid, delta);
    o.trail = __shfl_up_sync(kFull, v.trail, delta);
  } else {
    b = __shfl_down_sync(kFull, static_cast<int>(v.brk), -delta);
    o.lead = __shfl_down_sync(kFull, v.lead, -delta);
    o.mid = __shfl_down_sync(kFull, v.mid, -delta);
    o.trail = __shfl_down_sync(kFull, v.trail, -delta);
  }
  o.brk = b != 0;
  return o;
}

__device__ __forceinline__ Val shfl_from(const Val& v, int src) {
  return {__shfl_sync(kFull, static_cast<int>(v.brk), src) != 0,
          __shfl_sync(kFull, v.lead, src), __shfl_sync(kFull, v.mid, src),
          __shfl_sync(kFull, v.trail, src)};
}

__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A value as two words, each carrying kValid: lead and trail (below 2^31)
// in the first, mid (below 2^62) in the second.
__device__ __forceinline__ void publish(uint64_t* p, const Val& v) {
  store_relaxed(p, kValid | (v.brk ? kBrk : 0) | static_cast<uint64_t>(v.lead) << 31 |
                       static_cast<uint64_t>(v.trail));
  store_relaxed(p + 1, kValid | static_cast<uint64_t>(v.mid));
}

__device__ __forceinline__ Val unpack(uint64_t w0, uint64_t w1) {
  return {(w0 & kBrk) != 0, static_cast<int32_t>((w0 >> 31) & kLow31),
          static_cast<int64_t>(w1 & ~kValid), static_cast<int32_t>(w0 & kLow31)};
}

// The kind of an element from its value and the one before it.
__device__ __forceinline__ uint8_t classify(int32_t v, int32_t prev, bool valid) {
  if (!valid) return kNone;
  const int32_t diff =
      static_cast<int32_t>(static_cast<uint32_t>(v) - static_cast<uint32_t>(prev));
  if (diff == 0) return kRep;
  if (diff > 0 && diff <= 64) return kDelta;
  return v <= 32767 ? kAbs2 : kAbs3;
}

__device__ __forceinline__ uint8_t bytes_of(uint8_t kind) {
  return kind == kDelta ? 1 : kind == kAbs2 ? 2 : kind == kAbs3 ? 3 : 0;
}

struct Params {
  const int32_t* values;  // (2, n) int32, row-major
  long long n;            // elements a row
  long long n_valid;      // in [0, n]
  uint8_t* out;           // (2 * out_cap) bytes, zeroed
  long long out_cap;      // at least 3 n
  int32_t* lens;          // the two rows' byte lengths
  uint64_t* status;       // kCounters, then kRec words a tile
  long long row_tiles;    // tiles a row
};

__global__ void __launch_bounds__(kThreads) coords_kernel(Params p) {
  __shared__ Val warp_vals[kWarps];
  __shared__ Val tile_before;
  __shared__ unsigned ticket;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) ticket = atomicAdd(reinterpret_cast<unsigned*>(p.status), 1u);
  __syncthreads();
  const int row = static_cast<int>(ticket & 1u);
  const long long j = ticket >> 1;  // the tile within its row
  const int32_t* vr = p.values + row * p.n;
  uint64_t* recs = p.status + kCounters + static_cast<long long>(row) * p.row_tiles * kRec;

  // 1. the values: each thread's kPer, the one before and the one after
  const long long i0 = j * kTile + static_cast<long long>(kPer) * tid;
  int32_t v[kPer];
  if (i0 + kPer <= p.n && (reinterpret_cast<uintptr_t>(vr + i0) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int4 a = *reinterpret_cast<const int4*>(vr + i0 + 4 * q);
      v[4 * q] = a.x, v[4 * q + 1] = a.y, v[4 * q + 2] = a.z, v[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = i0 + k < p.n ? vr[i0 + k] : 0;
  }
  const int32_t before = i0 == 0 ? kFirstPrev : i0 - 1 < p.n ? vr[i0 - 1] : 0;
  const long long inext = i0 + kPer;
  // whether the element after the thread's last is a repeat (a run ends
  // at n)
  const bool next_rep =
      inext < p.n && classify(vr[inext], v[kPer - 1], inext < p.n_valid) == kRep;
  uint8_t kind[kPer];
  Val own = identity();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = i0 + k;
    kind[k] = classify(v[k], k ? v[k - 1] : before, i < p.n_valid);
    if (i >= p.n) continue;  // past the row: nothing
    const Val e = kind[k] == kRep ? Val{false, 1, 0, 1} : Val{true, 0, bytes_of(kind[k]), 0};
    own = combine(own, e);
  }

  // 2. across the warp and the tile
  Val incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Val o = shfl_val(incl, d);
    if (lane >= d) incl = combine(o, incl);
  }
  Val lane_before = shfl_val(incl, 1);
  if (lane == 0) lane_before = identity();
  if (lane == 31) warp_vals[warp] = incl;
  __syncthreads();

  // 3. the look-back, by warp 0
  if (warp == 0) {
    Val w = lane < kWarps ? warp_vals[lane] : identity();
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const Val o = shfl_val(w, d);
      if (lane >= d) w = combine(o, w);
    }
    Val wb = shfl_val(w, 1);
    if (lane == 0) wb = identity();
    const Val total = shfl_from(w, kWarps - 1);
    if (lane < kWarps) warp_vals[lane] = wb;
    uint64_t* rec = recs + j * kRec;
    if (lane == 0) publish(j == 0 ? rec + 2 : rec, total);
    Val acc = identity();  // the tiles read so far, newer than the window
    for (long long hi = j - 1; hi >= 0; hi -= 32) {
      // lane l reads tile hi - l; before the row's first tile, the
      // identity reads as an inclusive value
      const long long k = hi - lane;
      const uint64_t* r = recs + (k < 0 ? 0 : k) * kRec;
      uint64_t wd[kRec] = {0, 0, 0, 0};
      bool in = k < 0, ready = k < 0;
      for (;;) {
        if (!ready) {
#pragma unroll
          for (int q = 0; q < kRec; ++q) wd[q] = load_relaxed(r + q);
          in = (wd[2] & wd[3] & kValid) != 0;
          ready = in || (wd[0] & wd[1] & kValid) != 0;
        }
        if (__all_sync(kFull, ready)) break;
      }
      const unsigned incls = __ballot_sync(kFull, in);
      const int nearest = incls ? __ffs(incls) - 1 : 31;
      Val x = identity();
      if (k >= 0 && lane <= nearest) x = in ? unpack(wd[2], wd[3]) : unpack(wd[0], wd[1]);
      // fold in order, lane 0 the newest: lane l ends holding lanes
      // l..nearest
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const Val o = shfl_val(x, -d);
        if (lane + d < 32) x = combine(o, x);
      }
      acc = combine(shfl_from(x, 0), acc);
      if (incls) break;
    }
    if (lane == 0) {
      const Val upto = combine(acc, total);
      if (j > 0) publish(rec + 2, upto);
      tile_before = acc;
      if (j == p.row_tiles - 1) {
        // the row's length: its trailing run closes at n
        p.lens[row] = static_cast<int32_t>(
            upto.brk ? ceil32(upto.lead) + upto.mid + ceil32(upto.trail) : ceil32(upto.lead));
      }
    }
  }
  __syncthreads();

  // 4. the bytes, from the run carried into the thread's first element:
  // its full tokens so far if it goes on, all its bytes if it ended
  // before the thread
  const Val pre = combine(combine(tile_before, warp_vals[warp]), lane_before);
  int64_t run = pre.brk ? pre.trail : pre.lead;
  int64_t off = (pre.brk ? ceil32(pre.lead) + pre.mid : 0) +
                (kind[0] == kRep ? run >> 5 : ceil32(run));
  uint8_t* o = p.out + row * p.out_cap;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const uint32_t x = static_cast<uint32_t>(v[k]);
    switch (kind[k]) {
      case kRep: {
        ++run;
        const bool last = k + 1 < kPer ? kind[k + 1] != kRep : !next_rep;
        if ((run & 31) == 0) {
          o[off++] = 0xC0 | 31;
        } else if (last && i0 + k < p.n) {
          o[off++] = static_cast<uint8_t>(((run & 31) - 1) | 0xC0);
        }
        break;
      }
      case kDelta:
        run = 0;
        o[off++] = static_cast<uint8_t>((x - static_cast<uint32_t>(k ? v[k - 1] : before) - 1u) | 0x80u);
        break;
      case kAbs2:
        run = 0;
        o[off++] = static_cast<uint8_t>(v[k] >> 8);
        o[off++] = static_cast<uint8_t>(x);
        break;
      case kAbs3:
        run = 0;
        o[off++] = static_cast<uint8_t>((v[k] >> 16) | 0xE0);
        o[off++] = static_cast<uint8_t>(v[k] >> 8);
        o[off++] = static_cast<uint8_t>(x);
        break;
      default:
        run = 0;
    }
  }
}

long long row_tiles(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Elements per tile (the card tests place their edge cases by it).
extern "C" long long repaq_coords_tile() { return kTile; }

// 64-bit words of zeroed status the kernel needs for rows of n elements
// (an even count): the ticket counter and a pad word, then four words a
// tile of each row.
extern "C" long long repaq_coords_status_words(long long n) {
  return kCounters + 2 * kRec * row_tiles(n);
}

// The X and Y streams of values (2 rows of n int32, row-major) into out
// (2 * out_cap bytes, zeroed by the caller): row r's bytes at [r out_cap,
// r out_cap + lens[r]), lens two int32. Elements at i >= n_valid emit
// nothing and end a run. status: zeroed words, at least
// repaq_coords_status_words(n), left as the kernel used them (the wrapper
// zeroes them with out, in one buffer).
extern "C" int repaq_coords_emit(const void* values, long long n, long long n_valid, void* out,
                                 long long out_cap, void* lens, void* status, void* stream) {
  if (n < 1 || n >= (1LL << 28) || n_valid < 0 || n_valid > n || out_cap < 3 * n ||
      out_cap >= (1LL << 29)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = row_tiles(n);
  Params p{static_cast<const int32_t*>(values), n, n_valid, static_cast<uint8_t*>(out),
           out_cap, static_cast<int32_t*>(lens), static_cast<uint64_t*>(status), tiles};
  coords_kernel<<<static_cast<unsigned>(2 * tiles), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
