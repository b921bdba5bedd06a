// Gap/run token parse for Hopper (sm_90a): the decode's by-column quality
// stream and its N-position stream turned into runs (start, count), one
// kernel each call. Two entries of one design.
//
// Replaces: XLA code of the JAX package and one Pallas kernel. In
// repaq_tpu/ops/device_streams.py, everything qualcol_decode_device
// (:1010) does before its writes (the length table and forced restarts,
// `_stream_lens_device` :920, the token FSM `token_start_mask_auto` :1081,
// which reaches the Pallas FSM `_fsm_kernel` pallas_tpu.py:175 through
// `token_fsm_pallas` :220, the 4-byte windows :1086-1091, the token
// compaction sort :1094, the token arithmetic :1100-1120, the bin search
// :1125-1133 and the segmented position sum with `lax.cummax` :1134-1140,
// the escape records :1246-1255), and the same chain of
// decode_positions_device (:929, rolls :952-955) up to its positions. The
// port ran it as ~100 eager torch operations a quality call: B3 (the FSM
// kernel), a compaction, a segmented scan, two searchsorted and the
// elementwise passes around them.
//
// The grammar (reference rfqcodec.cpp:957-1047). A token starts where the
// FSM's state (the bytes left in the current token) is 0, or where a
// restart is forced (each bin's stream start); its length is 1 for bytes
// 0xxxxxxx and 110xxxxx, 2 for 10xxxxxx, 4 for 111xxxxx. A token covers
// npos positions (a run 110xxxxx covers (b0 & 0x1F) + 1, any other token
// 1) from its distance dist past the previous token's last position (a gap
// of 1, 2 or 4 bytes: its value + 1; a run: 1), and advances the position
// by adv = dist + npos - 1. The quality stream is a u32le byte length a
// bin (4 B bytes), the bins' streams back to back, then 5-byte escape
// records (char, u32le position) up to the stream's total length; its
// positions restart at -1 at each bin. The N-position stream is one
// segment.
//
// Exactly the torch composition's arithmetic, for every input it takes:
// a bin's tokens are those whose index the composition's binary search
// (torch.searchsorted over the int32 stream starts, sorted or not) puts
// there, a token starts a segment when its bin differs from the token
// before's, and its first position is wrap32(R + dist - 1 - base), with R
// the true (64-bit) sum of the advances before it and base the int32
// running max over the segment starts j <= it of wrap32(R_j), floored at
// 0. While R < 2^31 (always, for a stream the encoder wrote: 124 bins
// under 2^24 positions each) base is the latest start's R; a tile whose
// advances reach 2^31 takes a second look-back for the running max.
// The 4-byte window of a token near the buffer's end wraps to its start,
// as torch.roll does.
//
// What bounds it on the card: memory, in principle. It reads the stream
// bytes once and writes 8 bytes a token slot, the segment offsets and 5
// bytes an escape slot (for an SE chunk's quality call, ~2.5 MB read and
// ~15 MB written, ~5 us at 3.35 TB/s).
//
// The design: one launch over tiles of kTile stream bytes, kPer
// consecutive bytes a thread, tiles in ticket order (an atomic counter), so
// that a tile waits only on tiles that have started. Per tile:
//   1. Each thread loads its kPer bytes (one 16-byte load) and the 3 past
//      them, and walks them from all four entry states at once (the states
//      one to a byte of a word): four start masks and the thread's map of
//      entry to exit state. For each entry state it sums what the tokens
//      add: their count, their advances, whether a segment starts among
//      them and the advances before the last one that does, and whether a
//      segment boundary lies past the last token (the next token starts a
//      segment). Boundaries are the first byte of each bin >= 1 by the
//      binary search, marked in a bitmap of the tile.
//   2. The maps are scanned across the block (byte permutes, as
//      csrc/token_fsm.cu), so each thread knows its entry state as a
//      function of the tile's; the four channels of sums (one a tile
//      entry state) are scanned across the block: as one 64-bit word each
//      (advances above 16 bits of tokens) in a tile without a bin
//      boundary, which is nearly every tile, else with the segmented
//      operator.
//   3. One look-back of the combined operator: a tile publishes, for each
//      of the four entry states, its exit state and its sums (8 64-bit
//      words, each with a valid bit), then its inclusive values (3 words)
//      once known. Warp 0 reads the 32 tiles before, each lane all 11
//      words of one tile in one round trip, until one holds an inclusive
//      record (each tile before is running or done, and publishes one
//      without waiting on a later tile). The maps composed from that
//      record up give each newer tile's entry state; their sums in it,
//      folded in order, give the prefix. The FSM state, the token count
//      and the position sums travel together, so a tile waits on one
//      chain of round trips, not on one a scan.
//   4. Each thread walks its bytes again in its true entry state and
//      writes each token's run into shared memory; the tile's runs are
//      stored whole (coalesced), the first tok_cap tokens; the threads
//      holding a bin boundary write the bin's first token index.
// Escape records are independent of the tokens: every block writes a
// share of them. The status words and every output lie in one buffer that
// the wrapper zero-fills, so a call is two device operations, that fill
// and this kernel.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // threads per tile
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                 // consecutive stream bytes a thread
constexpr int kTile = kThreads * kPer;   // stream bytes a tile
constexpr int kBits = kTile / 32;        // bitmap words a tile
constexpr int kMaxBins = 124;            // the quality stream's B < 125
constexpr int kCounters = 2;             // the ticket, a pad word
constexpr int kRec = 16;                 // status words a tile's record
constexpr uint64_t kValid = 1ULL << 63;
constexpr uint64_t kLow42 = (1ULL << 42) - 1;
constexpr uint32_t kIdentity = 0x03020100u;  // map s -> s
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kMaxAgg = 1, kMaxIncl = 2;  // flags of the max words
static_assert(kPer == 16, "a thread's bytes are one 16-byte load");
static_assert(kThreads >= kMaxBins + 1, "a thread a bin for the table");

// The sums of a run of bytes for one entry state: tokens, advances, a
// segment start among them (has) and the advances before the last one
// (off), a boundary past the last token (pend).
struct Ch {
  uint32_t c;
  uint64_t a;
  uint64_t off;
  bool has;
  bool pend;
};

__device__ __forceinline__ Ch ch_identity() { return {0u, 0ULL, 0ULL, false, false}; }

// first A, then B
__device__ __forceinline__ Ch combine(const Ch& A, const Ch& B) {
  Ch C;
  const bool first = A.pend && B.c > 0;  // B's first token starts a segment
  C.c = A.c + B.c;
  C.a = A.a + B.a;
  C.has = A.has || B.has || first;
  C.off = B.has ? A.a + B.off : (first ? A.a : A.off);
  C.pend = B.c > 0 ? B.pend : (A.pend || B.pend);
  return C;
}

__device__ __forceinline__ uint32_t apply_map(uint32_t map, uint32_t s) {
  return (map >> (8 * s)) & 3u;
}

// first `a`, then `b`: byte s of the result is byte a[s] of b
__device__ __forceinline__ uint32_t compose_map(uint32_t a, uint32_t b) {
  const uint32_t sel = __byte_perm(a | (a >> 4), 0, 0x0020);
  return __byte_perm(b, 0, sel);
}

__device__ __forceinline__ Ch pick(const Ch (&v)[4], uint32_t u) {
  return u == 0 ? v[0] : u == 1 ? v[1] : u == 2 ? v[2] : v[3];
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], uint32_t u) {
  return u == 0 ? v[0] : u == 1 ? v[1] : u == 2 ? v[2] : v[3];
}

// The token that would start at byte k of a thread's words w (16 bytes and
// the 3 past them): its first byte, distance and positions covered.
__device__ __forceinline__ uint32_t token_at(const uint32_t (&w)[5], int k, uint32_t* dist,
                                             uint32_t* npos) {
  const uint32_t win = __funnelshift_r(w[k >> 2], w[(k >> 2) + 1], 8 * (k & 3));
  const uint32_t b0 = win & 0xFF, b1 = (win >> 8) & 0xFF, b2 = (win >> 16) & 0xFF,
                 b3 = win >> 24;
  *npos = b0 >= 0xC0 && b0 < 0xE0 ? (b0 & 0x1F) + 1 : 1;
  *dist = b0 < 0x80 ? b0 + 1
          : b0 < 0xC0 ? (((b0 & 0x3F) << 8) | b1) + 1
          : b0 >= 0xE0 ? (((b0 & 0x1F) << 24) | (b1 << 16) | (b2 << 8) | b3) + 1
                       : 1;
  return b0;
}

// A tile without a segment boundary sums tokens and advances only: one
// 64-bit word, the advances above 16 bits of tokens (a tile's advances are
// below 2^40, its tokens below 2^16).
__device__ __forceinline__ uint64_t pack(const Ch& v) {
  return v.a << 16 | v.c;
}

__device__ __forceinline__ Ch unpack(uint64_t w) {
  return {static_cast<uint32_t>(w & 0xFFFF), w >> 16, 0ULL, false, false};
}

// entry state e's sums from a published function's words
__device__ __forceinline__ Ch agg_ch(const uint64_t (&wd)[11], uint32_t e) {
  const uint64_t a = e == 0 ? wd[0] : e == 1 ? wd[2] : e == 2 ? wd[4] : wd[6];
  const uint64_t o = e == 0 ? wd[1] : e == 1 ? wd[3] : e == 2 ? wd[5] : wd[7];
  return {static_cast<uint32_t>(a >> 42) & 0x1FFFFu, a & kLow42, o & ~kValid,
          ((a >> 59) & 1) != 0, ((a >> 60) & 1) != 0};
}

// Ch through a shuffle: up (delta > 0), down (delta < 0)
__device__ __forceinline__ Ch shfl_ch(const Ch& v, int delta) {
  Ch o;
  const uint32_t flags = (v.has ? 1u : 0u) | (v.pend ? 2u : 0u);
  uint32_t f;
  if (delta > 0) {
    o.c = __shfl_up_sync(kFull, v.c, delta);
    o.a = __shfl_up_sync(kFull, v.a, delta);
    o.off = __shfl_up_sync(kFull, v.off, delta);
    f = __shfl_up_sync(kFull, flags, delta);
  } else {
    o.c = __shfl_down_sync(kFull, v.c, -delta);
    o.a = __shfl_down_sync(kFull, v.a, -delta);
    o.off = __shfl_down_sync(kFull, v.off, -delta);
    f = __shfl_down_sync(kFull, flags, -delta);
  }
  o.has = f & 1u;
  o.pend = f & 2u;
  return o;
}

__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A tile's record: words 0-7 its function of the entry state (two words
// a state: the exit state and the sums), 8-10 its inclusive values. Every
// word carries kValid, so each is read alone.
__device__ void publish_agg(uint64_t* rec, uint32_t map, const Ch (&ch)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Ch& v = ch[e];
    const uint64_t x = apply_map(map, e);
    store_relaxed(rec + 2 * e, kValid | x << 61 | static_cast<uint64_t>(v.pend) << 60 |
                                   static_cast<uint64_t>(v.has) << 59 |
                                   static_cast<uint64_t>(v.c) << 42 | (v.a & kLow42));
    store_relaxed(rec + 2 * e + 1, kValid | v.off);
  }
}

__device__ void publish_incl(uint64_t* rec, uint32_t x, const Ch& v) {
  store_relaxed(rec + 8, kValid | static_cast<uint64_t>(x) << 61 |
                             static_cast<uint64_t>(v.pend) << 60 | v.c);
  store_relaxed(rec + 9, kValid | v.a);
  store_relaxed(rec + 10, kValid | v.off);
}

__device__ __forceinline__ void store_word(int64_t* p, uint32_t flag, int32_t v) {
  store_relaxed(reinterpret_cast<uint64_t*>(p),
                static_cast<uint64_t>(flag) << 32 | static_cast<uint32_t>(v));
}

// The torch.searchsorted(right=True) of v over the nb int32 starts sb, as
// its binary search runs (sorted or not).
__device__ int upper_bound(const int32_t* sb, int nb, int32_t v) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(sb[mid] > v)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct Params {
  const uint8_t* buf;
  long long m;
  int nbins;             // quality: B; positions: -1
  long long limit;       // quality: the stream's total length; positions: valid_len
  long long tok_cap;
  long long esc_cap;
  long long max_tiles;   // status records the buffer holds
  int32_t* start;
  int32_t* count;
  int32_t* seg_off;
  int32_t* esc_pos;
  uint8_t* esc_char;
  uint64_t* status;
};

__device__ __forceinline__ uint32_t byte_at(const uint8_t* buf, long long m, long long i) {
  // the window wraps at m, as torch.roll; indices past m + 3 are never read
  return i < m ? buf[i] : (i - m < m ? buf[i - m] : 0u);
}

// Tile-level state shared by the block
struct Shared {
  int32_t sb[kMaxBins];        // stream starts, int32 as the composition
  int32_t bnd[kMaxBins];       // boundary of bin s (1..B-1): its first byte
  int32_t fpos[kMaxBins];      // forced restarts, clamp(start, 0, m)
  uint32_t force_bits[kBits];
  uint32_t bnd_bits[kBits];
  uint32_t warp_map[kWarps];
  Ch warp_ch[kWarps][4];
  uint64_t warp_sum[kWarps][4];
  Ch tile_ch[4];
  uint32_t tile_map;
  Ch prefix;                   // everything before the tile, true entry
  uint32_t entry;
  int32_t warp_max[kWarps];
  int32_t max_before;
  uint32_t tok_base[kThreads];
  uint16_t tok_mask[kThreads];
  int32_t tok_start[kTile];    // the tile's runs, stored whole after
  uint8_t tok_count[kTile];
  long long ticket;
};

__global__ void __launch_bounds__(kThreads, 2) parse_kernel(Params p) {
  __shared__ Shared sh;
  __shared__ long long lo_s, hi_s, base_s;
  __shared__ int32_t stream_end_s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool table = p.nbins >= 0;
  const int nb = table ? p.nbins : 0;

  // the length table: stream starts, the end, the restarts, the bin
  // boundaries (warp 0 scans the table, then a thread a bin)
  if (warp == 0) {
    int32_t len[4], sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = 4 * lane + k;
      len[k] = 0;
      if (b < nb) {
        const uint8_t* q = p.buf + 4 * b;
        len[k] = static_cast<int32_t>(q[0] | q[1] << 8 | q[2] << 16 |
                                      static_cast<uint32_t>(q[3]) << 24);
      }
      sum = static_cast<int32_t>(static_cast<uint32_t>(sum) + static_cast<uint32_t>(len[k]));
    }
    int32_t incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl = static_cast<int32_t>(static_cast<uint32_t>(incl) + static_cast<uint32_t>(o));
    }
    uint32_t at = static_cast<uint32_t>(incl) - static_cast<uint32_t>(sum);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = 4 * lane + k;
      if (b < nb) sh.sb[b] = static_cast<int32_t>(4u * nb + at);
      at += static_cast<uint32_t>(len[k]);
    }
    const int32_t total = __shfl_sync(kFull, incl, 31);
    if (lane == 0) {
      const long long m = p.m;
      long long lo, hi;
      if (table) {
        const int32_t end = static_cast<int32_t>(4u * nb + static_cast<uint32_t>(total));
        stream_end_s = end;
        lo = 4LL * nb;
        hi = end < lo ? lo : (end > m ? m : end);
        if (lo > m) lo = hi = m;
      } else {
        stream_end_s = 0;
        lo = 0;
        hi = p.limit < 0 ? 0 : (p.limit > m ? m : p.limit);
      }
      lo_s = lo;
      hi_s = hi;
      base_s = lo & ~15LL;
    }
  }
  __syncthreads();
  if (table && tid < nb) {
    const int32_t s = sh.sb[tid];
    sh.fpos[tid] = s < 0 ? 0 : (s > p.m ? static_cast<int32_t>(p.m) : s);
  }
  if (table && tid >= 1 && tid < nb) {
    // a token's bin is the search's answer - 1, clamped; bin tid starts at
    // the first byte whose answer reaches tid + 1 (bisection, monotone in
    // the byte for any table), or never (m)
    bool sorted = true;
    for (int b = 1; b < nb; ++b) sorted = sorted && sh.sb[b - 1] <= sh.sb[b];
    long long at;
    if (sorted) {
      const int32_t s = sh.sb[tid];
      at = s < 0 ? 0 : (s > p.m ? p.m : s);
    } else {
      long long l = 0, h = p.m;
      while (l < h) {
        const long long mid = (l + h) >> 1;
        if (upper_bound(sh.sb, nb, static_cast<int32_t>(mid)) >= tid + 1) {
          h = mid;
        } else {
          l = mid + 1;
        }
      }
      at = l;
    }
    sh.bnd[tid] = static_cast<int32_t>(at);
  }
  __syncthreads();
  const long long lo = lo_s, hi = hi_s, base = base_s;
  const int32_t stream_end = stream_end_s;
  const long long tiles_all = hi > base ? (hi - base + kTile - 1) / kTile : 1;
  const long long tiles = tiles_all < p.max_tiles ? tiles_all : p.max_tiles;

  // escape records, a share each block: rec = stream_end + 5e, kept while
  // rec + 4 < limit; the window at min(rec, m - 5) with the index wrapping
  // below 0 as torch's does, over w32 and its 3 zero words
  if (table) {
    const long long m = p.m;
    for (long long e = blockIdx.x * static_cast<long long>(kThreads) + tid; e < p.esc_cap;
         e += static_cast<long long>(gridDim.x) * kThreads) {
      const int32_t rec = static_cast<int32_t>(static_cast<uint32_t>(stream_end) +
                                               5u * static_cast<uint32_t>(e));
      const int32_t rec4 = static_cast<int32_t>(static_cast<uint32_t>(rec) + 4u);
      int32_t pos = -1;
      uint8_t ch = 0;
      if (rec4 < p.limit) {
        long long r = rec < m - 5 ? rec : m - 5;
        long long w = r < 0 ? r + m + 3 : r;   // into [w32, 0, 0, 0]
        long long r4 = r + 4 < m - 1 ? r + 4 : m - 1;
        if (r4 < 0) r4 += m;
        uint32_t we = 0;
        if (w >= 0 && w < m) {
#pragma unroll
          for (int k = 0; k < 4; ++k) we |= byte_at(p.buf, m, w + k) << (8 * k);
        }
        const uint32_t top = r4 >= 0 && r4 < m ? p.buf[r4] : 0u;
        ch = static_cast<uint8_t>(we);
        pos = static_cast<int32_t>(((we >> 8) & 0xFFFFFFu) | top << 24);
      }
      p.esc_pos[e] = pos;
      p.esc_char[e] = ch;
    }
  }

  uint64_t* records = p.status + kCounters;
  int64_t* max_words = reinterpret_cast<int64_t*>(records + kRec * p.max_tiles);

  for (;;) {
    if (tid == 0) sh.ticket = atomicAdd(reinterpret_cast<unsigned long long*>(p.status), 1ULL);
    for (int w = tid; w < kBits; w += kThreads) sh.force_bits[w] = sh.bnd_bits[w] = 0;
    __syncthreads();
    const long long j = sh.ticket;
    if (j >= tiles) break;
    const long long t0 = base + j * kTile;
    if (table && tid < nb) {
      const long long q = sh.fpos[tid] - t0;
      if (q >= 0 && q < kTile) atomicOr(&sh.force_bits[q >> 5], 1u << (q & 31));
      if (tid >= 1) {
        const long long r = sh.bnd[tid] - t0;
        if (r >= 0 && r < kTile) atomicOr(&sh.bnd_bits[r >> 5], 1u << (r & 31));
      }
    }
    __syncthreads();

    // 1. the thread's bytes, its four walks and their sums
    const long long i0 = t0 + static_cast<long long>(kPer) * tid;
    uint32_t w[5];
    if (i0 + kPer + 3 <= p.m) {
      const uint4 v = *reinterpret_cast<const uint4*>(p.buf + i0);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
      w[4] = p.buf[i0 + 16] | p.buf[i0 + 17] << 8 | p.buf[i0 + 18] << 16;
    } else {
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        w[q] = 0;
        for (int k = 0; k < 4 && 4 * q + k < kPer + 3; ++k) {
          const long long i = i0 + 4 * q + k;
          if (i < p.m + 3) w[q] |= byte_at(p.buf, p.m, i) << (8 * k);
        }
      }
    }
    const uint32_t fbits = (sh.force_bits[tid >> 1] >> (16 * (tid & 1))) & 0xFFFFu;
    const uint32_t bbits = (sh.bnd_bits[tid >> 1] >> (16 * (tid & 1))) & 0xFFFFu;
    uint32_t adv[kPer];   // the advance of a token starting at each byte
    uint32_t sm[4] = {0, 0, 0, 0};
    uint32_t S = kIdentity;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      uint32_t dist, npos;
      const uint32_t b0 = token_at(w, k, &dist, &npos);
      adv[k] = dist + npos - 1;
      const long long i = i0 + k;
      const bool ins = i >= lo && i < hi;
      const uint32_t len1 = ins ? (b0 < 0x80 ? 0 : b0 < 0xC0 ? 1 : b0 < 0xE0 ? 0 : 3) : 0;
      const bool forced = ins && ((fbits >> k) & 1u);
      const uint32_t z = forced ? 0xFFFFFFFFu : __vcmpeq4(S, 0);
      if (ins) {
#pragma unroll
        for (int u = 0; u < 4; ++u) sm[u] |= ((z >> (8 * u)) & 1u) << k;
      }
      S = (z & (len1 * 0x01010101u)) | (~z & __vsub4(S, 0x01010101u));
    }
    Ch own[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t a = 0;   // 16 bytes hold at most 4 gaps of 2^29
#pragma unroll
      for (int k = 0; k < kPer; ++k) a += ((sm[u] >> k) & 1u) ? adv[k] : 0u;
      own[u] = {static_cast<uint32_t>(__popc(sm[u])), a, 0ULL, false, false};
    }
    if (bbits) {   // a bin boundary among the thread's bytes (rare)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        Ch v = ch_identity();
        for (int k = 0; k < kPer; ++k) {
          if ((bbits >> k) & 1u) v.pend = true;
          if ((sm[u] >> k) & 1u) {
            if (v.pend) {
              v.has = true;
              v.off = v.a;
              v.pend = false;
            }
            v.a += adv[k];
            v.c += 1;
          }
        }
        own[u] = v;
      }
    }

    // 2. the maps across the block, then the four channels
    uint32_t mincl = S;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_up_sync(kFull, mincl, d);
      if (lane >= d) mincl = compose_map(o, mincl);
    }
    const uint32_t mup = __shfl_up_sync(kFull, mincl, 1);
    const uint32_t mex = lane ? mup : kIdentity;   // within the warp
    if (lane == 31) sh.warp_map[warp] = mincl;
    // a tile without a boundary (nearly every one) scans packed sums
    const bool tile_bnd = __syncthreads_or(bbits != 0);
    if (warp == 0) {
      uint32_t v = lane < kWarps ? sh.warp_map[lane] : kIdentity;
#pragma unroll
      for (int d = 1; d < kWarps; d <<= 1) {
        const uint32_t o = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v = compose_map(o, v);
      }
      const uint32_t up = __shfl_up_sync(kFull, v, 1);
      if (lane < kWarps) sh.warp_map[lane] = lane ? up : kIdentity;
      if (lane == kWarps - 1) sh.tile_map = v;
    }
    __syncthreads();
    const uint32_t pmap = compose_map(sh.warp_map[warp], mex);  // tile entry -> thread entry
    Ch ex[4];   // per tile entry state: the sums before this thread
    if (!tile_bnd) {
      uint64_t exw[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint64_t incl = pack(pick(own, apply_map(pmap, e)));
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const uint64_t o = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += o;
        }
        const uint64_t up = __shfl_up_sync(kFull, incl, 1);
        exw[e] = lane ? up : 0ULL;
        if (lane == 31) sh.warp_sum[warp][e] = incl;
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint64_t v = lane < kWarps ? sh.warp_sum[lane][e] : 0ULL;
#pragma unroll
          for (int d = 1; d < kWarps; d <<= 1) {
            const uint64_t o = __shfl_up_sync(kFull, v, d);
            if (lane >= d) v += o;
          }
          const uint64_t up = __shfl_up_sync(kFull, v, 1);
          __syncwarp();
          if (lane < kWarps) sh.warp_sum[lane][e] = lane ? up : 0ULL;
          if (lane == kWarps - 1) sh.tile_ch[e] = unpack(v);
        }
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 4; ++e) ex[e] = unpack(sh.warp_sum[warp][e] + exw[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Ch incl = pick(own, apply_map(pmap, e));
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const Ch o = shfl_ch(incl, d);
          if (lane >= d) incl = combine(o, incl);
        }
        const Ch up = shfl_ch(incl, 1);
        ex[e] = lane ? up : ch_identity();
        if (lane == 31) sh.warp_ch[warp][e] = incl;
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Ch v = lane < kWarps ? sh.warp_ch[lane][e] : ch_identity();
#pragma unroll
          for (int d = 1; d < kWarps; d <<= 1) {
            const Ch o = shfl_ch(v, d);
            if (lane >= d) v = combine(o, v);
          }
          const Ch up = shfl_ch(v, 1);
          __syncwarp();
          if (lane < kWarps) sh.warp_ch[lane][e] = lane ? up : ch_identity();
          if (lane == kWarps - 1) sh.tile_ch[e] = v;
        }
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 4; ++e) ex[e] = combine(sh.warp_ch[warp][e], ex[e]);
    }

    // 3. the look-back: everything before the tile, in its true state.
    // Lane l reads the record of tile j - 1 - l, all 11 words at once, and
    // waits until some lane holds an inclusive record (every tile before
    // this one is running or done and publishes one without waiting on a
    // later tile) and every newer lane its function. The maps composed
    // from that record down give each newer tile's entry state; its sums
    // in that state, folded in order, give the prefix.
    uint64_t* rec = records + kRec * j;
    if (warp == 0) {
      Ch pre = {0u, 0ULL, 0ULL, true, false};  // token 0 starts a segment at 0
      uint32_t x = 0;
      if (j > 0) {
        if (lane == 0) publish_agg(rec, sh.tile_map, sh.tile_ch);
        const long long k = j - 1 - lane;
        const uint64_t* r = records + kRec * (k < 0 ? 0 : k);
        uint64_t wd[11];
        bool incl = k < 0, ready = k < 0;
        for (;;) {
          if (!incl) {
#pragma unroll
            for (int q = 0; q < 11; ++q) wd[q] = load_relaxed(r + q);
            uint64_t all = kValid;
#pragma unroll
            for (int q = 0; q < 8; ++q) all &= wd[q];
            incl = (wd[8] & wd[9] & wd[10] & kValid) != 0;
            ready = incl || all != 0;
          }
          const unsigned incls = __ballot_sync(kFull, incl);
          const unsigned readys = __ballot_sync(kFull, ready);
          const unsigned newer = incls ? (2u << (__ffs(incls) - 1)) - 1u : kFull;
          if (incls && (readys & newer) == newer) break;
        }
        const int nearest = __ffs(__ballot_sync(kFull, incl)) - 1;
        uint32_t map = kIdentity;
        Ch v = ch_identity();
        if (lane == nearest) {
          if (k >= 0) {
            x = static_cast<uint32_t>(wd[8] >> 61) & 3u;
            v = {static_cast<uint32_t>(wd[8]), wd[9] & ~kValid, wd[10] & ~kValid, true,
                 ((wd[8] >> 60) & 1) != 0};
          }
          map = x * 0x01010101u;   // before the first tile: state 0, init
          if (k < 0) v = pre;
        } else if (lane < nearest) {
          map = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) map |= (static_cast<uint32_t>(wd[2 * e] >> 61) & 3u) << (8 * e);
        }
        // the state after each lane's tile, composed from the nearest up
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const uint32_t o = __shfl_down_sync(kFull, map, d);
          if (lane + d < 32) map = compose_map(o, map);
        }
        const uint32_t before = __shfl_down_sync(kFull, map, 1);
        if (lane < nearest) v = agg_ch(wd, apply_map(before, 0));
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const Ch o = shfl_ch(v, -d);
          if (lane + d < 32) v = combine(o, v);
        }
        pre = v;
        x = apply_map(map, 0);
      }
      if (lane == 0) {
        publish_incl(rec, apply_map(sh.tile_map, x), combine(pre, pick(sh.tile_ch, x)));
        sh.prefix = pre;
        sh.entry = x;
      }
    }
    __syncthreads();

    // 4. the runs, in the true entry state
    const uint32_t e = sh.entry;
    const uint32_t u = apply_map(pmap, e);
    const uint32_t mask = pick4(sm, u);
    Ch cur = combine(sh.prefix, pick(ex, e));
    const Ch tile_end = combine(sh.prefix, pick(sh.tile_ch, e));
    const uint32_t c0 = sh.prefix.c;   // the tile's first token
    sh.tok_base[tid] = cur.c;
    sh.tok_mask[tid] = static_cast<uint16_t>(mask);
    // every position sum in the tile is below 2^31: each segment's base is
    // its latest start; else the running max of the starts' wrap32 sums
    const bool slow = table && tile_end.a >= (1ULL << 31);
    int32_t run_max = 0;
    if (slow) {
      int32_t tmax = INT_MIN;
      Ch v = cur;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if ((bbits >> k) & 1u) v.pend = true;
        if ((mask >> k) & 1u) {
          if (v.pend) {
            tmax = max(tmax, static_cast<int32_t>(static_cast<uint32_t>(v.a)));
            v.pend = false;
          }
          uint32_t dist, npos;
          token_at(w, k, &dist, &npos);
          v.a += dist + npos - 1;
        }
      }
      int32_t incl = tmax;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t o = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl = max(incl, o);
      }
      const int32_t up = __shfl_up_sync(kFull, incl, 1);
      const int32_t texcl = lane ? up : INT_MIN;
      if (lane == 31) sh.warp_max[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        int32_t v2 = lane < kWarps ? sh.warp_max[lane] : INT_MIN;
        int32_t tot = v2;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) tot = max(tot, __shfl_xor_sync(kFull, tot, d));
#pragma unroll
        for (int d = 1; d < kWarps; d <<= 1) {
          const int32_t o = __shfl_up_sync(kFull, v2, d);
          if (lane >= d) v2 = max(v2, o);
        }
        const int32_t up2 = __shfl_up_sync(kFull, v2, 1);
        __syncwarp();
        if (lane < kWarps) sh.warp_max[lane] = lane ? up2 : INT_MIN;
        // the running max before the tile, by look-back over the max words
        if (lane == 0 && j > 0) store_word(max_words + j, kMaxAgg, tot);
        int32_t acc = INT_MIN;
        for (long long top = j - 1;; top -= 32) {
          const long long k = top - lane;
          uint32_t flag = kMaxIncl;
          int32_t val = 0;   // before the first tile: token 0's start, 0
          const uint64_t* mw = reinterpret_cast<const uint64_t*>(max_words + (k < 0 ? 0 : k));
          uint64_t xw = 0;
          if (k >= 0) {
            xw = load_relaxed(mw);
            flag = static_cast<uint32_t>(xw >> 32);
          }
          while (!__all_sync(kFull, flag != 0)) {
            if (flag == 0) {
              xw = load_relaxed(mw);
              flag = static_cast<uint32_t>(xw >> 32);
            }
          }
          if (k >= 0) val = static_cast<int32_t>(xw);
          const unsigned incls = __ballot_sync(kFull, flag == kMaxIncl);
          const int nearest = incls ? __ffs(incls) - 1 : 31;
          if (lane > nearest) val = INT_MIN;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) val = max(val, __shfl_xor_sync(kFull, val, d));
          acc = max(acc, val);
          if (incls) break;
        }
        if (lane == 0) {
          store_word(max_words + j, kMaxIncl, max(acc, tot));
          sh.max_before = acc;
        }
      }
      __syncthreads();
      run_max = max(sh.max_before, max(sh.warp_max[warp], texcl));
    } else if (table && tid == 0) {
      // every start so far is below 2^31: the running max is the latest
      store_word(max_words + j, kMaxIncl, static_cast<int32_t>(tile_end.off));
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if ((bbits >> k) & 1u) cur.pend = true;
      if ((mask >> k) & 1u) {
        if (cur.pend) {
          cur.off = cur.a;
          cur.pend = false;
          run_max = max(run_max, static_cast<int32_t>(static_cast<uint32_t>(cur.a)));
        }
        const uint32_t base_pos = slow ? static_cast<uint32_t>(max(run_max, 0))
                                       : static_cast<uint32_t>(cur.off);
        uint32_t dist, npos;
        token_at(w, k, &dist, &npos);
        sh.tok_start[cur.c - c0] =
            static_cast<int32_t>(static_cast<uint32_t>(cur.a) + dist - 1u - base_pos);
        sh.tok_count[cur.c - c0] = static_cast<uint8_t>(npos);
        cur.a += dist + npos - 1;
        cur.c += 1;
      }
    }
    __syncthreads();
    // the tile's runs, stored whole (coalesced), the first tok_cap tokens
    {
      const long long n = tile_end.c - c0;
      const long long keep = min(n, p.tok_cap - static_cast<long long>(c0));
      for (long long i = tid; i < keep; i += kThreads) {
        p.start[c0 + i] = sh.tok_start[i];
        p.count[c0 + i] = sh.tok_count[i];
      }
    }
    // the bins' first token indices: bin s starts at the first token at or
    // past its boundary
    if (table && tid >= 1 && tid < nb) {
      const long long q = sh.bnd[tid] - t0;
      long long tok = -1;
      if (q >= 0 && q < kTile) {
        const int t = static_cast<int>(q / kPer), bit = static_cast<int>(q % kPer);
        tok = sh.tok_base[t] + __popc(sh.tok_mask[t] & ((1u << bit) - 1u));
      } else if (q >= kTile && j == tiles - 1) {
        tok = tile_end.c;
      }
      if (tok >= 0) p.seg_off[tid] = static_cast<int32_t>(tok < p.tok_cap ? tok : p.tok_cap);
    }
    if (table && nb > 0 && tid == 0 && j == tiles - 1) {
      const long long tok = tile_end.c;
      p.seg_off[nb] = static_cast<int32_t>(tok < p.tok_cap ? tok : p.tok_cap);
    }
  }
}

long long tiles_for(long long bytes) { return bytes > 0 ? (bytes + kTile - 1) / kTile : 1; }

}  // namespace

// Stream bytes a tile (the card tests place their edge cases by it).
extern "C" long long repaq_parse_tile() { return kTile; }

// Status records the buffer must hold for a call: with the table
// (nbins >= 0), every tile a stream in [4 nbins, m) can need; else the
// valid bytes' tiles.
extern "C" long long repaq_parse_max_tiles(long long m, int nbins, long long limit) {
  if (nbins >= 0) {
    const long long base = (4LL * nbins) & ~15LL;
    return tiles_for(m - base);
  }
  return tiles_for(limit < m ? limit : m);
}

// 64-bit words of zeroed status for max_tiles records: the ticket and a
// pad word, kRec words a record, one max word a record (an even count).
extern "C" long long repaq_parse_status_words(long long max_tiles) {
  return kCounters + (kRec + 1) * max_tiles + (max_tiles & 1);
}

// The runs (start, count) of a gap/run stream in the m bytes of buf
// (16-byte aligned). With nbins >= 0, the quality stream: a 4 nbins byte
// u32le length table, the bins' streams, escape records up to `limit`
// bytes (its total length); seg_off (nbins + 1 int32) gets each bin's
// first token index, esc_pos/esc_char (esc_cap) the escape records'
// positions (-1 where none) and chars. With nbins = -1, the N-position
// stream of `limit` valid bytes. start/count (tok_cap int32) get each
// token's first position and position count, up to tok_cap tokens. Every
// output and the status words (repaq_parse_status_words(max_tiles), max
// tiles from repaq_parse_max_tiles) must be zeroed by the caller; grid:
// blocks to launch (the tiles of the bytes the caller knows of; a stream
// past them is taken by the same blocks in turn).
extern "C" int repaq_parse_tokens(const void* buf, long long m, int nbins, long long limit,
                                  long long tok_cap, long long esc_cap, void* start,
                                  void* count, void* seg_off, void* esc_pos, void* esc_char,
                                  void* status, long long max_tiles, long long grid,
                                  void* stream) {
  if (m < 5 || m >= (1LL << 31) - 2LL * kTile || nbins < -1 || nbins > kMaxBins ||
      4LL * (nbins < 0 ? 0 : nbins) > m || tok_cap < 0 || tok_cap >= (1LL << 31) ||
      esc_cap < 0 || esc_cap >= (1LL << 31) || max_tiles < 1 || grid < 1 ||
      grid > max_tiles || max_tiles != repaq_parse_max_tiles(m, nbins, limit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{static_cast<const uint8_t*>(buf), m, nbins, limit, tok_cap,
           nbins >= 0 ? esc_cap : 0, max_tiles, static_cast<int32_t*>(start),
           static_cast<int32_t*>(count), static_cast<int32_t*>(seg_off),
           static_cast<int32_t*>(esc_pos), static_cast<uint8_t*>(esc_char),
           static_cast<uint64_t*>(status)};
  parse_kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
