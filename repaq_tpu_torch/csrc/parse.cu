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
// ~19 MB written, ~6 us at 3.35 TB/s). In practice a tile's chain of
// dependent steps (its loads, barriers and the look-back's round trips)
// sets the time, so the design cuts steps and keeps loads in flight.
//
// The design: one persistent wave of blocks (the blocks the SMs hold at
// once, capped by the tiles) over tiles of kTile stream bytes, kPer
// consecutive bytes a thread, tiles in ticket order (an atomic counter), so
// that a tile waits only on tiles whose tickets were drawn before. A block
// reads the length table once (the stream starts, the forced restarts and
// the bin boundaries), then loops over tickets: it draws the next one (at
// a tile's start on a grid of at most a block an SM, else once the tile's
// look-back is done), whose bytes are on their way into shared memory
// (16-byte cp.async, two stages) while it writes the tile's runs.
// Per tile:
//   1. Each thread walks its kPer bytes (and the 3 past them) from all four
//      FSM entry states at once (the states one to a byte of a word): four
//      start masks, the thread's map of entry to exit state and each
//      walk's advances. In a warp whose every byte is a 1-byte token (most
//      warps of a real stream) the walks meet at once: walk u starts at
//      byte u, or at the first forced restart, and the sums are byte sums.
//   2. The maps are scanned across the block (byte permutes, as
//      csrc/token_fsm.cu), so each thread knows its entry state as a
//      function of the tile's. In a gap/run stream the four walks meet
//      after a few bytes: from the first thread whose entry state no longer
//      depends on the tile's, every thread has one start mask, one sum and
//      one block-scan channel. Only the threads before it (the head:
//      thread 0 alone in nearly every tile) keep four sums, one an entry
//      state; a tile whose walks never meet (a long chain of 2-byte gap
//      tokens, whose walks stay a byte apart) is all head, and its four
//      channels are scanned one after the other. Sums are tokens and
//      advances, one packed 64-bit word, in a tile without a bin boundary,
//      else the segmented operator (the advances before the last segment
//      start, and whether a boundary lies past the last token).
//   3. One look-back of the combined operator: a tile publishes, for each
//      of the four entry states, its exit state and its sums (8 64-bit
//      words, each with a valid bit), then its inclusive values (3 words)
//      once known. The block's threads read the kThreads tiles before, a
//      thread one tile's 11 words in one round trip, until one holds an
//      inclusive record and every newer one its function (each tile before
//      is running or done, and publishes without waiting on a later tile);
//      a waiting thread reloads only the inclusive words, and backs off.
//      The maps composed from that record up give each newer tile's entry
//      state; their sums in it, folded in order (across the warps only
//      when the record lies past warp 0's 32 tiles), give the prefix. The
//      FSM state, the token count and the position sums travel together,
//      so a tile waits on one chain of round trips, a window of 256 tiles
//      long (a window of 32, read by warp 0 alone, lost in turns on an
//      H100: 0.060 against 0.049 ms at a real SE chunk's call).
//   4. Each thread walks its bytes again in its true entry state (a warp
//      of 1-byte tokens decodes each by its first byte) and writes each
//      token's run into shared memory (a pad word every 32 entries: a
//      thread's tokens lie ~16 apart); the tile's runs are stored whole
//      (coalesced), the first tok_cap tokens; the threads holding a bin
//      boundary write the bin's first token index.
// Every output is written once, by this kernel: the runs by their tiles;
// the token slots at or past the stream's byte count (which no token can
// reach) and the escape records by every block, a share each, once its
// tickets run out; the slots between the last token and the byte count
// once the last tile's inclusive record is out. Only the status words (the
// ticket and the tile records) are cleared before the launch, by one
// memset of their own.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // threads per tile
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                 // consecutive stream bytes a thread
constexpr int kTile = kThreads * kPer;   // stream bytes a tile
constexpr int kStage = kTile + 16;       // a tile's bytes and the 16 past
constexpr int kBits = kTile / 32;        // bitmap words a tile
constexpr int kMaxBins = 124;            // the quality stream's B < 125
constexpr int kMinBlocks = 3;            // blocks an SM, the register cap
constexpr int kCounters = 16;            // the ticket, alone on its 128-byte line
constexpr int kRec = 16;                 // status words a tile's record, a line
constexpr uint64_t kValid = 1ULL << 63;
constexpr uint64_t kLow42 = (1ULL << 42) - 1;
constexpr uint32_t kIdentity = 0x03020100u;  // map s -> s
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kMaxAgg = 1, kMaxIncl = 2;  // flags of the max words
static_assert(kPer == 16, "a thread's bytes are one 16-byte load");
static_assert(kThreads >= kMaxBins + 1, "a thread a bin for the table");
static_assert(kBits <= kThreads, "a thread a bitmap word");

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

// a map that sends every entry state to one exit state
__device__ __forceinline__ bool is_constant(uint32_t map) {
  return map == (map & 0xFFu) * 0x01010101u;
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

// The advance of the token at byte k: its value (big-endian, the length's
// bits cleared) + 1, or a run's positions.
__device__ __forceinline__ uint32_t token_adv(const uint32_t (&w)[5], int k) {
  const uint32_t win = __funnelshift_r(w[k >> 2], w[(k >> 2) + 1], 8 * (k & 3));
  const uint32_t b0 = win & 0xFF, be = __byte_perm(win, 0, 0x0123);
  return (b0 < 0x80 ? b0 : b0 < 0xC0 ? (be >> 16) & 0x3FFFu
                         : b0 < 0xE0 ? b0 & 0x1Fu : be & 0x1FFFFFFFu) + 1;
}

// The FSM from all four entry states at once over a thread's 16 bytes:
// the start mask of each entry state (byte u of lo: its bits of bytes
// 0-7, of hi: of bytes 8-15), the map of entry to exit state, and each
// walk's advances. ins: the bytes inside the stream; fbits: the forced
// restarts among them. Between forced restarts a walk's tokens keep their
// lengths, so with at most 4 restarts at most 7 4-byte gaps of 2^29 start
// in its 16 bytes: the sums fit 32 bits (own_sum takes the rest).
struct Walk {
  uint32_t lo, hi, map;
  uint32_t a[4];
  bool one_byte;   // the warp's every byte a 1-byte token, in the stream
};

// The bytes of w that are 1-byte tokens (0xxxxxxx, 110xxxxx), a bit each.
__device__ __forceinline__ uint32_t one_byte_tokens(const uint32_t (&w)[5]) {
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t ge80 = __vcmpgeu4(w[q], 0x80808080u), geC0 = __vcmpgeu4(w[q], 0xC0C0C0C0u),
                   geE0 = __vcmpgeu4(w[q], 0xE0E0E0E0u);
    const uint32_t one = ~((ge80 & ~geC0) | geE0);
    bits |= ((one & 1u) | (one >> 7 & 2u) | (one >> 14 & 4u) | (one >> 21 & 8u)) << (4 * q);
  }
  return bits;
}

// A 1-byte token's advance less one: the gap's value, or the run's
// positions less one; of the four bytes of a word at once.
__device__ __forceinline__ uint32_t one_byte_adv4(uint32_t x) {
  const uint32_t run = __vcmpgeu4(x, 0xC0C0C0C0u);
  return (x & ~run) | (x & run & 0x1F1F1F1Fu);
}

__device__ __forceinline__ Walk walk4(const uint32_t (&w)[5], uint32_t ins, uint32_t fbits) {
  Walk wk = {0u, 0u, kIdentity, {0u, 0u, 0u, 0u}, false};
  if (__all_sync(kFull, ins == 0xFFFFu && one_byte_tokens(w) == 0xFFFFu)) {
    // every byte of the warp a token (most warps of a real stream): walk
    // u starts its tokens at byte h = min(u, the first forced restart),
    // after the bytes left of the token before, and ends in state 0
    const uint32_t f = fbits ? __ffs(fbits) - 1 : kPer;
    uint32_t total = kPer;
#pragma unroll
    for (int q = 0; q < 4; ++q) total = __dp4a(one_byte_adv4(w[q]), 0x01010101u, total);
    const uint32_t a0 = one_byte_adv4(w[0]);
    wk.a[0] = total;
#pragma unroll
    for (int u = 1; u < 4; ++u) {
      wk.a[u] = wk.a[u - 1] - (u - 1 < f ? (a0 >> (8 * (u - 1)) & 0xFFu) + 1u : 0u);
      const uint32_t h = u < f ? u : f;
      wk.lo |= (0xFFu << h & 0xFFu) << (8 * u);
    }
    wk.lo |= 0xFFu;
    wk.hi = 0xFFFFFFFFu;
    wk.map = 0u;
    wk.one_byte = true;
    return wk;
  }
  uint32_t S = kIdentity;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const uint32_t b0 = (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
    const bool in = (ins >> k) & 1u;
    const uint32_t len1 = in ? (b0 < 0x80 ? 0 : b0 < 0xC0 ? 1 : b0 < 0xE0 ? 0 : 3) : 0;
    const bool forced = in && ((fbits >> k) & 1u);
    const uint32_t z = in ? (forced ? 0xFFFFFFFFu : __vcmpeq4(S, 0)) : 0u;
    const uint32_t adv = token_adv(w, k);
    if (k < 8) {
      wk.lo |= (z & 0x01010101u) << k;
    } else {
      wk.hi |= (z & 0x01010101u) << (k - 8);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) wk.a[u] += (z >> (8 * u)) & 1u ? adv : 0u;
    const uint32_t zs = in ? z : __vcmpeq4(S, 0);
    S = (zs & (len1 * 0x01010101u)) | (~zs & __vsub4(S, 0x01010101u));
  }
  wk.map = S;
  return wk;
}

__device__ __forceinline__ uint32_t mask_of(const Walk& wk, uint32_t u) {
  return __byte_perm(wk.lo, wk.hi, u | (u + 4) << 4) & 0xFFFFu;
}

// The sums of the tokens that start at the bytes of mask (bbits: the bin
// boundaries among the thread's bytes).
__device__ __forceinline__ Ch sum_of(const uint32_t (&w)[5], uint32_t mask, uint32_t bbits) {
  Ch v = ch_identity();
  if (!bbits) {
    uint64_t a = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) a += ((mask >> k) & 1u) ? token_adv(w, k) : 0u;
    v.c = __popc(mask);
    v.a = a;
    return v;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {   // a bin boundary among the bytes (rare)
    if ((bbits >> k) & 1u) v.pend = true;
    if ((mask >> k) & 1u) {
      if (v.pend) {
        v.has = true;
        v.off = v.a;
        v.pend = false;
      }
      v.a += token_adv(w, k);
      v.c += 1;
    }
  }
  return v;
}

// A walk's sums in entry state u: from the walk, or (a bin boundary or
// more than 4 forced restarts among the bytes) by sum_of.
__device__ __forceinline__ Ch own_sum(const Walk& wk, const uint32_t (&w)[5], uint32_t u,
                                      uint32_t fbits, uint32_t bbits) {
  const uint32_t mask = mask_of(wk, u);
  if (bbits || __popc(fbits) > 4) return sum_of(w, mask, bbits);
  const uint32_t a = u == 0 ? wk.a[0] : u == 1 ? wk.a[1] : u == 2 ? wk.a[2] : wk.a[3];
  return {static_cast<uint32_t>(__popc(mask)), a, 0ULL, false, false};
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

// an entry state's sums from its two words of a published function
__device__ __forceinline__ Ch agg_ch(uint64_t a, uint64_t o) {
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

// Exclusive scans across the warp and the block, in thread order; the
// block's run two barriers and leaves its total in scratch[kWarps].
__device__ __forceinline__ Ch warp_excl_ch(Ch v, int lane, Ch* incl_out) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Ch o = shfl_ch(v, d);
    if (lane >= d) v = combine(o, v);
  }
  *incl_out = v;
  const Ch up = shfl_ch(v, 1);
  return lane ? up : ch_identity();
}

__device__ Ch block_excl_ch(const Ch& v, Ch* scratch, int lane, int warp) {
  Ch incl;
  const Ch ex = warp_excl_ch(v, lane, &incl);
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    Ch t;
    const Ch up = warp_excl_ch(lane < kWarps ? scratch[lane] : ch_identity(), lane, &t);
    __syncwarp();
    if (lane < kWarps) scratch[lane] = up;
    if (lane == kWarps - 1) scratch[kWarps] = t;
  }
  __syncthreads();
  return combine(scratch[warp], ex);
}

__device__ uint64_t block_excl_u64(uint64_t v, uint64_t* scratch, int lane, int warp) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += o;
  }
  const uint64_t up = __shfl_up_sync(kFull, v, 1);
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint64_t t = lane < kWarps ? scratch[lane] : 0ULL;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const uint64_t o = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t += o;
    }
    const uint64_t tup = __shfl_up_sync(kFull, t, 1);
    __syncwarp();
    if (lane < kWarps) scratch[lane] = lane ? tup : 0ULL;
    if (lane == kWarps - 1) scratch[kWarps] = t;
  }
  __syncthreads();
  return scratch[warp] + (lane ? up : 0ULL);
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
  bool early_draw;       // at most a block an SM: the next ticket drawn at a tile's start
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

// The bytes of the tile at t0 and the 16 past it into a stage: by cp.async
// inside the buffer, else (the buffer's last tile) byte by byte, wrapping
// at m as torch.roll's windows do, zero past m + 3.
__device__ __forceinline__ void stage_tile(uint8_t* s, const uint8_t* buf, long long m,
                                           long long t0, int tid) {
  if (t0 + kStage <= m) {
    cp_async16(s + kPer * tid, buf + t0 + kPer * tid);
    if (tid == 0) cp_async16(s + kTile, buf + t0 + kTile);
    return;
  }
  for (int q = tid; q < kStage; q += kThreads) {
    const long long i = t0 + q;
    s[q] = static_cast<uint8_t>(i < m + 3 ? byte_at(buf, m, i) : 0u);
  }
}

// Each token's run from a thread's bytes in its true entry state (mask),
// into the tile's staging (a pad word each 32 entries): its first
// position past the segment's base (the latest start, or the running max
// of the starts past 2^31) and its count. kOneByte: every byte a 1-byte
// token, decoded from its first byte alone.
template <bool kOneByte>
__device__ __forceinline__ void stage_runs(const uint32_t (&w)[5], uint32_t mask, uint32_t bbits,
                                           bool slow, int32_t run_max, Ch& cur, uint32_t c0,
                                           int32_t* tok_start, uint8_t* tok_count) {
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
      if (kOneByte) {
        const uint32_t b0 = (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
        dist = b0 < 0x80 ? b0 + 1 : 1;
        npos = b0 < 0x80 ? 1 : (b0 & 0x1F) + 1;
      } else {
        token_at(w, k, &dist, &npos);
      }
      const uint32_t q = cur.c - c0;
      tok_start[q + (q >> 5)] =
          static_cast<int32_t>(static_cast<uint32_t>(cur.a) + dist - 1u - base_pos);
      tok_count[q + (q >> 5)] = static_cast<uint8_t>(npos);
      cur.a += dist + npos - 1;
      cur.c += 1;
    }
  }
}

// Block-level state
struct Shared {
  uint8_t stage[2][kStage];    // this tile's bytes and the next one's
  int32_t sb[kMaxBins];        // stream starts, int32 as the composition
  int32_t bnd[kMaxBins];       // boundary of bin s (1..B-1): its first byte
  int32_t fpos[kMaxBins];      // forced restarts, clamp(start, 0, m)
  uint32_t force_bits[kBits];
  uint32_t bnd_bits[kBits];
  uint32_t warp_map[kWarps];
  uint32_t lb_map[kWarps];     // the look-back: each warp's composed maps
  int lb_near[kWarps];         // and its nearest inclusive record
  Ch lb_ch[kWarps];            // and its folded sums
  Ch scan_ch[kWarps + 1];
  uint64_t scan_u64[kWarps + 1];
  Ch vt[kThreads];             // each thread's rest before it, over the look-back
  Ch head[4];                  // the head's sums, a tile entry state each
  Ch vtot;                     // the rest of the tile, one channel
  uint32_t tile_map;
  Ch prefix;                   // everything before the tile, true entry
  uint32_t entry;
  int32_t warp_max[kWarps];
  int32_t max_before;
  uint32_t tok_base[kThreads];
  uint16_t tok_mask[kThreads];
  // the tile's runs, a pad word each 32 entries; during the look-back,
  // each thread's record of the window (8 words, by column)
  __align__(16) int32_t tok_start[kTile + kTile / 32];
  uint8_t tok_count[kTile + kTile / 32];   // each 32 (banks), stored whole
  long long ticket;
  long long lo, hi, base;
  int32_t stream_end;
};

__global__ void __launch_bounds__(kThreads, kMinBlocks) parse_kernel(Params p) {
  __shared__ __align__(16) Shared sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool table = p.nbins >= 0;
  const int nb = table ? p.nbins : 0;

  // the length table, once a block: stream starts, the end, the restarts,
  // the bin boundaries (warp 0 scans the table, then a thread a bin)
  unsigned long long* ticket = reinterpret_cast<unsigned long long*>(p.status);
  if (tid == 0) sh.ticket = static_cast<long long>(atomicAdd(ticket, 1ULL));
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
        sh.stream_end = end;
        lo = 4LL * nb;
        hi = end < lo ? lo : (end > m ? m : end);
        if (lo > m) lo = hi = m;
      } else {
        sh.stream_end = 0;
        lo = 0;
        hi = p.limit < 0 ? 0 : (p.limit > m ? m : p.limit);
      }
      sh.lo = lo;
      sh.hi = hi;
      sh.base = lo & ~15LL;
    }
  }
  if (tid < kBits) sh.force_bits[tid] = sh.bnd_bits[tid] = 0;
  __syncthreads();
  // stream offsets, tiles and tickets fit 32 bits (m < 2^31 - 2 kTile)
  const int lo = static_cast<int>(sh.lo), hi = static_cast<int>(sh.hi),
            base = static_cast<int>(sh.base);
  const int32_t stream_end = sh.stream_end;
  const int tiles_all = hi > base ? (hi - base + kTile - 1) / kTile : 1;
  const int tiles = tiles_all < p.max_tiles ? tiles_all : static_cast<int>(p.max_tiles);
  int jn = static_cast<int>(sh.ticket);   // the first ticket: its bytes on their way
  if (jn < tiles) stage_tile(sh.stage[0], p.buf, p.m, base + jn * kTile, tid);
  cp_async_commit();
  if (table && tid < nb) {
    const int32_t s = sh.sb[tid];
    sh.fpos[tid] = s < 0 ? 0 : (s > p.m ? static_cast<int32_t>(p.m) : s);
  }
  const bool sorted = __syncthreads_and(!table || tid < 1 || tid >= nb ||
                                        sh.sb[tid - 1] <= sh.sb[tid]);
  if (table && tid >= 1 && tid < nb) {
    // a token's bin is the search's answer - 1, clamped; bin tid starts at
    // the first byte whose answer reaches tid + 1 (bisection, monotone in
    // the byte for any table), or never (m)
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

  uint64_t* records = p.status + kCounters;
  int64_t* max_words = reinterpret_cast<int64_t*>(records + kRec * p.max_tiles);
  int cur = 0;

  for (;;) {
    const int j = jn;
    if (j >= tiles) break;
    const int t0 = base + j * kTile;
    unsigned long long next = 0;
    if (p.early_draw && tid == 0) next = atomicAdd(ticket, 1ULL);
    if (table && tid < nb) {
      const int q = sh.fpos[tid] - t0;
      if (q >= 0 && q < kTile) atomicOr(&sh.force_bits[q >> 5], 1u << (q & 31));
      if (tid >= 1) {
        const int r = sh.bnd[tid] - t0;
        if (r >= 0 && r < kTile) atomicOr(&sh.bnd_bits[r >> 5], 1u << (r & 31));
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // 1. the thread's bytes and its four walks
    const int i0 = t0 + kPer * tid;
    const uint8_t* stage = sh.stage[cur];
    uint32_t w[5];
    {
      const uint4 v = *reinterpret_cast<const uint4*>(stage + kPer * tid);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
      w[4] = *reinterpret_cast<const uint32_t*>(stage + kPer * tid + kPer);
    }
    const uint32_t fbits = (sh.force_bits[tid >> 1] >> (16 * (tid & 1))) & 0xFFFFu;
    const uint32_t bbits = (sh.bnd_bits[tid >> 1] >> (16 * (tid & 1))) & 0xFFFFu;
    uint32_t ins;
    {
      const int a = lo - i0, b = hi - i0;
      const int kl = a <= 0 ? 0 : (a >= kPer ? kPer : static_cast<int>(a));
      const int kh = b <= 0 ? 0 : (b >= kPer ? kPer : static_cast<int>(b));
      ins = kh > kl ? ((1u << kh) - 1u) & ~((1u << kl) - 1u) : 0u;
    }
    const Walk wk = walk4(w, ins, fbits);

    // 2. the maps across the block: each thread's entry state as a function
    // of the tile's
    uint32_t mincl = wk.map;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t o = __shfl_up_sync(kFull, mincl, d);
      if (lane >= d) mincl = compose_map(o, mincl);
    }
    const uint32_t mup = __shfl_up_sync(kFull, mincl, 1);
    const uint32_t mex = lane ? mup : kIdentity;   // within the warp
    if (lane == 31) sh.warp_map[warp] = mincl;
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
    if (tid < kBits) sh.force_bits[tid] = sh.bnd_bits[tid] = 0;   // read above
    const uint32_t pmap = compose_map(sh.warp_map[warp], mex);  // tile entry -> thread entry
    // the head: the threads whose entry state still depends on the tile's
    // (a prefix of the block: once constant, a composed map stays so)
    const bool resolved = is_constant(pmap);
    const int heads = __syncthreads_count(!resolved);

    // the rest in one channel: each thread past the head in its one state
    {
      const Ch v = resolved ? own_sum(wk, w, pmap & 3u, fbits, bbits) : ch_identity();
      if (!tile_bnd) {
        sh.vt[tid] = unpack(block_excl_u64(pack(v), sh.scan_u64, lane, warp));
        if (tid == 0) sh.vtot = unpack(sh.scan_u64[kWarps]);
      } else {
        sh.vt[tid] = block_excl_ch(v, sh.scan_ch, lane, warp);
        if (tid == 0) sh.vtot = sh.scan_ch[kWarps];
      }
    }
    // the head's four channels, one a tile entry state: thread 0 alone in
    // nearly every tile; within warp 0 by its shuffles; else by the block
    if (heads == 1) {
      if (tid == 0) {
#pragma unroll 1
        for (int e = 0; e < 4; ++e) sh.head[e] = own_sum(wk, w, e, fbits, bbits);
      }
    } else if (heads <= 32) {
      if (warp == 0) {
#pragma unroll 1
        for (int e = 0; e < 4; ++e) {
          const Ch v = lane < heads ? own_sum(wk, w, apply_map(pmap, e), fbits, bbits)
                                    : ch_identity();
          Ch incl;
          warp_excl_ch(v, lane, &incl);
          if (lane == 31) sh.head[e] = incl;
        }
      }
    } else {
#pragma unroll 1
      for (int e = 0; e < 4; ++e) {
        const Ch v = tid < heads ? own_sum(wk, w, apply_map(pmap, e), fbits, bbits)
                                 : ch_identity();
        block_excl_ch(v, sh.scan_ch, lane, warp);
        if (tid == 0) sh.head[e] = sh.scan_ch[kWarps];
      }
    }
    __syncthreads();

    // 3. the look-back: everything before the tile, in its true state.
    // Thread i of the window reads the record of tile j - 1 - i, all 11
    // words at once, until some thread holds an inclusive record (every
    // tile before this one is running or done and publishes one without
    // waiting on a later tile) and every newer one its function. The maps
    // composed from that record down give each newer tile's entry state;
    // its sums in that state, folded in order, give the prefix.
    uint64_t* rec = records + kRec * j;
    const Ch init = {0u, 0ULL, 0ULL, true, false};  // token 0 starts a segment at 0
    if (j > 0) {
      if (tid == 0) {
        Ch fn[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) fn[e] = combine(sh.head[e], sh.vtot);
        publish_agg(rec, sh.tile_map, fn);
      }
      const int k = j - 1 - tid;
      const bool reads = k >= 0;   // a thread a tile of the window
      const uint64_t* r = records + kRec * (reads ? k : 0);
      // the function's words wait in shared memory (the run staging, free
      // until step 4), a thread reading back only its own; the exit states
      // and the inclusive words stay in registers
      uint64_t* fw = reinterpret_cast<uint64_t*>(sh.tok_start) + tid;
      static_assert(8 * kThreads * sizeof(uint64_t) <= sizeof(sh.tok_start), "the window fits");
      uint64_t w8 = 0, w9 = 0, w10 = 0;
      uint32_t amap = 0;
      bool incl = k < 0, ready = !reads;
      // after the first read a thread reloads only what the look-back
      // still needs (the block's polls share the SM's load path with the
      // other blocks' work): a record not yet out below the nearest
      // inclusive one, and, while none is in the window, the oldest warp's
      // inclusive words
      int nearest = INT_MAX;
      for (int round = 0;; ++round) {
        if (round) __nanosleep(256);
        if (reads && !ready && tid < nearest) {
          uint64_t x[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) x[q] = load_relaxed(r + q);
          w8 = load_relaxed(r + 8);
          w9 = load_relaxed(r + 9);
          w10 = load_relaxed(r + 10);
          uint64_t all = kValid;
          amap = 0;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            all &= x[q];
            fw[q * kThreads] = x[q];
            if (!(q & 1)) amap |= (static_cast<uint32_t>(x[q] >> 61) & 3u) << (4 * q);
          }
          incl = (w8 & w9 & w10 & kValid) != 0;
          ready = incl || all != 0;
        } else if (reads && !incl && nearest == INT_MAX && warp == kWarps - 1) {
          // the inclusive words, once the first of them shows
          w8 = load_relaxed(r + 8);
          if (w8 & kValid) {
            w9 = load_relaxed(r + 9);
            w10 = load_relaxed(r + 10);
          }
          incl = (w8 & w9 & w10 & kValid) != 0;
        }
        const unsigned ib = __ballot_sync(kFull, incl);
        if (lane == 0) sh.lb_near[warp] = ib ? 32 * warp + __ffs(ib) - 1 : INT_MAX;
        __syncthreads();
        nearest = INT_MAX;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) nearest = min(nearest, sh.lb_near[q]);
        if (!__syncthreads_or(tid < nearest && !ready) && nearest != INT_MAX) break;
      }
      uint32_t map = kIdentity;
      Ch v = ch_identity();
      if (tid == nearest) {
        const uint32_t x = k >= 0 ? static_cast<uint32_t>(w8 >> 61) & 3u : 0u;
        map = x * 0x01010101u;   // before the first tile: state 0, init
        v = k >= 0 ? Ch{static_cast<uint32_t>(w8), w9 & ~kValid, w10 & ~kValid, true,
                        ((w8 >> 60) & 1) != 0}
                   : init;
      } else if (tid < nearest) {
        map = amap;
      }
      // the state after each tile, composed from the nearest up: within
      // the warp, then through the older warps' (a nearest record among
      // warp 0's tiles, the usual case, leaves the other warps out)
      const bool wide = nearest >= 32;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t o = __shfl_down_sync(kFull, map, d);
        if (lane + d < 32) map = compose_map(o, map);
      }
      uint32_t older = kIdentity;
      if (wide) {
        if (lane == 0) sh.lb_map[warp] = map;
        __syncthreads();
        for (int q = kWarps - 1; q > warp; --q) older = compose_map(older, sh.lb_map[q]);
        map = compose_map(older, map);
      }
      const uint32_t after_older = __shfl_down_sync(kFull, map, 1);
      const uint32_t before = lane == 31 ? older : after_older;
      if (tid < nearest) {
        const uint32_t e = apply_map(before, 0);
        v = agg_ch(fw[2 * e * kThreads], fw[(2 * e + 1) * kThreads]);
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const Ch o = shfl_ch(v, -d);
        if (lane + d < 32) v = combine(o, v);
      }
      if (wide) {
        if (lane == 0) sh.lb_ch[warp] = v;
        __syncthreads();
      }
      if (tid == 0) {
        Ch pre = v;
        if (wide) {
          pre = ch_identity();
          for (int q = kWarps - 1; q >= 0; --q) pre = combine(pre, sh.lb_ch[q]);
        }
        const uint32_t x = apply_map(map, 0);
        publish_incl(rec, apply_map(sh.tile_map, x),
                     combine(pre, combine(sh.head[x], sh.vtot)));
        sh.prefix = pre;
        sh.entry = x;
      }
    } else if (tid == 0) {
      publish_incl(rec, apply_map(sh.tile_map, 0), combine(init, combine(sh.head[0], sh.vtot)));
      sh.prefix = init;
      sh.entry = 0;
    }
    // the next ticket: drawn at the tile's start when the grid holds at
    // most a block an SM, else once the look-back is done (a wave of
    // blocks drawing at once waits on the contended atomic: in turns on an
    // H100, drawn at the start 0.0476 / 0.0488 against 0.0466 / 0.0444 ms
    // at a real SE / PE chunk's quality call; drawn after, the N stream's
    // 6 blocks lost ~0.6 us); its bytes go on their way during the runs
    // and the stores
    if (tid == 0) sh.ticket = static_cast<long long>(p.early_draw ? next : atomicAdd(ticket, 1ULL));
    __syncthreads();
    jn = static_cast<int>(sh.ticket);
    if (jn < tiles) stage_tile(sh.stage[cur ^ 1], p.buf, p.m, base + jn * kTile, tid);
    cp_async_commit();

    // 4. the runs, in the true entry state; the bytes again from the
    // stage (kept out of registers over the look-back)
    const uint32_t e = sh.entry;
    uint32_t wr[5];
    {
      const uint4 v = *reinterpret_cast<const uint4*>(stage + kPer * tid);
      wr[0] = v.x, wr[1] = v.y, wr[2] = v.z, wr[3] = v.w;
      wr[4] = *reinterpret_cast<const uint32_t*>(stage + kPer * tid + kPer);
    }
    const Ch prefix = sh.prefix;
    const uint32_t mask = mask_of(wk, apply_map(pmap, e));
    const Ch tile_end = combine(prefix, combine(sh.head[e], sh.vtot));
    // a thread past the head: the prefix, the head in the true state, the
    // rest before it; in the head: the head's threads before it, scanned
    // again in the true state (thread 0 alone: nothing)
    Ch curc = prefix;
    if (heads > 1 && (heads > 32 || warp == 0)) {
      const Ch v = tid < heads ? sum_of(wr, mask, bbits) : ch_identity();
      Ch incl;
      const Ch ex = heads > 32 ? block_excl_ch(v, sh.scan_ch, lane, warp)
                               : warp_excl_ch(v, lane, &incl);
      if (!resolved) curc = combine(prefix, ex);
    }
    if (resolved) curc = combine(prefix, combine(sh.head[e], sh.vt[tid]));
    const uint32_t c0 = prefix.c;   // the tile's first token
    sh.tok_base[tid] = curc.c;
    sh.tok_mask[tid] = static_cast<uint16_t>(mask);
    // every position sum in the tile is below 2^31: each segment's base is
    // its latest start; else the running max of the starts' wrap32 sums
    const bool slow = table && tile_end.a >= (1ULL << 31);
    int32_t run_max = 0;
    if (slow) {
      int32_t tmax = INT_MIN;
      Ch v = curc;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if ((bbits >> k) & 1u) v.pend = true;
        if ((mask >> k) & 1u) {
          if (v.pend) {
            tmax = max(tmax, static_cast<int32_t>(static_cast<uint32_t>(v.a)));
            v.pend = false;
          }
          v.a += token_adv(wr, k);
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
        for (int top = j - 1;; top -= 32) {
          const int k = top - lane;
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
          const int near = incls ? __ffs(incls) - 1 : 31;
          if (lane > near) val = INT_MIN;
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
    if (wk.one_byte) {
      stage_runs<true>(wr, mask, bbits, slow, run_max, curc, c0, sh.tok_start, sh.tok_count);
    } else {
      stage_runs<false>(wr, mask, bbits, slow, run_max, curc, c0, sh.tok_start, sh.tok_count);
    }
    __syncthreads();
    // the tile's runs, stored whole (coalesced), the first tok_cap tokens
    {
      const long long n = tile_end.c - c0;
      const long long keep = min(n, p.tok_cap - static_cast<long long>(c0));
      for (long long i = tid; i < keep; i += kThreads) {
        p.start[c0 + i] = sh.tok_start[i + (i >> 5)];
        p.count[c0 + i] = sh.tok_count[i + (i >> 5)];
      }
    }
    // the bins' first token indices: bin s starts at the first token at or
    // past its boundary
    if (table && tid >= 1 && tid < nb) {
      const int q = sh.bnd[tid] - t0;
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
    cur ^= 1;
  }
  cp_async_wait_all();

  // The block's tickets are done: its share of what no tile writes.
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + tid;
  // bins starting before the first tile (a corrupt table): token 0; and
  // bin 0's, always 0
  if (table && blockIdx.x == 0 && tid < nb && (tid == 0 || sh.bnd[tid] < base)) {
    p.seg_off[tid] = 0;
  }
  if (table && nb == 0 && blockIdx.x == 0 && tid == 0) p.seg_off[0] = 0;
  // escape records: rec = stream_end + 5e, kept while rec + 4 < limit; the
  // window at min(rec, m - 5) with the index wrapping below 0 as torch's
  // does, over w32 and its 3 zero words
  if (table) {
    const long long m = p.m;
    for (long long e = first; e < p.esc_cap; e += stride) {
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
  // token slots at or past the stream's byte count: no token reaches them
  const long long span = hi - lo;
  const long long reach = span < p.tok_cap ? span : p.tok_cap;
  for (long long i = reach + first; i < p.tok_cap; i += stride) {
    p.start[i] = 0;
    p.count[i] = 0;
  }
  // the slots between the last token and the byte count, once the last
  // tile's inclusive record (drawn before this block's last ticket) is out
  if (tid == 0) {
    const uint64_t* last = records + kRec * (tiles - 1) + 8;
    uint64_t v = load_relaxed(last);
    while (!(v & kValid)) {
      __nanosleep(256);
      v = load_relaxed(last);
    }
    sh.ticket = static_cast<long long>(static_cast<uint32_t>(v));
  }
  __syncthreads();
  const long long total = sh.ticket < p.tok_cap ? sh.ticket : p.tok_cap;
  for (long long i = total + first; i < reach; i += stride) {
    p.start[i] = 0;
    p.count[i] = 0;
  }
}

long long tiles_for(long long bytes) { return bytes > 0 ? (bytes + kTile - 1) / kTile : 1; }

// The blocks of one wave of the kernel on the current device (its SMs
// times the blocks an SM holds) and its SMs, asked of the runtime once a
// device.
cudaError_t wave_blocks(long long* blocks, long long* sm_count) {
  static long long cached[64][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev][0]) {
    *blocks = cached[dev][0];
    *sm_count = cached[dev][1];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, parse_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *blocks = static_cast<long long>(sms) * per_sm;
  *sm_count = sms;
  if (dev < 64) {
    cached[dev][1] = sms;
    cached[dev][0] = *blocks;
  }
  return cudaSuccess;
}

}  // namespace

// Stream bytes a tile (the card tests place their edge cases by it).
extern "C" long long repaq_parse_tile() { return kTile; }

// Blocks of the kernel's persistent wave on the current device (the SMs
// times the blocks an SM holds), or minus a cudaError_t.
extern "C" long long repaq_parse_wave() {
  long long blocks = 0, sms = 0;
  const cudaError_t err = wave_blocks(&blocks, &sms);
  return err == cudaSuccess ? blocks : -static_cast<long long>(err);
}

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

// 64-bit status words for max_tiles records: the ticket's line (polled
// records on it would slow every draw), kRec words a record, one max word
// a record (an even count).
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
// token's first position and position count, up to tok_cap tokens, and 0
// past the last. The kernel writes every output; the status words
// (repaq_parse_status_words(max_tiles), max tiles from
// repaq_parse_max_tiles) are cleared here by one memset on the stream,
// then one launch: a wave of blocks (repaq_parse_wave), no more than the
// tiles of the bytes the caller knows of (a stream past them, a table
// claiming more, is taken by the same blocks in turn).
extern "C" int repaq_parse_tokens(const void* buf, long long m, int nbins, long long limit,
                                  long long tok_cap, long long esc_cap, void* start,
                                  void* count, void* seg_off, void* esc_pos, void* esc_char,
                                  void* status, long long max_tiles, void* stream) {
  if (m < 5 || m >= (1LL << 31) - 2LL * kTile || nbins < -1 || nbins > kMaxBins ||
      4LL * (nbins < 0 ? 0 : nbins) > m || limit < 0 || limit >= (1LL << 31) || tok_cap < 1 ||
      tok_cap >= (1LL << 31) || esc_cap < 0 || esc_cap >= (1LL << 31) || max_tiles < 1 ||
      max_tiles != repaq_parse_max_tiles(m, nbins, limit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long wave = 0, sms = 0;
  cudaError_t err = wave_blocks(&wave, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long first = (4LL * (nbins < 0 ? 0 : nbins)) & ~15LL;
  const long long known = (limit < m ? limit : m) - first;
  long long grid = known > 0 ? (known + kTile - 1) / kTile : 1;
  if (grid > max_tiles) grid = max_tiles;
  if (grid > wave) grid = wave;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(status, 0, 8 * repaq_parse_status_words(max_tiles), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{static_cast<const uint8_t*>(buf), m, nbins, limit, tok_cap,
           nbins >= 0 ? esc_cap : 0, max_tiles, grid <= sms, static_cast<int32_t*>(start),
           static_cast<int32_t*>(count), static_cast<int32_t*>(seg_off),
           static_cast<int32_t*>(esc_pos), static_cast<uint8_t*>(esc_char),
           static_cast<uint64_t*>(status)};
  parse_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
