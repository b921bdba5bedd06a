// The PE pair kernels for Hopper (sm_90a): the mate-overlap search, and the
// two pair-tile kernels built around it.
//
// 1. overlap_pairs, the search alone. Replaces: XLA code of the JAX
// package, not a Pallas kernel: the double polynomial hash search of
// repaq_tpu/ops/device_streams.py, `overlap_pairs_device` (:1369) with its
// hashes (:1316, :1333), its first candidate (:1345) and its exact check
// (:1358). It keeps JAX's signature for the tests and runs on no main path.
//
// For each pair p, with minlen = min(L1, L2), it gives the reference's
// first-match overlap (rfqcodec.cpp:1391-1438):
//   +o for the smallest o in [12, minlen] with r1[p, L1-o:] == r2[p, :o];
//   else -o for the smallest such o with r2[p, L2-o:] == r1[p, :o];
//   else 0 (also whenever minlen < 12).
// Bytes compare raw, all 256 values ('N' included). The search is exact,
// so no candidate ever needs the host's search to confirm it.
//
// The search, shared by overlap_pairs and pe_encode_pairs: a warp a pair,
// on rows in shared memory.
//   1. Filter. A candidate o puts a's suffix at byte s = La - o, so the
//      candidates are the starts s in [La - minlen, La - 12] whose four
//      bytes equal b's first four. Each lane takes two aligned words of
//      a, the 8 starts in them, from two loads and 8 funnel shifts by
//      constant amounts: a warp filters 256 candidates a round, so one
//      round covers reads of up to ~250 bp.
//   2. Verification, in order of o. The round's hits are ordered by lane,
//      then by bit (both by increasing o); __ballot_sync and __ffs take the
//      next, and the whole warp compares its o bytes, a word a lane, and
//      agrees by __all_sync. The first that holds is the answer. Over
//      random bases a candidate passes the filter with odds 1/256, so a
//      pair verifies about one candidate beyond its true overlap.
// Forward runs first, and the backward direction only when forward found
// none; every branch is the same in all lanes of the warp. The worst case,
// a row built so that every candidate fails its last byte (A..AC against
// A..AG), verifies 139 candidates a direction: microseconds for the one
// warp that meets it. overlap_pairs stages a pair's two rows per warp (the
// rows may lie any stride apart) and searches them, one wave of warps.
//
// 2. pe_encode_pairs: a PE chunk's (rows, L) seq and qual grids, in place:
// each odd seq row reverse-complemented (ACGT and acgt to TGCA, every other
// byte to 'N', as codec/vectorized.py's _COMP), each odd qual row
// reversed, then each pair's overlap searched on the transformed rows, the
// pairs at or past n_pairs set to 0, and the encode's shift clamp applied
// (0 where |ov + shift| > 127). Replaces: the JAX step's revcomp, search
// and clamp, repaq_tpu/codec/device_engine.py:580-591 (revcomp :582-583,
// search :587, clamp :589-591), which the port ran as a clone, flip, LUT
// gather and row assign for each grid, the overlap_pairs launch and ~8
// elementwise kernels.
//
// 3. pe_decode_rows: the PE decode's payload in one pass: for each row r
// of the (rows, L) grid, the row rebuilt from stored space by the (4, rows)
// tables (stored offset so, forward and backward overlap f and w, the
// mate's stored offset prev): an even row is stored[so + i]; an odd row is
// [its mate's tail][its stored span][its mate's head], i.e. stored[so - f +
// i] for i < f, stored[prev + i - (L - w)] for i >= L - w, else
// stored[so + i - f] (all in int32 arithmetic, the index clamped to the
// stored bytes); with nbq, 'N' where the row-space quality equals nbq;
// then odd rows reverse-complemented and odd quality rows reversed, the
// seq grid written to out[0, rows L) and the quality grid to out[rows L,
// 2 rows L). Without tables every row stores L bases at r L. Replaces:
// repaq_tpu/codec/device_engine.py:984-1001 (expansion), :1008-1009 (N
// restore), :1010-1021 (revcomp) and the payload's concatenation, which
// the port ran as an int32 index grid, three wheres, a clamp, an int64
// gather, the N where, the revcomp's flips, gathers and row assigns and a
// torch.cat.
//
// What bounds 2 and 3 on the card: memory. A PE chunk (98,304 rows of 150
// bytes) moves ~37 MB in the encode (the seq grid and the odd qual rows
// read, the odd rows of both written, ov written) and ~55 MB in the decode
// (the stored bases and the qual grid read, the tables, 2 rows L
// written): 11 and 16 us at 3.35 TB/s. The design: a persistent grid;
// each block takes tiles of P pairs (2P consecutive rows) in turn, tile b,
// b + grid, ... (every tile costs about the same, so no ticket counter). A
// tile's rows are one contiguous byte range on each side (a decode tile's
// stored bases too: the elided offsets are cumulative, so a tile of whole
// pairs stores one range from its first row's offset), so a tile is
// staged into shared memory by 16-byte cp.async of the aligned vectors
// that hold it, the staged bytes congruent mod 16 to their global
// addresses. Two stages: the copies of a block's next tile are issued
// before it works on this one, so each tile's load latency hides behind
// the previous tile's work. A warp builds a row of the tile's output in
// shared memory a word at a time (an odd row's four bytes funnel-shifted
// from two staged words, reversed by one byte permute and complemented by
// four byte compares; the decode's 'N' restore a byte compare of the
// quality word), the bytes at a row's ends and any word a decode row
// reads across its two spans one at a time; then the tile's output is
// stored whole by 16-byte stores (the encode's even rows as they were:
// full sectors cost less than partial ones). The encode then searches its
// pairs on the output tile, a warp a pair. P is 32 pairs where two stages
// and the output tiles fit in kTileBudget bytes, halved down to 1 for
// long reads; rows past what one pair's tile can hold (~29,000 bases) take
// a route of their own: the encode a block a pair, its odd rows turned in
// place in global memory, the pair then staged and searched; the decode
// read and written in global memory directly, a warp a row's piece, a byte
// a lane.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMinOverlap = 12;  // the reference's MIN_OVERLAP
constexpr int kMaxWarps = 8;     // pairs a block of overlap_pairs
// blocks an SM the registers must allow: 6 keeps the kernel to 40
// registers (48 warps an SM), where the compiler would take 64 (32 warps);
// the pairs' loads then have more warps to hide behind
constexpr int kMinBlocks = 6;
constexpr int kWordsPerLane = 2;  // filter words a lane and round
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // a block's limit on sm_90

// the pair-tile kernels: threads a block, the most pairs a tile, and the
// shared memory a block's tiles aim under (P halves until they fit)
constexpr int kPairThreads = 256;
constexpr int kPairTile = 32;
constexpr long long kTileBudget = 64 * 1024;
// bytes of a row a warp of the decode's direct route takes at a time
constexpr int kPiece = 256;

// 16-byte vectors a staged row of len bytes may take: the vectors that
// hold the row from any start within a vector, and one spare, so that a
// word read at any byte of the row stays inside
__host__ __device__ inline long long row_vecs(long long len) {
  return (len + 30) / 16 + 1;
}

// the four bytes from byte s of a staged row, byte s lowest
__device__ __forceinline__ uint32_t word_at(const uint32_t* row, int s) {
  return __funnelshift_r(row[s >> 2], row[(s >> 2) + 1], (s & 3) * 8);
}

// the row's vectors into the shared row s; returns the byte of s at which
// the row starts
__device__ __forceinline__ int stage(uint4* s, const uint8_t* g, int len,
                                     int lane) {
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  const uint4* v = reinterpret_cast<const uint4*>(g - off);
  const int n = (off + len + 15) >> 4;
  for (int i = lane; i < n; i += 32) s[i] = __ldg(v + i);
  return off;
}

// a's staged bytes [s, s + o) against b's [sb, sb + o), the whole warp;
// the same answer in every lane
__device__ __forceinline__ bool verify(const uint32_t* a, int s,
                                       const uint32_t* b, int sb, int o,
                                       int lane) {
  bool ok = true;
  for (int j = 4 * lane; j < o; j += 128) {
    uint32_t x = word_at(a, s + j) ^ word_at(b, sb + j);
    if (o - j < 4) x &= kFull >> (8 * (4 - (o - j)));
    ok = ok && x == 0;
  }
  return __all_sync(kFull, ok);
}

// the smallest o in [12, minlen] with a's suffix of o bytes equal to b's
// prefix, 0 if none (minlen >= 12); a's row starts at staged byte sa, b's
// at sb. The same value in every lane.
__device__ int first_overlap(const uint32_t* a, int sa, int la,
                             const uint32_t* b, int sb, int minlen,
                             int lane) {
  const uint32_t head = word_at(b, sb);  // b's first four bytes
  const int s_hi = sa + la - kMinOverlap;  // the start of o = 12
  const int s_lo = sa + la - minlen;       // the start of o = minlen
  const int w_lo = s_lo >> 2;
  for (int w0 = s_hi >> 2; w0 >= w_lo; w0 -= 32 * kWordsPerLane) {
    // bit 4k + 3 - u: the start 4 w + u of the lane's word k, w = w0 -
    // kWordsPerLane lane - k; lower bits, then higher lanes, are larger o
    unsigned hits = 0;
#pragma unroll
    for (int k = 0; k < kWordsPerLane; ++k) {
      const int w = w0 - kWordsPerLane * lane - k;
      if (w >= w_lo) {
        const uint32_t lo = a[w];
        const uint32_t hi = a[w + 1];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int s = 4 * w + u;
          if (s >= s_lo && s <= s_hi && __funnelshift_r(lo, hi, 8 * u) == head)
            hits |= 1u << (4 * k + 3 - u);
        }
      }
    }
    for (unsigned lanes = __ballot_sync(kFull, hits != 0); lanes;
         lanes &= lanes - 1) {
      const int src = __ffs(lanes) - 1;
      for (unsigned h = __shfl_sync(kFull, hits, src); h; h &= h - 1) {
        const int bit = __ffs(h) - 1;
        const int s = 4 * (w0 - kWordsPerLane * src - (bit >> 2)) + 3 -
                      (bit & 3);
        const int o = sa + la - s;
        if (verify(a, s, b, sb, o, lane)) return o;
      }
    }
  }
  return 0;
}

__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
    overlap_kernel(const uint8_t* __restrict__ r1, long long stride1, int l1,
                   const uint8_t* __restrict__ r2, long long stride2, int l2,
                   long long pairs, int32_t* __restrict__ out) {
  extern __shared__ uint4 rows[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long p =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (p >= pairs) return;  // the whole warp: p is the warp's
  const int minlen = min(l1, l2);
  if (minlen < kMinOverlap) {  // no candidate: nothing to read
    if (lane == 0) out[p] = 0;
    return;
  }
  uint4* v1 = rows + warp * (row_vecs(l1) + row_vecs(l2));
  uint4* v2 = v1 + row_vecs(l1);
  const int s1 = stage(v1, r1 + p * stride1, l1, lane);
  const int s2 = stage(v2, r2 + p * stride2, l2, lane);
  __syncwarp();
  const uint32_t* w1 = reinterpret_cast<const uint32_t*>(v1);
  const uint32_t* w2 = reinterpret_cast<const uint32_t*>(v2);
  int ov = first_overlap(w1, s1, l1, w2, s2, minlen, lane);
  if (ov == 0) ov = -first_overlap(w2, s2, l2, w1, s1, minlen, lane);
  if (lane == 0) out[p] = ov;
}

// ---------------------------------------------------------------------------
// the pair-tile kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_at(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// bytes of the 16 at g that lie before end land at s, the rest are zero
__device__ __forceinline__ void cp_async16(void* s, const uint8_t* g,
                                           const uint8_t* end) {
  const long long left = end - g;
  const int bytes = left >= 16 ? 16 : static_cast<int>(left);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_at(s)),
               "l"(g), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_at(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// the aligned vectors that hold global bytes [g, g + len) (none past end,
// which is 16-aligned or the end of the tensor) into s, block-wide; the
// range starts at byte (g & 15) of s, congruent to g mod 16. The vector
// that holds g starts at or after the tensor's start, which the wrapper
// aligns to 16 bytes.
__device__ __forceinline__ int stage_async(uint4* s, const uint8_t* g,
                                           long long len, const uint8_t* end) {
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  const uint8_t* v = g - off;
  const long long n = (off + len + 15) >> 4;
  for (long long i = threadIdx.x; i < n; i += blockDim.x)
    cp_async16(s + i, v + 16 * i, end);
  return off;
}

// n bytes from shared s to global g, with 16-byte stores where the two are
// congruent mod 16 (bytes at the ends), else byte by byte; the threads i0,
// i0 + step, ... of the caller
__device__ __forceinline__ void store_bytes(uint8_t* g, const uint8_t* s,
                                            long long n, int i0, int step) {
  if (((reinterpret_cast<uintptr_t>(g) ^ reinterpret_cast<uintptr_t>(s)) &
       15) != 0) {
    for (long long i = i0; i < n; i += step) g[i] = s[i];
    return;
  }
  long long head = (16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15;
  if (head > n) head = n;
  const long long vecs = (n - head) >> 4;
  for (long long i = i0; i < head; i += step) g[i] = s[i];
  uint4* gv = reinterpret_cast<uint4*>(g + head);
  const uint4* sv = reinterpret_cast<const uint4*>(s + head);
  for (long long i = i0; i < vecs; i += step) gv[i] = sv[i];
  for (long long i = head + 16 * vecs + i0; i < n; i += step) g[i] = s[i];
}

// vectorized._COMP: A/a -> T, T/t -> A, C/c -> G, G/g -> C, else N (a
// byte | 0x20 is 'a' only for 'A' and 'a', and so for the others)
__device__ __forceinline__ uint8_t comp_base(uint8_t c) {
  const unsigned l = c | 0x20u;
  return l == 'a' ? 'T' : l == 't' ? 'A' : l == 'c' ? 'G'
                                       : l == 'g' ? 'C' : 'N';
}

// 0xFF in each byte of x that is 0, 0 in the others (the exact zero-byte
// test: no carry crosses a byte)
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  const uint32_t hi =
      ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x | 0x7F7F7F7Fu);
  return (hi >> 7) * 0xFFu;
}

// comp_base of each byte of a word. An upper-case base's bits 1-2 are a
// code (A 0, C 1, T 2, G 3) whose complement is code ^ 2, so one byte
// permute of "ACTG" by the codes gives the complements, and one by the
// codes themselves the base each code names: a byte that is not that base
// (upper or lower case) is no ACGT and becomes 'N'.
__device__ __forceinline__ uint32_t comp4(uint32_t x) {
  constexpr uint32_t kACTG = 0x47544341u;  // 'A' 'C' 'T' 'G', byte 0 first
  const uint32_t u = x & 0xDFDFDFDFu;      // upper case
  const uint32_t code = (u >> 1) & 0x03030303u;
  const uint32_t c2 = code | (code >> 4);
  const uint32_t sel = (c2 & 0xFFu) | ((c2 >> 8) & 0xFF00u);  // nibbles
  const uint32_t ok = zero_bytes(__byte_perm(kACTG, 0, sel) ^ u);
  return (__byte_perm(kACTG, 0, sel ^ 0x2222u) & ok) |
         (0x4E4E4E4Eu & ~ok);
}

// a word's bytes in reverse order
__device__ __forceinline__ uint32_t rev4(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// 'N' in c's bytes where q's equal nbq (nbq < 0: none)
__device__ __forceinline__ uint32_t restore_n4(uint32_t c, uint32_t q,
                                               int nbq) {
  if (nbq < 0) return c;
  const uint32_t m = zero_bytes(q ^ (0x01010101u * static_cast<uint32_t>(nbq)));
  return (c & ~m) | (0x4E4E4E4Eu & m);
}

// e / L for the tile bytes e < 2^18 and L < 2^17: a multiply by
// ceil(2^40 / L) (exact while e * L < 2^40)
__device__ __forceinline__ int row_of(int e, unsigned long long inv_l) {
  return static_cast<int>((static_cast<unsigned long long>(e) * inv_l) >> 40);
}

// a tile's buffers, in 16-byte vectors: a stage of seq (the decode's
// stored bases) and qual rows, the decode's tables, the output tiles of
// seq and qual (one set, not staged twice) and the decode's row spans
struct TileLayout {
  long long seq_vecs, qual_vecs, table_vecs, out_vecs, row_vecs;
  __host__ __device__ long long stage() const {
    return seq_vecs + qual_vecs + table_vecs;
  }
  __host__ __device__ long long bytes(int nbuf) const {
    return 16 * (nbuf * stage() + 2 * out_vecs + row_vecs);
  }
};

__host__ __device__ inline TileLayout encode_layout(int pairs, int L) {
  const long long v = row_vecs(2LL * pairs * L);
  return {v, v, 0, v, 0};
}

__host__ __device__ inline TileLayout decode_layout(int pairs, int L,
                                                    bool tables) {
  const long long rows = 2LL * pairs;
  const long long v = row_vecs(rows * L);
  return {v, v, tables ? (4 * rows * 4 + 15) / 16 : 0, v, rows};
}

// The tile's n bytes of output, os and oq from the staged s and q (the
// four congruent mod 16, the tile at byte o of each), block-wide: an even
// row copied, an odd one reverse-complemented (its qual reversed). A
// thread takes a word of the output at a time. Inside one row it moves as
// a word (an odd row's from two staged words funnel-shifted, its bytes
// reversed by one permute and complemented four at once); a word across
// two rows is the last four bytes of the one and the first four of the
// next, each so made, shifted into place; the words at the tile's ends
// (and rows under 4 bytes) a byte at a time.
__device__ __forceinline__ void encode_tile(const uint8_t* s, const uint8_t* q,
                                            uint8_t* os, uint8_t* oq, int o,
                                            int n, int L,
                                            unsigned long long inv_l) {
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(s);
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);
  uint32_t* os32 = reinterpret_cast<uint32_t*>(os);
  uint32_t* oq32 = reinterpret_cast<uint32_t*>(oq);
  // the output bytes k..k+3 of row j (0 <= k <= L - 4), in place order
  auto word = [&](int j, int k, uint32_t* c, uint32_t* qw) {
    const int r = o + j * L;
    if (j & 1) {
      const int p = r + L - 4 - k;  // the bytes the word reverses
      *c = comp4(rev4(word_at(s32, p)));
      *qw = rev4(word_at(q32, p));
    } else {
      *c = word_at(s32, r + k);
      *qw = word_at(q32, r + k);
    }
  };
  const int w0 = o >> 2;
  const int words = ((o + n + 3) >> 2) - w0;
  for (int wi = threadIdx.x; wi < words; wi += blockDim.x) {
    const int t = 4 * (w0 + wi);
    const int e = t - o;  // the word's first byte in the tile
    if (e >= 0 && e + 4 <= n && L >= 4) {
      const int j = row_of(e, inv_l);
      const int k = e - j * L;
      uint32_t c, qw;
      if (k <= L - 4) {
        word(j, k, &c, &qw);
      } else {  // m bytes of row j, 4 - m of row j + 1
        const int m = L - k;
        uint32_t c1, q1;
        word(j, L - 4, &c, &qw);
        word(j + 1, 0, &c1, &q1);
        c = (c >> (32 - 8 * m)) | (c1 << (8 * m));
        qw = (qw >> (32 - 8 * m)) | (q1 << (8 * m));
      }
      os32[t >> 2] = c;
      oq32[t >> 2] = qw;
      continue;
    }
    for (int b = max(e, 0); b < min(e + 4, n); ++b) {
      const int jb = row_of(b, inv_l);
      const int kb = b - jb * L;
      const int src = (jb & 1) ? o + jb * L + L - 1 - kb : o + b;
      os[o + b] = (jb & 1) ? comp_base(s[src]) : s[src];
      oq[o + b] = q[src];
    }
  }
}

__global__ void __launch_bounds__(kPairThreads)
    pe_encode_kernel(uint8_t* __restrict__ seq, uint8_t* __restrict__ qual,
                     int L, long long pairs, long long n_pairs, int shift,
                     int search, int tile_pairs, int nbuf,
                     int32_t* __restrict__ ov) {
  extern __shared__ uint4 smem[];
  const TileLayout lay = encode_layout(tile_pairs, L);
  const long long tiles = (pairs + tile_pairs - 1) / tile_pairs;
  const long long rows = 2 * pairs;
  const uint8_t* seq_end = seq + rows * L;
  const uint8_t* qual_end = qual + rows * L;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const unsigned long long inv_l = ((1ULL << 40) + L - 1) / L;
  // the byte at which a stage's tile starts, the same in both grids (both
  // 16-byte aligned) and in the output tiles
  int off[2];

  auto issue = [&](long long t, int b) {
    uint4* st = smem + b * lay.stage();
    const long long r0 = 2 * t * tile_pairs;
    const long long len = min(2LL * tile_pairs, rows - r0) * L;
    off[b] = stage_async(st, seq + r0 * L, len, seq_end);
    stage_async(st + lay.seq_vecs, qual + r0 * L, len, qual_end);
    cp_async_commit();
  };

  uint8_t* os = reinterpret_cast<uint8_t*>(smem + nbuf * lay.stage());
  uint8_t* oq = os + 16 * lay.out_vecs;
  long long t = blockIdx.x;
  if (nbuf == 2 && t < tiles) issue(t, 0);
  for (int k = 0; t < tiles; t += gridDim.x, ++k) {
    const int b = nbuf == 2 ? (k & 1) : 0;
    if (nbuf == 2) {
      if (t + gridDim.x < tiles) {
        issue(t + gridDim.x, b ^ 1);
      } else {
        cp_async_commit();  // an empty group keeps the count
      }
      cp_async_wait<1>();
    } else {
      issue(t, 0);
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* s = reinterpret_cast<const uint8_t*>(smem + b * lay.stage());
    const uint8_t* q = s + 16 * lay.seq_vecs;
    const long long p0 = t * tile_pairs;
    const int np =
        static_cast<int>(min(static_cast<long long>(tile_pairs), pairs - p0));
    const int o = off[b];
    encode_tile(s, q, os, oq, o, 2 * np * L, L, inv_l);
    __syncthreads();
    // the whole tile, even rows unchanged (full sectors cost less than
    // partial ones at the odd rows' ends)
    store_bytes(seq + 2 * p0 * L, os + o, 2LL * np * L, threadIdx.x,
                blockDim.x);
    store_bytes(qual + 2 * p0 * L, oq + o, 2LL * np * L, threadIdx.x,
                blockDim.x);
    for (int j = warp; j < np; j += warps) {
      const long long p = p0 + j;  // a warp a pair
      int found = 0;
      if (search && p < n_pairs && L >= kMinOverlap) {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(os);
        const int sa = o + 2 * j * L;
        const int sb = sa + L;
        found = first_overlap(w, sa, L, w, sb, L, lane);
        if (found == 0) found = -first_overlap(w, sb, L, w, sa, L, lane);
      }
      if (lane == 0) {
        const int shifted = found + shift;
        ov[p] = (shifted > 127 || shifted < -127) ? 0 : found;
      }
    }
    __syncthreads();  // the stage and the output tiles are free again
  }
}

// the encode's route for rows too long for a tile: a block a pair, the odd
// rows turned in place in global memory (byte j swapped with byte L-1-j by
// one thread), then the pair's two rows staged by warp 0 and searched
__global__ void __launch_bounds__(kPairThreads)
    pe_encode_long_kernel(uint8_t* seq, uint8_t* qual, int L, long long pairs,
                          long long n_pairs, int shift, int search,
                          int32_t* __restrict__ ov) {
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31;
  for (long long p = blockIdx.x; p < pairs; p += gridDim.x) {
    uint8_t* rs = seq + (2 * p + 1) * L;
    uint8_t* rq = qual + (2 * p + 1) * L;
    for (int j = threadIdx.x; j < (L + 1) / 2; j += blockDim.x) {
      const uint8_t a = rs[j], b = rs[L - 1 - j];
      rs[j] = comp_base(b);
      rs[L - 1 - j] = comp_base(a);
      const uint8_t c = rq[j], d = rq[L - 1 - j];
      rq[j] = d;
      rq[L - 1 - j] = c;
    }
    __syncthreads();  // the block's writes, seen by warp 0's loads
    if (threadIdx.x < 32) {
      int found = 0;
      if (search && p < n_pairs && L >= kMinOverlap) {
        // plain loads: the odd row was written by this kernel
        uint4* v1 = smem;
        uint4* v2 = smem + row_vecs(L);
        const uint8_t* r1 = seq + 2 * p * L;
        const int s1 = static_cast<int>(reinterpret_cast<uintptr_t>(r1) & 15);
        const int s2 = static_cast<int>(reinterpret_cast<uintptr_t>(rs) & 15);
        const uint4* g1 = reinterpret_cast<const uint4*>(r1 - s1);
        const uint4* g2 = reinterpret_cast<const uint4*>(rs - s2);
        for (int i = lane; i < (s1 + L + 15) >> 4; i += 32) v1[i] = g1[i];
        for (int i = lane; i < (s2 + L + 15) >> 4; i += 32) v2[i] = g2[i];
        __syncwarp();
        const uint32_t* w1 = reinterpret_cast<const uint32_t*>(v1);
        const uint32_t* w2 = reinterpret_cast<const uint32_t*>(v2);
        found = first_overlap(w1, s1, L, w2, s2, L, lane);
        if (found == 0) found = -first_overlap(w2, s2, L, w1, s1, L, lane);
      }
      if (lane == 0) {
        const int shifted = found + shift;
        ov[p] = (shifted > 127 || shifted < -127) ? 0 : found;
      }
    }
    __syncthreads();  // the staged rows are free again
  }
}

// the decode's source byte of row r (odd or not), position i, as an index
// into the stored bytes (int32 arithmetic as the plain version's, wrapping
// alike), clamped to [0, n_stored)
__device__ __forceinline__ int source_of(bool odd, int so, int f, int w,
                                         int prev, int i, int L,
                                         int n_stored) {
  const unsigned u = static_cast<unsigned>(i);
  const int lw = static_cast<int>(static_cast<unsigned>(L) -
                                  static_cast<unsigned>(w));
  int src;
  if (!odd) {
    src = static_cast<int>(static_cast<unsigned>(so) + u);
  } else if (i < f) {
    src = static_cast<int>(static_cast<unsigned>(so) -
                           static_cast<unsigned>(f) + u);
  } else if (i >= lw) {
    src = static_cast<int>(static_cast<unsigned>(prev) + u -
                           static_cast<unsigned>(lw));
  } else {
    src = static_cast<int>(static_cast<unsigned>(so) + u -
                           static_cast<unsigned>(f));
  }
  return src < 0 ? 0 : (src >= n_stored ? n_stored - 1 : src);
}

// The decode's direct route (rows too long for a stage): a warp takes a
// piece of up to kPiece bytes of a row at a time (the grid's warps take
// the pieces in turn), loads the row's tables once (the same address in
// every lane) and moves the piece a byte a lane: each output byte read
// from its stored source by source_of, 'N' where its quality is nbq, an
// odd row's bytes written reversed and complemented (its quality
// reversed). Consecutive lanes read and write consecutive bytes, so every
// load and store of a warp is one or two sectors.
__global__ void __launch_bounds__(kPairThreads)
    pe_decode_direct_kernel(const uint8_t* __restrict__ stored,
                            int n_stored, const uint8_t* __restrict__ qual,
                            const int32_t* __restrict__ tables,
                            long long rows, int L, int nbq,
                            uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long n = rows * L;
  const int pieces = (L + kPiece - 1) / kPiece;
  const long long items = rows * pieces;
  const long long warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long it = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) >> 5;
       it < items; it += warps) {
    const long long r = pieces == 1 ? it : it / pieces;
    const int i0 = static_cast<int>(it - r * pieces) * kPiece;
    const int i1 = min(L, i0 + kPiece);
    const bool odd = r & 1;
    int so, f = 0, w = 0, prev = 0;
    if (tables) {
      so = __ldg(tables + r);
      f = __ldg(tables + rows + r);
      w = __ldg(tables + 2 * rows + r);
      prev = __ldg(tables + 3 * rows + r);
    } else {
      so = static_cast<int>(r * L);
    }
    const uint8_t* q = qual + r * L;
    uint8_t* os = out + r * L;
    uint8_t* oq = out + n + r * L;
#pragma unroll 4
    for (int i = i0 + lane; i < i1; i += 32) {
      uint8_t c = __ldg(stored + source_of(odd, so, f, w, prev, i, L,
                                           n_stored));
      const uint8_t qc = __ldg(q + i);
      if (qc == nbq) c = 'N';
      const int at = odd ? L - 1 - i : i;
      os[at] = odd ? comp_base(c) : c;
      oq[at] = qc;
    }
  }
}

// A decode tile's row, as its words read it: the stage byte of the span
// the row reads from its start (stored so - f for an odd row, so for an
// even one; -1 where the row reads outside the staged bytes or its
// tables are of no real chunk, and takes the byte path), that span's
// length, and the stage byte of the span it reads after it (an odd row's
// backward overlap: its mate's first w bytes, from prev).
struct RowSpans {
  int a, la, b, pad;  // pad: 16 bytes a record
};

__device__ __forceinline__ RowSpans row_spans(bool odd, int so, int f, int w,
                                              int prev, int L, long long lo,
                                              long long hi, int soff) {
  const long long a = odd ? static_cast<long long>(so) - f : so;
  const int la = odd ? L - w : L;
  const bool fast =
      (!odd || (f >= 0 && w >= 0 && f <= L && w <= L && (f == 0 || w == 0))) &&
      (la == 0 || (a >= lo && a + la <= hi)) &&
      (!odd || w == 0 || (prev >= lo && static_cast<long long>(prev) + w <= hi));
  if (!fast) return {-1, 0, 0, 0};
  return {soff + static_cast<int>(a - lo), la,
          soff + static_cast<int>(prev - lo), 0};
}

__global__ void __launch_bounds__(kPairThreads)
    pe_decode_kernel(const uint8_t* __restrict__ stored, int n_stored,
                     const uint8_t* __restrict__ qual,
                     const int32_t* __restrict__ tables, long long rows,
                     int L, int nbq, int tile_pairs, int nbuf,
                     uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  const TileLayout lay = decode_layout(tile_pairs, L, tables != nullptr);
  const long long tile_rows = 2LL * tile_pairs;
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  const long long n = rows * L;
  const uint8_t* stored_end = stored + n_stored;
  const uint8_t* qual_end = qual + n;
  // per stage: the stored range [lo, hi) and where it and the qual tile
  // start in their buffers
  long long lo[2], hi[2];
  int soff[2], qoff[2];

  auto issue = [&](long long t, int b) {
    uint4* st = smem + b * lay.stage();
    const long long r0 = t * tile_rows;
    const long long nrows = min(tile_rows, rows - r0);
    // a tile of whole pairs stores one range from its first row's offset,
    // at most its rows' bytes; a row whose sources fall outside it (pad
    // rows, tables of no real chunk) reads global memory instead
    long long first = tables ? __ldg(tables + r0) : r0 * L;
    first = first < 0 ? 0 : (first > n_stored ? n_stored : first);
    lo[b] = first;
    hi[b] = min(first + nrows * L, static_cast<long long>(n_stored));
    soff[b] = stage_async(st, stored + lo[b], hi[b] - lo[b], stored_end);
    qoff[b] = stage_async(st + lay.seq_vecs, qual + r0 * L, nrows * L,
                          qual_end);
    if (tables) {
      int32_t* tab = reinterpret_cast<int32_t*>(st + lay.seq_vecs +
                                                lay.qual_vecs);
      for (long long e = threadIdx.x; e < 4 * nrows; e += blockDim.x) {
        const long long c = e / nrows;
        const long long j = e - c * nrows;
        cp_async4(tab + c * tile_rows + j, tables + c * rows + r0 + j);
      }
    }
    cp_async_commit();
  };

  uint8_t* obuf = reinterpret_cast<uint8_t*>(smem + nbuf * lay.stage());
  RowSpans* rec = reinterpret_cast<RowSpans*>(smem + nbuf * lay.stage() +
                                              2 * lay.out_vecs);
  const unsigned long long inv_l = ((1ULL << 40) + L - 1) / L;
  long long t = blockIdx.x;
  if (nbuf == 2 && t < tiles) issue(t, 0);
  for (int k = 0; t < tiles; t += gridDim.x, ++k) {
    const int b = nbuf == 2 ? (k & 1) : 0;
    if (nbuf == 2) {
      if (t + gridDim.x < tiles) {
        issue(t + gridDim.x, b ^ 1);
      } else {
        cp_async_commit();
      }
      cp_async_wait<1>();
    } else {
      issue(t, 0);
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint4* st = smem + b * lay.stage();
    const int32_t* tab = reinterpret_cast<const int32_t*>(
        st + lay.seq_vecs + lay.qual_vecs);
    const long long r0 = t * tile_rows;
    const int nrows = static_cast<int>(min(tile_rows, rows - r0));
    uint8_t* og = out + r0 * L;
    // the output tiles, congruent mod 16 to the seq tile's place in out
    const int ooff = static_cast<int>(reinterpret_cast<uintptr_t>(og) & 15);
    uint8_t* os = obuf;
    uint8_t* oq = obuf + 16 * lay.out_vecs;
    const long long slo = lo[b], shi = hi[b];
    const int so_ = soff[b], qo = qoff[b];
    auto table = [&](int j, int* so, int* f, int* w, int* prev) {
      if (tables) {
        *so = tab[j];
        *f = tab[tile_rows + j];
        *w = tab[2 * tile_rows + j];
        *prev = tab[3 * tile_rows + j];
      } else {
        *so = static_cast<int>((r0 + j) * L);
        *f = *w = *prev = 0;
      }
    };
    for (int j = threadIdx.x; j < nrows; j += blockDim.x) {
      // each row's spans, a thread a row
      int so, f, w, prev;
      table(j, &so, &f, &w, &prev);
      rec[j] = row_spans(j & 1, so, f, w, prev, L, slo, shi, so_);
    }
    __syncthreads();
    // then the output a word a thread, as the encode's: inside one row of
    // real spans as a word (an odd row's bytes reversed and complemented
    // four at once, 'N' where the quality word's bytes equal nbq), across
    // two rows as the last four bytes of the one and the first four of the
    // next, shifted into place; else a byte at a time by source_of's exact
    // arithmetic
    const uint8_t* sb = reinterpret_cast<const uint8_t*>(st);
    const uint8_t* qb = reinterpret_cast<const uint8_t*>(st + lay.seq_vecs);
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(sb);
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qb);
    uint32_t* os32 = reinterpret_cast<uint32_t*>(os);
    uint32_t* oq32 = reinterpret_cast<uint32_t*>(oq);
    const int nb = nrows * L;
    auto one = [&](int e) {  // output byte e of the tile
      const int j = row_of(e, inv_l);
      const int kk = e - j * L;
      const bool odd = j & 1;
      const int i = odd ? L - 1 - kk : kk;
      int so, f, w, prev;
      table(j, &so, &f, &w, &prev);
      const int src = source_of(odd, so, f, w, prev, i, L, n_stored);
      uint8_t c = (src >= slo && src < shi) ? sb[so_ + (src - slo)]
                                            : __ldg(stored + src);
      const uint8_t qc = qb[qo + j * L + i];
      if (qc == nbq) c = 'N';
      os[ooff + e] = odd ? comp_base(c) : c;
      oq[ooff + e] = qc;
    };
    // the output bytes k..k+3 of row j (0 <= k <= L - 4) in place order,
    // or false where they take the byte path (a row outside its real
    // spans, a word across an odd row's two spans)
    auto word = [&](int j, int k, uint32_t* c, uint32_t* qw) {
      const RowSpans r = rec[j];
      if (r.a < 0) return false;
      const int qrow = qo + j * L;
      if (!(j & 1)) {
        *qw = word_at(q32, qrow + k);
        *c = restore_n4(word_at(s32, r.a + k), *qw, nbq);
        return true;
      }
      const int i = L - 4 - k;  // the lowest of its bytes' row positions
      uint32_t x;
      if (i + 3 < r.la) {
        x = word_at(s32, r.a + i);
      } else if (i >= r.la) {
        x = word_at(s32, r.b + i - r.la);
      } else {
        return false;
      }
      const uint32_t y = word_at(q32, qrow + i);
      *c = comp4(rev4(restore_n4(x, y, nbq)));
      *qw = rev4(y);
      return true;
    };
    const int w0 = ooff >> 2;
    const int words = ((ooff + nb + 3) >> 2) - w0;
    for (int wi = threadIdx.x; wi < words; wi += blockDim.x) {
      const int t = 4 * (w0 + wi);
      const int e = t - ooff;
      if (e >= 0 && e + 4 <= nb && L >= 4) {
        const int j = row_of(e, inv_l);
        const int kk = e - j * L;
        uint32_t c, qw, c1, q1;
        bool ok;
        if (kk <= L - 4) {
          ok = word(j, kk, &c, &qw);
        } else {  // m bytes of row j, 4 - m of row j + 1
          const int m = L - kk;
          ok = word(j, L - 4, &c, &qw) && word(j + 1, 0, &c1, &q1);
          c = (c >> (32 - 8 * m)) | (c1 << (8 * m));
          qw = (qw >> (32 - 8 * m)) | (q1 << (8 * m));
        }
        if (ok) {
          os32[t >> 2] = c;
          oq32[t >> 2] = qw;
          continue;
        }
      }
      for (int x = max(e, 0); x < min(e + 4, nb); ++x) one(x);
    }
    __syncthreads();
    store_bytes(og, os + ooff, static_cast<long long>(nrows) * L,
                threadIdx.x, blockDim.x);
    store_bytes(out + n + r0 * L, oq + ooff,
                static_cast<long long>(nrows) * L, threadIdx.x, blockDim.x);
    __syncthreads();  // the stage and the output tiles are free again
  }
}

// the blocks one wave of `kernel` holds with `smem` bytes a block
cudaError_t wave_blocks(const void* kernel, size_t smem, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kPairThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *blocks = static_cast<long long>(sms) * per_sm;
  return cudaSuccess;
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// pairs a tile and stages for rows of L bytes: P halves from kPairTile
// until two stages fit kTileBudget, then one stage is taken if two exceed
// a block's limit; 0 pairs when one pair's single stage does not fit
template <typename Layout>
void tile_shape(Layout layout, int* pairs, int* nbuf) {
  int p = kPairTile;
  while (p > 1 && layout(p).bytes(2) > kTileBudget) p >>= 1;
  *pairs = p;
  *nbuf = layout(p).bytes(2) <= static_cast<long long>(kMaxSmem) ? 2 : 1;
  if (layout(p).bytes(*nbuf) > static_cast<long long>(kMaxSmem)) *pairs = 0;
}

void encode_shape(int L, int* pairs, int* nbuf) {
  tile_shape([L](int p) { return encode_layout(p, L); }, pairs, nbuf);
}

void decode_shape(int L, bool tables, int* pairs, int* nbuf) {
  tile_shape([L, tables](int p) { return decode_layout(p, L, tables); },
             pairs, nbuf);
}

}  // namespace

// r1, r2: `pairs` rows of l1 and l2 bytes, row p at r1 + p * stride1 and
// r2 + p * stride2 (any alignment); out: (pairs,) int32. Returns the CUDA
// error of the launch, cudaErrorInvalidValue when one warp's two rows
// exceed a block's shared memory.
extern "C" int repaq_overlap_pairs(const void* r1, long long stride1, int l1,
                                   const void* r2, long long stride2, int l2,
                                   long long pairs, void* out, void* stream) {
  if (pairs <= 0) return 0;
  const size_t warp_bytes =
      16 * static_cast<size_t>(row_vecs(l1) + row_vecs(l2));
  int warps = kMaxWarps;
  while (warps > 1 && warps * warp_bytes > kDefaultSmem) warps >>= 1;
  const size_t smem = warps * warp_bytes;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(overlap_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (pairs + warps - 1) / warps;
  overlap_kernel<<<static_cast<unsigned>(blocks), warps * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(r1), stride1, l1,
      static_cast<const uint8_t*>(r2), stride2, l2, pairs,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Pairs a tile of the encode (decode = 0) or of the decode with tables
// (decode = 1) or without (decode = 2) at rows of L bytes; 0 where rows
// are too long for a tile (the encode's long route, the decode's direct
// route).
extern "C" long long repaq_pe_pair_tile(int L, int decode) {
  int pairs = 0, nbuf = 0;
  if (decode)
    decode_shape(L, decode == 1, &pairs, &nbuf);
  else
    encode_shape(L, &pairs, &nbuf);
  return pairs;
}

// seq, qual: (2 * pairs, L) uint8 grids, contiguous, 16-byte aligned,
// transformed in place; ov: (pairs,) int32. Returns the CUDA error of the
// launch, cudaErrorInvalidValue when one pair's two rows exceed a block's
// shared memory (past the format's 65,535 bases).
extern "C" int repaq_pe_encode_pairs(void* seq, void* qual, int L,
                                     long long pairs, long long n_pairs,
                                     int shift, int search, void* ov,
                                     void* stream) {
  if (pairs <= 0) return 0;
  int tile = 0, nbuf = 0;
  encode_shape(L, &tile, &nbuf);
  const bool long_rows = tile == 0;
  const size_t smem = long_rows ? 16 * 2 * row_vecs(L)
                                : encode_layout(tile, L).bytes(nbuf);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel =
      long_rows ? reinterpret_cast<const void*>(pe_encode_long_kernel)
                : reinterpret_cast<const void*>(pe_encode_kernel);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = 0;
  err = wave_blocks(kernel, smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = long_rows ? pairs : (pairs + tile - 1) / tile;
  if (blocks > tiles) blocks = tiles;
  auto* s = static_cast<uint8_t*>(seq);
  auto* q = static_cast<uint8_t*>(qual);
  auto* o = static_cast<int32_t*>(ov);
  const auto st = static_cast<cudaStream_t>(stream);
  if (long_rows) {
    pe_encode_long_kernel<<<static_cast<unsigned>(blocks), kPairThreads,
                            smem, st>>>(s, q, L, pairs, n_pairs, shift,
                                        search, o);
  } else {
    pe_encode_kernel<<<static_cast<unsigned>(blocks), kPairThreads, smem,
                       st>>>(s, q, L, pairs, n_pairs, shift, search, tile,
                             nbuf, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// stored: n_stored bytes (>= 1), 16-byte aligned; qual: (rows, L) uint8,
// contiguous, 16-byte aligned; tables: (4, rows) int32 contiguous, or null;
// nbq: the quality byte that restores 'N', or -1 for none; out: 2 * rows *
// L bytes. Returns the CUDA error of the launch.
extern "C" int repaq_pe_decode_rows(const void* stored, int n_stored,
                                    const void* qual, const void* tables,
                                    long long rows, int L, int nbq, void* out,
                                    void* stream) {
  if (rows <= 0) return 0;
  int tile = 0, nbuf = 0;
  decode_shape(L, tables != nullptr, &tile, &nbuf);
  const auto* st = static_cast<const uint8_t*>(stored);
  const auto* qu = static_cast<const uint8_t*>(qual);
  const auto* tab = static_cast<const int32_t*>(tables);
  auto* o = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (tile == 0) {
    const void* kernel = reinterpret_cast<const void*>(pe_decode_direct_kernel);
    long long blocks = 0;
    const cudaError_t err = wave_blocks(kernel, 0, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long items = rows * ((L + kPiece - 1) / kPiece);
    const long long need =
        (items + kPairThreads / 32 - 1) / (kPairThreads / 32);
    if (blocks > need) blocks = need;
    pe_decode_direct_kernel<<<static_cast<unsigned>(blocks), kPairThreads, 0,
                              s>>>(st, n_stored, qu, tab, rows, L, nbq, o);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = decode_layout(tile, L, tab != nullptr).bytes(nbuf);
  const void* kernel = reinterpret_cast<const void*>(pe_decode_kernel);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = 0;
  err = wave_blocks(kernel, smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (rows + 2LL * tile - 1) / (2LL * tile);
  if (blocks > tiles) blocks = tiles;
  pe_decode_kernel<<<static_cast<unsigned>(blocks), kPairThreads, smem, s>>>(
      st, n_stored, qu, tab, rows, L, nbq, tile, nbuf, o);
  return static_cast<int>(cudaGetLastError());
}
