// Exact PE mate-overlap search for Hopper (sm_90a).
//
// Replaces: XLA code of the JAX package, not a Pallas kernel: the double
// polynomial hash search of repaq_tpu/ops/device_streams.py,
// `overlap_pairs_device` (:1369) with its hashes (:1316, :1333), its
// first candidate (:1345) and its exact check (:1358).
//
// For each pair p, with minlen = min(L1, L2), it gives the reference's
// first-match overlap (rfqcodec.cpp:1391-1438):
//   +o for the smallest o in [12, minlen] with r1[p, L1-o:] == r2[p, :o];
//   else -o for the smallest such o with r2[p, L2-o:] == r1[p, :o];
//   else 0 (also whenever minlen < 12).
// Bytes compare raw, all 256 values ('N' included). The search is exact,
// so no candidate ever needs the host's search to confirm it.
//
// What bounds it on the card: memory, in principle. A pair's two rows are
// read once and one int32 is written: 304 bytes a pair of 150 bp reads,
// 14.9 MB for a PE chunk's 49,152 pairs, 4.5 us at 3.35 TB/s. In practice
// latency does (PERF.md): each pair is one warp's chain of a load from
// memory, shared-memory reads and warp votes, so the time is set by the
// chain's length and by how many warps an SM keeps in flight. At 150 bp
// there are 139 candidates a direction; the design spends few
// instructions on each, and keeps every lane at work when it verifies.
//
// The design: one warp a pair, up to 8 pairs a block.
//   1. Staging. The warp copies both rows to shared memory as the aligned
//      16-byte vectors that hold them, one vector a lane (a row may start
//      at any byte and rows lie any stride apart, so the engine's views of
//      the odd and even rows of one grid are read as they are). A vector
//      that holds a byte of the row lies in the row's memory page, so the
//      bytes read around the row are never a fault, and never compared.
//   2. Filter. A candidate o puts a's suffix at byte s = La - o, so the
//      candidates are the starts s in [La - minlen, La - 12] whose four
//      bytes equal b's first four. Each lane takes two aligned words of
//      a, the 8 starts in them, from two loads and 8 funnel shifts by
//      constant amounts: a warp filters 256 candidates a round, so one
//      round covers reads of up to ~250 bp.
//   3. Verification, in order of o. The round's hits are ordered by lane,
//      then by bit (both by increasing o); __ballot_sync and __ffs take the
//      next, and the whole warp compares its o bytes, a word a lane, and
//      agrees by __all_sync. The first that holds is the answer. Over
//      random bases a candidate passes the filter with odds 1/256, so a
//      pair verifies about one candidate beyond its true overlap.
// Forward runs first, and the backward direction only when forward found
// none; every branch is the same in all lanes of the warp. The worst case,
// a row built so that every candidate fails its last byte (A..AC against
// A..AG), verifies 139 candidates a direction: microseconds for the one
// warp that meets it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMinOverlap = 12;  // the reference's MIN_OVERLAP
constexpr int kMaxWarps = 8;     // pairs a block
// blocks an SM the registers must allow: 6 keeps the kernel to 40
// registers (48 warps an SM), where the compiler would take 64 (32 warps);
// the pairs' loads then have more warps to hide behind
constexpr int kMinBlocks = 6;
constexpr int kWordsPerLane = 2;  // filter words a lane and round
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // a block's limit on sm_90

// 16-byte vectors a staged row of len bytes may take: the vectors that
// hold the row from any start within a vector, and one spare, so that a
// word read at any byte of the row stays inside
__host__ __device__ inline int row_vecs(int len) { return (len + 30) / 16 + 1; }

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
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        overlap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (pairs + warps - 1) / warps;
  overlap_kernel<<<static_cast<unsigned>(blocks), warps * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(r1), stride1, l1,
      static_cast<const uint8_t*>(r2), stride2, l2, pairs,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
