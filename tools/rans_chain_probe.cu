// The dependent chains of rans_encode's and rans_decode's state steps, timed
// alone on the card: one thread runs `steps` steps of csrc/rans.cu's
// encode_step on symbols held in registers (no loads on the chain; its word
// and emit stores go to shared memory), or of its decode_step, whose table
// entry and payload word are loaded on the chain; clock64() around the loop
// gives the cycles a step. Built by tools/profile_rans.py with the
// package's nvcc flags.

#include "../repaq_tpu_torch/csrc/rans.cu"

namespace {

__global__ void chain_probe_kernel(const uint4* __restrict__ syms, int steps,
                                   long long* __restrict__ cycles,
                                   uint32_t* __restrict__ out) {
  __shared__ uint16_t w[32];
  __shared__ uint8_t em[32];
  Sym s[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) s[u] = {syms[u].x, syms[u].y, syms[u].z};
  uint32_t x = kRansL;
  const long long t0 = clock64();
  for (int k = 0; k < steps; k += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      x = encode_step(x, s[u], w + threadIdx.x, em + threadIdx.x);
    }
  }
  const long long t1 = clock64();
  out[threadIdx.x] = x;
  cycles[threadIdx.x] = t1 - t0;
}

// decode_step with the payload ring in shared memory, filled from `words`
// (kDecRing bytes), and a packed table (rans_device.decode_table): one row
// and its syms copied into shared memory (order-0, the shared route), or
// 256 rows read from global memory (order-1, the global route). The state
// starts at x0.
template <bool kShared>
__global__ void decode_probe_kernel(const uint32_t* __restrict__ table,
                                    const uint8_t* __restrict__ syms,
                                    const uint8_t* __restrict__ words,
                                    uint32_t x0, int steps,
                                    long long* __restrict__ cycles,
                                    uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t tab_s[kShared ? 1 << kScaleBits : 1];
  __shared__ __align__(16) uint8_t syms_s[kShared ? 1 << kScaleBits : 1];
  __shared__ __align__(16) uint8_t ring[kDecRing];
  if (kShared) {
    for (int k = 0; k < (1 << kScaleBits); ++k) {
      tab_s[k] = table[k];
      syms_s[k] = syms[k];
    }
  }
  for (int k = 0; k < kDecRing; ++k) ring[k] = words[k];
  __syncthreads();
  const uint32_t* const tab = kShared ? tab_s : table;
  const uint8_t* const sym = syms_s;
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(
      ring));
  uint32_t x = x0, kb = (x0 & kScaleMask) << 2, at = 0, lim = kRansL;
  uint32_t left = 0xFFFFFFFFu, acc = 0;
  const long long t0 = clock64();
  for (int j = 0; j < steps; j += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      acc += decode_step<kShared, true>(x, kb, at, lim, left, tab, sym,
                                        ring_s);
    }
  }
  const long long t1 = clock64();
  out[threadIdx.x] = x ^ acc;
  cycles[threadIdx.x] = t1 - t0;
}

}  // namespace

// syms: 8 x (e, m, l, 0) uint32; one block of one thread
extern "C" int repaq_rans_chain_probe(const void* syms, int steps,
                                      void* cycles, void* out, void* stream) {
  chain_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(syms), steps,
      static_cast<long long*>(cycles), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// table: rows x 4096 packed entries (rows == 1: shared, order-0, with
// syms, its slots' symbols; else global, order-1, 256 rows, syms null);
// words: kDecRing payload bytes; one block of one thread
extern "C" int repaq_rans_decode_chain_probe(const void* table,
                                             const void* syms, int rows,
                                             const void* words, int x0,
                                             int steps, void* cycles,
                                             void* out, void* stream) {
  auto* kernel = rows == 1 ? decode_probe_kernel<true>
                           : decode_probe_kernel<false>;
  kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), static_cast<const uint8_t*>(syms),
      static_cast<const uint8_t*>(words), static_cast<uint32_t>(x0), steps,
      static_cast<long long*>(cycles), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// the probe's ring size: profile_rans.py fills it
extern "C" int repaq_rans_decode_probe_ring() { return kDecRing; }
