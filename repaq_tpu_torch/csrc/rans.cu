// Interleaved-rANS encode, payload layout and decode for Hopper (sm_90a):
// the `.rfqz` second entropy stage.
//
// Replaces: the two lax.scan loops of repaq_tpu/ops/rans_device.py,
// `rans_encode_device` (scan at :152, with the payload sort of
// `rans_encode_payload_device` :158) and `rans_decode_device` (scan at
// :330). Those were XLA code, not Pallas kernels. The coder is the host
// oracle's (repaq_tpu/codec/rans_np.py): 32-bit state, 16-bit
// renormalisation, 12-bit scale, so a lane emits or reads at most one
// 16-bit word per symbol. Lane i codes its own contiguous slice
// [off[i], off[i+1]) of the section (rans_np.lane_slices, ragged lanes
// included), and the order-1 context is the previous byte of the same
// lane (0 for the lane's first byte).
//
// What bounds it on the card: latency. A section has at most 4096 lanes,
// so at most 4096 threads (32 blocks of 128) run one serial chain each,
// with four warps an SM and nothing to hide a dependent instruction's
// latency behind. The bytes moved are a few times the section. The design
// keeps loads off each lane's chain where the coder allows: encode and
// layout load a batch of kUnroll steps at once (their loads do not depend
// on the state); decode reads a symbol and its table entry from one slot
// index and loads the next payload word before it knows it needs it. The
// order-0 tables sit in shared memory; the order-1 ones (64 Ki entries of
// freq | cum << 16 for encode, 1 Mi slots of symbol and entry for decode)
// stay in global memory, read through L1/L2. Batching sections, so that
// more than 32 SMs work, is later work.
//
// rans_encode writes, per step k of lane i (k = 0 codes the lane's last
// byte), the word x & 0xFFFF and whether it was emitted, at k * lanes + i:
// the (steps, lanes) layout of the JAX scan's outputs. Steps past a ragged
// lane's end hold 0. rans_layout then writes each lane's final state (4
// bytes LE) and its emitted words in decode order (steps walked backwards,
// high byte first) from the lane's start in the payload, so no sort is
// needed: every destination is written once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kScaleBits = 12;
constexpr uint32_t kScaleMask = (1u << kScaleBits) - 1;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kThreads = 128;
constexpr int kUnroll = 8;  // steps whose loads are issued together

// One encoder step on the table entry e = freq | cum << 16.
__device__ __forceinline__ void encode_step(uint32_t& x, uint32_t e,
                                            long long slot,
                                            uint16_t* __restrict__ words,
                                            uint8_t* __restrict__ emits) {
  const uint32_t f = e & 0xFFFFu;
  const bool emit = (x >> 20) >= f;  // x >= f << 20, without overflow
  words[slot] = static_cast<uint16_t>(x & 0xFFFFu);
  emits[slot] = emit;
  if (emit) x >>= 16;
  x = ((x / f) << kScaleBits) + (x % f) + (e >> 16);
}

// The table loads of a step depend on the data only, not on the state, so
// each batch of kUnroll steps loads its bytes and entries first and then
// runs the state chain: the loads overlap instead of each step waiting on
// its own.
template <int kOrder>
__global__ void rans_encode_kernel(const uint8_t* __restrict__ data,
                                   const long long* __restrict__ off,
                                   int lanes, const uint32_t* __restrict__ fc,
                                   long long steps,
                                   uint16_t* __restrict__ words,
                                   uint8_t* __restrict__ emits,
                                   long long* __restrict__ final_state) {
  __shared__ uint32_t fc0[256];
  if (kOrder == 0) {
    for (int s = threadIdx.x; s < 256; s += blockDim.x) fc0[s] = fc[s];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const long long begin = off[i];
  const long long len = off[i + 1] - begin;
  const long long last = begin + len - 1;  // step k codes data[last - k]
  uint32_t x = kRansL;
  long long k = 0;
  for (; k + kUnroll <= len; k += kUnroll) {
    uint32_t b[kUnroll + 1];
#pragma unroll
    for (int j = 0; j <= kUnroll; ++j) {
      const long long p = last - k - j;
      b[j] = p >= begin ? data[p] : 0u;  // b[kUnroll]: the context only
    }
    uint32_t e[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      e[j] = kOrder == 0 ? fc0[b[j]] : __ldg(fc + ((b[j + 1] << 8) | b[j]));
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      encode_step(x, e[j], (k + j) * lanes + i, words, emits);
    }
  }
  for (; k < len; ++k) {
    const long long p = last - k;
    const uint32_t s = data[p];
    const uint32_t prev = p > begin ? data[p - 1] : 0u;
    const uint32_t e = kOrder == 0 ? fc0[s] : __ldg(fc + ((prev << 8) | s));
    encode_step(x, e, k * lanes + i, words, emits);
  }
  for (; k < steps; ++k) {
    const long long slot = k * lanes + i;
    words[slot] = 0;
    emits[slot] = 0;
  }
  final_state[i] = x;
}

// Walks the lane's steps backwards, kUnroll at a time with the loads of a
// batch issued together, since only the write position depends on the
// previous step.
__global__ void rans_layout_kernel(const uint16_t* __restrict__ words,
                                   const uint8_t* __restrict__ emits,
                                   const long long* __restrict__ final_state,
                                   const long long* __restrict__ start,
                                   int lanes, long long steps,
                                   uint8_t* __restrict__ payload,
                                   long long cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  long long pos = start[i];
  const uint32_t x = static_cast<uint32_t>(final_state[i]);
  for (int b = 0; b < 4; ++b, ++pos) {
    if (pos < cap) payload[pos] = static_cast<uint8_t>(x >> (8 * b));
  }
  for (long long k = steps - 1; k >= 0; k -= kUnroll) {
    uint32_t em[kUnroll], w[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long slot = (k - j) * lanes + i;
      em[j] = k - j >= 0 ? emits[slot] : 0u;
      w[j] = k - j >= 0 ? words[slot] : 0u;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (!em[j]) continue;
      if (pos < cap) payload[pos] = static_cast<uint8_t>(w[j] >> 8);
      if (pos + 1 < cap) payload[pos + 1] = static_cast<uint8_t>(w[j]);
      pos += 2;
    }
  }
}

// fcs[ctx * SCALE + slot] is the entry freq | cum << 16 of the symbol at
// that slot, so the symbol and its entry load together, and the next
// payload word is loaded before the state says whether it is needed: one
// memory latency per step. Reads stay inside [lane_start[i],
// min(lane_start[i+1], plen)), so a corrupt payload cannot make a lane
// read out of bounds.
template <int kOrder>
__global__ void rans_decode_kernel(const uint8_t* __restrict__ payload,
                                   long long plen,
                                   const long long* __restrict__ lane_start,
                                   const long long* __restrict__ off,
                                   int lanes,
                                   const uint8_t* __restrict__ sym_lut,
                                   const uint32_t* __restrict__ fcs,
                                   uint8_t* __restrict__ out) {
  __shared__ uint8_t sym0[kOrder == 0 ? 1 << kScaleBits : 1];
  __shared__ uint32_t fcs0[kOrder == 0 ? 1 << kScaleBits : 1];
  if (kOrder == 0) {
    for (int s = threadIdx.x; s < (1 << kScaleBits); s += blockDim.x) {
      sym0[s] = sym_lut[s];
      fcs0[s] = fcs[s];
    }
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  long long ptr = lane_start[i];
  const long long lane_end =
      lane_start[i + 1] < plen ? lane_start[i + 1] : plen;
  uint32_t x = 0;
  for (int b = 0; b < 4; ++b, ++ptr) {
    if (ptr < lane_end) x |= static_cast<uint32_t>(payload[ptr]) << (8 * b);
  }
  uint32_t prev = 0;
  const long long end = off[i + 1];
  for (long long p = off[i]; p < end; ++p) {
    const bool more = ptr + 1 < lane_end;
    const uint32_t word =
        more ? (static_cast<uint32_t>(payload[ptr]) << 8) | payload[ptr + 1]
             : 0u;
    const uint32_t slot = x & kScaleMask;
    uint32_t s, e;
    if (kOrder == 0) {
      s = sym0[slot];
      e = fcs0[slot];
    } else {
      const uint32_t at = (prev << kScaleBits) | slot;
      s = __ldg(sym_lut + at);
      e = __ldg(fcs + at);
    }
    x = (e & 0xFFFFu) * (x >> kScaleBits) + slot - (e >> 16);
    if (x < kRansL && more) {
      x = (x << 16) | word;
      ptr += 2;
    }
    out[p] = static_cast<uint8_t>(s);
    prev = s;
  }
}

unsigned blocks_for(int lanes) {
  return static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int repaq_rans_encode(const void* data, const void* off, int lanes,
                                 const void* fc, int order, long long steps,
                                 void* words, void* emits, void* final_state,
                                 void* stream) {
  auto* kernel = order == 0 ? rans_encode_kernel<0> : rans_encode_kernel<1>;
  kernel<<<blocks_for(lanes), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const long long*>(off),
      lanes, static_cast<const uint32_t*>(fc), steps,
      static_cast<uint16_t*>(words), static_cast<uint8_t*>(emits),
      static_cast<long long*>(final_state));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repaq_rans_layout(const void* words, const void* emits,
                                 const void* final_state, const void* start,
                                 int lanes, long long steps, void* payload,
                                 long long cap, void* stream) {
  rans_layout_kernel<<<blocks_for(lanes), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(words), static_cast<const uint8_t*>(emits),
      static_cast<const long long*>(final_state),
      static_cast<const long long*>(start), lanes, steps,
      static_cast<uint8_t*>(payload), cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repaq_rans_decode(const void* payload, long long plen,
                                 const void* lane_start, const void* off,
                                 int lanes, const void* sym_lut,
                                 const void* fcs, int order, void* out,
                                 void* stream) {
  auto* kernel = order == 0 ? rans_decode_kernel<0> : rans_decode_kernel<1>;
  kernel<<<blocks_for(lanes), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), plen,
      static_cast<const long long*>(lane_start),
      static_cast<const long long*>(off), lanes,
      static_cast<const uint8_t*>(sym_lut), static_cast<const uint32_t*>(fcs),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
