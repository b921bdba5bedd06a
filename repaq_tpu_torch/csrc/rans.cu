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
// What bounds rans_encode on the card: each lane's state chain. A lane
// codes its bytes one after another, and one step is a chain of six
// dependent instructions (cuobjdump -sass: ISETP, the predicated SHF of
// the renormalisation, the IMAD.MOV that places x beside umulhi's addend,
// IMAD.HI, SHF, IMAD), 36.9 cycles on an NVIDIA H100 80GB HBM3
// (tools/rans_chain_probe.cu). The longest lane's steps times that, at the
// card's 1,980 MHz, is a floor no schedule of this step beats: 0.0208 ms
// for an order-1 section of 2,285,523 bytes in 2048 lanes (1,116 steps),
// 0.0728 ms for 16,000,000 bytes in 4096 lanes (3,907 steps), where the
// bytes moved take 0.003 and 0.019 ms. The design keeps all else off the
// chain: the division is a multiply by a reciprocal (rans_device.
// rcp_table); each lane's bytes are staged in shared memory a window
// ahead by cp.async; a step's loads (its bytes, the order-1 entry in
// global memory, the reciprocal or the order-0 symbol in shared memory)
// run one to three batches ahead of the chain, each on inputs that landed
// an iteration earlier; 64-lane blocks put one warp on each scheduler of
// 32-64 SMs. What is left above the floor are the two stores of each step
// and its loads' instructions (tools/profile_rans.py).
//
// rans_layout and rans_decode are bound by latency too: at most 4096
// threads (32 blocks of 128) run one serial chain each. Layout loads a
// batch of kUnroll steps at once; decode reads a symbol and its table
// entry from one slot index and loads the next payload word before it
// knows it needs it. Decode's order-0 tables sit in shared memory, its
// order-1 ones (1 Mi slots of symbol and entry) in global memory, read
// through L1/L2. Batching sections, so that more than 32 SMs work, is
// later work.
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

// rans_encode's shape: kEncThreads lanes a block, each lane's next
// kWindow steps staged in shared memory while the current ones are coded,
// and batches of kBatch steps whose loads run ahead of the chain. The
// -D switches exist for tools/profile_rans.py's sweep; the defaults are the
// sweep's fastest on the card.
#ifndef REPAQ_RANS_THREADS
#define REPAQ_RANS_THREADS 64
#endif
#ifndef REPAQ_RANS_WINDOW
#define REPAQ_RANS_WINDOW 1024
#endif
#ifndef REPAQ_RANS_BATCH
#define REPAQ_RANS_BATCH 16
#endif
constexpr int kEncThreads = REPAQ_RANS_THREADS;
constexpr int kWindow = REPAQ_RANS_WINDOW;
constexpr int kBatch = REPAQ_RANS_BATCH;
// a lane's row: kSlack bytes (the zero context before a lane's first byte
// may land there, and a batch that starts at the window's last step reads
// up to kBatch bytes below the window), then the 16-byte aligned cover of
// the window and the context byte before it, at most kWindow + 32 bytes
constexpr int kSlack = kBatch > 16 ? (kBatch + 15) / 16 * 16 : 16;
constexpr int kRow = kSlack + kWindow + 32;
constexpr int kRcpRows = (1 << kScaleBits) + 1;  // row f for f in 1..4096
static_assert(kWindow % kBatch == 0 && kWindow % 16 == 0,
              "a window holds whole batches and whole 16-byte chunks");
static_assert(kEncThreads % 32 == 0, "whole warps");

size_t encode_smem_bytes(int order) {
  return 2 * kEncThreads * kRow +
         (order == 0 ? 256 * sizeof(uint4) : kRcpRows * sizeof(uint2));
}

// What a step needs of its symbol: the entry e = freq | cum << 16 and the
// reciprocal of freq, q = (x + umulhi(x, m)) >> l (rans_device.rcp_table).
struct Sym {
  uint32_t e, m, l;
};

// One encoder step, with no division: emit the low word if x >= f << 20,
// then x' = ((x / f) << 12) + x % f + c, written x + c + q * (4096 - f).
// The 32-bit sum x + umulhi(x, m) cannot wrap: after renormalisation
// x < f << 20, so it stays below 2^(20 + l) <= 2^32
// (tests/test_torch_rans.py proves this and the quotient for every f).
__device__ __forceinline__ uint32_t encode_step(uint32_t x, Sym s,
                                                uint16_t* w, uint8_t* em) {
  const uint32_t f = s.e & 0xFFFFu;
  // f = 4096 wraps to 2^32 - 1: such a symbol never emits
  const bool emit = x > (f << 20) - 1u;
  *w = static_cast<uint16_t>(x & 0xFFFFu);
  *em = emit;
  if (emit) x >>= 16;
  const uint32_t q = (x + __umulhi(x, s.m)) >> s.l;
  return x + (s.e >> 16) + q * ((1u << kScaleBits) - f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Window t of a lane [begin, end): it codes steps [t * kWindow, t * kWindow
// + n) on bytes [lo, hi), hi = end - t * kWindow, and reads the context
// byte before lo. The row holds 16-byte chunks c0.. of the aligned data
// (abase = data - a0), so the byte of the window's step j sits at
// row + kSlack + u0 - j.
struct Window {
  long long lo, hi, c0;
  int n, u0;
};

__device__ __forceinline__ Window window_of(long long begin, long long end,
                                            long long t, int a0) {
  Window w;
  w.hi = end - t * kWindow;
  w.lo = w.hi - kWindow > begin ? w.hi - kWindow : begin;
  w.n = w.hi > w.lo ? static_cast<int>(w.hi - w.lo) : 0;
  const long long ctx = w.lo > begin ? w.lo - 1 : w.lo;
  w.c0 = (ctx + a0) >> 4;
  w.u0 = static_cast<int>(w.hi - 1 + a0 - 16 * w.c0);
  return w;
}

// The lane's own row of window t: asynchronous 16-byte copies of the
// chunks from the one holding the context byte to the one holding hi - 1.
// Each chunk holds a byte of the section, so no copy leaves its allocation.
__device__ __forceinline__ void stage_row(uint8_t* row,
                                          const uint8_t* abase,
                                          const Window& w, int a0) {
  if (w.n == 0) return;
  const int chunks = static_cast<int>(((w.hi - 1 + a0) >> 4) - w.c0) + 1;
  const uint8_t* src = abase + 16 * w.c0;
  for (int c = 0; c < chunks; ++c) {
    cp_async16(row + kSlack + 16 * c, src + 16 * c);
  }
}

// A batch's symbols come in three stages, each from the one before: its
// bytes from the staged row (order-1: the context byte too), then the
// order-1 entries from the table in global memory, then the reciprocals
// (order-0: the whole symbol) from shared memory. None depends on the
// state, so the batch loop runs each stage on a later batch than the one
// it codes, and every load's input landed an iteration earlier.
template <int kOrder>
__device__ __forceinline__ void batch_bytes(uint32_t (&r)[kBatch],
                                            const uint8_t* at) {
  uint32_t b[kBatch + 1];
#pragma unroll
  for (int u = 0; u < kBatch + kOrder; ++u) b[u] = at[-u];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) r[u] = kOrder ? b[u + 1] << 8 | b[u] : b[u];
}

template <int kOrder>
__device__ __forceinline__ void batch_keys(uint32_t (&k)[kBatch],
                                           const uint32_t (&r)[kBatch],
                                           const uint32_t* __restrict__ fc) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) k[u] = kOrder ? __ldg(fc + r[u]) : r[u];
}

template <int kOrder>
__device__ __forceinline__ void batch_syms(Sym (&s)[kBatch],
                                           const uint32_t (&k)[kBatch],
                                           const uint4* sym0,
                                           const uint2* rcp) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (kOrder == 0) {
      const uint4 v = sym0[k[u]];
      s[u] = {v.x, v.y, v.z};
    } else {
      const uint2 r = rcp[k[u] & 0xFFFFu];
      s[u] = {k[u], r.x, r.y};
    }
  }
}

// One thread a lane. Lane i's bytes [b, b + q + (i < r)), b = i q + min(i,
// r), q = n / lanes, r = n % lanes (rans_np.lane_slices), are coded from
// the last one back in windows of kWindow steps: the block stages window t + 1
// of every lane into one half of its shared memory with cp.async while it
// codes window t from the other half. Per step k of lane i, the word x &
// 0xFFFF before the step and the emit flag go to k * lanes + i (steps past
// the lane's end write 0), and the final state to final_state[i].
template <int kOrder>
__global__ void __launch_bounds__(kEncThreads)
    rans_encode_kernel(const uint8_t* __restrict__ data, long long n,
                       int lanes,
                       const uint32_t* __restrict__ fc,
                       const uint2* __restrict__ rcp, long long steps,
                       uint16_t* __restrict__ words,
                       uint8_t* __restrict__ emits,
                       long long* __restrict__ final_state) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const rows = smem;  // [2][kEncThreads][kRow]
  uint4* const sym0 = reinterpret_cast<uint4*>(smem + 2 * kEncThreads * kRow);
  uint2* const rcp_s = reinterpret_cast<uint2*>(smem + 2 * kEncThreads * kRow);
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kEncThreads + tid;
  const bool active = i < lanes;
  const int a0 = static_cast<int>(reinterpret_cast<uintptr_t>(data) & 15);
  const uint8_t* const abase = data - a0;
  const long long q = n / lanes, r = n % lanes;
  const long long begin = active ? i * q + (i < r ? i : r) : 0;
  const long long end = active ? begin + q + (i < r ? 1 : 0) : 0;
  uint8_t* const my_row = rows + tid * kRow;
  constexpr int kHalf = kEncThreads * kRow;

  // the tables, then window 0, in the first copy group
  if (kOrder == 0) {
    for (int s = tid; s < 256; s += kEncThreads) {
      const uint32_t e = fc[s];
      const uint2 r = rcp[e & 0xFFFFu];
      sym0[s] = make_uint4(e, r.x, r.y, 0u);
    }
  } else {
    for (int c = tid; c < (kRcpRows - 1) / 2; c += kEncThreads) {
      cp_async16(rcp_s + 2 * c, rcp + 2 * c);
    }
    if (tid == 0) rcp_s[kRcpRows - 1] = rcp[kRcpRows - 1];
  }
  const long long windows = (steps + kWindow - 1) / kWindow;
  if (windows > 0) stage_row(my_row, abase, window_of(begin, end, 0, a0), a0);
  cp_async_commit();

  uint32_t x = kRansL;
  for (long long t = 0; t < windows; ++t) {
    if (t + 1 < windows) {
      stage_row(my_row + ((t + 1) & 1) * kHalf, abase,
                window_of(begin, end, t + 1, a0), a0);
    }
    cp_async_commit();
    cp_async_wait_but_one();  // window t (and the tables) have landed
    __syncthreads();
    if (active) {
      const Window w = window_of(begin, end, t, a0);
      uint8_t* const at = my_row + (t & 1) * kHalf + kSlack + w.u0;
      // the context of the lane's first byte is 0
      if (kOrder == 1 && w.n > 0 && w.lo == begin) at[-w.n] = 0;
      const long long k0 = t * kWindow;
      uint16_t* wp = words + k0 * lanes + i;
      uint8_t* ep = emits + k0 * lanes + i;
      if (w.n > 0) {
        // a batch past the window's end reads from its last step on: the
        // bytes stay in the row and are never coded
        const int last = w.n - 1;
        auto from = [&](int j) { return at - (j < last ? j : last); };
        uint32_t raw[kBatch], key[kBatch];
        Sym cur[kBatch];
        batch_bytes<kOrder>(raw, from(0));
        batch_keys<kOrder>(key, raw, fc);
        batch_syms<kOrder>(cur, key, sym0, rcp_s);
        batch_bytes<kOrder>(raw, from(kBatch));
        batch_keys<kOrder>(key, raw, fc);
        batch_bytes<kOrder>(raw, from(2 * kBatch));
        int j = 0;
        for (; j + kBatch <= w.n; j += kBatch) {
          uint32_t key2[kBatch];
          Sym nxt[kBatch];
          // the batches after this one: keys of the second, bytes of the
          // third, symbols of the first
          batch_keys<kOrder>(key2, raw, fc);
          batch_bytes<kOrder>(raw, from(j + 3 * kBatch));
          batch_syms<kOrder>(nxt, key, sym0, rcp_s);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            x = encode_step(x, cur[u], wp, ep);
            wp += lanes;
            ep += lanes;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            cur[u] = nxt[u];
            key[u] = key2[u];
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {  // the lane's last steps
          if (j + u < w.n) {
            x = encode_step(x, cur[u], wp, ep);
            wp += lanes;
            ep += lanes;
          }
        }
      }
      const long long stop = k0 + kWindow < steps ? k0 + kWindow : steps;
      for (long long k = k0 + w.n; k < stop; ++k) {  // past the lane's end
        *wp = 0;
        *ep = 0;
        wp += lanes;
        ep += lanes;
      }
    }
    __syncthreads();  // this half is read; window t + 2 may overwrite it
  }
  if (active) final_state[i] = x;
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

extern "C" int repaq_rans_encode(const void* data, long long n, int lanes,
                                 const void* fc, const void* rcp, int order,
                                 long long steps, void* words, void* emits,
                                 void* final_state, void* stream) {
  auto* kernel = order == 0 ? rans_encode_kernel<0> : rans_encode_kernel<1>;
  const size_t smem = encode_smem_bytes(order);
  // the shared-memory limit is raised once per device and order: the call
  // costs more host time than a launch
  static bool raised[2][64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !raised[order != 0][dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[order != 0][dev] = true;
  }
  const unsigned blocks =
      static_cast<unsigned>((lanes + kEncThreads - 1) / kEncThreads);
  kernel<<<blocks, kEncThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, lanes,
      static_cast<const uint32_t*>(fc),
      static_cast<const uint2*>(rcp), steps, static_cast<uint16_t*>(words),
      static_cast<uint8_t*>(emits), static_cast<long long*>(final_state));
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long repaq_rans_encode_window() { return kWindow; }

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
