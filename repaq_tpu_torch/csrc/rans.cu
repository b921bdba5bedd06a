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
// rans_decode is bound by latency too: each lane decodes its bytes one
// after another, and a step is a chain of a table load and four integer
// instructions (decode_step: the entry's freq - 1, y, the compare, the
// select of the next entry's offset), about 59 cycles on an NVIDIA H100
// 80GB HBM3 with the table in shared memory and about 325 read from
// global memory (tools/rans_chain_probe.cu). The design keeps the chain's loads in
// shared memory and all else off it: each lane's payload is staged a
// window ahead by cp.async into a ring, so the next 16-bit word is one
// shared load beside the table's; the table is packed per live context
// (rans_device.decode_table: one u32 an entry that carries freq - 1,
// slot - cum and the next context's row), in shared memory with each
// slot's symbol when at most kSharedRows contexts are live, else all 256
// rows read from global memory, one load a step, the row being the
// context byte, so that the entry's next row is the output byte; each
// lane's decoded bytes
// are staged in shared memory and copied out at each window's end as
// contiguous runs, a warp a lane; 32-lane blocks, each warp on its own,
// put 2048 lanes on 64 SMs and 4096 on 128. What is left above the chain
// is its shared loads' bank conflicts, 32 lanes at random slots, and each
// window's copies (tools/profile_rans.py --decode).
//
// rans_layout, in place of the payload sort, is a transpose and a
// per-lane compaction, with no chain: what bounds it is memory, 3 bytes
// read a (step, lane) and 2 written an emitted word. It works in
// tiles of kTileSteps steps x kTileLanes lanes, one block a tile, so that
// an order-1 section of 2048 lanes makes 320 blocks and an order-0 one of
// 4096 lanes 2048 (rans_layout_kernel). On an NVIDIA H100 most of its time
// is the staging of words and emits from device memory; the compaction,
// the copy-out and the wait for the counts of the tiles above take the
// rest (tools/profile_rans.py --layout --ablate).
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

// rans_layout's tile: kTileSteps steps x kTileLanes lanes a block. The -D
// switches exist for tools/profile_rans.py's layout sweep; the defaults are
// its fastest on the card.
#ifndef REPAQ_LAYOUT_STEPS
#define REPAQ_LAYOUT_STEPS 256
#endif
#ifndef REPAQ_LAYOUT_LANES
#define REPAQ_LAYOUT_LANES 32
#endif
constexpr int kTileSteps = REPAQ_LAYOUT_STEPS;
constexpr int kTileLanes = REPAQ_LAYOUT_LANES;
constexpr int kLayoutThreads = 256;
constexpr int kLayoutWarps = kLayoutThreads / 32;
constexpr int kParts = kLayoutThreads / kTileLanes;  // threads a lane
constexpr int kGroups = kTileSteps / 32;  // 32-step groups a tile
constexpr int kWordVecs = kTileLanes / 8;   // 16-byte vectors a words row
constexpr int kEmitVecs = kTileLanes / 16;  // and an emits row
// a lane's slot of the tile's output: at most kTileSteps words, then 2
// more, so that the slots of consecutive lanes start in other banks
constexpr int kSlot = kTileSteps + 2;
constexpr int kLook = 8;  // status words a thread loads at once
constexpr uint32_t kReady = 1u << 31;
static_assert(kTileSteps % 32 == 0 && kTileLanes % 32 == 0 &&
                  kLayoutThreads % kTileLanes == 0,
              "whole groups, whole warps of lanes, whole lanes a block");
// Vector q of words row r sits at q ^ swizzle(r), so that the vectors q of
// any 8 consecutive rows fall in 8 distinct 16-byte bank groups.
constexpr int kSwizzleShift = kWordVecs >= 8 ? 0 : kWordVecs == 4 ? 1 : 2;
constexpr int kSwizzleMask = (kWordVecs >= 8 ? 8 : kWordVecs) - 1;

// [words rows][masks][words before each group][emits rows, later the
// lanes' output slots]
constexpr int kMaskOffset = kTileSteps * kTileLanes * 2;
constexpr int kRowsOffset = kMaskOffset + 2 * kGroups * kTileLanes * 4;
size_t layout_smem_bytes() {
  return kRowsOffset + kTileLanes * kSlot * 2;
}

__device__ __forceinline__ int word_at(int r, int l) {
  const int q = l / 8;
  return 8 * (r * kWordVecs + (q ^ ((r >> kSwizzleShift) & kSwizzleMask))) +
         l % 8;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A status word carries its own value (kReady | count), so relaxed
// accesses at gpu scope are enough: nothing else is published with it.
__device__ __forceinline__ void store_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t load_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ bool inside(long long pos, long long cap) {
  return pos >= 0 && pos < cap;
}

// One block a tile: steps [k0, k0 + rows) of lanes [l0, l0 + width), taken
// from the top tile down by an atomic ticket, so that a block waits only on
// blocks that have started. Per tile:
//   1. The tile's emits, then its words, are staged in shared memory by
//      16-byte cp.async copies (lanes % 16 == 0 and aligned inputs; else a
//      copy an element). Rows of words are swizzled (word_at).
//   2. Each lane's flags become one 32-bit mask a group of 32 steps, bit j
//      for the j-th step from the group's top (decode order).
//   3. A lane's words before each group of the tile are prefix sums of the
//      masks' counts; the tile's count goes at once to its status word, so
//      no block ever waits to publish.
//   4. The lane's words in the tiles above are the sum of their status
//      words: kParts threads a lane, each loading kLook words at once.
//      Then lane i's bytes of this tile start at start[i] + 4 + 2 x that.
//   5. A thread a lane and group walks the set bits of its mask and puts
//      each emitted word, high byte first, at its rank in the lane's slot
//      of shared memory, where the emits were: the tile's words are read
//      once, and only the emitted ones.
//   6. A warp a lane copies the slot to the payload, 64 contiguous bytes a
//      store instruction (byte stores where the lane's run starts odd).
// The top tile also writes each lane's final state. The wrapper zeroes the
// payload, the status words and the ticket counter in one fill.
__global__ void __launch_bounds__(kLayoutThreads)
    rans_layout_kernel(const uint16_t* __restrict__ words,
                       const uint8_t* __restrict__ emits,
                       const long long* __restrict__ final_state,
                       const long long* __restrict__ start, int lanes,
                       long long steps, int tiles, int lane_groups, bool vec,
                       uint8_t* __restrict__ payload, long long cap,
                       uint32_t* __restrict__ status,
                       unsigned* __restrict__ counter) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* const wrows = reinterpret_cast<uint16_t*>(smem);
  uint32_t* const mask =  // [group][lane], and the words before it
      reinterpret_cast<uint32_t*>(smem + kMaskOffset);
  uint32_t* const before = mask + kGroups * kTileLanes;
  uint8_t* const erows = smem + kRowsOffset;
  uint16_t* const slots = reinterpret_cast<uint16_t*>(erows);
  __shared__ long long base[kTileLanes];
  __shared__ uint32_t count[kTileLanes];
  __shared__ uint32_t part_sum[kParts][kTileLanes];
  __shared__ unsigned shared_ticket;
  const int tid = threadIdx.x;
  if (tid == 0) shared_ticket = atomicAdd(counter, 1u);
  __syncthreads();
  const int tile = tiles - 1 - static_cast<int>(shared_ticket / lane_groups);
  const int l0 = static_cast<int>(shared_ticket % lane_groups) * kTileLanes;
  const long long k0 = static_cast<long long>(tile) * kTileSteps;
  const int rows = static_cast<int>(
      steps - k0 < kTileSteps ? steps - k0 : kTileSteps);
  const int width = lanes - l0 < kTileLanes ? lanes - l0 : kTileLanes;
  const long long at0 = k0 * lanes + l0;  // row 0, lane 0 of the tile

  // 1. staging
  if (vec) {
    for (int i = tid; i < rows * kEmitVecs; i += kLayoutThreads) {
      const int r = i / kEmitVecs, q = i % kEmitVecs;
      if (16 * q < width) {
        cp_async16(erows + r * kTileLanes + 16 * q,
                   emits + at0 + static_cast<long long>(r) * lanes + 16 * q);
      }
    }
    cp_async_commit();
    for (int i = tid; i < rows * kWordVecs; i += kLayoutThreads) {
      const int r = i / kWordVecs, q = i % kWordVecs;
      if (8 * q < width) {
        cp_async16(wrows + word_at(r, 8 * q),
                   words + at0 + static_cast<long long>(r) * lanes + 8 * q);
      }
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < rows * kTileLanes; i += kLayoutThreads) {
      const int r = i / kTileLanes, l = i % kTileLanes;
      if (l < width) {
        const long long at = at0 + static_cast<long long>(r) * lanes + l;
        erows[r * kTileLanes + l] = emits[at];
        wrows[word_at(r, l)] = words[at];
      }
    }
  }
  cp_async_wait_but_one();  // the emits have landed
  __syncthreads();

  // 2. masks
  const int lane = tid % kTileLanes, part = tid / kTileLanes;
  const int groups = (rows + 31) / 32;
  if (lane < width) {
    for (int g = part; g < groups; g += kParts) {
      const int top = rows - 1 - 32 * g;
      uint32_t m = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (top - j >= 0) {
          m |= static_cast<uint32_t>(erows[(top - j) * kTileLanes + lane] != 0)
               << j;
        }
      }
      mask[g * kTileLanes + lane] = m;
    }
  }
  __syncthreads();

  // 3. the words before each group, and the tile's count published
  if (part == 0 && lane < width) {
    uint32_t n = 0;
    for (int g = 0; g < groups; ++g) {
      before[g * kTileLanes + lane] = n;
      n += __popc(mask[g * kTileLanes + lane]);
    }
    count[lane] = n;
    store_relaxed(status + static_cast<long long>(tile) * lanes + l0 + lane,
                  kReady | n);
  }

  // 4. the words of the tiles above
  uint32_t above = 0;
  if (lane < width) {
    const uint32_t* const col = status + l0 + lane;
    for (int t0 = tile + 1 + part; t0 < tiles; t0 += kParts * kLook) {
      uint32_t v[kLook];
#pragma unroll
      for (int u = 0; u < kLook; ++u) {
        const int t = t0 + u * kParts;
        v[u] = t < tiles
                   ? load_relaxed(col + static_cast<long long>(t) * lanes)
                   : kReady;
      }
#pragma unroll
      for (int u = 0; u < kLook; ++u) {
        while (!(v[u] & kReady)) {
          v[u] = load_relaxed(col +
                              static_cast<long long>(t0 + u * kParts) * lanes);
        }
        above += v[u] & ~kReady;
      }
    }
  }
  part_sum[part][lane] = above;
  cp_async_wait_all();  // the words have landed
  __syncthreads();
  if (part == 0 && lane < width) {
    long long sum = 0;
    for (int p = 0; p < kParts; ++p) sum += part_sum[p][lane];
    const long long s = start[l0 + lane];
    base[lane] = s + 4 + 2 * sum;
    if (tile == tiles - 1) {  // the final state leads the lane's bytes
      const uint32_t x = static_cast<uint32_t>(final_state[l0 + lane]);
      for (int b = 0; b < 4; ++b) {
        if (inside(s + b, cap)) {
          payload[s + b] = static_cast<uint8_t>(x >> 8 * b);
        }
      }
    }
  }

  // 5. the emitted words into the lanes' slots, a thread a lane and group
  for (int i = tid; i < groups * kTileLanes; i += kLayoutThreads) {
    const int l = i % kTileLanes, g = i / kTileLanes;
    if (l >= width) continue;
    uint32_t m = mask[g * kTileLanes + l];
    uint16_t* out = slots + l * kSlot + before[g * kTileLanes + l];
    const int top = rows - 1 - 32 * g;
    while (m) {
      const int r = top - (__ffs(m) - 1);
      m &= m - 1;
      *out++ = static_cast<uint16_t>(  // high byte first
          __byte_perm(wrows[word_at(r, l)], 0, 0x0001));
    }
  }
  __syncthreads();

  // 6. each lane's slot to the payload, a warp a lane
  const int warp = tid / 32, j = tid % 32;
  for (int l = warp; l < width; l += kLayoutWarps) {
    const long long at = base[l];
    const int n = 2 * static_cast<int>(count[l]);
    const uint16_t* const slot = slots + l * kSlot;
    if (!(at & 1)) {
      for (int k = 2 * j; k < n; k += 64) {
        if (at + k >= 0 && at + k + 1 < cap) {
          *reinterpret_cast<uint16_t*>(payload + at + k) = slot[k / 2];
        } else if (inside(at + k, cap)) {
          payload[at + k] = static_cast<uint8_t>(slot[k / 2]);
        }
      }
    } else {
      const uint8_t* const bytes = reinterpret_cast<const uint8_t*>(slot);
      for (int k = j; k < n; k += 32) {
        if (inside(at + k, cap)) payload[at + k] = bytes[k];
      }
    }
  }
}

// rans_decode's shape: 32 lanes a block, decoded by its first warp while
// its second copies the decoded bytes out; each lane's payload staged in a
// ring of kDecRing bytes (a power of two); windows of kDecWindow steps;
// order-1 tables of at most kSharedRows live contexts in shared memory. The
// -D switches exist for tools/profile_rans.py --decode's sweep; the
// defaults are its fastest on the card.
#ifndef REPAQ_DEC_RING
#define REPAQ_DEC_RING 2048
#endif
#ifndef REPAQ_DEC_SHARED_ROWS
#define REPAQ_DEC_SHARED_ROWS 6
#endif
constexpr int kDecLanes = 32;
constexpr int kDecThreads = 2 * kDecLanes;  // the decode warp, the copy warp
constexpr int kDecRing = REPAQ_DEC_RING;
constexpr int kSharedRows = REPAQ_DEC_SHARED_ROWS;
// A window reads at most 2 kDecWindow bytes, and the ring is refilled at
// each window's start up to 4 kDecWindow bytes past the lane's position:
// with the chunk that holds the position, kDecWindow / 4 + 1 chunks of 16
// bytes, the ring's.
constexpr int kDecWindow = kDecRing / 4 - 4;
constexpr int kRingChunks = kDecRing / 16;
constexpr int kRingStride = kDecRing + 16;  // lanes' rings start in other banks
// a lane's decoded bytes of a window, in an odd number of words, so that
// the lanes' bytes of one step land in 32 distinct banks; two stages, one
// written while the other is copied out
constexpr int kStageStride = 4 * (((kDecWindow + 3) / 4) | 1);
constexpr int kStageBytes = kDecLanes * kStageStride;
// a context's row: 4096 packed entries and the 4096 symbols of its slots
constexpr int kRowBytes = 5 << kScaleBits;
// a stage's runs: each lane's first output byte and count
struct DecRun {
  long long dst;
  int n, pad;
};
constexpr size_t kDecLaneBytes =
    static_cast<size_t>(kDecLanes) * kRingStride + 2 * kStageBytes +
    2 * kDecLanes * sizeof(DecRun);
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most on Hopper
constexpr uint32_t kFullMask = 0xFFFFFFFFu;
static_assert(kDecRing >= 64 && (kDecRing & (kDecRing - 1)) == 0,
              "a ring of a power of two, 64 bytes or more");
static_assert(static_cast<size_t>(kSharedRows) * kRowBytes + kDecLaneBytes <=
                  kMaxSmem,
              "the shared table, rings, stages and runs fit a block");

// shared memory: [entries of the rows][symbols of the rows] on the shared
// route, none on the global one; then [rings][stages 0 and 1][runs 0 and 1]
size_t decode_smem_bytes(int rows, bool shared) {
  return (shared ? static_cast<size_t>(rows) * kRowBytes : 0) +
         kDecLaneBytes;
}

// Named barriers between the decode warp and the copy warp of a block:
// stage b is full (decoded) or empty (copied out).
constexpr int kStageFull = 1, kStageEmpty = 3;

// A barrier counts whole warps: each is reached by a converged warp.
__device__ __forceinline__ void bar_sync(int id) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kDecThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kDecThreads) : "memory");
}

// The packed table (rans_device.decode_table): one u32 a (context row,
// slot), (freq - 1) | row' << 12 | (slot - cum) << 20, where row' is the
// row of the decoded symbol as the next context. Both 12-bit fields hold
// their whole range: freq is 1..4096 and slot - cum 0..freq - 1. The
// shared route holds the live rows only (order-0: one row, row' 0), and a
// symbol that is no live context, which on a valid section only ends a
// lane, names the last; the output byte is each slot's symbol, `syms`,
// beside the entries. The global route holds all 256 rows, row r being
// context byte r, so row' is the decoded symbol and the output byte: the
// entry is the step's one load from global memory.
//
// Shared-memory loads the compiler keeps where they are written: the
// payload word is loaded on every step, and must not sink under the branch
// that uses it, which would put it on the state chain.
__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lds_u8(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// y < lim ? a : b, the compare and the select in one piece of PTX, so that
// both candidates are formed before the choice and nothing is left after it
__device__ __forceinline__ uint32_t select_lt(uint32_t y, uint32_t lim,
                                              uint32_t a, uint32_t b) {
  uint32_t r;
  asm("{\n\t.reg .pred p;\n\tsetp.lt.u32 p, %1, %2;\n\t"
      "selp.b32 %0, %3, %4, p;\n\t}"
      : "=r"(r) : "r"(y), "r"(lim), "r"(a), "r"(b));
  return r;
}

// One decoder step of a lane. kb = 4 (row << 12 | x's slot) is the byte
// offset of the entry; the entry and the 16-bit word at byte `at` of the
// lane's ring (shared address `ring`) load side by side (the entry from
// shared memory on the shared route), and the output byte: the slot's
// symbol from shared memory (`syms`) on the shared route, the entry's
// next row on the global one. Then y =
// freq (x >> 12) + slot - cum, and the word is shifted in when y < lim,
// which is 2^16 while the lane holds two more bytes (`left`) and else 0.
// The next offset is either the word's slot or y's in the entry's row:
// both are formed from y4 = 4 y + 0..3 (an IMAD beside y's) and chosen by
// one select. Selects, not branches: lanes renormalise on different steps.
// Returns the symbol.
template <bool kShared, bool kEven>
__device__ __forceinline__ uint32_t decode_step(uint32_t& x, uint32_t& kb,
                                                uint32_t& at, uint32_t& lim,
                                                uint32_t& left,
                                                const uint32_t* tab,
                                                const uint8_t* syms,
                                                uint32_t ring) {
  const uint32_t v =  // the word as a little-endian u16: its high byte first
      kEven ? lds_u16(ring + at)
            : lds_u8(ring + at) |
                  lds_u8(ring + ((at + 1) & (kDecRing - 1))) << 8;
  const uint32_t* const at_e = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const uint8_t*>(tab) + kb);
  const uint32_t e = kShared ? *at_e : __ldg(at_e);
  const uint32_t s = kShared ? syms[kb >> 2] : (e >> 12) & 0xFFu;
  const uint32_t w = __byte_perm(v, 0, 0x4401);  // hi << 8 | lo
  const uint32_t q = x >> kScaleBits, q4 = (x >> (kScaleBits - 2)) & ~3u;
  const uint32_t f1 = e & kScaleMask;
  const uint32_t y = f1 * q + q + (e >> 20);
  const uint32_t y4 = f1 * q4 + q4 + (e >> 18);  // bits 0-1 are not 4 y's
  const uint32_t row4 = (e & 0xFF000u) << 2;
  kb = select_lt(y, lim, row4 | ((w << 2) & 0x3FFCu), row4 | (y4 & 0x3FFCu));
  const bool need = y < lim;
  x = need ? y << 16 | w : y;
  at = need ? (at + 2) & (kDecRing - 1) : at;
  left -= need ? 2u : 0u;
  lim = left > 1 ? kRansL : 0u;
  return s;
}

// A lane of rans_decode_kernel: its payload bytes [a, e) in aligned
// coordinates (abase = payload - a0; none when e <= a), its output bytes
// [lo, lo + len), and its ring in shared memory.
struct DecLane {
  const uint8_t* abase;
  long long a, e, lo, len;
  uint8_t* ring;
};

// Asynchronous 16-byte copies of the lane's chunks from chunk `next` (in
// aligned coordinates) through the one that holds byte min(limit, e) - 1,
// chunk c into ring slot c % kRingChunks. Each chunk holds a byte of the
// lane, so no copy leaves the payload's allocation.
__device__ __forceinline__ void top_up(const DecLane& ln, long long& next,
                                       long long limit) {
  const long long stop = limit < ln.e ? limit : ln.e;
  if (stop <= ln.a) return;
  for (const long long last = (stop + 15) >> 4; next < last; ++next) {
    cp_async16(ln.ring + ((next & (kRingChunks - 1)) << 4),
               ln.abase + (next << 4));
  }
}

// The lane's decode once its first chunks have landed: the state from its
// first 4 bytes, then windows of kDecWindow steps into stage t % 2, each
// begun by the request of the bytes the next one may read. A stage is
// handed to the copy warp when full, with each lane's run, and written
// again once the copy warp has emptied it; a window whose lanes have no
// step left hands over empty runs, which end the copy warp's loop. `at`
// starts at the lane's first word (0 for a lane with no bytes).
template <bool kShared, bool kEven>
__device__ __forceinline__ void decode_lanes(const DecLane& ln,
                                             long long next, uint32_t at,
                                             const uint32_t* tab,
                                             const uint8_t* syms,
                                             uint8_t* stages, DecRun* runs) {
  const int lane = threadIdx.x & 31;
  const long long have = ln.e - ln.a;
  uint32_t x = 0;
  for (int b = 0; b < 4; ++b) {
    if (b < have) x |= static_cast<uint32_t>(
        ln.ring[(ln.a + b) & (kDecRing - 1)]) << (8 * b);
  }
  // the lane's bytes past its state (a lane's count is a u32); the first
  // entry is in row 0, context 0's, the first live one
  const uint32_t left0 = have <= 4 ? 0u
                         : have - 4 < 0xFFFFFFFFLL
                             ? static_cast<uint32_t>(have - 4)
                             : 0xFFFFFFFFu;
  uint32_t left = left0, lim = left > 1 ? kRansL : 0u;
  uint32_t kb = (x & kScaleMask) << 2;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(
      ln.ring));
  for (int t = 0;; ++t) {
    const long long k0 = static_cast<long long>(t) * kDecWindow;
    const long long rest = ln.len - k0;
    const int n = rest <= 0 ? 0 : rest < kDecWindow ? static_cast<int>(rest)
                                                    : kDecWindow;
    const int b = t & 1;
    if (t >= 2) bar_sync(kStageEmpty + b);  // window t - 2 is copied out
    runs[b * kDecLanes + lane] = {ln.lo + k0, n, 0};
    if (!__any_sync(kFullMask, n > 0)) {
      bar_arrive(kStageFull + b);  // empty runs: the copy warp stops
      if (t >= 1) bar_sync(kStageEmpty + (b ^ 1));  // and has copied t - 1
      return;
    }
    top_up(ln, next, ln.a + 4 + (left0 - left) + 4LL * kDecWindow);
    cp_async_commit();
    cp_async_wait_but_one();  // this window's bytes have landed
    uint8_t* const stage = stages + b * kStageBytes + lane * kStageStride;
    for (int j = 0; j < n; ++j) {
      stage[j] = static_cast<uint8_t>(decode_step<kShared, kEven>(
          x, kb, at, lim, left, tab, syms, ring));
    }
    bar_arrive(kStageFull + b);
  }
}

// The copy warp: each full stage's runs to `out`, a lane's run at a time,
// in aligned 32-bit words: word j of a run at out + dst (m bytes past a
// word) holds stage bytes 4 j - m .. 4 j - m + 3, two stage words funnel-
// shifted; the first and last words, which the run may share with others,
// are written byte by byte. Every word of the row is formed and the stores
// are predicated, with no branch, so that the lanes' loads overlap. Until
// a stage of empty runs.
__device__ __forceinline__ void copy_stages(const uint8_t* stages,
                                            const DecRun* runs,
                                            uint8_t* __restrict__ out) {
  // the words a run can touch, in rounds of 32; the stage words they read
  // (one before the row, up to 32 kRounds - kStageStride / 4 after it) lie
  // inside shared memory and feed no written byte
  constexpr int kRounds = (kStageStride / 4 + 1 + 31) / 32;
  const int lane = threadIdx.x & 31;
  for (int t = 0;; ++t) {
    const int b = t & 1;
    bar_sync(kStageFull + b);
    if (!__any_sync(kFullMask, runs[b * kDecLanes + lane].n > 0)) return;
#pragma unroll 8
    for (int l = 0; l < kDecLanes; ++l) {
      const DecRun r = runs[b * kDecLanes + l];
      const int m = static_cast<int>(
          (reinterpret_cast<uintptr_t>(out) + r.dst) & 3);
      const int end = m + r.n;
      const uint32_t* const src = reinterpret_cast<const uint32_t*>(
          stages + b * kStageBytes + l * kStageStride);
      uint8_t* const base = out + (r.dst - m);
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        const int p = 4 * (lane + 32 * u);
        const uint32_t v = __funnelshift_rc(src[p / 4 - 1], src[p / 4],
                                            32 - 8 * m);
        const bool full = p >= m && p + 4 <= end;
        if (full) *reinterpret_cast<uint32_t*>(base + p) = v;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!full && p + k >= m && p + k < end) {
            base[p + k] = static_cast<uint8_t>(v >> (8 * k));
          }
        }
      }
    }
    bar_arrive(kStageEmpty + b);
  }
}

// 32 lanes a block. On the shared route both warps stage the block's
// tables; then the first decodes, a thread a lane, and the second copies
// its output out. Lane i reads its payload bytes [start_i, min(start_i +
// counts[i], plen)), start_i the sum of the counts before it (the decode
// warp sums those of the lanes before it: all blocks together read
// lanes^2 / 64 counts, 2 MB at 4096 lanes and 0.5 GB at the section
// format's most, 65,535), and writes lane i's part of the split of n
// bytes of rans_np.lane_slices, the one split the section format has.
// Blocks whose lanes all start at an even aligned offset read each word
// as one u16, the others as two bytes. An order-0 section is a table of
// one row.
template <bool kShared>
__global__ void __launch_bounds__(kDecThreads)
    rans_decode_kernel(const uint8_t* __restrict__ payload, long long plen,
                       const long long* __restrict__ counts, int lanes,
                       long long n, const uint32_t* __restrict__ table,
                       const uint8_t* __restrict__ syms, int rows,
                       uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t* const table_s = reinterpret_cast<uint32_t*>(smem);
  uint8_t* const syms_s = smem + (kShared ? rows << (kScaleBits + 2) : 0);
  uint8_t* const rings = smem + (kShared ? rows * kRowBytes : 0);
  uint8_t* const stages = rings + kDecLanes * kRingStride;
  DecRun* const runs = reinterpret_cast<DecRun*>(stages + 2 * kStageBytes);
  if (kShared) {
    for (int v = tid; v < rows << (kScaleBits - 2); v += kDecThreads) {
      cp_async16(table_s + 4 * v, table + 4 * v);
    }
    for (int v = tid; v < rows << (kScaleBits - 4); v += kDecThreads) {
      cp_async16(syms_s + 16 * v, syms + 16 * v);
    }
  }
  cp_async_commit();
  if (tid >= kDecLanes) {  // the copy warp
    cp_async_wait_all();
    __syncthreads();  // the tables have landed
    copy_stages(stages, runs, out);
    return;
  }

  const int i = blockIdx.x * kDecLanes + lane;
  const bool active = i < lanes;
  // the counts of the lanes before this block's, two at a time
  const int pairs = blockIdx.x * (kDecLanes / 2);
  const longlong2* const count2 = reinterpret_cast<const longlong2*>(counts);
  long long before = 0;
  for (int k0 = lane; k0 < pairs; k0 += 32 * 8) {
    longlong2 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = k0 + 32 * u;
      v[u] = k < pairs ? __ldg(count2 + k) : make_longlong2(0, 0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) before += v[u].x + v[u].y;
  }
  const long long mine = active ? counts[i] : 0;
  long long incl = mine;
  for (int d = 1; d < 32; d <<= 1) {
    const long long t = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += t;
  }
  for (int d = 16; d > 0; d >>= 1) {
    before += __shfl_xor_sync(kFullMask, before, d);
  }
  const long long start = before + incl - mine;
  const long long ps = start < 0 ? 0 : start < plen ? start : plen;
  const long long end = start + mine;
  const long long pe = end < ps ? ps : end < plen ? end : plen;

  const int a0 = static_cast<int>(reinterpret_cast<uintptr_t>(payload) & 15);
  DecLane ln;
  ln.abase = payload - a0;
  ln.a = ps + a0;
  ln.e = pe + a0;
  const long long q = n / lanes, r = n % lanes;
  ln.lo = i * q + (i < r ? i : r);
  ln.len = active ? q + (i < r ? 1 : 0) : 0;
  ln.ring = rings + lane * kRingStride;
  // the bytes window 0 reads now; its own top-up requests the rest
  long long next = ln.a >> 4;
  top_up(ln, next, ln.a + 4 + 2LL * kDecWindow);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();  // the tables have landed

  const uint32_t* const tab = kShared ? table_s : table;
  const uint32_t at =
      ln.e > ln.a ? static_cast<uint32_t>(ln.a + 4) & (kDecRing - 1) : 0u;
  if (__all_sync(kFullMask, !(at & 1))) {
    decode_lanes<kShared, true>(ln, next, at, tab, syms_s, stages, runs);
  } else {
    decode_lanes<kShared, false>(ln, next, at, tab, syms_s, stages, runs);
  }
}

long long layout_tiles(long long steps) {
  return steps > 0 ? (steps + kTileSteps - 1) / kTileSteps : 1;
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

// The built layout tile, steps and lanes (the card tests place their edge
// cases by it).
extern "C" long long repaq_rans_layout_tile_steps() { return kTileSteps; }
extern "C" long long repaq_rans_layout_tile_lanes() { return kTileLanes; }

// 32-bit words of zeroed scratch repaq_rans_layout needs for a (steps,
// lanes) input: a status word a tile and lane, then the ticket counter.
extern "C" long long repaq_rans_layout_status_words(int lanes,
                                                    long long steps) {
  return layout_tiles(steps) * lanes + 1;
}

extern "C" int repaq_rans_layout(const void* words, const void* emits,
                                 const void* final_state, const void* start,
                                 int lanes, long long steps, void* payload,
                                 long long cap, void* status, void* stream) {
  if (lanes <= 0) return 0;
  const long long tiles = layout_tiles(steps);
  const long long lane_groups = (lanes + kTileLanes - 1) / kTileLanes;
  if (tiles * lane_groups > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = layout_smem_bytes();
  // raised once per device, as for rans_encode
  static bool raised[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(rans_layout_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[dev] = true;
  }
  const bool vec =
      lanes % 16 == 0 && ((reinterpret_cast<uintptr_t>(words) |
                           reinterpret_cast<uintptr_t>(emits)) & 15) == 0;
  uint32_t* const words32 = static_cast<uint32_t*>(status);
  rans_layout_kernel<<<static_cast<unsigned>(tiles * lane_groups),
                       kLayoutThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(words), static_cast<const uint8_t*>(emits),
      static_cast<const long long*>(final_state),
      static_cast<const long long*>(start), lanes, steps,
      static_cast<int>(tiles), static_cast<int>(lane_groups), vec,
      static_cast<uint8_t*>(payload), cap, words32,
      reinterpret_cast<unsigned*>(words32 + tiles * lanes));
  return static_cast<int>(cudaGetLastError());
}

// The built decode window (steps) and shared-table limit (live contexts):
// the card tests and chip_smoke.py place their edge cases by them.
extern "C" long long repaq_rans_decode_window() { return kDecWindow; }
extern "C" long long repaq_rans_decode_shared_rows() { return kSharedRows; }

// table: the packed rows (rans_device.decode_table); syms: their slots'
// symbols on the shared route, in shared memory with them (order-0
// always: one row), else null, with the table's 256 rows read from global
// memory; counts, table and syms 16-byte aligned; out gets the split of n
// bytes of rans_np.lane_slices.
extern "C" int repaq_rans_decode(const void* payload, long long plen,
                                 const void* counts, int lanes, long long n,
                                 const void* table, const void* syms,
                                 int rows, int shared, int order, void* out,
                                 void* stream) {
  if (lanes <= 0) return 0;
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(counts) |
                            reinterpret_cast<uintptr_t>(table) |
                            reinterpret_cast<uintptr_t>(syms);
  if ((aligned & 15) || (shared != 0) == (syms == nullptr) ||
      (shared ? rows < 1 || rows > kSharedRows || (order == 0 && rows != 1)
              : order == 0 || rows != 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* kernel = shared ? rans_decode_kernel<true> : rans_decode_kernel<false>;
  // raised once per device and route to the route's most, as for
  // rans_encode
  static bool raised[2][64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !raised[shared != 0][dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(decode_smem_bytes(kSharedRows, shared != 0)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[shared != 0][dev] = true;
  }
  kernel<<<static_cast<unsigned>((lanes + kDecLanes - 1) / kDecLanes),
           kDecThreads, decode_smem_bytes(rows, shared != 0),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), plen,
      static_cast<const long long*>(counts), lanes, n,
      static_cast<const uint32_t*>(table), static_cast<const uint8_t*>(syms),
      rows, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
