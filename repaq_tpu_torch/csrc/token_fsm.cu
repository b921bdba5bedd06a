// Token-boundary FSM for Hopper (sm_90a).
//
// Replaces: repaq_tpu/ops/pallas_tpu.py `_fsm_kernel`, as reached through
// `token_fsm_pallas` + `token_start_mask_auto` (repaq_tpu/ops/
// device_streams.py) on the decode path (N-position and quality streams).
//
// The gap/run stream grammar is a 4-state machine: the state is the number
// of bytes left in the current token. At a byte where the state is 0 (or
// where a restart is forced at a per-bin stream boundary) a token starts
// and the state becomes len-1; elsewhere it drops by one. The output is
// the "token starts here" mask. A 4-state map is held in one word, the
// image of state s in byte s (identity 0x03020100); composing maps is
// associative and takes two byte permutes.
//
// What bounds it on the card: memory. The function reads each length once
// (1 byte as uint8, 4 as int32) and each force flag once, and writes one
// bool: 3 bytes per stream byte with uint8 lengths, 6 with int32. At 3.35
// TB/s a 12-Mbyte stream cannot take less than ~11 us (uint8) or ~21 us
// (int32). The work per byte is a dozen integer operations.
//
// The design is one kernel, one pass, nothing of size n in device memory
// but the inputs and the output: a single-pass scan over tiles with
// decoupled look-back (Merrill and Garland). A tile is kThreads segments of
// kSeg bytes, one a thread. Per tile:
//   1. Each warp loads its 32 segments' lengths and force flags with
//      16-byte vector loads at consecutive addresses, makes 3-bit codes,
//      len - 1 | force << 2, and passes them through a small stage in shared
//      memory to the thread that walks them, four to a word.
//   2. It walks the segment from all four entry states at once, the states
//      one to a byte of a word: a token starts where a state's byte is 0 or
//      the restart is forced. The four start bits of four bytes gather in
//      one word (byte p, bit k: byte k starts a token from entry state p),
//      and the final states give the segment's map.
//   3. The segment maps are scanned across the block: shuffles within a
//      warp, then one warp over the warp totals. Each thread gets the map
//      of the segments before it in the tile, the block its tile's map.
//   4. Look-back for the tile's entry state. Tiles take their index from an
//      atomic counter in launch order, so a tile waits only on tiles that
//      have started. Each publishes its map (flag 1) as soon as it has it,
//      then its exit state (flag 2) once it knows its entry state, in one
//      32-bit status word stored with release semantics; warp 0 reads the
//      32 tiles before (one status line) with acquire loads, composes their
//      maps back to the nearest exit state and applies them, or folds all
//      32 and reads the 32 before those.
//   5. Each thread spreads the start bits of its entry state to bytes, and
//      the warp stores its segments back through its stage with 16-byte
//      vector stores at consecutive addresses.
// On an H100 this runs at about a third of the uint8 bound and near half
// of the int32 one; with the look-back cut out it still takes three
// quarters of its time, so the tiles' load-walk-store structure more than
// the look-back holds it back (tools/profile_token_fsm.py, which builds the
// switches below and an earlier design's source beside this one; PERF.md).
// The wrapper (repaq_tpu_torch/ops/kernels.py) zeroes the status words and
// the counter and guarantees 16-byte aligned lens, force and out buffers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSeg = 32;                  // stream bytes one thread walks
constexpr int kWords = kSeg / 4;          // code words a thread holds
constexpr int kStage = kSeg + 16;         // a segment's stride in the stage
constexpr int kThreads = 512;             // segments per tile
constexpr int kWarps = kThreads / 32;
constexpr long long kTile = kSeg * kThreads;  // stream bytes per tile
constexpr uint32_t kIdentity = 0x03020100u;   // map s -> s
constexpr uint32_t kMapBits = 0x03030303u;
constexpr uint32_t kFlagMap = 1u << 4;    // status: map | flag, the tile's map
constexpr uint32_t kFlagExit = 2u << 4;   // status: the tile's exit state
constexpr uint32_t kOnes = 0x01010101u;

// Profiling switches, off in every build of the package; their output is
// wrong on purpose. -DREPAQ_FSM_NO_LOOKBACK: every tile enters in state 0.
// -DREPAQ_FSM_NO_TICKET, only with it: the tile index is blockIdx.x.
#ifdef REPAQ_FSM_NO_LOOKBACK
constexpr bool kLookBack = false;
#else
constexpr bool kLookBack = true;
#endif
#ifdef REPAQ_FSM_NO_TICKET
constexpr bool kTicket = false;
#else
constexpr bool kTicket = true;
#endif

__device__ __forceinline__ uint32_t apply_map(uint32_t map, uint32_t s) {
  return (map >> (8 * s)) & 3u;
}

// first `a`, then `b`: byte s of the result is byte a[s] of b
__device__ __forceinline__ uint32_t compose(uint32_t a, uint32_t b) {
  const uint32_t sel = __byte_perm(a | (a >> 4), 0, 0x0020);  // a as nibbles
  return __byte_perm(b, 0, sel);
}

__device__ __forceinline__ uint32_t status_flag(uint32_t w) {
  return (w >> 4) & 3u;
}

__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// code of one stream byte: clamp(len, 1, 4) - 1 in bits 0-1, force in bit 2
__device__ __forceinline__ uint32_t code_of(long long len, bool forced) {
  return static_cast<uint32_t>(len < 1 ? 0 : (len > 4 ? 3 : len - 1)) |
         (forced ? 4u : 0u);
}

// The codes of a warp's 32 segments from `at`, whole within the stream:
// the warp loads them with 16-byte vector loads at consecutive addresses
// (every access of a load instruction in one run of bytes) into its stage
// in shared memory, at a segment stride of kStage bytes so that the 16-byte
// reads of the segments by their threads take no bank twice; then each
// thread reads its own segment's words.
template <typename T>
__device__ __forceinline__ void stage_codes(const T* __restrict__ lens,
                                            const uint8_t* __restrict__ force,
                                            long long at, int lane,
                                            uint8_t* stage,
                                            uint32_t code[kWords]) {
  constexpr int kChunks = 32 * kSeg / 16;  // 16-byte chunks of the warp
#pragma unroll
  for (int v = 0; v < kChunks / 32; ++v) {
    const int c = lane + 32 * v;
    uint4 f = make_uint4(0, 0, 0, 0);
    if (force != nullptr) f = *reinterpret_cast<const uint4*>(force + at + 16 * c);
    // a force byte is 0 or 1: bit 2 of the code
    f.x = (f.x & kOnes) << 2, f.y = (f.y & kOnes) << 2;
    f.z = (f.z & kOnes) << 2, f.w = (f.w & kOnes) << 2;
    if constexpr (sizeof(T) == 1) {
      const uint4 l = *reinterpret_cast<const uint4*>(lens + at + 16 * c);
      f.x |= __vminu4(__vmaxu4(l.x, kOnes), 4 * kOnes) - kOnes;
      f.y |= __vminu4(__vmaxu4(l.y, kOnes), 4 * kOnes) - kOnes;
      f.z |= __vminu4(__vmaxu4(l.z, kOnes), 4 * kOnes) - kOnes;
      f.w |= __vminu4(__vmaxu4(l.w, kOnes), 4 * kOnes) - kOnes;
    }
    *reinterpret_cast<uint4*>(stage + (c * 16 / kSeg) * kStage +
                              (c * 16) % kSeg) = f;
  }
  if constexpr (sizeof(T) == 4) {
    __syncwarp();
#pragma unroll
    for (int v = 0; v < kChunks * 4 / 32; ++v) {
      const int c = lane + 32 * v;  // 4 lengths, stream bytes 4c .. 4c+3
      const int4 l = *reinterpret_cast<const int4*>(lens + at + 4 * c);
      const uint32_t w = static_cast<uint32_t>(min(max(l.x, 1), 4) - 1) |
                         static_cast<uint32_t>(min(max(l.y, 1), 4) - 1) << 8 |
                         static_cast<uint32_t>(min(max(l.z, 1), 4) - 1) << 16 |
                         static_cast<uint32_t>(min(max(l.w, 1), 4) - 1) << 24;
      *reinterpret_cast<uint32_t*>(stage + (c * 4 / kSeg) * kStage +
                                   (c * 4) % kSeg) |= w;
    }
  }
  __syncwarp();
#pragma unroll
  for (int v = 0; v < kWords / 4; ++v) {
    const uint4 w = *reinterpret_cast<const uint4*>(stage + lane * kStage + 16 * v);
    code[4 * v] = w.x, code[4 * v + 1] = w.y, code[4 * v + 2] = w.z,
    code[4 * v + 3] = w.w;
  }
}

// The codes of the segment of kSeg bytes from `at`, four to a word, at the
// stream's end, byte by byte; bytes past n are 1-byte tokens and never
// reach the output.
template <typename T>
__device__ __forceinline__ void load_codes(const T* __restrict__ lens,
                                           const uint8_t* __restrict__ force,
                                           long long at, long long n,
                                           uint32_t code[kWords]) {
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    uint32_t c = 0;
    for (int k = 0; k < 4; ++k) {
      const long long i = at + 4 * q + k;
      if (i < n) {
        c |= code_of(static_cast<long long>(lens[i]),
                     force != nullptr && force[i] != 0) << (8 * k);
      }
    }
    code[q] = c;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
token_fsm_kernel(const T* __restrict__ lens, const uint8_t* __restrict__ force,
                 long long n, uint32_t* __restrict__ status,
                 uint32_t* __restrict__ counter, uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t stage[kWarps][32 * kStage];
  __shared__ uint32_t warp_maps[kWarps];
  __shared__ uint32_t shared_tile_id;
  __shared__ uint32_t shared_entry;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  if (t == 0) shared_tile_id = kTicket ? atomicAdd(counter, 1u) : blockIdx.x;
  __syncthreads();
  const uint32_t tile_id = shared_tile_id;
  const long long at = static_cast<long long>(tile_id) * kTile + kSeg * t;

  // 1. this thread's codes
  uint32_t code[kWords];
  const long long warp_at = at - kSeg * lane;
  if (warp_at + 32 * kSeg <= n) {
    stage_codes<T>(lens, force, warp_at, lane, stage[warp], code);
  } else {
    load_codes<T>(lens, force, at, n, code);
  }

  // 2. walk from all four entry states, state p in byte p of `st`
  uint32_t st = 0x03020100u;
  uint32_t starts[kWords];  // byte p, bit k: byte 4w + k starts from state p
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    uint32_t z4 = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t c = __byte_perm(code[w], 0, 0x1111u * k);  // byte k, 4x
      // bit 0 of a byte: its state is 0, or the restart is forced
      const uint32_t z = (~(st | (st >> 1)) | (c >> 2)) & kOnes;
      const uint32_t zm = z * 0xFFu;
      st = ((st - (z ^ kOnes)) & ~zm) | (c & zm & 0x03030303u);
      z4 |= z << k;
    }
    starts[w] = z4;
  }
  const uint32_t my_map = st;

  // 3. block scan of the segment maps: inclusive within the warp ...
  uint32_t incl = my_map;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t before = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl = compose(before, incl);
  }
  uint32_t excl = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
  if (lane == 0) excl = kIdentity;
  if (lane == 31) warp_maps[warp] = incl;
  __syncthreads();
  // ... then across the warps, by warp 0 (kWarps <= 32)
  if (warp == 0) {
    const uint32_t own = lane < kWarps ? warp_maps[lane] : kIdentity;
    uint32_t wincl = own;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const uint32_t before = __shfl_up_sync(0xFFFFFFFFu, wincl, d);
      if (lane >= d) wincl = compose(before, wincl);
    }
    uint32_t wexcl = __shfl_up_sync(0xFFFFFFFFu, wincl, 1);
    if (lane == 0) wexcl = kIdentity;
    const uint32_t tile_map = __shfl_sync(0xFFFFFFFFu, wincl, kWarps - 1);
    __syncwarp();
    if (lane < kWarps) warp_maps[lane] = wexcl;

    // 4. publish the tile's map, then look back for its entry state
    if (lane == 0) store_release(status + tile_id, kFlagMap | tile_map);
    uint32_t acc = kIdentity;  // entry state of tile `hi + 1` -> this tile's
    long long hi = static_cast<long long>(tile_id) - 1;
    uint32_t entry = 0;
    while (kLookBack) {
      // lane l reads tile hi - l: one status line; before tile 0 the
      // stream's start reads as an exit state of 0
      const long long j = hi - lane;
      uint32_t sw = j < 0 ? kFlagExit : load_acquire(status + j);
      while (!__all_sync(0xFFFFFFFFu, sw != 0)) {
        if (sw == 0) sw = load_acquire(status + j);
      }
      // compose the maps of the tiles nearer than the nearest exit state
      // (lane k; all 32 without one), the earliest first, by a shuffle
      // reduction
      const uint32_t exits = __ballot_sync(0xFFFFFFFFu, status_flag(sw) == 2);
      const int k = exits ? __ffs(exits) - 1 : 32;
      uint32_t m = lane < k ? sw & kMapBits : kIdentity;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t earlier = __shfl_down_sync(0xFFFFFFFFu, m, d);
        if (lane + d < 32) m = compose(earlier, m);
      }
      const uint32_t span = __shfl_sync(0xFFFFFFFFu, m, 0);
      if (exits) {
        entry = apply_map(acc, apply_map(span, __shfl_sync(0xFFFFFFFFu,
                                                            sw & 3u, k)));
        break;
      }
      acc = compose(span, acc);
      hi -= 32;
    }
    if (lane == 0) {
      store_release(status + tile_id, kFlagExit | apply_map(tile_map, entry));
      shared_entry = entry;
    }
  }
  __syncthreads();

  // 5. the start bits of this segment's entry state, one byte each
  const uint32_t s = apply_map(compose(warp_maps[warp], excl), shared_entry);
  uint32_t o[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    // bit k of the nibble to bit 0 of byte k
    o[w] = (((starts[w] >> (8 * s)) & 0xFu) * 0x00204081u) & kOnes;
  }
  if (warp_at + 32 * kSeg <= n) {
    // back through the stage, then 16-byte stores at consecutive addresses
    uint8_t* sg = stage[warp];
#pragma unroll
    for (int v = 0; v < kWords / 4; ++v) {
      *reinterpret_cast<uint4*>(sg + lane * kStage + 16 * v) =
          make_uint4(o[4 * v], o[4 * v + 1], o[4 * v + 2], o[4 * v + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int v = 0; v < kSeg / 16; ++v) {
      const int c = lane + 32 * v;
      *reinterpret_cast<uint4*>(out + warp_at + 16 * c) =
          *reinterpret_cast<const uint4*>(sg + (c * 16 / kSeg) * kStage +
                                          (c * 16) % kSeg);
    }
  } else {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      for (int k = 0; k < 4; ++k) {
        if (at + 4 * w + k < n) out[at + 4 * w + k] = (o[w] >> (8 * k)) & 1u;
      }
    }
  }
}

long long num_tiles(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// Stream bytes per tile (the card tests place their edge cases by it).
extern "C" long long repaq_token_fsm_tile() { return kTile; }

// 32-bit words of zeroed status repaq_token_start_mask needs for an n-byte
// stream: one per tile, then the tile counter.
extern "C" long long repaq_token_fsm_status_words(long long n) {
  return num_tiles(n) + 1;
}

// lens_bytes: 1 for uint8 lengths, 4 for int32; force may be null.
extern "C" int repaq_token_start_mask(const void* lens, int lens_bytes,
                                      const void* force, long long n,
                                      void* status, void* out, void* stream) {
  if (n <= 0) return 0;
  if (lens_bytes != 1 && lens_bytes != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = num_tiles(n);
  uint32_t* words = static_cast<uint32_t*>(status);
  const uint8_t* f = static_cast<const uint8_t*>(force);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (lens_bytes == 1) {
    token_fsm_kernel<uint8_t><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        static_cast<const uint8_t*>(lens), f, n, words, words + tiles, o);
  } else {
    token_fsm_kernel<int32_t><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        static_cast<const int32_t*>(lens), f, n, words, words + tiles, o);
  }
  return static_cast<int>(cudaGetLastError());
}
