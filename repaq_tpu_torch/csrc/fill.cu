// Masked run writes for Hopper (sm_90a): for each entry i with keep[i],
// out[start[i] + j] = value[i] for 0 <= j < count[i], each target kept
// only inside [0, out_n).
//
// Replaces: the dump-slot scatters of the decode. The TPU has no masked
// scatter, so the JAX package (repaq_tpu/ops/device_streams.py:982, :992,
// :1161, :1197, :1211, :1228, :1242, :1257, and
// repaq_tpu/codec/device_engine.py:845, :982) aims every masked write at
// one spare element past the end (XLA's mode="drop") and builds a fixed
// (run_cap, 4, 31) grid to extend the quality runs; torch's index_put_
// ran the same writes: an SE decode chunk issued ~73 M grid entries, all
// but ~9.6 k aimed at the dump byte, 1.8 ms of index_put_ on an NVIDIA
// H100 (tools/profile_fill.py). Here a masked entry writes nothing, and a
// run is written by the thread that holds its entry.
//
// What bounds it on the card: memory. It must read keep for every entry
// (or, without keep, count: 4 bytes unless one count serves all), count
// for the kept ones, start (4 bytes) and the value's bytes (unless one
// value serves all) for the entries that write, and write the run
// elements: ~19.5 MB for an SE decode chunk's 2,359,296 quality tokens,
// 1,680,349 of them writing: ~5.8 us at 3.35 TB/s, with one launch's
// fixed cost of ~5 us on top.
//
// Each thread loads kEntriesPerThread entries a block's width apart
// before it writes any, so a warp's loads each cover consecutive
// addresses (start and value only where the count is above 0), then
// writes each kept entry's run element by element (the
// decode's runs are at most 32; an SE chunk's ~0.6% of tokens cover more
// than one position). Where two kept entries write one target, either
// value may land (the callers' runs are disjoint; the decode writes its
// escapes in a second launch so that they land last).
//
// The launch has a plain C entry a type (repaq_fill_runs_u8,
// repaq_fill_runs_i32); ops/kernels.py binds them with ctypes. A null
// count, value or keep pointer means the scalar count_all, value_all, or
// every entry kept.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEntriesPerThread = 4;
constexpr int kEntriesPerBlock = kThreads * kEntriesPerThread;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fill_runs_kernel(T* __restrict__ out, long long out_n,
                 const int32_t* __restrict__ start,
                 const int32_t* __restrict__ count, int32_t count_all,
                 const T* __restrict__ value, T value_all,
                 const bool* __restrict__ keep, long long n) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kEntriesPerBlock + threadIdx.x;
  int32_t s[kEntriesPerThread], c[kEntriesPerThread];
  T v[kEntriesPerThread];
#pragma unroll
  for (int r = 0; r < kEntriesPerThread; ++r) {
    const long long i = base + r * kThreads;
    const bool live = i < n && (keep == nullptr || keep[i]);
    c[r] = live ? (count ? count[i] : count_all) : 0;
  }
  // start and value only for the entries that write: the decode's masked
  // entries (count 0, the tail of the token cap) cost their count alone
#pragma unroll
  for (int r = 0; r < kEntriesPerThread; ++r) {
    const long long i = base + r * kThreads;
    s[r] = c[r] > 0 ? start[i] : 0;
    v[r] = c[r] > 0 && value ? value[i] : value_all;
  }
#pragma unroll
  for (int r = 0; r < kEntriesPerThread; ++r) {
    if (c[r] <= 0) continue;
    long long lo = s[r];
    long long hi = lo + c[r];
    if (lo < 0) lo = 0;
    if (hi > out_n) hi = out_n;
    for (long long t = lo; t < hi; ++t) out[t] = v[r];
  }
}

template <typename T>
int launch(void* out, long long out_n, const void* start, const void* count,
           int count_all, const void* value, T value_all, const void* keep,
           long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kEntriesPerBlock - 1) / kEntriesPerBlock;
  fill_runs_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(out), out_n, static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(count), count_all,
      static_cast<const T*>(value), value_all,
      static_cast<const bool*>(keep), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repaq_fill_runs_u8(void* out, long long out_n,
                                  const void* start, const void* count,
                                  int count_all, const void* value,
                                  int value_all, const void* keep,
                                  long long n, void* stream) {
  return launch<uint8_t>(out, out_n, start, count, count_all, value,
                         static_cast<uint8_t>(value_all), keep, n, stream);
}

extern "C" int repaq_fill_runs_i32(void* out, long long out_n,
                                   const void* start, const void* count,
                                   int count_all, const void* value,
                                   int value_all, const void* keep,
                                   long long n, void* stream) {
  return launch<int32_t>(out, out_n, start, count, count_all, value,
                         static_cast<int32_t>(value_all), keep, n, stream);
}
