// The dependent chain of rans_encode's state step, timed alone on the card:
// one thread runs `steps` steps of csrc/rans.cu's encode_step on symbols
// held in registers (no loads on the chain; its word and emit stores go to
// shared memory), and clock64() around the loop gives the cycles a step.
// Built by tools/profile_rans.py with the package's nvcc flags.

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

}  // namespace

// syms: 8 x (e, m, l, 0) uint32; one block of one thread
extern "C" int repaq_rans_chain_probe(const void* syms, int steps,
                                      void* cycles, void* out, void* stream) {
  chain_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(syms), steps,
      static_cast<long long*>(cycles), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
