// Reads a captured CUDA graph: the operations that one call of a wrapper
// enqueued (kernels.captured_ops). Not a kernel and no TPU counterpart: a
// host helper for the checks that count a call's device kernels. A stream
// capture records every operation enqueued on the capturing stream, and
// the graph holds each of them as a node, so none is missed, where a
// profiler's activity records of a run have been seen to lose one.
//
// Node types come from the runtime; a kernel node's name from the driver
// (cuGraphKernelNodeGetParams, cuFuncGetName or cuKernelGetName), since
// the runtime names only the kernels it registered itself and a call's
// kernels may come from PyTorch's library as well as from this one.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cxxabi.h>

#include <cstdio>
#include <cstdlib>
#include <vector>

namespace {

typedef CUresult (*KernelParamsFn)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS*);
typedef CUresult (*FuncNameFn)(const char**, CUfunction);
typedef CUresult (*KernelNameFn)(const char**, CUkernel);

void* driver_entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, &fn, CUDART_VERSION, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault,
                                            &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? fn
                                                                    : nullptr;
}

// The kernel's name, demangled where it demangles, into out (name_len
// bytes, cut); "?" where the driver gives none.
void kernel_name(cudaGraphNode_t node, char* out, long long name_len) {
  static KernelParamsFn params_of = reinterpret_cast<KernelParamsFn>(
      driver_entry("cuGraphKernelNodeGetParams"));
  static FuncNameFn func_name = reinterpret_cast<FuncNameFn>(
      driver_entry("cuFuncGetName"));
  static KernelNameFn kern_name = reinterpret_cast<KernelNameFn>(
      driver_entry("cuKernelGetName"));
  const char* mangled = nullptr;
  CUDA_KERNEL_NODE_PARAMS p = {};
  if (params_of && params_of(reinterpret_cast<CUgraphNode>(node), &p) ==
                       CUDA_SUCCESS) {
    if (p.func && func_name) {
      func_name(&mangled, p.func);
    } else if (p.kern && kern_name) {
      kern_name(&mangled, p.kern);
    }
  }
  if (!mangled) {
    snprintf(out, name_len, "?");
    return;
  }
  int status = 0;
  char* demangled = abi::__cxa_demangle(mangled, nullptr, nullptr, &status);
  snprintf(out, name_len, "%s", status == 0 && demangled ? demangled
                                                         : mangled);
  free(demangled);
}

}  // namespace

// The graph's nodes, at most cap of them: node i's cudaGraphNodeType in
// types[i] and, for a kernel node, the kernel's name in names[i * name_len
// ...], for a memset node the bytes it sets in decimal (empty for the
// others). Returns the graph's node count (more than cap when it holds
// more), or minus a cudaError_t.
extern "C" long long repaq_graph_nodes(void* graph, int* types, char* names,
                                       long long cap, long long name_len) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  std::vector<cudaGraphNode_t> nodes(n);
  if (n) {
    err = cudaGraphGetNodes(g, nodes.data(), &n);
    if (err != cudaSuccess) return -static_cast<long long>(err);
  }
  for (size_t i = 0; i < n && static_cast<long long>(i) < cap; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return -static_cast<long long>(err);
    types[i] = static_cast<int>(type);
    char* name = names + i * name_len;
    name[0] = 0;
    if (type == cudaGraphNodeTypeKernel) kernel_name(nodes[i], name, name_len);
    if (type == cudaGraphNodeTypeMemset) {
      cudaMemsetParams p = {};
      err = cudaGraphMemsetNodeGetParams(nodes[i], &p);
      if (err != cudaSuccess) return -static_cast<long long>(err);
      snprintf(name, name_len, "%llu", static_cast<unsigned long long>(
                                           p.width * p.elementSize * p.height));
    }
  }
  return static_cast<long long>(n);
}
