// A decode loop as one CUDA graph: the counterpart of the JAX package's
// lax.while_loop (whisperx_tpu/decode/search.py: greedy_decode, beam_decode).
//
// The caller (whisperx_tpu_torch/ops/graph_loop.py) captures one step of the
// loop with torch.cuda.graph; the step updates the loop's state in place and
// ends by writing the loop's condition, a bool on the device. This file
// builds the graph that repeats it:
//
//   loop_enter(cont) -> WHILE(handle) { step (child graph) -> set_condition(cont) } -> loop_exit
//
// loop_enter tests the condition before the first step, as lax.while_loop
// tests cond before its first body. The conditional node
// (CUDA 12.4 and later: cudaGraphCondTypeWhile) runs its body while the
// handle is non-zero, and the kernel at the end of the body sets the handle
// from the flag the step just wrote and adds one to a step counter (the
// caller's launch counts: launches in one step x steps run). One launch of
// the instantiated graph runs the whole loop; the host reads nothing until
// the caller reads the loop's outputs. loop_exit does nothing: with
// loop_enter it brackets the loop with one kernel on each side, outside the
// conditional body, so that a profiler's trace holds the loop's start and
// end on the device's clock (CUPTI records no kernel of a WHILE body).

#include <cuda_runtime.h>

namespace {

#if CUDART_VERSION >= 12040

// One thread each. loop_enter: the handle takes the flag's value.
// set_condition: the same at the end of a step, which it counts in `steps`.
__global__ void loop_enter(cudaGraphConditionalHandle handle, const bool* cont) {
  cudaGraphSetConditional(handle, *cont ? 1u : 0u);
}

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* cont, long long* steps) {
  ++*steps;
  cudaGraphSetConditional(handle, *cont ? 1u : 0u);
}

__global__ void loop_exit() {}

// A one-thread kernel node running `func` on `args` after `deps`.
cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* deps, size_t n_deps,
                       void* func, void** args) {
  cudaKernelNodeParams p = {};
  p.func = func;
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &p);
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* deps, size_t n_deps,
                     cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, deps, nullptr, n_deps, params);
#else
  return cudaGraphAddNode(node, graph, deps, n_deps, params);
#endif
}

cudaError_t build(cudaGraph_t outer, cudaGraph_t step, const bool* cont, long long* steps) {
  cudaGraphConditionalHandle handle;
  cudaError_t e = cudaGraphConditionalHandleCreate(&handle, outer, 0, 0);
  if (e != cudaSuccess) return e;
  cudaGraphNode_t first, loop, child, last, tail;
  void* enter_args[] = {&handle, &cont};
  void* step_args[] = {&handle, &cont, &steps};
  if ((e = add_kernel(&first, outer, nullptr, 0, reinterpret_cast<void*>(loop_enter), enter_args)) != cudaSuccess)
    return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  if ((e = add_node(&loop, outer, &first, 1, &params)) != cudaSuccess) return e;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  if ((e = cudaGraphAddChildGraphNode(&child, body, nullptr, 0, step)) != cudaSuccess) return e;
  if ((e = add_kernel(&last, body, &child, 1, reinterpret_cast<void*>(set_condition), step_args)) != cudaSuccess)
    return e;
  return add_kernel(&tail, outer, &loop, 1, reinterpret_cast<void*>(loop_exit), nullptr);
}

#endif

}  // namespace

// The CUDA runtime this library was built with and the CUDA driver's version
// (e.g. 12040 for 12.4). A WHILE node needs 12.4 or later of both.
extern "C" int graph_loop_versions(int* runtime, int* driver) {
  *runtime = CUDART_VERSION;
  return static_cast<int>(cudaDriverGetVersion(driver));
}

// `step`: the captured step (a cudaGraph_t, cloned here as a child graph);
// `cont`: the bool the step writes last; `steps`: an int64 on the device
// that each step run adds one to. Instantiates the loop graph into *exec.
// Returns a cudaError_t (cudaErrorNotSupported when built with a runtime
// older than 12.4).
extern "C" int graph_loop_create(void* step, const void* cont, void* steps, void** exec) {
#if CUDART_VERSION >= 12040
  cudaGraph_t outer = nullptr;
  cudaError_t e = cudaGraphCreate(&outer, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = build(outer, static_cast<cudaGraph_t>(step), static_cast<const bool*>(cont), static_cast<long long*>(steps));
  cudaGraphExec_t instance = nullptr;
  if (e == cudaSuccess) e = cudaGraphInstantiate(&instance, outer, 0);
  const cudaError_t d = cudaGraphDestroy(outer);  // the instance keeps its own copy
  if (e == cudaSuccess) {
    *exec = instance;
    e = d;
  }
  return static_cast<int>(e);
#else
  (void)step;
  (void)cont;
  (void)steps;
  (void)exec;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}

// One launch runs the loop to its end on `stream`.
extern "C" int graph_loop_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

extern "C" int graph_loop_destroy(void* exec) {
  return static_cast<int>(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
