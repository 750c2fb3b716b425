// A captured CUDA graph run under a device flag: a CUDA IF conditional node.
//
// This replaces no Pallas kernel: it is the device side of the JAX loops'
// `lax.while_loop` stop and `lax.cond` accept test (nmf_tpu/models/
// solver.py:454-493, 586), which decide on the device what runs next.  A
// loop's part (one step, or a check's close) is captured as a CUDA graph as
// before; `nmf_if_graph` builds a graph of two nodes around it:
//
//   set_if (one thread: the handle <- *pred)  ->  IF handle { the part }
//
// and instantiates it.  Each launch reads the flag where it lies on the
// device when the launch reaches it, so the host enqueues the part without
// reading the card, and a launch whose flag is false runs nothing of the
// part.  The part enters the IF node's body as a child graph node (a
// copy): its memory stays in the pool that PyTorch's capture drew it from,
// which the caller keeps alive with the captured graph.
//
// Conditional nodes need CUDA 12.4 or later, in the runtime and on the card
// (cudaGraphAddNode with conditional parameters, cudaGraphSetConditional on
// the device); the build and the first call fail where they are missing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void set_if(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

// The executable graph "IF *pred: body" on `device`, in *exec_out, its
// graph in *graph_out (both for nmf_if_graph_destroy).  `body` is a
// cudaGraph_t (copied: the caller may free it after), `pred` a device bool
// at a fixed address.  Returns a cudaError_t.
int nmf_if_graph(void* body, const void* pred, int device, void** exec_out,
                 void** graph_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphConditionalHandle handle;
  cudaGraphNode_t set_node, if_node, child;
  cudaGraphNodeParams params = {};
  cudaKernelNodeParams kernel = {};
  const bool* flag = static_cast<const bool*>(pred);
  void* args[] = {&handle, &flag};
  if ((err = cudaGraphCreate(&graph, 0)) != cudaSuccess) return err;
  // the handle is set at every launch by set_if: its default never shows
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) goto fail;
  kernel.func = reinterpret_cast<void*>(set_if);
  kernel.gridDim = dim3(1);
  kernel.blockDim = dim3(1);
  kernel.kernelParams = args;
  if ((err = cudaGraphAddKernelNode(&set_node, graph, nullptr, 0, &kernel)) != cudaSuccess)
    goto fail;
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  if ((err = cudaGraphAddNode(&if_node, graph, &set_node, 1, &params)) != cudaSuccess) goto fail;
  err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0], nullptr, 0,
                                   static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) goto fail;
  if ((err = cudaGraphInstantiate(&exec, graph, 0)) != cudaSuccess) goto fail;
  *exec_out = exec;
  *graph_out = graph;
  return cudaSuccess;
fail:
  cudaGraphDestroy(graph);
  return err;
}

// One launch of an nmf_if_graph on `stream`.
int nmf_graph_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
}

// Frees what nmf_if_graph made.
int nmf_if_graph_destroy(void* exec, void* graph) {
  cudaError_t err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  cudaError_t err2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  return err != cudaSuccess ? err : err2;
}

}  // extern "C"
