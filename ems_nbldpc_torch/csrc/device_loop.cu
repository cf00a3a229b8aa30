// The device loop's graph: a decoder's iterations as one CUDA-graph WHILE
// node, the counterpart of the JAX package's jax.lax.while_loop decodes
// (ems_nbldpc_tpu/decoder/layered.py decode_layered, decode_layered_list;
// decoder/flooding.py decode_flooding).
//
// The graph is  [set_condition(h, pred)] -> [WHILE h { body }].  The body
// is one decoder step, captured from the PyTorch step function on a stream
// (loop_begin ... loop_end); its last launch is set_condition(h, pred)
// again, where pred is a [] bool on the device that the step computes as
// (it < max_iters) & ~all(conv), the while-loop's cond.  So the steps run on
// the device, with no host read between them, exactly while cond holds;
// when every frame has converged at init the body never runs.
//
// Marker kernels: nbldpc_mark_<name> is an empty <<<1, 1>>> kernel whose
// only use is its place on the card's timeline.  The program launches one
// at each boundary of its spans (loop_mark; decoder/device_loop.py mark):
// encode and channel in the batch's generation, end at its close, decide
// and syndrome in every decoder step, and sweep at the head of each step
// of a layered decoder.  A device span runs from its marker's start to the
// start of the next marker or set_condition kernel on the stream.
//
// This file holds no math: set_condition reads one byte.  It exists because
// PyTorch 2.11 does not expose conditional-node capture to Python; the CUDA
// runtime (12.4 and later) offers it, and here it is called directly.
// Plain C interface, loaded with ctypes (decoder/device_loop.py); every
// function returns a CUDA error code (0 = success).
#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

__global__ void nbldpc_mark_encode() {}
__global__ void nbldpc_mark_channel() {}
__global__ void nbldpc_mark_end() {}
__global__ void nbldpc_mark_decide() {}
__global__ void nbldpc_mark_syndrome() {}
__global__ void nbldpc_mark_sweep() {}

}  // namespace

extern "C" {

// Build the graph [set_condition(h, pred)] -> [WHILE h { body }] and begin
// capturing `stream` into the empty body (relaxed mode: the kernels'
// launchers set function attributes and the allocator may grow its pool
// while the body is captured).  On success *graph_out and *handle_out hold
// the graph and its condition handle; on failure nothing is left behind.
int loop_begin(void* stream, const bool* pred, void** graph_out,
               unsigned long long* handle_out) {
  cudaGraph_t graph = nullptr;
  cudaError_t e = cudaGraphCreate(&graph, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphConditionalHandle handle = 0;
  cudaGraphNode_t set_node = nullptr, loop_node = nullptr;
  cudaKernelNodeParams k = {};
  void* args[] = {&handle, &pred};
  cudaGraphNodeParams c = {};
  if ((e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0)) !=
      cudaSuccess)
    goto fail;
  k.func = reinterpret_cast<void*>(set_condition);
  k.gridDim = dim3(1);
  k.blockDim = dim3(1);
  k.kernelParams = args;
  if ((e = cudaGraphAddKernelNode(&set_node, graph, nullptr, 0, &k)) !=
      cudaSuccess)
    goto fail;
  c.type = cudaGraphNodeTypeConditional;
  c.conditional.handle = handle;
  c.conditional.type = cudaGraphCondTypeWhile;
  c.conditional.size = 1;
  if ((e = cudaGraphAddNode(&loop_node, graph, &set_node, 1, &c)) !=
      cudaSuccess)
    goto fail;
  if ((e = cudaStreamBeginCaptureToGraph(
           static_cast<cudaStream_t>(stream), c.conditional.phGraph_out[0],
           nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed)) !=
      cudaSuccess)
    goto fail;
  *graph_out = graph;
  *handle_out = handle;
  return 0;
fail:
  cudaGraphDestroy(graph);
  return static_cast<int>(e);
}

// Launch set_condition(handle, pred) on `stream`: the body's last launch.
int loop_set(void* stream, unsigned long long handle, const bool* pred) {
  set_condition<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(handle,
                                                                pred);
  return static_cast<int>(cudaGetLastError());
}

// Launch marker `which` on `stream`, in the order of device_loop.MARKS:
// 0 encode, 1 channel, 2 end, 3 decide, 4 syndrome, 5 sweep.
int loop_mark(int which, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: nbldpc_mark_encode<<<1, 1, 0, s>>>(); break;
    case 1: nbldpc_mark_channel<<<1, 1, 0, s>>>(); break;
    case 2: nbldpc_mark_end<<<1, 1, 0, s>>>(); break;
    case 3: nbldpc_mark_decide<<<1, 1, 0, s>>>(); break;
    case 4: nbldpc_mark_syndrome<<<1, 1, 0, s>>>(); break;
    case 5: nbldpc_mark_sweep<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// End the body's capture on `stream` (also after a failed capture, so the
// stream leaves capture mode) and, if it succeeded, instantiate the graph.
int loop_end(void* stream, void* graph, void** exec_out) {
  cudaGraph_t body = nullptr;
  cudaError_t e =
      cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &body);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphExec_t exec = nullptr;
  e = cudaGraphInstantiate(&exec, static_cast<cudaGraph_t>(graph), 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *exec_out = exec;
  return 0;
}

// One decode: launch the instantiated graph on `stream`.
int loop_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(
      static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

// Free the instantiated graph and the graph (either may be null), after the
// device has finished whatever launch of the graph may still be running.
int loop_destroy(void* exec, void* graph) {
  cudaError_t e = cudaSuccess;
  if (exec) {
    e = cudaDeviceSynchronize();
    const cudaError_t f =
        cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
    if (e == cudaSuccess) e = f;
  }
  if (graph) {
    const cudaError_t f = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = f;
  }
  return static_cast<int>(e);
}

}  // extern "C"
