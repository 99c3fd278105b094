// CUDA graph conditional nodes for the Session's captured steps: the
// predicate setter kernel and the node plumbing around a stream capture.
//
// It replaces no TPU kernel. The JAX package lowers cond and while_loop to
// lax.cond and lax.while_loop (simple_tensorflow_tpu/ops/control_flow_ops.py
// :192 _lower_cond, :337 _lower_while), which XLA runs as control flow on
// the device. The port replays a captured step as one CUDA graph, and a
// graph has a fixed list of kernels unless it holds conditional nodes
// (CUDA 12.4+): an IF node runs its body graph once when its handle is
// non-zero, a WHILE node runs its body graph as long as its handle is
// non-zero when the body starts. The handle is set on the device by
// cudaGraphSetConditional, from a kernel of the graph: set_conditional_kernel
// below, one thread that reads the predicate tensor (one byte, torch.bool)
// and sets the handle. So a replay reads no predicate on the host.
//
// What bounds it: nothing but its launch. It reads one byte; the node's
// cost is the launch latency of the kernel and of the body graph, a few
// microseconds an iteration.
//
// The plumbing (the C entry points):
//   stf_cond_node_begin: on a stream under capture, create a handle in the
//     graph being captured, capture a set_conditional_kernel launch that sets
//     it from the predicate, add a conditional node (IF or WHILE, one body
//     graph) after it, and make the node the stream's only dependency, so
//     whatever the stream captures next runs after the loop or branch.
//     Returns the handle and the (empty) body graph.
//   stf_capture_to_graph_begin / _end: capture a second stream's work into
//     that body graph (cudaStreamBeginCaptureToGraph, relaxed mode).
//   stf_cond_set: capture a set_conditional_kernel launch on a stream: the end
//     of a WHILE body sets the handle from the predicate it recomputed.
//   stf_graph_node_count: the nodes of a graph (a body's, or the step's).
// ops/kernels/control_flow.py drives them around PyTorch's capture.
#include <cuda_runtime.h>

namespace stf {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const unsigned char* pred,
                                       int negate) {
  const unsigned int v = pred[0] != 0 ? 1u : 0u;
  cudaGraphSetConditional(handle, negate ? 1u - v : v);
}

}  // namespace stf

static cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                                const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, graph, deps,
                                             nullptr, n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, graph, deps,
                                             n);
#endif
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  return cudaSuccess;
}

extern "C" int stf_cond_set(void* stream, unsigned long long handle,
                            const void* pred, int negate) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stf::set_conditional_kernel<<<1, 1, 0, s>>>(
      static_cast<cudaGraphConditionalHandle>(handle),
      static_cast<const unsigned char*>(pred), negate);
  return cudaGetLastError();
}

extern "C" int stf_cond_node_begin(void* stream, int is_while,
                                   const void* pred, int negate,
                                   unsigned long long* handle_out,
                                   void** body_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info(s, &graph, &deps, &n);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  err = static_cast<cudaError_t>(stf_cond_set(stream, handle, pred, negate));
  if (err != cudaSuccess) return err;
  err = capture_info(s, &graph, &deps, &n);  // now: the setter's node
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  *handle_out = static_cast<unsigned long long>(handle);
  *body_out = params.conditional.phGraph_out[0];
  return cudaSuccess;
}

extern "C" int stf_capture_to_graph_begin(void* stream, void* graph) {
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(stream), static_cast<cudaGraph_t>(graph),
      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int stf_graph_node_count(void* graph, unsigned long long* out) {
  size_t n = 0;
  cudaError_t err =
      cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
  *out = n;
  return err;
}

extern "C" int stf_capture_to_graph_end(void* stream) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph);
}
