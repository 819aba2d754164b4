// Conditional IF nodes in a CUDA graph under capture (ops/_graph.py's
// device_if): the port's counterpart of the JAX package's lax.cond on the
// card, for a torch that gives Python no conditional nodes of its own.
//
// nbody_graph_if_begin, called while `stream` is capturing a graph:
//  * creates a conditional handle in the graph being captured,
//  * captures a one-thread kernel that sets the handle from *pred at every
//    launch of the graph (cudaGraphSetConditional),
//  * adds an IF node after it, makes the node the stream's only capture
//    dependency, and
//  * starts capturing `child` into the node's body graph.
// Work enqueued on `child` until nbody_graph_if_end then runs only on the
// launches where *pred was true.  Conditional nodes need CUDA 12.4 or
// later (runtime and driver).

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// the graph `stream` is capturing and its current dependencies
cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps,
                         const cudaGraphEdgeData** edges, size_t* n_deps) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
  *edges = nullptr;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, &id, graph, deps,
                                           edges, n_deps);
#else
  cudaError_t e = cudaStreamGetCaptureInfo_v3(stream, &status, &id, graph,
                                              deps, edges, n_deps);
#endif
  if (e != cudaSuccess) return e;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorIllegalState;
}

}  // namespace

extern "C" int nbody_graph_if_begin(void* stream, const bool* pred,
                                    void* child, int mode) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  const cudaGraphEdgeData* edges;
  size_t n_deps;
  cudaError_t e = capture_info(s, &graph, &deps, &edges, &n_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                       cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return static_cast<int>(e);
  set_if_kernel<<<1, 1, 0, s>>>(handle, pred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = capture_info(s, &graph, &deps, &edges, &n_deps);  // after the kernel
  if (e != cudaSuccess) return static_cast<int>(e);

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, deps, edges, n_deps, &params);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                          cudaStreamSetCaptureDependencies);
#else
  e = cudaGraphAddNode_v2(&node, graph, deps, edges, n_deps, &params);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(child), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, static_cast<cudaStreamCaptureMode>(mode)));
}

extern "C" int nbody_graph_if_end(void* child) {
  cudaGraph_t body;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body));
}

// a stream of this library's own for a branch's capture (never one of
// torch's pool, which could hand back the capturing stream itself)
extern "C" int nbody_graph_stream_create(void** stream) {
  cudaStream_t s;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *stream = s;
  return static_cast<int>(e);
}
