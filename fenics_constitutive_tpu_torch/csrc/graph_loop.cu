// CUDA-graph while nodes for the compiled step: the device side of the
// port's counterpart of jax.lax.while_loop (solver/compiled.py::device_while).
//
// Replaces no TPU kernel: JAX compiles a data-dependent loop into its program
// with lax.while_loop (fenics_constitutive_tpu/solver/linear.py::cg_solve,
// solver/packed_step.py's converged Newton, models/packed_models.py's Mises
// local Newton). A plain CUDA graph replays a fixed list of launches; a
// conditional node of type while (CUDA 12.4+) runs its body graph again for
// as long as its handle holds a non-zero value, which a kernel in the graph
// sets from a predicate in device memory. The host reads nothing back.
//
// What this file holds:
//   - set_conditional_kernel, one thread: handle <- (*pred != 0). Bound by
//     one launch (a few microseconds in a graph); it moves one byte.
//   - the host functions that compose a parent graph from graphs captured by
//     torch (child-graph nodes) and while nodes whose body is a child graph
//     followed by the set-conditional kernel node, check the node types a
//     conditional body may hold, instantiate and launch it.
// The wrapper (solver/graph_loop.py) checks every return code and raises.
#include <cuda_runtime.h>

#include <vector>

#include "common.cuh"

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const unsigned char* pred) {
  cudaGraphSetConditional(handle, *pred != 0 ? 1u : 0u);
}

cudaError_t add_set_conditional(cudaGraphNode_t* node, cudaGraph_t graph,
                                const cudaGraphNode_t* deps, size_t ndeps,
                                cudaGraphConditionalHandle handle, const void* pred) {
  cudaKernelNodeParams p = {};
  const void* pred_arg = pred;
  void* args[2] = {&handle, &pred_arg};
  p.func = reinterpret_cast<void*>(set_conditional_kernel);
  p.gridDim = dim3(1, 1, 1);
  p.blockDim = dim3(1, 1, 1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, ndeps, &p);
}

bool device_pointer(const void* ptr) {
  cudaPointerAttributes attr = {};
  if (cudaPointerGetAttributes(&attr, ptr) != cudaSuccess) {
    cudaGetLastError();  // clear the error this call leaves on a host pointer
    return false;
  }
  return attr.type == cudaMemoryTypeDevice;
}

// The node types a while node's body may hold (CUDA programming guide,
// conditional nodes): kernels, memsets, device-to-device copies, empty,
// child-graph and conditional nodes. *bad = the first other type, else -1.
cudaError_t check_graph(cudaGraph_t graph, int* bad) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(graph, nullptr, &n);
  if (e != cudaSuccess) return e;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) {
    e = cudaGraphGetNodes(graph, nodes.data(), &n);
    if (e != cudaSuccess) return e;
  }
  for (size_t i = 0; i < n && *bad < 0; ++i) {
    cudaGraphNodeType type;
    e = cudaGraphNodeGetType(nodes[i], &type);
    if (e != cudaSuccess) return e;
    switch (type) {
      case cudaGraphNodeTypeKernel:
      case cudaGraphNodeTypeMemset:
      case cudaGraphNodeTypeEmpty:
      case cudaGraphNodeTypeConditional:
        break;
      case cudaGraphNodeTypeMemcpy: {
        cudaMemcpy3DParms p = {};
        e = cudaGraphMemcpyNodeGetParams(nodes[i], &p);
        if (e != cudaSuccess) return e;
        const bool d2d = p.kind == cudaMemcpyDeviceToDevice ||
                         (p.kind == cudaMemcpyDefault && p.srcArray == nullptr &&
                          p.dstArray == nullptr && device_pointer(p.srcPtr.ptr) &&
                          device_pointer(p.dstPtr.ptr));
        if (!d2d) *bad = static_cast<int>(type);
        break;
      }
      case cudaGraphNodeTypeGraph: {
        cudaGraph_t child = nullptr;
        e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
        if (e != cudaSuccess) return e;
        e = check_graph(child, bad);
        if (e != cudaSuccess) return e;
        break;
      }
      default:
        *bad = static_cast<int>(type);
    }
  }
  return cudaSuccess;
}

}  // namespace

// Entry points. Graphs, nodes and executable graphs travel as opaque
// pointers; ``dep`` is the node the new node follows (nullptr: none). Each
// returns a cudaError_t (0 = success).

extern "C" int fct_graph_create(void** graph) {
  cudaGraph_t g = nullptr;
  const cudaError_t e = cudaGraphCreate(&g, 0);
  *graph = g;
  return static_cast<int>(e);
}

// *nodes = the number of nodes of ``graph`` (0: an empty segment)
extern "C" int fct_graph_count(void* graph, unsigned long long* nodes) {
  size_t n = 0;
  const cudaError_t e = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
  *nodes = n;
  return static_cast<int>(e);
}

// *bad = the cudaGraphNodeType of the first node of ``graph`` (or of a child
// graph) that a conditional body may not hold, or -1
extern "C" int fct_graph_check(void* graph, int* bad) {
  *bad = -1;
  return static_cast<int>(check_graph(static_cast<cudaGraph_t>(graph), bad));
}

// a child-graph node of ``graph`` holding a copy of ``child``
extern "C" int fct_graph_add_child(void* graph, void* dep, void* child, void** node) {
  cudaGraphNode_t n = nullptr;
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  const cudaError_t e = cudaGraphAddChildGraphNode(&n, static_cast<cudaGraph_t>(graph),
                                                   d ? &d : nullptr, d ? 1 : 0,
                                                   static_cast<cudaGraph_t>(child));
  *node = n;
  return static_cast<int>(e);
}

// A while loop in ``graph`` after ``dep``: the set-conditional kernel node
// (handle <- *pred), then the while node. Returns the while node, its body
// graph (empty: the caller fills it and ends it with fct_graph_add_set) and
// the handle.
extern "C" int fct_graph_add_while(void* graph, void* dep, const void* pred, void** node,
                                   void** body, unsigned long long* handle) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphConditionalHandle h = 0;
  cudaError_t e = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaGraphNode_t set = nullptr;
  e = add_set_conditional(&set, g, d ? &d : nullptr, d ? 1 : 0, h, pred);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  cudaGraphNode_t w = nullptr;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&w, g, &set, nullptr, 1, &p);
#else
  e = cudaGraphAddNode(&w, g, &set, 1, &p);
#endif
  if (e != cudaSuccess) return static_cast<int>(e);
  *node = w;
  *body = p.conditional.phGraph_out[0];
  *handle = h;
  return 0;
}

// the set-conditional kernel node (handle <- *pred) in ``graph`` after ``dep``
extern "C" int fct_graph_add_set(void* graph, void* dep, unsigned long long handle,
                                 const void* pred, void** node) {
  cudaGraphNode_t n = nullptr;
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  const cudaError_t e = add_set_conditional(&n, static_cast<cudaGraph_t>(graph),
                                            d ? &d : nullptr, d ? 1 : 0,
                                            static_cast<cudaGraphConditionalHandle>(handle),
                                            pred);
  *node = n;
  return static_cast<int>(e);
}

// Instantiate ``graph``; *result = the cudaGraphInstantiateResult
extern "C" int fct_graph_instantiate(void* graph, void** exec, int* result) {
  cudaGraphInstantiateParams p = {};
  p.flags = 0;
  cudaGraphExec_t x = nullptr;
  const cudaError_t e = cudaGraphInstantiateWithParams(&x, static_cast<cudaGraph_t>(graph), &p);
  *exec = x;
  *result = static_cast<int>(p.result_out);
  return static_cast<int>(e);
}

extern "C" int fct_graph_launch(void* exec, void* stream) {
  cudaError_t e = cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fct_graph_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = e2;
  }
  return static_cast<int>(e);
}

// the CUDA runtime version this library was built against (e.g. 12080)
extern "C" int fct_graph_runtime_version(int* build, int* driver) {
  *build = CUDART_VERSION;
  return static_cast<int>(cudaDriverGetVersion(driver));
}
