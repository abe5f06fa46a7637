// The device-side loops of the fused ADMM drivers: one CUDA graph whose
// conditional WHILE nodes replay loop bodies captured from PyTorch until a
// flag in device memory is 0.
//
// Replaces: the lax.while_loop of exaadmm_tpu/algorithms/admm_two_level.py
// (_fused_outer_while: an outer loop around the inner one) and of
// exaadmm_tpu/algorithms/admm_one_level.py (_one_level_while). Not a TPU
// kernel: XLA compiled those loops into the device program. On Hopper the
// counterpart is a graph with conditional nodes (CUDA 12.4 or later).
//
// What bounds it on the H100: latency. set_condition is one thread reading
// one int and adding one to a 64-bit launch counter (20 bytes, one add);
// what it costs is one tiny kernel node per trip of a loop, in place of a
// kernel launch and a read-back by the host.
//
// Graph of two_level (every flag is written by the body before it):
//
//   set(h_out, outer_flag) -> WHILE h_out {
//       pre -> set(h_in, inner_flag) -> WHILE h_in { inner -> set(h_in, inner_flag) }
//       -> tail -> set(h_out, outer_flag) }
//
// and of one_level:  set(h, flag) -> WHILE h { body -> set(h, flag) }.
// A body is a child graph node (a clone of the captured graph, in which
// every event record and wait node has become an empty node with the same
// edges: a conditional body refuses event nodes, and a collective captured
// on its own stream can leave its fork and join in the body as events;
// inside one graph the edges give the same order); the handle
// is created on the graph that holds its WHILE node, whose first value the
// set node before the loop gives, so every launch starts from the flags in
// memory and not from a default. Every run of set_condition adds one to
// *count, the kernel's launch counter in device memory, which the caller
// reads back after the run.
//
// C interface (no PyTorch headers): graphs, executable graphs and streams as
// void*, flags and the counter as device pointers; every entry point returns
// a cudaError_t as int. The handles, the kernel and the graph come from
// this library's own (static) runtime.

#include <cuda_runtime.h>

#include <vector>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const int* flag, unsigned long long* count) {
  *count += 1;
  cudaGraphSetConditional(handle, *flag != 0 ? 1u : 0u);
}

cudaError_t add_set(cudaGraph_t graph, cudaGraphNode_t* node,
                    const cudaGraphNode_t* dep,
                    cudaGraphConditionalHandle handle, const int* flag,
                    unsigned long long* count) {
  void* args[] = {&handle, &flag, &count};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(set_condition);
  p.gridDim = dim3(1, 1, 1);
  p.blockDim = dim3(1, 1, 1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, dep, dep ? 1 : 0, &p);
}

// Each event record and wait node of ``g`` (and of its child graphs)
// replaced by an empty node with its edges; *rewritten counts them.
cudaError_t events_to_edges(cudaGraph_t g, int* rewritten) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(g, nodes.data(), &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    if (err != cudaSuccess) break;
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = events_to_edges(child, rewritten);
      continue;
    }
    if (t != cudaGraphNodeTypeEventRecord && t != cudaGraphNodeTypeWaitEvent) {
      continue;
    }
    size_t nin = 0, nout = 0;
    err = cudaGraphNodeGetDependencies(nodes[i], nullptr, &nin);
    if (err == cudaSuccess) {
      err = cudaGraphNodeGetDependentNodes(nodes[i], nullptr, &nout);
    }
    std::vector<cudaGraphNode_t> in(nin + 1), out(nout + 1);
    if (err == cudaSuccess && nin > 0) {
      err = cudaGraphNodeGetDependencies(nodes[i], in.data(), &nin);
    }
    if (err == cudaSuccess && nout > 0) {
      err = cudaGraphNodeGetDependentNodes(nodes[i], out.data(), &nout);
    }
    cudaGraphNode_t empty;
    if (err == cudaSuccess) {
      err = cudaGraphAddEmptyNode(&empty, g, nin ? in.data() : nullptr, nin);
    }
    for (size_t j = 0; err == cudaSuccess && j < nout; ++j) {
      err = cudaGraphAddDependencies(g, &empty, &out[j], 1);
    }
    if (err == cudaSuccess) err = cudaGraphDestroyNode(nodes[i]);
    if (err == cudaSuccess) *rewritten += 1;
  }
  return err;
}

// A child graph node of a clone of ``child`` with its event nodes made
// edges (``events_to_edges``).
cudaError_t add_child(cudaGraph_t graph, cudaGraphNode_t* node,
                      const cudaGraphNode_t* dep, void* child,
                      int* rewritten) {
  cudaGraph_t copy = nullptr;
  cudaError_t err = cudaGraphClone(&copy, static_cast<cudaGraph_t>(child));
  if (err == cudaSuccess) err = events_to_edges(copy, rewritten);
  if (err == cudaSuccess) {
    err = cudaGraphAddChildGraphNode(node, graph, dep, dep ? 1 : 0, copy);
  }
  if (copy != nullptr) cudaGraphDestroy(copy);
  return err;
}

// A WHILE node on ``handle`` after ``dep``; *body is the graph it runs.
cudaError_t add_while(cudaGraph_t graph, cudaGraphNode_t* node,
                      const cudaGraphNode_t* dep,
                      cudaGraphConditionalHandle handle, cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  cudaError_t err = cudaGraphAddNode(node, graph, dep, dep ? 1 : 0, &p);
  if (err == cudaSuccess) *body = p.conditional.phGraph_out[0];
  return err;
}

// Instantiate ``graph`` into *exec; on failure *bad_node_type is the type
// of the node that instantiation refused (-1 if it named none).
cudaError_t instantiate(cudaGraph_t graph, void** exec, int* bad_node_type) {
  cudaGraphInstantiateParams ip = {};
  ip.flags = 0;
  cudaGraphExec_t out = nullptr;
  cudaError_t err = cudaGraphInstantiateWithParams(&out, graph, &ip);
  *bad_node_type = -1;
  if (err != cudaSuccess) {
    cudaGraphNodeType t;
    if (ip.errNode_out != nullptr &&
        cudaGraphNodeGetType(ip.errNode_out, &t) == cudaSuccess) {
      *bad_node_type = static_cast<int>(t);
    }
    return err;
  }
  *exec = out;
  return cudaSuccess;
}

}  // namespace

#define TRY(expr)                                    \
  do {                                               \
    cudaError_t e_ = (expr);                         \
    if (e_ != cudaSuccess) {                         \
      if (top != nullptr) cudaGraphDestroy(top);     \
      return static_cast<int>(e_);                   \
    }                                                \
  } while (0)

extern "C" {

// The CUDA driver's version (12040 for 12.4), to refuse an older one.
int driver_version(int* version) {
  return static_cast<int>(cudaDriverGetVersion(version));
}

// The outer loop around the inner one; ``pre``, ``inner`` and ``tail`` are
// cudaGraph_t of the captured bodies (cloned here); *rewritten is the
// number of their event nodes made edges.
int graph_loop_two_level(void* pre, void* inner, void* tail,
                         const int* inner_flag, const int* outer_flag,
                         unsigned long long* count, int device, void** exec,
                         int* bad_node_type, int* rewritten) {
  cudaGraph_t top = nullptr;
  *bad_node_type = -1;
  *rewritten = 0;
  TRY(cudaSetDevice(device));
  TRY(cudaGraphCreate(&top, 0));
  cudaGraphConditionalHandle h_out, h_in;
  TRY(cudaGraphConditionalHandleCreate(&h_out, top, 0, 0));
  cudaGraphNode_t first, outer_loop;
  cudaGraph_t outer_body, inner_body;
  TRY(add_set(top, &first, nullptr, h_out, outer_flag, count));
  TRY(add_while(top, &outer_loop, &first, h_out, &outer_body));

  TRY(cudaGraphConditionalHandleCreate(&h_in, outer_body, 0, 0));
  cudaGraphNode_t pre_node, inner_first, inner_loop, tail_node, outer_next;
  TRY(add_child(outer_body, &pre_node, nullptr, pre, rewritten));
  TRY(add_set(outer_body, &inner_first, &pre_node, h_in, inner_flag,
              count));
  TRY(add_while(outer_body, &inner_loop, &inner_first, h_in, &inner_body));
  TRY(add_child(outer_body, &tail_node, &inner_loop, tail, rewritten));
  TRY(add_set(outer_body, &outer_next, &tail_node, h_out, outer_flag,
              count));

  cudaGraphNode_t inner_node, inner_next;
  TRY(add_child(inner_body, &inner_node, nullptr, inner, rewritten));
  TRY(add_set(inner_body, &inner_next, &inner_node, h_in, inner_flag,
              count));

  TRY(instantiate(top, exec, bad_node_type));
  cudaGraphDestroy(top);
  return 0;
}

// One loop around ``body`` (a cudaGraph_t, cloned here), *rewritten as in
// graph_loop_two_level.
int graph_loop_one_level(void* body, const int* flag,
                         unsigned long long* count, int device, void** exec,
                         int* bad_node_type, int* rewritten) {
  cudaGraph_t top = nullptr;
  *bad_node_type = -1;
  *rewritten = 0;
  TRY(cudaSetDevice(device));
  TRY(cudaGraphCreate(&top, 0));
  cudaGraphConditionalHandle h;
  TRY(cudaGraphConditionalHandleCreate(&h, top, 0, 0));
  cudaGraphNode_t first, loop, body_node, next;
  cudaGraph_t loop_body;
  TRY(add_set(top, &first, nullptr, h, flag, count));
  TRY(add_while(top, &loop, &first, h, &loop_body));
  TRY(add_child(loop_body, &body_node, nullptr, body, rewritten));
  TRY(add_set(loop_body, &next, &body_node, h, flag, count));
  TRY(instantiate(top, exec, bad_node_type));
  cudaGraphDestroy(top);
  return 0;
}

int graph_loop_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(
      static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

int graph_loop_destroy(void* exec) {
  return static_cast<int>(
      cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

// counts[t] += the nodes of type t in ``graph``, child graphs included
// (types at or above ``ntypes`` go to counts[ntypes - 1]).
int graph_node_types(void* graph, int* counts, int ntypes) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes(g, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    if (err != cudaSuccess) break;
    int k = static_cast<int>(t);
    counts[k < ntypes ? k : ntypes - 1] += 1;
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) {
        err = static_cast<cudaError_t>(graph_node_types(child, counts,
                                                        ntypes));
      }
    }
  }
  delete[] nodes;
  return static_cast<int>(err);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
