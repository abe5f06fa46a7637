// Bus scatter: out[b, c] = sum of vals[r, c] over the rows r of segment b.
//
// Replaces: exaadmm_tpu/ops/bus_pallas.py::kr_scatter_pallas, the line->bus
// aggregation of the bus (xbar) update (exaadmm_tpu/models/acopf/kernels.py
// bus_update, the 8 per-arc sums), and serves the generator->bus sums of
// the same update.
//
// What bounds it on the H100: bytes by count, latency in fact. Each output
// reads its segment's rows once: about (R * C + nseg * C) values plus the
// CSR, for R = 2 * nline arcs and C = 8 channels (about 2.8 MB at 9,241
// buses, under a microsecond at 3.35 TB/s); there is almost no arithmetic.
// At these sizes the launch is one short wave, so what sets its time is the
// chain of dependent loads of its slowest thread: ptr, then idx[k], then
// vals[idx[k]], once for every row of the segment.
//
// Design: one thread per (segment, channel), threads in (segment, channel)
// order, so a warp reads whole rows (4 segments x 8 channels of fp64 is 4
// rows of 64 bytes). The thread adds its segment's rows in the CSR order
// (ptr, idx), ascending, into a register that starts at zero: the same
// order as index_add_ on the CPU, and with no atomics the sum is
// bit-identical from run to run (index_add_ on the GPU adds with atomics in
// no fixed order). The load chain is broken into three independent rounds
// per chunk of kChunk rows: all kChunk idx loads, then all kChunk vals
// loads, then the adds in order. A segment of up to kChunk rows (every bus
// of the synthetic 9,241-bus grid has at most 17 arcs) then costs three
// dependent loads instead of two per row. The TPU kernel's one-hot
// Khatri-Rao matmuls and bf16 split were matrix-unit tricks and are gone.
//
// C interface (no PyTorch headers): pointers and the stream as void*, every
// entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bus_scatter_kernel(const T* __restrict__ vals, const int* __restrict__ ptr,
                       const int* __restrict__ idx, T* __restrict__ out,
                       int nseg, int nch) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(nseg) * nch) return;
  const int seg = static_cast<int>(tid / nch);
  const int ch = static_cast<int>(tid - static_cast<long long>(seg) * nch);
  const int k0 = __ldg(ptr + seg);
  const int k1 = __ldg(ptr + seg + 1);
  T acc = T(0);
  for (int k = k0; k < k1; k += kChunk) {
    int row[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      row[u] = (k + u < k1) ? __ldg(idx + k + u) : 0;
    T v[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      v[u] = (k + u < k1)
                 ? __ldg(vals + static_cast<long long>(row[u]) * nch + ch)
                 : T(0);
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (k + u < k1) acc = acc + v[u];
  }
  out[tid] = acc;
}

template <typename T>
int launch(const void* vals, const void* ptr, const void* idx, void* out,
           int nseg, int nch, void* stream) {
  const long long total = static_cast<long long>(nseg) * nch;
  if (total > 0) {
    const unsigned blocks =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    bus_scatter_kernel<T><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(vals), static_cast<const int*>(ptr),
        static_cast<const int*>(idx), static_cast<T*>(out), nseg, nch);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int bus_scatter_f64(const void* vals, const void* ptr, const void* idx,
                    void* out, int nseg, int nch, void* stream) {
  return launch<double>(vals, ptr, idx, out, nseg, nch, stream);
}

int bus_scatter_f32(const void* vals, const void* ptr, const void* idx,
                    void* out, int nseg, int nch, void* stream) {
  return launch<float>(vals, ptr, idx, out, nseg, nch, stream);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
