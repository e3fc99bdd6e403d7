// One Eq. 19 round over all nodes: the Hopper counterpart of
// src/repro/kernels/dekrr_step.py::dekrr_step_pallas (_dekrr_step_kernel).
//
// Bound on the card: bytes. Each node reads (2 + K) D×D blocks (G, S, P)
// once and does 2 flops per element read, far below the ~20 flop/byte an
// H100 needs in f64 before arithmetic limits it. The design therefore only
// has to stream every block once with coalesced loads: one block of 256
// threads per node, one warp per matrix row (see dekrr_common.cuh), θ row
// blocks staged in shared memory. The TPU kernel's scalar prefetch becomes
// each block reading its own slot-table entries.
#include "dekrr_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(dekrr::kThreads)
dekrr_step_kernel(const T* __restrict__ g, const T* __restrict__ d,
                  const T* __restrict__ s, const T* __restrict__ p,
                  const T* __restrict__ table, const int* __restrict__ nbr_idx,
                  const int* __restrict__ self_idx,
                  const int* __restrict__ nbr_mask, T* __restrict__ out, int J,
                  int K, int D, int Dy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const size_t rows = static_cast<size_t>(Dy) * D;
  for (int j = blockIdx.x; j < J; j += gridDim.x)
    dekrr::eq19_node<T>(j, g, d, s, p, table, nbr_idx, self_idx, nbr_mask,
                        out + j * rows, smem, K, D, Dy);
}

template <typename T>
int launch(const void* g, const void* d, const void* s, const void* p,
           const void* table, const void* nbr_idx, const void* self_idx,
           const void* nbr_mask, void* out, int J, int K, int D, int Dy,
           void* stream) {
  const size_t smem = dekrr::node_smem_elems(K, D, Dy) * sizeof(T);
  cudaError_t err = dekrr::allow_smem(dekrr_step_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dekrr_step_kernel<T><<<J, dekrr::kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const T*>(d),
      static_cast<const T*>(s), static_cast<const T*>(p),
      static_cast<const T*>(table), static_cast<const int*>(nbr_idx),
      static_cast<const int*>(self_idx), static_cast<const int*>(nbr_mask),
      static_cast<T*>(out), J, K, D, Dy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dekrr_step_f64(const void* g, const void* d, const void* s, const void* p,
                   const void* table, const void* nbr_idx, const void* self_idx,
                   const void* nbr_mask, void* out, int J, int K, int D, int Dy,
                   void* stream) {
  return launch<double>(g, d, s, p, table, nbr_idx, self_idx, nbr_mask, out, J,
                        K, D, Dy, stream);
}

int dekrr_step_f32(const void* g, const void* d, const void* s, const void* p,
                   const void* table, const void* nbr_idx, const void* self_idx,
                   const void* nbr_mask, void* out, int J, int K, int D, int Dy,
                   void* stream) {
  return launch<float>(g, d, s, p, table, nbr_idx, self_idx, nbr_mask, out, J,
                       K, D, Dy, stream);
}

}  // extern "C"
