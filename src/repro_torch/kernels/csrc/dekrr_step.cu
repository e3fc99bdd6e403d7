// One Eq. 19 round over all nodes: the Hopper counterpart of
// src/repro/kernels/dekrr_step.py::dekrr_step_pallas (_dekrr_step_kernel)
// and, with an activation mask, of its masked variant
// (_dekrr_step_masked_kernel) that the asynchronous-gossip rounds run.
//
// Bound on the card: bytes. Each node reads (2 + K) D×D blocks (G, S, P)
// once and does 2 flops per element read (dekrr_common.cuh). At the paper's
// J = 10, K = 4, D = 200 that is 19 MB a round, 5.7 µs at 3.35 TB/s.
//
// One block per node would stream a node's 1.9 MB through one SM: 10 of
// 132 SMs at ~13 GB/s each. The node's two phases, acc = d + Sθ + ΣPθ and
// then out = G acc, are what kept it on one SM: the second needs all of
// acc. Here each node is one thread-block cluster of C blocks of 32 warps
// (grid (C, J), cluster dims (C, 1, 1), C at most the portable 8; 7 at
// D = 200, one row a warp; C and the rows per block from the wrapper,
// kernels/dekrr_step.py::round_plan), and the cluster's distributed shared
// memory carries acc between the phases: dekrr_common.cuh's
// eq19_node_cluster, the node body the multi-round solve and the async
// chain run too. Only the assignment of rows to blocks differs between the
// kernels, and a row's bits do not depend on it. So the fused chains equal
// per-round launches bit for bit.
//
// `active` ([J] int32, or null for all ones) gates each node: an inactive
// node's cluster copies its own θ rows from the table to the output and
// reads no G/S/P block. Active nodes run the unchanged rows, so an all-ones
// mask gives the unmasked round bit for bit.
#include <cooperative_groups.h>

#include "cluster_launch.cuh"
#include "dekrr_common.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T>
__global__ void __launch_bounds__(dekrr::kClusterThreads)
dekrr_step_kernel(const T* __restrict__ g, const T* __restrict__ d,
                  const T* __restrict__ s, const T* __restrict__ p,
                  const T* __restrict__ table, const int* __restrict__ nbr_idx,
                  const int* __restrict__ self_idx,
                  const int* __restrict__ nbr_mask,
                  const int* __restrict__ active, T* __restrict__ out, int K,
                  int D, int Dy, int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int j = blockIdx.y;
  const size_t rows = static_cast<size_t>(Dy) * D;
  const T* self_src = table + static_cast<size_t>(self_idx[j]) * rows;
  T* out_j = out + j * rows;

  if (active != nullptr && active[j] == 0) {
    const int C = static_cast<int>(cluster.num_blocks());
    for (size_t i = static_cast<size_t>(cluster.block_rank()) * blockDim.x +
                    threadIdx.x;
         i < rows; i += static_cast<size_t>(C) * blockDim.x)
      out_j[i] = self_src[i];
    return;  // the whole cluster takes this branch: no cluster barrier
  }
  dekrr::eq19_node_cluster(
      cluster, j, g, d, s, p, self_src,
      dekrr::TableRows<T>{table, nbr_idx + static_cast<size_t>(j) * K, rows},
      nbr_mask, out_j, reinterpret_cast<T*>(smem_raw), K, D, Dy,
      rows_per_cta);
}

template <typename T>
int launch(const void* g, const void* d, const void* s, const void* p,
           const void* table, const void* nbr_idx, const void* self_idx,
           const void* nbr_mask, const void* active, void* out, int J, int K,
           int D, int Dy, int cluster, int rows_per_cta, void* stream) {
  if (cluster < 1 || cluster > 8 || rows_per_cta < 1 ||
      static_cast<long long>(cluster) * rows_per_cta < D)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dekrr::node_smem_elems(K, D, Dy) * sizeof(T);
  return cluster_launch(
      dekrr_step_kernel<T>, dim3(cluster, J), dekrr::kClusterThreads, smem,
      cluster, stream, static_cast<const T*>(g), static_cast<const T*>(d),
      static_cast<const T*>(s), static_cast<const T*>(p),
      static_cast<const T*>(table), static_cast<const int*>(nbr_idx),
      static_cast<const int*>(self_idx), static_cast<const int*>(nbr_mask),
      static_cast<const int*>(active), static_cast<T*>(out), K, D, Dy,
      rows_per_cta);
}

}  // namespace

extern "C" {

// `active` may be null (every node active). `cluster` blocks per node, each
// forming `rows_per_cta` rows (cluster · rows_per_cta ≥ D).
int dekrr_step_f64(const void* g, const void* d, const void* s, const void* p,
                   const void* table, const void* nbr_idx, const void* self_idx,
                   const void* nbr_mask, const void* active, void* out, int J,
                   int K, int D, int Dy, int cluster, int rows_per_cta,
                   void* stream) {
  return launch<double>(g, d, s, p, table, nbr_idx, self_idx, nbr_mask, active,
                        out, J, K, D, Dy, cluster, rows_per_cta, stream);
}

int dekrr_step_f32(const void* g, const void* d, const void* s, const void* p,
                   const void* table, const void* nbr_idx, const void* self_idx,
                   const void* nbr_mask, const void* active, void* out, int J,
                   int K, int D, int Dy, int cluster, int rows_per_cta,
                   void* stream) {
  return launch<float>(g, d, s, p, table, nbr_idx, self_idx, nbr_mask, active,
                       out, J, K, D, Dy, cluster, rows_per_cta, stream);
}

// Dynamic shared memory of a block at (K, D, Dy), as the launcher passes it
// (repro_torch.analysis.smem checks the same formula before any launch).
int dekrr_step_smem_bytes_f64(int K, int D, int Dy) {
  return static_cast<int>(dekrr::node_smem_elems(K, D, Dy) * sizeof(double));
}

int dekrr_step_smem_bytes_f32(int K, int D, int Dy) {
  return static_cast<int>(dekrr::node_smem_elems(K, D, Dy) * sizeof(float));
}

}  // extern "C"
