// R Jacobi rounds of Eq. 19 in one launch: the Hopper counterpart of
// src/repro/kernels/dekrr_solve.py::dekrr_solve_pallas (_dekrr_solve_kernel).
//
// The Pallas kernel relies on its (R, J) grid running in order, so round
// r + 1 sees all of round r. A CUDA grid has no order, so this kernel is one
// persistent launch in which every node is a thread-block cluster running
// the round kernel's node body (dekrr_common.cuh::eq19_node_cluster) round
// after round: grid (C, n_clusters), cluster dims (C, 1, 1), C and the rows
// per block from kernels/dekrr_solve.py::chain_plan (the round kernel's
// round_plan). Cluster q runs nodes j = q, q + n_clusters, ..., so J past
// the co-resident clusters still runs; every block of a cluster takes the
// same node sequence, so the cluster barriers inside the body never
// diverge. The launch is cooperative (cluster_launch.cuh) and
// cooperative_groups' grid barrier ends each round: it fences each block's
// writes at device scope before arriving, so round r's θ rows are visible
// to every cluster in round r + 1. Jacobi needs two θ tables: round r reads
// table r % 2 and writes table (r + 1) % 2, both seeded from θ0 so rows
// that no node owns stay at θ0. The tables live in a workspace the caller
// allocates.
//
// The residual trace res[r, j] is a cluster max (dekrr_common.cuh::
// cluster_max: each block pushes its partial into the cluster's shared
// memory, one cluster barrier, then the partials in rank order; max is
// exact, so its bits do not depend on the order), written by the
// cluster's block rank 0.
//
// Bound on the card: at one round it is bytes, as for the round kernel; over
// R rounds each input is still read from device memory only once in the
// count, so the bound becomes the R·2(2 + K)D²J flops. The blocks (22 MB at
// the paper's J = 10, D = 200, K = 4) fit in the 50 MB L2, so rounds after
// the first stream them from L2 through J·C SMs, as one round-kernel launch
// does.
//
// Each row is computed by the round kernel's routines, so this solve equals
// R round launches bit for bit.
#include <cooperative_groups.h>

#include "cluster_launch.cuh"
#include "dekrr_common.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T>
__global__ void __launch_bounds__(dekrr::kClusterThreads)
dekrr_solve_kernel(const T* __restrict__ g, const T* __restrict__ d,
                   const T* __restrict__ s, const T* __restrict__ p,
                   const T* __restrict__ theta0, const int* __restrict__ nbr_idx,
                   const int* __restrict__ self_idx,
                   const int* __restrict__ nbr_mask, T* __restrict__ out,
                   T* __restrict__ res, T* work, int R, int J, int K, int D,
                   int Dy, int T_rows, int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ dekrr::ClusterMax<T, 1> red;
  T* smem = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const bool leader = cluster.block_rank() == 0 && threadIdx.x == 0;
  const size_t rows = static_cast<size_t>(Dy) * D;
  const size_t n = static_cast<size_t>(T_rows) * rows;
  T* const tab1 = work + n;  // table 0 is `work`
  int calls = 0;             // cluster_max calls

  const size_t stride =
      static_cast<size_t>(gridDim.x) * gridDim.y * blockDim.x;
  const size_t tid =
      (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * blockDim.x +
      threadIdx.x;
  for (size_t i = tid; i < n; i += stride) {
    work[i] = theta0[i];
    tab1[i] = theta0[i];
  }
  grid.sync();

  for (int r = 0; r < R; ++r) {
    const T* rd = r & 1 ? tab1 : work;
    T* wr = r & 1 ? work : tab1;
    for (int j = blockIdx.y; j < J; j += gridDim.y) {
      T local[1] = {dekrr::eq19_node_cluster<T>(
          cluster, j, g, d, s, p, rd + self_idx[j] * rows,
          dekrr::TableRows<T>{rd, nbr_idx + static_cast<size_t>(j) * K, rows},
          nbr_mask, wr + self_idx[j] * rows, smem, K, D, Dy, rows_per_cta)};
      if (res != nullptr) {
        dekrr::cluster_max(cluster, local, red, calls);
        if (leader) res[static_cast<size_t>(r) * J + j] = local[0];
      }
    }
    grid.sync();
  }

  const T* fin = R & 1 ? tab1 : work;
  for (size_t i = tid; i < static_cast<size_t>(J) * rows; i += stride)
    out[i] = fin[self_idx[i / rows] * rows + i % rows];
}

template <typename T>
size_t smem_bytes(int K, int D, int Dy) {
  return dekrr::node_smem_elems(K, D, Dy) * sizeof(T);
}

template <typename T>
int max_clusters(int K, int D, int Dy, int cluster) {
  return cluster_max_active(dekrr_solve_kernel<T>, dekrr::kClusterThreads,
                            smem_bytes<T>(K, D, Dy), cluster);
}

template <typename T>
int launch(const void* g, const void* d, const void* s, const void* p,
           const void* theta0, const void* nbr_idx, const void* self_idx,
           const void* nbr_mask, void* out, void* res, void* work, int R, int J,
           int K, int D, int Dy, int T_rows, int cluster, int rows_per_cta,
           int n_clusters, void* stream) {
  if (cluster < 1 || cluster > 8 || rows_per_cta < 1 ||
      static_cast<long long>(cluster) * rows_per_cta < D || n_clusters > J)
    return static_cast<int>(cudaErrorInvalidValue);
  return cluster_launch_resident(
      dekrr_solve_kernel<T>, n_clusters, dekrr::kClusterThreads,
      smem_bytes<T>(K, D, Dy), cluster, stream, static_cast<const T*>(g),
      static_cast<const T*>(d), static_cast<const T*>(s),
      static_cast<const T*>(p), static_cast<const T*>(theta0),
      static_cast<const int*>(nbr_idx), static_cast<const int*>(self_idx),
      static_cast<const int*>(nbr_mask), static_cast<T*>(out),
      static_cast<T*>(res), static_cast<T*>(work), R, J, K, D, Dy, T_rows,
      rows_per_cta);
}

}  // namespace

extern "C" {

// Clusters of `cluster` blocks the device holds at once for a (K, D, Dy)
// problem (the most a launch may ask for), negative on a CUDA error.
int dekrr_solve_max_clusters_f64(int K, int D, int Dy, int cluster) {
  return max_clusters<double>(K, D, Dy, cluster);
}

int dekrr_solve_max_clusters_f32(int K, int D, int Dy, int cluster) {
  return max_clusters<float>(K, D, Dy, cluster);
}

// `cluster` blocks per node, each forming `rows_per_cta` rows (cluster ·
// rows_per_cta ≥ D), over `n_clusters` ≤ J clusters; a grid of more
// clusters than the device holds at once is refused
// (cudaErrorCooperativeLaunchTooLarge) and does not run.
int dekrr_solve_f64(const void* g, const void* d, const void* s, const void* p,
                    const void* theta0, const void* nbr_idx,
                    const void* self_idx, const void* nbr_mask, void* out,
                    void* res, void* work, int R, int J, int K, int D, int Dy,
                    int T_rows, int cluster, int rows_per_cta, int n_clusters,
                    void* stream) {
  return launch<double>(g, d, s, p, theta0, nbr_idx, self_idx, nbr_mask, out,
                        res, work, R, J, K, D, Dy, T_rows, cluster,
                        rows_per_cta, n_clusters, stream);
}

int dekrr_solve_f32(const void* g, const void* d, const void* s, const void* p,
                    const void* theta0, const void* nbr_idx,
                    const void* self_idx, const void* nbr_mask, void* out,
                    void* res, void* work, int R, int J, int K, int D, int Dy,
                    int T_rows, int cluster, int rows_per_cta, int n_clusters,
                    void* stream) {
  return launch<float>(g, d, s, p, theta0, nbr_idx, self_idx, nbr_mask, out,
                       res, work, R, J, K, D, Dy, T_rows, cluster,
                       rows_per_cta, n_clusters, stream);
}

// Dynamic shared memory of a block at (K, D, Dy), as the launcher passes it
// (repro_torch.analysis.smem checks the same formula before any launch).
int dekrr_solve_smem_bytes_f64(int K, int D, int Dy) {
  return static_cast<int>(smem_bytes<double>(K, D, Dy));
}

int dekrr_solve_smem_bytes_f32(int K, int D, int Dy) {
  return static_cast<int>(smem_bytes<float>(K, D, Dy));
}

}  // extern "C"
