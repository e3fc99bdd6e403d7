// R Chebyshev-accelerated rounds of Eq. 19 in one launch: the Hopper
// counterpart of src/repro/kernels/dekrr_solve.py::dekrr_cheb_solve_pallas
// (_dekrr_cheb_solve_kernel).
//
// Built as dekrr_solve.cu: one persistent cooperative launch of grid (C,
// n_clusters), cluster dims (C, 1, 1), C and the rows per block from
// kernels/dekrr_solve.py::chain_plan. Cluster q runs nodes j = q,
// q + n_clusters, ..., every block of it the same sequence, and
// cooperative_groups' grid barrier ends each round. The state:
//   two round-parity θ tables [T*Dy, D] in `work`, both seeded from θ0
//                       (round r reads table r % 2, writes (r + 1) % 2);
//   pdir [J*Dy, D]      each node's search direction p, node j at row block
//                       j (owner-only, no parity; written in place in the
//                       output array, seeded from delta0);
//   alpha, beta [R]     the precomputed schedule on the device.
// Per round r and node j, the node's cluster runs dekrr_common.cuh::
// eq19_node_cluster (the round kernel's body), which writes F(θ)'s rows
// into the write-parity table; then each block updates only the rows it
// formed ([a0, a1) of every output column), in place there and in pdir:
//   p ← (F(θ) − θ_self) + β_r·p,   θ ← θ_self + α_r·p,
// each operation rounded on its own (__dsub_rn, __dmul_rn, __dadd_rn; the
// __f*_rn forms in f32), with no FMA contraction, in the order of
// core/acceleration.py::chebyshev_scan. F(θ) is the round kernel's rows
// bit for bit, so one launch equals the per-round `cuda` backend
// (step_batched through the round kernel, then torch's elementwise ops)
// bit for bit. With a trace, res[r, j] = max|θ_new − θ_self| (the step
// taken, not the F-residual), one cluster max per node and round
// (dekrr_common.cuh::cluster_max), written by the cluster's block rank 0.
// Both θ and p rows are outputs, so chunked launches chain bit for bit.
//
// One grid barrier a round is enough: cross-node reads touch only the
// read-parity table, and each block writes only its own rows of the other
// table and of pdir.
//
// Bound on the card: as for dekrr_solve.cu, the inputs are read from
// device memory once in the count, so over R rounds the bound is the
// rounds' flops.
#include <cooperative_groups.h>

#include "cluster_launch.cuh"
#include "dekrr_common.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(dekrr::kClusterThreads)
dekrr_cheb_solve_kernel(const T* __restrict__ g, const T* __restrict__ d,
                        const T* __restrict__ s, const T* __restrict__ p,
                        const T* __restrict__ theta0,
                        const T* __restrict__ delta0,
                        const int* __restrict__ nbr_idx,
                        const int* __restrict__ self_idx,
                        const int* __restrict__ nbr_mask,
                        const T* __restrict__ alpha, const T* __restrict__ beta,
                        T* __restrict__ out_theta, T* pdir, T* __restrict__ res,
                        T* work, int R, int J, int K, int D, int Dy,
                        int T_rows, int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ dekrr::ClusterMax<T, 1> red;
  T* smem = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const bool leader = rank == 0 && threadIdx.x == 0;
  const size_t rows = static_cast<size_t>(Dy) * D;
  const size_t n = static_cast<size_t>(T_rows) * rows;
  T* const tab1 = work + n;  // table 0 is `work`
  int calls = 0;             // cluster_max calls
  // this block's own rows of the round: [a0, a1) of every output column
  const int a0 = rank * rows_per_cta;
  const int own_n = max(0, min(D, a0 + rows_per_cta) - a0);

  const size_t stride =
      static_cast<size_t>(gridDim.x) * gridDim.y * blockDim.x;
  const size_t tid =
      (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * blockDim.x +
      threadIdx.x;
  for (size_t i = tid; i < n; i += stride) {
    work[i] = theta0[i];
    tab1[i] = theta0[i];
  }
  for (size_t i = tid; i < static_cast<size_t>(J) * rows; i += stride)
    pdir[i] = delta0[i];
  grid.sync();

  for (int r = 0; r < R; ++r) {
    const T* rd = r & 1 ? tab1 : work;
    T* wr = r & 1 ? work : tab1;
    const T a = alpha[r];
    const T b = beta[r];
    for (int j = blockIdx.y; j < J; j += gridDim.y) {
      T* own = wr + static_cast<size_t>(self_idx[j]) * rows;
      dekrr::eq19_node_cluster<T>(
          cluster, j, g, d, s, p, rd + static_cast<size_t>(self_idx[j]) * rows,
          dekrr::TableRows<T>{rd, nbr_idx + static_cast<size_t>(j) * K, rows},
          nbr_mask, own, smem, K, D, Dy, rows_per_cta);
      const T* th = smem;  // the staged θ_self rows
      T* pj = pdir + static_cast<size_t>(j) * rows;
      T local[1] = {T(0)};
      for (int e = threadIdx.x; e < Dy * own_n; e += blockDim.x) {
        const size_t i = static_cast<size_t>(e / own_n) * D + a0 + e % own_n;
        const T pn = add_rn(sub_rn(own[i], th[i]), mul_rn(b, pj[i]));
        const T tn = add_rn(th[i], mul_rn(a, pn));
        own[i] = tn;
        pj[i] = pn;
        local[0] = fmax(local[0], fabs(sub_rn(tn, th[i])));
      }
      if (res != nullptr) {
        dekrr::cluster_max(cluster, local, red, calls);
        if (leader) res[static_cast<size_t>(r) * J + j] = local[0];
      }
      __syncthreads();  // th is restaged by the next node
    }
    grid.sync();
  }

  const T* fin = R & 1 ? tab1 : work;
  for (size_t i = tid; i < static_cast<size_t>(J) * rows; i += stride)
    out_theta[i] = fin[self_idx[i / rows] * rows + i % rows];
}

template <typename T>
size_t smem_bytes(int K, int D, int Dy) {
  return dekrr::node_smem_elems(K, D, Dy) * sizeof(T);
}

template <typename T>
int max_clusters(int K, int D, int Dy, int cluster) {
  return cluster_max_active(dekrr_cheb_solve_kernel<T>, dekrr::kClusterThreads,
                            smem_bytes<T>(K, D, Dy), cluster);
}

template <typename T>
int launch(const void* g, const void* d, const void* s, const void* p,
           const void* theta0, const void* delta0, const void* nbr_idx,
           const void* self_idx, const void* nbr_mask, const void* alpha,
           const void* beta, void* out_theta, void* pdir, void* res,
           void* work, int R, int J, int K, int D, int Dy, int T_rows,
           int cluster, int rows_per_cta, int n_clusters, void* stream) {
  if (cluster < 1 || cluster > 8 || rows_per_cta < 1 ||
      static_cast<long long>(cluster) * rows_per_cta < D || n_clusters > J)
    return static_cast<int>(cudaErrorInvalidValue);
  return cluster_launch_resident(
      dekrr_cheb_solve_kernel<T>, n_clusters, dekrr::kClusterThreads,
      smem_bytes<T>(K, D, Dy), cluster, stream, static_cast<const T*>(g),
      static_cast<const T*>(d), static_cast<const T*>(s),
      static_cast<const T*>(p), static_cast<const T*>(theta0),
      static_cast<const T*>(delta0), static_cast<const int*>(nbr_idx),
      static_cast<const int*>(self_idx), static_cast<const int*>(nbr_mask),
      static_cast<const T*>(alpha), static_cast<const T*>(beta),
      static_cast<T*>(out_theta), static_cast<T*>(pdir), static_cast<T*>(res),
      static_cast<T*>(work), R, J, K, D, Dy, T_rows, rows_per_cta);
}

}  // namespace

extern "C" {

// Clusters of `cluster` blocks the device holds at once for a (K, D, Dy)
// problem (the most a launch may ask for), negative on a CUDA error.
int dekrr_cheb_solve_max_clusters_f64(int K, int D, int Dy, int cluster) {
  return max_clusters<double>(K, D, Dy, cluster);
}

int dekrr_cheb_solve_max_clusters_f32(int K, int D, int Dy, int cluster) {
  return max_clusters<float>(K, D, Dy, cluster);
}

// res [R, J] may be null (no trace). `work` holds 2*T*Dy*D elements.
// `cluster`, `rows_per_cta` and `n_clusters` as for dekrr_solve_f64.
int dekrr_cheb_solve_f64(const void* g, const void* d, const void* s,
                         const void* p, const void* theta0, const void* delta0,
                         const void* nbr_idx, const void* self_idx,
                         const void* nbr_mask, const void* alpha,
                         const void* beta, void* out_theta, void* pdir,
                         void* res, void* work, int R, int J, int K, int D,
                         int Dy, int T_rows, int cluster, int rows_per_cta,
                         int n_clusters, void* stream) {
  return launch<double>(g, d, s, p, theta0, delta0, nbr_idx, self_idx,
                        nbr_mask, alpha, beta, out_theta, pdir, res, work, R, J,
                        K, D, Dy, T_rows, cluster, rows_per_cta, n_clusters,
                        stream);
}

int dekrr_cheb_solve_f32(const void* g, const void* d, const void* s,
                         const void* p, const void* theta0, const void* delta0,
                         const void* nbr_idx, const void* self_idx,
                         const void* nbr_mask, const void* alpha,
                         const void* beta, void* out_theta, void* pdir,
                         void* res, void* work, int R, int J, int K, int D,
                         int Dy, int T_rows, int cluster, int rows_per_cta,
                         int n_clusters, void* stream) {
  return launch<float>(g, d, s, p, theta0, delta0, nbr_idx, self_idx, nbr_mask,
                       alpha, beta, out_theta, pdir, res, work, R, J, K, D, Dy,
                       T_rows, cluster, rows_per_cta, n_clusters, stream);
}

}  // extern "C"
