// R Chebyshev-accelerated rounds of Eq. 19 in one launch: the Hopper
// counterpart of src/repro/kernels/dekrr_solve.py::dekrr_cheb_solve_pallas
// (_dekrr_cheb_solve_kernel).
//
// Per round r and node j: F(θ) is the synchronous round's rows, then the
// node's own rows are updated elementwise,
//   p ← (F(θ) − θ_self) + β_r·p,   θ ← θ_self + α_r·p,
// each operation rounded on its own (__dsub_rn, __dmul_rn, __dadd_rn; the
// __f*_rn forms in f32), with no FMA contraction, in the order of
// core/acceleration.py::chebyshev_scan. F(θ) is the round kernel's rows bit
// for bit, so one launch equals the per-round `cuda` backend (step_batched
// through the round kernel, then torch's elementwise ops) bit for bit. With
// a trace, res[r, j] = max|θ_new − θ_self| (the step taken, not the
// F-residual). Both θ and p rows are outputs, so chunked launches chain bit
// for bit. The chain reads what the synchronous chain reads and writes only
// its own rows, so kernels/dekrr_solve.py::cheb_plan picks between the
// synchronous chain's two routes by the same rule (dekrr_solve.cu):
//
// The resident route (`dekrr_cheb_solve_resident_kernel`): one cluster of
// C blocks per node, built from dekrr_common.cuh::Resident (S, the live P
// and d rows in shared memory, G in registers, read once a launch), running
// the synchronous chains' resident rounds (dekrr_common.cuh::
// resident_sync_rounds, as dekrr_solve.cu's resident kernel): per-node
// progress counters instead of a grid barrier, the θ tables holding node
// rows (round r reads table r % 2, round 0 reads θ0, rows no node owns are
// read from θ0 every round), the trace from block partials pushed into
// rank 0's shared memory. The update is the epilogue of the out rows
// (`ChebUpdate`): F(θ) stays in the register the warp sum leaves it in,
// θ_self is the staged own row, and the block's p rows [Dy, rows] stay in
// shared memory for the whole launch (seeded from delta0, written to out_p
// after the last round). A round publishes θ_new; the last round writes it
// to out_theta.
//
// The streamed route (`dekrr_cheb_solve_kernel`): one persistent
// cooperative launch of grid (C, n_clusters), cluster dims (C, 1, 1), C and
// the rows per block from chain_plan. Cluster q runs nodes j = q,
// q + n_clusters, ..., running dekrr_common.cuh::eq19_node_cluster (the
// round kernel's body), which writes F(θ)'s rows into the write-parity
// table [T*Dy, D] (two tables in `work`, both seeded from θ0); each block
// then updates only the rows it formed, in place there and in pdir (each
// node's p at row block j, in the output array, seeded from delta0).
// cooperative_groups' grid barrier ends each round; one a round is enough,
// as cross-node reads touch only the read-parity table.
//
// Bound on the card: as for dekrr_solve.cu, the inputs are read from
// device memory once in the count, so over R rounds the bound is the
// rounds' flops.
//
// The `*_clocked` entry points run the same kernels with the phase clock
// on (dekrr_common.cuh::PhaseClock; `chip_smoke.py --chain-timings`).
#include <cooperative_groups.h>

#include "cluster_launch.cuh"
#include "dekrr_common.cuh"

namespace cg = cooperative_groups;

namespace {

// Phases of a round the clock marks (kernels/dekrr_solve.py::CHAIN_PHASES).
constexpr int kStreamedPhases = 7;  // stage, acc, exchange, out, update,
                                    // max, grid
constexpr int kResidentPhases = 6;  // wait, stage, acc, exchange,
                                    // out and update, publish

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

// The update of one element from F(θ) `f` and θ_self `self`: p ← (f −
// self) + β·p in place, returns θ_self + α·p.
template <typename T>
__device__ __forceinline__ T cheb_update(T f, T self, T& p, T a, T b) {
  const T pn = add_rn(sub_rn(f, self), mul_rn(b, p));
  p = pn;
  return add_rn(self, mul_rn(a, pn));
}

// The resident route's epilogue of Resident::out_rows: the update of
// element (o, a0 + lr), its p in the block's rows pd [Dy, cap].
template <typename T>
struct ChebUpdate {
  T* pd;
  int cap;
  T a, b;  // α_r, β_r
  __device__ __forceinline__ T operator()(T f, T self, int o, int lr) const {
    return cheb_update(f, self, pd[o * cap + lr], a, b);
  }
};

template <typename T, typename Clock>
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
                        T* work, unsigned long long* stamps, int R, int J,
                        int K, int D, int Dy, int T_rows, int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ dekrr::ClusterMax<T, 1> red;
  T* smem = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const Clock clock = dekrr::make_clock<Clock>(stamps, R, kStreamedPhases);
  clock.start();
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
          nbr_mask, own, smem, K, D, Dy, rows_per_cta, clock, r, 0);
      const T* th = smem;  // the staged θ_self rows
      T* pj = pdir + static_cast<size_t>(j) * rows;
      T local[1] = {T(0)};
      for (int e = threadIdx.x; e < Dy * own_n; e += blockDim.x) {
        const size_t i = static_cast<size_t>(e / own_n) * D + a0 + e % own_n;
        const T tn = cheb_update(own[i], th[i], pj[i], a, b);
        own[i] = tn;
        local[0] = fmax(local[0], fabs(sub_rn(tn, th[i])));
      }
      clock.mark_synced(r, 4);
      if (res != nullptr) {
        dekrr::cluster_max(cluster, local, red, calls);
        if (leader) res[static_cast<size_t>(r) * J + j] = local[0];
      }
      __syncthreads();  // th is restaged by the next node
      clock.mark(r, 5);
    }
    grid.sync();
    clock.mark(r, 6);
  }

  const T* fin = R & 1 ? tab1 : work;
  for (size_t i = tid; i < static_cast<size_t>(J) * rows; i += stride)
    out_theta[i] = fin[self_idx[i / rows] * rows + i % rows];
}

// The resident route: grid (C, J), cluster dims (C, 1, 1), node j =
// blockIdx.y; `tab` holds 2·J·Dy·D elements, `prog` J counters (zeroed by
// the launcher), `waits` the [J, W] wait sets, `nbr_node` [J, K] the node
// that owns each slot's table row (−1: none). delta0, out_theta and out_p
// hold node j's rows at row block j.
template <typename T, typename Clock>
__global__ void __launch_bounds__(dekrr::kResThreads, 1)
dekrr_cheb_solve_resident_kernel(
    const T* __restrict__ g, const T* __restrict__ d, const T* __restrict__ s,
    const T* __restrict__ p, const T* __restrict__ theta0,
    const T* __restrict__ delta0, const int* __restrict__ nbr_idx,
    const int* __restrict__ nbr_node, const int* __restrict__ self_idx,
    const int* __restrict__ nbr_mask, const int* __restrict__ waits,
    const T* __restrict__ alpha, const T* __restrict__ beta, unsigned* prog,
    T* tab, T* __restrict__ out_theta, T* __restrict__ out_p,
    T* __restrict__ res, unsigned long long* stamps, int R, int J, int K,
    int D, int Dy, int W, int rows_per_cta, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int live_k[dekrr::kResMaxLive];
  __shared__ int nlive_s;
  cg::cluster_group cluster = cg::this_cluster();
  const Clock clock = dekrr::make_clock<Clock>(stamps, R, kResidentPhases);
  clock.start();
  const int j = blockIdx.y;
  dekrr::Resident<T> node(cluster, smem_raw, live_k, &nlive_s, j, g, d, s, p,
                          nbr_mask, K, D, Dy, rows_per_cta, L);
  const size_t rows = node.rows;
  // the block's p rows [Dy, cap], after its d rows; the first round's
  // staging barrier orders these writes before the first update
  T* const pd = node.dsm + static_cast<size_t>(Dy) * node.cap;
  const T* delta_j = delta0 + static_cast<size_t>(j) * rows;
  for (int e = threadIdx.x; e < Dy * node.n; e += blockDim.x)
    pd[(e / node.n) * node.cap + e % node.n] =
        delta_j[static_cast<size_t>(e / node.n) * D + node.a0 + e % node.n];
  dekrr::resident_sync_rounds(
      cluster, node, clock, live_k, theta0, nbr_idx, nbr_node, self_idx,
      waits + static_cast<size_t>(j) * W, W, prog, tab, out_theta, res, R, J,
      K, [&](int r) {
        return ChebUpdate<T>{pd, node.cap, alpha[r], beta[r]};
      });
  // every round's p writes ended at its publish barrier
  T* out_pj = out_p + static_cast<size_t>(j) * rows;
  for (int e = threadIdx.x; e < Dy * node.n; e += blockDim.x)
    out_pj[static_cast<size_t>(e / node.n) * D + node.a0 + e % node.n] =
        pd[(e / node.n) * node.cap + e % node.n];
}

template <typename T>
size_t smem_bytes(int K, int D, int Dy) {
  return dekrr::node_smem_elems(K, D, Dy) * sizeof(T);
}

// The resident block's layout plus its p rows [Dy, rows].
template <typename T>
size_t resident_smem_bytes(int L, int D, int Dy, int rows) {
  return (dekrr::resident_smem_elems(L, D, Dy, rows) +
          static_cast<size_t>(Dy) * rows) *
         sizeof(T);
}

template <typename T>
int max_clusters(int K, int D, int Dy, int cluster) {
  return cluster_max_active(dekrr_cheb_solve_kernel<T, dekrr::NoClock>,
                            dekrr::kClusterThreads, smem_bytes<T>(K, D, Dy),
                            cluster);
}

template <typename T>
int resident_max_clusters(int blocks, int threads, int smem) {
  return cluster_max_active(
      dekrr_cheb_solve_resident_kernel<T, dekrr::NoClock>, threads, smem,
      blocks);
}

template <typename T, typename Clock>
int launch(const void* g, const void* d, const void* s, const void* p,
           const void* theta0, const void* delta0, const void* nbr_idx,
           const void* self_idx, const void* nbr_mask, const void* alpha,
           const void* beta, void* out_theta, void* pdir, void* res,
           void* work, void* stamps, int R, int J, int K, int D, int Dy,
           int T_rows, int cluster, int rows_per_cta, int n_clusters,
           void* stream) {
  if (cluster < 1 || cluster > 8 || rows_per_cta < 1 ||
      static_cast<long long>(cluster) * rows_per_cta < D || n_clusters > J)
    return static_cast<int>(cudaErrorInvalidValue);
  return cluster_launch_resident(
      dekrr_cheb_solve_kernel<T, Clock>, n_clusters, dekrr::kClusterThreads,
      smem_bytes<T>(K, D, Dy), cluster, stream, static_cast<const T*>(g),
      static_cast<const T*>(d), static_cast<const T*>(s),
      static_cast<const T*>(p), static_cast<const T*>(theta0),
      static_cast<const T*>(delta0), static_cast<const int*>(nbr_idx),
      static_cast<const int*>(self_idx), static_cast<const int*>(nbr_mask),
      static_cast<const T*>(alpha), static_cast<const T*>(beta),
      static_cast<T*>(out_theta), static_cast<T*>(pdir), static_cast<T*>(res),
      static_cast<T*>(work), static_cast<unsigned long long*>(stamps), R, J, K,
      D, Dy, T_rows, rows_per_cta);
}

template <typename T, typename Clock>
int launch_resident(const void* g, const void* d, const void* s,
                    const void* p, const void* theta0, const void* delta0,
                    const void* nbr_idx, const void* nbr_node,
                    const void* self_idx, const void* nbr_mask,
                    const void* waits, const void* alpha, const void* beta,
                    void* prog, void* tab, void* out_theta, void* out_p,
                    void* res, void* stamps, int R, int J, int K, int D,
                    int Dy, int W, int blocks, int rows, int L, void* stream) {
  if (blocks < 1 || blocks > dekrr::kMaxCluster || rows < 1 ||
      rows > dekrr::kResMaxRows || static_cast<long long>(blocks) * rows < D ||
      D > 32 * dekrr::kLaneCols || L < 0 || L > dekrr::kResMaxLive ||
      L > K || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(prog, 0, sizeof(unsigned) * J,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return cluster_launch_resident(
      dekrr_cheb_solve_resident_kernel<T, Clock>, J,
      dekrr::resident_threads(rows), resident_smem_bytes<T>(L, D, Dy, rows),
      blocks, stream, static_cast<const T*>(g), static_cast<const T*>(d),
      static_cast<const T*>(s), static_cast<const T*>(p),
      static_cast<const T*>(theta0), static_cast<const T*>(delta0),
      static_cast<const int*>(nbr_idx), static_cast<const int*>(nbr_node),
      static_cast<const int*>(self_idx), static_cast<const int*>(nbr_mask),
      static_cast<const int*>(waits), static_cast<const T*>(alpha),
      static_cast<const T*>(beta), static_cast<unsigned*>(prog),
      static_cast<T*>(tab), static_cast<T*>(out_theta),
      static_cast<T*>(out_p), static_cast<T*>(res),
      static_cast<unsigned long long*>(stamps), R, J, K, D, Dy, W, rows, L);
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

// The streamed route. res [R, J] may be null (no trace). `work` holds
// 2*T*Dy*D elements. `cluster`, `rows_per_cta` and `n_clusters` as for
// dekrr_solve_f64.
int dekrr_cheb_solve_f64(const void* g, const void* d, const void* s,
                         const void* p, const void* theta0, const void* delta0,
                         const void* nbr_idx, const void* self_idx,
                         const void* nbr_mask, const void* alpha,
                         const void* beta, void* out_theta, void* pdir,
                         void* res, void* work, int R, int J, int K, int D,
                         int Dy, int T_rows, int cluster, int rows_per_cta,
                         int n_clusters, void* stream) {
  return launch<double, dekrr::NoClock>(
      g, d, s, p, theta0, delta0, nbr_idx, self_idx, nbr_mask, alpha, beta,
      out_theta, pdir, res, work, nullptr, R, J, K, D, Dy, T_rows, cluster,
      rows_per_cta, n_clusters, stream);
}

int dekrr_cheb_solve_f32(const void* g, const void* d, const void* s,
                         const void* p, const void* theta0, const void* delta0,
                         const void* nbr_idx, const void* self_idx,
                         const void* nbr_mask, const void* alpha,
                         const void* beta, void* out_theta, void* pdir,
                         void* res, void* work, int R, int J, int K, int D,
                         int Dy, int T_rows, int cluster, int rows_per_cta,
                         int n_clusters, void* stream) {
  return launch<float, dekrr::NoClock>(
      g, d, s, p, theta0, delta0, nbr_idx, self_idx, nbr_mask, alpha, beta,
      out_theta, pdir, res, work, nullptr, R, J, K, D, Dy, T_rows, cluster,
      rows_per_cta, n_clusters, stream);
}

// dekrr_cheb_solve_f64 with the phase clock on: `stamps` holds, for each
// block of the grid, 1 + R·7 zeroed u64 (dekrr_common.cuh::PhaseClock).
int dekrr_cheb_solve_clocked_f64(
    const void* g, const void* d, const void* s, const void* p,
    const void* theta0, const void* delta0, const void* nbr_idx,
    const void* self_idx, const void* nbr_mask, const void* alpha,
    const void* beta, void* out_theta, void* pdir, void* res, void* work,
    void* stamps, int R, int J, int K, int D, int Dy, int T_rows, int cluster,
    int rows_per_cta, int n_clusters, void* stream) {
  return launch<double, dekrr::PhaseClock>(
      g, d, s, p, theta0, delta0, nbr_idx, self_idx, nbr_mask, alpha, beta,
      out_theta, pdir, res, work, stamps, R, J, K, D, Dy, T_rows, cluster,
      rows_per_cta, n_clusters, stream);
}

// The resident route: `blocks` ≤ 8 blocks per node of `rows` ≤ 32 rows
// (blocks · rows ≥ D ≤ 256), J clusters, L ≤ 16 the most live slots of a
// node; `tab` 2·J·Dy·D elements, `prog` J u32 (zeroed here, on `stream`),
// `waits` [J, W] int32 (−1 padded), `nbr_node` [J, K] int32; out_theta and
// out_p [J·Dy, D], res [R, J] or null. A grid of more clusters than the
// device holds at once is refused before it runs.
int dekrr_cheb_solve_resident_f64(
    const void* g, const void* d, const void* s, const void* p,
    const void* theta0, const void* delta0, const void* nbr_idx,
    const void* nbr_node, const void* self_idx, const void* nbr_mask,
    const void* waits, const void* alpha, const void* beta, void* prog,
    void* tab, void* out_theta, void* out_p, void* res, int R, int J, int K,
    int D, int Dy, int W, int blocks, int rows, int L, void* stream) {
  return launch_resident<double, dekrr::NoClock>(
      g, d, s, p, theta0, delta0, nbr_idx, nbr_node, self_idx, nbr_mask, waits,
      alpha, beta, prog, tab, out_theta, out_p, res, nullptr, R, J, K, D, Dy,
      W, blocks, rows, L, stream);
}

int dekrr_cheb_solve_resident_f32(
    const void* g, const void* d, const void* s, const void* p,
    const void* theta0, const void* delta0, const void* nbr_idx,
    const void* nbr_node, const void* self_idx, const void* nbr_mask,
    const void* waits, const void* alpha, const void* beta, void* prog,
    void* tab, void* out_theta, void* out_p, void* res, int R, int J, int K,
    int D, int Dy, int W, int blocks, int rows, int L, void* stream) {
  return launch_resident<float, dekrr::NoClock>(
      g, d, s, p, theta0, delta0, nbr_idx, nbr_node, self_idx, nbr_mask, waits,
      alpha, beta, prog, tab, out_theta, out_p, res, nullptr, R, J, K, D, Dy,
      W, blocks, rows, L, stream);
}

// dekrr_cheb_solve_resident_f64 with the phase clock on (1 + R·6 stamps a
// block).
int dekrr_cheb_solve_resident_clocked_f64(
    const void* g, const void* d, const void* s, const void* p,
    const void* theta0, const void* delta0, const void* nbr_idx,
    const void* nbr_node, const void* self_idx, const void* nbr_mask,
    const void* waits, const void* alpha, const void* beta, void* prog,
    void* tab, void* out_theta, void* out_p, void* res, void* stamps, int R,
    int J, int K, int D, int Dy, int W, int blocks, int rows, int L,
    void* stream) {
  return launch_resident<double, dekrr::PhaseClock>(
      g, d, s, p, theta0, delta0, nbr_idx, nbr_node, self_idx, nbr_mask, waits,
      alpha, beta, prog, tab, out_theta, out_p, res, stamps, R, J, K, D, Dy, W,
      blocks, rows, L, stream);
}

// Clusters of `blocks` resident blocks of `threads` threads and `smem`
// bytes the device holds at once, negative on a CUDA error.
int dekrr_cheb_solve_resident_max_clusters_f64(int blocks, int threads,
                                               int smem) {
  return resident_max_clusters<double>(blocks, threads, smem);
}

int dekrr_cheb_solve_resident_max_clusters_f32(int blocks, int threads,
                                               int smem) {
  return resident_max_clusters<float>(blocks, threads, smem);
}

// Dynamic shared memory of a block at (K, D, Dy), as the launcher passes it
// (repro_torch.analysis.smem checks the same formula before any launch).
int dekrr_cheb_solve_smem_bytes_f64(int K, int D, int Dy) {
  return static_cast<int>(smem_bytes<double>(K, D, Dy));
}

int dekrr_cheb_solve_smem_bytes_f32(int K, int D, int Dy) {
  return static_cast<int>(smem_bytes<float>(K, D, Dy));
}

// ... and of a resident block of `rows` rows with L live slots.
int dekrr_cheb_solve_resident_smem_bytes_f64(int L, int D, int Dy, int rows) {
  return static_cast<int>(resident_smem_bytes<double>(L, D, Dy, rows));
}

int dekrr_cheb_solve_resident_smem_bytes_f32(int L, int D, int Dy, int rows) {
  return static_cast<int>(resident_smem_bytes<float>(L, D, Dy, rows));
}

}  // extern "C"
