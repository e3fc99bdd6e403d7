// R Jacobi rounds of Eq. 19 in one launch: the Hopper counterpart of
// src/repro/kernels/dekrr_solve.py::dekrr_solve_pallas (_dekrr_solve_kernel).
//
// The Pallas kernel relies on its (R, J) grid running in order, so round
// r + 1 sees all of round r. A CUDA grid has no order, so this kernel is one
// persistent cooperative launch in which every node is a thread-block
// cluster. kernels/dekrr_solve.py::solve_plan picks one of two routes and
// records it by name:
//
// The resident route (`dekrr_solve_resident_kernel`, where the operands fit
// on chip: dekrr_common.cuh's "resident route"): one cluster of C blocks per
// node, each block holding its rows of S, the live P and G on chip for the
// whole launch; per-node progress counters instead of a grid barrier. The
// θ tables hold node rows: round r reads table r % 2 (round 0 reads θ0) and
// writes table (r + 1) % 2, the last round writes `out`. A live slot whose
// table row no node owns (nbr_node −1) reads θ0's row in every round. The
// residual trace res[r, j]: each block pushes its max into block rank 0's
// shared memory (DSMEM) at the end of round r, and rank 0 reads the C
// partials in rank order after round r + 1's cluster barrier (after one
// more barrier for the last round); max is exact.
//
// The streamed route (`dekrr_solve_kernel`, everywhere else): every node a
// cluster running the round kernel's node body (dekrr_common.cuh::
// eq19_node_cluster) round after round: grid (C, n_clusters), cluster dims
// (C, 1, 1), C and the rows per block from chain_plan (the round kernel's
// round_plan). Cluster q runs nodes j = q, q + n_clusters, ..., so J past
// the co-resident clusters still runs; every block of a cluster takes the
// same node sequence, so the cluster barriers inside the body never
// diverge. cooperative_groups' grid barrier ends each round: it fences each
// block's writes at device scope before arriving, so round r's θ rows are
// visible to every cluster in round r + 1. Jacobi needs two θ tables: round
// r reads table r % 2 and writes table (r + 1) % 2, both seeded from θ0 so
// rows that no node owns stay at θ0. The residual trace is a cluster max
// (dekrr_common.cuh::cluster_max) written by the cluster's block rank 0.
//
// Bound on the card: at one round it is bytes, as for the round kernel; over
// R rounds each input is read from device memory only once in the count, so
// the bound becomes the R·2(2 + K)D²J flops. The streamed route reads the
// blocks (19.2 MB at the paper's J = 10, D = 200, K = 4) from L2 every
// round, a warp's loads one L2 latency apart; the resident route reads them
// once, and a round is then its shared-memory reads and its hand-offs
// through L2.
//
// Both routes compute each row with the round kernel's order of
// operations, so this solve equals R round launches bit for bit.
//
// The `*_clocked` entry points run the same kernels with the phase clock on
// (dekrr_common.cuh::PhaseClock; `chip_smoke.py --chain-timings`), and
// `dekrr_handoff_probe` times one release/acquire hand-off between two SMs
// through L2, the floor of any wait between nodes.
#include <cooperative_groups.h>

#include "cluster_launch.cuh"
#include "dekrr_common.cuh"

namespace cg = cooperative_groups;

namespace {

// Phases of a round the clock marks (kernels/dekrr_solve.py::CHAIN_PHASES).
constexpr int kStreamedPhases = 6;  // stage, acc, exchange, out, max, grid
constexpr int kResidentPhases = 6;  // wait, stage, acc, exchange, out, publish

template <typename T, typename Clock>
__global__ void __launch_bounds__(dekrr::kClusterThreads)
dekrr_solve_kernel(const T* __restrict__ g, const T* __restrict__ d,
                   const T* __restrict__ s, const T* __restrict__ p,
                   const T* __restrict__ theta0, const int* __restrict__ nbr_idx,
                   const int* __restrict__ self_idx,
                   const int* __restrict__ nbr_mask, T* __restrict__ out,
                   T* __restrict__ res, T* work, unsigned long long* stamps,
                   int R, int J, int K, int D, int Dy, int T_rows,
                   int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ dekrr::ClusterMax<T, 1> red;
  T* smem = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const Clock clock = dekrr::make_clock<Clock>(stamps, R, kStreamedPhases);
  clock.start();
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
          nbr_mask, wr + self_idx[j] * rows, smem, K, D, Dy, rows_per_cta,
          clock, r, 0)};
      if (res != nullptr) {
        dekrr::cluster_max(cluster, local, red, calls);
        if (leader) res[static_cast<size_t>(r) * J + j] = local[0];
      }
      clock.mark(r, 4);
    }
    grid.sync();
    clock.mark(r, 5);
  }

  const T* fin = R & 1 ? tab1 : work;
  for (size_t i = tid; i < static_cast<size_t>(J) * rows; i += stride)
    out[i] = fin[self_idx[i / rows] * rows + i % rows];
}

// The resident route: grid (C, J), cluster dims (C, 1, 1), node j =
// blockIdx.y; `tab` holds 2·J·Dy·D elements, `prog` J counters (zeroed by
// the launcher), `waits` the [J, W] wait sets, `nbr_node` [J, K] the node
// that owns each slot's table row (−1: none).
template <typename T, typename Clock>
__global__ void __launch_bounds__(dekrr::kResThreads, 1)
dekrr_solve_resident_kernel(
    const T* __restrict__ g, const T* __restrict__ d, const T* __restrict__ s,
    const T* __restrict__ p, const T* __restrict__ theta0,
    const int* __restrict__ nbr_idx, const int* __restrict__ nbr_node,
    const int* __restrict__ self_idx, const int* __restrict__ nbr_mask,
    const int* __restrict__ waits, unsigned* prog, T* tab,
    T* __restrict__ out, T* __restrict__ res, unsigned long long* stamps,
    int R, int J, int K, int D, int Dy, int W, int rows_per_cta, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int live_k[dekrr::kResMaxLive];
  __shared__ int nlive_s;
  cg::cluster_group cluster = cg::this_cluster();
  const Clock clock = dekrr::make_clock<Clock>(stamps, R, kResidentPhases);
  clock.start();
  const int j = blockIdx.y;
  dekrr::Resident<T> node(cluster, smem_raw, live_k, &nlive_s, j, g, d, s, p,
                          nbr_mask, K, D, Dy, rows_per_cta, L);
  dekrr::resident_sync_rounds(
      cluster, node, clock, live_k, theta0, nbr_idx, nbr_node, self_idx,
      waits + static_cast<size_t>(j) * W, W, prog, tab, out, res, R, J, K,
      [](int) { return dekrr::Identity(); });
}

// One thread of each of two blocks (each on its own SM: the launcher gives
// each more than half an SM's shared memory) passes a counter back and
// forth `iters` times, release then acquire at GPU scope; block 0 writes
// the elapsed ns of the 2·iters hand-offs.
__global__ void handoff_probe_kernel(unsigned* flags, int iters,
                                     unsigned long long* out_ns) {
  if (threadIdx.x != 0) return;
  unsigned* mine = flags + blockIdx.x;
  unsigned* theirs = flags + (1 - blockIdx.x);
  const unsigned long long t0 = dekrr::global_ns();
  for (int i = 1; i <= iters; ++i) {
    if (blockIdx.x == 0) {
      asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(theirs),
                   "r"(static_cast<unsigned>(i))
                   : "memory");
      while (dekrr::ld_acquire(mine) < static_cast<unsigned>(i)) {
      }
    } else {
      while (dekrr::ld_acquire(mine) < static_cast<unsigned>(i)) {
      }
      asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(theirs),
                   "r"(static_cast<unsigned>(i))
                   : "memory");
    }
  }
  if (blockIdx.x == 0) *out_ns = dekrr::global_ns() - t0;
}

template <typename T>
size_t smem_bytes(int K, int D, int Dy) {
  return dekrr::node_smem_elems(K, D, Dy) * sizeof(T);
}

template <typename T>
size_t resident_smem_bytes(int L, int D, int Dy, int rows) {
  return dekrr::resident_smem_elems(L, D, Dy, rows) * sizeof(T);
}

template <typename T>
int max_clusters(int K, int D, int Dy, int cluster) {
  return cluster_max_active(dekrr_solve_kernel<T, dekrr::NoClock>,
                            dekrr::kClusterThreads, smem_bytes<T>(K, D, Dy),
                            cluster);
}

template <typename T>
int resident_max_clusters(int blocks, int threads, int smem) {
  return cluster_max_active(dekrr_solve_resident_kernel<T, dekrr::NoClock>,
                            threads, smem, blocks);
}

template <typename T, typename Clock>
int launch(const void* g, const void* d, const void* s, const void* p,
           const void* theta0, const void* nbr_idx, const void* self_idx,
           const void* nbr_mask, void* out, void* res, void* work, void* stamps,
           int R, int J, int K, int D, int Dy, int T_rows, int cluster,
           int rows_per_cta, int n_clusters, void* stream) {
  if (cluster < 1 || cluster > 8 || rows_per_cta < 1 ||
      static_cast<long long>(cluster) * rows_per_cta < D || n_clusters > J)
    return static_cast<int>(cudaErrorInvalidValue);
  return cluster_launch_resident(
      dekrr_solve_kernel<T, Clock>, n_clusters, dekrr::kClusterThreads,
      smem_bytes<T>(K, D, Dy), cluster, stream, static_cast<const T*>(g),
      static_cast<const T*>(d), static_cast<const T*>(s),
      static_cast<const T*>(p), static_cast<const T*>(theta0),
      static_cast<const int*>(nbr_idx), static_cast<const int*>(self_idx),
      static_cast<const int*>(nbr_mask), static_cast<T*>(out),
      static_cast<T*>(res), static_cast<T*>(work),
      static_cast<unsigned long long*>(stamps), R, J, K, D, Dy, T_rows,
      rows_per_cta);
}

template <typename T, typename Clock>
int launch_resident(const void* g, const void* d, const void* s,
                    const void* p, const void* theta0, const void* nbr_idx,
                    const void* nbr_node, const void* self_idx,
                    const void* nbr_mask, const void* waits, void* prog,
                    void* tab, void* out, void* res, void* stamps, int R,
                    int J, int K, int D, int Dy, int W, int blocks, int rows,
                    int L, void* stream) {
  if (blocks < 1 || blocks > dekrr::kMaxCluster || rows < 1 ||
      rows > dekrr::kResMaxRows || static_cast<long long>(blocks) * rows < D ||
      D > 32 * dekrr::kLaneCols || L < 0 || L > dekrr::kResMaxLive ||
      L > K || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(prog, 0, sizeof(unsigned) * J,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return cluster_launch_resident(
      dekrr_solve_resident_kernel<T, Clock>, J, dekrr::resident_threads(rows),
      resident_smem_bytes<T>(L, D, Dy, rows), blocks, stream,
      static_cast<const T*>(g), static_cast<const T*>(d),
      static_cast<const T*>(s), static_cast<const T*>(p),
      static_cast<const T*>(theta0), static_cast<const int*>(nbr_idx),
      static_cast<const int*>(nbr_node), static_cast<const int*>(self_idx),
      static_cast<const int*>(nbr_mask), static_cast<const int*>(waits),
      static_cast<unsigned*>(prog), static_cast<T*>(tab),
      static_cast<T*>(out), static_cast<T*>(res),
      static_cast<unsigned long long*>(stamps), R, J, K, D, Dy, W, rows, L);
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
  return launch<double, dekrr::NoClock>(
      g, d, s, p, theta0, nbr_idx, self_idx, nbr_mask, out, res, work,
      nullptr, R, J, K, D, Dy, T_rows, cluster, rows_per_cta, n_clusters,
      stream);
}

int dekrr_solve_f32(const void* g, const void* d, const void* s, const void* p,
                    const void* theta0, const void* nbr_idx,
                    const void* self_idx, const void* nbr_mask, void* out,
                    void* res, void* work, int R, int J, int K, int D, int Dy,
                    int T_rows, int cluster, int rows_per_cta, int n_clusters,
                    void* stream) {
  return launch<float, dekrr::NoClock>(
      g, d, s, p, theta0, nbr_idx, self_idx, nbr_mask, out, res, work,
      nullptr, R, J, K, D, Dy, T_rows, cluster, rows_per_cta, n_clusters,
      stream);
}

// dekrr_solve_f64 with the phase clock on: `stamps` holds, for each block
// of the grid, 1 + R·6 zeroed u64 (dekrr_common.cuh::PhaseClock).
int dekrr_solve_clocked_f64(const void* g, const void* d, const void* s,
                            const void* p, const void* theta0,
                            const void* nbr_idx, const void* self_idx,
                            const void* nbr_mask, void* out, void* res,
                            void* work, void* stamps, int R, int J, int K,
                            int D, int Dy, int T_rows, int cluster,
                            int rows_per_cta, int n_clusters, void* stream) {
  return launch<double, dekrr::PhaseClock>(
      g, d, s, p, theta0, nbr_idx, self_idx, nbr_mask, out, res, work, stamps,
      R, J, K, D, Dy, T_rows, cluster, rows_per_cta, n_clusters, stream);
}

// The resident route: `blocks` ≤ 8 blocks per node of `rows` ≤ 32 rows
// (blocks · rows ≥ D ≤ 256), J clusters, L ≤ 16 the most live slots of a
// node; `tab` 2·J·Dy·D elements, `prog` J u32 (zeroed here, on `stream`),
// `waits` [J, W] int32 (−1 padded), `nbr_node` [J, K] int32. A grid of
// more clusters than the device holds at once is refused before it runs.
int dekrr_solve_resident_f64(const void* g, const void* d, const void* s,
                             const void* p, const void* theta0,
                             const void* nbr_idx, const void* nbr_node,
                             const void* self_idx, const void* nbr_mask,
                             const void* waits, void* prog, void* tab,
                             void* out, void* res, int R, int J, int K, int D,
                             int Dy, int W, int blocks, int rows, int L,
                             void* stream) {
  return launch_resident<double, dekrr::NoClock>(
      g, d, s, p, theta0, nbr_idx, nbr_node, self_idx, nbr_mask, waits, prog,
      tab, out, res, nullptr, R, J, K, D, Dy, W, blocks, rows, L, stream);
}

int dekrr_solve_resident_f32(const void* g, const void* d, const void* s,
                             const void* p, const void* theta0,
                             const void* nbr_idx, const void* nbr_node,
                             const void* self_idx, const void* nbr_mask,
                             const void* waits, void* prog, void* tab,
                             void* out, void* res, int R, int J, int K, int D,
                             int Dy, int W, int blocks, int rows, int L,
                             void* stream) {
  return launch_resident<float, dekrr::NoClock>(
      g, d, s, p, theta0, nbr_idx, nbr_node, self_idx, nbr_mask, waits, prog,
      tab, out, res, nullptr, R, J, K, D, Dy, W, blocks, rows, L, stream);
}

// dekrr_solve_resident_f64 with the phase clock on (1 + R·6 stamps a
// block).
int dekrr_solve_resident_clocked_f64(
    const void* g, const void* d, const void* s, const void* p,
    const void* theta0, const void* nbr_idx, const void* nbr_node,
    const void* self_idx, const void* nbr_mask, const void* waits, void* prog,
    void* tab, void* out, void* res, void* stamps, int R, int J, int K, int D,
    int Dy, int W, int blocks, int rows, int L, void* stream) {
  return launch_resident<double, dekrr::PhaseClock>(
      g, d, s, p, theta0, nbr_idx, nbr_node, self_idx, nbr_mask, waits, prog,
      tab, out, res, stamps, R, J, K, D, Dy, W, blocks, rows, L, stream);
}

// Clusters of `blocks` resident blocks of `threads` threads and `smem`
// bytes the device holds at once, negative on a CUDA error.
int dekrr_solve_resident_max_clusters_f64(int blocks, int threads, int smem) {
  return resident_max_clusters<double>(blocks, threads, smem);
}

int dekrr_solve_resident_max_clusters_f32(int blocks, int threads, int smem) {
  return resident_max_clusters<float>(blocks, threads, smem);
}

// Dynamic shared memory of a block at (K, D, Dy), as the launcher passes it
// (repro_torch.analysis.smem checks the same formula before any launch).
int dekrr_solve_smem_bytes_f64(int K, int D, int Dy) {
  return static_cast<int>(smem_bytes<double>(K, D, Dy));
}

int dekrr_solve_smem_bytes_f32(int K, int D, int Dy) {
  return static_cast<int>(smem_bytes<float>(K, D, Dy));
}

// ... and of a resident block of `rows` rows with L live slots.
int dekrr_solve_resident_smem_bytes_f64(int L, int D, int Dy, int rows) {
  return static_cast<int>(resident_smem_bytes<double>(L, D, Dy, rows));
}

int dekrr_solve_resident_smem_bytes_f32(int L, int D, int Dy, int rows) {
  return static_cast<int>(resident_smem_bytes<float>(L, D, Dy, rows));
}

// Elapsed ns of 2·iters release/acquire hand-offs between two SMs through
// L2, written to out_ns (one u64) on `stream`; `flags` holds two zeroed
// u32.
int dekrr_handoff_probe(void* flags, int iters, void* out_ns, void* stream) {
  const int smem = 150 * 1024;  // over half an SM: one block an SM
  cudaError_t err = cudaFuncSetAttribute(
      handoff_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned* f = static_cast<unsigned*>(flags);
  unsigned long long* o = static_cast<unsigned long long*>(out_ns);
  void* args[] = {&f, &iters, &o};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(handoff_probe_kernel), dim3(2), dim3(32), args,
      smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
