// R asynchronous-gossip rounds of Eq. 19 plus a delivery flush, in one
// launch: the Hopper counterpart of
// src/repro/kernels/dekrr_solve.py::dekrr_async_solve_pallas
// (_dekrr_async_solve_kernel).
//
// State (node ids index everything; node j's θ row block is table row j):
//   two round-parity θ tables [T*Dy, D] in `work`, both seeded from θ0;
//   sent [J*Dy, D]      the last θ each node put on the wire (censor ref);
//   buf  [J*K*Dy, D]    per-edge staleness buffers, slot (j, k) at row block
//                       j*K + k: the last θ node j received from nbr_idx[j, k];
//   two round-parity broadcast-flag vectors [J] int32 in `flags`.
// sent and buf are written in place in the output arrays.
//
// Step r = 0 .. R, for every node j:
//   deliver (r >= 1): slot k takes rd[nbr_idx[j, k]] iff the slot is live and
//     that neighbour raised its round r - 1 flag (edge gossip: and node j
//     was active in round r - 1);
//   compute (r < R): an active node runs the round against its buffers,
//     then broadcasts iff censoring is off or max|new - sent| > thr[r]
//     (strict; over the whole [Dy, D] block); an inactive node copies its
//     θ rows through and lowers its flag;
//   step R delivers only (the flush of round R - 1's broadcasts).
//
// The Pallas kernel runs its (R + 1, J) grid in order. Here, as in
// dekrr_solve.cu, every node is a thread-block cluster (grid (C,
// n_clusters), cluster dims (C, 1, 1), from kernels/dekrr_solve.py::
// chain_plan); cluster q runs nodes j = q, q + n_clusters, ... and the
// launch is cooperative, with one grid barrier (cg::this_grid().sync())
// ending each step. That one barrier is enough because every value read
// across nodes (the read-parity θ table and the read-parity flags) was
// written in the previous step, and every value written in a step
// (write-parity θ rows, sent rows, buffer rows, the write-parity flag)
// belongs to the writing node alone; the barrier fences each block's
// writes at device scope before it arrives, so they are visible to every
// cluster after it. Per step and node, every block of the node's cluster:
//   - delivery: copies its share of the delivered slots into buf (split
//     across the cluster), and stages a delivered slot straight from the
//     read table, which holds the same value, so no block waits for
//     another's copy;
//   - active node: runs dekrr_common.cuh::eq19_node_cluster (the round
//     kernel's body) on the staged rows, writing its own rows of the
//     write-parity θ; then one cluster max (cluster_max) of the residual
//     and of max|own − sent| over its rows, so every block takes the same
//     broadcast branch; then writes its own rows of sent;
//   - inactive node: copies its share of the θ rows through. The whole
//     cluster takes this branch, so no cluster barrier diverges.
// The flag and the trace (res, bc) are written by block rank 0.
//
// The arithmetic after staging is the round kernel's, so one launch of R
// rounds equals R masked round launches plus the delivery rule bit for bit.
//
// The resident route (`dekrr_async_solve_resident_kernel`, picked by
// kernels/dekrr_solve.py::async_plan where the operands fit on chip; see
// dekrr_common.cuh's "resident route"): one cluster per node holding the
// node's rows of S, the live P and G on chip for the whole launch, and the
// grid barrier replaced by per-node progress counters. Step r > 0 of node
// j starts once every node of W(j) = {j} ∪ in(j) ∪ out(j) has ended step
// r − 1: the values read across nodes (the read-parity θ rows and flags of
// in(j)) were written in step r − 1, and the values node j writes in step
// r (its write-parity θ rows and flag) were last read in step r − 1 by
// out(j). The θ tables hold node rows; step 0 reads θ0. The node's sent
// and buffer rows are node j's alone: its cluster copies sent0 and buf0 in
// at the start (one cluster barrier), and a buffer row one block delivers
// is read by another block only in a later step, after the counter wait.
// An inactive node still ends its step on the counters. Step R − 1 writes
// θ into `out_theta` as well as into the table the flush reads.
//
// Bound on the card: as for dekrr_solve.cu, the inputs are read from device
// memory once in the count, so over R rounds the bound is the flops of the
// active nodes' updates.
#include <cooperative_groups.h>

#include "cluster_launch.cuh"
#include "dekrr_common.cuh"

namespace cg = cooperative_groups;

namespace {

// Phases of a step the clock marks (kernels/dekrr_solve.py::CHAIN_PHASES).
constexpr int kStreamedPhases = 8;  // delivery, stage, acc, exchange, out,
                                    // max, sent and flags, grid
constexpr int kResidentPhases = 8;  // wait, delivery, stage, acc, exchange,
                                    // out, max, sent and flags and publish

// Node j's neighbour row blocks in one step: a slot delivered this step
// (`deliver`, and its neighbour raised its flag) from the read table, any
// other from its staleness buffer. Only live slots are asked for.
template <typename T>
struct DeliveredRows {
  const T* rd;
  const T* buf_j;    // buffer row block of slot (j, 0)
  const int* idx_j;  // nbr_idx row of node j
  const int* fl_rd;  // the read-parity broadcast flags
  bool deliver;
  size_t rows;
  __device__ const T* operator()(int k) const {
    const int nb = idx_j[k];
    if (deliver && fl_rd[nb] != 0) return rd + static_cast<size_t>(nb) * rows;
    return buf_j + static_cast<size_t>(k) * rows;
  }
};

template <typename T, typename Clock>
__global__ void __launch_bounds__(dekrr::kClusterThreads)
dekrr_async_solve_kernel(
    const T* __restrict__ g, const T* __restrict__ d, const T* __restrict__ s,
    const T* __restrict__ p, const T* __restrict__ theta0,
    const T* __restrict__ sent0, const T* __restrict__ buf0,
    const int* __restrict__ nbr_idx, const int* __restrict__ nbr_mask,
    const int* __restrict__ active, const T* __restrict__ thr,
    T* __restrict__ out_theta, T* sent, T* buf, T* __restrict__ res,
    int* __restrict__ bc, T* work, int* flags, unsigned long long* stamps,
    int R, int J, int K, int D, int Dy, int T_rows, int censored, int edge,
    int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ dekrr::ClusterMax<T, 2> red;
  T* smem = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const Clock clock =
      dekrr::make_clock<Clock>(stamps, R + 1, kStreamedPhases);
  clock.start();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const bool leader = rank == 0 && threadIdx.x == 0;
  const size_t rows = static_cast<size_t>(Dy) * D;
  const size_t n = static_cast<size_t>(T_rows) * rows;
  T* const tab1 = work + n;     // θ table 0 is `work`
  int* const fl1 = flags + J;   // flag vector 0 is `flags`
  int calls = 0;                // cluster_max calls
  // this block's share of a node's rows when the cluster splits a copy
  const size_t c_first = static_cast<size_t>(rank) * blockDim.x + threadIdx.x;
  const size_t c_step = static_cast<size_t>(C) * blockDim.x;
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
    sent[i] = sent0[i];
  for (size_t i = tid; i < static_cast<size_t>(J) * K * rows; i += stride)
    buf[i] = buf0[i];
  for (size_t i = tid; i < static_cast<size_t>(2) * J; i += stride) flags[i] = 0;
  grid.sync();

  for (int r = 0; r <= R; ++r) {
    const T* rd = r & 1 ? tab1 : work;
    T* wr = r & 1 ? work : tab1;
    const int* fl_rd = r & 1 ? fl1 : flags;
    int* fl_wr = r & 1 ? flags : fl1;
    for (int j = blockIdx.y; j < J; j += gridDim.y) {
      const size_t jk = static_cast<size_t>(j) * K;
      const bool deliver =
          r >= 1 && (!edge || active[static_cast<size_t>(r - 1) * J + j]);
      if (deliver) {
        for (int k = 0; k < K; ++k) {
          const int nb = nbr_idx[jk + k];
          if (nbr_mask[jk + k] == 0 || fl_rd[nb] == 0) continue;
          const T* src = rd + static_cast<size_t>(nb) * rows;
          T* dst = buf + (jk + k) * rows;
          for (size_t i = c_first; i < rows; i += c_step) dst[i] = src[i];
        }
      }
      clock.mark_synced(r, 0);
      const size_t at = static_cast<size_t>(r) * J + j;
      if (r == R) {
        if (res != nullptr && leader) {
          res[at] = T(0);
          bc[at] = 0;
        }
        continue;
      }
      const T* own_rd = rd + static_cast<size_t>(j) * rows;
      T* own = wr + static_cast<size_t>(j) * rows;
      T* sent_j = sent + static_cast<size_t>(j) * rows;
      if (active[at] == 0) {
        for (size_t i = c_first; i < rows; i += c_step) own[i] = own_rd[i];
        if (leader) {
          fl_wr[j] = 0;
          if (res != nullptr) {
            res[at] = T(0);
            bc[at] = 0;
          }
        }
        clock.mark_synced(r, 6);
        continue;  // the whole cluster takes this branch
      }
      T m[2] = {dekrr::eq19_node_cluster<T>(
                    cluster, j, g, d, s, p, own_rd,
                    DeliveredRows<T>{rd, buf + jk * rows, nbr_idx + jk, fl_rd,
                                     deliver, rows},
                    nbr_mask, own, smem, K, D, Dy, rows_per_cta, clock, r, 1),
                T(0)};
      if (censored)
        for (int e = threadIdx.x; e < Dy * own_n; e += blockDim.x) {
          const size_t i = static_cast<size_t>(e / own_n) * D + a0 + e % own_n;
          m[1] = fmax(m[1], fabs(own[i] - sent_j[i]));
        }
      if (res != nullptr || censored)
        dekrr::cluster_max(cluster, m, red, calls);
      clock.mark(r, 5);
      const int flag = !censored || m[1] > thr[r] ? 1 : 0;
      if (flag)
        for (int e = threadIdx.x; e < Dy * own_n; e += blockDim.x) {
          const size_t i = static_cast<size_t>(e / own_n) * D + a0 + e % own_n;
          sent_j[i] = own[i];
        }
      if (leader) {
        fl_wr[j] = flag;
        if (res != nullptr) {
          res[at] = m[0];
          bc[at] = flag;
        }
      }
      clock.mark_synced(r, 6);
    }
    grid.sync();
    clock.mark(r, 7);
  }

  const T* fin = R & 1 ? tab1 : work;
  for (size_t i = tid; i < static_cast<size_t>(J) * rows; i += stride)
    out_theta[i] = fin[i];
}

// The resident route: grid (C, J), cluster dims (C, 1, 1), node j =
// blockIdx.y; `tab` holds 2·J·Dy·D elements, `flags` 2·J ints, `prog` J
// counters (zeroed by the launcher), `waits` the [J, W] wait sets.
template <typename T, typename Clock>
__global__ void __launch_bounds__(dekrr::kResThreads, 1)
dekrr_async_solve_resident_kernel(
    const T* __restrict__ g, const T* __restrict__ d, const T* __restrict__ s,
    const T* __restrict__ p, const T* __restrict__ theta0,
    const T* __restrict__ sent0, const T* __restrict__ buf0,
    const int* __restrict__ nbr_idx, const int* __restrict__ nbr_mask,
    const int* __restrict__ active, const T* __restrict__ thr,
    const int* __restrict__ waits, unsigned* prog, T* __restrict__ out_theta,
    T* sent, T* buf, T* __restrict__ res, int* __restrict__ bc, T* tab,
    int* flags, unsigned long long* stamps, int R, int J, int K, int D,
    int Dy, int W, int censored, int edge, int rows_per_cta, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ dekrr::ClusterMax<T, 2> red;
  __shared__ int live_k[dekrr::kResMaxLive];
  __shared__ int nlive_s;
  __shared__ unsigned delivered;  // bit q: live slot q delivered this step
  __shared__ const T* src[dekrr::kResMaxLive + 1];
  cg::cluster_group cluster = cg::this_cluster();
  const Clock clock =
      dekrr::make_clock<Clock>(stamps, R + 1, kResidentPhases);
  clock.start();
  const int j = blockIdx.y;
  dekrr::Resident<T> node(cluster, smem_raw, live_k, &nlive_s, j, g, d, s, p,
                          nbr_mask, K, D, Dy, rows_per_cta, L);
  const int C = node.C;
  const bool leader = node.rank == 0 && threadIdx.x == 0;
  const size_t rows = node.rows;
  const size_t jk = static_cast<size_t>(j) * K;
  const int* wait_j = waits + static_cast<size_t>(j) * W;
  T* const tab1 = tab + static_cast<size_t>(J) * rows;  // table 0 is `tab`
  int* const fl1 = flags + J;                            // flags 0: `flags`
  int calls = 0;                                         // cluster_max calls
  // this block's share of a node's rows when the cluster splits a copy
  const size_t c_first =
      static_cast<size_t>(node.rank) * blockDim.x + threadIdx.x;
  const size_t c_step = static_cast<size_t>(C) * blockDim.x;
  const int a0 = node.a0, own_n = node.n;
  T* const sent_j = sent + static_cast<size_t>(j) * rows;

  for (size_t i = c_first; i < rows; i += c_step) sent_j[i] = sent0[j * rows + i];
  for (size_t i = c_first; i < K * rows; i += c_step)
    buf[jk * rows + i] = buf0[jk * rows + i];
  cluster.sync();

  for (int r = 0; r <= R; ++r) {
    if (r > 0) dekrr::wait_nodes(wait_j, W, prog, C * r);
    clock.mark(r, 0);
    const T* rd = r & 1 ? tab1 : tab;
    T* wr = r & 1 ? tab : tab1;
    const int* fl_rd = r & 1 ? fl1 : flags;
    int* fl_wr = r & 1 ? flags : fl1;
    const bool deliver =
        r >= 1 && (!edge || active[static_cast<size_t>(r - 1) * J + j]);
    const T* own_rd = r == 0 ? theta0 + j * rows : rd + j * rows;
    // where each staged row block comes from: own rows; a live slot
    // delivered this step from the read table, any other from its buffer
    if (threadIdx.x == 0) delivered = 0u;
    __syncthreads();
    if (threadIdx.x <= node.nlive) {
      const int q = threadIdx.x;
      if (q == 0) {
        src[0] = own_rd;
      } else {
        const int k = live_k[q - 1];
        const int nb = nbr_idx[jk + k];
        if (deliver && __ldcg(fl_rd + nb) != 0) {
          src[q] = rd + static_cast<size_t>(nb) * rows;
          atomicOr(&delivered, 1u << (q - 1));
        } else {
          src[q] = buf + (jk + k) * rows;
        }
      }
    }
    __syncthreads();
    // delivery: the cluster splits the copies of the delivered slots
    for (int q = 1; q <= node.nlive; ++q) {
      if (!((delivered >> (q - 1)) & 1u)) continue;
      T* dst = buf + (jk + live_k[q - 1]) * rows;
      for (size_t i = c_first; i < rows; i += c_step) dst[i] = __ldcg(src[q] + i);
    }
    clock.mark_synced(r, 1);
    const size_t at = static_cast<size_t>(r) * J + j;
    if (r == R) {
      if (res != nullptr && leader) {
        res[at] = T(0);
        bc[at] = 0;
      }
      break;  // the flush delivers only
    }
    T* own = wr + static_cast<size_t>(j) * rows;
    T* fin = out_theta + static_cast<size_t>(j) * rows;
    if (active[at] == 0) {
      for (size_t i = c_first; i < rows; i += c_step) {
        const T v = __ldcg(own_rd + i);
        own[i] = v;
        if (r == R - 1) fin[i] = v;
      }
      if (leader) {
        fl_wr[j] = 0;
        if (res != nullptr) {
          res[at] = T(0);
          bc[at] = 0;
        }
      }
      dekrr::publish(prog, j);  // the whole cluster takes this branch
      clock.mark(r, 7);
      continue;
    }
    node.stage(src);
    clock.mark(r, 2);
    node.acc_rows(cluster);
    clock.mark_synced(r, 3);
    cluster.sync();
    clock.mark(r, 4);
    T m[2] = {node.out_rows(own, T(0)), T(0)};
    __syncthreads();
    if (r == R - 1)
      for (int e = threadIdx.x; e < Dy * own_n; e += blockDim.x) {
        const size_t i = static_cast<size_t>(e / own_n) * D + a0 + e % own_n;
        fin[i] = own[i];
      }
    if (censored)
      for (int e = threadIdx.x; e < Dy * own_n; e += blockDim.x) {
        const size_t i = static_cast<size_t>(e / own_n) * D + a0 + e % own_n;
        m[1] = fmax(m[1], fabs(own[i] - sent_j[i]));
      }
    clock.mark(r, 5);
    if (res != nullptr || censored)
      dekrr::cluster_max(cluster, m, red, calls);
    clock.mark(r, 6);
    const int flag = !censored || m[1] > thr[r] ? 1 : 0;
    if (flag)
      for (int e = threadIdx.x; e < Dy * own_n; e += blockDim.x) {
        const size_t i = static_cast<size_t>(e / own_n) * D + a0 + e % own_n;
        sent_j[i] = own[i];
      }
    if (leader) {
      fl_wr[j] = flag;
      if (res != nullptr) {
        res[at] = m[0];
        bc[at] = flag;
      }
    }
    dekrr::publish(prog, j);
    clock.mark(r, 7);
  }
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
  return cluster_max_active(dekrr_async_solve_kernel<T, dekrr::NoClock>,
                            dekrr::kClusterThreads, smem_bytes<T>(K, D, Dy),
                            cluster);
}

template <typename T>
int resident_max_clusters(int blocks, int threads, int smem) {
  return cluster_max_active(
      dekrr_async_solve_resident_kernel<T, dekrr::NoClock>, threads, smem,
      blocks);
}

template <typename T, typename Clock>
int launch(const void* g, const void* d, const void* s, const void* p,
           const void* theta0, const void* sent0, const void* buf0,
           const void* nbr_idx, const void* nbr_mask, const void* active,
           const void* thr, void* out_theta, void* sent, void* buf, void* res,
           void* bc, void* work, void* flags, void* stamps, int R, int J,
           int K, int D, int Dy, int T_rows, int censored, int edge,
           int cluster, int rows_per_cta, int n_clusters, void* stream) {
  if (cluster < 1 || cluster > 8 || rows_per_cta < 1 ||
      static_cast<long long>(cluster) * rows_per_cta < D || n_clusters > J)
    return static_cast<int>(cudaErrorInvalidValue);
  return cluster_launch_resident(
      dekrr_async_solve_kernel<T, Clock>, n_clusters, dekrr::kClusterThreads,
      smem_bytes<T>(K, D, Dy), cluster, stream, static_cast<const T*>(g),
      static_cast<const T*>(d), static_cast<const T*>(s),
      static_cast<const T*>(p), static_cast<const T*>(theta0),
      static_cast<const T*>(sent0), static_cast<const T*>(buf0),
      static_cast<const int*>(nbr_idx), static_cast<const int*>(nbr_mask),
      static_cast<const int*>(active), static_cast<const T*>(thr),
      static_cast<T*>(out_theta), static_cast<T*>(sent), static_cast<T*>(buf),
      static_cast<T*>(res), static_cast<int*>(bc), static_cast<T*>(work),
      static_cast<int*>(flags), static_cast<unsigned long long*>(stamps), R,
      J, K, D, Dy, T_rows, censored, edge, rows_per_cta);
}

template <typename T, typename Clock>
int launch_resident(const void* g, const void* d, const void* s,
                    const void* p, const void* theta0, const void* sent0,
                    const void* buf0, const void* nbr_idx,
                    const void* nbr_mask, const void* active, const void* thr,
                    const void* waits, void* prog, void* out_theta,
                    void* sent, void* buf, void* res, void* bc, void* tab,
                    void* flags, void* stamps, int R, int J, int K, int D,
                    int Dy, int W, int censored, int edge, int blocks,
                    int rows, int L, void* stream) {
  if (blocks < 1 || blocks > dekrr::kMaxCluster || rows < 1 ||
      rows > dekrr::kResMaxRows || static_cast<long long>(blocks) * rows < D ||
      D > 32 * dekrr::kLaneCols || L < 0 || L > dekrr::kResMaxLive ||
      L > K || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(prog, 0, sizeof(unsigned) * J,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return cluster_launch_resident(
      dekrr_async_solve_resident_kernel<T, Clock>, J,
      dekrr::resident_threads(rows), resident_smem_bytes<T>(L, D, Dy, rows),
      blocks, stream, static_cast<const T*>(g), static_cast<const T*>(d),
      static_cast<const T*>(s), static_cast<const T*>(p),
      static_cast<const T*>(theta0), static_cast<const T*>(sent0),
      static_cast<const T*>(buf0), static_cast<const int*>(nbr_idx),
      static_cast<const int*>(nbr_mask), static_cast<const int*>(active),
      static_cast<const T*>(thr), static_cast<const int*>(waits),
      static_cast<unsigned*>(prog), static_cast<T*>(out_theta),
      static_cast<T*>(sent), static_cast<T*>(buf), static_cast<T*>(res),
      static_cast<int*>(bc), static_cast<T*>(tab), static_cast<int*>(flags),
      static_cast<unsigned long long*>(stamps), R, J, K, D, Dy, W, censored,
      edge, rows, L);
}

}  // namespace

extern "C" {

// Clusters of `cluster` blocks the device holds at once for a (K, D, Dy)
// problem (the most a launch may ask for), negative on a CUDA error.
int dekrr_async_solve_max_clusters_f64(int K, int D, int Dy, int cluster) {
  return max_clusters<double>(K, D, Dy, cluster);
}

int dekrr_async_solve_max_clusters_f32(int K, int D, int Dy, int cluster) {
  return max_clusters<float>(K, D, Dy, cluster);
}

// res/bc [(R + 1), J] may both be null (no trace). `work` holds 2*T*Dy*D
// elements, `flags` 2*J ints. `cluster`, `rows_per_cta` and `n_clusters`
// as for dekrr_solve_f64.
int dekrr_async_solve_f64(const void* g, const void* d, const void* s,
                          const void* p, const void* theta0, const void* sent0,
                          const void* buf0, const void* nbr_idx,
                          const void* nbr_mask, const void* active,
                          const void* thr, void* out_theta, void* sent,
                          void* buf, void* res, void* bc, void* work,
                          void* flags, int R, int J, int K, int D, int Dy,
                          int T_rows, int censored, int edge, int cluster,
                          int rows_per_cta, int n_clusters, void* stream) {
  return launch<double, dekrr::NoClock>(
      g, d, s, p, theta0, sent0, buf0, nbr_idx, nbr_mask, active, thr,
      out_theta, sent, buf, res, bc, work, flags, nullptr, R, J, K, D, Dy,
      T_rows, censored, edge, cluster, rows_per_cta, n_clusters, stream);
}

int dekrr_async_solve_f32(const void* g, const void* d, const void* s,
                          const void* p, const void* theta0, const void* sent0,
                          const void* buf0, const void* nbr_idx,
                          const void* nbr_mask, const void* active,
                          const void* thr, void* out_theta, void* sent,
                          void* buf, void* res, void* bc, void* work,
                          void* flags, int R, int J, int K, int D, int Dy,
                          int T_rows, int censored, int edge, int cluster,
                          int rows_per_cta, int n_clusters, void* stream) {
  return launch<float, dekrr::NoClock>(
      g, d, s, p, theta0, sent0, buf0, nbr_idx, nbr_mask, active, thr,
      out_theta, sent, buf, res, bc, work, flags, nullptr, R, J, K, D, Dy,
      T_rows, censored, edge, cluster, rows_per_cta, n_clusters, stream);
}

// dekrr_async_solve_f64 with the phase clock on: `stamps` holds, for each
// block of the grid, 1 + (R + 1)·8 zeroed u64.
int dekrr_async_solve_clocked_f64(
    const void* g, const void* d, const void* s, const void* p,
    const void* theta0, const void* sent0, const void* buf0,
    const void* nbr_idx, const void* nbr_mask, const void* active,
    const void* thr, void* out_theta, void* sent, void* buf, void* res,
    void* bc, void* work, void* flags, void* stamps, int R, int J, int K,
    int D, int Dy, int T_rows, int censored, int edge, int cluster,
    int rows_per_cta, int n_clusters, void* stream) {
  return launch<double, dekrr::PhaseClock>(
      g, d, s, p, theta0, sent0, buf0, nbr_idx, nbr_mask, active, thr,
      out_theta, sent, buf, res, bc, work, flags, stamps, R, J, K, D, Dy,
      T_rows, censored, edge, cluster, rows_per_cta, n_clusters, stream);
}

// The resident route (as dekrr_solve_resident_f64): `tab` 2·J·Dy·D
// elements, `flags` 2·J ints, `prog` J u32 (zeroed here), `waits` [J, W].
int dekrr_async_solve_resident_f64(
    const void* g, const void* d, const void* s, const void* p,
    const void* theta0, const void* sent0, const void* buf0,
    const void* nbr_idx, const void* nbr_mask, const void* active,
    const void* thr, const void* waits, void* prog, void* out_theta,
    void* sent, void* buf, void* res, void* bc, void* tab, void* flags, int R,
    int J, int K, int D, int Dy, int W, int censored, int edge, int blocks,
    int rows, int L, void* stream) {
  return launch_resident<double, dekrr::NoClock>(
      g, d, s, p, theta0, sent0, buf0, nbr_idx, nbr_mask, active, thr, waits,
      prog, out_theta, sent, buf, res, bc, tab, flags, nullptr, R, J, K, D,
      Dy, W, censored, edge, blocks, rows, L, stream);
}

int dekrr_async_solve_resident_f32(
    const void* g, const void* d, const void* s, const void* p,
    const void* theta0, const void* sent0, const void* buf0,
    const void* nbr_idx, const void* nbr_mask, const void* active,
    const void* thr, const void* waits, void* prog, void* out_theta,
    void* sent, void* buf, void* res, void* bc, void* tab, void* flags, int R,
    int J, int K, int D, int Dy, int W, int censored, int edge, int blocks,
    int rows, int L, void* stream) {
  return launch_resident<float, dekrr::NoClock>(
      g, d, s, p, theta0, sent0, buf0, nbr_idx, nbr_mask, active, thr, waits,
      prog, out_theta, sent, buf, res, bc, tab, flags, nullptr, R, J, K, D,
      Dy, W, censored, edge, blocks, rows, L, stream);
}

// dekrr_async_solve_resident_f64 with the phase clock on (1 + (R + 1)·8
// stamps a block).
int dekrr_async_solve_resident_clocked_f64(
    const void* g, const void* d, const void* s, const void* p,
    const void* theta0, const void* sent0, const void* buf0,
    const void* nbr_idx, const void* nbr_mask, const void* active,
    const void* thr, const void* waits, void* prog, void* out_theta,
    void* sent, void* buf, void* res, void* bc, void* tab, void* flags,
    void* stamps, int R, int J, int K, int D, int Dy, int W, int censored,
    int edge, int blocks, int rows, int L, void* stream) {
  return launch_resident<double, dekrr::PhaseClock>(
      g, d, s, p, theta0, sent0, buf0, nbr_idx, nbr_mask, active, thr, waits,
      prog, out_theta, sent, buf, res, bc, tab, flags, stamps, R, J, K, D,
      Dy, W, censored, edge, blocks, rows, L, stream);
}

int dekrr_async_solve_resident_max_clusters_f64(int blocks, int threads,
                                                int smem) {
  return resident_max_clusters<double>(blocks, threads, smem);
}

int dekrr_async_solve_resident_max_clusters_f32(int blocks, int threads,
                                                int smem) {
  return resident_max_clusters<float>(blocks, threads, smem);
}

// Dynamic shared memory of a block at (K, D, Dy), as the launcher passes it
// (repro_torch.analysis.smem checks the same formula before any launch).
int dekrr_async_solve_smem_bytes_f64(int K, int D, int Dy) {
  return static_cast<int>(smem_bytes<double>(K, D, Dy));
}

int dekrr_async_solve_smem_bytes_f32(int K, int D, int Dy) {
  return static_cast<int>(smem_bytes<float>(K, D, Dy));
}

// ... and of a resident block of `rows` rows with L live slots.
int dekrr_async_solve_resident_smem_bytes_f64(int L, int D, int Dy,
                                              int rows) {
  return static_cast<int>(resident_smem_bytes<double>(L, D, Dy, rows));
}

int dekrr_async_solve_resident_smem_bytes_f32(int L, int D, int Dy,
                                              int rows) {
  return static_cast<int>(resident_smem_bytes<float>(L, D, Dy, rows));
}

}  // extern "C"
