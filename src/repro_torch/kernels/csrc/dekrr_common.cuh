// One node's Eq. 19 update, the counterpart of the node body the Pallas
// kernels of src/repro/kernels/dekrr_step.py and dekrr_solve.py share
// (_eq19_update), shared here by the round kernel (dekrr_step.cu, with
// or without an activation mask), the multi-round solve (dekrr_solve.cu),
// the asynchronous-gossip chain (dekrr_async_solve.cu) and the Chebyshev
// chain (dekrr_cheb_solve.cu). All compute each output row with the same two
// per-row routines, so a fused chain equals the same number of per-round
// launches bit for bit.
//
// Layout (row-major, all contiguous):
//   g, s   [J, D, D]        p [J, K, D, D]
//   d      [J*Dy, D]        node j owns rows [j*Dy, (j+1)*Dy)
//   table  [T*Dy, D]        θ table; table row t owns flat rows [t*Dy, (t+1)*Dy)
//   nbr_idx, nbr_mask [J, K] int32, self_idx [J] int32
//
//   out_j = G_j (d_j + S_j θ_self(j) + Σ_{k live} P_jk θ_nbr(j,k))
//
// Bound on the card: bytes. A round reads (2 + K) D×D blocks per node once
// and does 2 flops per element read, far below the ~20 flop/byte at which
// an H100 stops being limited by device memory in f64.
//
// Each element of acc = d + Sθ + ΣPθ and of out = G acc is computed by ONE
// warp, in one fixed order: lane_dot's lane-strided partials over the
// contraction axis (S first, then the live P blocks in slot order), then
// warp_sum's shuffle tree, then d + sum (`eq19_acc_row`, `eq19_out_row`).
// The bits of a row therefore do not depend on which warp, block or
// cluster computes it. `eq19_node_cluster` spreads a node's rows over a
// thread-block cluster, acc passed between the phases through distributed
// shared memory; every kernel above runs it (the chains on their streamed
// route). The three chains' resident route (`Resident`, at the end of this
// file) forms the same rows in the same order from operands it holds on
// chip. Masked slots are skipped: their P blocks are zero and are not
// read.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace dekrr {

// ------------------------------------------------------------ phase clock
// %globaltimer, ns.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The chains' phase clock, off: compiles to nothing (every production
// launch and the round kernel).
struct NoClock {
  __device__ void start() const {}
  __device__ void mark(int, int) const {}
  __device__ void mark_synced(int, int) const {}
};

// The chains' phase clock, on (the `*_clocked` entry points that
// `chip_smoke.py --chain-timings` calls): thread 0 of each block writes
// %globaltimer when the block ends a phase, into
// stamps[block][1 + step * phases + phase] (index 0: the block's start;
// block = blockIdx.y * gridDim.x + blockIdx.x). A phase that ends at a
// barrier is marked as thread 0 leaves it; `mark_synced` adds a block
// barrier first, for a phase that ends without one. A stamp never
// written stays 0 (the caller zeroes the buffer).
struct PhaseClock {
  unsigned long long* row;
  int phases;
  __device__ PhaseClock(unsigned long long* stamps, int steps, int n_phases)
      : phases(n_phases) {
    const size_t block =
        static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    row = stamps + block * (1 + static_cast<size_t>(steps) * n_phases);
  }
  __device__ void start() const {
    if (threadIdx.x == 0) row[0] = global_ns();
  }
  __device__ void mark(int step, int phase) const {
    if (threadIdx.x == 0)
      row[1 + static_cast<size_t>(step) * phases + phase] = global_ns();
  }
  __device__ void mark_synced(int step, int phase) const {
    __syncthreads();
    mark(step, phase);
  }
};

// The clock a kernel instantiated with `Clock` builds from its stamps
// argument (null for NoClock).
template <typename Clock>
__device__ __forceinline__ Clock make_clock(unsigned long long* stamps,
                                            int steps, int phases);
template <>
__device__ __forceinline__ NoClock make_clock<NoClock>(unsigned long long*,
                                                       int, int) {
  return NoClock();
}
template <>
__device__ __forceinline__ PhaseClock make_clock<PhaseClock>(
    unsigned long long* stamps, int steps, int phases) {
  return PhaseClock(stamps, steps, phases);
}

constexpr int kDyChunk = 4;  // output columns accumulated per pass over a row
// Warps of a cluster block (eq19_node_cluster). A row's bits do not depend on
// which warp forms it; at the paper's D = 200 a cluster of 7 such blocks
// gives every warp one row.
constexpr int kClusterWarps = 32;
constexpr int kClusterThreads = kClusterWarps * 32;
constexpr int kMaxCluster = 8;  // blocks of a cluster at most (portable size)

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // lane 0 holds the sum
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmax(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// Shared memory the update needs, in elements: (1 + K) staged θ blocks
// plus the acc block, each [Dy, D].
__host__ __device__ inline size_t node_smem_elems(int K, int D, int Dy) {
  return static_cast<size_t>(K + 2) * Dy * D;
}

// part[o] += sum over this lane's b of row[b] * v[o*D + b], o < no.
template <typename T>
__device__ __forceinline__ void lane_dot(T (&part)[kDyChunk], const T* row,
                                        const T* v, int lane, int D, int no) {
  for (int b = lane; b < D; b += 32) {
    const T w = row[b];
#pragma unroll
    for (int o = 0; o < kDyChunk; ++o)
      if (o < no) part[o] += w * v[o * D + b];
  }
}

// Where node j's neighbour row blocks come from: the θ table through the
// slot table (rounds of the synchronous and Chebyshev solves), ...
template <typename T>
struct TableRows {
  const T* table;
  const int* idx_j;   // nbr_idx row of node j
  size_t rows;        // Dy * D
  __device__ const T* operator()(int k) const {
    return table + static_cast<size_t>(idx_j[k]) * rows;
  }
};

// ... or the node's own staleness-buffer rows, slot k at row block
// j*K + k (the fused asynchronous chain).
template <typename T>
struct BufferRows {
  const T* first;     // buffer row block of slot (j, 0)
  size_t rows;
  __device__ const T* operator()(int k) const {
    return first + static_cast<size_t>(k) * rows;
  }
};

// Copy node j's own θ rows and its live neighbours' rows into th
// [(1 + K), Dy, D] (slot k at block 1 + k; masked slots are left alone).
// Threads `first`, `first + step`, ... of the caller's group take part.
template <typename T, typename NbrRows>
__device__ __forceinline__ void stage_theta(T* th, const T* self_src,
                                            NbrRows nbr_rows,
                                            const int* mask_j, int K,
                                            size_t rows, int first,
                                            int step) {
  for (size_t i = first; i < rows; i += step) th[i] = self_src[i];
  for (int k = 0; k < K; ++k) {
    if (mask_j[k] == 0) continue;
    const T* src = nbr_rows(k);
    T* dst = th + (1 + k) * rows;
    for (size_t i = first; i < rows; i += step) dst[i] = src[i];
  }
}

// Row a of acc = d_j + S_j θ_self + Σ_live P_jk θ_k, every output column
// o < Dy, by one warp (lane 0 writes acc[o*D + a]). th holds the staged
// rows as `stage_theta` leaves them.
template <typename T>
__device__ __forceinline__ void eq19_acc_row(int a, const T* __restrict__ s_j,
                                             const T* __restrict__ p_j,
                                             const T* __restrict__ d_j,
                                             const int* mask_j, const T* th,
                                             T* acc, int K, int D, int Dy,
                                             int lane) {
  const size_t rows = static_cast<size_t>(Dy) * D;
  const size_t dd = static_cast<size_t>(D) * D;
  for (int o0 = 0; o0 < Dy; o0 += kDyChunk) {
    const int no = min(kDyChunk, Dy - o0);
    T part[kDyChunk];
#pragma unroll
    for (int o = 0; o < kDyChunk; ++o) part[o] = T(0);
    lane_dot(part, s_j + static_cast<size_t>(a) * D, th + o0 * D, lane, D, no);
    for (int k = 0; k < K; ++k) {
      if (mask_j[k] == 0) continue;
      lane_dot(part, p_j + k * dd + static_cast<size_t>(a) * D,
               th + (1 + k) * rows + o0 * D, lane, D, no);
    }
#pragma unroll
    for (int o = 0; o < kDyChunk; ++o) {
      if (o >= no) break;
      const T sum = warp_sum(part[o]);
      const size_t at = static_cast<size_t>(o0 + o) * D + a;
      if (lane == 0) acc[at] = d_j[at] + sum;
    }
  }
}

// Row a of out = G_j acc, every output column o < Dy, by one warp (lane 0
// writes out_rows[o*D + a]). Returns max(local, |out − θ_self|) over the
// elements this lane wrote.
template <typename T>
__device__ __forceinline__ T eq19_out_row(int a, const T* __restrict__ g_j,
                                          const T* acc, const T* th_self,
                                          T* out_rows, T local, int D, int Dy,
                                          int lane) {
  for (int o0 = 0; o0 < Dy; o0 += kDyChunk) {
    const int no = min(kDyChunk, Dy - o0);
    T part[kDyChunk];
#pragma unroll
    for (int o = 0; o < kDyChunk; ++o) part[o] = T(0);
    lane_dot(part, g_j + static_cast<size_t>(a) * D, acc + o0 * D, lane, D, no);
#pragma unroll
    for (int o = 0; o < kDyChunk; ++o) {
      if (o >= no) break;
      const T val = warp_sum(part[o]);
      const size_t at = static_cast<size_t>(o0 + o) * D + a;
      if (lane == 0) {
        out_rows[at] = val;
        local = fmax(local, fabs(val - th_self[at]));
      }
    }
  }
  return local;
}

// Node j's update by one thread-block cluster (every block of it calls
// this with the same arguments). Block `rank` of the cluster forms rows
// [rank·R, (rank+1)·R) ∩ [0, D) (R = rows_per_cta, at least D over the
// cluster size) of acc and then of out:
//
//   1. every block stages the node's 1 + K live θ row blocks (a few KB);
//   2. block c forms its acc rows into its own shared memory, one warp
//      per row;
//   3. cluster.sync(); each block copies the other blocks' acc rows out of
//      their shared memory (map_shared_rank), then cluster.sync() again,
//      so no block moves on while a peer still reads it;
//   4. block c forms its out rows = G acc into out_rows.
//
// `smem` holds node_smem_elems(K, D, Dy) elements; on return its first
// Dy*D elements still hold the staged own rows. Returns this thread's share
// of max |out − θ_self| over the block's rows (reduce over the cluster,
// `cluster_max`, for the node's residual). Ends with a block barrier, so
// the caller may read the block's out rows and reuse smem at once; out
// rows of other blocks need a cluster barrier first.
//
// `clock` (the chains' phase clock, `PhaseClock`; `NoClock` elsewhere, which
// compiles to nothing) marks phases phase0 .. phase0 + 3 of step `step`:
// the staging, the acc rows, the acc exchange and the out rows.
template <typename T, typename NbrRows, typename Clock = NoClock>
__device__ T eq19_node_cluster(cooperative_groups::cluster_group& cluster,
                               int j, const T* __restrict__ g,
                               const T* __restrict__ d,
                               const T* __restrict__ s,
                               const T* __restrict__ p, const T* self_src,
                               NbrRows nbr_rows,
                               const int* __restrict__ nbr_mask, T* out_rows,
                               T* smem, int K, int D, int Dy,
                               int rows_per_cta, Clock clock = Clock(),
                               int step = 0, int phase0 = 0) {
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t rows = static_cast<size_t>(Dy) * D;
  const size_t dd = static_cast<size_t>(D) * D;
  T* th = smem;                    // [(1 + K), Dy, D]
  T* acc = smem + (K + 1) * rows;  // [Dy, D]
  const int* mask_j = nbr_mask + static_cast<size_t>(j) * K;
  stage_theta(th, self_src, nbr_rows, mask_j, K, rows, threadIdx.x,
              blockDim.x);
  __syncthreads();
  clock.mark(step, phase0);

  const int a0 = rank * rows_per_cta;
  const int a1 = min(D, a0 + rows_per_cta);
  const T* s_j = s + j * dd;
  const T* p_j = p + static_cast<size_t>(j) * K * dd;
  const T* d_j = d + j * rows;
  for (int a = a0 + warp; a < a1; a += kClusterWarps)
    eq19_acc_row(a, s_j, p_j, d_j, mask_j, th, acc, K, D, Dy, lane);
  clock.mark_synced(step, phase0 + 1);
  cluster.sync();

  for (int peer = 0; peer < C; ++peer) {
    const int b0 = peer * rows_per_cta;
    const int n = min(D, b0 + rows_per_cta) - b0;
    if (peer == rank || n <= 0) continue;
    const T* src = cluster.map_shared_rank(acc, peer);
    for (int e = threadIdx.x; e < Dy * n; e += blockDim.x) {
      const size_t at = static_cast<size_t>(e / n) * D + b0 + e % n;
      acc[at] = src[at];
    }
  }
  cluster.sync();
  clock.mark(step, phase0 + 2);

  const T* g_j = g + j * dd;
  T local = T(0);
  for (int a = a0 + warp; a < a1; a += kClusterWarps)
    local = eq19_out_row(a, g_j, acc, th, out_rows, local, D, Dy, lane);
  __syncthreads();
  clock.mark(step, phase0 + 3);
  return local;
}

// Shared memory of `cluster_max`: per-warp partials, and the partial of
// each block of the cluster, pushed there by that block, in two sets used
// in turn.
template <typename T, int N>
struct ClusterMax {
  T warp[kClusterWarps][N];
  T part[2][kMaxCluster][N];  // [set][rank]
};

// Cluster-wide max of each thread's v[i], i < N, returned in v to every
// thread of every block of the cluster, so the cluster may branch on it as
// one. Each block reduces its threads (shuffles, then warp 0 over the
// warps' partials); lanes c < C of warp 0 push the block's partial into
// block c's shared memory (map_shared_rank); after one cluster barrier
// every thread reads the C partials from its own block's shared memory in
// rank order (max is exact, so no order changes the bits). `calls` counts
// this thread's calls (every thread of the cluster makes the same calls):
// consecutive calls use the two sets of `part` in turn, so a block may
// push the next call's partials while a peer still reads this call's.
// Every thread of the cluster must call it (a block and a cluster barrier).
template <typename T, int N>
__device__ void cluster_max(cooperative_groups::cluster_group& cluster,
                            T (&v)[N], ClusterMax<T, N>& red, int& calls) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int C = static_cast<int>(cluster.num_blocks());
  const int set = calls++ & 1;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = warp_max(v[i]);
    if (lane == 0) red.warp[warp][i] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) / 32;
    T* dst = lane < C ? cluster.map_shared_rank(
                            red.part[set][cluster.block_rank()], lane)
                      : nullptr;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T m = warp_max(lane < nw ? red.warp[lane][i] : red.warp[0][i]);
      const T block = __shfl_sync(0xffffffffu, m, 0);
      if (lane < C) dst[i] = block;
    }
  }
  cluster.sync();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T m = red.part[set][0][i];
    for (int c = 1; c < C; ++c) m = fmax(m, red.part[set][c][i]);
    v[i] = m;
  }
}

// ======================================================= the resident route
// The chains' second route (kernels/dekrr_solve.py::resident_plan picks it
// where the operands fit on chip): each node is one cluster of C blocks,
// one cluster per node, all resident at once (a cooperative launch). Block
// c of node j holds rows [a0, a0 + n) of S_j and of the node's live P_jk in
// shared memory and the same rows of G_j in registers, read from device
// memory once per launch, not once per round. A round then reads only the
// (1 + live) θ row blocks it depends on (through L2), forms its acc rows
// from shared memory, pushes them into every block of the cluster (DSMEM),
// passes one cluster barrier and forms its out rows from the registers.
//
// No grid barrier: node j's blocks each add one to the node's monotone
// progress counter prog[j] (release, GPU scope) when they end a round, and
// start round r > 0 only once every node of the node's wait set W(j) has
// prog ≥ C·r (acquire). W(j) = {j} ∪ in(j) ∪ out(j), from the slot table in
// Python: the nodes j reads (their round r − 1 rows, read after), the nodes
// that read j (j overwrites in round r the parity table they read in round
// r − 1: write after read) and j itself (its own rows, formed by all its
// blocks). Every wait points at an earlier round, and every cluster is
// resident, so the chain cannot deadlock. The counters are the only
// atomics; no atomic touches a value.
//
// Every row keeps the streamed route's order: one warp, lane_dot's
// lane-strided partials, S first and then the live P blocks in slot order,
// warp_sum's tree, then d + sum; out = G acc the same way. Only the place
// the operands come from differs, so the resident route equals the
// streamed route and the round kernel bit for bit.
constexpr int kResRowsPerWarp = 2;  // rows a warp forms (θ read once for both)
constexpr int kResMaxRows = 32;     // rows a block forms at most
constexpr int kResThreads = 32 * kResMaxRows / kResRowsPerWarp;  // 512
constexpr int kLaneCols = 8;        // G values a lane holds a row: D ≤ 256
constexpr int kResMaxLive = 16;     // live slots a node may have
constexpr int kStageUnroll = 4;     // θ loads in flight a thread

// Shared memory of a resident block, in elements: the S and live P rows
// [(1 + L), rows, D], the staged θ [(1 + L), Dy, D] (own rows, then the
// live slots in slot order), acc [Dy, D] and the block's d rows [Dy, rows].
// The Chebyshev chain adds its p rows [Dy, rows] after the d rows.
// (kernels/dekrr_solve.py::resident_smem_bytes and
// repro_torch.analysis.smem compute the same formula.)
__host__ __device__ inline size_t resident_smem_elems(int L, int D, int Dy,
                                                      int rows) {
  return static_cast<size_t>(1 + L) * rows * D +
         static_cast<size_t>(1 + L) * Dy * D + static_cast<size_t>(Dy) * D +
         static_cast<size_t>(Dy) * rows;
}

__host__ __device__ inline int resident_threads(int rows) {
  return 32 * ((rows + kResRowsPerWarp - 1) / kResRowsPerWarp);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// End of a round: every thread's writes of the block are done (barrier),
// then one thread adds one to prog[j] with release semantics at GPU scope.
__device__ __forceinline__ void publish(unsigned* prog, int j) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                 :
                 : "l"(prog + j)
                 : "memory");
}

// A wait that sees no progress for this long traps (the launch fails with
// an error) rather than holding the card: every wait points at an earlier
// round of a resident cluster, so only a fault in the plan or the kernel
// could make one last.
constexpr unsigned long long kWaitLimitNs = 5000000000ull;

// Start of a round: lanes of warp 0 each spin on the counters of a few
// nodes of the wait set (acquire), then a block barrier hands the acquired
// view to every thread. `wait` is node j's row of the [J, W] table, -1
// padded.
__device__ __forceinline__ void wait_nodes(const int* __restrict__ wait,
                                           int W, const unsigned* prog,
                                           unsigned target) {
  if (threadIdx.x < 32) {
    for (int i = threadIdx.x; i < W; i += 32) {
      const int node = wait[i];
      if (node < 0) continue;
      const unsigned long long t0 = global_ns();
      while (ld_acquire(prog + node) < target)
        if (global_ns() - t0 > kWaitLimitNs) __trap();
    }
    __syncwarp();
  }
  __syncthreads();
}

// dst[i] = src[i], i < n, by threads tid, tid + step, ...: 16-byte moves
// where both ends and n allow, else elements; `Volatile` reads through L2
// only (data written in this launch by other blocks), else through the
// read-only path (the operands).
template <typename T, bool kFromL2>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kFromL2)
    return __ldcg(p);
  else
    return __ldg(p);
}

template <bool kFromL2, typename T>
__device__ void copy_rows(T* dst, const T* src, size_t n, size_t tid,
                          size_t step) {
  constexpr int U = 8;
  const bool vec =
      ((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src) |
        (n * sizeof(T))) & 15) == 0;
  if (vec) {
    const size_t n4 = n * sizeof(T) / 16;
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int4* s4 = reinterpret_cast<const int4*>(src);
    size_t i = tid;
    for (; i + (U - 1) * step < n4; i += U * step) {
      int4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = load<int4, kFromL2>(s4 + i + u * step);
#pragma unroll
      for (int u = 0; u < U; ++u) d4[i + u * step] = v[u];
    }
    for (; i < n4; i += step) d4[i] = load<int4, kFromL2>(s4 + i);
    return;
  }
  size_t i = tid;
  for (; i + (U - 1) * step < n; i += U * step) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = load<T, kFromL2>(src + i + u * step);
#pragma unroll
    for (int u = 0; u < U; ++u) dst[i + u * step] = v[u];
  }
  for (; i < n; i += step) dst[i] = load<T, kFromL2>(src + i);
}

// part0[o] += r0[b] * v[o*D + b] and part1[o] += r1[b] * v[o*D + b] over
// this lane's b: lane_dot for two rows at once (each θ value read once for
// both); each row's partials take lane_dot's operations in lane_dot's
// order. Without a second row (`two` false) part1 is left to the caller
// to ignore. (A lane loop unrolled to kLaneCols steps, 4 rows a warp, and
// the acc stores spread over the lanes each measured slower on an H100.)
template <typename T>
__device__ __forceinline__ void lane_dot2(T (&part0)[kDyChunk],
                                          T (&part1)[kDyChunk], const T* r0,
                                          const T* r1, bool two, const T* v,
                                          int lane, int D, int no) {
  for (int b = lane; b < D; b += 32) {
    const T w0 = r0[b];
    const T w1 = two ? r1[b] : T(0);
#pragma unroll
    for (int o = 0; o < kDyChunk; ++o)
      if (o < no) {
        const T x = v[o * D + b];
        part0[o] += w0 * x;
        part1[o] += w1 * x;
      }
  }
}

// The value `Resident::out_rows` writes for an out element: the element
// itself (the synchronous and asynchronous chains). The Chebyshev chain
// passes its own update (dekrr_cheb_solve.cu).
struct Identity {
  template <typename T>
  __device__ __forceinline__ T operator()(T v, T, int, int) const {
    return v;
  }
};

// One block of a resident node: its rows, its shared-memory layout and its
// G rows in registers. Warp w forms local rows w and w + warps.
static_assert(kResRowsPerWarp == 2, "Resident forms two rows a warp");
template <typename T>
struct Resident {
  int j, rank, C, a0, n, cap, nlive, D, Dy, lane, lr0, lr1;
  size_t rows;                 // Dy * D, one θ row block
  T *ops, *th, *acc, *dsm;
  T g0[kLaneCols], g1[kLaneCols];

  // Lays out shared memory, lists the live slots of node j (slot order)
  // into live_k and stages this block's rows of S, the live P, d and G.
  // Every thread of the block calls it; ends with a block barrier.
  __device__ Resident(cooperative_groups::cluster_group& cluster,
                      unsigned char* smem_raw, int* live_k, int* nlive_s,
                      int node, const T* __restrict__ g,
                      const T* __restrict__ d, const T* __restrict__ s,
                      const T* __restrict__ p,
                      const int* __restrict__ nbr_mask, int K, int D_,
                      int Dy_, int rows_per_cta, int L)
      : j(node), D(D_), Dy(Dy_) {
    rank = static_cast<int>(cluster.block_rank());
    C = static_cast<int>(cluster.num_blocks());
    cap = rows_per_cta;
    a0 = rank * cap;
    n = max(0, min(D, a0 + cap) - a0);
    rows = static_cast<size_t>(Dy) * D;
    lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
    lr0 = warp < n ? warp : -1;
    lr1 = warp + warps < n ? warp + warps : -1;
    T* base = reinterpret_cast<T*>(smem_raw);
    ops = base;
    th = ops + static_cast<size_t>(1 + L) * cap * D;
    acc = th + static_cast<size_t>(1 + L) * rows;
    dsm = acc + rows;
    if (threadIdx.x == 0) {
      int m = 0;
      for (int k = 0; k < K; ++k)
        if (nbr_mask[static_cast<size_t>(j) * K + k] != 0) live_k[m++] = k;
      *nlive_s = m;
    }
    __syncthreads();
    nlive = *nlive_s;
    const size_t dd = static_cast<size_t>(D) * D;
    for (int q = 0; q <= nlive; ++q) {
      const T* src = (q == 0 ? s + j * dd
                             : p + (static_cast<size_t>(j) * K +
                                    live_k[q - 1]) * dd) +
                     static_cast<size_t>(a0) * D;
      copy_rows<false>(ops + static_cast<size_t>(q) * cap * D, src,
                       static_cast<size_t>(n) * D, threadIdx.x, blockDim.x);
    }
    for (int e = threadIdx.x; e < Dy * n; e += blockDim.x)
      dsm[(e / n) * cap + e % n] =
          d[j * rows + static_cast<size_t>(e / n) * D + a0 + e % n];
    const T* g_j = g + j * dd;
#pragma unroll
    for (int i = 0; i < kLaneCols; ++i) {
      const int b = lane + 32 * i;
      g0[i] = lr0 >= 0 && b < D ? g_j[static_cast<size_t>(a0 + lr0) * D + b]
                                : T(0);
      g1[i] = lr1 >= 0 && b < D ? g_j[static_cast<size_t>(a0 + lr1) * D + b]
                                : T(0);
    }
    __syncthreads();
  }

  // th[q] = *src[q] for the (1 + nlive) staged row blocks, through L2,
  // kStageUnroll loads in flight a thread. Ends with a block barrier.
  __device__ void stage(const T* const* src) {
    const int total = static_cast<int>((1 + nlive) * rows);
    const int R = static_cast<int>(rows);
    for (int b0 = threadIdx.x; b0 < total; b0 += kStageUnroll * blockDim.x) {
      T v[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int e = b0 + u * blockDim.x;
        if (e < total) {
          const int q = e / R;
          v[u] = __ldcg(src[q] + (e - q * R));
        }
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int e = b0 + u * blockDim.x;
        if (e < total) th[e] = v[u];
      }
    }
    __syncthreads();
  }

  // acc rows of this block, every output column, written into acc and into
  // acc of every other block of the cluster (DSMEM stores); the caller's
  // cluster barrier makes them visible.
  __device__ void acc_rows(cooperative_groups::cluster_group& cluster) {
    if (lr0 < 0) return;
    const bool two = lr1 >= 0;
    const size_t slot = static_cast<size_t>(cap) * D;
    for (int o0 = 0; o0 < Dy; o0 += kDyChunk) {
      const int no = min(kDyChunk, Dy - o0);
      T p0[kDyChunk], p1[kDyChunk];
#pragma unroll
      for (int o = 0; o < kDyChunk; ++o) p0[o] = p1[o] = T(0);
      const T* r0 = ops + static_cast<size_t>(lr0) * D;
      const T* r1 = ops + static_cast<size_t>(two ? lr1 : lr0) * D;
      lane_dot2(p0, p1, r0, r1, two, th + o0 * D, lane, D, no);
      for (int q = 1; q <= nlive; ++q)
        lane_dot2(p0, p1, r0 + q * slot, r1 + q * slot, two,
                  th + q * rows + o0 * D, lane, D, no);
#pragma unroll
      for (int o = 0; o < kDyChunk; ++o) {
        if (o >= no) break;
        const T s0 = warp_sum(p0[o]);
        const T s1 = warp_sum(p1[o]);
        if (lane == 0) {
          const size_t at0 = static_cast<size_t>(o0 + o) * D + a0 + lr0;
          const T v0 = dsm[(o0 + o) * cap + lr0] + s0;
          T v1 = T(0);
          size_t at1 = 0;
          if (two) {
            at1 = static_cast<size_t>(o0 + o) * D + a0 + lr1;
            v1 = dsm[(o0 + o) * cap + lr1] + s1;
          }
          for (int c = 0; c < C; ++c) {
            T* dst = c == rank ? acc : cluster.map_shared_rank(acc, c);
            dst[at0] = v0;
            if (two) dst[at1] = v1;
          }
        }
      }
    }
  }

  // out rows = G acc of this block into out_j (node j's row block), every
  // output column; returns max(local, |out − θ_self|) over what this lane
  // wrote. `epi(v, θ_self, o, lr)` gives the value written for element
  // (o, a0 + lr) from its sum v, in the lane that formed it (Identity:
  // v itself).
  template <typename Epilogue = Identity>
  __device__ T out_rows(T* out_j, T local, Epilogue epi = Epilogue()) const {
    if (lr0 < 0) return local;
    const bool two = lr1 >= 0;
    for (int o0 = 0; o0 < Dy; o0 += kDyChunk) {
      const int no = min(kDyChunk, Dy - o0);
      T p0[kDyChunk], p1[kDyChunk];
#pragma unroll
      for (int o = 0; o < kDyChunk; ++o) p0[o] = p1[o] = T(0);
#pragma unroll
      for (int i = 0; i < kLaneCols; ++i) {
        const int b = lane + 32 * i;
        if (b < D) {
#pragma unroll
          for (int o = 0; o < kDyChunk; ++o)
            if (o < no) {
              const T x = acc[(o0 + o) * D + b];
              p0[o] += g0[i] * x;
              p1[o] += g1[i] * x;
            }
        }
      }
#pragma unroll
      for (int o = 0; o < kDyChunk; ++o) {
        if (o >= no) break;
        const T v0 = warp_sum(p0[o]);
        const T v1 = warp_sum(p1[o]);
        if (lane == 0) {
          const size_t at0 = static_cast<size_t>(o0 + o) * D + a0 + lr0;
          const T w0 = epi(v0, th[at0], o0 + o, lr0);
          out_j[at0] = w0;
          local = fmax(local, fabs(w0 - th[at0]));
          if (two) {
            const size_t at1 = static_cast<size_t>(o0 + o) * D + a0 + lr1;
            const T w1 = epi(v1, th[at1], o0 + o, lr1);
            out_j[at1] = w1;
            local = fmax(local, fabs(w1 - th[at1]));
          }
        }
      }
    }
    return local;
  }
};

// Max over the block's threads of v, in thread 0 (warp_max, then warp 0
// over the warps' values in `scratch`, one slot a warp).
template <typename T>
__device__ __forceinline__ T block_max(T v, T* scratch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_max(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x / 32;
    v = warp_max(lane < nw ? scratch[lane] : scratch[0]);
  }
  return v;
}

// R synchronous rounds of a resident node (dekrr_solve.cu's and
// dekrr_cheb_solve.cu's resident kernels; grid (C, J), cluster dims
// (C, 1, 1), node j = node.j). Round r waits for round r − 1 of the wait
// set `wait_j` (W entries, −1 padded) on the progress counters `prog`
// (zeroed before the launch), stages θ_self and the live slots' rows from
// table r % 2 (round 0, and a slot whose table row no node owns,
// nbr_node −1: θ0's row), forms acc, then the out rows through
// `epi_of(r)` (Resident::out_rows' epilogue) into table (r + 1) % 2, the
// last round into `out`, and publishes. `tab` holds 2·J·Dy·D elements of
// node rows. The trace res[r, j] (null: none): each block pushes its max
// into block rank 0's shared memory (DSMEM) at the end of round r, and
// rank 0 reads the C partials in rank order after round r + 1's cluster
// barrier; the last round's after one more barrier, which also keeps each
// block alive until its peers' pushes into it are done. Max is exact.
template <typename T, typename Clock, typename EpiOf>
__device__ __forceinline__ void resident_sync_rounds(
    cooperative_groups::cluster_group& cluster, Resident<T>& node,
    const Clock& clock, const int* live_k, const T* __restrict__ theta0,
    const int* __restrict__ nbr_idx, const int* __restrict__ nbr_node,
    const int* __restrict__ self_idx, const int* __restrict__ wait_j,
    int W, unsigned* prog, T* tab, T* __restrict__ out, T* __restrict__ res,
    int R, int J, int K, EpiOf epi_of) {
  __shared__ const T* src[kResMaxLive + 1];
  __shared__ T part[2][kMaxCluster];  // trace partials, by rank
  __shared__ T scratch[kResThreads / 32];
  const int j = node.j;
  const size_t rows = node.rows;
  const size_t jk = static_cast<size_t>(j) * K;
  T* const tab1 = tab + static_cast<size_t>(J) * rows;  // table 0 is `tab`

  for (int r = 0; r < R; ++r) {
    if (r > 0) wait_nodes(wait_j, W, prog, node.C * r);
    clock.mark(r, 0);
    const T* rd = r & 1 ? tab1 : tab;
    if (threadIdx.x <= node.nlive) {
      const int q = threadIdx.x;
      int owner = j;
      size_t row = self_idx[j];
      if (q > 0) {
        owner = nbr_node[jk + live_k[q - 1]];
        row = nbr_idx[jk + live_k[q - 1]];
      }
      src[q] = r == 0 || owner < 0 ? theta0 + row * rows
                                   : rd + static_cast<size_t>(owner) * rows;
    }
    __syncthreads();
    node.stage(src);
    clock.mark(r, 1);
    node.acc_rows(cluster);
    clock.mark_synced(r, 2);
    cluster.sync();
    clock.mark(r, 3);
    if (res != nullptr && r > 0 && node.rank == 0 && threadIdx.x == 0) {
      T m = part[(r - 1) & 1][0];
      for (int c = 1; c < node.C; ++c) m = fmax(m, part[(r - 1) & 1][c]);
      res[static_cast<size_t>(r - 1) * J + j] = m;
    }
    T* wr = r == R - 1 ? out : (r & 1 ? tab : tab1);
    const T local =
        node.out_rows(wr + static_cast<size_t>(j) * rows, T(0), epi_of(r));
    clock.mark_synced(r, 4);
    if (res != nullptr) {
      const T m = block_max(local, scratch);
      if (threadIdx.x == 0)
        *cluster.map_shared_rank(&part[r & 1][node.rank], 0) = m;
    }
    publish(prog, j);  // its barrier also ends the round's epilogue writes
    clock.mark(r, 5);
  }
  if (res != nullptr) {
    cluster.sync();
    if (node.rank == 0 && threadIdx.x == 0) {
      T m = part[(R - 1) & 1][0];
      for (int c = 1; c < node.C; ++c) m = fmax(m, part[(R - 1) & 1][c]);
      res[static_cast<size_t>(R - 1) * J + j] = m;
    }
  }
}

}  // namespace dekrr
