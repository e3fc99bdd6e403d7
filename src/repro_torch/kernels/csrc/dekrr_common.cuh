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
// cluster computes it. Two node bodies run the rows:
//   - `eq19_node_cluster`: a node's rows spread over a thread-block
//     cluster, acc passed between the phases through distributed shared
//     memory. The round kernel, the multi-round solve and the async chain
//     run it.
//   - `eq19_node_rows`: a whole node in one block of kThreads threads. The
//     Chebyshev chain runs it, in the cooperative launch at the end.
// Both give the same bits. Masked slots are skipped: their P blocks are
// zero and are not read.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace dekrr {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

// Node j's update by one block, from an explicit own row block and
// neighbour row blocks. `smem` holds node_smem_elems(K, D, Dy) elements; on
// return its first Dy*D elements still hold the staged own rows
// θ_self(j). Returns this thread's share of max |out_j - θ_self(j)| (reduce
// over the block for the node's residual). Ends with a block barrier, so
// the caller may read out_rows and the staged own rows at once; it must
// barrier again before the next call reuses smem.
//
// The arithmetic after staging does not depend on where the rows came
// from, so every kernel that calls this with the same row values gets the
// same bits.
template <typename T, typename NbrRows>
__device__ T eq19_node_rows(int j, const T* __restrict__ g,
                            const T* __restrict__ d, const T* __restrict__ s,
                            const T* __restrict__ p, const T* self_src,
                            NbrRows nbr_rows, const int* __restrict__ nbr_mask,
                            T* out_rows, T* smem, int K, int D, int Dy) {
  const size_t rows = static_cast<size_t>(Dy) * D;
  const size_t dd = static_cast<size_t>(D) * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  T* th = smem;                          // [(1 + K), Dy, D]
  T* acc = smem + (K + 1) * rows;        // [Dy, D]
  const int* mask_j = nbr_mask + static_cast<size_t>(j) * K;

  stage_theta(th, self_src, nbr_rows, mask_j, K, rows, threadIdx.x,
              blockDim.x);
  __syncthreads();

  const T* s_j = s + j * dd;
  const T* p_j = p + static_cast<size_t>(j) * K * dd;
  const T* d_j = d + j * rows;
  for (int a = warp; a < D; a += kWarps)
    eq19_acc_row(a, s_j, p_j, d_j, mask_j, th, acc, K, D, Dy, lane);
  __syncthreads();

  const T* g_j = g + j * dd;
  T local = T(0);
  for (int a = warp; a < D; a += kWarps)
    local = eq19_out_row(a, g_j, acc, th, out_rows, local, D, Dy, lane);
  __syncthreads();
  return local;
}

// Node j's update with its rows read from the θ table through the slot
// tables (layout at the top of this file).
template <typename T>
__device__ T eq19_node(int j, const T* __restrict__ g, const T* __restrict__ d,
                       const T* __restrict__ s, const T* __restrict__ p,
                       const T* table, const int* __restrict__ nbr_idx,
                       const int* __restrict__ self_idx,
                       const int* __restrict__ nbr_mask, T* out_rows, T* smem,
                       int K, int D, int Dy) {
  const size_t rows = static_cast<size_t>(Dy) * D;
  return eq19_node_rows<T>(
      j, g, d, s, p, table + static_cast<size_t>(self_idx[j]) * rows,
      TableRows<T>{table, nbr_idx + static_cast<size_t>(j) * K, rows},
      nbr_mask, out_rows, smem, K, D, Dy);
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
template <typename T, typename NbrRows>
__device__ T eq19_node_cluster(cooperative_groups::cluster_group& cluster,
                               int j, const T* __restrict__ g,
                               const T* __restrict__ d,
                               const T* __restrict__ s,
                               const T* __restrict__ p, const T* self_src,
                               NbrRows nbr_rows,
                               const int* __restrict__ nbr_mask, T* out_rows,
                               T* smem, int K, int D, int Dy,
                               int rows_per_cta) {
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

  const int a0 = rank * rows_per_cta;
  const int a1 = min(D, a0 + rows_per_cta);
  const T* s_j = s + j * dd;
  const T* p_j = p + static_cast<size_t>(j) * K * dd;
  const T* d_j = d + j * rows;
  for (int a = a0 + warp; a < a1; a += kClusterWarps)
    eq19_acc_row(a, s_j, p_j, d_j, mask_j, th, acc, K, D, Dy, lane);
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

  const T* g_j = g + j * dd;
  T local = T(0);
  for (int a = a0 + warp; a < a1; a += kClusterWarps)
    local = eq19_out_row(a, g_j, acc, th, out_rows, local, D, Dy, lane);
  __syncthreads();
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

// Block-wide max of each thread's `v`, returned to every thread, so the
// block may branch on it as one. `red` is kWarps elements of shared
// memory. Every thread of the block must call it (two block barriers).
template <typename T>
__device__ T block_max(T v, T* red) {
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  T m = red[0];
  for (int w = 1; w < kWarps; ++w) m = fmax(m, red[w]);
  __syncthreads();
  return m;
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Co-resident blocks of a cooperative kernel on this device with `smem`
// bytes of dynamic shared memory, 0 when the device cannot launch
// cooperatively, or a negative CUDA error code.
template <typename Kernel>
inline int coop_max_blocks(Kernel kernel, size_t smem) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) !=
      cudaSuccess)
    return -static_cast<int>(err);
  if (!coop) return 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return -static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

// One cooperative launch of `kernel` over min(J, co-resident cap) blocks of
// kThreads threads (each block loops over nodes j = blockIdx.x, + gridDim.x,
// ...): the Chebyshev chain's launch. Returns a CUDA error code, 0 on
// success.
template <typename Kernel>
inline int coop_launch(Kernel kernel, int J, size_t smem, void** args,
                       void* stream) {
  const int cap = coop_max_blocks(kernel, smem);
  if (cap < 0) return -cap;
  if (cap == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  dim3 grid(J < cap ? J : cap);
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), grid, dim3(kThreads), args, smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dekrr
