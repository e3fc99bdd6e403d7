// One node's Eq. 19 update, the counterpart of the node body the Pallas
// kernels of src/repro/kernels/dekrr_step.py and dekrr_solve.py share
// (_eq19_update), shared here by the round kernel (dekrr_step.cu, with
// or without an activation mask), the multi-round solve (dekrr_solve.cu),
// the asynchronous-gossip chain (dekrr_async_solve.cu) and the Chebyshev
// chain (dekrr_cheb_solve.cu). All compute each output row with the same two
// per-row routines, so a fused chain equals the same number of per-round
// launches bit for bit. The cooperative launch the three chains share is at
// the end.
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
// cluster computes it: the chains run a whole node in one block
// (`eq19_node_rows`), the round kernel spreads a node's rows over a
// thread-block cluster, and both give the same bits. Masked slots are
// skipped: their P blocks are zero and are not read.
#pragma once
#include <cuda_runtime.h>

namespace dekrr {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDyChunk = 4;  // output columns accumulated per pass over a row

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
// ...). Returns a CUDA error code, 0 on success.
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
