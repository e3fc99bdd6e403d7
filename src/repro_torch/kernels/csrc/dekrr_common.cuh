// One node's Eq. 19 update, shared by the round kernel (dekrr_step.cu, with
// or without an activation mask), the multi-round solve (dekrr_solve.cu),
// the asynchronous-gossip chain (dekrr_async_solve.cu) and the Chebyshev
// chain (dekrr_cheb_solve.cu). All launch the same block shape and call one
// function, so a fused chain equals the same number of per-round launches
// bit for bit. The cooperative launch the three chains share is at the end.
//
// Layout (row-major, all contiguous):
//   g, s   [J, D, D]        p [J, K, D, D]
//   d      [J*Dy, D]        node j owns rows [j*Dy, (j+1)*Dy)
//   table  [T*Dy, D]        θ table; table row t owns flat rows [t*Dy, (t+1)*Dy)
//   nbr_idx, nbr_mask [J, K] int32, self_idx [J] int32
//
//   out_j = G_j (d_j + S_j θ_self(j) + Σ_{k live} P_jk θ_nbr(j,k))
//
// The block stages the 1 + K live θ row blocks in shared memory, forms acc
// with one warp per output row (lanes stride the contraction axis, so each
// warp reads a matrix row with coalesced loads), then applies G the same
// way. Masked slots are skipped: their P blocks are zero and are not read.
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

// Node j's update from an explicit own row block and neighbour row blocks.
// `smem` holds node_smem_elems(K, D, Dy) elements; on return its first
// Dy*D elements still hold the staged own rows θ_self(j). Returns this
// thread's share of max |out_j - θ_self(j)| (reduce over the block for the
// node's residual). Ends with a block barrier, so the caller may read
// out_rows and the staged own rows at once; it must barrier again before
// the next call reuses smem.
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

  for (size_t i = threadIdx.x; i < rows; i += blockDim.x) th[i] = self_src[i];
  for (int k = 0; k < K; ++k) {
    if (mask_j[k] == 0) continue;
    const T* src = nbr_rows(k);
    T* dst = th + (1 + k) * rows;
    for (size_t i = threadIdx.x; i < rows; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();

  // acc = d + S θ_self + Σ_live P_k θ_k
  const T* s_j = s + j * dd;
  const T* p_j = p + static_cast<size_t>(j) * K * dd;
  const T* d_j = d + j * rows;
  for (int a = warp; a < D; a += kWarps) {
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
  __syncthreads();

  // out = G acc
  const T* g_j = g + j * dd;
  T local = T(0);
  for (int a = warp; a < D; a += kWarps) {
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
          local = fmax(local, fabs(val - th[at]));
        }
      }
    }
  }
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
