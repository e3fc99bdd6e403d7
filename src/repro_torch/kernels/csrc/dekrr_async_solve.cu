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
//   compute (r < R): an active node runs dekrr::eq19_node_rows against its
//     buffers, then broadcasts iff censoring is off or
//     max|new - sent| > thr[r] (strict; over the whole [Dy, D] block, reduced
//     across the block before any thread branches on it); an inactive node
//     copies its θ rows through and lowers its flag;
//   step R delivers only (the flush of round R - 1's broadcasts).
//
// The Pallas kernel runs its (R + 1, J) grid in order. Here the grid loops
// over nodes and one grid.sync() ends each step. That one barrier is enough
// because every value read across nodes (the read-parity θ table and the
// read-parity flags) was written in the previous step, and every value
// written in a step (write-parity θ rows, sent rows, buffer rows, the
// write-parity flag) belongs to the writing node alone.
//
// Neighbour rows come from the buffer rows and the own row from the read
// table; the arithmetic is eq19_node_rows, the same function the round
// kernel runs on the [θ; buffers] table, so one launch of R rounds equals R
// masked round launches plus the delivery rule bit for bit.
//
// Bound on the card: as for dekrr_solve.cu, the inputs are read from device
// memory once in the count, so over R rounds the bound is the flops of the
// active nodes' updates; the kernel itself is latency-bound (one block per
// node on J of 132 SMs, a grid barrier per step).
#include <cooperative_groups.h>

#include "dekrr_common.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T>
__global__ void __launch_bounds__(dekrr::kThreads)
dekrr_async_solve_kernel(
    const T* __restrict__ g, const T* __restrict__ d, const T* __restrict__ s,
    const T* __restrict__ p, const T* __restrict__ theta0,
    const T* __restrict__ sent0, const T* __restrict__ buf0,
    const int* __restrict__ nbr_idx, const int* __restrict__ nbr_mask,
    const int* __restrict__ active, const T* __restrict__ thr,
    T* __restrict__ out_theta, T* sent, T* buf, T* __restrict__ res,
    int* __restrict__ bc, T* work, int* flags, int R, int J, int K, int D,
    int Dy, int T_rows, int censored, int edge) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[dekrr::kWarps];
  T* smem = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const size_t rows = static_cast<size_t>(Dy) * D;
  const size_t n = static_cast<size_t>(T_rows) * rows;
  T* tab[2] = {work, work + n};
  int* fl[2] = {flags, flags + J};

  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (size_t i = tid; i < n; i += stride) {
    tab[0][i] = theta0[i];
    tab[1][i] = theta0[i];
  }
  for (size_t i = tid; i < static_cast<size_t>(J) * rows; i += stride)
    sent[i] = sent0[i];
  for (size_t i = tid; i < static_cast<size_t>(J) * K * rows; i += stride)
    buf[i] = buf0[i];
  for (size_t i = tid; i < static_cast<size_t>(2) * J; i += stride) flags[i] = 0;
  grid.sync();

  for (int r = 0; r <= R; ++r) {
    const T* rd = tab[r & 1];
    T* wr = tab[(r + 1) & 1];
    const int* fl_rd = fl[r & 1];
    int* fl_wr = fl[(r + 1) & 1];
    for (int j = blockIdx.x; j < J; j += gridDim.x) {
      const size_t jk = static_cast<size_t>(j) * K;
      if (r >= 1 && (!edge || active[static_cast<size_t>(r - 1) * J + j])) {
        for (int k = 0; k < K; ++k) {
          const int nb = nbr_idx[jk + k];
          if (nbr_mask[jk + k] == 0 || fl_rd[nb] == 0) continue;
          const T* src = rd + static_cast<size_t>(nb) * rows;
          T* dst = buf + (jk + k) * rows;
          for (size_t i = threadIdx.x; i < rows; i += blockDim.x) dst[i] = src[i];
        }
      }
      __syncthreads();
      const size_t at = static_cast<size_t>(r) * J + j;
      if (r == R) {
        if (res != nullptr && threadIdx.x == 0) {
          res[at] = T(0);
          bc[at] = 0;
        }
        continue;
      }
      const T* own_rd = rd + static_cast<size_t>(j) * rows;
      T* own = wr + static_cast<size_t>(j) * rows;
      T* sent_j = sent + static_cast<size_t>(j) * rows;
      T resid = T(0);
      int flag = 0;
      if (active[at] != 0) {
        const T local = dekrr::eq19_node_rows<T>(
            j, g, d, s, p, own_rd, dekrr::BufferRows<T>{buf + jk * rows, rows},
            nbr_mask, own, smem, K, D, Dy);
        if (res != nullptr) resid = dekrr::block_max(local, red);
        flag = 1;
        if (censored) {
          T part = T(0);
          for (size_t i = threadIdx.x; i < rows; i += blockDim.x)
            part = fmax(part, fabs(own[i] - sent_j[i]));
          const T delta = dekrr::block_max(part, red);
          flag = delta > thr[r] ? 1 : 0;
        }
        if (flag)
          for (size_t i = threadIdx.x; i < rows; i += blockDim.x)
            sent_j[i] = own[i];
      } else {
        for (size_t i = threadIdx.x; i < rows; i += blockDim.x)
          own[i] = own_rd[i];
      }
      if (threadIdx.x == 0) {
        fl_wr[j] = flag;
        if (res != nullptr) {
          res[at] = resid;
          bc[at] = flag;
        }
      }
      __syncthreads();
    }
    grid.sync();
  }

  const T* fin = tab[R & 1];
  for (int j = blockIdx.x; j < J; j += gridDim.x) {
    const T* src = fin + static_cast<size_t>(j) * rows;
    for (size_t i = threadIdx.x; i < rows; i += blockDim.x)
      out_theta[j * rows + i] = src[i];
  }
}

template <typename T>
size_t smem_bytes(int K, int D, int Dy) {
  return dekrr::node_smem_elems(K, D, Dy) * sizeof(T);
}

template <typename T>
int launch(const void* g, const void* d, const void* s, const void* p,
           const void* theta0, const void* sent0, const void* buf0,
           const void* nbr_idx, const void* nbr_mask, const void* active,
           const void* thr, void* out_theta, void* sent, void* buf, void* res,
           void* bc, void* work, void* flags, int R, int J, int K, int D,
           int Dy, int T_rows, int censored, int edge, void* stream) {
  void* args[] = {&g,      &d,    &s,   &p,   &theta0, &sent0,   &buf0,
                  &nbr_idx, &nbr_mask, &active, &thr, &out_theta, &sent,
                  &buf,    &res,  &bc,  &work, &flags, &R,      &J,
                  &K,      &D,    &Dy,  &T_rows, &censored, &edge};
  return dekrr::coop_launch(dekrr_async_solve_kernel<T>, J,
                            smem_bytes<T>(K, D, Dy), args, stream);
}

}  // namespace

extern "C" {

// Co-resident block cap for a (K, D, Dy) problem; 0 when the device cannot
// launch the kernel cooperatively, negative on a CUDA error.
int dekrr_async_solve_max_blocks_f64(int K, int D, int Dy) {
  return dekrr::coop_max_blocks(dekrr_async_solve_kernel<double>,
                                smem_bytes<double>(K, D, Dy));
}

int dekrr_async_solve_max_blocks_f32(int K, int D, int Dy) {
  return dekrr::coop_max_blocks(dekrr_async_solve_kernel<float>,
                                smem_bytes<float>(K, D, Dy));
}

// res/bc [(R + 1), J] may both be null (no trace). `work` holds 2*T*Dy*D
// elements, `flags` 2*J ints.
int dekrr_async_solve_f64(const void* g, const void* d, const void* s,
                          const void* p, const void* theta0, const void* sent0,
                          const void* buf0, const void* nbr_idx,
                          const void* nbr_mask, const void* active,
                          const void* thr, void* out_theta, void* sent,
                          void* buf, void* res, void* bc, void* work,
                          void* flags, int R, int J, int K, int D, int Dy,
                          int T_rows, int censored, int edge, void* stream) {
  return launch<double>(g, d, s, p, theta0, sent0, buf0, nbr_idx, nbr_mask,
                        active, thr, out_theta, sent, buf, res, bc, work, flags,
                        R, J, K, D, Dy, T_rows, censored, edge, stream);
}

int dekrr_async_solve_f32(const void* g, const void* d, const void* s,
                          const void* p, const void* theta0, const void* sent0,
                          const void* buf0, const void* nbr_idx,
                          const void* nbr_mask, const void* active,
                          const void* thr, void* out_theta, void* sent,
                          void* buf, void* res, void* bc, void* work,
                          void* flags, int R, int J, int K, int D, int Dy,
                          int T_rows, int censored, int edge, void* stream) {
  return launch<float>(g, d, s, p, theta0, sent0, buf0, nbr_idx, nbr_mask,
                       active, thr, out_theta, sent, buf, res, bc, work, flags,
                       R, J, K, D, Dy, T_rows, censored, edge, stream);
}

}  // extern "C"
