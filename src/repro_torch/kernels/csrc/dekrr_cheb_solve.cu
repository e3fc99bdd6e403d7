// R Chebyshev-accelerated rounds of Eq. 19 in one launch: the Hopper
// counterpart of src/repro/kernels/dekrr_solve.py::dekrr_cheb_solve_pallas
// (_dekrr_cheb_solve_kernel).
//
// The layout of dekrr_solve.cu (two round-parity θ tables in `work`, both
// seeded from θ0, read through self_idx / nbr_idx) plus
//   pdir [J*Dy, D]      each node's search direction p, node j at row block
//                       j (owner-only, no parity; written in place in the
//                       output array, seeded from delta0);
//   alpha, beta [R]     the precomputed schedule on the device.
// Per round r and node j, after new = dekrr::eq19_node (F applied once):
//   p_j <- (new - θ_self) + β_r p_j,   θ_j <- θ_self + α_r p_j
// written to the write-parity table; with a trace, res[r, j] =
// max|θ_new - θ_self| (the step taken, not the F-residual). Both θ and p
// rows are outputs, so chunked launches chain bit for bit.
//
// One grid.sync() per round: cross-node reads touch only the read-parity
// table, and each node writes its own rows of the other table and of pdir.
//
// Bound on the card: as for dekrr_solve.cu, the R rounds' flops; the
// kernel is latency-bound in the same way (one block per node).
#include <cooperative_groups.h>

#include "dekrr_common.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T>
__global__ void __launch_bounds__(dekrr::kThreads)
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
                        int T_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[dekrr::kWarps];
  T* smem = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const size_t rows = static_cast<size_t>(Dy) * D;
  const size_t n = static_cast<size_t>(T_rows) * rows;
  T* tab[2] = {work, work + n};

  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (size_t i = tid; i < n; i += stride) {
    tab[0][i] = theta0[i];
    tab[1][i] = theta0[i];
  }
  for (size_t i = tid; i < static_cast<size_t>(J) * rows; i += stride)
    pdir[i] = delta0[i];
  grid.sync();

  for (int r = 0; r < R; ++r) {
    const T* rd = tab[r & 1];
    T* wr = tab[(r + 1) & 1];
    const T a = alpha[r];
    const T b = beta[r];
    for (int j = blockIdx.x; j < J; j += gridDim.x) {
      T* own = wr + static_cast<size_t>(self_idx[j]) * rows;
      dekrr::eq19_node<T>(j, g, d, s, p, rd, nbr_idx, self_idx, nbr_mask, own,
                          smem, K, D, Dy);
      const T* th = smem;  // the staged θ_self rows
      T* pj = pdir + static_cast<size_t>(j) * rows;
      T local = T(0);
      for (size_t i = threadIdx.x; i < rows; i += blockDim.x) {
        const T pn = (own[i] - th[i]) + b * pj[i];
        const T tn = th[i] + a * pn;
        own[i] = tn;
        pj[i] = pn;
        local = fmax(local, fabs(tn - th[i]));
      }
      if (res != nullptr) {
        const T m = dekrr::block_max(local, red);
        if (threadIdx.x == 0) res[static_cast<size_t>(r) * J + j] = m;
      }
      __syncthreads();
    }
    grid.sync();
  }

  const T* fin = tab[R & 1];
  for (int j = blockIdx.x; j < J; j += gridDim.x) {
    const T* src = fin + static_cast<size_t>(self_idx[j]) * rows;
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
           const void* theta0, const void* delta0, const void* nbr_idx,
           const void* self_idx, const void* nbr_mask, const void* alpha,
           const void* beta, void* out_theta, void* pdir, void* res,
           void* work, int R, int J, int K, int D, int Dy, int T_rows,
           void* stream) {
  void* args[] = {&g,        &d,        &s,     &p,        &theta0,
                  &delta0,   &nbr_idx,  &self_idx, &nbr_mask, &alpha,
                  &beta,     &out_theta, &pdir, &res,      &work,
                  &R,        &J,        &K,     &D,        &Dy,
                  &T_rows};
  return dekrr::coop_launch(dekrr_cheb_solve_kernel<T>, J,
                            smem_bytes<T>(K, D, Dy), args, stream);
}

}  // namespace

extern "C" {

// Co-resident block cap for a (K, D, Dy) problem; 0 when the device cannot
// launch the kernel cooperatively, negative on a CUDA error.
int dekrr_cheb_solve_max_blocks_f64(int K, int D, int Dy) {
  return dekrr::coop_max_blocks(dekrr_cheb_solve_kernel<double>,
                                smem_bytes<double>(K, D, Dy));
}

int dekrr_cheb_solve_max_blocks_f32(int K, int D, int Dy) {
  return dekrr::coop_max_blocks(dekrr_cheb_solve_kernel<float>,
                                smem_bytes<float>(K, D, Dy));
}

// res [R, J] may be null (no trace). `work` holds 2*T*Dy*D elements.
int dekrr_cheb_solve_f64(const void* g, const void* d, const void* s,
                         const void* p, const void* theta0, const void* delta0,
                         const void* nbr_idx, const void* self_idx,
                         const void* nbr_mask, const void* alpha,
                         const void* beta, void* out_theta, void* pdir,
                         void* res, void* work, int R, int J, int K, int D,
                         int Dy, int T_rows, void* stream) {
  return launch<double>(g, d, s, p, theta0, delta0, nbr_idx, self_idx,
                        nbr_mask, alpha, beta, out_theta, pdir, res, work, R, J,
                        K, D, Dy, T_rows, stream);
}

int dekrr_cheb_solve_f32(const void* g, const void* d, const void* s,
                         const void* p, const void* theta0, const void* delta0,
                         const void* nbr_idx, const void* self_idx,
                         const void* nbr_mask, const void* alpha,
                         const void* beta, void* out_theta, void* pdir,
                         void* res, void* work, int R, int J, int K, int D,
                         int Dy, int T_rows, void* stream) {
  return launch<float>(g, d, s, p, theta0, delta0, nbr_idx, self_idx, nbr_mask,
                       alpha, beta, out_theta, pdir, res, work, R, J, K, D, Dy,
                       T_rows, stream);
}

}  // extern "C"
