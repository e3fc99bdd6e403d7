// R Jacobi rounds of Eq. 19 in one launch: the Hopper counterpart of
// src/repro/kernels/dekrr_solve.py::dekrr_solve_pallas (_dekrr_solve_kernel).
//
// The Pallas kernel relies on its (R, J) grid running in order, so round
// r + 1 sees all of round r. A CUDA grid has no order, so this kernel is one
// cooperative launch: the grid (capped at the co-resident block count) loops
// over nodes, and cooperative_groups' grid.sync() separates the rounds.
// Jacobi needs two θ tables: round r reads table r % 2 and writes table
// (r + 1) % 2, both seeded from θ0 so rows that no node owns stay at θ0.
// The tables live in a workspace the caller allocates.
//
// Bound on the card: at one round it is bytes, as for the round kernel; over
// R rounds each input is still read from device memory only once in the
// count, so the bound becomes the R·2(2 + K)D²J flops. The arithmetic runs on
// the FP64 vector units (DFMA), not the tensor cores, so the reachable peak
// is the vector f64 rate, half the DMMA rate. The blocks (22 MB at the
// paper's J = 10, D = 200, K = 4) fit in the 50 MB L2, so rounds after the
// first stream them from L2.
//
// Each node's update is dekrr_common.cuh::eq19_node, the same function and
// block shape as the round kernel, so this solve equals R round launches
// bit for bit.
#include <cooperative_groups.h>

#include "dekrr_common.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T>
__global__ void __launch_bounds__(dekrr::kThreads)
dekrr_solve_kernel(const T* __restrict__ g, const T* __restrict__ d,
                   const T* __restrict__ s, const T* __restrict__ p,
                   const T* __restrict__ theta0, const int* __restrict__ nbr_idx,
                   const int* __restrict__ self_idx,
                   const int* __restrict__ nbr_mask, T* __restrict__ out,
                   T* __restrict__ res, T* work, int R, int J, int K, int D,
                   int Dy, int T_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[dekrr::kWarps];
  T* smem = reinterpret_cast<T*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  const size_t rows = static_cast<size_t>(Dy) * D;
  const size_t n = static_cast<size_t>(T_rows) * rows;
  T* tab[2] = {work, work + n};

  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    tab[0][i] = theta0[i];
    tab[1][i] = theta0[i];
  }
  grid.sync();

  for (int r = 0; r < R; ++r) {
    const T* rd = tab[r & 1];
    T* wr = tab[(r + 1) & 1];
    for (int j = blockIdx.x; j < J; j += gridDim.x) {
      T local = dekrr::eq19_node<T>(j, g, d, s, p, rd, nbr_idx, self_idx,
                                    nbr_mask, wr + self_idx[j] * rows, smem,
                                    K, D, Dy);
      if (res != nullptr) {
        const T m = dekrr::block_max(local, red);
        if (threadIdx.x == 0) res[static_cast<size_t>(r) * J + j] = m;
      }
    }
    grid.sync();
  }

  const T* fin = tab[R & 1];
  for (int j = blockIdx.x; j < J; j += gridDim.x) {
    const T* src = fin + self_idx[j] * rows;
    for (size_t i = threadIdx.x; i < rows; i += blockDim.x)
      out[j * rows + i] = src[i];
  }
}

template <typename T>
size_t smem_bytes(int K, int D, int Dy) {
  return dekrr::node_smem_elems(K, D, Dy) * sizeof(T);
}

template <typename T>
int launch(const void* g, const void* d, const void* s, const void* p,
           const void* theta0, const void* nbr_idx, const void* self_idx,
           const void* nbr_mask, void* out, void* res, void* work, int R, int J,
           int K, int D, int Dy, int T_rows, void* stream) {
  void* args[] = {&g,   &d,    &s,   &p, &theta0, &nbr_idx, &self_idx,
                  &nbr_mask, &out, &res, &work, &R, &J, &K, &D, &Dy, &T_rows};
  return dekrr::coop_launch(dekrr_solve_kernel<T>, J, smem_bytes<T>(K, D, Dy),
                            args, stream);
}

}  // namespace

extern "C" {

// Co-resident block cap for a (K, D, Dy) problem; 0 when the device cannot
// launch the kernel cooperatively, negative on a CUDA error.
int dekrr_solve_max_blocks_f64(int K, int D, int Dy) {
  return dekrr::coop_max_blocks(dekrr_solve_kernel<double>,
                                smem_bytes<double>(K, D, Dy));
}

int dekrr_solve_max_blocks_f32(int K, int D, int Dy) {
  return dekrr::coop_max_blocks(dekrr_solve_kernel<float>,
                                smem_bytes<float>(K, D, Dy));
}

int dekrr_solve_f64(const void* g, const void* d, const void* s, const void* p,
                    const void* theta0, const void* nbr_idx,
                    const void* self_idx, const void* nbr_mask, void* out,
                    void* res, void* work, int R, int J, int K, int D, int Dy,
                    int T_rows, void* stream) {
  return launch<double>(g, d, s, p, theta0, nbr_idx, self_idx, nbr_mask, out,
                        res, work, R, J, K, D, Dy, T_rows, stream);
}

int dekrr_solve_f32(const void* g, const void* d, const void* s, const void* p,
                    const void* theta0, const void* nbr_idx,
                    const void* self_idx, const void* nbr_mask, void* out,
                    void* res, void* work, int R, int J, int K, int D, int Dy,
                    int T_rows, void* stream) {
  return launch<float>(g, d, s, p, theta0, nbr_idx, self_idx, nbr_mask, out,
                       res, work, R, J, K, D, Dy, T_rows, stream);
}

}  // extern "C"
