// Fused random-feature Gram blocks of Eq. 17, batched over problems: the
// Hopper counterpart of src/repro/kernels/rff_gram.py::rff_gram_pallas
// (_rff_gram_kernel), vmapped by repro.kernels.ops.rff_gram_batched.
//
// For each problem b:  Z = scale · cos(Ω X + b) · colmask   (Z is never stored)
//                      G = Z Zᵀ [F, F],  zy = Z y [F]
//
// The Pallas kernel carries the [F, F] sum in VMEM from one grid step to the
// next. Here every block owns one 64×64 tile of one G and loops over all N
// in tiles of kTN columns: it computes cos(ΩX+b) for its own 64 row- and 64
// column-frequencies into shared memory, masks padded columns and
// accumulates its tile in registers (4×4 per thread). No block shares an
// output, so there are no atomics and no second pass, and the result is the
// same from run to run. zy comes from the blocks of the first column tile.
//
// Bound on the card: operations. Forming Z costs 2·F·d·N flops and the Gram
// 2·F²·N; X is read once. This simple kernel recomputes each cosine once
// per tile in the other dimension (ceil(F/64) times) and runs on the FP64
// vector units, not the tensor cores.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kTN = 16;
constexpr int kThreads = 256;  // 16 × 16 threads, 4 × 4 outputs each

__host__ __device__ inline size_t gram_smem_elems(int dim) {
  return static_cast<size_t>(dim) * kTN + 2 * kTile * kTN + kTN;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rff_gram_kernel(const T* __restrict__ omega, const T* __restrict__ bias,
                const T* __restrict__ x, const T* __restrict__ y,
                const T* __restrict__ mask, T* __restrict__ gram,
                T* __restrict__ zy, int F, int dim, int N, T scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);   // [dim, kTN]
  T* zr = xs + static_cast<size_t>(dim) * kTN;  // [kTN, kTile] row features
  T* zc = zr + kTile * kTN;                  // [kTN, kTile] column features
  T* ys = zc + kTile * kTN;                  // [kTN]

  const int ct = blockIdx.x, rt = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* om = omega + static_cast<size_t>(b) * F * dim;
  const T* bi = bias + static_cast<size_t>(b) * F;
  const T* xb = x + static_cast<size_t>(b) * dim * N;
  const T* yb = y + static_cast<size_t>(b) * N;
  const T* mb = mask + static_cast<size_t>(b) * N;
  const bool want_zy = (ct == 0);

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = T(0);
  T zy_acc = T(0);

  for (int n0 = 0; n0 < N; n0 += kTN) {
    for (int i = tid; i < dim * kTN; i += kThreads) {
      const int k = i / kTN, n = i % kTN;
      xs[i] = (n0 + n < N) ? xb[static_cast<size_t>(k) * N + n0 + n] : T(0);
    }
    if (tid < kTN) ys[tid] = (n0 + tid < N) ? yb[n0 + tid] : T(0);
    __syncthreads();

    for (int e = tid; e < 2 * kTile * kTN; e += kThreads) {
      const int n = e % kTN;
      const int rr = e / kTN;                  // 0..2*kTile-1
      const bool col = rr >= kTile;
      const int fl = rr % kTile;
      const int f = (col ? ct : rt) * kTile + fl;
      T z = T(0);
      if (f < F && n0 + n < N) {
        const T* w = om + static_cast<size_t>(f) * dim;
        T proj = T(0);
        for (int k = 0; k < dim; ++k) proj += w[k] * xs[k * kTN + n];
        z = scale * cos(proj + bi[f]) * mb[n0 + n];
      }
      (col ? zc : zr)[n * kTile + fl] = z;
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < kTN; ++n) {
      T a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = zr[n * kTile + ty * 4 + i];
        c[i] = zc[n * kTile + tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] += a[i] * c[k];
    }
    if (want_zy && tid < kTile)
      for (int n = 0; n < kTN; ++n) zy_acc += zr[n * kTile + tid] * ys[n];
    __syncthreads();
  }

  T* gb = gram + static_cast<size_t>(b) * F * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = rt * kTile + ty * 4 + i;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int colx = ct * kTile + tx * 4 + k;
      if (row < F && colx < F) gb[static_cast<size_t>(row) * F + colx] = acc[i][k];
    }
  }
  if (want_zy && tid < kTile && rt * kTile + tid < F)
    zy[static_cast<size_t>(b) * F + rt * kTile + tid] = zy_acc;
}

template <typename T>
int launch(const void* omega, const void* bias, const void* x, const void* y,
           const void* mask, void* gram, void* zy, int B, int F, int dim, int N,
           double scale, void* stream) {
  const size_t smem = gram_smem_elems(dim) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rff_gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (F + kTile - 1) / kTile;
  dim3 grid(tiles, tiles, B);
  rff_gram_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(omega), static_cast<const T*>(bias),
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(mask), static_cast<T*>(gram), static_cast<T*>(zy),
      F, dim, N, static_cast<T>(scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rff_gram_f64(const void* omega, const void* bias, const void* x,
                 const void* y, const void* mask, void* gram, void* zy, int B,
                 int F, int dim, int N, double scale, void* stream) {
  return launch<double>(omega, bias, x, y, mask, gram, zy, B, F, dim, N, scale,
                        stream);
}

int rff_gram_f32(const void* omega, const void* bias, const void* x,
                 const void* y, const void* mask, void* gram, void* zy, int B,
                 int F, int dim, int N, double scale, void* stream) {
  return launch<float>(omega, bias, x, y, mask, gram, zy, B, F, dim, N, scale,
                       stream);
}

}  // extern "C"
