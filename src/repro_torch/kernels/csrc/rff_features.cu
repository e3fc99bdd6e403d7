// Random-feature map of the serving tier: the Hopper counterpart of
// src/repro/kernels/rff_features.py::rff_features_pallas
// (_rff_features_kernel), called per node and wave by the serving tier
// through repro.kernels.ops.rff_features and ops.rff_features_lowp.
//
//   Z = scale · cos(Ω X + b)        Ω [D, d], b [D], X [d, N] → Z [D, N]
//
// f64 / f32: the product is accumulated in the working type and the
// epilogue uses the accurate cos / cosf (the arguments reach |ΩX| ≈ 53 on
// the paper's problems, beyond what __cosf is good for).
//
// bf16 (the ops.rff_features_lowp arrangement, whose forward-error bound
// the serving tier attaches to every answer): Ω, b and X arrive in bf16,
// the product is accumulated in f32 and rounded to bf16, the bias is added
// and the sum rounded to bf16, the cosine is taken in f32 and rounded to
// bf16. Z is written in bf16 at unit scale; the wrapper casts it to f32 and
// applies the f32 scale, as the reference does.
//
// The Pallas kernel takes one (block_d × block_n) tile per grid step with
// the whole input dim in VMEM, on operands padded to (8, 128). Here every
// block owns one 64×64 output tile and walks the input dim in chunks of
// kK, staging a [64, kK] slice of Ω and a [kK, 64] slice of X in shared
// memory (16 KB in f64 whatever d is), so no input dim needs a budget
// check. Ragged edges are masked by the loads and the stores; nothing is
// padded. Each of 256 threads accumulates a 4×4 sub-tile in registers, at
// rows ty + 16·i and columns tx + 16·j so that a warp's stores of one row
// are contiguous. No block shares an output, so there are no atomics.
//
// Bound on the card: at the serving shape (D = 200, d = 148, N = 512) the
// launch moves ~1.7 MB in f64 and does ~30 MFLOP, about 0.5 µs either
// way, far below the launch latency, which is what this kernel's time is
// made of. The product runs on the FP64/FP32 vector units, not the tensor
// cores, in every type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kK = 16;
constexpr int kThreads = 256;  // 16 × 16 threads, 4 × 4 outputs each

template <typename T>
struct Acc {
  using type = T;
  __device__ static T load(T v) { return v; }
};

template <>
struct Acc<__nv_bfloat16> {
  using type = float;
  __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
};

__device__ inline double epilogue(double acc, double b, double scale) {
  return cos(acc + b) * scale;
}

__device__ inline float epilogue(float acc, float b, float scale) {
  return cosf(acc + b) * scale;
}

// The three bf16 roundings of rff_features_lowp; `scale` is 1.
__device__ inline __nv_bfloat16 epilogue(float acc, __nv_bfloat16 b, float) {
  const float proj = __bfloat162float(__float2bfloat16_rn(acc));
  const float arg =
      __bfloat162float(__float2bfloat16_rn(proj + __bfloat162float(b)));
  return __float2bfloat16_rn(cosf(arg));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rff_features_kernel(const T* __restrict__ omega, const T* __restrict__ bias,
                    const T* __restrict__ x, T* __restrict__ z, int D, int dim,
                    int N, typename Acc<T>::type scale) {
  using A = typename Acc<T>::type;
  __shared__ A ws[kK][kTile];  // Ω slice, transposed: ws[k][row]
  __shared__ A xs[kK][kTile];  // X slice: xs[k][col]

  const int col0 = blockIdx.x * kTile, row0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  A acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = A(0);

  for (int k0 = 0; k0 < dim; k0 += kK) {
    // Ω: kTile rows × kK inputs; consecutive threads take consecutive k of
    // one row (a row of Ω is contiguous).
    for (int e = tid; e < kTile * kK; e += kThreads) {
      const int r = e / kK, k = e % kK;
      const int row = row0 + r, kk = k0 + k;
      ws[k][r] = (row < D && kk < dim)
                     ? Acc<T>::load(omega[static_cast<size_t>(row) * dim + kk])
                     : A(0);
    }
    // X: kK inputs × kTile columns; consecutive threads take consecutive
    // columns of one input row.
    for (int e = tid; e < kK * kTile; e += kThreads) {
      const int k = e / kTile, c = e % kTile;
      const int kk = k0 + k, col = col0 + c;
      xs[k][c] = (kk < dim && col < N)
                     ? Acc<T>::load(x[static_cast<size_t>(kk) * N + col])
                     : A(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      A a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ws[k][ty + 16 * i];
        c[i] = xs[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * c[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= D) continue;
    const T b = bias[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < N)
        z[static_cast<size_t>(row) * N + col] = epilogue(acc[i][j], b, scale);
    }
  }
}

template <typename T>
int launch(const void* omega, const void* bias, const void* x, void* z, int D,
           int dim, int N, double scale, void* stream) {
  using A = typename Acc<T>::type;
  dim3 grid((N + kTile - 1) / kTile, (D + kTile - 1) / kTile);
  rff_features_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(omega), static_cast<const T*>(bias),
      static_cast<const T*>(x), static_cast<T*>(z), D, dim, N,
      static_cast<A>(scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rff_features_f64(const void* omega, const void* bias, const void* x,
                     void* z, int D, int dim, int N, double scale,
                     void* stream) {
  return launch<double>(omega, bias, x, z, D, dim, N, scale, stream);
}

int rff_features_f32(const void* omega, const void* bias, const void* x,
                     void* z, int D, int dim, int N, double scale,
                     void* stream) {
  return launch<float>(omega, bias, x, z, D, dim, N, scale, stream);
}

// Unit scale: the wrapper applies the f32 scale after the cast to f32.
int rff_features_bf16(const void* omega, const void* bias, const void* x,
                      void* z, int D, int dim, int N, void* stream) {
  return launch<__nv_bfloat16>(omega, bias, x, z, D, dim, N, 1.0, stream);
}

}  // extern "C"
