// Random-feature map of the serving tier, batched over nodes: the Hopper
// counterpart of src/repro/kernels/rff_features.py::rff_features_pallas
// (_rff_features_kernel), which the reference's serving tier calls once
// per node and wave through repro.kernels.ops.rff_features and
// ops.rff_features_lowp. Here one launch covers every cos_bias node of a
// wave:
//
//   Z[j] = scale[j] · cos(Ω[j] X + b[j])     Ω [J, D_max, d], b [J, D_max],
//                                            X [d, N] → Z [J, D_max, N]
//
// Rows r ≥ D_j of node j are written as exact zeros, whatever Ω[j] holds
// there, so padded θ rows never meet a NaN or an Inf. The single-node
// wrappers launch the same kernel with J = 1.
//
// f64: the product on the FP64 tensor cores (mma.sync m16n8k16 .f64),
// the accurate cos. f32: the same tiling with the products on the FP32
// units (FMA in k order, no TF32), the accurate cosf. bf16 (the
// ops.rff_features_lowp arrangement, whose forward-error bound the serving
// tier attaches to every answer): Ω, b and X in bf16, the product summed
// in f32 by FMA in k order and rounded to bf16, the bias sum rounded to
// bf16, the f32 cosf rounded to bf16; Z in bf16 at unit scale, which the
// wrapper casts to f32 and scales in f32. The bf16 product stays off the
// tensor cores on purpose: their f32 accumulation (mma.sync m16n8k16
// bf16 → f32) does not round each addition as an in-order f32 sum does,
// so a rare feature lands one bf16 rounding away from the plain version's,
// and one such feature moves a served answer past the serving check's
// tolerance (the f32 GEMV's rounding of the plain versions' answer). In k
// order on the FP32 units the features equal the plain version's bits.
//
// Bound on the card, at the serving wave (J = 10, D = 200, d = 148,
// N = 512): f64 moves ~11.2 MB (3.3 µs at 3.35 TB/s) and does 303 MFLOP
// of product (4.5 µs at the 67 TFLOP/s DMMA rate), so operations bound
// it; bf16 moves ~3.4 MB (~1.0 µs), above its 0.3 µs at the bf16
// tensor-core rate (the FP32 units it runs on would take 4.5 µs).
// Besides, the wave takes 1.02 M accurate cosines, in f64 a real
// share of the FP64 units' time that neither bound counts. The TPU kernel
// ran one node per call; what costs time here is latency (a launch, the
// first loads, a chain of chunks) and, at the wave, the issue rate of the
// product. The design answers with:
//
// * One launch per wave. Grid (column tiles, row tiles, J); each output
//   entry is written by exactly one block, with no atomics.
// * Warps spread over the card. A warp owns 16 rows × 8·NT columns (NT
//   m16n8 tiles); a block WR × WC warps. The wrapper's plan
//   (kernels/rff_features.py::features_plan) picks the largest block whose
//   grid still puts four warps on every SM: one node (D 200, N 512) takes
//   4 × 2 warps of 16 × 8 (128 blocks of 64 × 16), the wave 2 × 2 warps of
//   16 × 32 (560 blocks of 32 × 64). Narrow warps cut a node's time about
//   in half against 16 × 32 ones: the product and the cosines of a warp
//   run one after another, so more, smaller warps finish sooner. The
//   launcher refuses a plan whose shared memory does not cover the layout
//   below.
// * A fixed sum order. Every entry sums d in k16 steps 0, 1, 2, … through
//   one m16n8k16 (f64) or 16 FMAs in k order (f32, bf16) each, whatever
//   the tile and the node count, so every plan, and a batched launch
//   against a per-node one, gives the same bits.
// * Staging through shared memory in 32-deep chunks by cp.async, in a
//   2-slot ring: the next chunk in flight while this one is multiplied,
//   one barrier a chunk. Copies are 16 bytes where rows allow it and
//   narrower otherwise (d = 148 gives 296-byte bf16 rows, 8-byte aligned); each
//   thread's copies are fixed at the start (a first row and a constant
//   step), with no integer division per element.
// * Shared row strides of 32 + 4 (f64, f32) or 32 + 8 (bf16) elements, so
//   the operand loads hit distinct banks; D_j, the scale and the bias are
//   loaded before the product, so their latency hides behind it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpRows = 16;
constexpr int kDepth = 32;  // d per staged chunk: two k16 steps
constexpr int kStages = 2;  // chunks in the ring

template <typename T>
struct Traits {
  using Acc = T;
  static constexpr int kPad = 4;
};

template <>
struct Traits<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kPad = 8;
};

// Shared memory of a block: kStages × (Ω slice [16·WR][kDepth + pad] +
// X slice [kDepth][8·NT·WC + pad]). kernels/rff_features.py::_smem_bytes is
// the same formula.
template <typename T>
__host__ __device__ inline size_t features_smem_bytes(int wr, int wc,
                                                      int nt) {
  const int pad = Traits<T>::kPad;
  return static_cast<size_t>(kStages) *
         (kWarpRows * wr * (kDepth + pad) + kDepth * (8 * nt * wc + pad)) *
         sizeof(T);
}

// ------------------------------------------------------------ warp product
// acc[nt] += A·B_nt over one k16 step, nt < NT. A: the warp's 16 rows of
// the Ω slice (row stride sa); b: the X slice at this warp's first column
// (row stride sb). acc[nt][e] is the entry at row g + 8·(e / 2), column
// 8·nt + 2t + (e % 2), g = lane / 4, t = lane % 4 (the mma C layout).
template <int NT>
__device__ __forceinline__ void warp_step(double (&acc)[NT][4],
                                          const double* a, int sa,
                                          const double* b, int sb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  double av[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) av[i] = a[(g + 8 * (i % 2)) * sa + t + 4 * (i / 2)];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    double bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) bv[i] = b[(t + 4 * i) * sb + nt * 8 + g];
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
        : "+d"(acc[nt][0]), "+d"(acc[nt][1]), "+d"(acc[nt][2]),
          "+d"(acc[nt][3])
        : "d"(av[0]), "d"(av[1]), "d"(av[2]), "d"(av[3]), "d"(av[4]),
          "d"(av[5]), "d"(av[6]), "d"(av[7]), "d"(bv[0]), "d"(bv[1]),
          "d"(bv[2]), "d"(bv[3]));
  }
}

// f32 on the FP32 units: the same entries, k in order.
template <int NT>
__device__ __forceinline__ void warp_step(float (&acc)[NT][4],
                                          const float* a, int sa,
                                          const float* b, int sb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float lo = a[g * sa + k], hi = a[(g + 8) * sa + k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 bv =
          *reinterpret_cast<const float2*>(b + k * sb + nt * 8 + 2 * t);
      acc[nt][0] = fmaf(lo, bv.x, acc[nt][0]);
      acc[nt][1] = fmaf(lo, bv.y, acc[nt][1]);
      acc[nt][2] = fmaf(hi, bv.x, acc[nt][2]);
      acc[nt][3] = fmaf(hi, bv.y, acc[nt][3]);
    }
  }
}

// bf16 on the FP32 units, the f32 path's entries and order. Two bf16
// values of a row come in one 32-bit load (the lower address in the low
// half); each widens to f32 exactly by a shift.
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

template <int NT>
__device__ __forceinline__ void warp_step(float (&acc)[NT][4],
                                          const __nv_bfloat16* a, int sa,
                                          const __nv_bfloat16* b, int sb,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
  auto pair = [](const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  };
#pragma unroll
  for (int k = 0; k < 16; k += 2) {
    const uint32_t lo2 = pair(a + g * sa + k);
    const uint32_t hi2 = pair(a + (g + 8) * sa + k);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lo = h ? bf16_hi(lo2) : bf16_lo(lo2);
      const float hi = h ? bf16_hi(hi2) : bf16_lo(hi2);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t bp = pair(b + (k + h) * sb + nt * 8 + 2 * t);
        const float b0 = bf16_lo(bp), b1 = bf16_hi(bp);
        acc[nt][0] = fmaf(lo, b0, acc[nt][0]);
        acc[nt][1] = fmaf(lo, b1, acc[nt][1]);
        acc[nt][2] = fmaf(hi, b0, acc[nt][2]);
        acc[nt][3] = fmaf(hi, b1, acc[nt][3]);
      }
    }
  }
}

// ----------------------------------------------------------------- epilogue
__device__ __forceinline__ double epilogue(double acc, double b,
                                           double scale) {
  return cos(acc + b) * scale;
}

__device__ __forceinline__ float epilogue(float acc, float b, float scale) {
  return cosf(acc + b) * scale;
}

// The three bf16 roundings of rff_features_lowp; unit scale.
__device__ __forceinline__ __nv_bfloat16 epilogue(float acc, __nv_bfloat16 b,
                                                  __nv_bfloat16) {
  const float proj = __bfloat162float(__float2bfloat16_rn(acc));
  const float arg =
      __bfloat162float(__float2bfloat16_rn(proj + __bfloat162float(b)));
  return __float2bfloat16_rn(cosf(arg));
}

// -------------------------------------------------------------------- copies
// Copy `bytes` (4, 8 or 16) from src to shared dst, or zero-fill them when
// !valid; 16-byte copies go through L2 only. 2-byte elements (bf16 rows of
// odd length) cannot take cp.async and are stored directly; the barrier
// that publishes the chunk publishes them too.
template <typename T>
__device__ __forceinline__ void copy_elems(T* dst, const T* src, int bytes,
                                           bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
                 "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(addr),
                 "l"(src), "r"(n));
  else if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
                 "l"(src), "r"(n));
  else
    *dst = valid ? *src : T(0.0f);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------------- kernel
// Grid (⌈N / 8·NT·WC⌉, ⌈D_max / 16·WR⌉, J), 32·WR·WC threads; a warp owns
// 16 rows × 8·NT columns. va and vx: elements per copy of an Ω row and an
// X row (each divides its row length and its alignment).
template <typename T, int WR, int WC, int NT>
__global__ void __launch_bounds__(32 * WR * WC)
rff_features_kernel(const T* __restrict__ omega, const T* __restrict__ bias,
                    const T* __restrict__ x, const T* __restrict__ scale,
                    const int* __restrict__ d_feat, T* __restrict__ z,
                    int d_max, int dim, int n, int va, int vx) {
  using A = typename Traits<T>::Acc;
  constexpr int kThreads = 32 * WR * WC;
  constexpr int kBM = kWarpRows * WR, kBN = 8 * NT * WC;
  constexpr int kSA = kDepth + Traits<T>::kPad;  // Ω slice row stride
  constexpr int kSX = kBN + Traits<T>::kPad;     // X slice row stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);        // [kStages][kBM][kSA]
  T* xs = as + kStages * kBM * kSA;              // [kStages][kDepth][kSX]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / WC, wc = warp % WC, g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * kBN, row0 = blockIdx.y * kBM;
  const int j = blockIdx.z;
  const T* om = omega + static_cast<size_t>(j) * d_max * dim;
  // What the epilogue needs, loaded first so the loads' latency hides
  // behind the product: D_j, the scale, the bias of this thread's rows.
  const int d_j = d_feat[j];
  const T s = scale != nullptr ? scale[j] : T(1.0f);
  T bv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + wr * kWarpRows + g + 8 * h;
    bv[h] = row < d_max ? bias[static_cast<size_t>(j) * d_max + row]
                        : T(0.0f);
  }

  // This thread's copies of a chunk: Ω rows a_row, a_row + a_step, … at
  // elements a_k … a_k + va − 1; X rows x_row, x_row + x_step, … at
  // columns x_col … x_col + vx − 1 (the rows per step divide the block).
  const int a_per_row = kDepth / va, x_per_row = kBN / vx;
  const int a_row = tid / a_per_row, a_k = tid % a_per_row * va;
  const int a_step = kThreads / a_per_row;
  const int x_row = tid / x_per_row, x_col = tid % x_per_row * vx;
  const int x_step = kThreads / x_per_row;
  const int a_bytes = va * static_cast<int>(sizeof(T));
  const int x_bytes = vx * static_cast<int>(sizeof(T));

  auto issue = [&](int chunk, int slot) {
    const int k0 = chunk * kDepth;
    T* ad = as + slot * kBM * kSA;
    for (int r = a_row; r < kBM; r += a_step) {
      const int row = row0 + r, k = k0 + a_k;
      const bool ok = row < d_max && k < dim;
      copy_elems(ad + r * kSA + a_k,
                 ok ? om + static_cast<size_t>(row) * dim + k : om, a_bytes,
                 ok);
    }
    T* xd = xs + slot * kDepth * kSX;
    for (int r = x_row; r < kDepth; r += x_step) {
      const int k = k0 + r, col = col0 + x_col;
      const bool ok = k < dim && col < n;
      copy_elems(xd + r * kSX + x_col,
                 ok ? x + static_cast<size_t>(k) * n + col : x, x_bytes, ok);
    }
  };

  A acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = A(0);

  const int chunks = (dim + kDepth - 1) / kDepth;
  auto multiply = [&](int slot) {
    const T* a = as + slot * kBM * kSA + wr * kWarpRows * kSA;
    const T* b = xs + slot * kDepth * kSX + wc * 8 * NT;
#pragma unroll
    for (int ks = 0; ks < kDepth / 16; ++ks)
      warp_step<NT>(acc, a + ks * 16, kSA, b + ks * 16 * kSX, kSX, lane);
  };
  issue(0, 0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c visible; every warp is done with c − 1
    if (c + 1 < chunks) issue(c + 1, (c + 1) % kStages);
    cp_async_commit();
    multiply(c % kStages);
  }

  T* zj = z + static_cast<size_t>(j) * d_max * n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + wr * kWarpRows + g + 8 * h;
    if (row >= d_max) continue;
    const bool live = row < d_j;
    T* zr = zj + static_cast<size_t>(row) * n;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + wc * 8 * NT + nt * 8 + 2 * t + e;
        if (col < n)
          zr[col] = live ? epilogue(acc[nt][2 * h + e], bv[h], s) : T(0.0f);
      }
  }
}

// Elements per copy: the widest of 16, 8, 4 bytes (2 for bf16) that
// divides the row length and the base address.
template <typename T>
int vector_width(const void* base, int row_elems) {
  const size_t row = static_cast<size_t>(row_elems) * sizeof(T);
  for (int bytes = 16; bytes >= 4; bytes /= 2)
    if (row % bytes == 0 && reinterpret_cast<uintptr_t>(base) % bytes == 0)
      return bytes / static_cast<int>(sizeof(T));
  return sizeof(T) < 4 ? 1 : -1;
}

template <typename T, int WR, int WC, int NT>
int launch_tile(const T* omega, const T* bias, const T* x, const T* scale,
                const int* d_feat, T* z, int J, int d_max, int dim, int n,
                int smem_bytes, int va, int vx, cudaStream_t stream) {
  auto kernel = rff_features_kernel<T, WR, WC, NT>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + 8 * NT * WC - 1) / (8 * NT * WC),
                  (d_max + kWarpRows * WR - 1) / (kWarpRows * WR), J);
  kernel<<<grid, 32 * WR * WC, smem_bytes, stream>>>(
      omega, bias, x, scale, d_feat, z, d_max, dim, n, va, vx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* omega, const void* bias, const void* x,
           const void* scale, const void* d_feat, void* z, int J, int d_max,
           int dim, int n, int wr, int wc, int nt, int smem_bytes,
           void* stream) {
  const int va = vector_width<T>(omega, dim);
  const int vx = vector_width<T>(x, n);
  if (J < 1 || d_max < 1 || dim < 1 || n < 1 || va < 1 || vx < 1 ||
      smem_bytes < 0 ||
      static_cast<size_t>(smem_bytes) < features_smem_bytes<T>(wr, wc, nt))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* o = static_cast<const T*>(omega);
  const T* b = static_cast<const T*>(bias);
  const T* xx = static_cast<const T*>(x);
  const T* s = static_cast<const T*>(scale);
  const int* df = static_cast<const int*>(d_feat);
  T* zz = static_cast<T*>(z);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RFF_TILE(R, C, W)                                                    \
  if (wr == R && wc == C && nt == W)                                         \
    return launch_tile<T, R, C, W>(o, b, xx, s, df, zz, J, d_max, dim, n,   \
                                   smem_bytes, va, vx, st);
  RFF_TILE(2, 2, 4)
  RFF_TILE(2, 2, 2)
  RFF_TILE(4, 2, 1)
#undef RFF_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// omega [J, d_max, dim], bias [J, d_max], x [dim, n], scale [J] (null in
// bf16: unit scale), d_feat [J] int32 (each ≤ d_max), z [J, d_max, n];
// (wr, wc, nt): warps of the block along rows and columns and m16n8 tiles
// a warp, one of (2, 2, 4), (2, 2, 2), (4, 2, 1); smem_bytes: dynamic
// shared memory of a block, at least features_smem_bytes(wr, wc, nt).
int rff_features_f64(const void* omega, const void* bias, const void* x,
                     const void* scale, const void* d_feat, void* z, int J,
                     int d_max, int dim, int n, int wr, int wc, int nt,
                     int smem_bytes, void* stream) {
  return launch<double>(omega, bias, x, scale, d_feat, z, J, d_max, dim, n,
                        wr, wc, nt, smem_bytes, stream);
}

int rff_features_f32(const void* omega, const void* bias, const void* x,
                     const void* scale, const void* d_feat, void* z, int J,
                     int d_max, int dim, int n, int wr, int wc, int nt,
                     int smem_bytes, void* stream) {
  return launch<float>(omega, bias, x, scale, d_feat, z, J, d_max, dim, n,
                       wr, wc, nt, smem_bytes, stream);
}

int rff_features_bf16(const void* omega, const void* bias, const void* x,
                      const void* scale, const void* d_feat, void* z, int J,
                      int d_max, int dim, int n, int wr, int wc, int nt,
                      int smem_bytes, void* stream) {
  return launch<__nv_bfloat16>(omega, bias, x, scale, d_feat, z, J, d_max,
                               dim, n, wr, wc, nt, smem_bytes, stream);
}

// Dynamic shared memory of a block of tile (wr, wc, nt) for elements of
// `elem` bytes (8 f64, 4 f32, 2 bf16), the least the launcher accepts
// (repro_torch.analysis.smem checks the same formula before any launch).
int rff_features_smem_bytes(int wr, int wc, int nt, int elem) {
  if (elem == 8) return static_cast<int>(features_smem_bytes<double>(wr, wc, nt));
  if (elem == 4) return static_cast<int>(features_smem_bytes<float>(wr, wc, nt));
  return static_cast<int>(features_smem_bytes<__nv_bfloat16>(wr, wc, nt));
}

}  // extern "C"
