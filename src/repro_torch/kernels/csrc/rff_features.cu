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
// wrappers launch the same kernels with J = 1.
//
// f64: the product on the FP64 tensor cores (mma.sync m16n8k16 .f64),
// the accurate cos. f32: the same tiling with the products on the FP32
// units (FMA in k order, no TF32), the accurate cosf. bf16 (the
// ops.rff_features_lowp arrangement, whose forward-error bound the serving
// tier attaches to every answer), a kernel of its own below: Ω, b and X in
// bf16, the product summed in f32 by FMA in k order and rounded to bf16,
// the bias sum rounded to bf16, the f32 cosf rounded to bf16; Z in bf16 at
// unit scale, which the wrapper casts to f32 and scales in f32. The bf16
// product stays off the tensor cores on purpose: their f32 accumulation
// (mma.sync m16n8k16 bf16 → f32) does not round each addition as an
// in-order f32 sum does, so a rare feature lands one bf16 rounding away
// from the plain version's, and one such feature moves a served answer
// past the serving check's tolerance (the f32 GEMV's rounding of the plain
// versions' answer). In k order on the FP32 units the features equal the
// plain version's bits.
//
// Bound on the card, at the serving wave (J = 10, D = 200, d = 148,
// N = 512): f64 moves ~11.2 MB (3.3 µs at 3.35 TB/s) and does 303 MFLOP
// of product (4.5 µs at the 67 TFLOP/s DMMA rate), so operations bound
// it; bf16 moves ~2.8 MB (0.83 µs), above its 0.3 µs at the bf16
// tensor-core rate, but the FP32 units it must run on take 4.5 µs for
// its 151.6 M FMA. Besides, the wave takes 1.02 M accurate cosines, in
// f64 a real share of the FP64 units' time that neither bound counts.
// The TPU kernel ran one node per call; what costs time here is latency
// (a launch, the first loads, a chain of chunks) and, at the wave, the
// issue rate of the product.
//
// The f64/f32 design:
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
//   one m16n8k16 (f64) or 16 FMAs in k order (f32) each, whatever the tile
//   and the node count, so every plan, and a batched launch against a
//   per-node one, gives the same bits.
// * Staging through shared memory in 32-deep chunks by cp.async, in a
//   2-slot ring: the next chunk in flight while this one is multiplied,
//   one barrier a chunk. Copies are 16 bytes where rows allow it and
//   narrower otherwise; each thread's copies are fixed at the start (a
//   first row and a constant step), with no integer division per element.
// * Shared row strides of 32 + 4 elements, so the operand loads hit
//   distinct banks; D_j, the scale and the bias are loaded before the
//   product, so their latency hides behind it.
//
// The bf16 design (rff_features_bf16_kernel), for the FP32 units' issue
// rate, with the same bits as the plain version:
//
// * One product over the stacked rows. Ω [J, D_max, d] is [J·D_max, d],
//   b [J·D_max] and Z [J·D_max, N]; row r belongs to node r / D_max, and a
//   row tile may straddle nodes. Grid (column tiles, row tiles): the wave's
//   2,000 rows tile into 64-row tiles with 2.4% waste. Rows past D_j are
//   staged as zeros and written as exact zeros.
// * Operands widened to f32 once, in shared memory. Each block stages its
//   Ω rows ([rows][k], row stride kBfDepth + 4 floats: the four rows a warp
//   reads at one k fall on distinct banks) and its X columns ([k][cols]) as
//   f32, 8-byte loads of four bf16 where the rows allow it (element loads
//   otherwise), widened by a shift. d goes in at most kBfDepth-deep chunks
//   through two slots, at least two chunks where d > 8, one barrier a chunk
//   (two at d = 148). A chunk is loaded into registers two chunks ahead,
//   so at d 148 both are in flight from the start and the second lands
//   while the first is multiplied. The nodes' sizes and biases are loaded first, so their
//   latency runs under the staging.
// * Register microtiles in k order. A thread owns TM rows (a stride of
//   BM / TM apart) × TN adjacent columns; it reads its rows' operands as
//   float4 along k, a group of four k ahead, and its columns' as float4, a
//   k ahead, both double-buffered in registers. Each entry is acc =
//   fmaf(ω_k, x_k, acc) for k = 0 … d − 1 from acc = 0: the plain version's
//   order whatever the tile, the node count or the stacking. k is padded
//   to a multiple of 8 with zeros, which leaves every sum's bits as they
//   are. With TN = 8 the lanes whose column group has bit 2 set read their
//   two float4 in the other order, so a warp's X reads hit distinct banks.
//   A 4 × 8 microtile reads 12 floats from shared memory for 32 FMA, more
//   than the 1 float a lane a clock that shared memory delivers for the
//   FP32 units' 4: the product runs at about two thirds of their rate.
// * The epilogue of the plain version through shared memory: the sums go
//   to the X slots, then each thread takes eight adjacent columns of a row
//   at a time in a rolled loop (the sum rounded to bf16, the bias added in
//   f32 and rounded, the accurate cosf rounded), one 16-byte store where N
//   allows, element stores at the ragged edge. The loop keeps one copy of
//   the cosine's code, which an unrolled epilogue of 32 cosines (its slow
//   path included) spread over ~60 KB of instructions.
// * The tile from kernels/rff_features.py::features_plan (item 2): 64 × 64
//   blocks of 4 × 8 microtiles at the wave (256 blocks, two an SM), the
//   largest tile whose grid reaches three SMs in four elsewhere (one node:
//   32 × 32 blocks of 2 × 4, 112 blocks).
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

// ----------------------------------------------------------------- epilogue
__device__ __forceinline__ double epilogue(double acc, double b,
                                           double scale) {
  return cos(acc + b) * scale;
}

__device__ __forceinline__ float epilogue(float acc, float b, float scale) {
  return cosf(acc + b) * scale;
}

// -------------------------------------------------------------------- copies
// Copy `bytes` (4, 8 or 16) from src to shared dst, or zero-fill them when
// !valid; 16-byte copies go through L2 only. A 2-byte element cannot take
// cp.async and is stored directly; the barrier that publishes the chunk
// publishes it too.
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

// Elements per copy: the widest of 16, 8, 4 bytes that divides the row
// length and the base address (1 for elements narrower than 4 bytes).
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

// ------------------------------------------------------------- bf16 route
constexpr int kBfDepth = 80;                // most of d staged at once
constexpr int kBfRowStride = kBfDepth + 4;  // Ω row stride in shared, floats

// Shared memory of a block of BM × BN entries, all 4-byte words: two X
// slots [kBfDepth][BN], after them two Ω slots [BM][kBfRowStride], then
// each row's bias and state. The X slots come first, so the prefetch of X
// row kBfDepth that ends the last chunk of slot 1 reads Ω's first row
// (never used) rather than past the block. After the product the X slots
// hold the block's sums [BM][BN + 4] for the epilogue.
// kernels/rff_features.py::_bf16_smem_bytes is the same formula.
__host__ __device__ constexpr size_t bf16_smem_bytes(int bm, int bn) {
  return static_cast<size_t>(2 * kBfDepth * bn + 2 * bm * kBfRowStride +
                             2 * bm) *
         sizeof(float);
}

// Four bf16 (the lower address in the low half of .x) widened to f32.
__device__ __forceinline__ float4 widen(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// Four bf16 at p by element: p[e] for e < count, zeros past it.
__device__ __forceinline__ uint2 load_elems(const __nv_bfloat16* p,
                                            int count) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  unsigned v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < count ? __ldg(q + e) : 0u;
  return make_uint2(v[0] | v[1] << 16, v[2] | v[3] << 16);
}

// The three bf16 roundings of rff_features_lowp at unit scale, as bits;
// b is the row's bf16 bias, widened.
__device__ __forceinline__ unsigned bf16_feature(float acc, float b) {
  const float proj = __bfloat162float(__float2bfloat16_rn(acc));
  const float arg = __bfloat162float(__float2bfloat16_rn(proj + b));
  return __bfloat16_as_ushort(__float2bfloat16_rn(cosf(arg)));
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[i][·] += a_q(row i) · b over one k: a[i] holds four k of row i, q
// picks this k; b[0] (and b[1] with TN = 8) the thread's X columns.
template <int TM, int TN>
__device__ __forceinline__ void fma_k(float (&acc)[TM][TN],
                                      const float4 (&a)[TM], int q,
                                      const float4 (&b)[TN / 4]) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float w = lane_of(a[i], q);
#pragma unroll
    for (int e = 0; e < TN; ++e)
      acc[i][e] = fmaf(w, lane_of(b[e / 4], e % 4), acc[i][e]);
  }
}

// Sum k = 0 … kend − 1 (kend a multiple of 8) of one staged chunk into
// acc, k in order. a: the thread's first Ω row in the slot (row i at
// a + i·RS); b: the X slot, the thread's two column groups at b + off[0]
// and b + off[1]. The operands of the next group of four k (Ω) and of the
// next k (X) load while this one is multiplied; the last prefetch reads
// one group or row past kend, inside the block's shared memory, and is not
// used.
template <int TM, int TN, int RS, int BN>
__device__ __forceinline__ void multiply_chunk(float (&acc)[TM][TN],
                                               const float* a,
                                               const float* b,
                                               const int (&off)[2],
                                               int kend) {
  constexpr int NB = TN / 4;
  float4 av[2][TM], bv[2][NB];
  auto load_a = [&](float4 (&dst)[TM], int k) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
      dst[i] = *reinterpret_cast<const float4*>(a + i * RS + k);
  };
  auto load_b = [&](float4 (&dst)[NB], int k) {
#pragma unroll
    for (int h = 0; h < NB; ++h)
      dst[h] = *reinterpret_cast<const float4*>(b + k * BN + off[h]);
  };
  load_a(av[0], 0);
  load_b(bv[0], 0);
  for (int k = 0; k < kend; k += 8) {
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = 4 * g + q;
        if (q == 3) load_a(av[g ^ 1], k + 4 * g + 4);
        load_b(bv[(kk + 1) & 1], k + kk + 1);
        fma_k<TM, TN>(acc, av[g], q, bv[kk & 1]);
      }
  }
}

// Grid (⌈N / BN⌉, ⌈rows / BM⌉), (BM / TM)·(BN / TN) threads; rows = J·D_max
// stacked rows, node r / d_max. kc: d per chunk (a multiple of 8, at most
// kBfDepth). vec_a / vec_x: Ω / X rows take 8-byte loads; vec_z: Z rows
// take 16-byte stores of eight features.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
rff_features_bf16_kernel(const __nv_bfloat16* __restrict__ omega,
                         const __nv_bfloat16* __restrict__ bias,
                         const __nv_bfloat16* __restrict__ x,
                         const int* __restrict__ d_feat,
                         __nv_bfloat16* __restrict__ z, int rows, int d_max,
                         int dim, int n, int kc, int vec_a, int vec_x,
                         int vec_z) {
  using bf16 = __nv_bfloat16;
  constexpr int RT = BM / TM, CT = BN / TN, kThreads = RT * CT;
  constexpr int TPR = kThreads / BM;     // threads staging one Ω row
  constexpr int QA = (kBfDepth / 4 + TPR - 1) / TPR;
  constexpr int XQ = BN / 4;             // four-column groups of an X row
  constexpr int XSTEP = kThreads / XQ;   // X rows the block stages a pass
  constexpr int QX = (kBfDepth + XSTEP - 1) / XSTEP;
  constexpr int CS = BN + 4;             // row stride of the sums
  static_assert(TN == 4 || TN == 8, "a thread owns 4 or 8 columns");
  static_assert(kThreads % BM == 0 && kThreads % XQ == 0,
                "staging: whole Ω rows and X column groups a thread");
  static_assert(BM * CS <= 2 * kBfDepth * BN, "the sums fit the X slots");
  extern __shared__ __align__(16) float bf_smem[];
  float* xs = bf_smem;                                     // [2][kBfDepth][BN]
  float* as = xs + 2 * kBfDepth * BN;                      // [2][BM][kBfRowStride]
  float* row_bias = as + 2 * BM * kBfRowStride;            // [BM]
  int* row_state = reinterpret_cast<int*>(row_bias + BM);  // [BM]

  const int tid = threadIdx.x, tn = tid % CT, tm = tid / CT;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  // The node sizes and biases this thread needs, loaded first so their
  // latency runs under the staging: row row0 + tid of the state table
  // (tid < BM) and the Ω row it stages.
  const int s_row = row0 + tid;
  const bool s_in = tid < BM && s_row < rows;
  const int s_node = s_in ? s_row / d_max : 0;
  const int s_df = s_in ? d_feat[s_node] : 0;
  const float s_bias = s_in ? __bfloat162float(bias[s_row]) : 0.f;
  const int a_r = tid / TPR, a_q = tid % TPR, a_row = row0 + a_r;
  const bool a_in = a_row < rows;
  const int a_node = a_in ? a_row / d_max : 0;
  const int a_df = d_feat[a_node];

  // Staging: thread tid copies Ω row a_r's four-k groups a_q, a_q + TPR, …
  // and X's four-column group x_c of rows x_r, x_r + XSTEP, …: a chunk is
  // loaded into registers (buffer c % 2, two chunks ahead), then widened
  // into its slot (slot c % 2). One uniform branch picks 8-byte loads or
  // element loads for the whole chunk; past d, N or the stacked rows the
  // registers hold zeros.
  const bf16* a_src = omega + static_cast<size_t>(a_in ? a_row : 0) * dim;
  const int x_c = tid % XQ * 4, x_r = tid / XQ, x_col = col0 + x_c;
  const bool x_in = x_col < n;
  uint2 ra[2][QA], rx[2][QX];
  auto load = [&](int chunk, uint2 (&la)[QA], uint2 (&lx)[QX]) {
    const int k0 = chunk * kc;
    if (vec_a) {
#pragma unroll
      for (int j = 0; j < QA; ++j) {
        const int kq = 4 * (a_q + TPR * j), k = k0 + kq;
        la[j] = make_uint2(0u, 0u);
        if (a_in && kq < kc && k < dim)
          la[j] = __ldg(reinterpret_cast<const uint2*>(a_src + k));
      }
    } else {
#pragma unroll
      for (int j = 0; j < QA; ++j) {
        const int kq = 4 * (a_q + TPR * j), k = k0 + kq;
        la[j] = load_elems(a_src + k, a_in && kq < kc ? dim - k : 0);
      }
    }
    if (vec_x) {
#pragma unroll
      for (int j = 0; j < QX; ++j) {
        const int kr = x_r + XSTEP * j, k = k0 + kr;
        lx[j] = make_uint2(0u, 0u);
        if (x_in && kr < kc && k < dim)
          lx[j] = __ldg(reinterpret_cast<const uint2*>(
              x + static_cast<size_t>(k) * n + x_col));
      }
    } else {
#pragma unroll
      for (int j = 0; j < QX; ++j) {
        const int kr = x_r + XSTEP * j, k = k0 + kr;
        lx[j] = load_elems(x + static_cast<size_t>(k) * n + x_col,
                           x_in && kr < kc && k < dim ? n - x_col : 0);
      }
    }
  };
  const bool a_live = a_in && a_row - a_node * d_max < a_df;
  auto store = [&](int slot, const uint2 (&la)[QA], const uint2 (&lx)[QX]) {
    float* ad = as + (slot * BM + a_r) * kBfRowStride;
#pragma unroll
    for (int j = 0; j < QA; ++j) {
      const int kq = 4 * (a_q + TPR * j);
      if (kq < kc)
        *reinterpret_cast<float4*>(ad + kq) =
            a_live ? widen(la[j]) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float* xd = xs + slot * kBfDepth * BN + x_c;
#pragma unroll
    for (int j = 0; j < QX; ++j) {
      const int kr = x_r + XSTEP * j;
      if (kr < kc) *reinterpret_cast<float4*>(xd + kr * BN) = widen(lx[j]);
    }
  };
  const int chunks = (dim + kc - 1) / kc;
  load(0, ra[0], rx[0]);
  if (chunks > 1) load(1, ra[1], rx[1]);
  // Each row's state for the epilogue: −1 past the stacked rows, 0 past
  // its node's D_j (exact zeros), 1 live with its bias; published by the
  // first barrier below.
  if (tid < BM) {
    row_state[tid] = !s_in ? -1 : s_row - s_node * d_max < s_df ? 1 : 0;
    row_bias[tid] = s_bias;
  }

  // This thread's entries: rows tm + i·RT, columns TN·tn … TN·tn + TN − 1;
  // with TN = 8 the lanes whose tn has bit 2 set read (and write) their
  // two float4 of X in the other order, off[0] first, so the lanes of a
  // quarter-warp fall on distinct banks.
  const int sw = TN == 8 ? (tn >> 2) & 1 : 0;
  const int off[2] = {TN * tn + 4 * sw, TN * tn + 4 * (1 - sw)};
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int e = 0; e < TN; ++e) acc[i][e] = 0.f;

  // Chunk c: widened into slot c % 2 while chunk c + 2 loads into the
  // registers it leaves, published by the barrier, then multiplied. The
  // barrier also orders the reads of the slot in chunk c − 2 before its
  // store. The loop takes two chunks a pass, so buffers and slots are
  // fixed in each half.
  auto step = [&](int c, uint2 (&la)[QA], uint2 (&lx)[QX], int slot) {
    store(slot, la, lx);
    if (c + 2 < chunks) load(c + 2, la, lx);
    __syncthreads();
    multiply_chunk<TM, TN, RT * kBfRowStride, BN>(
        acc, as + (slot * BM + tm) * kBfRowStride,
        xs + slot * kBfDepth * BN, off, min(kc, (dim - c * kc + 7) & ~7));
  };
  for (int c = 0; c < chunks; c += 2) {
    step(c, ra[0], rx[0], 0);
    if (c + 1 < chunks) step(c + 1, ra[1], rx[1], 1);
  }

  // Epilogue through shared memory: the sums [BM][CS] in the X slots, then
  // eight adjacent features a thread at a time in a rolled loop (eight
  // inlined cosines, a 16-byte store where N allows).
  __syncthreads();  // every warp is done with the slots
  float* sums = xs;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int h = 0; h < TN / 4; ++h)
      *reinterpret_cast<float4*>(sums + (tm + i * RT) * CS + off[h]) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
  __syncthreads();
  constexpr int C8 = BN / 8;
#pragma unroll 1
  for (int w = tid; w < BM * C8; w += kThreads) {
    const int r = w / C8, c = 8 * (w % C8), col = col0 + c;
    const int state = row_state[r];
    if (state < 0 || col >= n) continue;
    float v[8];
#pragma unroll
    for (int h = 0; h < 8; h += 2) {
      const float2 p = *reinterpret_cast<const float2*>(sums + r * CS + c + h);
      v[h] = p.x;
      v[h + 1] = p.y;
    }
    const float b = row_bias[r];
    unsigned pk[4];
#pragma unroll
    for (int h = 0; h < 4; ++h)
      pk[h] = state > 0 ? bf16_feature(v[2 * h], b) |
                              bf16_feature(v[2 * h + 1], b) << 16
                        : 0u;
    __nv_bfloat16* zr = z + static_cast<size_t>(row0 + r) * n + col;
    if (vec_z && col + 8 <= n) {
      *reinterpret_cast<uint4*>(zr) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    } else {
      unsigned short* zs = reinterpret_cast<unsigned short*>(zr);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (col + e < n)
          zs[e] = static_cast<unsigned short>(pk[e / 2] >> (16 * (e % 2)));
    }
  }
}

template <int BM, int BN, int TM, int TN>
int launch_bf16_tile(const __nv_bfloat16* omega, const __nv_bfloat16* bias,
                     const __nv_bfloat16* x, const int* d_feat,
                     __nv_bfloat16* z, int rows, int d_max, int dim, int n,
                     int kc, int smem_bytes, cudaStream_t stream) {
  if (static_cast<size_t>(smem_bytes) < bf16_smem_bytes(BM, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long row_tiles = (static_cast<long long>(rows) + BM - 1) / BM;
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = rff_features_bf16_kernel<BM, BN, TM, TN>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const int vec_a = dim % 4 == 0 && aligned(omega, 8);
  const int vec_x = n % 4 == 0 && aligned(x, 8);
  const int vec_z = n % 8 == 0 && aligned(z, 16);
  const dim3 grid((n + BN - 1) / BN, static_cast<unsigned>(row_tiles));
  kernel<<<grid, (BM / TM) * (BN / TN), smem_bytes, stream>>>(
      omega, bias, x, d_feat, z, rows, d_max, dim, n, kc, vec_a, vec_x,
      vec_z);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// omega [J, d_max, dim], bias [J, d_max], x [dim, n], scale [J], d_feat
// [J] int32 (each ≤ d_max), z [J, d_max, n];
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

// bf16 at unit scale over the stacked rows: omega [J·d_max, dim], bias
// [J·d_max], x [dim, n], d_feat [J] int32 (each ≤ d_max), z [J·d_max, n];
// (bm, bn, tm, tn): the block tile and a thread's microtile, one of
// (64, 64, 4, 8), (32, 64, 2, 8), (32, 32, 2, 4), (16, 32, 1, 4); kc: d
// per staged chunk, a multiple of 8 in [8, 80]; smem_bytes: at least
// rff_features_bf16_smem_bytes(bm, bn).
int rff_features_bf16(const void* omega, const void* bias, const void* x,
                      const void* d_feat, void* z, int J, int d_max, int dim,
                      int n, int bm, int bn, int tm, int tn, int kc,
                      int smem_bytes, void* stream) {
  const long long rows = static_cast<long long>(J) * d_max;
  if (J < 1 || d_max < 1 || dim < 1 || n < 1 || rows > 0x7fffffff ||
      kc < 8 || kc > kBfDepth || kc % 8 != 0 || smem_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using B = __nv_bfloat16;
  const B* o = static_cast<const B*>(omega);
  const B* b = static_cast<const B*>(bias);
  const B* xx = static_cast<const B*>(x);
  const int* df = static_cast<const int*>(d_feat);
  B* zz = static_cast<B*>(z);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RFF_BF16_TILE(M, N, R, C)                                            \
  if (bm == M && bn == N && tm == R && tn == C)                              \
    return launch_bf16_tile<M, N, R, C>(o, b, xx, df, zz,                    \
                                        static_cast<int>(rows), d_max, dim,  \
                                        n, kc, smem_bytes, st);
  RFF_BF16_TILE(64, 64, 4, 8)
  RFF_BF16_TILE(32, 64, 2, 8)
  RFF_BF16_TILE(32, 32, 2, 4)
  RFF_BF16_TILE(16, 32, 1, 4)
#undef RFF_BF16_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of a block of tile (wr, wc, nt) for elements of
// `elem` bytes (8 f64, 4 f32), the least the launcher accepts
// (repro_torch.analysis.smem checks the same formula before any launch).
int rff_features_smem_bytes(int wr, int wc, int nt, int elem) {
  if (elem == 8) return static_cast<int>(features_smem_bytes<double>(wr, wc, nt));
  return static_cast<int>(features_smem_bytes<float>(wr, wc, nt));
}

// The same for the bf16 kernel's block of bm × bn entries.
int rff_features_bf16_smem_bytes(int bm, int bn) {
  return static_cast<int>(bf16_smem_bytes(bm, bn));
}

}  // extern "C"
