// Fused random-feature Gram blocks of Eq. 17, batched over problems: the
// Hopper counterpart of src/repro/kernels/rff_gram.py::rff_gram_pallas
// (_rff_gram_kernel), vmapped by repro.kernels.ops.rff_gram_batched.
//
// For each problem b:  Z = scale · cos(Ω X + b) · colmask   (Z is never stored)
//                      G = Z Zᵀ [F, F],  zy = Z y [F]
//
// Bound on the card: operations, 2·F·d·N for the projection plus F(F+1)·N
// for the Gram's upper triangle (G is symmetric). In f64 only the FP64 tensor cores (mma.sync .f64, 67 TFLOP/s)
// reach that rate; the FP64 vector units give half. The Pallas kernel walks
// N in order and carries the [F, F] sum in VMEM; a CUDA grid has no order
// and a block has 227 KB of shared memory, so this kernel splits N across
// clusters and reduces in a fixed order:
//
// * Grid (C·S, Q, B), clusters of C blocks along x, 8 warps a block. Cluster
//   s of problem b owns slice_cols columns (a multiple of kNc) and walks
//   them in tiles of kNc. The wrapper (kernels/rff_gram.py::gram_plan)
//   picks C, S, Q and whether Ω stays resident.
// * Block rank r owns feature rows [r·H, (r+1)·H), H a multiple of 16 (at
//   C = 2, F = 200: 112 and 96 rows). Its Ω rows are loaded into shared
//   memory once (`resident`; else streamed with X), and X goes through a
//   ring of kStages chunks of kKc rows by cp.async (16-byte copies through
//   L2 where rows are 16-byte aligned; each thread's share of a chunk is
//   fixed, so a stage costs a few adds, not integer divisions). Two slots
//   of 32 rows beat four of 16: half the barriers a tile.
// * Projection: P = Ω X_tile on the FP64 tensor cores (mma.sync m16n8k16
//   .f64), two 16×16 units a warp, four independent accumulators.
// * Epilogue: scale·cos(P + b)·mask with the accurate cos into the shared Z
//   tile [F_pad, kNc]; each cosine of each column is computed once (Q = 1,
//   i.e. F ≤ 208 at C = 2). The block adds its rows' Z·y to a register.
// * Exchange: a cluster barrier, then each block copies the other ranks'
//   rows out of their shared memory (distributed shared memory). The
//   barrier that keeps a rank from overwriting rows a peer still copies is
//   split (arrive after the copy, wait before the next epilogue), so its
//   latency hides behind the Gram and the next projection.
// * Gram: the upper triangle of Z Zᵀ in 16×16 blocks, six per warp, dealt
//   over ranks and warps, on the tensor cores, summed in registers over the
//   slice.
// * Reduction: each block writes its partial blocks (and zy rows) to a
//   workspace [B, Q, S, group_blocks, 16·16] (+ [B, S, F_pad]) and bumps a
//   per-(problem, group, rank) counter after __threadfence(); the block
//   that brings it to S sums s = 0 … S−1 in slice order and writes each
//   upper element to G[i][j] and G[j][i] (G is exactly symmetric). The
//   wrapper zeroes the counters for each launch. No float atomics: two
//   launches give the same bits.
//
// What still holds it back (chip_smoke.py and PERF.md): every tile passes
// through ~5 chunk barriers, a cluster barrier and a copy with only 8
// warps an SM to hide their latency, so the phases add up instead of
// overlapping. F above 208 at C = 2 (the wrapper raises C first) splits the
// triangle into Q groups whose clusters each recompute Z. f32 runs the
// same tiling with the products on the FP32 units (FMA, no TF32).
//
// A second route takes F past what a cluster's shared memory holds (560
// features in f64, 1,024 in f32; kernels/rff_gram.py::gram_plan picks it
// there, as a WideGramPlan). It stores Z instead of re-forming it: per
// pass of `batch` problems and chunk of `cols` columns of N (the plan
// keeps the workspace [batch, F_pad, cols] within its cap), two launches:
//
// * rff_gram_z_kernel forms each Z entry of the chunk ONCE: one 256-thread
//   block per 64×64 tile of Z, Ω and X streamed through shared memory in
//   32-deep chunks by cp.async (two in a ring), the projection on the FP64
//   tensor cores (mma.sync m16n8k16 .f64, a 32×16 tile a warp, fragments
//   reused across its 2×2 mma tiles), then scale·cos(P + b)·mask with the
//   accurate cos into the workspace (zero past F and the chunk's columns).
// * rff_gram_wide_kernel takes one 256-thread block per 64×64 tile (I ≤ J)
//   of G's upper triangle and problem, streams the Z panels of its two row
//   ranges (one on the diagonal) through a ring of three 32-column stages
//   by cp.async, accumulates Z_I Z_Jᵀ on the FP64 tensor cores, and forms
//   zy on the diagonal tiles. Each entry of G is summed by one block and
//   written to G[i][j] and G[j][i] from one value; a later chunk adds its
//   sum to what the earlier chunks left (in chunk order).
//
// No atomics and no float reduction across blocks: G == Gᵀ exactly and
// the same bits from run to run. f32 runs the same tiling with the
// products on the FP32 units (mma16x8x16's FMA twin, no TF32).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kNc = 32;       // columns per tile
constexpr int kKc = 32;       // projection depth per staged chunk
constexpr int kStages = 2;    // chunks in the cp.async ring (1 in flight)
// Shared row strides ≡ 4 (mod 8) words: the fragment loads below (lane
// (g, t) reads row g, column t) hit 16 distinct 8-byte banks per half warp.
constexpr int kZs = kNc + 4;
constexpr int kXs = kNc + 4;
constexpr int kOs = kKc + 4;
constexpr int kUnits = kNc / 16;           // 16×16 projection units per m-tile
constexpr int kPSlots = 2;                 // projection units per warp
constexpr int kMaxRankRows = kPSlots * kWarps / kUnits * 16;  // 128
constexpr int kGSlots = 6;                 // 16×16 Gram blocks per warp
constexpr int kCopyBatch = 8;              // peer Z loads in flight a thread
constexpr int kSumBatch = 4;               // reduced elements a thread at once

__host__ __device__ inline int rank_rows_alloc(int F, int C) {
  const int nb = (F + 15) / 16;
  return (nb + C - 1) / C * 16;
}

// Row stride of the resident Ω rows: d padded to the chunk depth, + 4.
__host__ __device__ inline int resident_stride(int dim) {
  return (dim + kKc - 1) / kKc * kKc + 4;
}

// Z tile [F_pad][kZs], Ω rows (resident [H][stride] or a ring [kStages][H]
// [kOs]), X ring [kStages][kKc][kXs], y and mask ring [kStages][2][kNc],
// bias rows [H]. The wrapper's plan sizes the launch
// (kernels/rff_gram.py::gram_plan); the launcher only checks that it
// covers this layout.
__host__ __device__ inline size_t gram_smem_bytes(int F, int dim, int C,
                                                  int resident, int elem) {
  const size_t fp = (F + 15) / 16 * 16;
  const size_t hr = rank_rows_alloc(F, C);
  const size_t om = resident ? hr * resident_stride(dim)
                             : kStages * hr * kOs;
  return (fp * kZs + om + static_cast<size_t>(kStages) * kKc * kXs +
          kStages * 2 * kNc + hr) *
         elem;
}

// c += A·B for a 16×8 (m×n) tile over k = 16 on the FP64 tensor cores. c
// is the lane's share in the mma layout: rows g, g, g+8, g+8 and columns
// 2t, 2t+1, 2t, 2t+1 (g = lane/4, t = lane%4); the lane holds A at rows
// g + 8·(i % 2), columns t + 4·(i / 2) (av[i]), and B at rows t + 4·i,
// column g (bv[i]).
__device__ __forceinline__ void dmma16x8x16(double (&c)[4],
                                            const double (&av)[8],
                                            const double (&bv)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(av[0]), "d"(av[1]), "d"(av[2]), "d"(av[3]), "d"(av[4]),
        "d"(av[5]), "d"(av[6]), "d"(av[7]), "d"(bv[0]), "d"(bv[1]),
        "d"(bv[2]), "d"(bv[3]));
}

// The same with A(m, k) = a[m·am + k·ak] and B(k, n) = b[k·bk + n·bn]
// loaded from memory.
__device__ __forceinline__ void mma16x8x16(double (&c)[4], const double* a,
                                           int am, int ak, const double* b,
                                           int bk, int bn, int lane) {
  const int g = lane >> 2, t = lane & 3;
  double av[8], bv[4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    av[i] = a[(g + 8 * (i % 2)) * am + (t + 4 * (i / 2)) * ak];
#pragma unroll
  for (int i = 0; i < 4; ++i) bv[i] = b[(t + 4 * i) * bk + g * bn];
  dmma16x8x16(c, av, bv);
}

// The same product in f32 on the FP32 units, k in order.
__device__ __forceinline__ void mma16x8x16(float (&c)[4], const float* a,
                                           int am, int ak, const float* b,
                                           int bk, int bn, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float lo = a[g * am + k * ak], hi = a[(g + 8) * am + k * ak];
    const float b0 = b[k * bk + 2 * t * bn], b1 = b[k * bk + (2 * t + 1) * bn];
    c[0] = fmaf(lo, b0, c[0]);
    c[1] = fmaf(lo, b1, c[1]);
    c[2] = fmaf(hi, b0, c[2]);
    c[3] = fmaf(hi, b1, c[3]);
  }
}

// Copy `bytes` (0 … 16, the rest zero-filled) of the 16-byte source chunk
// to 16 bytes of shared memory, through L2 only (an 8-byte copy must go
// through L1, which the shared-memory carve-out leaves at ~28 KB).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(bytes));
}

// One element, zero when !valid (rows whose length is not a multiple of
// 16 bytes).
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(addr),
               "l"(src), "n"(Bytes), "r"(valid ? Bytes : 0));
}

// Start copying `rows` rows of `width` elements (src row r at
// src + r·src_stride) to dst (row stride dst_stride), zero-filling rows at
// or past rows_valid and elements at or past `valid`; the block's threads
// share the work. 16-byte chunks when `vec` (width a multiple of 16 bytes,
// 16-byte aligned rows), else one element a copy.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int dst_stride,
                                          const T* src, size_t src_stride,
                                          int rows, int rows_valid, int width,
                                          int valid, bool vec) {
  const int v = vec ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int per_row = width / v;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row, i = e % per_row * v;
    const int n = r < rows_valid ? max(0, min(v, valid - i)) : 0;
    const T* from = n ? src + r * src_stride + i : src;
    T* to = dst + r * dst_stride + i;
    if (vec)
      cp_async16(to, from, n * static_cast<int>(sizeof(T)));
    else
      cp_async<sizeof(T)>(to, from, n > 0);
  }
}

// The two halves of cluster.sync(), so a block can work between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte copies where every row starts on a 16-byte boundary.
__device__ __forceinline__ bool aligned16(const void* ptr, size_t row_bytes) {
  return reinterpret_cast<size_t>(ptr) % 16 == 0 && row_bytes % 16 == 0;
}

// (bi, bj) of upper-triangle block `idx` (row-major, bi ≤ bj < nb).
__device__ __forceinline__ void tri_block(int idx, int nb, int& bi, int& bj) {
  bi = 0;
  while (idx >= nb - bi) {
    idx -= nb - bi;
    ++bi;
  }
  bj = bi + idx;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
rff_gram_kernel(const T* __restrict__ omega, const T* __restrict__ bias,
                const T* __restrict__ x, const T* __restrict__ y,
                const T* __restrict__ mask, T* __restrict__ gram,
                T* __restrict__ zy, T* __restrict__ work,
                int* __restrict__ counters, int F, int dim, int N, T scale,
                int slices, int slice_cols, int group_blocks, int resident) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.x / C, q = blockIdx.y, b = blockIdx.z;
  const int groups = gridDim.y, B = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;

  const int nb = (F + 15) / 16, fp = nb * 16;
  const int hr = rank_rows_alloc(F, C);       // rows per rank (allocated)
  const int row0 = rank * hr;
  const int my_rows = max(0, min(fp, row0 + hr) - row0);
  // Ω rows of this rank: resident [hr][ostr] loaded once, or a ring of
  // kStages chunks [hr][kOs] streamed with X.
  const int ostr = resident ? resident_stride(dim) : kOs;
  T* zs = reinterpret_cast<T*>(smem_raw);     // [fp][kZs]
  T* os = zs + static_cast<size_t>(fp) * kZs;
  T* xs = os + static_cast<size_t>(hr) * (resident ? ostr : kStages * kOs);
  T* ym = xs + kStages * kKc * kXs;            // [kStages][y, mask][kNc]
  T* bs = ym + kStages * 2 * kNc;              // [hr] bias of this rank's rows

  const T* om = omega + static_cast<size_t>(b) * F * dim;
  const T* bi_b = bias + static_cast<size_t>(b) * F;
  const T* xb = x + static_cast<size_t>(b) * dim * N;
  const T* yb = y + static_cast<size_t>(b) * N;
  const T* mb = mask + static_cast<size_t>(b) * N;

  const int c_begin = s * slice_cols;
  const int c_end = min(N, c_begin + slice_cols);
  const int tiles = c_end > c_begin ? (c_end - c_begin + kNc - 1) / kNc : 0;
  const int kchunks = max(1, (dim + kKc - 1) / kKc);
  const int stages = tiles * kchunks;

  // This warp's projection units u = warp + kWarps·i: rows pm·16 of the
  // rank, columns pn·16 of the tile.
  int pm[kPSlots], pn[kPSlots];
  bool p_live[kPSlots];
#pragma unroll
  for (int i = 0; i < kPSlots; ++i) {
    const int u = warp + kWarps * i;
    pm[i] = u / kUnits;
    pn[i] = u % kUnits;
    p_live[i] = pm[i] * 16 < my_rows;
  }
  // This warp's Gram blocks in group q: the rank takes every C-th block
  // of the row-major upper triangle, each warp a run of kGSlots of them.
  const int total_blocks = nb * (nb + 1) / 2;
  const int blocks_here = min(group_blocks, total_blocks - q * group_blocks);
  int gbi[kGSlots], gbj[kGSlots];
  bool g_live[kGSlots];
#pragma unroll
  for (int i = 0; i < kGSlots; ++i) {
    const int l = (warp * kGSlots + i) * C + rank;
    g_live[i] = l < blocks_here;
    tri_block(g_live[i] ? q * group_blocks + l : 0, nb, gbi[i], gbj[i]);
  }

  T pacc[kPSlots][2][4], gacc[kGSlots][2][4];
#pragma unroll
  for (int i = 0; i < kGSlots; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[i][h][e] = T(0);
  T zy_acc = T(0);

  const bool xvec = aligned16(x, N * sizeof(T)) &&
                    aligned16(y, N * sizeof(T)) &&
                    aligned16(mask, N * sizeof(T));
  const bool ovec = aligned16(omega, dim * sizeof(T));
  const bool bvec = aligned16(bias, F * sizeof(T));

  // Each thread's share of a stage's X chunk [kKc][kNc] and of a tile's
  // y and mask, fixed for the launch: chunk e = tid + j·kThreads is row
  // xr[j], columns xi[j] … + xv − 1. A stage then costs a few adds.
  const int xv = xvec ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kXSlots = kKc * kNc / kThreads;
  int xr[kXSlots], xi[kXSlots];
#pragma unroll
  for (int j = 0; j < kXSlots; ++j) {
    const int e = tid + j * kThreads;
    xr[j] = e < kKc * kNc / xv ? e / (kNc / xv) : kKc;  // kKc: no chunk
    xi[j] = e % (kNc / xv) * xv;
  }
  const int ym_row = tid / (kNc / xv), ym_col = tid % (kNc / xv) * xv;

  // Stage (tile, kc) into ring slot buf.
  auto load_stage = [&](int tile, int kc, int buf) {
    const int c0 = c_begin + tile * kNc, k0 = kc * kKc;
    if (!resident)
      copy_rows(os + static_cast<size_t>(buf) * hr * kOs, kOs,
                om + static_cast<size_t>(row0) * dim + k0, dim, my_rows,
                F - row0, kKc, dim - k0, ovec);
    T* xd = xs + buf * kKc * kXs;
#pragma unroll
    for (int j = 0; j < kXSlots; ++j) {
      if (xr[j] >= kKc) continue;
      const int k = k0 + xr[j], col = c0 + xi[j];
      const int n = k < dim ? max(0, min(xv, c_end - col)) : 0;
      const T* src = n ? xb + static_cast<size_t>(k) * N + col : xb;
      T* dst = xd + xr[j] * kXs + xi[j];
      if (xvec)
        cp_async16(dst, src, n * static_cast<int>(sizeof(T)));
      else
        cp_async<sizeof(T)>(dst, src, n > 0);
    }
    if (kc == kchunks - 1 && ym_row < 2) {  // y and mask, for the epilogue
      const int col = c0 + ym_col;
      const int n = max(0, min(xv, c_end - col));
      const T* row = ym_row ? mb : yb;
      const T* src = n ? row + col : row;
      T* dst = ym + buf * 2 * kNc + ym_row * kNc + ym_col;
      if (xvec)
        cp_async16(dst, src, n * static_cast<int>(sizeof(T)));
      else
        cp_async<sizeof(T)>(dst, src, n > 0);
    }
  };

  // This rank's bias rows and (resident) Ω rows, zero past F and d, once.
  copy_rows(bs, hr, bi_b + row0, 0, 1, 1, hr, F - row0, bvec);
  if (resident)
    copy_rows(os, ostr, om + static_cast<size_t>(row0) * dim, dim, my_rows,
              F - row0, ostr - 4, dim, ovec);
  cp_async_commit();
  // One commit group per stage (empty past the end), kStages − 1 ahead;
  // (ld_tile, ld_kc) is the next stage to load, (tile, kc) this one.
  int ld_tile = 0, ld_kc = 0;
  auto next = [&](int& tl, int& k) {
    if (++k == kchunks) {
      k = 0;
      ++tl;
    }
  };
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < stages) {
      load_stage(ld_tile, ld_kc, st);
      next(ld_tile, ld_kc);
    }
    cp_async_commit();
  }
  int tile = 0, kc = 0;
  for (int st = 0; st < stages; ++st, next(tile, kc)) {
    const int buf = st % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk st visible; every warp is done with st − 1
    if (st + kStages - 1 < stages) {
      load_stage(ld_tile, ld_kc, (st + kStages - 1) % kStages);
      next(ld_tile, ld_kc);
    }
    cp_async_commit();

    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < kPSlots; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) pacc[i][h][e] = T(0);
    }
#pragma unroll
    for (int i = 0; i < kPSlots; ++i) {
      if (!p_live[i]) continue;
      const T* oa = resident
          ? os + static_cast<size_t>(pm[i]) * 16 * ostr + kc * kKc
          : os + (static_cast<size_t>(buf) * hr + pm[i] * 16) * kOs;
      const T* xa = xs + buf * kKc * kXs + pn[i] * 16;
#pragma unroll
      for (int ks = 0; ks < kKc / 16; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mma16x8x16(pacc[i][h], oa + ks * 16, ostr, 1,
                     xa + ks * 16 * kXs + h * 8, kXs, 1, lane);
    }
    if (kc != kchunks - 1) continue;

    // Epilogue of the tile: this rank's Z rows into the shared tile.
    const int c0 = c_begin + tile * kNc;
    const T* yms = ym + buf * 2 * kNc;  // y, mask of the tile (0 past c_end)
    if (tile > 0) cluster_wait();  // peers are done reading our rows
#pragma unroll
    for (int i = 0; i < kPSlots; ++i) {
      if (!p_live[i]) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + pm[i] * 16 + g + (e >= 2 ? 8 : 0);
          const int col = pn[i] * 16 + h * 8 + 2 * t + (e & 1);
          T z = T(0);
          if (row < F && c0 + col < c_end)
            z = scale * cos(pacc[i][h][e] + bs[row - row0]) * yms[kNc + col];
          zs[static_cast<size_t>(row) * kZs + col] = z;
        }
    }
    cluster_arrive();
    cluster_wait();  // every rank's rows written
    if (q == 0 && tid < my_rows) {
      const T* zr = zs + static_cast<size_t>(row0 + tid) * kZs;
#pragma unroll
      for (int n = 0; n < kNc; ++n) zy_acc += zr[n] * yms[n];
    }
    // The other ranks' rows, in 16-byte words (kZs·sizeof(T) is a multiple
    // of 16), all loads in flight before the stores.
    constexpr int kW = kNc * sizeof(T) / 16, kRowW = kZs * sizeof(T) / 16;
    for (int peer = 0; peer < C; ++peer) {
      const int p0 = peer * hr;
      const int total = (min(fp, p0 + hr) - p0) * kW;
      if (peer == rank || total <= 0) continue;
      const uint4* src = reinterpret_cast<const uint4*>(
          cluster.map_shared_rank(zs, peer)) + p0 * kRowW;
      uint4* dst = reinterpret_cast<uint4*>(zs) + p0 * kRowW;
      for (int e0 = tid; e0 < total; e0 += kCopyBatch * kThreads) {
        uint4 v[kCopyBatch];
#pragma unroll
        for (int u = 0; u < kCopyBatch; ++u) {
          const int e = e0 + u * kThreads;
          if (e < total) v[u] = src[e / kW * kRowW + e % kW];
        }
#pragma unroll
        for (int u = 0; u < kCopyBatch; ++u) {
          const int e = e0 + u * kThreads;
          if (e < total) dst[e / kW * kRowW + e % kW] = v[u];
        }
      }
    }
    __syncthreads();   // the copies, for the Gram
    cluster_arrive();  // done with the peers' rows; waited on at the next tile

    // Gram: this warp's upper-triangle blocks, k over the tile's columns.
#pragma unroll
    for (int i = 0; i < kGSlots; ++i) {
      if (!g_live[i]) continue;
      const T* za = zs + static_cast<size_t>(gbi[i]) * 16 * kZs;
      const T* zb = zs + static_cast<size_t>(gbj[i]) * 16 * kZs;
#pragma unroll
      for (int ks = 0; ks < kNc / 16; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mma16x8x16(gacc[i][h], za + ks * 16, kZs, 1,
                     zb + h * 8 * kZs + ks * 16, 1, kZs, lane);
    }
  }

  if (stages > 0) cluster_wait();  // no block leaves while peers read it

  // Partials of this slice.
  const size_t blk_elems = static_cast<size_t>(group_blocks) * 256;
  T* wg = work + ((static_cast<size_t>(b) * groups + q) * slices + s) * blk_elems;
#pragma unroll
  for (int i = 0; i < kGSlots; ++i) {
    if (!g_live[i]) continue;
    const int l = (warp * kGSlots + i) * C + rank;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wg[static_cast<size_t>(l) * 256 + (g + (e >= 2 ? 8 : 0)) * 16 + h * 8 +
           2 * t + (e & 1)] = gacc[i][h][e];
  }
  T* wz = work + static_cast<size_t>(B) * groups * slices * blk_elems;
  if (q == 0 && tid < my_rows)
    wz[(static_cast<size_t>(b) * slices + s) * fp + row0 + tid] = zy_acc;

  // The last block of (b, q, rank) to finish sums the slices in order.
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = counters + (b * groups + q) * C + rank;
    is_last = atomicAdd(ctr, 1) == slices - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  const T* wq = work + (static_cast<size_t>(b) * groups + q) * slices * blk_elems;
  T* gb = gram + static_cast<size_t>(b) * F * F;
  const int mine = blocks_here > rank ? (blocks_here - rank + C - 1) / C : 0;
  for (int e0 = tid; e0 < mine * 256; e0 += kSumBatch * kThreads) {
    size_t at[kSumBatch];
    int ij[kSumBatch][2];
    bool ok[kSumBatch];
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int l = rank + (e / 256) * C, el = e % 256;
      int bi, bj;
      tri_block(e < mine * 256 ? q * group_blocks + l : 0, nb, bi, bj);
      ij[u][0] = bi * 16 + el / 16;
      ij[u][1] = bj * 16 + el % 16;
      ok[u] = e < mine * 256 && ij[u][0] < F && ij[u][1] < F &&
              ij[u][0] <= ij[u][1];
      at[u] = static_cast<size_t>(l) * 256 + el;
    }
    T v[kSumBatch];
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u) v[u] = T(0);
    for (int sl = 0; sl < slices; ++sl) {  // slice order, loads batched
      T w[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        w[u] = ok[u] ? __ldcg(wq + sl * blk_elems + at[u]) : T(0);
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) v[u] += w[u];
    }
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u) {
      if (!ok[u]) continue;
      gb[static_cast<size_t>(ij[u][0]) * F + ij[u][1]] = v[u];
      gb[static_cast<size_t>(ij[u][1]) * F + ij[u][0]] = v[u];
    }
  }
  if (q == 0 && tid < my_rows && row0 + tid < F) {
    T v = T(0);
    for (int sl = 0; sl < slices; ++sl)
      v += __ldcg(wz + (static_cast<size_t>(b) * slices + sl) * fp + row0 + tid);
    zy[static_cast<size_t>(b) * F + row0 + tid] = v;
  }
}

template <typename T>
int launch(const void* omega, const void* bias, const void* x, const void* y,
           const void* mask, void* gram, void* zy, void* work, void* counters,
           int B, int F, int dim, int N, double scale, int cluster, int slices,
           int slice_cols, int groups, int group_blocks, int resident,
           int smem_bytes, void* stream) {
  const int nb = (F + 15) / 16;
  if (cluster < 1 || cluster > 8 || slices < 1 || slice_cols % kNc != 0 ||
      static_cast<size_t>(smem_bytes) <
          gram_smem_bytes(F, dim, cluster, resident, sizeof(T)) ||
      static_cast<long long>(slices) * slice_cols < N ||
      rank_rows_alloc(F, cluster) > kMaxRankRows ||
      group_blocks > kGSlots * kWarps * cluster ||
      static_cast<long long>(groups) * group_blocks < nb * (nb + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return cluster_launch(
      rff_gram_kernel<T>, dim3(cluster * slices, groups, B), kThreads,
      smem_bytes, cluster, stream,
      static_cast<const T*>(omega), static_cast<const T*>(bias),
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(mask), static_cast<T*>(gram), static_cast<T*>(zy),
      static_cast<T*>(work), static_cast<int*>(counters), F, dim, N,
      static_cast<T>(scale), slices, slice_cols, group_blocks, resident);
}

// ------------------------------------------------------------- wide route
constexpr int kWT = 64;        // Z and G tile rows and columns
constexpr int kWK = 32;        // depth of a staged chunk (d, or N columns)
constexpr int kWStages = 3;    // the Gram phase's cp.async ring
// Row strides ≡ 4 (mod 8) words, as kZs: k-contiguous panels [rows][kWAs]
// and the X panel [k][kWXs].
constexpr int kWAs = kWK + 4;
constexpr int kWXs = kWT + 4;

__host__ __device__ constexpr size_t z_smem_bytes(size_t elem) {
  return (2 * kWT * kWAs + 2 * kWK * kWXs) * elem;
}

__host__ __device__ constexpr size_t wide_smem_bytes(size_t elem) {
  return kWStages * (2 * kWT * kWAs + kWK) * elem;
}

// c[m][n] += A·B over k = 16 for a warp's 2×2 grid of 16×8 tiles:
// A(row, k) = a[row·am + k·ak] (tile m at rows m·16), B(k, col) =
// b[k·bk + col·bn] (tile n at columns n·8). In f64 each fragment is
// loaded once and feeds the tensor cores twice.
template <int MT, int NT>
__device__ __forceinline__ void warp_mma(double (&c)[MT][NT][4],
                                         const double* a, int am, int ak,
                                         const double* b, int bk, int bn,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  double av[MT][8], bv[NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[m][i] = a[(m * 16 + g + 8 * (i % 2)) * am + (t + 4 * (i / 2)) * ak];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      bv[n][i] = b[(t + 4 * i) * bk + (n * 8 + g) * bn];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) dmma16x8x16(c[m][n], av[m], bv[n]);
}

template <int MT, int NT>
__device__ __forceinline__ void warp_mma(float (&c)[MT][NT][4],
                                         const float* a, int am, int ak,
                                         const float* b, int bk, int bn,
                                         int lane) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma16x8x16(c[m][n], a + m * 16 * am, am, ak, b + n * 8 * bn, bk, bn,
                 lane);
}

// Phase 1: Z[b, F_pad, cols] of columns [c_base, c_base + width) of N,
// one block per 64×64 tile (grid (⌈width/64⌉, F_pad/64, batch)). Warp w
// forms rows (w / 4)·32 … + 31, columns (w % 4)·16 … + 15 of the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rff_gram_z_kernel(const T* __restrict__ omega, const T* __restrict__ bias,
                  const T* __restrict__ x, const T* __restrict__ mask,
                  T* __restrict__ z, int F, int dim, int N, int c_base,
                  int width, int f_pad, int cols, T scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* os = reinterpret_cast<T*>(smem_raw);  // [2][kWT][kWAs]  Ω rows
  T* xs = os + 2 * kWT * kWAs;             // [2][kWK][kWXs]  X columns
  const int b = blockIdx.z, r0 = blockIdx.y * kWT, c0 = blockIdx.x * kWT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, wr = warp >> 2, wc = warp & 3;
  const T* om = omega + static_cast<size_t>(b) * F * dim;
  const T* xb = x + static_cast<size_t>(b) * dim * N + c_base + c0;
  const bool ovec = aligned16(om, dim * sizeof(T));
  const bool xvec = aligned16(xb, N * sizeof(T));
  const int kchunks = (dim + kWK - 1) / kWK;

  // chunk kc of Ω's rows [r0, r0 + 64) and X's columns [c0, c0 + 64),
  // zero past F, d and the chunk's width
  auto load = [&](int kc, int buf) {
    const int k0 = kc * kWK;
    copy_rows(os + buf * kWT * kWAs, kWAs,
              om + static_cast<size_t>(r0) * dim + k0, dim, kWT, F - r0, kWK,
              dim - k0, ovec);
    copy_rows(xs + buf * kWK * kWXs, kWXs, xb + static_cast<size_t>(k0) * N,
              N, kWK, dim - k0, kWT, width - c0, xvec);
  };

  T acc[2][2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = T(0);
  load(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < kchunks; ++kc) {
    if (kc + 1 < kchunks) load(kc + 1, (kc + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk kc visible to every warp
    const T* oa = os + (kc & 1) * kWT * kWAs + wr * 32 * kWAs;
    const T* xa = xs + (kc & 1) * kWK * kWXs + wc * 16;
#pragma unroll
    for (int ks = 0; ks < kWK / 16; ++ks)
      warp_mma(acc, oa + ks * 16, kWAs, 1, xa + ks * 16 * kWXs, kWXs, 1,
               lane);
    __syncthreads();  // every warp is done with the slot refilled next
  }

  T* zb = z + static_cast<size_t>(b) * f_pad * cols;
  const T* bi = bias + static_cast<size_t>(b) * F;
  const T* mb = mask + static_cast<size_t>(b) * N + c_base;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + wr * 32 + m * 16 + g + (e >= 2 ? 8 : 0);
        const int col = c0 + wc * 16 + n * 8 + 2 * t + (e & 1);
        T v = T(0);
        if (row < F && col < width)
          v = scale * cos(acc[m][n][e] + bi[row]) * mb[col];
        zb[static_cast<size_t>(row) * cols + col] = v;
      }
}

// Phase 2: G (and zy) of the chunk, one block per 64×64 tile (I ≤ J) of
// the upper triangle and problem (grid (tiles, batch)); warp w sums rows
// (w / 4)·32 … + 31 of tile I against rows (w % 4)·16 … + 15 of tile J.
// `accumulate`: add to the G and zy the earlier chunks wrote.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rff_gram_wide_kernel(const T* __restrict__ z, const T* __restrict__ y,
                     T* __restrict__ gram, T* __restrict__ zy, int F, int N,
                     int c_base, int width, int f_pad, int cols,
                     int accumulate) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* panels = reinterpret_cast<T*>(smem_raw);  // [kWStages][2][kWT][kWAs]
  T* ys = panels + kWStages * 2 * kWT * kWAs;   // [kWStages][kWK]
  const int b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, wr = warp >> 2, wc = warp & 3;
  int ti, tj;
  tri_block(blockIdx.x, f_pad / kWT, ti, tj);
  const bool diag = ti == tj;
  const T* zb = z + static_cast<size_t>(b) * f_pad * cols;
  const T* zi = zb + static_cast<size_t>(ti) * kWT * cols;
  const T* zj = zb + static_cast<size_t>(tj) * kWT * cols;
  const T* yb = y + static_cast<size_t>(b) * N + c_base;
  const int ksteps = (width + kWK - 1) / kWK;

  // columns [k0, k0 + 32) of both panels (Z is zero past the width) and,
  // on the diagonal, of y
  auto load = [&](int kc, int buf) {
    const int k0 = kc * kWK;
    T* pa = panels + buf * 2 * kWT * kWAs;
    copy_rows(pa, kWAs, zi + k0, cols, kWT, kWT, kWK, kWK, true);
    if (!diag)
      copy_rows(pa + kWT * kWAs, kWAs, zj + k0, cols, kWT, kWT, kWK, kWK,
                true);
    else if (tid < kWK)
      ys[buf * kWK + tid] = k0 + tid < width ? yb[k0 + tid] : T(0);
  };

  T acc[2][2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = T(0);
  T zy_acc = T(0);
  for (int st = 0; st < kWStages - 1; ++st) {
    if (st < ksteps) load(st, st);
    cp_async_commit();
  }
  for (int kc = 0; kc < ksteps; ++kc) {
    const int buf = kc % kWStages;
    cp_async_wait<kWStages - 2>();
    __syncthreads();  // stage kc visible; every warp is done with kc − 1
    if (kc + kWStages - 1 < ksteps)
      load(kc + kWStages - 1, (kc + kWStages - 1) % kWStages);
    cp_async_commit();
    const T* pa = panels + buf * 2 * kWT * kWAs;
    const T* pb = diag ? pa : pa + kWT * kWAs;
#pragma unroll
    for (int ks = 0; ks < kWK / 16; ++ks)
      warp_mma(acc, pa + wr * 32 * kWAs + ks * 16, kWAs, 1,
               pb + wc * 16 * kWAs + ks * 16, 1, kWAs, lane);
    if (diag && tid < kWT) {
      const T* zr = pa + tid * kWAs;
      const T* yy = ys + buf * kWK;
#pragma unroll 8
      for (int c = 0; c < kWK; ++c) zy_acc += zr[c] * yy[c];
    }
  }

  T* gb = gram + static_cast<size_t>(b) * F * F;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ti * kWT + wr * 32 + m * 16 + g + (e >= 2 ? 8 : 0);
        const int j = tj * kWT + wc * 16 + n * 8 + 2 * t + (e & 1);
        if (i >= F || j >= F || (diag && i > j)) continue;
        T v = acc[m][n][e];
        if (accumulate) v = gb[static_cast<size_t>(i) * F + j] + v;
        gb[static_cast<size_t>(i) * F + j] = v;
        gb[static_cast<size_t>(j) * F + i] = v;
      }
  const int row = ti * kWT + tid;
  if (diag && tid < kWT && row < F) {
    T* out = zy + static_cast<size_t>(b) * F + row;
    *out = accumulate ? *out + zy_acc : zy_acc;
  }
}

// Every pass of `batch` problems walks N in chunks of `cols` columns: the
// Z launch, then the Gram launch, on one stream (chunk order).
template <typename T>
int launch_wide(const void* omega, const void* bias, const void* x,
                const void* y, const void* mask, void* gram, void* zy,
                void* work, int B, int F, int dim, int N, double scale,
                int batch, int cols, void* stream) {
  const long long f_pad = (F + kWT - 1) / kWT * kWT, nt = f_pad / kWT;
  if (B < 1 || F < 1 || dim < 1 || N < 1 || batch < 1 || batch > 65535 ||
      cols < kWT || cols % kWT != 0 || nt > 65535 ||
      nt * (nt + 1) / 2 > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      rff_gram_z_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(z_smem_bytes(sizeof(T))));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        rff_gram_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(wide_smem_bytes(sizeof(T))));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned tiles = static_cast<unsigned>(nt * (nt + 1) / 2);
  for (int b0 = 0; b0 < B; b0 += batch) {
    const int nb = B - b0 < batch ? B - b0 : batch;
    const size_t bf = static_cast<size_t>(b0) * F, bn = static_cast<size_t>(b0) * N;
    for (int c_base = 0; c_base < N; c_base += cols) {
      const int width = N - c_base < cols ? N - c_base : cols;
      rff_gram_z_kernel<T><<<dim3((width + kWT - 1) / kWT,
                                  static_cast<unsigned>(nt), nb),
                             kThreads, z_smem_bytes(sizeof(T)), st>>>(
          static_cast<const T*>(omega) + bf * dim,
          static_cast<const T*>(bias) + bf,
          static_cast<const T*>(x) + static_cast<size_t>(b0) * dim * N,
          static_cast<const T*>(mask) + bn, static_cast<T*>(work), F, dim, N,
          c_base, width, static_cast<int>(f_pad), cols,
          static_cast<T>(scale));
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
      rff_gram_wide_kernel<T><<<dim3(tiles, nb), kThreads,
                                wide_smem_bytes(sizeof(T)), st>>>(
          static_cast<const T*>(work), static_cast<const T*>(y) + bn,
          static_cast<T*>(gram) + bf * F, static_cast<T*>(zy) + bf, F, N,
          c_base, width, static_cast<int>(f_pad), cols, c_base > 0);
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// work: B·groups·slices·group_blocks·256 + B·slices·F_pad elements;
// counters: B·groups·cluster int32, zero on entry (one launch's use);
// resident: 1 keeps each block's Ω rows in shared memory for the launch;
// smem_bytes: dynamic shared memory per block, at least gram_smem_bytes.
int rff_gram_f64(const void* omega, const void* bias, const void* x,
                 const void* y, const void* mask, void* gram, void* zy,
                 void* work, void* counters, int B, int F, int dim, int N,
                 double scale, int cluster, int slices, int slice_cols,
                 int groups, int group_blocks, int resident, int smem_bytes,
                 void* stream) {
  return launch<double>(omega, bias, x, y, mask, gram, zy, work, counters, B,
                        F, dim, N, scale, cluster, slices, slice_cols, groups,
                        group_blocks, resident, smem_bytes, stream);
}

int rff_gram_f32(const void* omega, const void* bias, const void* x,
                 const void* y, const void* mask, void* gram, void* zy,
                 void* work, void* counters, int B, int F, int dim, int N,
                 double scale, int cluster, int slices, int slice_cols,
                 int groups, int group_blocks, int resident, int smem_bytes,
                 void* stream) {
  return launch<float>(omega, bias, x, y, mask, gram, zy, work, counters, B, F,
                       dim, N, scale, cluster, slices, slice_cols, groups,
                       group_blocks, resident, smem_bytes, stream);
}

// The wide route: work holds batch·F_pad·cols elements (F_pad = F rounded
// up to 64; cols a multiple of 64); no counters. gram [B, F, F], zy [B, F].
int rff_gram_wide_f64(const void* omega, const void* bias, const void* x,
                      const void* y, const void* mask, void* gram, void* zy,
                      void* work, int B, int F, int dim, int N, double scale,
                      int batch, int cols, void* stream) {
  return launch_wide<double>(omega, bias, x, y, mask, gram, zy, work, B, F,
                             dim, N, scale, batch, cols, stream);
}

int rff_gram_wide_f32(const void* omega, const void* bias, const void* x,
                      const void* y, const void* mask, void* gram, void* zy,
                      void* work, int B, int F, int dim, int N, double scale,
                      int batch, int cols, void* stream) {
  return launch_wide<float>(omega, bias, x, y, mask, gram, zy, work, B, F,
                            dim, N, scale, batch, cols, stream);
}

}  // extern "C"
