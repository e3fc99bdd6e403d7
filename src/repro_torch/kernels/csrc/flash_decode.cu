// Single-token decode attention: the Hopper counterpart of
// src/repro/kernels/decode_attention.py:73 flash_decode_pallas
// (_flash_decode_kernel), which the reference reaches through
// repro.kernels.ops.flash_decode. In the port every decode step of every
// attention layer runs it (repro_torch.models.layers.decode_attention,
// backend "cuda").
//
// For every (batch b, kv head kv) row and each of its G = H / K query
// heads g (query head h = kv·G + g):
//
//   out[b, h] = softmax_s(q[b, h] · k[b, s, kv] · dh^-0.5, s < len[row]) ·
//               v[b, s, kv]
//
// in f32, with the online-softmax state of the TPU kernel: a running max
// m and sum l per query head and an accumulator acc [G, dh], rescaled by
// α = exp(m_prev − m_new) per tile; masked scores are the finite −1e30 and
// the final divide is by max(l, 1e-30), as in the reference.
//
// Layout. The cache is read in place in the model's [B, S, K, dh] layout
// through the element strides of its batch and position axes (head stride
// dh, dh contiguous), so no transposed or padded copy of K and V is made
// per call; the TPU wrapper's [B·K, S, dh] transpose and its dh → 128 and
// S → block_s padding have no counterpart. q and out are [B, H, dh].
//
// Work. One block of 128 threads per row walks the positions in tiles of
// `rows` positions (rows = min(128, 4096 / dh): 16 KB of K and 16 KB of V
// a tile in f32, 64 positions at dh = 64). Each thread holds 8 float4 of
// the next K tile and 8 of the next V tile in registers, loaded with
// 16-byte loads (neighbouring threads on neighbouring addresses of one
// position's row) while the block computes on the current tile in shared
// memory: scores [G, rows], then one warp per query head for the max,
// the exponentials and the sum, then acc [G, dh] spread over the threads.
// The K tile's rows are padded by 4 floats so the float4 reads of the
// score loop fall on distinct banks.
//
// The loop stops at len: once a tile holds one valid position m is finite,
// and a fully masked later tile would give α = 1 and p = exp(−1e30 − m) = 0
// bit for bit, so the stale tail of the cache is never read. Positions
// ≥ len inside the last tile are neither loaded nor counted.
//
// Bound on the card: by bytes. K and V up to len are read once (B·K·len·dh
// ·4 B each); the work is 4·B·H·len·dh flops, ~4 flops a byte, far below
// the H100's ~20 f32 flops a byte. At B = 8, K = 16, dh = 64 and len =
// 32,768 that is 2.15 GB, ~0.64 ms at 3.35 TB/s. The design keeps one
// pass over the cache and overlaps the next tile's loads with the current
// tile's arithmetic; it does not split S across blocks, so only B·K blocks
// run (128 of 132 SMs at B = 8 for qwen1.5-0.5b, 16 at B = 1), and it uses
// neither TMA nor wgmma. Splitting S with a second combining pass is the
// next step.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileVec = 1024;                     // float4 of K per tile
constexpr int kVecPerThread = kTileVec / kThreads;  // 8
constexpr int kMaxRows = 128;
constexpr int kMaxSmem = 232448;                    // per block on sm_90
constexpr float kNegInf = -1e30f;

int tile_rows(int dh) {
  const int rows = 4 * kTileVec / dh;
  return rows < kMaxRows ? rows : kMaxRows;
}

size_t smem_bytes(int groups, int dh) {
  const int rows = tile_rows(dh);
  // K tile (padded rows), V tile, q, acc, scores, m, l, alpha
  const size_t floats = size_t(rows) * (dh + 4) + size_t(rows) * dh +
                        2 * size_t(groups) * dh + size_t(groups) * rows +
                        3 * size_t(groups);
  return floats * sizeof(float);
}

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* lens;
  float* out;
  long long k_sb, k_ss, v_sb, v_ss;  // element strides: batch, position
  int n_kv, groups, dh, rows;
  float scale;
};

__device__ inline float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ inline float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int dh = p.dh, G = p.groups, rows = p.rows;
  const int dv = dh / 4;        // float4 per position
  const int kpitch = dh + 4;    // padded K row, in floats
  float* ks = reinterpret_cast<float*>(smem4);  // [rows][dh + 4]
  float* vs = ks + rows * kpitch;               // [rows][dh]
  float* qs = vs + rows * dh;                   // [G][dh]
  float* acc = qs + G * dh;                     // [G][dh]
  float* sc = acc + G * dh;                     // [G][rows]
  float* m_s = sc + G * rows;                   // [G]
  float* l_s = m_s + G;                         // [G]
  float* a_s = l_s + G;                         // [G]

  const int row = blockIdx.x;  // b · n_kv + kv
  const int b = row / p.n_kv, kv = row % p.n_kv;
  const int len = p.lens[row];
  const int tid = threadIdx.x;
  const float* kbase = p.k + b * p.k_sb + (long long)kv * dh;
  const float* vbase = p.v + b * p.v_sb + (long long)kv * dh;
  const long long qoff = (long long)row * G * dh;

  for (int i = tid; i < G * dh; i += kThreads) {
    qs[i] = p.q[qoff + i];
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int tile_vec = rows * dv;
  float4 kr[kVecPerThread], vr[kVecPerThread];
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int idx = tid + i * kThreads;
      float4 kz = make_float4(0.f, 0.f, 0.f, 0.f), vz = kz;
      const int j = idx / dv, c = idx % dv;
      if (idx < tile_vec && t0 + j < len) {
        const long long pos = t0 + j;
        kz = __ldg(reinterpret_cast<const float4*>(kbase + pos * p.k_ss) + c);
        vz = __ldg(reinterpret_cast<const float4*>(vbase + pos * p.v_ss) + c);
      }
      kr[i] = kz;
      vr[i] = vz;
    }
  };

  const int n_tiles = (len + rows - 1) / rows;
  load(0);
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * rows;
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < tile_vec) {
        const int j = idx / dv, c = idx % dv;
        reinterpret_cast<float4*>(ks + j * kpitch)[c] = kr[i];
        reinterpret_cast<float4*>(vs + j * dh)[c] = vr[i];
      }
    }
    __syncthreads();
    if (t + 1 < n_tiles) load(t0 + rows);  // in flight during the tile

    // scores [G, rows]
    for (int idx = tid; idx < G * rows; idx += kThreads) {
      const int g = idx / rows, j = idx % rows;
      const float4* qv = reinterpret_cast<const float4*>(qs + g * dh);
      const float4* kv4 = reinterpret_cast<const float4*>(ks + j * kpitch);
      float s = 0.f;
      for (int c = 0; c < dv; ++c) {
        const float4 a = qv[c], w = kv4[c];
        s = fmaf(a.x, w.x, s);
        s = fmaf(a.y, w.y, s);
        s = fmaf(a.z, w.z, s);
        s = fmaf(a.w, w.w, s);
      }
      sc[idx] = t0 + j < len ? s * p.scale : kNegInf;
    }
    __syncthreads();

    // online-softmax statistics: one warp per query head
    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < G; g += kThreads / 32) {
      float* sg = sc + g * rows;
      float mx = kNegInf;
      for (int j = lane; j < rows; j += 32) mx = fmaxf(mx, sg[j]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < rows; j += 32) {
        const float e = expf(sg[j] - m_new);
        sg[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc · α + p · V
    for (int idx = tid; idx < G * dh; idx += kThreads) {
      const int g = idx / dh, d = idx % dh;
      const float* pg = sc + g * rows;
      float a = 0.f;
      for (int j = 0; j < rows; ++j) a = fmaf(pg[j], vs[j * dh + d], a);
      acc[idx] = acc[idx] * a_s[g] + a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * dh; idx += kThreads)
    p.out[qoff + idx] = acc[idx] / fmaxf(l_s[idx / dh], 1e-30f);
}

}  // namespace

extern "C" {

// q [B, K·G, dh] and out contiguous; k/v at element strides (k_sb, k_ss) /
// (v_sb, v_ss) over batch and position, head stride dh, dh contiguous,
// 16-byte aligned; lens [B·K] int32 in [1, S]. Launches on `stream`.
int flash_decode_f32(const void* q, const void* k, const void* v,
                     const void* lens, void* out, long long k_sb,
                     long long k_ss, long long v_sb, long long v_ss, int batch,
                     int n_kv, int groups, int dh, double scale,
                     void* stream) {
  if (batch <= 0 || n_kv <= 0 || groups <= 0 || dh <= 0 || dh % 4 ||
      dh > 256)
    return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(groups, dh);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
  }
  Params prm;
  prm.q = static_cast<const float*>(q);
  prm.k = static_cast<const float*>(k);
  prm.v = static_cast<const float*>(v);
  prm.lens = static_cast<const int*>(lens);
  prm.out = static_cast<float*>(out);
  prm.k_sb = k_sb;
  prm.k_ss = k_ss;
  prm.v_sb = v_sb;
  prm.v_ss = v_ss;
  prm.n_kv = n_kv;
  prm.groups = groups;
  prm.dh = dh;
  prm.rows = tile_rows(dh);
  prm.scale = float(scale);
  flash_decode_kernel<<<batch * n_kv, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(prm);
  return int(cudaGetLastError());
}

}  // extern "C"
