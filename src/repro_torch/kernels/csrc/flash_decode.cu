// Single-token decode attention: the Hopper counterpart of
// src/repro/kernels/decode_attention.py:73 flash_decode_pallas
// (_flash_decode_kernel, pallas_call at :89), which the reference reaches
// through repro.kernels.ops.flash_decode. In the port every decode step of
// every attention layer runs it (repro_torch.models.layers.decode_attention,
// backend "cuda").
//
// For every (batch b, kv head kv) row and each of its G = H / K query
// heads g (query head h = kv·G + g):
//
//   out[b, h] = softmax_s(q[b, h] · k[b, s, kv] · dh^-0.5, s < len[row]) ·
//               v[b, s, kv]
//
// in f32, the function of the TPU kernel: masked positions count as the
// finite score −1e30 (they add exactly 0 once one position is valid) and
// the final divide is by max(l, 1e-30). No position at or past len is
// read, so the stale tail of the cache changes no bit of the output.
//
// Two entries: flash_decode_f32 (f32 q, K, V, out) and flash_decode_bf16
// (bf16 q, K, V, out), as the reference's kernel takes q.dtype. The bf16
// ring stages the cache's bf16 bytes as they are (a 16-byte copy is 8
// values) and each lane widens its 4 values to f32 in registers; scores,
// m, l, acc and the cross-chunk partials stay f32 in both, and the bf16
// output is rounded once, at the end.
//
// Bound on the card: by bytes. K and V up to len are read once
// (B·K·len·dh·itemsize B each) against 4·B·H·len·dh flops, ~1 flop a byte
// at G = 1 in f32 (2 in bf16), far below the H100's ~20 f32 flops a byte.
// At B = 8, K = 16, dh = 64, len = 32,768 that is 2.15 GB in f32 (0.64 ms
// at 3.35 TB/s), half in bf16; at B = 1 it is 268 MB (0.080 ms) in f32
// over only 16 rows, so the rows alone cannot fill 132 SMs.
//
// Split. Each row's positions are cut into chunks of `chunk` positions
// (kernels/decode_attention.py::decode_plan: 256 KB of K and V, 512
// positions at dh 64), a function of dh alone, never of S or len: a view of
// any length, the int8 path's slice to len and a replayed CUDA graph with
// new lengths all cut the same chunks and so give the same bits. The grid
// is (rows · head blocks, ⌈S / chunk⌉); a block whose chunk starts at or
// past its row's len (read on the device) exits at once. At B = 1, S =
// 32,768 that is 1,024 blocks, ~3.9 waves of two blocks an SM.
//
// Ring. A block of 256 threads streams its chunk through a ring of 3–4
// stages in shared memory (decode_plan's `stages`), each stage a tile of
// 32·ppg positions of K and of V filled by cp.async (16-byte copies through
// L2 only, each thread at offsets it computes once) with one commit group
// per tile, q joining the first; two or three tiles are in flight while
// one is computed, behind one barrier a tile.
//
// Scores without a block barrier. Eight lanes take a position (a lane
// group; 32 groups), each lane a slice of dh (float4 columns sub, sub + 8,
// …), and sum q·k with three shuffles, so G = 1 (qwen1.5-0.5b) keeps every
// lane busy; a group takes ppg = 2 positions of a tile where a 64-position
// stage fits 32 KB (dh ≤ 64), so two score chains overlap. Each group keeps
// its own online-softmax state per query head (m, l and its slice of acc),
// in base 2 (scores times log2 e, every exponential one exp2f), updated
// with one exponential a position: the larger of m and s becomes the new
// max, so one of the two factors is exactly 1. At the end of the chunk the
// 32 states merge in a fixed tree: the groups of a warp by shuffles, then
// the 8 warps through shared memory in warp order.
//
// Combine. A row with one active chunk (len ≤ chunk: the serving cache at
// S ≤ 512) writes out directly. Otherwise every active chunk writes its
// partial (m, l, acc[dh]) per head to the workspace and takes a ticket
// from its row's counter with atomicInc after one fence, which wraps the
// counter back to 0 at the last ticket; the block that draws the last
// ticket merges the row's partials: R = 256 / (heads · dh) threads a
// column, thread r folding chunks r, r + R, … in order with a running max,
// eight partials in flight, then the R states in order of r. That order is
// fixed whichever block combines, so every call and every graph replay
// gives the same bits, and the counter table is left zeroed for the next
// call.
//
// Heads. A block takes up to 4 query heads of its row (head_block ∈ {1, 2,
// 4}); G > 4 runs ⌈G / 4⌉ head blocks, adjacent in the grid, each
// streaming the row's K and V.
//
// What holds it back (PERF.md §6): with many chunks in flight it streams
// near the card's practical rate; with few rows (one long request) a fixed
// latency stays: a launch's first loads, the last blocks, each streaming
// alone behind its ring's two tiles in flight, and the rows' merges.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                   // lanes per position
constexpr int kLaneGroups = kThreads / kLanes;
constexpr int kWarps = kThreads / 32;
constexpr int kCombineBatch = 8;            // partials in flight a thread
constexpr int kMaxPPG = 2;                  // positions a lane group a tile
constexpr int kMaxSmem = 232448;            // per block on sm_90
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

size_t smem_bytes(int ppg, int stages, int head_block, int dh, int item) {
  // ring [stages][K, V][tile][dh], q [head_block][dh] in the operands'
  // type; tile = 32 · ppg
  return (size_t(stages) * 2 * (ppg * kLaneGroups) * dh +
          size_t(head_block) * dh) * size_t(item);
}

// 4 values of a row from shared memory, widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const int* lens;
  T* out;
  float* ws;            // partials [rows, chunks, G, 2 + dh]
  unsigned* counters;   // [rows · head blocks], zero between calls
  long long k_sb, k_ss, v_sb, v_ss;  // element strides: batch, position
  int n_kv, groups, dh, chunk, chunks, stages, head_blocks, ppg;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until the oldest of the ring's in-flight tiles has landed: at most
// stages − 2 groups pending (stages 3 or 4).
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages == 4)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 scale_add(float4 a, float alpha, float p,
                                            float4 v) {
  return make_float4(fmaf(p, v.x, a.x * alpha), fmaf(p, v.y, a.y * alpha),
                     fmaf(p, v.z, a.z * alpha), fmaf(p, v.w, a.w * alpha));
}

__device__ __forceinline__ float4 shfl_xor4(float4 a, int off) {
  return make_float4(__shfl_xor_sync(kFull, a.x, off),
                     __shfl_xor_sync(kFull, a.y, off),
                     __shfl_xor_sync(kFull, a.z, off),
                     __shfl_xor_sync(kFull, a.w, off));
}

// T: the operands' type (float, bf16); NV: 4-value columns a lane holds
// (⌈dh / 32⌉ rounded up to 1, 2, 4, 8); GB: query heads a block takes.
template <typename T, int NV, int GB>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Params<T> p) {
  extern __shared__ float4 smem4[];
  constexpr int kVec = 16 / sizeof(T);  // values a 16-byte copy moves
  __shared__ int is_last;
  const int hb = p.head_blocks;
  const int row = blockIdx.x / hb, hx = blockIdx.x % hb;
  const int chunk_id = blockIdx.y;
  const int len = p.lens[row];
  const int start = chunk_id * p.chunk;
  if (start >= len) return;

  const int dh = p.dh, dv = dh / 4, dc = dh / kVec, G = p.groups;
  const int g0 = hx * GB;
  const int ng = min(GB, G - g0);
  const int end = min(start + p.chunk, len);
  const int ppg = p.ppg;
  const int tile = ppg * kLaneGroups;  // positions per ring stage
  const int n_tiles = (end - start + tile - 1) / tile;
  const int n_active = (len + p.chunk - 1) / p.chunk;
  const int stage = 2 * tile * dh;      // K tile, then V tile, in values
  T* ring = reinterpret_cast<T*>(smem4);     // [stages][2][tile][dh]
  T* qs = ring + p.stages * stage;           // [GB][dh]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / kLanes, sub = tid % kLanes;
  const int b = row / p.n_kv, kv = row % p.n_kv;
  const T* kbase = p.k + b * p.k_sb + (long long)kv * dh;
  const T* vbase = p.v + b * p.v_sb + (long long)kv * dh;
  const long long qrow = ((long long)row * G + g0) * dh;

  // q joins the first tile's commit group
  for (int i = tid; i < ng * dc; i += kThreads)
    cp_async16(qs + kVec * i, p.q + qrow + kVec * i);

  // This thread's copies of a tile: 16-byte copy tid + 256·r of its K and
  // V rows (tile·dc / kThreads = ppg·dh·itemsize / 128 ≤ ppg·NV of them),
  // at fixed offsets from the tile's first position; a copy past the tile
  // never passes `end`.
  int cj[kMaxPPG * NV];
  long long ko[kMaxPPG * NV], vo[kMaxPPG * NV];
#pragma unroll
  for (int r = 0; r < kMaxPPG * NV; ++r) {
    const int idx = tid + kThreads * r;
    const int j = idx / dc, col = idx - j * dc;
    cj[r] = idx < tile * dc ? j : p.chunk;
    ko[r] = j * p.k_ss + kVec * col;
    vo[r] = j * p.v_ss + kVec * col;
  }
  auto load = [&](int t) {
    T* dst = ring + (t % p.stages) * stage;
    const int base = start + t * tile;
    const T* kt = kbase + base * p.k_ss;
    const T* vt = vbase + base * p.v_ss;
#pragma unroll
    for (int r = 0; r < kMaxPPG * NV; ++r) {
      if (base + cj[r] < end) {
        const int idx = tid + kThreads * r;
        cp_async16(dst + kVec * idx, kt + ko[r]);
        cp_async16(dst + tile * dh + kVec * idx, vt + vo[r]);
      }
    }
  };

  const int ahead = p.stages - 1;
  for (int t = 0; t < ahead; ++t) {
    if (t < n_tiles) load(t);
    cp_async_commit();
  }

  // scores in base 2: s·log2(e), so every exponential is one exp2f
  const float scale2 = p.scale * 1.4426950408889634f;
  constexpr bool kQInRegs = NV * GB <= 8;
  float4 qr[GB][NV];
  float m[GB], l[GB];
  float4 acc[GB][NV];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[g][i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_ring(p.stages);
    __syncthreads();  // tile t landed for all; tile t − 1's stage is free
    if (t + ahead < n_tiles) load(t + ahead);
    cp_async_commit();

    if (kQInRegs && t == 0) {
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int col = sub + kLanes * i;
          qr[g][i] = g < ng && col < dv ? load4(qs + g * dh + 4 * col)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
    // this lane group's positions of the tile: grp, grp + 32
    const T* st = ring + (t % p.stages) * stage;
    bool valid[kMaxPPG];
    float4 kr[kMaxPPG][NV], vr[kMaxPPG][NV];
#pragma unroll
    for (int pp = 0; pp < kMaxPPG; ++pp) {
      const int j = grp + kLaneGroups * pp;
      valid[pp] = pp < ppg && start + t * tile + j < end;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int col = sub + kLanes * i;
        const bool in = pp < ppg && col < dv;
        kr[pp][i] = in ? load4(st + j * dh + 4 * col)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        vr[pp][i] = in ? load4(st + (tile + j) * dh + 4 * col)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= ng) break;
      float s[kMaxPPG];
#pragma unroll
      for (int pp = 0; pp < kMaxPPG; ++pp) {
        s[pp] = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int col = sub + kLanes * i;
          if (col < dv) {
            const float4 a = kQInRegs ? qr[g][i] : load4(qs + g * dh + 4 * col);
            s[pp] = fmaf(a.x, kr[pp][i].x, s[pp]);
            s[pp] = fmaf(a.y, kr[pp][i].y, s[pp]);
            s[pp] = fmaf(a.z, kr[pp][i].z, s[pp]);
            s[pp] = fmaf(a.w, kr[pp][i].w, s[pp]);
          }
        }
      }
#pragma unroll
      for (int pp = 0; pp < kMaxPPG; ++pp) {
        if (pp >= ppg) break;
        s[pp] += __shfl_xor_sync(kFull, s[pp], 1);
        s[pp] += __shfl_xor_sync(kFull, s[pp], 2);
        s[pp] += __shfl_xor_sync(kFull, s[pp], 4);
        s[pp] *= scale2;
      }
#pragma unroll
      for (int pp = 0; pp < kMaxPPG; ++pp) {
        if (!valid[pp]) continue;
        // one exponential: the larger of m and s becomes the new max, so
        // one of α = 2^{m − m'} and p = 2^{s − m'} is exactly 1
        const bool up = s[pp] > m[g];
        const float e = exp2f(up ? m[g] - s[pp] : s[pp] - m[g]);
        const float alpha = up ? e : 1.f, pe = up ? 1.f : e;
        l[g] = fmaf(l[g], alpha, pe);
#pragma unroll
        for (int i = 0; i < NV; ++i)
          acc[g][i] = scale_add(acc[g][i], alpha, pe, vr[pp][i]);
        m[g] = up ? s[pp] : m[g];
      }
    }
  }

  // merge the warp's four lane groups (columns match across xor 8, 16)
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= ng) break;
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float w1 = exp2f(m[g] - mx), w2 = exp2f(mo - mx);
      l[g] = fmaf(lo, w2, l[g] * w1);
#pragma unroll
      for (int i = 0; i < NV; ++i)
        acc[g][i] = scale_add(acc[g][i], w1, w2, shfl_xor4(acc[g][i], off));
      m[g] = mx;
    }
  }

  // then the 8 warps, in warp order, through the (now idle) ring
  cp_async_wait_all();
  __syncthreads();
  const int rec = 2 + dh;
  float* red = reinterpret_cast<float*>(ring);  // [warps][GB][2 + dh]
  if (lane < kLanes) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= ng) break;
      float* r = red + (warp * GB + g) * rec;
      if (sub == 0) {
        r[0] = m[g];
        r[1] = l[g];
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int col = sub + kLanes * i;
        if (col < dv) {
          r[2 + 4 * col] = acc[g][i].x;
          r[3 + 4 * col] = acc[g][i].y;
          r[4 + 4 * col] = acc[g][i].z;
          r[5 + 4 * col] = acc[g][i].w;
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < ng * dh; idx += kThreads) {
    const int g = idx / dh, d = idx - g * dh;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red[(w * GB + g) * rec]);
    float sum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* r = red + (w * GB + g) * rec;
      const float e = exp2f(r[0] - mx);
      sum = fmaf(r[1], e, sum);
      a = fmaf(r[2 + d], e, a);
    }
    if (n_active == 1) {
      store(p.out + qrow + idx, a / fmaxf(sum, 1e-30f));
    } else {
      float* part =
          p.ws + (((long long)row * p.chunks + chunk_id) * G + g0 + g) * rec;
      if (d == 0) {
        part[0] = mx;
        part[1] = sum;
      }
      part[2 + d] = a;
    }
  }
  if (n_active == 1) return;

  // the last of the row's active chunks to finish merges the partials
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // cumulative: the block's partials, then the ticket
    const unsigned ticket =
        atomicInc(p.counters + blockIdx.x, unsigned(n_active - 1));
    is_last = ticket == unsigned(n_active - 1);
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // Partials read through L2 (__ldcg): other SMs wrote them. R threads a
  // column, thread r merging chunks r, r + R, … in order with a running
  // max, eight loads in flight; then the R states in order of r. The
  // order is fixed, so every call gives the same bits.
  const long long stride = (long long)G * rec;  // one chunk's records
  const float* part0 = p.ws + ((long long)row * p.chunks * G + g0) * rec;
  const int cols = ng * dh;
  const int R = cols < kThreads ? kThreads / cols : 1;
  float* states = reinterpret_cast<float*>(ring);  // [R][cols][m, l, acc]
  for (int idx = tid; idx < R * cols; idx += kThreads) {
    const int r = idx / cols, col = idx - r * cols;
    const int g = col / dh, d = col - g * dh;
    const float* part = part0 + g * rec;
    float mr = kNegInf, sum = 0.f, a = 0.f;
    for (int c0 = r; c0 < n_active; c0 += kCombineBatch * R) {
      float mc[kCombineBatch], lc[kCombineBatch], ac[kCombineBatch];
#pragma unroll
      for (int u = 0; u < kCombineBatch; ++u) {
        const int c = c0 + u * R;
        const float* rp = part + c * stride;
        const bool in = c < n_active;
        mc[u] = in ? __ldcg(rp) : kNegInf;
        lc[u] = in ? __ldcg(rp + 1) : 0.f;
        ac[u] = in ? __ldcg(rp + 2 + d) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kCombineBatch; ++u) {
        const float mx = fmaxf(mr, mc[u]);
        const float w1 = exp2f(mr - mx), w2 = exp2f(mc[u] - mx);
        sum = fmaf(lc[u], w2, sum * w1);
        a = fmaf(ac[u], w2, a * w1);
        mr = mx;
      }
    }
    if (R == 1) {
      store(p.out + qrow + col, a / fmaxf(sum, 1e-30f));
    } else {
      states[3 * idx] = mr;
      states[3 * idx + 1] = sum;
      states[3 * idx + 2] = a;
    }
  }
  if (R == 1) return;
  __syncthreads();
  for (int col = tid; col < cols; col += kThreads) {
    float mx = kNegInf;
    for (int r = 0; r < R; ++r) mx = fmaxf(mx, states[3 * (r * cols + col)]);
    float sum = 0.f, a = 0.f;
    for (int r = 0; r < R; ++r) {
      const float* st = states + 3 * (r * cols + col);
      const float e = exp2f(st[0] - mx);
      sum = fmaf(st[1], e, sum);
      a = fmaf(st[2], e, a);
    }
    store(p.out + qrow + col, a / fmaxf(sum, 1e-30f));
  }
}

template <typename T, int NV, int GB>
cudaError_t launch(const Params<T>& prm, dim3 grid, size_t smem,
                   cudaStream_t stream) {
  auto kernel = flash_decode_kernel<T, NV, GB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T, int NV>
cudaError_t launch_heads(const Params<T>& prm, int head_block, dim3 grid,
                         size_t smem, cudaStream_t stream) {
  switch (head_block) {
    case 1: return launch<T, NV, 1>(prm, grid, smem, stream);
    case 2: return launch<T, NV, 2>(prm, grid, smem, stream);
    case 4: return launch<T, NV, 4>(prm, grid, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* lens,
        void* out, void* ws, void* counters, long long k_sb, long long k_ss,
        long long v_sb, long long v_ss, int batch, int n_kv, int groups,
        int dh, int ppg, int chunk, int chunks, int stages, int head_block,
        double scale, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (batch <= 0 || n_kv <= 0 || groups <= 0 || dh <= 0 || dh % kVec ||
      dh > 256 || ppg < 1 || ppg > kMaxPPG || chunk <= 0 ||
      chunk % (ppg * kLaneGroups) || chunks <= 0 || chunks > 65535 ||
      (stages != 3 && stages != 4))
    return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(ppg, stages, head_block, dh, sizeof(T));
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  const int head_blocks = (groups + head_block - 1) / head_block;
  const long long blocks_x = (long long)batch * n_kv * head_blocks;
  if (blocks_x > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  Params<T> prm;
  prm.q = static_cast<const T*>(q);
  prm.k = static_cast<const T*>(k);
  prm.v = static_cast<const T*>(v);
  prm.lens = static_cast<const int*>(lens);
  prm.out = static_cast<T*>(out);
  prm.ws = static_cast<float*>(ws);
  prm.counters = static_cast<unsigned*>(counters);
  prm.k_sb = k_sb;
  prm.k_ss = k_ss;
  prm.v_sb = v_sb;
  prm.v_ss = v_ss;
  prm.n_kv = n_kv;
  prm.groups = groups;
  prm.dh = dh;
  prm.chunk = chunk;
  prm.chunks = chunks;
  prm.stages = stages;
  prm.head_blocks = head_blocks;
  prm.ppg = ppg;
  prm.scale = float(scale);
  const dim3 grid(static_cast<unsigned>(blocks_x),
                  static_cast<unsigned>(chunks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv4 = (dh / 4 + kLanes - 1) / kLanes;  // 4-value columns a lane
  const int hb = head_block;
  if (nv4 <= 1) return int(launch_heads<T, 1>(prm, hb, grid, smem, st));
  if (nv4 <= 2) return int(launch_heads<T, 2>(prm, hb, grid, smem, st));
  if (nv4 <= 4) return int(launch_heads<T, 4>(prm, hb, grid, smem, st));
  return int(launch_heads<T, 8>(prm, hb, grid, smem, st));
}

}  // namespace

extern "C" {

// q [B, K·G, dh] and out contiguous; k/v at element strides (k_sb, k_ss) /
// (v_sb, v_ss) over batch and position, head stride dh, dh contiguous,
// 16-byte aligned; lens [B·K] int32 in [1, chunks·chunk]; ws at least
// B·K·chunks·G·(2 + dh) floats; counters B·K·⌈G / head_block⌉ zeroed
// uint32 (the kernel leaves them zeroed). ppg 1 or 2 (a tile of 32·ppg
// positions), chunk a multiple of the tile, stages 3 or 4, head_block 1, 2
// or 4 (kernels/decode_attention.py::decode_plan). dh a multiple of the
// values one 16-byte copy moves: 4 in f32, 8 in bf16. Launches on `stream`.
int flash_decode_f32(const void* q, const void* k, const void* v,
                     const void* lens, void* out, void* ws, void* counters,
                     long long k_sb, long long k_ss, long long v_sb,
                     long long v_ss, int batch, int n_kv, int groups, int dh,
                     int ppg, int chunk, int chunks, int stages,
                     int head_block, double scale, void* stream) {
  return run<float>(q, k, v, lens, out, ws, counters, k_sb, k_ss, v_sb,
                    v_ss, batch, n_kv, groups, dh, ppg, chunk, chunks, stages,
                    head_block, scale, stream);
}

int flash_decode_bf16(const void* q, const void* k, const void* v,
                      const void* lens, void* out, void* ws, void* counters,
                      long long k_sb, long long k_ss, long long v_sb,
                      long long v_ss, int batch, int n_kv, int groups, int dh,
                      int ppg, int chunk, int chunks, int stages,
                      int head_block, double scale, void* stream) {
  return run<__nv_bfloat16>(q, k, v, lens, out, ws, counters, k_sb, k_ss,
                            v_sb, v_ss, batch, n_kv, groups, dh, ppg, chunk,
                            chunks, stages, head_block, scale, stream);
}

// Dynamic shared memory of a block, as the launcher computes it, for
// operands of `itemsize` bytes (repro_torch.analysis.smem checks the same
// formula before any launch).
int flash_decode_smem_bytes(int ppg, int stages, int head_block, int dh,
                            int itemsize) {
  return int(smem_bytes(ppg, stages, head_block, dh, itemsize));
}

}  // extern "C"
