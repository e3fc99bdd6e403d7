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
// Two entries: flash_decode_f32 (f32 q, K, V, out; flash_decode_kernel)
// and flash_decode_bf16 (bf16 q, K, V, out; flash_decode_bf16_kernel, its
// own design, below), as the reference's kernel takes q.dtype. Scores, m,
// l, acc and the cross-chunk partials are f32 in both, and the bf16 output
// is rounded once, at the end.
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
// What holds the f32 route back (PERF.md §6): with many chunks in flight
// it streams near the card's practical rate; with few rows (one long
// request) a fixed latency stays: a launch's first loads, the last blocks,
// each streaming alone behind its ring's two tiles in flight, and the
// rows' merges.
//
// The bf16 route (flash_decode_bf16_kernel): the same function, the same
// partials and ticket, its own plan (decode_plan(itemsize=2)):
// - Lanes of 16 bytes: a lane takes 8 contiguous values of a column, so at
//   dh 64 a lane group of 8 covers a position's row and a quarter-warp
//   reads one contiguous 128-byte run (no bank conflict; one shared load of
//   K and one of V a lane a position). A lane holds ⌈dh / 64⌉ such columns
//   and a lane group takes 4 / that many positions of a stage, so four
//   scores are in flight at dh 64, folded into the state in one step.
// - A producer warp and an mbarrier ring: 288 threads, eight consumer
//   warps (32 lane groups) and one producer warp. The producer loads each
//   whole tile (128 positions at dh 64) as one box of a TMA tensor map
//   over the [B, S, K, dh] cache an operand, and a chunk's short last tile
//   (at len) with one cp.async.bulk a row, so no row at or past len is
//   read; both complete on the stage's full mbarrier (expect_tx). Consumers
//   take their values into registers and release the stage on its empty
//   mbarrier (one arrival a warp): no block-wide barrier a tile. 2 stages
//   of 32 KB.
// - The split: persistent blocks, as many as the card holds at once (2 an
//   SM), walk the units (chunk, row · head block), chunk first; a chunk is
//   16 tiles (2,048 positions at dh 64, 512 KB of K and V), and a unit's
//   query rows ride with its first tile. One long request (B 1, S 32,768)
//   is 256 units, one round of the 264 blocks; B 8 is 7.76 units a block;
//   the serving cache (128 rows at S 512) 128 units, one an SM.
// - The merge: the ticket is one acq_rel increment at gpu scope after the
//   block barrier (no full fence); the row's last block stages the row's
//   partials in its merge area, a window of whole chunks at a time
//   (decode_plan's merge_window: 131 at dh 64), takes M = the largest m_c
//   (exact in any order), then folds 2^{m_c − M}·l_c and 2^{m_c − M}·acc_c
//   in chunk order, one thread a column: flash_decode_split_reference's
//   order, fixed by len alone.
// - A launch whose K and V views hold more bytes than L2 loads its tiles
//   evict-first; a cache that fits in L2 keeps the normal policy.
//
// What holds the bf16 route back (PERF.md §6): a block's tensor copies,
// not its arithmetic or its bytes in flight: with no arithmetic at all it
// ran no faster, with one block an SM it ran at ~0.55× whatever the ring's
// depth, and larger boxes and units ran faster; so each unit's epilogue
// and the copies a block keeps in flight set the rate, 90–92% of the bound
// at B 8.
#include <cuda.h>
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

// ---------------------------------------------------------------- bf16
// The bf16 route: its own kernel, so the f32 instantiation above is
// compiled exactly as before.
using bf16 = __nv_bfloat16;

constexpr int kBConsumerWarps = 8;
constexpr int kBConsumers = 32 * kBConsumerWarps;   // 256
constexpr int kBThreads = kBConsumers + 32;         // and one producer warp
constexpr int kBGroups = kBConsumers / kLanes;      // 32 lane groups
constexpr int kBMaxStages = 8;
constexpr int kBMergeBytes = 34816;  // the merge area, at least

// The merge area: the warps' states of a chunk [warps][head_block][2 + dh]
// and, for a row's last block, windows of the row's partials.
__host__ __device__ size_t bf16_merge_bytes(int head_block, int dh) {
  const size_t states =
      size_t(kBConsumerWarps) * head_block * (2 + dh) * sizeof(float);
  return states > size_t(kBMergeBytes) ? states : size_t(kBMergeBytes);
}

// ring [stages][K, V][16·ppg][dh] bf16, q slots [stages][head_block][dh]
// bf16, q [head_block][dh] f32, the merge area, the mbarriers full[stages]
// and empty[stages], the last-block flag, and 128 bytes to align the ring
size_t bf16_smem_bytes(int ppg, int stages, int head_block, int dh) {
  return 128 + size_t(stages) * 2 * (ppg * kBGroups) * dh * sizeof(bf16) +
         size_t(stages) * head_block * dh * sizeof(bf16) +
         size_t(head_block) * dh * sizeof(float) +
         bf16_merge_bytes(head_block, dh) + size_t(stages) * 16 + 16;
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrive once, expecting `bytes` more from bulk copies.
__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n"
      ::"r"(smem_u32(bar)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.release.cta.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the phase of `parity` to complete; trap rather than hang if it
// never does.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned addr = smem_u32(bar);
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// `bytes` of global memory at `src` into shared memory at `dst` by the
// copy engine, completed on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The tile at coordinates (0, kv, pos, b) of the [B, S, K, dh] cache
// described by `map` (a box of one kv head's rows) into shared memory at
// `dst`, completed on `bar`, under the L2 eviction `policy`.
__device__ __forceinline__ void tile_load(void* dst, const CUtensorMap* map,
                                          int kv, int pos, int b,
                                          unsigned long long* bar,
                                          unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes.L2::cache_hint [%0], [%1, {%2, %3, %4, %5}], [%6], "
      "%7;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(0), "r"(kv),
      "r"(pos), "r"(b), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// An L2 policy: evict first (a launch that streams more than L2 holds) or
// normal (a cache that stays in L2 from one launch to the next).
__device__ __forceinline__ unsigned long long l2_policy(bool evict_first) {
  unsigned long long policy;
  if (evict_first)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
  else
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
                 : "=l"(policy));
  return policy;
}

// The row's ticket, after the block barrier that follows the partial's
// writes: an acq_rel increment at gpu scope releases this block's partial
// (cumulative over the barrier) and acquires every earlier block's; it
// wraps to 0 at `last`, so the counter is 0 again for the next launch.
__device__ __forceinline__ unsigned ticket(unsigned* counter, unsigned last) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(counter), "r"(last)
               : "memory");
  return old;
}

// the consumer warps alone (the producer warp has left)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kBConsumers) : "memory");
}

// 8 bf16 values (16 bytes) widened to f32: a bf16 is the top half of its
// f32
__device__ __forceinline__ void widen8(const uint4 raw, float (&out)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    out[2 * e] = __uint_as_float(w[e] << 16);
    out[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

template <int GB>
__device__ __forceinline__ float pick(const float (&a)[GB], int g) {
  float x = a[0];
#pragma unroll
  for (int i = 1; i < GB; ++i) x = g == i ? a[i] : x;
  return x;
}

// The row's last block: M = the largest m_c (exact in any order), then
// Σ_c 2^{m_c − M}·l_c and Σ_c 2^{m_c − M}·acc_c folded in chunk order, one
// thread a column, out of windows of whole chunks' records staged in the
// merge area (read through L2: other SMs wrote them); `mred` [warps][GB]
// is scratch. The order is fixed by len, so every call gives the same
// bits. Ends with a consumer barrier.
template <int GB, int kCols>
__device__ void merge_row(const Params<bf16>& p, float* merge,
                          int merge_floats, float* mred, int row, int g0,
                          int ng, int n_active, long long qrow) {
  const int dh = p.dh, G = p.groups, rec = 2 + dh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = ng * rec;                     // floats of a chunk
  const long long stride = (long long)G * rec;  // a chunk's records
  const float* part0 = p.ws + ((long long)row * p.chunks * G + g0) * rec;
  float* win = merge;
  const int cap = max(1, merge_floats / per);  // chunks a window
  const int w0 = min(n_active, cap);
  float mloc[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) mloc[g] = kNegInf;
  for (int idx = tid; idx < w0 * per; idx += kBConsumers) {
    const int c = idx / per, o = idx - c * per;
    const float x = __ldcg(part0 + c * stride + o);
    win[idx] = x;
    if (o % rec == 0) {
#pragma unroll
      for (int g = 0; g < GB; ++g)
        if (g == o / rec) mloc[g] = fmaxf(mloc[g], x);
    }
  }
  for (int idx = tid; idx < (n_active - w0) * ng; idx += kBConsumers) {
    const int c = w0 + idx / ng, gi = idx % ng;
    const float x = __ldcg(part0 + c * stride + gi * rec);
#pragma unroll
    for (int g = 0; g < GB; ++g)
      if (g == gi) mloc[g] = fmaxf(mloc[g], x);
  }
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mloc[g] = fmaxf(mloc[g], __shfl_xor_sync(kFull, mloc[g], off));
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) mred[warp * GB + g] = mloc[g];
  }
  consumer_sync();
  float big[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    big[g] = mred[g];
    for (int w = 1; w < kBConsumerWarps; ++w)
      big[g] = fmaxf(big[g], mred[w * GB + g]);
  }
  const int cols = ng * dh;
  float ls[kCols], as[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) ls[k] = as[k] = 0.f;
  for (int c0 = 0; c0 < n_active; c0 += cap) {
    const int wn = min(cap, n_active - c0);
    if (c0 > 0) {
      consumer_sync();  // the previous window is folded
      for (int idx = tid; idx < wn * per; idx += kBConsumers) {
        const int c = idx / per, o = idx - c * per;
        win[idx] = __ldcg(part0 + (c0 + c) * stride + o);
      }
      consumer_sync();
    }
    // each staged m becomes its weight 2^{m_c − M}
    for (int idx = tid; idx < wn * ng; idx += kBConsumers) {
      const int c = idx / ng, g = idx % ng;
      float* r = win + c * per + g * rec;
      r[0] = exp2f(r[0] - pick<GB>(big, g));
    }
    consumer_sync();
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int col = tid + kBConsumers * k;
      if (col < cols) {
        const int g = col / dh, d = col - g * dh;
        const float* r = win + g * rec;
        for (int c = 0; c < wn; ++c, r += per) {
          ls[k] = fmaf(r[1], r[0], ls[k]);
          as[k] = fmaf(r[2 + d], r[0], as[k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int col = tid + kBConsumers * k;
    if (col < cols)
      store(p.out + qrow + col, as[k] / fmaxf(ls[k], 1e-30f));
  }
  consumer_sync();
}

// NV: 16-byte columns a lane holds (⌈dh / 64⌉: 1, 2 or 4); GB: query
// heads a block takes. A lane group of 8 lanes takes a position, lane
// `sub` its columns sub, sub + 8, …, so a quarter-warp reads a whole
// 128-byte run of one position's row; a lane group takes PPG = 4 / NV
// positions of each stage (a stage: 16·PPG positions).
//
// Persistent: block x takes the units (chunk, row · head block) u = x,
// x + gridDim.x, … in the order u = chunk · units_x + row · hb + hx, so
// the first chunks of every row come first; producer and consumers walk
// the same units and count the same tiles, so tile T of the block sits in
// stage T % stages at its (T / stages)-th use.
template <int NV, int GB>
__global__ void __launch_bounds__(kBThreads)
flash_decode_bf16_kernel(const Params<bf16> p, const int units_x,
                         const bool evict_first,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap) {
  constexpr int PPG = 4 / NV;
  constexpr int kTile = kBGroups * PPG;
  constexpr int kCols = (GB * NV * 64 + kBConsumers - 1) / kBConsumers;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring at a 128-byte boundary, as the tensor copies need
  unsigned char* smem =
      smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const int dh = p.dh, dc = dh / 8, G = p.groups, stages = p.stages;
  const int hb = p.head_blocks;  // units_x: rows · head blocks
  const long long units = (long long)units_x * p.chunks;
  const int tile_vals = kTile * dh;  // values of a K (or V) tile
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* qslot = ring + stages * 2 * tile_vals;  // [stages][GB][dh]
  float* qs = reinterpret_cast<float*>(qslot + stages * GB * dh);
  float* merge = qs + GB * dh;
  const int merge_floats = int(bf16_merge_bytes(GB, dh) / sizeof(float));
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(merge + merge_floats);
  unsigned long long* empty = full + stages;
  int* flag = reinterpret_cast<int*>(empty + stages);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kBConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kBConsumerWarps) {
    // Producer: stage T % stages, once the consumers have released its
    // previous tile, gets tile T's K and V rows (and with a unit's first
    // tile the unit's query rows): a whole tile as one box of the cache's
    // tensor map an operand, a chunk's last tile when it stops short of
    // kTile (at len) one bulk copy of dh·2 bytes a row, so no row at or
    // past `end` is read.
    const unsigned row_bytes = unsigned(dh) * sizeof(bf16);
    const unsigned long long policy = l2_policy(evict_first);
    int T = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const int cid = int(u / units_x), rh = int(u % units_x);
      const int row = rh / hb, hx = rh % hb;
      const int len = p.lens[row], start = cid * p.chunk;
      if (start >= len) continue;
      const int end = min(start + p.chunk, len);
      const int b = row / p.n_kv, kv = row % p.n_kv;
      const int ng = min(GB, G - hx * GB);
      const bf16* kbase = p.k + b * p.k_sb + (long long)kv * dh;
      const bf16* vbase = p.v + b * p.v_sb + (long long)kv * dh;
      for (int base = start; base < end; base += kTile, ++T) {
        const int s = T % stages;
        if (T >= stages) mbar_wait(&empty[s], ((T / stages) - 1) & 1);
        const int n = min(kTile, end - base);
        const unsigned qbytes = base == start ? ng * row_bytes : 0u;
        bf16* kd = ring + s * 2 * tile_vals;
        bf16* vd = kd + tile_vals;
        if (lane == 0) {
          mbar_arrive_expect(&full[s], 2u * n * row_bytes + qbytes);
          if (qbytes)
            bulk_load(qslot + s * GB * dh,
                      p.q + ((long long)row * G + hx * GB) * dh, qbytes,
                      &full[s]);
          if (n == kTile) {
            tile_load(kd, &kmap, kv, base, b, &full[s], policy);
            tile_load(vd, &vmap, kv, base, b, &full[s], policy);
          }
        }
        if (n == kTile) continue;
        __syncwarp();
        for (int j = lane; j < n; j += 32) {
          bulk_load(kd + j * dh, kbase + (base + j) * p.k_ss, row_bytes,
                    &full[s]);
          bulk_load(vd + j * dh, vbase + (base + j) * p.v_ss, row_bytes,
                    &full[s]);
        }
      }
    }
    return;
  }

  const int grp = tid / kLanes, sub = tid % kLanes;
  const float scale2 = p.scale * 1.4426950408889634f;
  constexpr bool kQInRegs = GB * NV <= 2;
  const int rec = 2 + dh;
  int T = 0;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int cid = int(u / units_x), rh = int(u % units_x);
    const int row = rh / hb, hx = rh % hb;
    const int len = p.lens[row], start = cid * p.chunk;
    if (start >= len) continue;
    const int end = min(start + p.chunk, len);
    const int g0 = hx * GB, ng = min(GB, G - g0);
    const int n_active = (len + p.chunk - 1) / p.chunk;
    const long long qrow = ((long long)row * G + g0) * dh;

    float qr[kQInRegs ? GB : 1][kQInRegs ? NV : 1][8];
    float m[GB], l[GB], acc[GB][NV][8];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][i][e] = 0.f;
    }

    for (int base = start; base < end; base += kTile, ++T) {
      const int s = T % stages;
      mbar_wait(&full[s], (T / stages) & 1);
      if (base == start) {
        // the unit's query rows came with its first tile: widened to f32
        // once (the previous unit is past its last read of qs)
        const bf16* qb = qslot + s * GB * dh;
        for (int i = tid; i < ng * dh; i += kBConsumers)
          qs[i] = __bfloat162float(qb[i]);
        consumer_sync();
        if (kQInRegs) {
#pragma unroll
          for (int g = 0; g < (kQInRegs ? GB : 1); ++g)
#pragma unroll
            for (int i = 0; i < (kQInRegs ? NV : 1); ++i) {
              const int col = sub + kLanes * i;
#pragma unroll
              for (int e = 0; e < 8; ++e)
                qr[g][i][e] =
                    g < ng && col < dc ? qs[g * dh + 8 * col + e] : 0.f;
            }
        }
      }
      const bf16* kt = ring + s * 2 * tile_vals;
      const bf16* vt = kt + tile_vals;
      // this lane group's positions of the tile: grp, grp + 16, …
      bool valid[PPG];
      uint4 kraw[PPG][NV], vraw[PPG][NV];
#pragma unroll
      for (int pp = 0; pp < PPG; ++pp) {
        const int j = grp + kBGroups * pp;
        valid[pp] = base + j < end;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int col = sub + kLanes * i;
          const bool in = col < dc;
          const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
          kraw[pp][i] = in ? *reinterpret_cast<const uint4*>(
                                 kt + j * dh + 8 * col)
                           : zero;
          vraw[pp][i] = in ? *reinterpret_cast<const uint4*>(
                                 vt + j * dh + 8 * col)
                           : zero;
        }
      }
      // the stage's values are in registers: hand it back to the producer
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);

#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= ng) break;
        float sc[PPG];
#pragma unroll
        for (int pp = 0; pp < PPG; ++pp) {
          sc[pp] = 0.f;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int col = sub + kLanes * i;
            if (col < dc) {
              float kf[8];
              widen8(kraw[pp][i], kf);
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                const float qv =
                    kQInRegs ? qr[kQInRegs ? g : 0][kQInRegs ? i : 0][e]
                             : qs[g * dh + 8 * col + e];
                sc[pp] = fmaf(qv, kf[e], sc[pp]);
              }
            }
          }
        }
#pragma unroll
        for (int pp = 0; pp < PPG; ++pp) {
          sc[pp] += __shfl_xor_sync(kFull, sc[pp], 1);
          sc[pp] += __shfl_xor_sync(kFull, sc[pp], 2);
          sc[pp] += __shfl_xor_sync(kFull, sc[pp], 4);
          sc[pp] *= scale2;
        }
        // the tile's positions in one step: the new max, then one
        // exponential a position and one for the rescale of the state
        float mx = m[g];
#pragma unroll
        for (int pp = 0; pp < PPG; ++pp)
          if (valid[pp]) mx = fmaxf(mx, sc[pp]);
        const float alpha = exp2f(m[g] - mx);
        float pe[PPG];
        float lsum = l[g] * alpha;
#pragma unroll
        for (int pp = 0; pp < PPG; ++pp) {
          pe[pp] = valid[pp] ? exp2f(sc[pp] - mx) : 0.f;
          lsum += pe[pp];
        }
        l[g] = lsum;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          float a[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) a[e] = acc[g][i][e] * alpha;
#pragma unroll
          for (int pp = 0; pp < PPG; ++pp) {
            if (!valid[pp]) continue;
            float vf[8];
            widen8(vraw[pp][i], vf);
#pragma unroll
            for (int e = 0; e < 8; ++e) a[e] = fmaf(pe[pp], vf[e], a[e]);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][i][e] = a[e];
        }
        m[g] = mx;
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
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[g][i][e] = fmaf(__shfl_xor_sync(kFull, acc[g][i][e], off),
                                w2, acc[g][i][e] * w1);
        m[g] = mx;
      }
    }

    // then the warps, in warp order, through the merge area (free: the
    // unit's first tile's barrier came after the previous unit's last use)
    float* red = merge;  // [warps][GB][2 + dh]
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
          if (col < dc) {
#pragma unroll
            for (int e = 0; e < 8; ++e) r[2 + 8 * col + e] = acc[g][i][e];
          }
        }
      }
    }
    consumer_sync();
    for (int idx = tid; idx < ng * dh; idx += kBConsumers) {
      const int g = idx / dh, d = idx - g * dh;
      float mx = kNegInf;
      for (int w = 0; w < kBConsumerWarps; ++w)
        mx = fmaxf(mx, red[(w * GB + g) * rec]);
      float sum = 0.f, a = 0.f;
      for (int w = 0; w < kBConsumerWarps; ++w) {
        const float* r = red + (w * GB + g) * rec;
        const float e = exp2f(r[0] - mx);
        sum = fmaf(r[1], e, sum);
        a = fmaf(r[2 + d], e, a);
      }
      if (n_active == 1) {
        store(p.out + qrow + idx, a / fmaxf(sum, 1e-30f));
      } else {
        float* part =
            p.ws + (((long long)row * p.chunks + cid) * G + g0 + g) * rec;
        if (d == 0) {
          part[0] = mx;
          part[1] = sum;
        }
        part[2 + d] = a;
      }
    }
    consumer_sync();  // every read of the merge area is done
    if (n_active == 1) continue;

    // the last of the row's active chunks to finish merges the partials
    if (tid == 0)
      *flag = ticket(p.counters + rh, unsigned(n_active - 1)) ==
              unsigned(n_active - 1);
    consumer_sync();
    if (!*flag) continue;
    __threadfence();
    // qs is free: the unit's scores are done
    merge_row<GB, kCols>(p, merge, merge_floats, qs, row, g0, ng, n_active,
                         qrow);
  }
}

struct Maps {
  CUtensorMap k, v;
};

// Blocks of `kernel` at `smem` bytes that the current device holds at
// once (the occupancy query: shared memory and registers).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, int* blocks) {
  int device = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBThreads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <int NV, int GB>
cudaError_t launch_bf16(const Params<bf16>& prm, const Maps& maps,
                        long long units, int units_x, bool evict_first,
                        size_t smem, cudaStream_t stream) {
  auto kernel = flash_decode_bf16_kernel<NV, GB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int resident = 0;
  err = resident_blocks(kernel, smem, &resident);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(units < resident ? units : resident));
  kernel<<<grid, kBThreads, smem, stream>>>(prm, units_x, evict_first,
                                            maps.k, maps.v);
  return cudaGetLastError();
}

template <int NV>
cudaError_t launch_bf16_heads(const Params<bf16>& prm, const Maps& maps,
                              int head_block, long long units, int units_x,
                              bool evict, size_t smem, cudaStream_t stream) {
  switch (head_block) {
    case 1:
      return launch_bf16<NV, 1>(prm, maps, units, units_x, evict, smem,
                                stream);
    case 2:
      return launch_bf16<NV, 2>(prm, maps, units, units_x, evict, smem,
                                stream);
    case 4:
      return launch_bf16<NV, 4>(prm, maps, units, units_x, evict, smem,
                                stream);
    default: return cudaErrorInvalidValue;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda; null if the driver has none.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The [B, S, K, dh] bf16 cache at `base` (element strides over batch and
// position; kv heads dh apart) as a tensor map whose box is one kv head's
// `tile` rows; unused (zeros) where S < tile, since no tile is then whole.
cudaError_t cache_map(CUtensorMap* map, const void* base, long long sb,
                      long long ss, int batch, int seq, int n_kv, int dh,
                      int tile) {
  *map = CUtensorMap{};
  if (seq < tile) return cudaSuccess;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(n_kv),
                              cuuint64_t(seq), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(dh) * sizeof(bf16),
                                 cuuint64_t(ss) * sizeof(bf16),
                                 cuuint64_t(sb) * sizeof(bf16)};
  const cuuint32_t box[4] = {cuuint32_t(dh), 1u, cuuint32_t(tile), 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int run_bf16(const void* q, const void* k, const void* v, const void* lens,
             void* out, void* ws, void* counters, long long k_sb,
             long long k_ss, long long v_sb, long long v_ss, int batch,
             int seq, int n_kv, int groups, int dh, int ppg, int chunk,
             int chunks, int stages, int head_block, double scale,
             void* stream) {
  const int nv = dh <= 64 ? 1 : dh <= 128 ? 2 : 4;  // 16-byte columns a lane
  if (batch <= 0 || seq <= 0 || n_kv <= 0 || groups <= 0 || dh <= 0 ||
      dh % 8 || dh > 256 || ppg != 4 / nv || chunk <= 0 ||
      chunk % (ppg * kBGroups) || chunks <= 0 || chunks > 65535 ||
      (long long)chunks * chunk < seq || stages < 2 || stages > kBMaxStages)
    return int(cudaErrorInvalidValue);
  Maps maps;
  const int tile = ppg * kBGroups;
  cudaError_t err = cache_map(&maps.k, k, k_sb, k_ss, batch, seq, n_kv, dh,
                              tile);
  if (err == cudaSuccess)
    err = cache_map(&maps.v, v, v_sb, v_ss, batch, seq, n_kv, dh, tile);
  if (err != cudaSuccess) return int(err);
  const size_t smem = bf16_smem_bytes(ppg, stages, head_block, dh);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  const int head_blocks = (groups + head_block - 1) / head_block;
  const long long blocks_x = (long long)batch * n_kv * head_blocks;
  if (blocks_x > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  Params<bf16> prm;
  prm.q = static_cast<const bf16*>(q);
  prm.k = static_cast<const bf16*>(k);
  prm.v = static_cast<const bf16*>(v);
  prm.lens = static_cast<const int*>(lens);
  prm.out = static_cast<bf16*>(out);
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
  // units: (chunk, row · head block)
  const long long units = blocks_x * chunks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ux = static_cast<int>(blocks_x);
  // K and V of the whole view stream through L2 once: past what L2 holds,
  // evict them first (a cache that fits stays for the next launch)
  int device = 0, l2 = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, device);
  if (err != cudaSuccess) return int(err);
  const bool evict = 4.0 * batch * seq * n_kv * dh > double(l2);
  if (nv == 1)
    return int(launch_bf16_heads<1>(prm, maps, head_block, units, ux, evict,
                                    smem, st));
  if (nv == 2)
    return int(launch_bf16_heads<2>(prm, maps, head_block, units, ux, evict,
                                    smem, st));
  return int(launch_bf16_heads<4>(prm, maps, head_block, units, ux, evict,
                                  smem, st));
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

// bf16: the same operands, and `seq` (S, the caches' positions, at most
// chunks·chunk), which bounds the tensor maps the whole tiles are read
// through; ppg 4 / ⌈dh / 64⌉ (a tile of 16·ppg positions), stages 2–8.
int flash_decode_bf16(const void* q, const void* k, const void* v,
                      const void* lens, void* out, void* ws, void* counters,
                      long long k_sb, long long k_ss, long long v_sb,
                      long long v_ss, int batch, int seq, int n_kv,
                      int groups, int dh, int ppg, int chunk, int chunks,
                      int stages, int head_block, double scale,
                      void* stream) {
  return run_bf16(q, k, v, lens, out, ws, counters, k_sb, k_ss, v_sb, v_ss,
                  batch, seq, n_kv, groups, dh, ppg, chunk, chunks, stages,
                  head_block, scale, stream);
}

// Dynamic shared memory of a block, as the launcher computes it, for
// operands of `itemsize` bytes (repro_torch.analysis.smem checks the same
// formula before any launch).
int flash_decode_smem_bytes(int ppg, int stages, int head_block, int dh,
                            int itemsize) {
  return int(itemsize == 2 ? bf16_smem_bytes(ppg, stages, head_block, dh)
                           : smem_bytes(ppg, stages, head_block, dh,
                                        itemsize));
}

}  // extern "C"
