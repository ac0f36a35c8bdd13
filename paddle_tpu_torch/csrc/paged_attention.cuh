// Paged attention of a [B, C, H, Dh] query window over one layer's paged
// KV pool, for Hopper (sm_90a). fp32 in, fp32 out, fp32 arithmetic on the
// SIMT units. The kernel body shared by two entry points, each in its own
// source and library:
//
//   paged_attention.cu       K2, the causal window: slot c sees the logical
//                            positions t <= positions[b, c];
//   paged_attention_tree.cu  K3, the tree window (kTree): slot c sees
//                            t < pos0 = positions[b, 0] (the committed
//                            prefix, strict) and the in-window positions
//                            pos0 + r whose window slot r is c or one of
//                            c's ancestors (anc[c, r]).
//
// Position t lives in page block_tables[b, t / bs] at slot t % bs.
// Positions are clamped at 0 and page ids into the pool, like a JAX gather.
//
// Design. The TPU kernels run a grid (B, H, Mb) whose innermost, sequential
// dimension walks the block-table slots and carries the online-softmax
// state in VMEM scratch. Here the context is split across blocks
// (flash-decoding): the grid is (H x query chunks, B, splits). A query
// chunk is at most 32 window slots, so any window C runs, in ceil(C / 32)
// chunks, and shared memory does not grow with C. A split is a contiguous
// run of `split_len` logical positions (a multiple of 64, chosen by the
// wrapper from the table's length and the SM count). Each block first
// reads its chunk's positions: the row's visible run fills n_used splits,
// and a block past them exits at once, so a short row costs its other
// splits nothing. The block walks the visible part of its run in inner
// tiles of kT positions (32 at Dh <= 64, 16 at Dh <= 128, 8 above: two
// stages of K and V take 18 to 35 KB, so three blocks share an SM),
// reading its own page ids from block_tables, and stops after the last
// position any slot of its chunk can see, so pages past it (the null
// tail) are never read. A row that fills one split is written by that
// block; otherwise each block writes fp32 partials (m, l, acc) and the
// last of the row's blocks to finish (an atomic count a (b, h, chunk),
// reset by that block) combines them in split order, so the result does
// not depend on the order blocks run in and no second kernel is launched.
// A split with no visible position (wholly masked) has l = 0 and is
// skipped by the combine.
//
// Each inner tile: the page rows of tile i + 2 are resolved while tile i
// is reduced, and tile i + 1's K and V rows are in flight (16-byte
// cp.async into a two-stage ring, rows past the run zero-filled) while
// tile i's scores are formed. Scores: a thread owns one position j of the
// tile; its group takes up to 32 / (256 / kT) slots, or, for a window of
// fewer slots than groups, a share of the head dim; it reads K row j as
// float4 (the row stride Dh + 4 floats puts the 8 rows a 16-byte phase
// reads on 8 different bank groups) and q of its slots as broadcasts, so
// no shuffle reduction per score. The online softmax takes one warp a
// slot, adding the head-dim shares; then each thread adds P V into float4
// accumulators of fixed (slot, 4 columns) that stay in registers across
// tiles (for a narrow window several threads share an output, each over
// every n-th position of the tile, summed in order at the end).
//
// Head dims: any Dh up to 256. The kernel is instantiated for the
// multiples of 32; any other Dh runs at the next of them with the columns
// past Dh zero-filled in q, K and V (no extra bytes read) and never
// written. Rows are copied 16 bytes at a time when Dh is a multiple of 4,
// else 4 bytes at a time.
//
// Tree mask: ceil(C / 32) uint32 words a slot, built once a block from the
// [C, C] bool anc; the TPU kernel resolved anc[c, rel] as a one-hot matmul
// only because it has no cheap gathers.
//
// Bound. Window attention does 4 flops per K/V element it reads for each
// of its query rows, far below the card's ratio of operations to bytes,
// so the time is bounded by bytes: K and V of every visible position, each
// read once (plus q and the output). Each K/V row is read once per (b, h,
// chunk); the split puts enough blocks on the 132 SMs that a row's
// context no longer runs tile after tile on one SM.
//
// Interface: plain C functions (bound with ctypes), launched on the
// caller's stream, allocating nothing (the wrapper allocates the partials
// and keeps the zeroed counts); each returns cudaGetLastError().

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;     // window slots a block
constexpr int kMaxSplits = 64;  // the combine's weights fit a K/V ring

template <int DP>
struct Geom {
  static constexpr int kT = DP <= 64 ? 32 : (DP <= 128 ? 16 : 8);
  static constexpr int kLd = DP + 4;                 // K/V row stride
  static constexpr int kD4 = DP / 4;                 // float4 a row
  static constexpr int kG = kThreads / kT;           // thread groups (scores)
  // slots a thread scores: 32 / kG, and 2 for a window of fewer than kG
  // slots, whose slot groups hold up to 2
  static constexpr int kSlots = kChunk / kG < 2 ? 2 : kChunk / kG;
  static constexpr int kOwn = kChunk * kD4 / kThreads;  // float4 acc a thread
  // rows of partial scores: a slot group's parts, G / sg parts of under
  // 2 sg slots each, or 32 slots in one part
  static constexpr int kPRows = 2 * kG > kChunk ? 2 * kG : kChunk;
  static_assert(kChunk * kD4 % kThreads == 0, "accumulators per thread");
  static_assert(4 * kT * kLd >= 2 * kChunk * kMaxSplits + kChunk,
                "the combine's weights fit the K/V ring");
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int pow2_floor(int x) {
  return 1 << (31 - __clz(x));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int DP>
size_t smem_bytes(int Cc, int nwords) {
  using G = Geom<DP>;
  return sizeof(float) * (4 * G::kT * G::kLd + Cc * DP + G::kPRows * G::kT
                          + 3 * Cc)
         + sizeof(int) * (2 * G::kT + Cc + 1)
         + sizeof(unsigned) * Cc * nwords;
}

template <int DP, bool kTree>
__global__ void __launch_bounds__(kThreads, 3)
paged_attention_kernel(const float* __restrict__ k_pages,
                       const float* __restrict__ v_pages,
                       const float* __restrict__ q,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ positions,
                       const unsigned char* __restrict__ anc,
                       float* __restrict__ out, float* __restrict__ part_m,
                       float* __restrict__ part_l,
                       float* __restrict__ part_acc,
                       int* __restrict__ counters, int C, int H, int Dh,
                       int bs, int Mb, int num_pages, int split_len,
                       float sm_scale) {
  using G = Geom<DP>;
  constexpr int kT = G::kT, kLd = G::kLd;
  const int n_chunks = (C + kChunk - 1) / kChunk;
  const int h = blockIdx.x % H, chunk = blockIdx.x / H;
  const int c0 = chunk * kChunk;
  const int b = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int Cc = min(kChunk, C - c0);
  const int nwords = kTree ? (C + 31) / 32 : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dh4 = (Dh + 3) / 4;
  const bool vec = (Dh & 3) == 0;

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [2][kT][kLd]
  float* v_s = k_s + 2 * kT * kLd;               // [2][kT][kLd]
  float* q_s = v_s + 2 * kT * kLd;               // [Cc][DP]
  float* p_s = q_s + Cc * DP;                    // [kPRows][kT] scores
  float* m_s = p_s + G::kPRows * kT;             // [Cc] running max
  float* l_s = m_s + Cc;                         // [Cc] running denominator
  float* alpha_s = l_s + Cc;                     // [Cc] rescale of the tile
  int* row_s = reinterpret_cast<int*>(alpha_s + Cc);     // [2][kT] pool rows
  int* pos_s = row_s + 2 * kT;                           // [Cc]
  int* flag_s = pos_s + Cc;                              // [1]
  unsigned* anc_s = reinterpret_cast<unsigned*>(flag_s + 1);  // [Cc][nwords]

  // the last position a slot of the chunk can see, the splits the row's
  // visible run fills, and this split's run; a split past them exits
  for (int c = tid; c < Cc; c += kThreads)
    pos_s[c] = max(positions[(size_t)b * C + c0 + c], 0);
  __syncthreads();
  const int pos0 = max(positions[(size_t)b * C], 0);
  int last = 0;
  if (kTree) {
    last = pos0 + C - 1;
  } else {
    for (int c = 0; c < Cc; ++c) last = max(last, pos_s[c]);
  }
  const int n_ctx = min(last + 1, Mb * bs);
  const int n_used = (n_ctx + split_len - 1) / split_len;
  if (split >= n_used) return;
  const int t_begin = split * split_len;
  const int t_end = min(t_begin + split_len, n_ctx);
  const int n_it = (t_end - t_begin + kT - 1) / kT;

  const int* table = block_tables + (size_t)b * Mb;
  const size_t row_stride = (size_t)H * Dh;  // pool row = (page, slot)
  const float* k_head = k_pages + (size_t)h * Dh;
  const float* v_head = v_pages + (size_t)h * Dh;

  for (int i = tid; i < Cc * DP; i += kThreads) {
    const int c = i / DP, d = i % DP;
    q_s[i] = d < Dh ? q[(((size_t)b * C + c0 + c) * H + h) * Dh + d] : 0.f;
  }
  for (int c = tid; c < Cc; c += kThreads) {
    m_s[c] = -INFINITY;
    l_s[c] = 0.f;
  }
  if (kTree) {
    for (int i = tid; i < Cc * nwords; i += kThreads) {
      const int c = i / nwords, w = i % nwords;
      const unsigned char* a = anc + (size_t)(c0 + c) * C + 32 * w;
      const int n = min(32, C - 32 * w);
      unsigned bits = 0u;  // bit r: window slot 32 w + r is c or an ancestor
      for (int r = 0; r < n; ++r)
        if (a[r]) bits |= 1u << r;
      anc_s[i] = bits;
    }
  }

  // pool rows of inner tile `it` into stage `st` (-1 past the run)
  auto resolve = [&](int it, int st) {
    if (tid < kT) {
      const int t = t_begin + it * kT + tid;
      int r = -1;
      if (t < t_end) {
        const int page = min(max(table[t / bs], 0), num_pages - 1);
        r = page * bs + t % bs;
      }
      row_s[st * kT + tid] = r;
    }
  };
  // K and V rows of the tile whose rows stage `st` holds, into stage st
  auto fetch = [&](int st) {
    float* ks = k_s + st * kT * kLd;
    float* vs = v_s + st * kT * kLd;
    const int* rows = row_s + st * kT;
    if (vec) {
#pragma unroll 2
      for (int i = tid; i < kT * G::kD4; i += kThreads) {
        const int j = i / G::kD4, d4 = i % G::kD4;
        const int r = rows[j];
        const bool in = r >= 0 && d4 < dh4;
        const size_t off = in ? (size_t)r * row_stride + 4 * d4 : 0;
        cp_async16(ks + j * kLd + 4 * d4, k_head + off, in);
        cp_async16(vs + j * kLd + 4 * d4, v_head + off, in);
      }
    } else {
      for (int i = tid; i < kT * DP; i += kThreads) {
        const int j = i / DP, d = i % DP;
        const int r = rows[j];
        const bool in = r >= 0 && d < Dh;
        const size_t off = in ? (size_t)r * row_stride + d : 0;
        cp_async4(ks + j * kLd + d, k_head + off, in);
        cp_async4(vs + j * kLd + d, v_head + off, in);
      }
    }
  };

  // scores: thread group g of a position splits into slot group g % sg
  // and head-dim part g / sg (a window of fewer than kG slots spreads its
  // dot products over the head dim instead of leaving groups idle)
  const int sg = Cc >= G::kG ? G::kG : pow2_floor(Cc);
  const int parts = G::kG / sg;
  // P V: each output float4 (slot, 4 columns) summed over the tile's
  // positions by jg_n threads (1 for a wide window), each jg-th position
  const int n_out = Cc * G::kD4;
  const int jg_n = min(kT, pow2_floor(max(1, kThreads / n_out)));
  const int jg = jg_n > 1 ? tid / n_out : 0;

  float4 acc[G::kOwn];
#pragma unroll
  for (int u = 0; u < G::kOwn; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);

  resolve(0, 0);
  __syncthreads();
  fetch(0);
  cp_async_commit();
  if (n_it > 1) resolve(1, 1);
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    // rows of tile it + 1 resolved; every thread done with tile it - 1
    __syncthreads();
    if (it + 1 < n_it) fetch(st ^ 1);
    cp_async_commit();
    if (it + 2 < n_it) resolve(it + 2, st);
    cp_async_wait_1();
    __syncthreads();  // tile it has landed for every thread
    const float* ks = k_s + st * kT * kLd;
    const float* vs = v_s + st * kT * kLd;
    const int t0 = t_begin + it * kT;
    {
      const int j = tid % kT, g = tid / kT;
      const int sgi = g % sg, part = g / sg;
      float s[G::kSlots];
#pragma unroll
      for (int i = 0; i < G::kSlots; ++i) s[i] = 0.f;
      const float4* kr = reinterpret_cast<const float4*>(ks + j * kLd);
      for (int d4 = part; d4 < dh4; d4 += parts) {
        const float4 kv = kr[d4];
#pragma unroll
        for (int i = 0; i < G::kSlots; ++i) {
          const int c = sgi + sg * i;
          if (c < Cc) {
            const float4 qv =
                reinterpret_cast<const float4*>(q_s + c * DP)[d4];
            s[i] = fmaf(qv.x, kv.x, s[i]);
            s[i] = fmaf(qv.y, kv.y, s[i]);
            s[i] = fmaf(qv.z, kv.z, s[i]);
            s[i] = fmaf(qv.w, kv.w, s[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < G::kSlots; ++i) {
        const int c = sgi + sg * i;
        if (c < Cc) p_s[(part * Cc + c) * kT + j] = s[i];
      }
    }
    __syncthreads();
    // online softmax, one warp a slot: the parts summed, scaled and
    // masked; a row with nothing visible so far uses 0 as its max, so no
    // NaN arises
    for (int c = warp; c < Cc; c += kWarps) {
      constexpr int kE = (kT + 31) / 32;   // positions a lane
      float x[kE], mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int j = lane + 32 * e, t = t0 + j;
        x[e] = -INFINITY;
        if (j < kT && t < t_end) {
          bool visible;
          if (kTree) {
            const int rel = t - pos0;  // window slot at position t
            visible = rel < 0 || (rel < C && ((anc_s[c * nwords + (rel >> 5)]
                                               >> (rel & 31)) & 1u));
          } else {
            visible = t <= pos_s[c];
          }
          if (visible) {
            float dot = 0.f;
            for (int pt = 0; pt < parts; ++pt)
              dot += p_s[(pt * Cc + c) * kT + j];
            x[e] = dot * sm_scale;
          }
        }
        mx = fmaxf(mx, x[e]);
      }
      const float m_old = m_s[c];
      const float m_new = fmaxf(m_old, warp_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int j = lane + 32 * e;
        const float p = expf(x[e] - m_use);
        if (j < kT) p_s[c * kT + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_use);
        alpha_s[c] = alpha;
        l_s[c] = l_s[c] * alpha + sum;
        m_s[c] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p @ V on this thread's (slot, 4 columns)
#pragma unroll
    for (int u = 0; u < G::kOwn; ++u) {
      const int o = jg_n > 1 ? tid % n_out : tid + kThreads * u;
      const int c = o / G::kD4, d4 = o % G::kD4;
      const bool mine = jg_n > 1 ? (u == 0 && jg < jg_n) : o < n_out;
      if (mine && d4 < dh4) {
        const float a = alpha_s[c];
        float4 r = acc[u];
        r.x *= a;
        r.y *= a;
        r.z *= a;
        r.w *= a;
        const float* pc = p_s + c * kT;
#pragma unroll 4
        for (int j = jg; j < kT; j += jg_n) {
          const float p = pc[j];
          const float4 vv =
              *reinterpret_cast<const float4*>(vs + j * kLd + 4 * d4);
          r.x = fmaf(p, vv.x, r.x);
          r.y = fmaf(p, vv.y, r.y);
          r.z = fmaf(p, vv.z, r.z);
          r.w = fmaf(p, vv.w, r.w);
        }
        acc[u] = r;
      }
    }
  }

  if (jg_n > 1) {
    // the position groups' sums of each output, added in group order
    __syncthreads();                       // every thread done with k_s
    float4* red = reinterpret_cast<float4*>(k_s);
    if (jg < jg_n) red[tid] = acc[0];      // tid = jg * n_out + o
    __syncthreads();
    if (tid < n_out) {
      float4 r = red[tid];
      for (int g = 1; g < jg_n; ++g) {
        const float4 x = red[g * n_out + tid];
        r.x += x.x;
        r.y += x.y;
        r.z += x.z;
        r.w += x.w;
      }
      acc[0] = r;
    }
  }

  // one split fills the row: the output (every causal slot sees position
  // 0 and every tree slot itself, so l > 0); more: this split's partials
#pragma unroll
  for (int u = 0; u < G::kOwn; ++u) {
    const int o = jg_n > 1 ? tid : tid + kThreads * u;
    const int c = o / G::kD4, d4 = o % G::kD4;
    if ((jg_n > 1 && u > 0) || o >= n_out || d4 >= dh4) continue;
    const size_t r = ((size_t)b * C + c0 + c) * H + h;
    float4 v = acc[u];
    float* dst;
    if (n_used == 1) {
      const float inv = 1.f / l_s[c];
      v.x *= inv;
      v.y *= inv;
      v.z *= inv;
      v.w *= inv;
      dst = out + r * Dh + 4 * d4;
    } else {
      dst = part_acc + (r * splits + split) * Dh + 4 * d4;
    }
    if (vec) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float vv[4] = {v.x, v.y, v.z, v.w};
      for (int e = 0; e < 4 && 4 * d4 + e < Dh; ++e) dst[e] = vv[e];
    }
  }
  if (n_used == 1) return;
  if (tid < Cc) {
    const size_t r = ((size_t)b * C + c0 + tid) * H + h;
    part_m[r * splits + split] = m_s[tid];
    part_l[r * splits + split] = l_s[tid];
  }
  // the last of the row's splits to finish combines them all, in split
  // order, so the result does not depend on which block that is
  __threadfence();
  __syncthreads();
  int* counter = counters + ((size_t)b * H + h) * n_chunks + chunk;
  if (tid == 0) flag_s[0] = atomicAdd(counter, 1) == n_used - 1;
  __syncthreads();
  if (!flag_s[0]) return;
  __threadfence();
  // each slot's split weights exp(m - max) (0 where l = 0) and 1 / sum
  // l exp(m - max), in the K/V ring (free now), then the outputs
  float* w_s = k_s;                      // [Cc][n_used]
  float* m2_s = w_s + Cc * n_used;       // [Cc][n_used]
  float* inv_s = m2_s + Cc * n_used;     // [Cc]
  for (int i = tid; i < Cc * n_used; i += kThreads) {
    const int c = i / n_used, sp = i % n_used;
    const size_t r = ((size_t)b * C + c0 + c) * H + h;
    w_s[i] = __ldcg(part_l + r * splits + sp);
    m2_s[i] = __ldcg(part_m + r * splits + sp);
  }
  __syncthreads();
  for (int c = tid; c < Cc; c += kThreads) {
    float* w = w_s + c * n_used;
    const float* m = m2_s + c * n_used;
    float mx = -INFINITY;
    for (int sp = 0; sp < n_used; ++sp)
      if (w[sp] > 0.f) mx = fmaxf(mx, m[sp]);
    float l = 0.f;
    for (int sp = 0; sp < n_used; ++sp) {
      const float e = w[sp] > 0.f ? expf(m[sp] - mx) : 0.f;
      l = fmaf(w[sp], e, l);
      w[sp] = e;
    }
    inv_s[c] = 1.f / l;
  }
  __syncthreads();
  for (int i = tid; i < Cc * Dh; i += kThreads) {
    const int c = i / Dh, d = i % Dh;
    const size_t r = ((size_t)b * C + c0 + c) * H + h;
    const float* w = w_s + c * n_used;
    const float* pa = part_acc + r * splits * Dh + d;
    float o = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n_used; ++sp)
      o = fmaf(w[sp], __ldcg(pa + (size_t)sp * Dh), o);
    out[r * Dh + d] = o * inv_s[c];
  }
  if (tid == 0) *counter = 0;  // ready for the next call
}

template <int DP, bool kTree>
cudaError_t launch(const float* k_pages, const float* v_pages,
                   const float* q, const int* block_tables,
                   const int* positions, const unsigned char* anc, float* out,
                   float* part_m, float* part_l, float* part_acc,
                   int* counters, int B, int C, int H, int Dh, int bs,
                   int Mb, int num_pages, int splits, int split_len,
                   float sm_scale, cudaStream_t stream) {
  const int Cc = C < kChunk ? C : kChunk;
  const size_t smem = smem_bytes<DP>(Cc, kTree ? (C + 31) / 32 : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<DP, kTree>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(H * ((C + kChunk - 1) / kChunk), B, splits);
  paged_attention_kernel<DP, kTree><<<grid, kThreads, smem, stream>>>(
      k_pages, v_pages, q, block_tables, positions, anc, out, part_m, part_l,
      part_acc, counters, C, H, Dh, bs, Mb, num_pages, split_len, sm_scale);
  return cudaGetLastError();
}

// Dispatch on the instantiated width: the next multiple of 32 >= Dh.
template <bool kTree>
int launch_dh(const void* k_pages, const void* v_pages, const void* q,
              const void* block_tables, const void* positions,
              const void* anc, void* out, void* part_m, void* part_l,
              void* part_acc, void* counters, int B, int C, int H, int Dh,
              int bs, int Mb, int num_pages, int splits, int split_len,
              float sm_scale, void* stream) {
  if (Dh < 1 || Dh > 256 || C < 1 || splits < 1 || splits > kMaxSplits
      || split_len < 1
      || split_len % 64 || (long long)splits * split_len < (long long)Mb * bs)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* kp = static_cast<const float*>(k_pages);
  const float* vp = static_cast<const float*>(v_pages);
  const float* qp = static_cast<const float*>(q);
  const int* tp = static_cast<const int*>(block_tables);
  const int* pp = static_cast<const int*>(positions);
  const unsigned char* ap = static_cast<const unsigned char*>(anc);
  float* op = static_cast<float*>(out);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  int* cn = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((Dh + 31) / 32 * 32) {
#define PTPU_PAGED_CASE(DP)                                                  \
  case DP:                                                                   \
    return launch<DP, kTree>(kp, vp, qp, tp, pp, ap, op, pm, pl, pa, cn, B,  \
                             C, H, Dh, bs, Mb, num_pages, splits, split_len, \
                             sm_scale, s);
    PTPU_PAGED_CASE(32)
    PTPU_PAGED_CASE(64)
    PTPU_PAGED_CASE(96)
    PTPU_PAGED_CASE(128)
    PTPU_PAGED_CASE(160)
    PTPU_PAGED_CASE(192)
    PTPU_PAGED_CASE(224)
    PTPU_PAGED_CASE(256)
#undef PTPU_PAGED_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
