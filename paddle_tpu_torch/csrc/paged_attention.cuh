// Paged attention of a [B, C, H, Dh] query window over one layer's paged
// KV pool, for Hopper (sm_90a). fp32 in, fp32 out. The kernel body shared
// by two entry points, each in its own source and library:
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
// state in VMEM scratch. Blocks of a CUDA grid run in parallel and in no
// order, so that dimension becomes a loop inside one thread block per
// (b, h): the block reads its own page ids from block_tables (no scalar
// prefetch, no gathered [B, max_ctx] copy), walks the row's positions in
// table order in tiles of 64, keeps (m, l, acc) for its C query rows in
// shared memory, and stops after the last position any slot of the row
// can see, so pages past it (the null tail) are never read. The tree mask
// is one uint32 bit mask a slot (C <= 32), built once a block from the
// [C, C] bool anc in shared memory and tested bit by bit; the TPU kernel
// resolved anc[c, rel] as a one-hot matmul only because it has no cheap
// gathers.
//
// Bound. Window attention does 4 flops per K/V element it reads for each
// of C <= 32 query rows, far below the card's ratio of operations to
// bytes, so the time is bounded by bytes: K and V of every visible
// position, each read once (plus q and the output). The design reads each
// K and V row exactly once per (b, h) and keeps many loads in flight: at
// the top of each tile every warp issues the loads of its 8 K rows (32
// lanes on consecutive addresses, the head dim split across lanes) and
// every thread its share of the V tile (16-byte loads), before any of them
// is used; the dot products are then reduced with shuffles and the V tile
// is staged once in shared memory for the C query rows. A row's tiles
// still run one after another on one SM, so the longest row sets the
// time; splitting the context across blocks (flash-decoding), cp.async/TMA
// pipelining and a bf16/fp8 pool are later work.
//
// Head dims: every multiple of 32 up to 256, one instantiation each (a
// lane holds Dh / 32 elements of a K row). Shared memory grows with Dh and
// C, to 140 KB at Dh 256 and C 32 (K3's largest window), past 48 KB
// allowed with cudaFuncSetAttribute before the launch.
//
// Interface: plain C functions (bound with ctypes), launched on the
// caller's stream, allocating nothing; each returns cudaGetLastError().

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;                      // logical positions per tile
constexpr int kRowsPerWarp = kTile / kWarps;   // K rows a warp reduces

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

template <int DH>
size_t smem_bytes(int C) {
  return sizeof(float) * (kTile * DH + 2 * C * DH + C * kTile + 3 * C)
         + sizeof(int) * (2 * C + kTile);
}

template <int DH, bool kTree>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ k_pages,
                       const float* __restrict__ v_pages,
                       const float* __restrict__ q,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ positions,
                       const unsigned char* __restrict__ anc,
                       float* __restrict__ out, int C, int H, int bs, int Mb,
                       int num_pages, float sm_scale) {
  constexpr int kPerLane = DH / 32;        // head-dim elements of one lane
  constexpr int kVec = DH / 4;             // float4 per row
  constexpr int kVPerThread = kTile * kVec / kThreads;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float4 smem4[];
  float* v_s = reinterpret_cast<float*>(smem4);  // [kTile][DH], 16B aligned
  float* q_s = v_s + kTile * DH;     // [C][DH]
  float* acc_s = q_s + C * DH;       // [C][DH]
  float* p_s = acc_s + C * DH;       // [C][kTile] scores, then weights
  float* m_s = p_s + C * kTile;      // [C] running max
  float* l_s = m_s + C;              // [C] running denominator
  float* alpha_s = l_s + C;          // [C] rescale of the tile
  int* pos_s = reinterpret_cast<int*>(alpha_s + C);  // [C]
  unsigned* anc_s = reinterpret_cast<unsigned*>(pos_s + C);  // [C] (tree)
  int* row_s = reinterpret_cast<int*>(anc_s + C);    // [kTile] pool rows

  const int* table = block_tables + (size_t)b * Mb;
  const size_t row_stride = (size_t)H * DH;  // pool row = (page, slot)
  const float* k_head = k_pages + (size_t)h * DH;
  const float* v_head = v_pages + (size_t)h * DH;

  for (int i = tid; i < C * DH; i += kThreads) {
    const int c = i / DH, d = i % DH;
    q_s[i] = q[(((size_t)b * C + c) * H + h) * DH + d];
    acc_s[i] = 0.f;
  }
  for (int c = tid; c < C; c += kThreads) {
    pos_s[c] = max(positions[b * C + c], 0);
    m_s[c] = -INFINITY;
    l_s[c] = 0.f;
    if (kTree) {
      unsigned bits = 0u;  // bit r: window slot r is c or an ancestor
      for (int r = 0; r < C; ++r)
        if (anc[c * C + r]) bits |= 1u << r;
      anc_s[c] = bits;
    }
  }
  __syncthreads();
  // the last position any slot of the row can see
  int last = 0;
  if (kTree) {
    last = pos_s[0] + C - 1;
  } else {
    for (int c = 0; c < C; ++c) last = max(last, pos_s[c]);
  }
  const int pos0 = pos_s[0];
  const int n_ctx = min(last + 1, Mb * bs);

  for (int t0 = 0; t0 < n_ctx; t0 += kTile) {
    const int nt = min(kTile, n_ctx - t0);
    // resolve each position of the tile through the row's block table
    if (tid < nt) {
      const int t = t0 + tid;
      const int page = min(max(table[t / bs], 0), num_pages - 1);
      row_s[tid] = page * bs + t % bs;
    }
    __syncthreads();
    // issue every load of the tile before using any: this warp's K rows
    // (lanes on consecutive addresses) and this thread's share of V
    const int j0 = warp * kRowsPerWarp;
    float kr[kRowsPerWarp][kPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float* krow = k_head + (size_t)row_s[min(j0 + r, nt - 1)]
                          * row_stride;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) kr[r][e] = krow[lane + 32 * e];
    }
    float4 vr[kVPerThread];
#pragma unroll
    for (int u = 0; u < kVPerThread; ++u) {
      const int i = tid + u * kThreads;
      const int j = min(i / kVec, nt - 1);
      vr[u] = reinterpret_cast<const float4*>(
          v_head + (size_t)row_s[j] * row_stride)[i % kVec];
    }
    // scores of this warp's rows; rows past the tile were loaded as
    // duplicates of its last row and are never stored
    for (int c = 0; c < C; ++c) {
      float part[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        part[r] = 0.f;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          part[r] += q_s[c * DH + lane + 32 * e] * kr[r][e];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) part[r] = warp_sum(part[r]);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int j = j0 + r;
          if (j >= nt) continue;
          const int t = t0 + j;
          bool visible;
          if (kTree) {
            const int rel = t - pos0;  // window slot at position t
            visible = rel < 0 || (rel < C && ((anc_s[c] >> rel) & 1u));
          } else {
            visible = t <= pos_s[c];
          }
          p_s[c * kTile + j] = visible ? part[r] * sm_scale : -INFINITY;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kVPerThread; ++u) smem4[tid + u * kThreads] = vr[u];
    __syncthreads();
    // online softmax: warp w takes query rows w, w + 8, ...; each lane
    // two positions of the tile
    for (int c = warp; c < C; c += kWarps) {
      float* pc = p_s + c * kTile;
      const float s0 = (lane < nt) ? pc[lane] : -INFINITY;
      const float s1 = (lane + 32 < nt) ? pc[lane + 32] : -INFINITY;
      const float m_old = m_s[c];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = (s0 == -INFINITY) ? 0.f : expf(s0 - m_new);
      const float p1 = (s1 == -INFINITY) ? 0.f : expf(s1 - m_new);
      const float tile_sum = warp_sum(p0 + p1);
      pc[lane] = p0;
      pc[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
        alpha_s[c] = alpha;
        l_s[c] = l_s[c] * alpha + tile_sum;
        m_s[c] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p @ V
    for (int i = tid; i < C * DH; i += kThreads) {
      const int c = i / DH, d = i % DH;
      const float* pc = p_s + c * kTile;
      float a = acc_s[i] * alpha_s[c];
      for (int j = 0; j < nt; ++j) a += pc[j] * v_s[j * DH + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  // every causal slot sees position 0 and every tree slot itself, so l > 0
  for (int i = tid; i < C * DH; i += kThreads) {
    const int c = i / DH, d = i % DH;
    out[(((size_t)b * C + c) * H + h) * DH + d] = acc_s[i] / l_s[c];
  }
}

template <int DH, bool kTree>
cudaError_t launch(const float* k_pages, const float* v_pages,
                   const float* q, const int* block_tables,
                   const int* positions, const unsigned char* anc, float* out,
                   int B, int C, int H, int bs, int Mb, int num_pages,
                   float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>(C);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<DH, kTree>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(H, B);
  paged_attention_kernel<DH, kTree><<<grid, kThreads, smem, stream>>>(
      k_pages, v_pages, q, block_tables, positions, anc, out, C, H, bs, Mb,
      num_pages, sm_scale);
  return cudaGetLastError();
}

template <bool kTree>
int launch_dh(const void* k_pages, const void* v_pages, const void* q,
              const void* block_tables, const void* positions,
              const void* anc, void* out, int B, int C, int H, int Dh,
              int bs, int Mb, int num_pages, float sm_scale, void* stream) {
  const float* kp = static_cast<const float*>(k_pages);
  const float* vp = static_cast<const float*>(v_pages);
  const float* qp = static_cast<const float*>(q);
  const int* tp = static_cast<const int*>(block_tables);
  const int* pp = static_cast<const int*>(positions);
  const unsigned char* ap = static_cast<const unsigned char*>(anc);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
#define PTPU_PAGED_CASE(DH)                                                  \
  case DH:                                                                   \
    return launch<DH, kTree>(kp, vp, qp, tp, pp, ap, op, B, C, H, bs, Mb,    \
                             num_pages, sm_scale, s);
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
