// Flash attention, forward and backward, for Hopper (sm_90a): the fp32
// route. fp32 in and out, fp32 arithmetic on the SIMT units throughout;
// bf16 inputs take the tensor-core kernels of flash_attention_tc.cu.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
// `flash_attention` (:120) -> `flash_attention_portable` (:156) ->
// `_flash_fwd` (:162, pl.pallas_call :191, body `_fwd_kernel` :58), and
// its backward `_flash_bwd_rule` (:212; on a TPU jax's library Pallas
// backward, :131-150), for fp32 programs: the forward runs once per layer
// in the fp32 and full-int8 inference of the Fluid-API Transformer LM
// (its attention stays fp32), forward and backward in fp32 training.
//
// What it computes, per (batch b, head h): O = softmax(Q K^T * scale) V
// over q [Tq, Dh] and k, v [Tk, Dh] (Dh 64 or 128, a template parameter;
// the wrapper pads any other head dim up to the next of them), keys at
// positions >= Tk masked and,
// when causal (Tq == Tk), keys after the query's position masked. The
// forward also writes the row log-sum-exp of the scaled scores (fp32
// [B, H, Tq]); the backward rebuilds P from it.
//
// Design. The TPU kernel walks a grid (B*H, q blocks, kv blocks) whose
// innermost, sequential dimension carries the online-softmax state in VMEM
// scratch. CUDA blocks run in parallel and in no order, so the kv walk
// becomes a loop inside one block per (b*h, 64-row q tile). Tiles of 64
// rows are staged in shared memory as fp32 with a row stride of Dh + 1
// floats (P and dS, 64 x 64, with 65), so every product below reads shared
// memory without bank conflicts; each of the 128 threads owns a 4 x 8
// piece of every 64 x 64 product (4 x Dh/8 of a 64 x Dh one) and keeps it
// in registers. Each launch first allows its dynamic shared memory (65 to
// 162 KB) with cudaFuncSetAttribute. The forward keeps the running max m,
// sum l and the O accumulator of its 4 rows in registers; P is written to
// shared memory only to be multiplied with V. Causal blocks stop at the diagonal tile;
// the diagonal tile and the ragged kv tail are masked with -inf, and a row
// whose keys are all masked so far uses 0 as its max, so no NaN can arise
// (such a row ends with l = 0, O = 0 and lse = +inf, for which the
// backward's P is exactly 0).
//
// The backward is three kernels: delta = rowsum(dO * O) (one warp a row);
// dK/dV, one block per (b*h, kv tile) walking the q tiles from the
// diagonal on, recomputing S = Q K^T and dP = dO V^T, P = exp(S*scale -
// lse) and dS = P (dP - delta), and accumulating dV += P^T dO and dK +=
// dS^T Q in registers; dQ, one block per (b*h, q tile) walking the kv
// tiles up to the diagonal, accumulating dQ += dS K. dQ is computed in its
// own pass (S and dP a second time) rather than with atomics, so the
// result does not depend on the order blocks run in.
//
// Bound. At the int8 inference path's shape (B 32, H 8, T 512, Dh 64,
// fp32, causal) the forward's products are 8.6 GFLOP against 134 MB of Q,
// K, V and O: on the fp32 SIMT rate (67 TFLOP/s) the products bound it
// (0.13 ms), not the bytes (0.04 ms at 3.35 TB/s). The design keeps P in
// fp32, as the TPU kernel does; a TF32 or split-bf16 tensor-core route for
// fp32 is later work.
//
// Interface: plain C functions (bound with ctypes), launched on the
// caller's stream, allocating nothing; each returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;                // q and kv rows per tile
constexpr int kPLd = kTile + 1;          // P and dS row stride, in floats
constexpr int kPFloats = kTile * kPLd;
constexpr int kThreads = 128;

// shared row stride of a [64][DH] tile, in floats, and the tile's floats
template <int DH>
__host__ __device__ constexpr int ld() { return DH + 1; }
template <int DH>
__host__ __device__ constexpr int tile_floats() { return kTile * ld<DH>(); }

struct Strides {  // element strides of one [B, H, T, Dh] tensor
  long long b, h, t;
};

// Rows [row0, row0 + 64) of one (b, h) slice into shared memory as fp32;
// rows at or past n are zero.
template <int DH>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          long long st, int row0, int n) {
  for (int i = threadIdx.x; i < kTile * DH; i += kThreads) {
    const int r = i / DH, d = i % DH, row = row0 + r;
    s[r * ld<DH>() + d] = row < n ? g[(long long)row * st + d] : 0.f;
  }
}

// acc[i][j] += sum_k A(4*ty + i, k) * B(tx + 8*j, k), k < K, where
// A(r, k) = a[r * sar + k * sak] and B(c, k) = b[c * sbc + k * sbk].
template <int J, int K>
__device__ __forceinline__ void tile_product(float (&acc)[4][J],
                                             const float* a, int sar,
                                             int sak, const float* b,
                                             int sbc, int sbk, int ty,
                                             int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[J];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(4 * ty + i) * sar + k * sak];
#pragma unroll
    for (int j = 0; j < J; ++j) bv[j] = b[(tx + 8 * j) * sbc + k * sbk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int J>
__device__ __forceinline__ void zero(float (&acc)[4][J]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
}

// reduce over the 8 lanes (tx) that share a row
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

__device__ __forceinline__ bool visible(int row, int col, int Tq, int Tk,
                                        int causal) {
  return row < Tq && col < Tk && (!causal || col <= row);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk, Strides sq,
                 Strides sk, Strides sv, Strides so, float scale,
                 int causal) {
  constexpr int kLd = ld<DH>(), kJ = DH / 8;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + tile_floats<DH>();
  float* v_s = k_s + tile_floats<DH>();
  float* p_s = v_s + tile_floats<DH>();
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const float* qg = q + b * sq.b + h * sq.h;
  const float* kg = k + b * sk.b + h * sk.h;
  const float* vg = v + b * sv.b + h * sv.h;
  load_tile<DH>(q_s, qg, sq.t, q0, Tq);

  float m[4], l[4], acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  zero(acc);
  int n_kt = (Tk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (int)blockIdx.y + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's P.V is done with k_s, v_s, p_s
    load_tile<DH>(k_s, kg, sk.t, k0, Tk);
    load_tile<DH>(v_s, vg, sv.t, k0, Tk);
    __syncthreads();
    float s[4][8];
    zero(s);
    tile_product<8, DH>(s, q_s, kLd, 1, k_s, kLd, 1, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = visible(row, k0 + tx + 8 * j, Tq, Tk, causal)
                      ? s[i][j] * scale
                      : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        sum += s[i][j];
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[i][j] *= alpha;
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        p_s[(4 * ty + i) * kPLd + tx + 8 * j] = s[i][j];
    }
    __syncthreads();
    tile_product<kJ, kTile>(acc, p_s, kPLd, 1, v_s, 1, kLd, ty, tx);  // P V
  }

  float* og = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Tq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      og[(long long)row * so.t + tx + 8 * j] = acc[i][j] * inv;
    if (tx == 0)
      lse[(long long)bh * Tq + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

// delta[b, h, t] = sum_d dO * O, one warp a row
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const float* __restrict__ o, const float* __restrict__ d_o,
                   float* __restrict__ delta, int H, int Tq, long long rows,
                   Strides so, Strides sdo) {
  const long long row = (long long)blockIdx.x * (kThreads / 32)
                        + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long bh = row / Tq;
  const int t = row % Tq, b = bh / H, h = bh % H;
  const float* op = o + b * so.b + h * so.h + t * so.t;
  const float* dp = d_o + b * sdo.b + h * sdo.h + t * sdo.t;
  float acc = op[lane] * dp[lane];
#pragma unroll
  for (int u = 1; u < DH / 32; ++u) acc += op[lane + 32 * u] * dp[lane + 32 * u];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// S = Q K^T and dP = dO V^T for one (q tile, kv tile) pair, then P and
// dS = P (dP - delta) into p_s (if given) and ds_s, both [q row][kv col].
template <int DH>
__device__ __forceinline__ void p_and_ds(const float* q_s, const float* do_s,
                                         const float* k_s, const float* v_s,
                                         const float* lse_s,
                                         const float* delta_s, float* p_s,
                                         float* ds_s, int q0, int k0, int Tq,
                                         int Tk, float scale, int causal,
                                         int ty, int tx) {
  float s[4][8], dp[4][8];
  zero(s);
  zero(dp);
  constexpr int kLd = ld<DH>();
  tile_product<8, DH>(s, q_s, kLd, 1, k_s, kLd, 1, ty, tx);
  tile_product<8, DH>(dp, do_s, kLd, 1, v_s, kLd, 1, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 8 * j;
      const float p = visible(q0 + r, k0 + c, Tq, Tk, causal)
                          ? expf(s[i][j] * scale - lse_s[r])
                          : 0.f;
      if (p_s) p_s[r * kPLd + c] = p;
      ds_s[r * kPLd + c] = p * (dp[i][j] - delta_s[r]);
    }
  }
}

// lse and delta of q rows [q0, q0 + 64) into shared memory
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, long long bh,
                                          int q0, int Tq) {
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < Tq ? lse[bh * Tq + row] : INFINITY;
    delta_s[threadIdx.x] = row < Tq ? delta[bh * Tq + row] : 0.f;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ d_o,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int Tq, int Tk, Strides sq,
                  Strides sk, Strides sv, Strides sdo, Strides sdk,
                  Strides sdv, float scale, int causal) {
  constexpr int kLd = ld<DH>(), kJ = DH / 8;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + tile_floats<DH>();
  float* q_s = v_s + tile_floats<DH>();
  float* do_s = q_s + tile_floats<DH>();
  float* p_s = do_s + tile_floats<DH>();
  float* ds_s = p_s + kPFloats;
  float* lse_s = ds_s + kPFloats;
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const float* qg = q + b * sq.b + h * sq.h;
  const float* dog = d_o + b * sdo.b + h * sdo.h;
  load_tile<DH>(k_s, k + b * sk.b + h * sk.h, sk.t, k0, Tk);
  load_tile<DH>(v_s, v + b * sv.b + h * sv.h, sv.t, k0, Tk);

  float dk_acc[4][kJ], dv_acc[4][kJ];  // rows: kv 4*ty + i; cols: d
  zero(dk_acc);
  zero(dv_acc);
  const int n_qt = (Tq + kTile - 1) / kTile;
  for (int qt = causal ? (int)blockIdx.y : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous q tile's products are done
    load_tile<DH>(q_s, qg, sq.t, q0, Tq);
    load_tile<DH>(do_s, dog, sdo.t, q0, Tq);
    load_rows(lse_s, delta_s, lse, delta, bh, q0, Tq);
    __syncthreads();
    p_and_ds<DH>(q_s, do_s, k_s, v_s, lse_s, delta_s, p_s, ds_s, q0, k0, Tq,
                 Tk, scale, causal, ty, tx);
    __syncthreads();
    tile_product<kJ, kTile>(dv_acc, p_s, 1, kPLd, do_s, 1, kLd, ty,
                            tx);                                // P^T dO
    tile_product<kJ, kTile>(dk_acc, ds_s, 1, kPLd, q_s, 1, kLd, ty,
                            tx);                                // dS^T Q
  }

  float* dkg = dk + b * sdk.b + h * sdk.h;
  float* dvg = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= Tk) continue;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int d = tx + 8 * j;
      dkg[(long long)row * sdk.t + d] = dk_acc[i][j] * scale;
      dvg[(long long)row * sdv.t + d] = dv_acc[i][j];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ d_o,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq, int H,
                int Tq, int Tk, Strides sq, Strides sk, Strides sv,
                Strides sdo, Strides sdq, float scale, int causal) {
  constexpr int kLd = ld<DH>(), kJ = DH / 8;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + tile_floats<DH>();
  float* k_s = do_s + tile_floats<DH>();
  float* v_s = k_s + tile_floats<DH>();
  float* ds_s = v_s + tile_floats<DH>();
  float* lse_s = ds_s + kPFloats;
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const float* kg = k + b * sk.b + h * sk.h;
  const float* vg = v + b * sv.b + h * sv.h;
  load_tile<DH>(q_s, q + b * sq.b + h * sq.h, sq.t, q0, Tq);
  load_tile<DH>(do_s, d_o + b * sdo.b + h * sdo.h, sdo.t, q0, Tq);
  load_rows(lse_s, delta_s, lse, delta, bh, q0, Tq);

  float dq_acc[4][kJ];  // rows: q 4*ty + i; cols: d
  zero(dq_acc);
  int n_kt = (Tk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (int)blockIdx.y + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous kv tile's dS K is done
    load_tile<DH>(k_s, kg, sk.t, k0, Tk);
    load_tile<DH>(v_s, vg, sv.t, k0, Tk);
    __syncthreads();
    p_and_ds<DH>(q_s, do_s, k_s, v_s, lse_s, delta_s, nullptr, ds_s, q0, k0,
                 Tq, Tk, scale, causal, ty, tx);
    __syncthreads();
    tile_product<kJ, kTile>(dq_acc, ds_s, kPLd, 1, k_s, 1, kLd, ty,
                            tx);                                // dS K
  }

  float* dqg = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Tq) continue;
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      dqg[(long long)row * sdq.t + tx + 8 * j] =
          dq_acc[i][j] * scale;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Strides strides_of(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Tq, int Tk,
                       const long long* st, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = (3 * tile_floats<DH>() + kPFloats) * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + kTile - 1) / kTile);
  flash_fwd_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse),
      H, Tq, Tk, strides_of(st, 0), strides_of(st, 1), strides_of(st, 2),
      strides_of(st, 3), scale, causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* d_o, const void* lse,
                       void* delta, void* dq, void* dk, void* dv, int B,
                       int H, int Tq, int Tk, const long long* st,
                       float scale, int causal, cudaStream_t stream) {
  // strides: q 0, k 1, v 2, o 3, do 4, dq 5, dk 6, dv 7
  const long long rows = (long long)B * H * Tq;
  const int warps = kThreads / 32;
  flash_delta_kernel<DH><<<(unsigned)((rows + warps - 1) / warps),
                              kThreads, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(d_o),
      static_cast<float*>(delta), H, Tq, rows, strides_of(st, 3),
      strides_of(st, 4));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = (4 * tile_floats<DH>() + 2 * kPFloats + 2 * kTile)
                         * sizeof(float);
  err = allow_smem(flash_dkdv_kernel<DH>, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(B * H, (Tk + kTile - 1) / kTile);
  flash_dkdv_kernel<DH><<<grid_kv, kThreads, smem_kv, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Tq, Tk,
      strides_of(st, 0), strides_of(st, 1), strides_of(st, 2),
      strides_of(st, 4), strides_of(st, 6), strides_of(st, 7), scale,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_q = (4 * tile_floats<DH>() + kPFloats + 2 * kTile)
                        * sizeof(float);
  err = allow_smem(flash_dq_kernel<DH>, smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q(B * H, (Tq + kTile - 1) / kTile);
  flash_dq_kernel<DH><<<grid_q, kThreads, smem_q, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, Tq, Tk, strides_of(st, 0), strides_of(st, 1),
      strides_of(st, 2), strides_of(st, 4), strides_of(st, 5), scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, Tq, Dh], k/v [B, H, Tk, Dh], o like q, all fp32, Dh 64 or 128:
// any strides with a unit head-dim stride, given as `strides` = [b, h, t]
// element strides of q, k, v, o (12 values, host memory). lse [B, H, Tq]
// fp32 contiguous. Causal needs Tq == Tk (the wrapper checks).
extern "C" int ptpu_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int H, int Tq, int Tk, int Dh,
                                        const long long* strides,
                                        float scale, int causal,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64:
      return static_cast<int>(launch_fwd<64>(q, k, v, o, lse, B, H, Tq, Tk,
                                             strides, scale, causal, s));
    case 128:
      return static_cast<int>(launch_fwd<128>(q, k, v, o, lse, B, H, Tq, Tk,
                                              strides, scale, causal, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward: dq/dk/dv like q/k/v (their own strides), from q, k, v, o,
// do and the forward's lse; delta is fp32 [B, H, Tq] scratch. `strides`
// holds 24 values: q, k, v, o, do, dq, dk, dv.
extern "C" int ptpu_flash_attention_bwd(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* d_o, const void* lse,
                                        void* delta, void* dq, void* dk,
                                        void* dv, int B, int H, int Tq,
                                        int Tk, int Dh,
                                        const long long* strides,
                                        float scale, int causal,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64:
      return static_cast<int>(launch_bwd<64>(q, k, v, o, d_o, lse, delta, dq,
                                             dk, dv, B, H, Tq, Tk, strides,
                                             scale, causal, s));
    case 128:
      return static_cast<int>(launch_bwd<128>(q, k, v, o, d_o, lse, delta,
                                              dq, dk, dv, B, H, Tq, Tk,
                                              strides, scale, causal, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
