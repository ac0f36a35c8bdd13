// Flash attention backward for Hopper (sm_90a): the fp32 route. fp32 in
// and out, fp32 arithmetic on the SIMT units throughout. The fp32 forward
// runs on the tensor cores by 3xTF32 (flash_attention_f32tc.cu); bf16
// takes the kernels of flash_attention_tc.cu.
//
// Replaces, for fp32 programs, the backward of the TPU kernel
// paddle_tpu/ops/pallas_kernels.py `flash_attention` (:120): its
// `_flash_bwd_rule` (:212; on a TPU jax's library Pallas backward,
// :131-150). It runs once per layer in fp32 training.
//
// What it computes, per (batch b, head h), from q [Tq, Dh], k, v [Tk, Dh]
// (Dh 64, 128 or 256, a template parameter; the wrapper pads any other
// head dim up to the next of them), o, dO and the forward's row
// log-sum-exp lse: P = exp(S * scale - lse) with S = Q K^T (keys at
// positions >= Tk masked and, when causal, keys after the query's
// position), dP = dO V^T, delta = rowsum(dO * O), dS = P (dP - delta), and
// dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K. A row the forward saw
// fully masked has lse = +inf, for which P is exactly 0.
//
// Design. Three kernels: delta (one warp a row); dK/dV, one block per
// (b*h, kv tile) walking the q tiles from the diagonal on, recomputing S
// and dP, forming P and dS in shared memory and accumulating dV and dK in
// registers; dQ, one block per (b*h, q tile) walking the kv tiles up to
// the diagonal, accumulating dQ += dS K. dQ is computed in its own pass
// (S and dP a second time) rather than with atomics, so the result does
// not depend on the order blocks run in. Tiles of TR rows (64, and 32 at
// Dh 256, where four 64-row tiles would need about 300 KB) are staged in
// shared memory as fp32 with a row stride of Dh + 1 floats (P and dS with
// TR + 1), so every product reads shared memory without bank conflicts;
// each of the 128 threads owns a TR/16 x 8 piece of every TR x TR product
// (TR/16 x Dh/8 of a TR x Dh one) and keeps it in registers. Each launch
// first allows its dynamic shared memory (up to 165 KB) with
// cudaFuncSetAttribute.
//
// Bound. At the fp32 training path's shape the products, 10 Dh flops a
// visible (query, key) pair, over the fp32 SIMT rate (67 TFLOP/s) bound
// it, not the bytes; a tensor-core route for the fp32 backward is later
// work.
//
// Interface: a plain C function (bound with ctypes), launched on the
// caller's stream, allocating nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;            // 16 x 8 threads (ty, tx)

// Tile rows by head dim: four 64-row tiles of Dh + 1 floats fit in 227 KB
// up to Dh 128; at Dh 256 the tiles take 32 rows.
template <int DH>
struct Rows {
  static constexpr int kTR = DH <= 128 ? 64 : 32;
};

struct Strides {  // element strides of one [B, H, T, Dh] tensor
  long long b, h, t;
};

// Rows [row0, row0 + TR) of one (b, h) slice into shared memory as fp32
// with a row stride of DH + 1; rows at or past n are zero.
template <int DH, int TR>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          long long st, int row0, int n) {
  for (int i = threadIdx.x; i < TR * DH; i += kThreads) {
    const int r = i / DH, d = i % DH, row = row0 + r;
    s[r * (DH + 1) + d] = row < n ? g[(long long)row * st + d] : 0.f;
  }
}

// acc[i][j] += sum_k A(R*ty + i, k) * B(tx + 8*j, k), k < K, where
// A(r, k) = a[r * sar + k * sak] and B(c, k) = b[c * sbc + k * sbk].
template <int R, int J, int K>
__device__ __forceinline__ void tile_product(float (&acc)[R][J],
                                             const float* a, int sar,
                                             int sak, const float* b,
                                             int sbc, int sbk, int ty,
                                             int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[R], bv[J];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a[(R * ty + i) * sar + k * sak];
#pragma unroll
    for (int j = 0; j < J; ++j) bv[j] = b[(tx + 8 * j) * sbc + k * sbk];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int R, int J>
__device__ __forceinline__ void zero(float (&acc)[R][J]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ bool visible(int row, int col, int Tq, int Tk,
                                        int causal) {
  return row < Tq && col < Tk && (!causal || col <= row);
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
// dS = P (dP - delta) into p_s (if given) and ds_s, both [q row][kv col]
// with a row stride of TR + 1.
template <int DH, int TR>
__device__ __forceinline__ void p_and_ds(const float* q_s, const float* do_s,
                                         const float* k_s, const float* v_s,
                                         const float* lse_s,
                                         const float* delta_s, float* p_s,
                                         float* ds_s, int q0, int k0, int Tq,
                                         int Tk, float scale, int causal,
                                         int ty, int tx) {
  constexpr int R = TR / 16, J = TR / 8, kLd = DH + 1, kPLd = TR + 1;
  float s[R][J], dp[R][J];
  zero(s);
  zero(dp);
  tile_product<R, J, DH>(s, q_s, kLd, 1, k_s, kLd, 1, ty, tx);
  tile_product<R, J, DH>(dp, do_s, kLd, 1, v_s, kLd, 1, ty, tx);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = R * ty + i;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = tx + 8 * j;
      const float p = visible(q0 + r, k0 + c, Tq, Tk, causal)
                          ? expf(s[i][j] * scale - lse_s[r])
                          : 0.f;
      if (p_s) p_s[r * kPLd + c] = p;
      ds_s[r * kPLd + c] = p * (dp[i][j] - delta_s[r]);
    }
  }
}

// lse and delta of q rows [q0, q0 + TR) into shared memory
template <int TR>
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, long long bh,
                                          int q0, int Tq) {
  if (threadIdx.x < TR) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < Tq ? lse[bh * Tq + row] : INFINITY;
    delta_s[threadIdx.x] = row < Tq ? delta[bh * Tq + row] : 0.f;
  }
}

// shared floats of a [TR][DH + 1] tile and of a [TR][TR + 1] P or dS tile
template <int DH>
__host__ __device__ constexpr int tile_floats() {
  return Rows<DH>::kTR * (DH + 1);
}
template <int DH>
__host__ __device__ constexpr int p_floats() {
  return Rows<DH>::kTR * (Rows<DH>::kTR + 1);
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
  constexpr int TR = Rows<DH>::kTR, R = TR / 16, kJ = DH / 8;
  constexpr int kLd = DH + 1, kPLd = TR + 1;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + tile_floats<DH>();
  float* q_s = v_s + tile_floats<DH>();
  float* do_s = q_s + tile_floats<DH>();
  float* p_s = do_s + tile_floats<DH>();
  float* ds_s = p_s + p_floats<DH>();
  float* lse_s = ds_s + p_floats<DH>();
  float* delta_s = lse_s + TR;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * TR;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const float* qg = q + b * sq.b + h * sq.h;
  const float* dog = d_o + b * sdo.b + h * sdo.h;
  load_tile<DH, TR>(k_s, k + b * sk.b + h * sk.h, sk.t, k0, Tk);
  load_tile<DH, TR>(v_s, v + b * sv.b + h * sv.h, sv.t, k0, Tk);

  float dk_acc[R][kJ], dv_acc[R][kJ];  // rows: kv R*ty + i; cols: d
  zero(dk_acc);
  zero(dv_acc);
  const int n_qt = (Tq + TR - 1) / TR;
  for (int qt = causal ? (int)blockIdx.y : 0; qt < n_qt; ++qt) {
    const int q0 = qt * TR;
    __syncthreads();  // the previous q tile's products are done
    load_tile<DH, TR>(q_s, qg, sq.t, q0, Tq);
    load_tile<DH, TR>(do_s, dog, sdo.t, q0, Tq);
    load_rows<TR>(lse_s, delta_s, lse, delta, bh, q0, Tq);
    __syncthreads();
    p_and_ds<DH, TR>(q_s, do_s, k_s, v_s, lse_s, delta_s, p_s, ds_s, q0, k0,
                     Tq, Tk, scale, causal, ty, tx);
    __syncthreads();
    tile_product<R, kJ, TR>(dv_acc, p_s, 1, kPLd, do_s, 1, kLd, ty,
                            tx);                                // P^T dO
    tile_product<R, kJ, TR>(dk_acc, ds_s, 1, kPLd, q_s, 1, kLd, ty,
                            tx);                                // dS^T Q
  }

  float* dkg = dk + b * sdk.b + h * sdk.h;
  float* dvg = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + R * ty + i;
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
  constexpr int TR = Rows<DH>::kTR, R = TR / 16, kJ = DH / 8;
  constexpr int kLd = DH + 1, kPLd = TR + 1;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + tile_floats<DH>();
  float* k_s = do_s + tile_floats<DH>();
  float* v_s = k_s + tile_floats<DH>();
  float* ds_s = v_s + tile_floats<DH>();
  float* lse_s = ds_s + p_floats<DH>();
  float* delta_s = lse_s + TR;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * TR;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const float* kg = k + b * sk.b + h * sk.h;
  const float* vg = v + b * sv.b + h * sv.h;
  load_tile<DH, TR>(q_s, q + b * sq.b + h * sq.h, sq.t, q0, Tq);
  load_tile<DH, TR>(do_s, d_o + b * sdo.b + h * sdo.h, sdo.t, q0, Tq);
  load_rows<TR>(lse_s, delta_s, lse, delta, bh, q0, Tq);

  float dq_acc[R][kJ];  // rows: q R*ty + i; cols: d
  zero(dq_acc);
  int n_kt = (Tk + TR - 1) / TR;
  if (causal) n_kt = min(n_kt, (int)blockIdx.y + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TR;
    __syncthreads();  // the previous kv tile's dS K is done
    load_tile<DH, TR>(k_s, kg, sk.t, k0, Tk);
    load_tile<DH, TR>(v_s, vg, sv.t, k0, Tk);
    __syncthreads();
    p_and_ds<DH, TR>(q_s, do_s, k_s, v_s, lse_s, delta_s, nullptr, ds_s, q0,
                     k0, Tq, Tk, scale, causal, ty, tx);
    __syncthreads();
    tile_product<R, kJ, TR>(dq_acc, ds_s, kPLd, 1, k_s, 1, kLd, ty,
                            tx);                                // dS K
  }

  float* dqg = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + R * ty + i;
    if (row >= Tq) continue;
#pragma unroll
    for (int j = 0; j < kJ; ++j)
      dqg[(long long)row * sdq.t + tx + 8 * j] = dq_acc[i][j] * scale;
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
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* d_o, const void* lse,
                       void* delta, void* dq, void* dk, void* dv, int B,
                       int H, int Tq, int Tk, const long long* st,
                       float scale, int causal, cudaStream_t stream) {
  // strides: q 0, k 1, v 2, o 3, do 4, dq 5, dk 6, dv 7
  constexpr int TR = Rows<DH>::kTR;
  const long long rows = (long long)B * H * Tq;
  const int warps = kThreads / 32;
  flash_delta_kernel<DH><<<(unsigned)((rows + warps - 1) / warps),
                              kThreads, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(d_o),
      static_cast<float*>(delta), H, Tq, rows, strides_of(st, 3),
      strides_of(st, 4));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = (4 * tile_floats<DH>() + 2 * p_floats<DH>() + 2 * TR)
                         * sizeof(float);
  err = allow_smem(flash_dkdv_kernel<DH>, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(B * H, (Tk + TR - 1) / TR);
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

  const size_t smem_q = (4 * tile_floats<DH>() + p_floats<DH>() + 2 * TR)
                        * sizeof(float);
  err = allow_smem(flash_dq_kernel<DH>, smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q(B * H, (Tq + TR - 1) / TR);
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

// The backward: dq/dk/dv like q/k/v (their own strides), from q, k, v, o,
// do and the forward's lse, all fp32, Dh 64, 128 or 256, any strides with
// a unit head-dim stride; delta is fp32 [B, H, Tq] scratch. `strides`
// holds 24 values (host memory): [b, h, t] element strides of q, k, v, o,
// do, dq, dk, dv. Causal needs Tq == Tk (the wrapper checks).
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
#define PTPU_BWD_CASE(DH)                                                    \
  case DH:                                                                   \
    return static_cast<int>(launch_bwd<DH>(q, k, v, o, d_o, lse, delta, dq,  \
                                           dk, dv, B, H, Tq, Tk, strides,    \
                                           scale, causal, s));
    PTPU_BWD_CASE(64)
    PTPU_BWD_CASE(128)
    PTPU_BWD_CASE(256)
#undef PTPU_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
