// K4: the fused int8 matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py `_int8_mm_kernel`
// / `int8_matmul` (:577-640), registered there as `int8_matmul` and reached
// from the `fused_int8_matmul` op that quant_rewrite emits for every
// full-int8 dense layer (ops/math.py).
//
// What it computes, for x [M, K] fp32 (rows given by two strides, so the
// lm_head's sliced input is read in place), w [K, N] int8, dq [N] fp32 and
// the activation scale s (rounded to fp32 by the caller):
//
//   q[m, k]   = (int8) clamp(rint(x[m, k] * s), -128, 127)   round half even
//   acc[m, n] = sum_k q[m, k] * w[k, n]                        exact int32
//   out[m, n] = (float) acc[m, n] * dq[n]                      one IEEE mul
//
// the TPU kernel's arithmetic step for step, so the result is bitwise its
// and the plain version's (K < 2^17 keeps |acc| below 2^31).
//
// Bound on the H100: at the LM's shapes (K 512 or 2048, N 512 to 32000) the
// work is bound by bytes, most of them the fp32 output, then the fp32 x:
// about 0.05 ms for an FFN layer at 16384 rows and 0.32 ms for an lm_head
// chunk, against 0.02 and 0.14 ms for its int8 operations at the tensor
// cores' 1979 TOP/s.
//
// Design, a simple first version: one block of 256 threads per 128 x 128
// output tile, walking K in tiles of 32. Each tile of x is read with 16-byte
// loads, quantized in registers and stored to shared memory packed four k
// to a 32-bit word; each tile of w is read four rows of four bytes per
// thread and transposed in registers (__byte_perm) to the same packing, one
// word per (k/4, n). Each thread then keeps an 8 x 8 int32 accumulator and
// issues SIMT __dp4a (4 int8 products a lane and instruction), the next
// tile's global loads in flight meanwhile. The epilogue converts, scales by
// dq and writes the fp32 outputs with 16-byte stores. The SIMT dp4a rate
// (about an eighth of the tensor cores' int8 rate) bounds this version, not
// the bytes: mma.sync / wgmma s8 tiles are the next step.
//
// Tails of M, N and K are bounds-checked in the loads (an element past the
// edge reads as 0, which quantizes to 0 and adds nothing) and the stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // rows of x and out a block
constexpr int BN = 128;        // columns of w and out a block
constexpr int BK = 32;         // k a tile
constexpr int BK4 = BK / 4;    // packed 32-bit words of k a tile
constexpr int THREADS = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr int A_PAD = 4;       // conflict-free packed stores of x

struct Params {
  const float* x;
  int64_t T, s0, s1;           // row m at (m / T) * s0 + (m % T) * s1
  const int8_t* w;
  const float* dq;
  float* out;
  int M, K, N;
  float s;
};

__device__ __forceinline__ uint32_t quant8(float v, float s) {
  float q = rintf(__fmul_rn(v, s));
  q = fminf(fmaxf(q, -128.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

__device__ __forceinline__ int pack4(float4 v, float s) {
  return static_cast<int>(quant8(v.x, s) | (quant8(v.y, s) << 8) |
                          (quant8(v.z, s) << 16) | (quant8(v.w, s) << 24));
}

// VEC_X: K, s0 and s1 multiples of 4 and x 16-byte aligned (float4 loads);
// VEC_W: N a multiple of 4 and w 4-byte aligned (32-bit loads).
template <bool VEC_X, bool VEC_W>
__global__ void __launch_bounds__(THREADS) int8_mm_kernel(Params p) {
  __shared__ __align__(16) int sA[BK4][BM + A_PAD];   // [k/4][m]
  __shared__ __align__(16) int sB[BK4][BN];           // [k/4][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // this thread's loads: x words (row tid/8 + 32 i, k/4 = tid % 8), i < 4;
  // w rows 4 (tid / 32) .. + 3 at columns n0 + 4 (tid % 32) .. + 3
  const int ak4 = tid % 8;
  const float* arow[4];
  bool avalid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tid / 8 + 32 * i;
    avalid[i] = m < p.M;
    const int64_t mm = avalid[i] ? m : 0;
    arow[i] = p.x + (mm / p.T) * p.s0 + (mm % p.T) * p.s1;
  }
  const int bk4 = tid / 32;
  const int bn = n0 + 4 * (tid % 32);

  float4 ra[4];
  uint32_t rb[4];

  auto load = [&](int k0) {
    const int k = k0 + 4 * ak4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (VEC_X) {
        ra[i] = (avalid[i] && k < p.K)
                    ? *reinterpret_cast<const float4*>(arow[i] + k)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const bool ok = avalid[i];
        ra[i].x = (ok && k < p.K) ? arow[i][k] : 0.f;
        ra[i].y = (ok && k + 1 < p.K) ? arow[i][k + 1] : 0.f;
        ra[i].z = (ok && k + 2 < p.K) ? arow[i][k + 2] : 0.f;
        ra[i].w = (ok && k + 3 < p.K) ? arow[i][k + 3] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k0 + 4 * bk4 + j;
      const int8_t* wr = p.w + static_cast<int64_t>(kk) * p.N;
      uint32_t v = 0;
      if (kk < p.K) {
        if (VEC_W) {
          if (bn < p.N) v = *reinterpret_cast<const uint32_t*>(wr + bn);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (bn + c < p.N)
              v |= static_cast<uint32_t>(static_cast<uint8_t>(wr[bn + c]))
                   << (8 * c);
        }
      }
      rb[j] = v;
    }
  };

  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) sA[ak4][tid / 8 + 32 * i] = pack4(ra[i], p.s);
    // 4 rows x 4 columns of bytes -> one word of 4 k per column
    const uint32_t lo01 = __byte_perm(rb[0], rb[1], 0x5140);
    const uint32_t hi01 = __byte_perm(rb[0], rb[1], 0x7362);
    const uint32_t lo23 = __byte_perm(rb[2], rb[3], 0x5140);
    const uint32_t hi23 = __byte_perm(rb[2], rb[3], 0x7362);
    *reinterpret_cast<int4*>(&sB[bk4][4 * (tid % 32)]) = make_int4(
        static_cast<int>(__byte_perm(lo01, lo23, 0x5410)),
        static_cast<int>(__byte_perm(lo01, lo23, 0x7632)),
        static_cast<int>(__byte_perm(hi01, hi23, 0x5410)),
        static_cast<int>(__byte_perm(hi01, hi23, 0x7632)));
  };

  // rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j and 64 + tx*4 + j
  int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  const int nk = (p.K + BK - 1) / BK;
  if (nk > 0) load(0);
  for (int t = 0; t < nk; ++t) {
    store();
    __syncthreads();
    if (t + 1 < nk) load((t + 1) * BK);
#pragma unroll
    for (int k4 = 0; k4 < BK4; ++k4) {
      const int4 a0 = *reinterpret_cast<const int4*>(&sA[k4][ty * 4]);
      const int4 a1 = *reinterpret_cast<const int4*>(&sA[k4][64 + ty * 4]);
      const int4 b0 = *reinterpret_cast<const int4*>(&sB[k4][tx * 4]);
      const int4 b1 = *reinterpret_cast<const int4*>(&sB[k4][64 + tx * 4]);
      const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const int b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float dqv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    dqv[j] = n < p.N ? p.dq[n] : 0.f;
  }
  const bool vec_out = (p.N & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= p.M) continue;
    float* orow = p.out + static_cast<int64_t>(m) * p.N;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int n = n0 + g * 64 + tx * 4;
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        o[c] = __fmul_rn(__int2float_rn(acc[i][g * 4 + c]), dqv[g * 4 + c]);
      if (vec_out && n + 3 < p.N) {
        *reinterpret_cast<float4*>(orow + n) =
            make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n + c < p.N) orow[n + c] = o[c];
      }
    }
  }
}

template <bool VEC_X, bool VEC_W>
void launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  int8_mm_kernel<VEC_X, VEC_W><<<grid, THREADS, 0, stream>>>(p);
}

}  // namespace

// x: fp32, last dim contiguous, row m at (m / T) * s0 + (m % T) * s1
// (elements); w [K, N] int8 and dq [N] fp32, contiguous; out [M, N] fp32,
// contiguous. 1 <= M <= 65535 * 128, 1 <= N, 0 <= K < 2^17 (the wrapper
// checks). Returns cudaGetLastError() after the launch.
extern "C" int ptpu_int8_matmul(const void* x, int64_t T, int64_t s0,
                                int64_t s1, const void* w, const void* dq,
                                void* out, int M, int K, int N,
                                float act_scale, void* stream) {
  Params p;
  p.x = static_cast<const float*>(x);
  p.T = T;
  p.s0 = s0;
  p.s1 = s1;
  p.w = static_cast<const int8_t*>(w);
  p.dq = static_cast<const float*>(dq);
  p.out = static_cast<float*>(out);
  p.M = M;
  p.K = K;
  p.N = N;
  p.s = act_scale;
  const bool vec_x = K % 4 == 0 && s0 % 4 == 0 && s1 % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec_x && vec_w) {
    launch<true, true>(p, st);
  } else if (vec_x) {
    launch<true, false>(p, st);
  } else if (vec_w) {
    launch<false, true>(p, st);
  } else {
    launch<false, false>(p, st);
  }
  return static_cast<int>(cudaGetLastError());
}
