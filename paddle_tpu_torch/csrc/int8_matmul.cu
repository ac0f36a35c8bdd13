// K4: the fused int8 matmul for Hopper (sm_90a), on the tensor cores.
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
// and the plain version's (K < 2^17 keeps |acc| below 2^31; integer sums
// are exact in any order, so the tensor cores change nothing).
//
// Bound on the H100: at the LM's shapes (K 512 or 2048, N 512 to 32000) the
// work is bound by bytes, most of them the fp32 output, then the fp32 x:
// about 0.05 ms for an FFN layer at 16384 rows and 0.32 ms for an lm_head
// chunk, against 0.02 and 0.14 ms for its int8 operations at the tensor
// cores' 1979 TOP/s.
//
// Design: two launches on the caller's stream, one call of the wrapper.
// - int8_mm_prep_kernel quantizes x once into xq [M, Kp] int8 (Kp = K
//   rounded up to 128, zeros past K: they add nothing) and transposes w into
//   wt [N, Kp] int8 through 64 x 64 shared-memory tiles. Quantizing inside
//   the product would redo every x element once per column tile, N / 128
//   times (250 times at the lm_head); here each is read and quantized once,
//   at a cost of 2 (M + N) Kp bytes beyond the bound's (xq and wt each
//   written and read back): 11% and 4% of the bound's bytes at FFN1 and the
//   lm_head, 41% at FFN2 (K 2048, N 512), where xq is a quarter of x.
// - int8_mm_gemm_kernel multiplies with mma.sync m16n8k32 s8 x s8 -> s32.
//   Both operands are then K-major, as the int8 tensor cores want them:
//   one block of 8 warps per 128 x 128 output tile, each warp 64 x 32 (4 x 4
//   m16n8 accumulators); a 3-stage ring of 128-k stages loaded with 16-byte
//   cp.async (rows past M or N zero-filled), the next two stages in flight
//   while the current one is multiplied; rows of 128 bytes with the 16-byte
//   chunk c of row r at chunk c ^ (r & 7), so each ldmatrix.x4 (which gives
//   exactly the m16n8k32 A fragment, or two B fragments) reads 8 rows from
//   8 different bank groups. The epilogue stages the int32 sums through
//   the ring (row stride 136 words: conflict-free 8-byte writes), then each
//   warp converts a row at a time, scales by dq and writes 512 contiguous
//   bytes with streaming 16-byte stores (st.global.cs: nothing reads the
//   output back before the next op). Launch bounds keep two blocks an SM,
//   so one block's epilogue overlaps the other's products.
// wgmma (Hopper's warpgroup product, both s8 operands K-major in shared
// memory) is the next step if the products ever bound the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BM = 128;                    // rows of out a block
constexpr int BN = 128;                    // columns of out a block
constexpr int BK = 128;                    // k a stage: one 128-byte row
constexpr int STAGES = 3;
constexpr int THREADS = 256;               // 8 warps: 2 (m) x 4 (n)
constexpr int kStageBytes = (BM + BN) * BK;
constexpr int kSmemBytes = STAGES * kStageBytes;    // 96 KB
constexpr int kOutLd = BN + 8;             // staged int32 row stride
static_assert(BM * kOutLd * 4 <= kSmemBytes, "epilogue fits the ring");
static_assert(BM == BN, "load_stage loads 128 rows of either operand");

constexpr int kPrepThreads = 256;
constexpr int kTT = 64;                    // w transpose tile, k and n

struct PrepParams {
  const float* x;
  int64_t T, s0, s1;           // row m at (m / T) * s0 + (m % T) * s1
  const int8_t* w;             // [K, N]
  int8_t* xq;                  // [M, Kp]
  int8_t* wt;                  // [N, Kp]
  int M, K, N, Kp;
  float s;
  int x_blocks;                // blocks that quantize x; the rest transpose w
};

struct GemmParams {
  const int8_t* xq;
  const int8_t* wt;
  const float* dq;
  float* out;                  // [M, N]
  int M, N, Kp;
};

__device__ __forceinline__ uint32_t quant8(float v, float s) {
  float q = rintf(__fmul_rn(v, s));
  q = fminf(fmaxf(q, -128.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

__device__ __forceinline__ uint32_t pack4(float4 v, float s) {
  return quant8(v.x, s) | (quant8(v.y, s) << 8) | (quant8(v.z, s) << 16) |
         (quant8(v.w, s) << 24);
}

// VEC_X: K, s0 and s1 multiples of 4 and x 16-byte aligned (float4 loads).
template <bool VEC_X>
__global__ void __launch_bounds__(kPrepThreads)
int8_mm_prep_kernel(PrepParams p) {
  __shared__ uint8_t tile[kTT][kTT + 4];
  if (static_cast<int>(blockIdx.x) < p.x_blocks) {
    // one thread a 16-k chunk of a row of xq
    const int chunks = p.Kp / 16;
    const int64_t total = static_cast<int64_t>(p.M) * chunks;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kPrepThreads +
                     threadIdx.x;
         i < total; i += static_cast<int64_t>(p.x_blocks) * kPrepThreads) {
      const int m = static_cast<int>(i / chunks);
      const int k0 = static_cast<int>(i % chunks) * 16;
      const float* row = p.x + (m / p.T) * p.s0 + (m % p.T) * p.s1;
      uint32_t wd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 4 * j;
        float4 v;
        if (VEC_X) {
          v = k < p.K ? *reinterpret_cast<const float4*>(row + k)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          v.x = k < p.K ? row[k] : 0.f;
          v.y = k + 1 < p.K ? row[k + 1] : 0.f;
          v.z = k + 2 < p.K ? row[k + 2] : 0.f;
          v.w = k + 3 < p.K ? row[k + 3] : 0.f;
        }
        wd[j] = pack4(v, p.s);
      }
      *reinterpret_cast<uint4*>(p.xq + static_cast<int64_t>(m) * p.Kp + k0) =
          make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
    return;
  }
  // w [K, N] -> wt [N, Kp], 64 x 64 tiles through shared memory
  const int tiles_n = (p.N + kTT - 1) / kTT;
  const int64_t tiles = static_cast<int64_t>(p.Kp / kTT) * tiles_n;
  const int stride = static_cast<int>(gridDim.x) - p.x_blocks;
  for (int64_t tt = static_cast<int>(blockIdx.x) - p.x_blocks; tt < tiles;
       tt += stride) {
    const int k0 = static_cast<int>(tt / tiles_n) * kTT;
    const int n0 = static_cast<int>(tt % tiles_n) * kTT;
    __syncthreads();  // the previous tile's reads are done
    for (int i = threadIdx.x; i < kTT * kTT; i += kPrepThreads) {
      const int r = i / kTT, c = i % kTT, k = k0 + r, n = n0 + c;
      tile[r][c] = (k < p.K && n < p.N)
                       ? static_cast<uint8_t>(
                             p.w[static_cast<int64_t>(k) * p.N + n])
                       : 0;
    }
    __syncthreads();
    // column c of the tile, k 16 kc .. 16 kc + 15: one 16-byte store
    const int c = threadIdx.x >> 2, kc = threadIdx.x & 3;
    if (n0 + c < p.N) {
      uint32_t wd[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * kc + 4 * j;
        wd[j] = tile[r][c] | (tile[r + 1][c] << 8) | (tile[r + 2][c] << 16) |
                (static_cast<uint32_t>(tile[r + 3][c]) << 24);
      }
      *reinterpret_cast<uint4*>(p.wt + static_cast<int64_t>(n0 + c) * p.Kp +
                                k0 + 16 * kc) =
          make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a swizzled [rows][128] stage.
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + 128) of a [rows, Kp] int8 matrix, k [k0, k0 + 128),
// into a swizzled stage; rows at or past n are zero-filled (and read
// nothing).
__device__ __forceinline__ void load_stage(uint8_t* s, const int8_t* g,
                                           int Kp, int row0, int n, int k0) {
#pragma unroll
  for (int it = 0; it < BM * (BK / 16) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i >> 3, c = i & 7, row = row0 + r;
    const bool in = row < n;
    cp_async16(s + swz(r, c),
               g + static_cast<int64_t>(in ? row : 0) * Kp + k0 + c * 16,
               in);
  }
}

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const uint8_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b, one m16n8k32 product of int8, exact int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS, 2)
int8_mm_gemm_kernel(GemmParams p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;   // rows 64 wm, columns 32 wn
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = p.Kp / BK;

  auto load = [&](int st, int kt) {
    uint8_t* s = smem + st * kStageBytes;
    load_stage(s, p.xq, p.Kp, m0, p.M, kt * BK);
    load_stage(s + BM * BK, p.wt, p.Kp, n0, p.N, kt * BK);
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    // stage kt has landed for every thread, and every warp is done with
    // stage kt - 1, which the next load overwrites
    __syncthreads();
    if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES,
                                   kt + STAGES - 1);
    cp_async_commit();
    const uint8_t* sa = smem + (kt % STAGES) * kStageBytes;
    const uint8_t* sb = sa + BM * BK;
#pragma unroll
    for (int kc = 0; kc < BK / 32; ++kc) {
      unsigned a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm4(a[i], sa + swz(64 * wm + 16 * i + (lane & 15),
                             2 * kc + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm4(b[j], sb + swz(32 * wn + 16 * j + (lane & 7) +
                                 ((lane >> 4) << 3),
                             2 * kc + ((lane >> 3) & 1)));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_s8(acc[i][2 * j], a[i], b[j][0], b[j][1]);
          mma_s8(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it holds the sums

  int* so = reinterpret_cast<int*>(smem);  // [BM][kOutLd]
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 64 * wm + 16 * i + g, c = 32 * wn + 8 * j + 2 * t;
      *reinterpret_cast<int2*>(so + r * kOutLd + c) =
          make_int2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<int2*>(so + (r + 8) * kOutLd + c) =
          make_int2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  // warp w writes rows w, w + 8, ...; lane l columns 4 l .. 4 l + 3
  const int c = 4 * lane, n = n0 + c;
  const float4 d = make_float4(n < p.N ? p.dq[n] : 0.f,
                               n + 1 < p.N ? p.dq[n + 1] : 0.f,
                               n + 2 < p.N ? p.dq[n + 2] : 0.f,
                               n + 3 < p.N ? p.dq[n + 3] : 0.f);
  const bool vec = (p.N & 3) == 0;   // rows of out 16-byte aligned
  for (int r = warp; r < BM && m0 + r < p.M; r += THREADS / 32) {
    const int4 v = *reinterpret_cast<const int4*>(so + r * kOutLd + c);
    const float4 o = make_float4(__fmul_rn(__int2float_rn(v.x), d.x),
                                 __fmul_rn(__int2float_rn(v.y), d.y),
                                 __fmul_rn(__int2float_rn(v.z), d.z),
                                 __fmul_rn(__int2float_rn(v.w), d.w));
    float* dst = p.out + static_cast<int64_t>(m0 + r) * p.N + n;
    if (vec) {
      if (n < p.N) __stcs(reinterpret_cast<float4*>(dst), o);
    } else {
      if (n < p.N) __stcs(dst, o.x);
      if (n + 1 < p.N) __stcs(dst + 1, o.y);
      if (n + 2 < p.N) __stcs(dst + 2, o.z);
      if (n + 3 < p.N) __stcs(dst + 3, o.w);
    }
  }
}

int cdiv(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }

}  // namespace

// x: fp32, last dim contiguous, row m at (m / T) * s0 + (m % T) * s1
// (elements); w [K, N] int8 and dq [N] fp32, contiguous; out [M, N] fp32,
// contiguous; xq [M, Kp] and wt [N, Kp] int8 scratch, 16-byte aligned, Kp
// = K rounded up to a multiple of 128. 1 <= M <= 65535 * 128, 1 <= N, 0 <=
// K < 2^17 (the wrapper checks). Launches the prep pass and the product;
// returns cudaGetLastError() after each.
extern "C" int ptpu_int8_matmul(const void* x, int64_t T, int64_t s0,
                                int64_t s1, const void* w, const void* dq,
                                void* out, void* xq, void* wt, int M, int K,
                                int N, int Kp, float act_scale,
                                void* stream) {
  if (Kp % BK != 0 || Kp < K) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PrepParams pp;
  pp.x = static_cast<const float*>(x);
  pp.T = T;
  pp.s0 = s0;
  pp.s1 = s1;
  pp.w = static_cast<const int8_t*>(w);
  pp.xq = static_cast<int8_t*>(xq);
  pp.wt = static_cast<int8_t*>(wt);
  pp.M = M;
  pp.K = K;
  pp.N = N;
  pp.Kp = Kp;
  pp.s = act_scale;
  // grid-stride loops over a grid of at most 8 blocks an SM per part
  pp.x_blocks = std::max(
      1, std::min(cdiv(static_cast<int64_t>(M) * (Kp / 16), kPrepThreads),
                  132 * 8));
  const int64_t w_tiles = static_cast<int64_t>(Kp / kTT) * cdiv(N, kTT);
  const int w_blocks = static_cast<int>(std::min<int64_t>(w_tiles, 132 * 4));
  const bool vec_x = K % 4 == 0 && s0 % 4 == 0 && s1 % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec_x) {
    int8_mm_prep_kernel<true>
        <<<pp.x_blocks + w_blocks, kPrepThreads, 0, st>>>(pp);
  } else {
    int8_mm_prep_kernel<false>
        <<<pp.x_blocks + w_blocks, kPrepThreads, 0, st>>>(pp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(int8_mm_gemm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  GemmParams gp;
  gp.xq = static_cast<const int8_t*>(xq);
  gp.wt = static_cast<const int8_t*>(wt);
  gp.dq = static_cast<const float*>(dq);
  gp.out = static_cast<float*>(out);
  gp.M = M;
  gp.N = N;
  gp.Kp = Kp;
  const dim3 grid(cdiv(N, BN), cdiv(M, BM));
  int8_mm_gemm_kernel<<<grid, THREADS, kSmemBytes, st>>>(gp);
  return static_cast<int>(cudaGetLastError());
}
