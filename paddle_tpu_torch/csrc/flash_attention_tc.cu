// Flash attention, forward and backward, in bf16 or fp16 on Hopper's
// tensor cores (sm_90a). bf16 (or fp16) in and out, fp32 accumulators: the
// kernels are templates on the element type, instantiated for both (the
// tc and fp16 entry points at the end); head dim 64, 128 or 256
// (a template parameter, instantiated for each; the wrapper pads any
// other head dim up to the next of them), and any multiple of 128 above
// 256 (the wide kernels, kWide below).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
// `flash_attention` (:120) -> `_flash_fwd` (:162, pl.pallas_call :191,
// body `_fwd_kernel` :58), and its backward `_flash_bwd_rule` (:212; on a
// TPU jax's library Pallas backward, :131-150). On the training path of
// the Fluid-API Transformer LM (bf16 under the AMP decorators, fp16 under
// amp.decorate(dtype="float16")) it runs once per layer forward and once
// per layer backward. fp32 inputs take
// flash_attention_f32tc.cu (forward) and flash_attention_f32tc_bwd.cu
// (backward).
//
// What it computes, per (batch b, head h): O = softmax(Q K^T * scale) V
// over q [Tq, Dh] and k, v [Tk, Dh], keys at positions >= Tk masked and,
// when causal (Tq == Tk), keys after the query's position masked. The
// forward also writes the row log-sum-exp of the scaled scores (fp32
// [B, H, Tq]); the backward rebuilds P from it.
//
// Bound. At the path's shape (B 160, H 8, T 512, causal) the forward
// moves 336 MB (q, k, v in, o out) and does 43 GFLOP, the backward 671 MB
// and 107 GFLOP (the 10 Dh flops a visible pair that the math needs): on
// 3.35 TB/s and 989 TFLOP/s both are bound by bytes, at 0.10 and 0.20 ms.
// So the design keeps every intermediate (S, P, dP, dS) in registers,
// reads each tile from device memory once per block with 16-byte copies
// that overlap the products, and feeds the tensor cores from shared
// memory without bank conflicts; the backward's recompute (S and dP in
// both passes, 14 Dh flops a pair) costs operations, not bytes.
//
// Design.
// - Products: mma.sync m16n8k16 bf16 x bf16 -> fp32. Each warp owns 16
//   rows of the block's tile and keeps its accumulators in registers.
//   The forward takes 128 query rows a block (8 warps; 64 rows in 4 warps
//   measured slower), the backward 64 rows (4 warps); launch
//   bounds hold registers to what lets 16 (forward) or 12 (backward)
//   warps share an SM at Dh 64, more occupancy being worth a few spilled
//   bytes; at Dh 128, where each warp's O (or dK and dV) accumulators and
//   Q fragments double, to 8 warps an SM in either pass (Bounds below).
//   At Dh 256 a warp's 16 x 256 O alone would take 128 registers: there
//   each block accumulates one 128-column half of O (dK and dV, dQ) and
//   the grid's z index picks the half; both halves' blocks form the same
//   S, P (and dP, dS), so those products are done twice. Q is read from
//   shared memory per k step instead of kept in registers.
// - The online softmax runs on the S accumulator fragments: a thread holds
//   two rows, the row max and (at the end) the row sum reduce over the 4
//   lanes of a quad. The fp32 accumulator layout of two neighbouring
//   m16n8 tiles is the A-operand layout of an m16n8k16 product, so P (and
//   in the backward dS) is rounded to bf16 in registers and multiplied
//   from there: it never goes to shared memory.
// - Tiles are bf16 in shared memory, [rows][Dh] with the 16-byte chunk c
//   of row r stored at chunk c ^ (r & 7), so the 8 rows an ldmatrix phase
//   reads fall in 8 different bank groups (a row is 8 chunks at Dh 64 and
//   16 at Dh 128: the XOR moves a chunk within its aligned group of 8,
//   whose 128 bytes span every bank). They are loaded with 16-byte
//   cp.async.cg (rows past T zero-filled, src-size 0, never written back)
//   and read with ldmatrix.x4, .trans where the operand is needed
//   transposed (V in P V; dO and Q in the backward's P^T dO, dS^T Q; K in
//   dS K).
// - A ring of 2 stages: the next tile is in flight while the current one
//   is multiplied; one cp.async.wait_group and one barrier a tile.
// - Causal: a block loops only over the tiles at or below its diagonal;
//   only the diagonal tile and ragged tails are masked. The heaviest
//   blocks (most tiles) come first in the grid.
// - Backward, deterministic (no atomics, so results do not depend on the
//   order blocks run in): delta = rowsum(dO * O); a dK/dV pass, one block
//   per (b*h, 64-key tile) walking the q tiles, computing S^T = K Q^T and
//   dP^T = V dO^T so that P^T and dS^T = P^T (dP^T - delta) sit in the
//   accumulator layout and feed dV += P^T dO and dK += dS^T Q as register
//   A operands; a dQ pass, one block per (b*h, 64-query tile) walking the
//   kv tiles, dQ += dS K.
//
// Numerics. bf16 x bf16 (fp16 x fp16) products are exact in fp32 and
// every sum is fp32.
// The softmax is fp32 with exp2f on scores prescaled by scale * log2(e).
// P, and in the backward P^T and dS, are rounded to the element type
// (round to nearest even) before the second
// product, as the JAX package's softmax attention rounds P to q's dtype
// (paddle_tpu/ops/compat_ops.py:632) and as SDPA does. lse stays fp32; a
// row whose keys are all masked uses 0 as its max, so no NaN can arise
// (it ends with l = 0, O = 0 and lse = +inf, for which the backward's P is
// exactly 0), as in flash_attention_f32tc.cu. delta uses the O the forward
// wrote, in the element type. fp16 has bf16's rounding plus 3 bits and a
// narrow range: the caller's loss scaling keeps dS and the grads inside it
// (an overflow writes inf, which dynamic loss scaling sees).
//
// Interface: plain C functions (bound with ctypes), launched on the
// caller's stream, allocating nothing; each returns cudaGetLastError().
// The caller guarantees 16-byte aligned rows: base addresses and every
// [B, H, T] stride multiples of 8 elements. Each launch first allows its
// dynamic shared memory (48 to 193 KB) with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using fp16 = __half;

// The element type: every kernel below is a template on it, instantiated
// for bf16 and fp16. Tiles, copies and ldmatrix fragments are 16-bit
// either way; only the product's input type and the rounding of fp32
// values (P, dS, the outputs) to it differ.
template <typename T>
struct Elem;
template <>
struct Elem<bf16> {
  // d += a b, one m16n8k16 product
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(unsigned u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
};
template <>
struct Elem<fp16> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(unsigned u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
};

constexpr int kTile = 64;                  // kv rows a tile; bwd block rows
constexpr int kFwdRows = 128;              // fwd block rows: 8 warps x 16
constexpr int kFwdThreads = 2 * kFwdRows;
constexpr int kBwdThreads = 128;           // 4 warps x 16 rows

// Blocks an SM each pass's launch bounds ask for, by head dim.
template <int DH>
struct Bounds;
// Dh 64: forward 2 (at most 128 registers a thread), backward 3 (168): the
// dK/dV pass spills a few bytes at that limit and still runs faster than
// at 2 blocks
template <>
struct Bounds<64> {
  static constexpr int kFwd = 2, kBwd = 3;
};
// Dh 128: the O accumulator and Q fragments (forward) and dK, dV (dK/dV
// pass) double; 1 forward block (255 registers) and 2 backward blocks
// (255) keep them in registers
template <>
struct Bounds<128> {
  static constexpr int kFwd = 1, kBwd = 2;
};
// Dh 256: each block accumulates 128 columns of O (dK and dV, dQ), so
// the accumulators are Dh 128's; the tiles take 192 KB (one block an SM)
template <>
struct Bounds<256> {
  static constexpr int kFwd = 1, kBwd = 1;
};
// Output columns a block accumulates: the whole head up to Dh 128; at Dh
// 256 one half, the grid's z index choosing which (S and dP are formed
// by both halves' blocks)
template <int DH>
constexpr int kOut = DH < 128 ? DH : 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {  // element strides of one [B, H, T, Dh] tensor
  long long b, h, t;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk c (8 elements) of row r in a swizzled
// [rows][DH] tile.
template <int DH>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DH + ((c ^ (r & 7)) << 3);
}

// log2 of the 16-byte chunks a row holds (DH / 8): rows and chunks of a
// flat chunk index by shift and mask
template <int DH>
constexpr int kChunkShift = DH == 64 ? 3 : (DH == 128 ? 4 : 5);

template <typename T>
__device__ __forceinline__ void cp_async16(T* dst, const T* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [row0, row0 + R) of one (b, h) slice into a swizzled tile, 16 bytes
// a copy; rows at or past n are zero-filled (and read nothing).
template <int R, int kThreads, int DH, typename T>
__device__ __forceinline__ void load_tile(T* s, const T* g,
                                          long long st, int row0, int n) {
  constexpr int kChunks = DH / 8;          // 16-byte chunks a row
  static_assert(kChunks == 1 << kChunkShift<DH>, "chunk shift");
  static_assert(R * kChunks % kThreads == 0, "tile chunks per thread");
#pragma unroll
  for (int it = 0; it < R * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i >> kChunkShift<DH>, c = i & (kChunks - 1);
    const int row = row0 + r;
    const bool in = row < n;
    cp_async16(s + swz<DH>(r, c), g + (long long)(in ? row : 0) * st + c * 8,
               in);
  }
}

// 64 fp32 row values (lse or delta) starting at row0; past n zero-filled
__device__ __forceinline__ void load_rows(float* s, const float* g, int row0,
                                          int n) {
  if (threadIdx.x < kTile) {
    const int row = row0 + threadIdx.x;
    const bool in = row < n;
    cp_async4(s + threadIdx.x, g + (in ? row : 0), in);
  }
}

template <typename T>
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const T* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
template <typename T>
__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const T* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A operand (16 rows x 16 k): rows [r0, r0 + 16), k chunk kc (k 16 kc ..
// 16 kc + 15) of a swizzled [rows][DH] tile.
template <int DH, typename T>
__device__ __forceinline__ void load_a(unsigned (&a)[4], const T* s,
                                       int r0, int kc, int lane) {
  ldsm4(a, s + swz<DH>(r0 + (lane & 15), 2 * kc + (lane >> 4)));
}

// B operands of two n8 tiles from a tile stored [n][k] (K for Q K^T):
// b[0..1] for n rows [n0, n0 + 8), b[2..3] for [n0 + 8, n0 + 16), k chunk
// kc.
template <int DH, typename T>
__device__ __forceinline__ void load_b(unsigned (&b)[4], const T* s,
                                       int n0, int kc, int lane) {
  ldsm4(b, s + swz<DH>(n0 + (lane & 7) + ((lane >> 4) << 3),
                       2 * kc + ((lane >> 3) & 1)));
}

// B operands of two n8 tiles from a tile stored [k][n] (V for P V): k
// rows [16 kc, 16 kc + 16), b[0..1] for n columns [16 np, 16 np + 8),
// b[2..3] for [16 np + 8, 16 np + 16).
template <int DH, typename T>
__device__ __forceinline__ void load_bt(unsigned (&b)[4], const T* s,
                                        int kc, int np, int lane) {
  ldsm4_t(b, s + swz<DH>(16 * kc + (lane & 7) + (((lane >> 3) & 1) << 3),
                         2 * np + (lane >> 4)));
}

// acc[DO/8][4] (16 rows x DO columns from column 16 np0 on) += A (16
// rows x 64 k, from registers a[4][4]) times a [k][n] tile: the second
// product of every pass.
template <int DH, int DO, typename T>
__device__ __forceinline__ void mma_rows_kn(float (&acc)[DO / 8][4],
                                            const unsigned (&a)[4][4],
                                            const T* s, int np0,
                                            int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int np = 0; np < DO / 16; ++np) {
      unsigned b[4];
      load_bt<DH>(b, s, kc, np0 + np, lane);
      Elem<T>::mma(acc[2 * np], a[kc], b[0], b[1]);
      Elem<T>::mma(acc[2 * np + 1], a[kc], b[2], b[3]);
    }
}

// acc[8][4] (16 rows x 64 n) = rows [r0, r0 + 16) of tile a_s times the
// transpose of the [n][k] tile b_s, k over DH: the first products (Q K^T
// and its kin); kZero false adds to acc (a head-dim chunk of the sum).
template <int DH, bool kZero = true, typename T>
__device__ __forceinline__ void mma_rows_nk(float (&acc)[8][4],
                                            const T* a_s, int r0,
                                            const T* b_s, int lane) {
  if (kZero) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    unsigned a[4];
    load_a<DH>(a, a_s, r0, kc, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      load_b<DH>(b, b_s, 16 * np, kc, lane);
      Elem<T>::mma(acc[2 * np], a, b[0], b[1]);
      Elem<T>::mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Accumulators (16 rows x 64 k) rounded to the element type as A operands: k chunk j
// is n8 tiles 2j and 2j + 1.
template <typename T>
__device__ __forceinline__ void to_a(unsigned (&a)[4][4],
                                     const float (&x)[8][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = Elem<T>::pack(x[2 * j][0], x[2 * j][1]);
    a[j][1] = Elem<T>::pack(x[2 * j][2], x[2 * j][3]);
    a[j][2] = Elem<T>::pack(x[2 * j + 1][0], x[2 * j + 1][1]);
    a[j][3] = Elem<T>::pack(x[2 * j + 1][2], x[2 * j + 1][3]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Writes a warp's 16 x DO accumulator (times `mul`) as element-type rows [row0,
// row0 + 16) of g (its first column), rows at or past n skipped: through
// the warp's own 16 rows of a swizzled [rows][DH] tile `s` (free by
// then), so that every global store is 16 bytes and DO / 8 lanes write
// one row.
template <int DH, int DO, typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[DO / 8][4],
                                           float mul_lo, float mul_hi,
                                           T* s, T* g, long long st,
                                           int row0, int n, int lane) {
  constexpr int kChunks = DO / 8;
  constexpr int kShift = kChunkShift<DO>;
  const int grp = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    *reinterpret_cast<unsigned*>(s + swz<DH>(grp, j) + 2 * t) =
        Elem<T>::pack(acc[j][0] * mul_lo, acc[j][1] * mul_lo);
    *reinterpret_cast<unsigned*>(s + swz<DH>(grp + 8, j) + 2 * t) =
        Elem<T>::pack(acc[j][2] * mul_hi, acc[j][3] * mul_hi);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + 32 * it;
    const int r = i >> kShift, c = i & (kChunks - 1);
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(g + (long long)(row0 + r) * st + c * 8) =
          *reinterpret_cast<const uint4*>(s + swz<DH>(r, c));
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kFwdThreads, Bounds<DH>::kFwd)
flash_tc_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int H, int Tq, int Tk,
                    Strides sq, Strides sk, Strides sv, Strides so,
                    float scale, int causal) {
  constexpr int kRows = kFwdRows, kThreads = kFwdThreads;
  constexpr int kTileElems = kTile * DH;
  constexpr int DO = kOut<DH>;
  // Q's fragments stay in registers up to Dh 128; at 256 they are read
  // from q_s per k step
  constexpr bool kQReg = DH <= 128;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kRows * DH;           // 2 stages
  T* v_s = k_s + 2 * kTileElems;       // 2 stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_qt = (Tq + kRows - 1) / kRows;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y)
                 * kRows;
  const T* qg = q + b * sq.b + h * sq.h;
  const T* kg = k + b * sk.b + h * sk.h;
  const T* vg = v + b * sv.b + h * sv.h;
  int n_kt = (Tk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (q0 + kRows - 1) / kTile + 1);

  load_tile<kRows, kThreads, DH>(q_s, qg, sq.t, q0, Tq);
  load_tile<kTile, kThreads, DH>(k_s, kg, sk.t, 0, Tk);
  load_tile<kTile, kThreads, DH>(v_s, vg, sv.t, 0, Tk);
  cp_async_commit();

  const float c = scale * kLog2e;
  const int row_w = q0 + 16 * warp;       // the warp's first row
  const int r_lo = row_w + grp, r_hi = r_lo + 8;
  const int col0 = blockIdx.z * DO;       // the block's columns of O
  unsigned qf[kQReg ? DH / 16 : 1][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DO / 8][4];
#pragma unroll
  for (int n = 0; n < DO / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    // tile kt has landed for every thread, and every warp is done with
    // tile kt - 1, whose stage the next load overwrites
    __syncthreads();
    if (kt + 1 < n_kt) {
      const int st = (kt + 1) & 1;
      load_tile<kTile, kThreads, DH>(k_s + st * kTileElems, kg, sk.t,
                                     (kt + 1) * kTile, Tk);
      load_tile<kTile, kThreads, DH>(v_s + st * kTileElems, vg, sv.t,
                                     (kt + 1) * kTile, Tk);
    }
    cp_async_commit();
    if (kQReg && kt == 0) {
#pragma unroll
      for (int kc = 0; kc < (kQReg ? DH / 16 : 0); ++kc)
        load_a<DH>(qf[kc], q_s, 16 * warp, kc, lane);
    }
    const int k0 = kt * kTile;
    if (causal && k0 > row_w + 15) continue;   // all after the warp's rows
    const T* ks = k_s + (kt & 1) * kTileElems;
    const T* vs = v_s + (kt & 1) * kTileElems;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc) {
      unsigned qa[4];
      if (kQReg) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kQReg ? kc : 0][e];
      } else {
        load_a<DH>(qa, q_s, 16 * warp, kc, lane);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bb[4];
        load_b<DH>(bb, ks, 16 * np, kc, lane);
        Elem<T>::mma(s[2 * np], qa, bb[0], bb[1]);
        Elem<T>::mma(s[2 * np + 1], qa, bb[2], bb[3]);
      }
    }

    const bool edge = (causal && k0 + kTile - 1 > row_w) || k0 + kTile > Tk;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * c;
        if (edge) {
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          if (col >= Tk || (causal && col > (e < 2 ? r_lo : r_hi)))
            x = -INFINITY;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mu[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      mu[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      alpha[i] = exp2f(m[i] - mu[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - mu[e >> 1]);
        sum[e >> 1] += s[n][e];
        acc[n][e] *= alpha[e >> 1];
      }
#pragma unroll
    for (int n = 8; n < DO / 8; ++n)   // 128 columns: the other half of O
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
    unsigned pa[4][4];
    to_a<T>(pa, s);
    mma_rows_kn<DH, DO>(acc, pa, vs, col0 / 16, lane);  // O += P V
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  if (t == 0 && blockIdx.z == 0) {
    if (r_lo < Tq)
      lse[(long long)bh * Tq + r_lo] =
          l[0] > 0.f ? m[0] * kLn2 + logf(l[0]) : INFINITY;
    if (r_hi < Tq)
      lse[(long long)bh * Tq + r_hi] =
          l[1] > 0.f ? m[1] * kLn2 + logf(l[1]) : INFINITY;
  }
  // the warp's own rows of q_s: only this warp read them
  __syncwarp();
  store_rows<DH, DO>(acc, inv[0], inv[1], q_s + 16 * warp * DH,
                     o + b * so.b + h * so.h + col0, so.t, row_w, Tq, lane);
}

// delta[b, h, t] = sum_d dO * O in fp32, 8 lanes a row (16 bytes each,
// DH / 64 times; DH 0: the head dim dh, a multiple of 64, given at run
// time)
template <typename T, int DH>
__global__ void __launch_bounds__(kBwdThreads)
flash_tc_delta_kernel(const T* __restrict__ o,
                      const T* __restrict__ d_o, float* __restrict__ delta,
                      int H, int Tq, long long rows, Strides so,
                      Strides sdo, int dh) {
  const long long row = (long long)blockIdx.x * (kBwdThreads / 8)
                        + (threadIdx.x >> 3);
  const int part = threadIdx.x & 7;
  float acc = 0.f;
  if (row < rows) {
    const long long bh = row / Tq;
    const int tq = (int)(row % Tq), b = (int)(bh / H), h = (int)(bh % H);
#pragma unroll
    for (int u = 0; u < (DH ? DH : dh) / 64; ++u) {
      const int c = part + 8 * u;
      const uint4 ov = *reinterpret_cast<const uint4*>(
          o + b * so.b + h * so.h + tq * so.t + c * 8);
      const uint4 dv = *reinterpret_cast<const uint4*>(
          d_o + b * sdo.b + h * sdo.h + tq * sdo.t + c * 8);
      const unsigned* op = reinterpret_cast<const unsigned*>(&ov);
      const unsigned* dp = reinterpret_cast<const unsigned*>(&dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = Elem<T>::unpack(op[i]);
        const float2 d = Elem<T>::unpack(dp[i]);
        acc = fmaf(a.x, d.x, acc);
        acc = fmaf(a.y, d.y, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (row < rows && part == 0) delta[row] = acc;
}

// One block per (b*h, 64-key tile): dK and dV of its keys, walking the q
// tiles (from the diagonal on when causal) with the next q tile's Q, dO,
// lse and delta in flight.
template <typename T, int DH>
__global__ void __launch_bounds__(kBwdThreads, Bounds<DH>::kBwd)
flash_tc_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ d_o,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Tq, int Tk,
                     Strides sq, Strides sk, Strides sv, Strides sdo,
                     Strides sdk, Strides sdv, float scale, int causal) {
  constexpr int kTileElems = kTile * DH;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kTileElems;
  T* q_s = v_s + kTileElems;           // 2 stages
  T* do_s = q_s + 2 * kTileElems;      // 2 stages
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTileElems);  // 2 x 64
  float* dl_s = lse_s + 2 * kTile;                                  // 2 x 64
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kt = blockIdx.y, k0 = kt * kTile;
  const T* qg = q + b * sq.b + h * sq.h;
  const T* dog = d_o + b * sdo.b + h * sdo.h;
  const float* lg = lse + (long long)bh * Tq;
  const float* dg = delta + (long long)bh * Tq;
  const int n_qt = (Tq + kTile - 1) / kTile;
  const int qt0 = causal ? kt : 0;

  load_tile<kTile, kBwdThreads, DH>(k_s, k + b * sk.b + h * sk.h, sk.t, k0,
                                    Tk);
  load_tile<kTile, kBwdThreads, DH>(v_s, v + b * sv.b + h * sv.h, sv.t, k0,
                                    Tk);
  load_tile<kTile, kBwdThreads, DH>(q_s, qg, sq.t, qt0 * kTile, Tq);
  load_tile<kTile, kBwdThreads, DH>(do_s, dog, sdo.t, qt0 * kTile, Tq);
  load_rows(lse_s, lg, qt0 * kTile, Tq);
  load_rows(dl_s, dg, qt0 * kTile, Tq);
  cp_async_commit();

  constexpr int DO = kOut<DH>;
  const int col0 = blockIdx.z * DO;       // the block's columns of dK, dV
  const float c = scale * kLog2e;
  const int kw = k0 + 16 * warp;          // the warp's first key
  float dk_acc[DO / 8][4], dv_acc[DO / 8][4];
#pragma unroll
  for (int n = 0; n < DO / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1, q0 = qt * kTile;
    cp_async_wait_all();
    __syncthreads();
    if (qt + 1 < n_qt) {
      const int nx = st ^ 1, q1 = q0 + kTile;
      load_tile<kTile, kBwdThreads, DH>(q_s + nx * kTileElems, qg, sq.t, q1,
                                        Tq);
      load_tile<kTile, kBwdThreads, DH>(do_s + nx * kTileElems, dog, sdo.t,
                                        q1, Tq);
      load_rows(lse_s + nx * kTile, lg, q1, Tq);
      load_rows(dl_s + nx * kTile, dg, q1, Tq);
    }
    cp_async_commit();
    const T* qs = q_s + st * kTileElems;
    const T* dos = do_s + st * kTileElems;
    const float* ls = lse_s + st * kTile;
    const float* ds = dl_s + st * kTile;

    float p[8][4], dp[8][4];               // [key][query]: P^T, dP^T
    mma_rows_nk<DH>(p, k_s, 16 * warp, qs, lane);    // S^T = K Q^T
    mma_rows_nk<DH>(dp, v_s, 16 * warp, dos, lane);  // dP^T = V dO^T
    const bool edge = (causal && q0 < kw + 15) || q0 + kTile > Tq
                      || k0 + kTile > Tk;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = 8 * n + 2 * t + (e & 1);    // query in the tile
        float pv = exp2f(fmaf(p[n][e], c, -ls[cl] * kLog2e));
        if (edge) {
          const int col = q0 + cl, row = kw + grp + 8 * (e >> 1);
          if (col >= Tq || row >= Tk || (causal && col < row)) pv = 0.f;
        }
        p[n][e] = pv;
        dp[n][e] = pv * (dp[n][e] - ds[cl]);
      }
    unsigned pa[4][4], da[4][4];
    to_a<T>(pa, p);
    to_a<T>(da, dp);
    mma_rows_kn<DH, DO>(dv_acc, pa, dos, col0 / 16, lane);  // dV += P^T dO
    mma_rows_kn<DH, DO>(dk_acc, da, qs, col0 / 16, lane);   // dK += dS^T Q
  }

  // the warp's own rows of k_s / v_s: only this warp read them
  store_rows<DH, DO>(dk_acc, scale, scale, k_s + 16 * warp * DH,
                     dk + b * sdk.b + h * sdk.h + col0, sdk.t, kw, Tk, lane);
  store_rows<DH, DO>(dv_acc, 1.f, 1.f, v_s + 16 * warp * DH,
                     dv + b * sdv.b + h * sdv.h + col0, sdv.t, kw, Tk, lane);
}

// One block per (b*h, 64-query tile): dQ of its queries, walking the kv
// tiles (up to the diagonal when causal) with the next one in flight.
template <typename T, int DH>
__global__ void __launch_bounds__(kBwdThreads, Bounds<DH>::kBwd)
flash_tc_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ d_o,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int H, int Tq, int Tk, Strides sq, Strides sk, Strides sv,
                   Strides sdo, Strides sdq, float scale, int causal) {
  constexpr int kTileElems = kTile * DH;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + kTileElems;
  T* k_s = do_s + kTileElems;          // 2 stages
  T* v_s = k_s + 2 * kTileElems;       // 2 stages
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * kTileElems);   // 64
  float* dl_s = lse_s + kTile;                                      // 64
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_qt = (Tq + kTile - 1) / kTile;
  const int qt = causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kTile;
  const T* kg = k + b * sk.b + h * sk.h;
  const T* vg = v + b * sv.b + h * sv.h;
  int n_kt = (Tk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, qt + 1);

  load_tile<kTile, kBwdThreads, DH>(q_s, q + b * sq.b + h * sq.h, sq.t, q0,
                                    Tq);
  load_tile<kTile, kBwdThreads, DH>(do_s, d_o + b * sdo.b + h * sdo.h, sdo.t,
                                    q0, Tq);
  load_rows(lse_s, lse + (long long)bh * Tq, q0, Tq);
  load_rows(dl_s, delta + (long long)bh * Tq, q0, Tq);
  load_tile<kTile, kBwdThreads, DH>(k_s, kg, sk.t, 0, Tk);
  load_tile<kTile, kBwdThreads, DH>(v_s, vg, sv.t, 0, Tk);
  cp_async_commit();

  const float c = scale * kLog2e;
  const int qw = q0 + 16 * warp;          // the warp's first query
  const int r_lo = qw + grp, r_hi = r_lo + 8;
  constexpr int DO = kOut<DH>;
  const int col0 = blockIdx.z * DO;       // the block's columns of dQ
  float l2[2], dl[2];
  float dq_acc[DO / 8][4];
#pragma unroll
  for (int n = 0; n < DO / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < n_kt) {
      const int nx = (kt + 1) & 1, k1 = (kt + 1) * kTile;
      load_tile<kTile, kBwdThreads, DH>(k_s + nx * kTileElems, kg, sk.t, k1,
                                        Tk);
      load_tile<kTile, kBwdThreads, DH>(v_s + nx * kTileElems, vg, sv.t, k1,
                                        Tk);
    }
    cp_async_commit();
    if (kt == 0) {
      l2[0] = lse_s[16 * warp + grp] * kLog2e;
      l2[1] = lse_s[16 * warp + grp + 8] * kLog2e;
      dl[0] = dl_s[16 * warp + grp];
      dl[1] = dl_s[16 * warp + grp + 8];
    }
    const int k0 = kt * kTile;
    const T* ks = k_s + (kt & 1) * kTileElems;
    const T* vs = v_s + (kt & 1) * kTileElems;

    float p[8][4], dp[8][4];
    mma_rows_nk<DH>(p, q_s, 16 * warp, ks, lane);    // S = Q K^T
    mma_rows_nk<DH>(dp, do_s, 16 * warp, vs, lane);  // dP = dO V^T
    const bool edge = (causal && k0 + kTile - 1 > qw) || k0 + kTile > Tk;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pv = exp2f(fmaf(p[n][e], c, -l2[i]));
        if (edge) {
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          if (col >= Tk || (causal && col > (i ? r_hi : r_lo))) pv = 0.f;
        }
        dp[n][e] = pv * (dp[n][e] - dl[i]);     // dS
      }
    unsigned da[4][4];
    to_a<T>(da, dp);
    mma_rows_kn<DH, DO>(dq_acc, da, ks, col0 / 16, lane);  // dQ += dS K
  }

  store_rows<DH, DO>(dq_acc, scale, scale, q_s + 16 * warp * DH,
                     dq + b * sdq.b + h * sdq.h + col0, sdq.t, qw, Tq, lane);
}

// Head dims above 256 (a multiple of kWide): a block accumulates one
// kWide-column part of O (of dK and dV, of dQ), the grid's z index choosing
// which, as the Dh-256 kernels do with their halves; S = Q K^T (and dP =
// dO V^T) are formed by streaming the head dim in kWide-column chunks
// through the ring. The chunks of a tile come in the order z + 1, ...,
// nC - 1, 0, ..., z, so the last is the block's own part and the ring
// stage it lands in feeds the second products. Shared memory and
// registers are those of a 128-column head whatever the head dim; every
// part's blocks form the same S (and dP), so those products are done
// Dh / kWide times, each over the whole head dim.
constexpr int kWide = 128;

// The forward: a ring stage holds one chunk of the block's 128 Q rows and
// of a kv tile's K rows, and at the tile's last chunk its V rows' own part
// (64 KB a stage).
template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_tc_fwd_wide_kernel(const T* __restrict__ q,
                         const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int H, int Tq, int Tk,
                         int nC, Strides sq, Strides sk, Strides sv,
                         Strides so, float scale, int causal) {
  constexpr int W = kWide, kRows = kFwdRows, kThreads = kFwdThreads;
  constexpr int kQE = kRows * W, kKE = kTile * W, kStage = kQE + 2 * kKE;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);   // [2 stages][Q, K, V]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, z = blockIdx.z;
  const int n_qt = (Tq + kRows - 1) / kRows;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y)
                 * kRows;
  const T* qg = q + b * sq.b + h * sq.h;
  const T* kg = k + b * sk.b + h * sk.h;
  const T* vg = v + b * sv.b + h * sv.h;
  int n_kt = (Tk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, (q0 + kRows - 1) / kTile + 1);
  const int n_steps = n_kt * nC;          // (kv tile, chunk) steps

  auto load_step = [&](int s) {
    const int kt = s / nC, i = s % nC, c = (z + 1 + i) % nC;
    T* st = ring + (s & 1) * kStage;
    load_tile<kRows, kThreads, W>(st, qg + c * W, sq.t, q0, Tq);
    load_tile<kTile, kThreads, W>(st + kQE, kg + c * W, sk.t, kt * kTile,
                                  Tk);
    if (i == nC - 1)
      load_tile<kTile, kThreads, W>(st + kQE + kKE, vg + c * W, sv.t,
                                    kt * kTile, Tk);
  };
  load_step(0);
  cp_async_commit();

  const float c = scale * kLog2e;
  const int row_w = q0 + 16 * warp;       // the warp's first row
  const int r_lo = row_w + grp, r_hi = r_lo + 8;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[W / 8][4], s[8][4];
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const int kt = step / nC, i = step % nC;
    cp_async_wait_all();
    // the step's chunk has landed for every thread, and every warp is done
    // with the stage the next load overwrites
    __syncthreads();
    if (step + 1 < n_steps) load_step(step + 1);
    cp_async_commit();
    const int k0 = kt * kTile;
    if (causal && k0 > row_w + 15) continue;   // all after the warp's rows
    const T* st = ring + (step & 1) * kStage;
    if (i == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
    mma_rows_nk<W, false>(s, st, 16 * warp, st + kQE, lane);  // S += Q K^T
    if (i != nC - 1) continue;

    const bool edge = (causal && k0 + kTile - 1 > row_w) || k0 + kTile > Tk;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * c;
        if (edge) {
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          if (col >= Tk || (causal && col > (e < 2 ? r_lo : r_hi)))
            x = -INFINITY;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mu[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - mu[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
    unsigned pa[4][4];
    to_a<T>(pa, s);
    mma_rows_kn<W, W>(acc, pa, st + kQE + kKE, 0, lane);  // O_z += P V_z
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  if (t == 0 && z == 0) {
    if (r_lo < Tq)
      lse[(long long)bh * Tq + r_lo] =
          l[0] > 0.f ? m[0] * kLn2 + logf(l[0]) : INFINITY;
    if (r_hi < Tq)
      lse[(long long)bh * Tq + r_hi] =
          l[1] > 0.f ? m[1] * kLn2 + logf(l[1]) : INFINITY;
  }
  // the warp's own Q rows of the last step's stage: only this warp read
  // them, and no copy is in flight
  store_rows<W, W>(acc, inv[0], inv[1],
                   ring + ((n_steps - 1) & 1) * kStage + 16 * warp * W,
                   o + b * so.b + h * so.h + z * W, so.t, row_w, Tq, lane);
}

// The backward, both passes in one body. kKV: the dK/dV pass (x k, y v, u
// q, w dO; out1 dV, out2 dK), a block per 64-key tile walking the q tiles
// from the diagonal on; else the dQ pass (x q, y dO, u k, w v; out2 dQ), a
// block per 64-query tile walking the kv tiles up to the diagonal. Tx, Tu:
// rows of x (and y), of u (and w). A ring stage holds one chunk of all
// four tiles (64 KB); the step's products are those of the Dh-256 kernels
// above, S^T = K Q^T and dP^T = V dO^T (S = Q K^T and dP = dO V^T)
// accumulated over the chunks.
template <typename T, bool kKV>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_tc_bwd_wide_kernel(const T* __restrict__ x,
                         const T* __restrict__ y,
                         const T* __restrict__ u,
                         const T* __restrict__ w,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ out1, T* __restrict__ out2,
                         int H, int Tx, int Tu, int nC, Strides sx,
                         Strides sy, Strides su, Strides sw, Strides so1,
                         Strides so2, float scale, int causal) {
  constexpr int W = kWide, kTE = kTile * W, kStage = 4 * kTE;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);   // [2 stages][X, Y, U, W]
  float* lse_s = reinterpret_cast<float*>(ring + 2 * kStage);  // [2][64]
  float* dl_s = lse_s + 2 * kTile;                              // [2][64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, z = blockIdx.z;
  const int n_xt = (Tx + kTile - 1) / kTile;
  const int xt = !kKV && causal ? n_xt - 1 - (int)blockIdx.y
                                : (int)blockIdx.y;
  const int x0 = xt * kTile;
  const int Tq = kKV ? Tu : Tx;           // lse and delta rows
  const T* xg = x + b * sx.b + h * sx.h;
  const T* yg = y + b * sy.b + h * sy.h;
  const T* ug = u + b * su.b + h * su.h;
  const T* wg = w + b * sw.b + h * sw.h;
  const float* lg = lse + (long long)bh * Tq;
  const float* dg = delta + (long long)bh * Tq;
  int ut0 = 0, n_ut = (Tu + kTile - 1) / kTile;
  if (causal) {
    if (kKV)
      ut0 = xt;                           // q tiles from the diagonal
    else
      n_ut = min(n_ut, xt + 1);           // kv tiles up to it
  }
  const int n_steps = (n_ut - ut0) * nC;

  auto load_step = [&](int s) {
    const int i = s % nC, c = (z + 1 + i) % nC, u0 = (ut0 + s / nC) * kTile;
    T* st = ring + (s & 1) * kStage;
    load_tile<kTile, kBwdThreads, W>(st, xg + c * W, sx.t, x0, Tx);
    load_tile<kTile, kBwdThreads, W>(st + kTE, yg + c * W, sy.t, x0, Tx);
    load_tile<kTile, kBwdThreads, W>(st + 2 * kTE, ug + c * W, su.t, u0,
                                     Tu);
    load_tile<kTile, kBwdThreads, W>(st + 3 * kTE, wg + c * W, sw.t, u0,
                                     Tu);
    if (kKV && i == 0) {
      const int rs = ((s / nC) & 1) * kTile;
      load_rows(lse_s + rs, lg, u0, Tu);
      load_rows(dl_s + rs, dg, u0, Tu);
    }
  };
  load_step(0);
  cp_async_commit();

  const float c = scale * kLog2e;
  const int xw = x0 + 16 * warp;          // the warp's first fixed row
  const int r_lo = xw + grp, r_hi = r_lo + 8;
  float l2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};   // dQ pass: its rows'
  if (!kKV) {
    if (r_lo < Tx) {
      l2[0] = lg[r_lo] * kLog2e;
      dl[0] = dg[r_lo];
    }
    if (r_hi < Tx) {
      l2[1] = lg[r_hi] * kLog2e;
      dl[1] = dg[r_hi];
    }
  }
  float acc1[kKV ? W / 8 : 1][4], acc2[W / 8][4], p[8][4], dp[8][4];
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc2[n][e] = 0.f;
      if (kKV) acc1[kKV ? n : 0][e] = 0.f;
    }

  for (int step = 0; step < n_steps; ++step) {
    const int i = step % nC, u0 = (ut0 + step / nC) * kTile;
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < n_steps) load_step(step + 1);
    cp_async_commit();
    // a tile wholly masked for the warp's rows
    if (causal && (kKV ? u0 + kTile - 1 < xw : u0 > xw + 15)) continue;
    const T* st = ring + (step & 1) * kStage;
    const T* us = st + 2 * kTE;
    const T* ws = st + 3 * kTE;
    if (i == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[n][e] = dp[n][e] = 0.f;
    }
    mma_rows_nk<W, false>(p, st, 16 * warp, us, lane);         // X U^T
    mma_rows_nk<W, false>(dp, st + kTE, 16 * warp, ws, lane);  // Y W^T
    if (i != nC - 1) continue;

    const float* ls = lse_s + ((step / nC) & 1) * kTile;
    const float* ds = dl_s + ((step / nC) & 1) * kTile;
    const bool edge = u0 + kTile > Tu
                      || (causal && (kKV ? u0 < xw + 15
                                         : u0 + kTile - 1 > xw));
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = 8 * n + 2 * t + (e & 1), col = u0 + cl;
        const int row = e < 2 ? r_lo : r_hi;
        const float lrow = kKV ? ls[cl] * kLog2e : l2[e >> 1];
        const float drow = kKV ? ds[cl] : dl[e >> 1];
        float pv = exp2f(fmaf(p[n][e], c, -lrow));
        if (edge && (col >= Tu
                     || (causal && (kKV ? col < row : col > row))))
          pv = 0.f;
        p[n][e] = pv;
        dp[n][e] = pv * (dp[n][e] - drow);
      }
    unsigned da[4][4];
    to_a<T>(da, dp);
    mma_rows_kn<W, W>(acc2, da, us, 0, lane);   // dK += dS^T Q; dQ += dS K
    if constexpr (kKV) {
      unsigned pa[4][4];
      to_a<T>(pa, p);
      mma_rows_kn<W, W>(acc1, pa, ws, 0, lane);  // dV += P^T dO
    }
  }

  // the warp's own X and Y rows of the last step's stage: only this warp
  // read them, and no copy is in flight
  T* st = ring + ((n_steps - 1) & 1) * kStage + 16 * warp * W;
  store_rows<W, W>(acc2, scale, scale, st,
                   out2 + b * so2.b + h * so2.h + z * W, so2.t, xw, Tx,
                   lane);
  if constexpr (kKV)
    store_rows<W, W>(acc1, 1.f, 1.f, st + kTE,
                     out1 + b * so1.b + h * so1.h + z * W, so1.t, xw, Tx,
                     lane);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Strides strides_of(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <typename T, int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Tq, int Tk,
                       const long long* strides, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = (size_t)(kFwdRows + 4 * kTile) * DH * sizeof(T);
  cudaError_t err = allow_smem(flash_tc_fwd_kernel<T, DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + kFwdRows - 1) / kFwdRows, DH / kOut<DH>);
  flash_tc_fwd_kernel<T, DH><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), H, Tq, Tk, strides_of(strides, 0),
      strides_of(strides, 1), strides_of(strides, 2), strides_of(strides, 3),
      scale, causal);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* d_o, const void* lse,
                       void* delta, void* dq, void* dk, void* dv, int B,
                       int H, int Tq, int Tk, const long long* strides,
                       float scale, int causal, cudaStream_t s) {
  constexpr int kTileElems = kTile * DH;
  const long long rows = (long long)B * H * Tq;
  const int rows_per_block = kBwdThreads / 8;
  flash_tc_delta_kernel<T, DH><<<(unsigned)((rows + rows_per_block - 1)
                                         / rows_per_block),
                              kBwdThreads, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(d_o),
      static_cast<float*>(delta), H, Tq, rows, strides_of(strides, 3),
      strides_of(strides, 4), DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = 6 * kTileElems * sizeof(T)
                         + 4 * kTile * sizeof(float);
  err = allow_smem(flash_tc_dkdv_kernel<T, DH>, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(B * H, (Tk + kTile - 1) / kTile, DH / kOut<DH>);
  flash_tc_dkdv_kernel<T, DH><<<grid_kv, kBwdThreads, smem_kv, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk,
      strides_of(strides, 0), strides_of(strides, 1),
      strides_of(strides, 2), strides_of(strides, 4),
      strides_of(strides, 6), strides_of(strides, 7), scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_q = 6 * kTileElems * sizeof(T)
                        + 2 * kTile * sizeof(float);
  err = allow_smem(flash_tc_dq_kernel<T, DH>, smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q(B * H, (Tq + kTile - 1) / kTile, DH / kOut<DH>);
  flash_tc_dq_kernel<T, DH><<<grid_q, kBwdThreads, smem_q, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Tq, Tk, strides_of(strides, 0),
      strides_of(strides, 1), strides_of(strides, 2),
      strides_of(strides, 4), strides_of(strides, 5), scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_wide(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int H, int Tq, int Tk,
                            int Dh, const long long* strides, float scale,
                            int causal, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)(kFwdRows + 2 * kTile) * kWide
                      * sizeof(T);
  cudaError_t err = allow_smem(flash_tc_fwd_wide_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + kFwdRows - 1) / kFwdRows, Dh / kWide);
  flash_tc_fwd_wide_kernel<T><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), H, Tq, Tk, Dh / kWide,
      strides_of(strides, 0), strides_of(strides, 1), strides_of(strides, 2),
      strides_of(strides, 3), scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_wide(const void* q, const void* k, const void* v,
                            const void* o, const void* d_o, const void* lse,
                            void* delta, void* dq, void* dk, void* dv, int B,
                            int H, int Tq, int Tk, int Dh,
                            const long long* st, float scale, int causal,
                            cudaStream_t s) {
  const long long rows = (long long)B * H * Tq;
  const int rows_per_block = kBwdThreads / 8;
  flash_tc_delta_kernel<T, 0><<<(unsigned)((rows + rows_per_block - 1)
                                        / rows_per_block),
                             kBwdThreads, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(d_o),
      static_cast<float*>(delta), H, Tq, rows, strides_of(st, 3),
      strides_of(st, 4), Dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int nC = Dh / kWide;
  const size_t smem = 8 * (size_t)kTile * kWide * sizeof(T)
                      + 4 * kTile * sizeof(float);
  const T* f[] = {static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v),
                     static_cast<const T*>(d_o)};
  const float* lp = static_cast<const float*>(lse);
  const float* dlp = static_cast<const float*>(delta);
  err = allow_smem(flash_tc_bwd_wide_kernel<T, true>, smem);
  if (err != cudaSuccess) return err;
  flash_tc_bwd_wide_kernel<T, true>
      <<<dim3(B * H, (Tk + kTile - 1) / kTile, nC), kBwdThreads, smem, s>>>(
          f[1], f[2], f[0], f[3], lp, dlp, static_cast<T*>(dv),
          static_cast<T*>(dk), H, Tk, Tq, nC, strides_of(st, 1),
          strides_of(st, 2), strides_of(st, 0), strides_of(st, 4),
          strides_of(st, 7), strides_of(st, 6), scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_tc_bwd_wide_kernel<T, false>, smem);
  if (err != cudaSuccess) return err;
  flash_tc_bwd_wide_kernel<T, false>
      <<<dim3(B * H, (Tq + kTile - 1) / kTile, nC), kBwdThreads, smem, s>>>(
          f[0], f[3], f[1], f[2], lp, dlp, nullptr, static_cast<T*>(dq),
          H, Tq, Tk, nC, strides_of(st, 0), strides_of(st, 4),
          strides_of(st, 1), strides_of(st, 2), strides_of(st, 5),
          strides_of(st, 5), scale, causal);
  return cudaGetLastError();
}

template <typename T>
int fwd_entry(const void* q, const void* k, const void* v, void* o,
              void* lse, int B, int H, int Tq, int Tk, int Dh,
              const long long* strides, float scale, int causal,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64:
      return static_cast<int>(launch_fwd<T, 64>(q, k, v, o, lse, B, H, Tq,
                                                Tk, strides, scale, causal,
                                                s));
    case 128:
      return static_cast<int>(launch_fwd<T, 128>(q, k, v, o, lse, B, H, Tq,
                                                 Tk, strides, scale, causal,
                                                 s));
    case 256:
      return static_cast<int>(launch_fwd<T, 256>(q, k, v, o, lse, B, H, Tq,
                                                 Tk, strides, scale, causal,
                                                 s));
    default:
      if (Dh > 256 && Dh % kWide == 0)
        return static_cast<int>(launch_fwd_wide<T>(q, k, v, o, lse, B, H,
                                                   Tq, Tk, Dh, strides,
                                                   scale, causal, s));
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int bwd_entry(const void* q, const void* k, const void* v, const void* o,
              const void* d_o, const void* lse, void* delta, void* dq,
              void* dk, void* dv, int B, int H, int Tq, int Tk, int Dh,
              const long long* strides, float scale, int causal,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64:
      return static_cast<int>(launch_bwd<T, 64>(q, k, v, o, d_o, lse, delta,
                                                dq, dk, dv, B, H, Tq, Tk,
                                                strides, scale, causal, s));
    case 128:
      return static_cast<int>(launch_bwd<T, 128>(q, k, v, o, d_o, lse,
                                                 delta, dq, dk, dv, B, H, Tq,
                                                 Tk, strides, scale, causal,
                                                 s));
    case 256:
      return static_cast<int>(launch_bwd<T, 256>(q, k, v, o, d_o, lse,
                                                 delta, dq, dk, dv, B, H, Tq,
                                                 Tk, strides, scale, causal,
                                                 s));
    default:
      if (Dh > 256 && Dh % kWide == 0)
        return static_cast<int>(launch_bwd_wide<T>(q, k, v, o, d_o, lse,
                                                   delta, dq, dk, dv, B, H,
                                                   Tq, Tk, Dh, strides,
                                                   scale, causal, s));
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, H, Tq, Dh], k/v [B, H, Tk, Dh], o like q, all bf16 (the tc entry
// points) or all fp16 (the fp16 ones), Dh 64, 128, 256 or a multiple of
// 128 above 256: any strides with a unit head-dim stride and 16-byte
// aligned rows, given as `strides` = [b, h, t] element strides of q, k,
// v, o (12 values, host memory). lse [B, H, Tq] fp32 contiguous. Causal
// needs Tq == Tk (the wrapper checks).
extern "C" int ptpu_flash_attention_tc_fwd(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int B, int H, int Tq, int Tk,
                                           int Dh, const long long* strides,
                                           float scale, int causal,
                                           void* stream) {
  return fwd_entry<bf16>(q, k, v, o, lse, B, H, Tq, Tk, Dh, strides, scale,
                         causal, stream);
}
extern "C" int ptpu_flash_attention_fp16_fwd(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse, int B, int H, int Tq,
                                             int Tk, int Dh,
                                             const long long* strides,
                                             float scale, int causal,
                                             void* stream) {
  return fwd_entry<fp16>(q, k, v, o, lse, B, H, Tq, Tk, Dh, strides, scale,
                         causal, stream);
}

// The backward: dq/dk/dv like q/k/v (their own strides), from q, k, v, o,
// do and the forward's lse; delta is fp32 [B, H, Tq] scratch. `strides`
// holds 24 values: q, k, v, o, do, dq, dk, dv.
extern "C" int ptpu_flash_attention_tc_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* d_o, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int Dh,
    const long long* strides, float scale, int causal, void* stream) {
  return bwd_entry<bf16>(q, k, v, o, d_o, lse, delta, dq, dk, dv, B, H, Tq,
                         Tk, Dh, strides, scale, causal, stream);
}
extern "C" int ptpu_flash_attention_fp16_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* d_o, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int Dh,
    const long long* strides, float scale, int causal, void* stream) {
  return bwd_entry<fp16>(q, k, v, o, d_o, lse, delta, dq, dk, dv, B, H, Tq,
                         Tk, Dh, strides, scale, causal, stream);
}
