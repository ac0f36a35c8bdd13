// Flash attention forward in fp32 on Hopper's tensor cores (sm_90a), by
// 3xTF32: fp32 in and out, fp32 accuracy from TF32 products. Head dims 64,
// 128 and 256 (a template parameter, instantiated for each; the wrapper
// pads any other head dim up to the next of them) and any multiple of 128
// above 256 (the wide kernel at the end). The fp32 backward is
// flash_attention_f32tc_bwd.cu; bf16 takes the kernels of
// flash_attention_tc.cu.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
// `flash_attention` (:120) -> `_flash_fwd` (:162, pl.pallas_call :191,
// body `_fwd_kernel` :58) for fp32 programs: it runs once per layer in the
// fp32 and full-int8 inference of the Fluid-API Transformer LM (whose
// attention stays fp32) and in the forward of fp32 training.
//
// What it computes, per (batch b, head h): O = softmax(Q K^T * scale) V
// over q [Tq, Dh] and k, v [Tk, Dh], keys at positions >= Tk masked and,
// when causal (Tq == Tk), keys after the query's position masked. It also
// writes the row log-sum-exp of the scaled scores (fp32 [B, H, Tq]), which
// the backward rebuilds P from; a row whose keys are all masked uses 0 as
// its max, so no NaN arises: it ends with l = 0, O = 0 and lse = +inf.
//
// Numerics (3xTF32). Each fp32 operand x is split into big = tf32(x)
// (cvt.rna: 10 stored mantissa bits, round to nearest) and small =
// tf32(x - big); a product is a_big b_big + a_big b_small + a_small b_big
// on mma.sync m16n8k8 TF32 with fp32 accumulators. The dropped a_small
// b_small term and the rounding of small keep about 21 bits of each
// operand, so a sum of products is as close to the fp32 one as two fp32
// summation orders are to each other. Both products, Q K^T and P V, run
// this way; the softmax is fp32 (exp2f on scores prescaled by scale *
// log2(e)), and P is split from its fp32 value in registers.
//
// Bound. At the int8 inference path's shape (B 32, H 8, T 512, causal,
// Dh 64) the products are 8.61 GFLOP, 25.8 GFLOP as three TF32 products:
// over the tensor cores' 494.7 TFLOP/s dense TF32 that is 0.052 ms (0.104
// at Dh 128), above the bytes (134 MB of Q, K, V, O: 0.040 ms). So the
// design keeps the products on the tensor cores and the splitting out of
// their way:
// - Each warp owns 16 query rows of the block's (128 rows in 8 warps at
//   Dh 64 and 128; 64 in 4 at Dh 256). The online softmax runs on the S
//   accumulator fragments: a thread holds two rows, whose max and sum
//   reduce over the 4 lanes of a quad.
// - K and V are split once a block, not once a warp: K and V tiles load
//   as fp32 by 16-byte cp.async.cg into a 2-stage ring (rows past T
//   zero-filled; the next tile in flight while the current one is
//   used), and each landed tile is split by all threads into TF32 big
//   and small planes, K as it lies and V transposed; every warp then
//   reads its B operands from the planes by ldmatrix (an 8 x 8 b16 block
//   is an 8 x 4 block of 32-bit words, word t of row g going to lane
//   4g + t: the m16n8k8 TF32 fragment). Two barriers a tile.
// - P never goes to shared memory. The m16n8k8 A operand wants a thread's
//   keys t and t + 4 of an 8-key step; its S accumulator holds keys 2t and
//   2t + 1. A sum over keys does not care about their order, so the k
//   slots t and t + 4 of each step are bound to keys 2t and 2t + 1: P is
//   split in registers and fed as it lies, and the V^T planes store each
//   8-key group's keys in that order (vt_col).
// - Row strides of Dh + 4 words (planes of V^T: kv rows + 4) put the 8
//   rows an ldmatrix phase or a float4 of the split pass reads on 8
//   different bank groups and keep rows 16-byte aligned.
// - Shared memory and registers set the shapes (Cfg): at Dh 64 Q stays
//   split in registers (64 registers) and kv tiles are 64 rows (174 KB);
//   at Dh 128 and 256 the O accumulator takes 64 / 128 registers, so Q is
//   read from shared memory by ldmatrix and split per k-step, and kv
//   tiles are 32 / 16 rows (206 / 208 KB). One block an SM. nvcc's
//   report (CUDA 12.8, -Xptxas -v, printed by chip_smoke.py's build
//   phase): 215 to 255 registers a thread across the three
//   instantiations, one of them spilling 48 bytes at the 255 cap.
// - Causal: a block loops only over the tiles at or below its diagonal and
//   a warp skips the products of tiles wholly after its rows; only the
//   diagonal tile and ragged tails are masked. The heaviest blocks come
//   first.
//
// Interface: a plain C function (bound with ctypes), launched on the
// caller's stream, allocating nothing; it returns cudaGetLastError(). The
// caller guarantees 16-byte aligned rows: base addresses and every
// [B, H, T] stride multiples of 4 elements.

#include "flash_attention_f32tc.cuh"

namespace {

// query rows a block (16 a warp), kv rows a tile, whether Q stays split in
// registers
template <int DH>
struct Cfg;
template <>
struct Cfg<64> {
  static constexpr int kRows = 128, kKT = 64;
  static constexpr bool kQReg = true;
};
template <>
struct Cfg<128> {
  static constexpr int kRows = 128, kKT = 32;
  static constexpr bool kQReg = false;
};
template <>
struct Cfg<256> {
  static constexpr int kRows = 64, kKT = 16;
  static constexpr bool kQReg = false;
};

// shared floats: Q, the raw K/V ring (2 stages), the K planes (big,
// small) and the V^T planes
template <int DH>
constexpr size_t smem_floats() {
  return (size_t)(Cfg<DH>::kRows + 6 * Cfg<DH>::kKT) * (DH + 4)
         + 2 * (size_t)DH * (Cfg<DH>::kKT + 4);
}

template <int DH>
__global__ void __launch_bounds__(2 * Cfg<DH>::kRows, 1)
flash_f32tc_fwd_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int H, int Tq, int Tk,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       float scale, int causal) {
  constexpr int kRows = Cfg<DH>::kRows, kKT = Cfg<DH>::kKT;
  constexpr int kThreads = 2 * kRows, kLd = DH + 4, kVLd = kKT + 4;
  constexpr int kNT = kKT / 8;             // n8 tiles of S a kv tile
  constexpr int kKS = DH / 8;              // k8 steps of Q K^T; n8 tiles of O
  constexpr int kTileF = kKT * kLd;
  constexpr bool kQReg = Cfg<DH>::kQReg;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                       // [kRows][kLd]
  float* raw = q_s + kRows * kLd;          // [2 stages][K, V][kKT][kLd]
  unsigned* kb_s = reinterpret_cast<unsigned*>(raw + 4 * kTileF);
  unsigned* ks_s = kb_s + kTileF;          // K planes [kKT][kLd]
  unsigned* vb_s = ks_s + kTileF;          // V^T planes [DH][kVLd]
  unsigned* vs_s = vb_s + DH * kVLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_qt = (Tq + kRows - 1) / kRows;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y)
                 * kRows;
  const float* qg = q + b * sq.b + h * sq.h;
  const float* kg = k + b * sk.b + h * sk.h;
  const float* vg = v + b * sv.b + h * sv.h;
  int n_kt = (Tk + kKT - 1) / kKT;
  if (causal) n_kt = min(n_kt, (q0 + kRows - 1) / kKT + 1);

  load_tile<kRows, DH, kThreads>(q_s, qg, sq.t, q0, Tq);
  load_tile<kKT, DH, kThreads>(raw, kg, sk.t, 0, Tk);
  load_tile<kKT, DH, kThreads>(raw + kTileF, vg, sv.t, 0, Tk);
  cp_async_commit();

  const float c = scale * kLog2e;
  const int row_w = q0 + 16 * warp;        // the warp's first row
  const int r_lo = row_w + grp, r_hi = r_lo + 8;
  const float* qw = q_s + 16 * warp * kLd;  // the warp's rows of q_s
  unsigned qb[kQReg ? kKS : 1][4], qsm[kQReg ? kKS : 1][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kKS][4];
#pragma unroll
  for (int n = 0; n < kKS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    // tile kt has landed for every thread, and every warp is done with
    // the planes of tile kt - 1 and the raw stage the next load fills
    __syncthreads();
    if (kt + 1 < n_kt) {
      float* st = raw + ((kt + 1) & 1) * 2 * kTileF;
      load_tile<kKT, DH, kThreads>(st, kg, sk.t, (kt + 1) * kKT, Tk);
      load_tile<kKT, DH, kThreads>(st + kTileF, vg, sv.t, (kt + 1) * kKT,
                                   Tk);
    }
    cp_async_commit();
    {
      // split tile kt once for the block: K into big and small planes as
      // it lies, V transposed with each 8-key group's keys in vt_col order
      const float* rk = raw + (kt & 1) * 2 * kTileF;
      const float* rv = rk + kTileF;
#pragma unroll
      for (int it = 0; it < kKT * DH / 4 / kThreads; ++it) {
        const int i = threadIdx.x + it * kThreads;
        const int key = i % kKT, c4 = i / kKT;
        const float4 kx = *reinterpret_cast<const float4*>(
            rk + key * kLd + 4 * c4);
        uint4 bb, ss;
        split(kx.x, bb.x, ss.x);
        split(kx.y, bb.y, ss.y);
        split(kx.z, bb.z, ss.z);
        split(kx.w, bb.w, ss.w);
        *reinterpret_cast<uint4*>(kb_s + key * kLd + 4 * c4) = bb;
        *reinterpret_cast<uint4*>(ks_s + key * kLd + 4 * c4) = ss;
        const float4 vx = *reinterpret_cast<const float4*>(
            rv + key * kLd + 4 * c4);
        const float ve[4] = {vx.x, vx.y, vx.z, vx.w};
        const int col = vt_col(key);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(ve[e], vb_s[(4 * c4 + e) * kVLd + col],
                vs_s[(4 * c4 + e) * kVLd + col]);
      }
    }
    if (kQReg && kt == 0) {
#pragma unroll
      for (int kc = 0; kc < (kQReg ? kKS : 0); ++kc)
        load_a<DH>(qb[kc], qsm[kc], qw, kc, lane);
    }
    __syncthreads();                         // the planes are ready
    const int k0 = kt * kKT;
    if (causal && k0 > row_w + 15) continue;   // all after the warp's rows

    // S = Q K^T
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kKS; ++kc) {
      unsigned ab[4], as[4];
      if (kQReg) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ab[e] = qb[kQReg ? kc : 0][e];
          as[e] = qsm[kQReg ? kc : 0][e];
        }
      } else {
        load_a<DH>(ab, as, qw, kc, lane);
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        // B (8 k x 8 keys) of key tiles 2 np and 2 np + 1: (k t, key grp),
        // (k t + 4, key grp)
        const int mi = lane >> 3;
        const int off = (8 * (2 * np + (mi >> 1)) + (lane & 7)) * kLd
                        + 8 * kc + 4 * (mi & 1);
        unsigned bb[4], bs[4];
        ldsm4(bb, kb_s + off);
        ldsm4(bs, ks_s + off);
        mma3(s[2 * np], ab, as, bb[0], bb[1], bs[0], bs[1]);
        mma3(s[2 * np + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
      }
    }

    const bool edge = (causal && k0 + kKT - 1 > row_w) || k0 + kKT > Tk;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
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
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - mu[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < kKS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];

    // O += P V; k slots t and t + 4 of key step j are keys 8 j + 2 t and
    // 8 j + 2 t + 1, in P (the S accumulator as it lies) and in the V^T
    // planes (vt_col)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      unsigned pb[4], ps[4];
      split(s[j][0], pb[0], ps[0]);
      split(s[j][2], pb[1], ps[1]);
      split(s[j][1], pb[2], ps[2]);
      split(s[j][3], pb[3], ps[3]);
#pragma unroll
      for (int np = 0; np < kKS / 2; ++np) {
        const int mi = lane >> 3;
        const int off = (8 * (2 * np + (mi >> 1)) + (lane & 7)) * kVLd
                        + 8 * j + 4 * (mi & 1);
        unsigned bb[4], bs[4];
        ldsm4(bb, vb_s + off);
        ldsm4(bs, vs_s + off);
        mma3(acc[2 * np], pb, ps, bb[0], bb[1], bs[0], bs[1]);
        mma3(acc[2 * np + 1], pb, ps, bb[2], bb[3], bs[2], bs[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  if (t == 0) {
    if (r_lo < Tq)
      lse[(long long)bh * Tq + r_lo] =
          l[0] > 0.f ? m[0] * kLn2 + logf(l[0]) : INFINITY;
    if (r_hi < Tq)
      lse[(long long)bh * Tq + r_hi] =
          l[1] > 0.f ? m[1] * kLn2 + logf(l[1]) : INFINITY;
  }
  float* og = o + b * so.b + h * so.h;
#pragma unroll
  for (int np = 0; np < kKS; ++np) {
    const int col = 8 * np + 2 * t;
    if (r_lo < Tq)
      *reinterpret_cast<float2*>(og + (long long)r_lo * so.t + col) =
          make_float2(acc[np][0] * inv[0], acc[np][1] * inv[0]);
    if (r_hi < Tq)
      *reinterpret_cast<float2*>(og + (long long)r_hi * so.t + col) =
          make_float2(acc[np][2] * inv[1], acc[np][3] * inv[1]);
  }
}

// Head dims above 256 (a multiple of kPart): a block accumulates one
// kPart-column part of O, the grid's z index choosing which, and forms S =
// Q K^T by streaming the head dim in kPart-column chunks through the ring,
// in order: a ring stage holds one chunk of the block's Q rows and of a kv
// tile's K rows, and at the block's own chunk z the V rows of its part,
// split into the V^T planes that the tile's last chunk multiplies. S is
// summed in the head dim's order, as the backward sums it. Shared memory
// and registers are those of a 128-column head whatever the head dim;
// every part's blocks form the same S, so the products of S grow with
// Dh / kPart (S is formed Dh / kPart times, each over the whole head dim).
struct WideCfg {
  static constexpr int kRows = 64, kKT = 32;
};

constexpr size_t wide_smem_floats() {
  return (size_t)(2 * WideCfg::kRows + 6 * WideCfg::kKT) * (kPart + 4)
         + 2 * (size_t)kPart * (WideCfg::kKT + 4);
}

__global__ void __launch_bounds__(2 * WideCfg::kRows, 1)
flash_f32tc_fwd_wide_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, float* __restrict__ lse,
                            int H, int Tq, int Tk, int nC, Strides sq,
                            Strides sk, Strides sv, Strides so, float scale,
                            int causal) {
  constexpr int W = kPart, kRows = WideCfg::kRows, kKT = WideCfg::kKT;
  constexpr int kThreads = 2 * kRows, kLd = W + 4, kVLd = kKT + 4;
  constexpr int kNT = kKT / 8, kKS = W / 8;
  constexpr int kQF = kRows * kLd, kTileF = kKT * kLd;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                       // [2 stages][kRows][kLd]
  float* raw = q_s + 2 * kQF;              // [2 stages][K, V][kKT][kLd]
  unsigned* kb_s = reinterpret_cast<unsigned*>(raw + 4 * kTileF);
  unsigned* ks_s = kb_s + kTileF;          // K planes [kKT][kLd]
  unsigned* vb_s = ks_s + kTileF;          // V^T planes [W][kVLd]
  unsigned* vs_s = vb_s + W * kVLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, z = blockIdx.z;
  const int n_qt = (Tq + kRows - 1) / kRows;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y)
                 * kRows;
  const float* qg = q + b * sq.b + h * sq.h;
  const float* kg = k + b * sk.b + h * sk.h;
  const float* vg = v + b * sv.b + h * sv.h;
  int n_kt = (Tk + kKT - 1) / kKT;
  if (causal) n_kt = min(n_kt, (q0 + kRows - 1) / kKT + 1);
  const int n_steps = n_kt * nC;           // (kv tile, chunk) steps

  // step s's chunk c of Q and K (and, at the block's own chunk z, V's
  // part) into ring stage s & 1
  auto load_step = [&](int s) {
    const int kt = s / nC, c = s % nC;
    float* st = raw + (s & 1) * 2 * kTileF;
    load_tile<kRows, W, kThreads>(q_s + (s & 1) * kQF, qg + c * W, sq.t, q0,
                                  Tq);
    load_tile<kKT, W, kThreads>(st, kg + c * W, sk.t, kt * kKT, Tk);
    if (c == z)
      load_tile<kKT, W, kThreads>(st + kTileF, vg + c * W, sv.t, kt * kKT,
                                  Tk);
  };
  load_step(0);
  cp_async_commit();

  const float c = scale * kLog2e;
  const int row_w = q0 + 16 * warp;        // the warp's first row
  const int r_lo = row_w + grp, r_hi = r_lo + 8;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kKS][4], s[kNT][4];
#pragma unroll
  for (int n = 0; n < kKS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const int kt = step / nC, i = step % nC;
    const bool last = i == nC - 1;
    cp_async_wait_all();
    // step's chunk has landed for every thread, and every warp is done
    // with the planes and the ring stage of the step before
    __syncthreads();
    if (step + 1 < n_steps) load_step(step + 1);
    cp_async_commit();
    {
      // split the chunk once for the block: K into big and small planes as
      // it lies; at the own chunk V transposed, each 8-key group's keys in
      // vt_col order
      const float* rk = raw + (step & 1) * 2 * kTileF;
      const float* rv = rk + kTileF;
#pragma unroll
      for (int it = 0; it < kKT * W / 4 / kThreads; ++it) {
        const int idx = threadIdx.x + it * kThreads;
        const int key = idx % kKT, c4 = idx / kKT;
        const float4 kx = *reinterpret_cast<const float4*>(
            rk + key * kLd + 4 * c4);
        uint4 bb, ss;
        split(kx.x, bb.x, ss.x);
        split(kx.y, bb.y, ss.y);
        split(kx.z, bb.z, ss.z);
        split(kx.w, bb.w, ss.w);
        *reinterpret_cast<uint4*>(kb_s + key * kLd + 4 * c4) = bb;
        *reinterpret_cast<uint4*>(ks_s + key * kLd + 4 * c4) = ss;
        if (i == z) {
          const float4 vx = *reinterpret_cast<const float4*>(
              rv + key * kLd + 4 * c4);
          const float ve[4] = {vx.x, vx.y, vx.z, vx.w};
          const int col = vt_col(key);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split(ve[e], vb_s[(4 * c4 + e) * kVLd + col],
                  vs_s[(4 * c4 + e) * kVLd + col]);
        }
      }
    }
    __syncthreads();                         // the planes are ready
    const int k0 = kt * kKT;
    if (causal && k0 > row_w + 15) continue;   // all after the warp's rows

    // S += Q_c K_c^T
    if (i == 0) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
    const float* qw = q_s + (step & 1) * kQF + 16 * warp * kLd;
#pragma unroll
    for (int kc = 0; kc < kKS; ++kc) {
      unsigned ab[4], as[4];
      load_a<W>(ab, as, qw, kc, lane);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        unsigned bb[4], bs[4];
        load_b<W>(bb, kb_s, np, kc, lane);
        load_b<W>(bs, ks_s, np, kc, lane);
        mma3(s[2 * np], ab, as, bb[0], bb[1], bs[0], bs[1]);
        mma3(s[2 * np + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
      }
    }
    if (!last) continue;

    const bool edge = (causal && k0 + kKT - 1 > row_w) || k0 + kKT > Tk;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
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
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - mu[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < kKS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];

    // O_z += P V_z, P's k slots bound to keys as in the forward above
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      unsigned pb[4], ps[4];
      split(s[j][0], pb[0], ps[0]);
      split(s[j][2], pb[1], ps[1]);
      split(s[j][1], pb[2], ps[2]);
      split(s[j][3], pb[3], ps[3]);
#pragma unroll
      for (int np = 0; np < kKS / 2; ++np) {
        const int mi = lane >> 3;
        const int off = (8 * (2 * np + (mi >> 1)) + (lane & 7)) * kVLd
                        + 8 * j + 4 * (mi & 1);
        unsigned bb[4], bs[4];
        ldsm4(bb, vb_s + off);
        ldsm4(bs, vs_s + off);
        mma3(acc[2 * np], pb, ps, bb[0], bb[1], bs[0], bs[1]);
        mma3(acc[2 * np + 1], pb, ps, bb[2], bb[3], bs[2], bs[3]);
      }
    }
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
  float* og = o + b * so.b + h * so.h + z * W;
#pragma unroll
  for (int np = 0; np < kKS; ++np) {
    const int col = 8 * np + 2 * t;
    if (r_lo < Tq)
      *reinterpret_cast<float2*>(og + (long long)r_lo * so.t + col) =
          make_float2(acc[np][0] * inv[0], acc[np][1] * inv[0]);
    if (r_hi < Tq)
      *reinterpret_cast<float2*>(og + (long long)r_hi * so.t + col) =
          make_float2(acc[np][2] * inv[1], acc[np][3] * inv[1]);
  }
}

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Tq, int Tk,
                       const long long* strides, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32tc_fwd_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int kRows = Cfg<DH>::kRows;
  const dim3 grid(B * H, (Tq + kRows - 1) / kRows);
  flash_f32tc_fwd_kernel<DH><<<grid, 2 * kRows, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Tq, Tk, strides_of(strides, 0),
      strides_of(strides, 1), strides_of(strides, 2), strides_of(strides, 3),
      scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_fwd_wide(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int H, int Tq, int Tk,
                            int Dh, const long long* strides, float scale,
                            int causal, cudaStream_t stream) {
  const size_t smem = wide_smem_floats() * sizeof(float);
  cudaError_t err = allow_smem(flash_f32tc_fwd_wide_kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int kRows = WideCfg::kRows;
  const dim3 grid(B * H, (Tq + kRows - 1) / kRows, Dh / kPart);
  flash_f32tc_fwd_wide_kernel<<<grid, 2 * kRows, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Tq, Tk, Dh / kPart,
      strides_of(strides, 0), strides_of(strides, 1), strides_of(strides, 2),
      strides_of(strides, 3), scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, Tq, Dh], k/v [B, H, Tk, Dh], o like q, all fp32, Dh 64, 128,
// 256 or a multiple of 128 above 256: any strides with a unit head-dim
// stride and 16-byte aligned rows, given as `strides` = [b, h, t] element
// strides of q, k, v, o (12 values, host memory). lse [B, H, Tq] fp32
// contiguous. Causal needs Tq == Tk (the wrapper checks).
extern "C" int ptpu_flash_attention_f32tc_fwd(const void* q, const void* k,
                                              const void* v, void* o,
                                              void* lse, int B, int H,
                                              int Tq, int Tk, int Dh,
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
    case 256:
      return static_cast<int>(launch_fwd<256>(q, k, v, o, lse, B, H, Tq, Tk,
                                              strides, scale, causal, s));
    default:
      if (Dh > 256 && Dh % kPart == 0)
        return static_cast<int>(launch_fwd_wide(q, k, v, o, lse, B, H, Tq,
                                                Tk, Dh, strides, scale,
                                                causal, s));
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
