// Flash attention backward in fp32 on Hopper's tensor cores (sm_90a), by
// 3xTF32: fp32 in and out, fp32 accuracy from TF32 products. Head dims 64
// and 128 whole, 256 and any multiple of 128 above it in 128-column parts
// (the wrapper pads any other head dim up to the width it runs at). The
// forward is flash_attention_f32tc.cu; bf16 takes flash_attention_tc.cu.
//
// Replaces, for fp32 programs, the backward of the TPU kernel
// paddle_tpu/ops/pallas_kernels.py `flash_attention` (:120): its
// `_flash_bwd_rule` (:212; on a TPU jax's library Pallas backward,
// :131-150). It runs once per layer in every fp32 training step.
//
// What it computes, per (batch b, head h), from q [Tq, Dh], k, v [Tk, Dh],
// o, dO and the forward's row log-sum-exp lse: P = exp(S * scale - lse)
// with S = Q K^T (keys at positions >= Tk masked and, when causal, keys
// after the query's position), dP = dO V^T, delta = rowsum(dO * O), dS =
// P (dP - delta), and dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K. A
// row the forward saw fully masked has lse = +inf, for which P is exactly
// 0 and no NaN arises.
//
// Numerics (3xTF32, as the forward). Each fp32 operand x is split into big
// = tf32(x) (cvt.rna) and small = tf32(x - big); a product is a_big b_big +
// a_big b_small + a_small b_big on mma.sync m16n8k8 TF32 with fp32
// accumulators. The softmax, dS and delta stay fp32; P and dS are split
// from their fp32 values in registers. The tensor cores' accumulation does
// not round to nearest: chained over a long sum its error grows with the
// chain and has a sign. So S is formed exactly as the forward forms it
// (the head dim in the same order, the three products in the same order),
// and P = exp(S - lse) then sums to 1 over a row as the forward's did;
// dP and each tile's share of dQ, dK and dV are summed from zero and added
// to their totals with an fp32 add. Without both, at Dh 256 the grads
// missed atol/rtol 1e-4 against the fp32 plain version.
//
// Bound. The five products are 10 Dh flops a visible (query, key) pair,
// 30 Dh as three TF32 products: at the fp32 training path's shapes (B 32,
// H 8, T 512, causal) 64.6 GFLOP at Dh 64, over the tensor cores' 494.7
// TFLOP/s dense TF32 0.130 ms (0.261 at Dh 128), above the bytes (268 MB
// of q, k, v, o, dO, dq, dk, dv: 0.080 ms). So, as the forward, the design
// keeps the products on the tensor cores and the splitting out of their
// way. Deterministic: two launches, no atomics.
// - delta = rowsum(dO * O), one warp a row.
// - One kernel body, two passes, one launch (their blocks interleaved
//   along the grid's y, each pass heaviest first, so that neither pass's
//   tail of light causal blocks leaves the card idle). A block holds R
//   fixed rows X, Y and walks the tiles of T streamed rows U, W; a warp
//   owns 16 fixed rows (at Dh 256 two warps share them, each taking half
//   of a tile's streamed rows; at the end the second adds its sums to the
//   first's, in that order):
//     dK/dV pass: X = K, Y = V (a block per kv tile), U = Q, W = dO (the
//     q tiles from the diagonal on): S^T = K Q^T, dP^T = V dO^T, then
//     dV += P^T dO and dK += dS^T Q;
//     dQ pass: X = Q, Y = dO (a block per q tile), U = K, W = V (the kv
//     tiles up to the diagonal): S = Q K^T, dP = dO V^T, then dQ += dS K.
//   So P^T (P) and dS^T (dS) come out as accumulator fragments, the rows
//   of the second products' A operands: they never go to shared memory.
//   The m16n8k8 A operand wants a thread's k slots t and t + 4 of an 8-row
//   step, its accumulator holds columns 2t and 2t + 1; a sum over k does
//   not care about order, so slots t and t + 4 are bound to streamed rows
//   2t and 2t + 1 in the A operand and in the B operand alike.
// - Each landed U and W tile is split once a block into TF32 big and small
//   planes ([T][width + 4], as they lie). The first products read their B
//   operands from the planes by ldmatrix (an 8 x 8 b16 block is the m16n8k8
//   TF32 fragment); the second products want W (U) as [k][n], and read a
//   thread's two words, rows 8j + 2t and 8j + 2t + 1 of column grp, with
//   plain loads: at a row stride of width + 4 (4 mod 32 words) the 32
//   lanes fall on 32 banks. X and Y are A operands read by ldmatrix from
//   their fp32 rows and split per k step (each warp reads only its own).
// - U and W load by 16-byte cp.async.cg into one raw stage that is free
//   once split: the next tile's copy runs while the current one is
//   multiplied. Two barriers a tile.
// - Shapes (BwdCfg): at Dh 64 R = 64 rows in 4 warps, T = 32 (85 KB, two
//   blocks an SM); at Dh 128 R = 128 in 8 warps, T = 16 (181 KB). From
//   Dh 256 on a block accumulates one 128-column part of its outputs (the
//   part is the fastest index of the grid's x) and forms S and dP by
//   streaming the head dim in 128-column chunks, in order; the block's own
//   chunk is split into planes of its own, which the tile's last chunk
//   multiplies. At Dh 256 the X and Y rows are held whole (R = 64, T = 16,
//   212 KB; 8 warps, two to a row group: one a group left a 4-warp block
//   an SM), and the dQ pass, whose dQ fits in registers, takes no parts:
//   whole-row planes, 232,448 bytes, the most a block may have (the raw
//   stage unpadded). Above 256 a chunk of the X and Y rows is reloaded
//   after each chunk's products (R = 128, 214 KB). Registers are Dh 128's
//   whatever the head dim (but for Dh 256's dQ); every part's blocks form
//   the same S and dP, so those products are done once a part.
// - Causal: the dK/dV pass walks the q tiles from the diagonal on and the
//   dQ pass the kv tiles up to it; a warp skips the products of a tile
//   wholly masked for its rows; only the diagonal tiles and ragged tails
//   are masked. The heaviest blocks come first.
//
// Interface: a plain C function (bound with ctypes), launched on the
// caller's stream, allocating nothing; it returns cudaGetLastError(). The
// caller guarantees 16-byte aligned rows: base addresses and every
// [B, H, T] stride multiples of 4 elements.

#include "flash_attention_f32tc.cuh"

namespace {

// By head dim and pass (kKV: dK/dV): rows a block holds (16 a warp group
// of kSplit warps, which split a tile's streamed rows; R and kSplit the
// same for both passes: the block size), streamed rows a tile, the
// head-dim width of a U/W tile (the whole head, or a kPart chunk) and of
// the X/Y rows held (the whole head, loaded once; or a chunk, reloaded
// each step); kParts: the head streamed in chunks, a block per part of the
// outputs
template <int DH, bool kKV>
struct BwdCfg;
template <bool kKV>
struct BwdCfg<64, kKV> {
  static constexpr int kR = 64, kT = 32, kW = 64, kXW = 64, kSplit = 1;
  static constexpr bool kParts = false;
};
template <bool kKV>
struct BwdCfg<128, kKV> {
  static constexpr int kR = 128, kT = 16, kW = 128, kXW = 128, kSplit = 1;
  static constexpr bool kParts = false;
};
// Dh 256: the dK/dV pass in two parts (dK and dV of 256 columns would take
// 256 registers a thread); the dQ pass whole, its planes and X/Y rows 256
// columns wide (227 KB: the most a block may have). The X/Y rows held
// whole leave room for 64 of them, so two warps share each 16-row group,
// each taking half of a tile's streamed rows (8 warps, not 4)
template <>
struct BwdCfg<256, true> {
  static constexpr int kR = 64, kT = 16, kW = kPart, kXW = 256, kSplit = 2;
  static constexpr bool kParts = true;
};
template <>
struct BwdCfg<256, false> {
  static constexpr int kR = 64, kT = 16, kW = 256, kXW = 256, kSplit = 2;
  static constexpr bool kParts = false;
};
// above 256: the X/Y chunk reloaded each step, 8 warps (at Dh 256 the
// reload cost more than 8 warps bought)
template <bool kKV>
struct BwdCfg<0, kKV> {
  static constexpr int kR = 128, kT = 16, kW = kPart, kXW = kPart, kSplit = 1;
  static constexpr bool kParts = true;
};

// shared floats of a pass: X, Y rows, the raw U/W stage (rows unpadded:
// it is read and written 16 bytes a row position in order), the U and W
// planes (big, small) of the step and, with parts, of the block's own
// chunk, and (dK/dV) two stages of the streamed rows' lse and delta
template <int DH, bool kKV>
constexpr size_t pass_smem_floats() {
  using C = BwdCfg<DH, kKV>;
  return (size_t)2 * C::kR * (C::kXW + 4) + (size_t)2 * C::kT * C::kW
         + (size_t)(C::kParts ? 8 : 4) * C::kT * (C::kW + 4)
         + (kKV ? 4 * C::kT : 0);
}
template <int DH>
constexpr size_t bwd_smem_floats() {
  return pass_smem_floats<DH, true>() > pass_smem_floats<DH, false>()
             ? pass_smem_floats<DH, true>()
             : pass_smem_floats<DH, false>();
}

// delta[b, h, t] = sum_d dO * O in fp32, one warp a row, 16 bytes a lane
__global__ void __launch_bounds__(128)
flash_f32tc_delta_kernel(const float* __restrict__ o,
                         const float* __restrict__ d_o,
                         float* __restrict__ delta, int H, int Tq,
                         long long rows, int Dh, Strides so, Strides sdo) {
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = row / Tq;
  const int tq = (int)(row % Tq), b = (int)(bh / H), h = (int)(bh % H);
  const float* op = o + b * so.b + h * so.h + (long long)tq * so.t;
  const float* dp = d_o + b * sdo.b + h * sdo.h + (long long)tq * sdo.t;
  float acc = 0.f;
  for (int c = lane; c < Dh / 4; c += 32) {
    const float4 a = *reinterpret_cast<const float4*>(op + 4 * c);
    const float4 d = *reinterpret_cast<const float4*>(dp + 4 * c);
    acc = fmaf(a.x, d.x, acc);
    acc = fmaf(a.y, d.y, acc);
    acc = fmaf(a.z, d.z, acc);
    acc = fmaf(a.w, d.w, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// One block of a pass. kKV: the dK/dV pass (x k, y v, u q, w dO; out1 dV,
// out2 dK); else the dQ pass (x q, y dO, u k, w v; out2 dQ). Tx, Tu: rows
// of x (and y), of u (and w); nC head-dim chunks of kW columns (1 up to Dh
// 128); the block's (b*h, part z) and its tile of x, in the order
// heaviest first.
template <int DH, bool kKV>
__device__ __forceinline__ void bwd_pass(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ u, const float* __restrict__ w,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ out1, float* __restrict__ out2, int H, int Tx,
    int Tu, int nC, Strides sx, Strides sy, Strides su, Strides sw,
    Strides so1, Strides so2, float scale, int causal, int bh, int z,
    int tile) {
  using C = BwdCfg<DH, kKV>;
  constexpr int R = C::kR, T = C::kT, W = C::kW;
  constexpr int XW = C::kXW;               // X/Y columns held
  constexpr bool kReload = XW == W && C::kParts;   // X/Y chunks: reloaded
  constexpr int kSplit = C::kSplit;        // warps a 16-row group
  constexpr int kThreads = 2 * R * kSplit, kLd = W + 4;
  constexpr int kNT = T / 8 / kSplit;      // n8 tiles of S a warp
  constexpr int kKS = W / 8;               // k8 steps of S; n8 tiles out
  constexpr int kXF = R * (XW + 4), kUF = T * kLd;
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                       // [R][XW + 4]
  float* y_s = x_s + kXF;                  // [R][XW + 4]
  float* u_raw = y_s + kXF;                // [T][W]
  float* w_raw = u_raw + T * W;            // [T][W]
  // U planes (big, small) and W planes [T][kLd] of the step, then those
  // of the own chunk (with parts; without, the same)
  unsigned* planes = reinterpret_cast<unsigned*>(w_raw + T * W);
  constexpr bool kParts = C::kParts;
  unsigned* own = planes + (kParts ? 4 * kUF : 0);
  float* lse_s = reinterpret_cast<float*>(own + 4 * kUF);  // [2][T] (kKV)
  float* dl_s = lse_s + 2 * T;                          // [2][T] (kKV)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, t = lane & 3;
  const int b = bh / H, h = bh % H;
  const int n_xt = (Tx + R - 1) / R;
  // the heaviest blocks first: the first kv tiles, the last q tiles
  const int x0 = (!kKV && causal ? n_xt - 1 - tile : tile) * R;
  const int Tq = kKV ? Tu : Tx;            // lse and delta rows
  const float* xg = x + b * sx.b + h * sx.h;
  const float* yg = y + b * sy.b + h * sy.h;
  const float* ug = u + b * su.b + h * su.h;
  const float* wg = w + b * sw.b + h * sw.h;
  const float* lg = lse + (long long)bh * Tq;
  const float* dg = delta + (long long)bh * Tq;
  int ut0 = 0, n_ut = (Tu + T - 1) / T;
  if (causal) {
    if (kKV)
      ut0 = x0 / T;                        // q tiles from the diagonal
    else
      n_ut = min(n_ut, (x0 + R - 1) / T + 1);   // kv tiles up to it
  }
  const int n_steps = (n_ut - ut0) * nC;   // (streamed tile, chunk) steps

  // the head dim streamed in order, as the forward sums S
  auto chunk = [&](int s) { return s % nC; };
  auto load_xy = [&](int s) {
    const int c = kReload ? chunk(s) : 0;
    load_tile<R, XW, kThreads>(x_s, xg + c * W, sx.t, x0, Tx);
    load_tile<R, XW, kThreads>(y_s, yg + c * W, sy.t, x0, Tx);
  };
  auto load_uw = [&](int s) {
    const int c = chunk(s), u0 = (ut0 + s / nC) * T;
    load_tile<T, W, kThreads, W>(u_raw, ug + c * W, su.t, u0, Tu);
    load_tile<T, W, kThreads, W>(w_raw, wg + c * W, sw.t, u0, Tu);
    if (kKV && s % nC == 0 && threadIdx.x < T) {
      const int st = (s / nC) & 1, row = u0 + threadIdx.x;
      const bool in = row < Tu;
      cp_async4(lse_s + st * T + threadIdx.x, lg + (in ? row : 0), in);
      cp_async4(dl_s + st * T + threadIdx.x, dg + (in ? row : 0), in);
    }
  };
  load_xy(0);
  load_uw(0);
  cp_async_commit();

  const float c = scale * kLog2e;
  // the warp's 16-row group and, of each streamed tile, its n8 tiles
  const int rg = warp % (R / 16), n0 = warp / (R / 16) * kNT;
  const int xw = x0 + 16 * rg;             // the warp's first fixed row
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
  float acc1[kKV ? kKS : 1][4], acc2[kKS][4], s[kNT][4], dp[kNT][4];
#pragma unroll
  for (int n = 0; n < kKS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc2[n][e] = 0.f;
      if (kKV) acc1[kKV ? n : 0][e] = 0.f;
    }

  for (int step = 0; step < n_steps; ++step) {
    const int u0 = (ut0 + step / nC) * T;
    const bool first = step % nC == 0, last = step % nC == nC - 1;
    // the step's planes: the own chunk's (kept for the second products at
    // the tile's last chunk) or the others'
    unsigned* pl = chunk(step) == z ? own : planes;
    unsigned *ub_s = pl, *us_s = pl + kUF, *wb_s = pl + 2 * kUF,
             *ws_s = pl + 3 * kUF;
    cp_async_wait_all();
    // the step's rows have landed for every thread, and every warp is
    // done with the planes of the step before
    __syncthreads();
#pragma unroll
    for (int it = 0; it < T * W / 4 / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / (W / 4), c4 = i % (W / 4);
      const int raw = r * W + 4 * c4, off = r * kLd + 4 * c4;  // planes
      const float4 ux = *reinterpret_cast<const float4*>(u_raw + raw);
      const float4 wx = *reinterpret_cast<const float4*>(w_raw + raw);
      uint4 bb, ss;
      split(ux.x, bb.x, ss.x);
      split(ux.y, bb.y, ss.y);
      split(ux.z, bb.z, ss.z);
      split(ux.w, bb.w, ss.w);
      *reinterpret_cast<uint4*>(ub_s + off) = bb;
      *reinterpret_cast<uint4*>(us_s + off) = ss;
      split(wx.x, bb.x, ss.x);
      split(wx.y, bb.y, ss.y);
      split(wx.z, bb.z, ss.z);
      split(wx.w, bb.w, ss.w);
      *reinterpret_cast<uint4*>(wb_s + off) = bb;
      *reinterpret_cast<uint4*>(ws_s + off) = ss;
    }
    __syncthreads();                         // planes ready, raw stage free
    if (step + 1 < n_steps) load_uw(step + 1);
    cp_async_commit();

    // the warp's streamed rows [ua, ua + 8 kNT), wholly masked for its
    // fixed rows when all its queries come before the warp's keys
    // (dK/dV) or all its keys after the warp's queries (dQ)
    const int ua = u0 + 8 * n0;
    const bool active =
        !causal || (kKV ? ua + 8 * kNT - 1 >= xw : ua <= xw + 15);
    if (active) {
      // the warp's X and Y rows, at the step's chunk when held whole
      const int xc = kReload ? 0 : chunk(step) * W;
      const float* xw_s = x_s + 16 * rg * (XW + 4) + xc;
      const float* yw_s = y_s + 16 * rg * (XW + 4) + xc;
      if (first) {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
      // S += X U^T as the forward forms Q K^T (its lse is then exactly
      // P's row sum): the head dim in order, the three products in the
      // forward's order (S^T = K Q^T trades the operands: mma3_ba); dP +=
      // Y W^T with each k step's three products added in fp32 (mma3_rn)
#pragma unroll
      for (int kc = 0; kc < kKS; ++kc) {
        unsigned ab[4], as[4];
        load_a<XW>(ab, as, xw_s, kc, lane);
        if constexpr (kNT == 1) {
          unsigned bb[2], bs[2];
          load_b1<W>(bb, ub_s, n0, kc, lane);
          load_b1<W>(bs, us_s, n0, kc, lane);
          if (kKV)
            mma3_ba(s[0], ab, as, bb[0], bb[1], bs[0], bs[1]);
          else
            mma3(s[0], ab, as, bb[0], bb[1], bs[0], bs[1]);
        } else {
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            unsigned bb[4], bs[4];
            load_b<W>(bb, ub_s, n0 / 2 + np, kc, lane);
            load_b<W>(bs, us_s, n0 / 2 + np, kc, lane);
            if (kKV) {
              mma3_ba(s[2 * np], ab, as, bb[0], bb[1], bs[0], bs[1]);
              mma3_ba(s[2 * np + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
            } else {
              mma3(s[2 * np], ab, as, bb[0], bb[1], bs[0], bs[1]);
              mma3(s[2 * np + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
            }
          }
        }
        load_a<XW>(ab, as, yw_s, kc, lane);
        if constexpr (kNT == 1) {
          unsigned bb[2], bs[2];
          load_b1<W>(bb, wb_s, n0, kc, lane);
          load_b1<W>(bs, ws_s, n0, kc, lane);
          mma3_rn(dp[0], ab, as, bb[0], bb[1], bs[0], bs[1]);
        } else {
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            unsigned bb[4], bs[4];
            load_b<W>(bb, wb_s, n0 / 2 + np, kc, lane);
            load_b<W>(bs, ws_s, n0 / 2 + np, kc, lane);
            mma3_rn(dp[2 * np], ab, as, bb[0], bb[1], bs[0], bs[1]);
            mma3_rn(dp[2 * np + 1], ab, as, bb[2], bb[3], bs[2], bs[3]);
          }
        }
      }
    }
    if (active && last) {
      // P and dS in place of S and dP; rows of the accumulators are the
      // warp's fixed rows (keys in the dK/dV pass), columns streamed rows
      const float* ls = lse_s + ((step / nC) & 1) * T;
      const float* ds = dl_s + ((step / nC) & 1) * T;
      const bool edge =
          ua + 8 * kNT > Tu
          || (causal && (kKV ? ua < xw + 15 : ua + 8 * kNT - 1 > xw));
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = 8 * (n0 + n) + 2 * t + (e & 1), col = u0 + cl;
          const int row = e < 2 ? r_lo : r_hi;
          const float lrow = kKV ? ls[cl] * kLog2e : l2[e >> 1];
          const float drow = kKV ? ds[cl] : dl[e >> 1];
          float pv = exp2f(fmaf(s[n][e], c, -lrow));
          if (edge && (col >= Tu
                       || (causal && (kKV ? col < row : col > row))))
            pv = 0.f;
          s[n][e] = pv;
          dp[n][e] = pv * (dp[n][e] - drow);
        }
      // second products over the warp's streamed rows, k step j: A slots
      // t and t + 4 are streamed rows 8 (n0 + j) + 2t and that + 1, the
      // accumulator's columns 2t and 2t + 1. A tile's terms are summed
      // from zero and then added to the outputs in fp32.
      unsigned db[kNT][4], dsm[kNT][4], pb[kKV ? kNT : 1][4],
          ps[kKV ? kNT : 1][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        split(dp[j][0], db[j][0], dsm[j][0]);
        split(dp[j][2], db[j][1], dsm[j][1]);
        split(dp[j][1], db[j][2], dsm[j][2]);
        split(dp[j][3], db[j][3], dsm[j][3]);
        if (kKV) {
          const int jj = kKV ? j : 0;
          split(s[j][0], pb[jj][0], ps[jj][0]);
          split(s[j][2], pb[jj][1], ps[jj][1]);
          split(s[j][1], pb[jj][2], ps[jj][2]);
          split(s[j][3], pb[jj][3], ps[jj][3]);
        }
      }
      const unsigned *ub_o = own, *us_o = own + kUF, *wb_o = own + 2 * kUF,
                     *ws_o = own + 3 * kUF;
#pragma unroll
      for (int n = 0; n < kKS; ++n) {
        float t2[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int o0 = (8 * (n0 + j) + 2 * t) * kLd + grp + 8 * n;
          const int o1 = o0 + kLd;
          // out2 += dS U (dK += dS^T Q, dQ += dS K)
          mma3(t2, db[j], dsm[j], ub_o[o0], ub_o[o1], us_o[o0], us_o[o1]);
          if (kKV)   // out1 += P W (dV += P^T dO)
            mma3(t1, pb[kKV ? j : 0], ps[kKV ? j : 0], wb_o[o0], wb_o[o1],
                 ws_o[o0], ws_o[o1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc2[n][e] += t2[e];
          if (kKV) acc1[kKV ? n : 0][e] += t1[e];
        }
      }
    }
    if (kReload && nC > 1 && step + 1 < n_steps) {
      // the next chunk's X and Y rows, once every warp is done with these
      __syncthreads();
      load_xy(step + 1);
      cp_async_commit();
    }
  }

  if constexpr (kSplit == 2) {
    // the group's second warp adds its sums to the first's, through the
    // X/Y rows (no copy is in flight, every warp is done with them)
    cp_async_wait_all();
    __syncthreads();
    float* red = smem;                     // [R / 16][kKS][32 lanes][4]
    float* red1 = red + (R / 16) * kKS * 128;
    const bool second = n0 != 0;
#pragma unroll
    for (int n = 0; n < kKS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ((rg * kKS + n) * 32 + lane) * 4 + e;
        if (second) {
          red[i] = acc2[n][e];
          if (kKV) red1[i] = acc1[kKV ? n : 0][e];
        }
      }
    __syncthreads();
    if (second) return;
#pragma unroll
    for (int n = 0; n < kKS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ((rg * kKS + n) * 32 + lane) * 4 + e;
        acc2[n][e] += red[i];
        if (kKV) acc1[kKV ? n : 0][e] += red1[i];
      }
  }
  float* g2 = out2 + b * so2.b + h * so2.h + z * W;
  float* g1 = kKV ? out1 + b * so1.b + h * so1.h + z * W : nullptr;
#pragma unroll
  for (int n = 0; n < kKS; ++n) {
    const int col = 8 * n + 2 * t;
    if (r_lo < Tx) {
      *reinterpret_cast<float2*>(g2 + (long long)r_lo * so2.t + col) =
          make_float2(acc2[n][0] * scale, acc2[n][1] * scale);
      if (kKV)
        *reinterpret_cast<float2*>(g1 + (long long)r_lo * so1.t + col) =
            make_float2(acc1[kKV ? n : 0][0], acc1[kKV ? n : 0][1]);
    }
    if (r_hi < Tx) {
      *reinterpret_cast<float2*>(g2 + (long long)r_hi * so2.t + col) =
          make_float2(acc2[n][2] * scale, acc2[n][3] * scale);
      if (kKV)
        *reinterpret_cast<float2*>(g1 + (long long)r_hi * so1.t + col) =
            make_float2(acc1[kKV ? n : 0][2], acc1[kKV ? n : 0][3]);
    }
  }
}

struct BwdArgs {
  const float *q, *k, *v, *d_o, *lse, *delta;
  float *dq, *dk, *dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int H, Tq, Tk, nC_kv, nC_q;   // head-dim chunks (and parts) of each pass
  float scale;
  int causal;
};

// Both passes in one launch (they read only q, k, v, dO, lse and delta),
// their blocks interleaved along the grid's y: even y the dK/dV pass's kv
// tile y / 2, odd y the dQ pass's q tile, each pass heaviest first, so
// that neither pass's light tail leaves the card idle; x is (b*h, part),
// the part fastest, so every part's heavy blocks come before the light
// (a pass with fewer parts leaves the rest of x idle).
template <int DH>
constexpr int bwd_threads() {
  static_assert(BwdCfg<DH, true>::kR == BwdCfg<DH, false>::kR
                    && BwdCfg<DH, true>::kSplit == BwdCfg<DH, false>::kSplit,
                "one block size for both passes");
  return 2 * BwdCfg<DH, true>::kR * BwdCfg<DH, true>::kSplit;
}

template <int DH>
__global__ void __launch_bounds__(bwd_threads<DH>(), 1)
flash_f32tc_bwd_kernel(const BwdArgs a) {
  constexpr int R = BwdCfg<DH, true>::kR;
  const int tile = blockIdx.y >> 1, bh = blockIdx.x / a.nC_kv;
  const int z = blockIdx.x % a.nC_kv;
  if ((blockIdx.y & 1) == 0) {
    if (tile < (a.Tk + R - 1) / R)
      bwd_pass<DH, true>(a.k, a.v, a.q, a.d_o, a.lse, a.delta, a.dv, a.dk,
                         a.H, a.Tk, a.Tq, a.nC_kv, a.sk, a.sv, a.sq, a.sdo,
                         a.sdv, a.sdk, a.scale, a.causal, bh, z, tile);
  } else if (tile < (a.Tq + R - 1) / R && z < a.nC_q) {
    bwd_pass<DH, false>(a.q, a.d_o, a.k, a.v, a.lse, a.delta, nullptr, a.dq,
                        a.H, a.Tq, a.Tk, a.nC_q, a.sq, a.sdo, a.sk, a.sv,
                        a.sdq, a.sdq, a.scale, a.causal, bh, z, tile);
  }
}

// strides: q 0, k 1, v 2, o 3, do 4, dq 5, dk 6, dv 7
template <int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* d_o, const void* lse,
                       void* delta, void* dq, void* dk, void* dv, int B,
                       int H, int Tq, int Tk, int Dh, const long long* st,
                       float scale, int causal, cudaStream_t stream) {
  const long long rows = (long long)B * H * Tq;
  flash_f32tc_delta_kernel<<<(unsigned)((rows + 3) / 4), 128, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(d_o),
      static_cast<float*>(delta), H, Tq, rows, Dh, strides_of(st, 3),
      strides_of(st, 4));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int R = BwdCfg<DH, true>::kR;
  const BwdArgs a{static_cast<const float*>(q),
                  static_cast<const float*>(k),
                  static_cast<const float*>(v),
                  static_cast<const float*>(d_o),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<float*>(dq),
                  static_cast<float*>(dk),
                  static_cast<float*>(dv),
                  strides_of(st, 0),
                  strides_of(st, 1),
                  strides_of(st, 2),
                  strides_of(st, 4),
                  strides_of(st, 5),
                  strides_of(st, 6),
                  strides_of(st, 7),
                  H,
                  Tq,
                  Tk,
                  Dh / BwdCfg<DH, true>::kW,
                  Dh / BwdCfg<DH, false>::kW,
                  scale,
                  causal};
  const size_t smem = bwd_smem_floats<DH>() * sizeof(float);
  err = allow_smem(flash_f32tc_bwd_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = ((Tq > Tk ? Tq : Tk) + R - 1) / R;
  const dim3 grid(B * H * a.nC_kv, 2 * tiles);
  flash_f32tc_bwd_kernel<DH><<<grid, bwd_threads<DH>(), smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The backward: dq/dk/dv like q/k/v (their own strides), from q, k, v, o,
// do and the forward's lse, all fp32, Dh 64, 128 or a multiple of 128 from
// 256 on, any strides with a unit head-dim stride and 16-byte aligned rows;
// delta is fp32 [B, H, Tq] scratch. `strides` holds 24 values (host
// memory): [b, h, t] element strides of q, k, v, o, do, dq, dk, dv. Causal
// needs Tq == Tk (the wrapper checks).
extern "C" int ptpu_flash_attention_f32tc_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* d_o, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int Dh,
    const long long* strides, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return static_cast<int>(launch_bwd<64>(q, k, v, o, d_o, lse, delta, dq,
                                           dk, dv, B, H, Tq, Tk, Dh, strides,
                                           scale, causal, s));
  if (Dh == 128)
    return static_cast<int>(launch_bwd<128>(q, k, v, o, d_o, lse, delta, dq,
                                            dk, dv, B, H, Tq, Tk, Dh,
                                            strides, scale, causal, s));
  if (Dh == 256)
    return static_cast<int>(launch_bwd<256>(q, k, v, o, d_o, lse, delta, dq,
                                            dk, dv, B, H, Tq, Tk, Dh,
                                            strides, scale, causal, s));
  if (Dh > 256 && Dh % kPart == 0)
    return static_cast<int>(launch_bwd<0>(q, k, v, o, d_o, lse, delta, dq,
                                          dk, dv, B, H, Tq, Tk, Dh, strides,
                                          scale, causal, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
