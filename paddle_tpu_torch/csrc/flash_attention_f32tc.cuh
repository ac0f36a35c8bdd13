// Helpers of the fp32 flash attention kernels on Hopper's tensor cores by
// 3xTF32 (flash_attention_f32tc.cu, the forward; flash_attention_f32tc_bwd.cu,
// the backward): 16-byte cp.async tile loads into [rows][width + 4] fp32
// tiles, the TF32 big/small split, ldmatrix fragments and the m16n8k8 TF32
// products. Each including source keeps these in its own anonymous
// namespace.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Output columns a block accumulates above head dim 256 (the grid's z index
// picks the part) and the head-dim chunk S and dP are streamed in there
constexpr int kPart = 128;

struct Strides {  // element strides of one [B, H, T, Dh] tensor
  long long b, h, t;
};

Strides strides_of(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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

// Rows [row0, row0 + R) of one (b, h) slice into a [R][kLd] tile (DH
// columns), 16 bytes a copy; rows at or past n are zero-filled (and read
// nothing).
template <int R, int DH, int kThreads, int kLd = DH + 4>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          long long st, int row0, int n) {
  constexpr int kChunks = DH / 4;
  static_assert(R * kChunks % kThreads == 0, "tile chunks per thread");
#pragma unroll
  for (int it = 0; it < R * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    const bool in = row < n;
    cp_async16(s + r * kLd + 4 * c,
               g + (long long)(in ? row : 0) * st + 4 * c, in);
  }
}

// x = big + small, each a TF32 bit pattern
__device__ __forceinline__ void split(float x, unsigned& big,
                                      unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(small)
      : "f"(x - __uint_as_float(big)));
}

// four 8 x 4 blocks of 32-bit words, one a lane group: lane l gives the
// address of row l % 8 of block l / 8 and receives word l % 4 of row
// l / 4 of each block
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b, one m16n8k8 TF32 product
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b to fp32 accuracy: the three products of 3xTF32, small first
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ab)[4],
                                     const unsigned (&as)[4], unsigned bb0,
                                     unsigned bb1, unsigned bs0,
                                     unsigned bs1) {
  mma(d, as, bb0, bb1);
  mma(d, ab, bs0, bs1);
  mma(d, ab, bb0, bb1);
}

// d += a b with the three products of mma3 in the order they take when
// the operands trade places: b a (the transposed product) accumulated by
// mma3 gives the same sums, in the same order, as this gives for a b
__device__ __forceinline__ void mma3_ba(float (&d)[4], const unsigned (&ab)[4],
                                        const unsigned (&as)[4], unsigned bb0,
                                        unsigned bb1, unsigned bs0,
                                        unsigned bs1) {
  mma(d, ab, bs0, bs1);
  mma(d, as, bb0, bb1);
  mma(d, ab, bb0, bb1);
}

// d += a b as mma3, the three products summed from zero and then added to
// d with an fp32 add: the tensor cores' accumulation does not round to
// nearest, and over a long chain of k steps its error grows with the
// chain; here it rounds once a k step
__device__ __forceinline__ void mma3_rn(float (&d)[4], const unsigned (&ab)[4],
                                        const unsigned (&as)[4], unsigned bb0,
                                        unsigned bb1, unsigned bs0,
                                        unsigned bs1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, ab, as, bb0, bb1, bs0, bs1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// A operand (16 rows x 8 k, split) of k step kc from a warp's 16 rows of a
// [rows][DH + 4] fp32 tile: (row grp, k t), (grp + 8, t), (grp, t + 4),
// (grp + 8, t + 4), one ldmatrix
template <int DH>
__device__ __forceinline__ void load_a(unsigned (&ab)[4], unsigned (&as)[4],
                                       const float* s, int kc, int lane) {
  const int m = lane >> 3;
  unsigned r[4];
  ldsm4(r, s + ((m & 1) * 8 + (lane & 7)) * (DH + 4) + 8 * kc
               + 4 * (m >> 1));
#pragma unroll
  for (int e = 0; e < 4; ++e) split(__uint_as_float(r[e]), ab[e], as[e]);
}

// B operands (8 k x 8 n, big or small plane) of n8 tiles 2 np and 2 np + 1,
// k step kc, from a plane stored [n][k] with row stride DH + 4: b[0..1]
// the first tile's (k t, n grp), (k t + 4, n grp), b[2..3] the second's
template <int DH>
__device__ __forceinline__ void load_b(unsigned (&b)[4], const unsigned* s,
                                       int np, int kc, int lane) {
  const int mi = lane >> 3;
  ldsm4(b, s + (8 * (2 * np + (mi >> 1)) + (lane & 7)) * (DH + 4) + 8 * kc
               + 4 * (mi & 1));
}

// The same for one n8 tile nt (b[0..1]), by ldmatrix.x2
template <int DH>
__device__ __forceinline__ void load_b1(unsigned (&b)[2], const unsigned* s,
                                        int nt, int kc, int lane) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(smem_u32(s + (8 * nt + (lane & 7)) * (DH + 4) + 8 * kc
                     + 4 * ((lane >> 3) & 1))));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// column of key k of an 8-key group in the V^T planes: keys 2t and 2t + 1
// go to columns t and t + 4, the k slots their P values take
__device__ __forceinline__ int vt_col(int k) {
  return (k & ~7) | ((k & 1) << 2) | ((k >> 1) & 3);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
