// K2: paged attention of a causal [B, C, H, Dh] query window over one
// layer's paged KV pool, for Hopper (sm_90a). fp32 in, fp32 out.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
// `_paged_attn_kernel` / `paged_attention` (:261-380), registered there as
// `paged_decode` (C = 1, every layer of every serving decode step) and
// `spec_window` (C = k + 1, every layer of a linear speculative verify
// window).
//
// What it computes, per row b, head h and window slot c: softmax over the
// logical positions t <= positions[b, c] of (q[b, c, h] . k[t]) * sm_scale,
// applied to v[t]. The kernel body, its design and its bound are in
// paged_attention.cuh, shared with the tree window (K3).

#include "paged_attention.cuh"

// Shapes (all contiguous): k_pages, v_pages [num_pages, bs, H, Dh] fp32;
// q, out [B, C, H, Dh] fp32; block_tables [B, Mb] int32; positions [B, C]
// int32. 1 <= Dh <= 256, any C >= 1. `splits` blocks a (b, h, chunk), each
// over `split_len` positions (a multiple of 64, splits * split_len >= Mb
// * bs); with splits > 1, part_m and part_l [B * C * H * splits] and
// part_acc [B * C * H * splits * Dh] fp32 scratch (16-byte aligned), and
// counters [B * H * ceil(C / 32)] int32, zero on entry and on return.
extern "C" int ptpu_paged_attention_f32(
    const void* k_pages, const void* v_pages, const void* q,
    const void* block_tables, const void* positions, void* out,
    void* part_m, void* part_l, void* part_acc, void* counters, int B, int C,
    int H, int Dh, int bs, int Mb, int num_pages, int splits, int split_len,
    float sm_scale, void* stream) {
  return launch_dh<false>(k_pages, v_pages, q, block_tables, positions,
                          nullptr, out, part_m, part_l, part_acc, counters,
                          B, C, H, Dh, bs, Mb, num_pages, splits, split_len,
                          sm_scale, stream);
}
