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
// int32. Dh is a multiple of 32 up to 256 and 1 <= C <= 16 (the wrapper
// checks).
extern "C" int ptpu_paged_attention_f32(
    const void* k_pages, const void* v_pages, const void* q,
    const void* block_tables, const void* positions, void* out, int B, int C,
    int H, int Dh, int bs, int Mb, int num_pages, float sm_scale,
    void* stream) {
  return launch_dh<false>(k_pages, v_pages, q, block_tables, positions,
                          nullptr, out, B, C, H, Dh, bs, Mb, num_pages,
                          sm_scale, stream);
}
