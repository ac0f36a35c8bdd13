// K3: the tree-mask speculative verify window, paged attention of a
// [B, C, H, Dh] query window holding a level-order token tree over one
// layer's paged KV pool, for Hopper (sm_90a). fp32 in, fp32 out.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
// `_paged_attn_tree_kernel` / `paged_attention_tree` (:410-541),
// registered there as `spec_window_tree` (every layer of a tree verify
// window, C = 1 + width * depth).
//
// What it computes, per row b, head h and window slot c: window slot c
// sits at cache position pos0 + c (pos0 = positions[b, 0]); softmax over
// the logical positions t with t < pos0 (the committed prefix, strict) or
// 0 <= t - pos0 < C and anc[c, t - pos0] (t's window slot is c or one of
// c's ancestors: sibling branches are mutually invisible) of
// (q[b, c, h] . k[t]) * sm_scale, applied to v[t]. The last position a
// row can see is pos0 + C - 1; the kernel stops there.
//
// The kernel body, its design and its bound are in paged_attention.cuh,
// shared with K2 under the kTree flag: the mask is ceil(C / 32) uint32
// words a slot built in shared memory from anc, in place of the TPU
// kernel's one-hot matmul.

#include "paged_attention.cuh"

// Shapes (all contiguous): k_pages, v_pages [num_pages, bs, H, Dh] fp32;
// q, out [B, C, H, Dh] fp32; block_tables [B, Mb] int32; positions [B, C]
// int32 (only positions[b, 0] is read); anc [C, C] bool, one byte each.
// 1 <= Dh <= 256, any C >= 1; splits, split_len, the partials and the
// counters as in paged_attention.cu.
extern "C" int ptpu_paged_attention_tree_f32(
    const void* k_pages, const void* v_pages, const void* q,
    const void* block_tables, const void* positions, const void* anc,
    void* out, void* part_m, void* part_l, void* part_acc, void* counters,
    int B, int C, int H, int Dh, int bs, int Mb, int num_pages, int splits,
    int split_len, float sm_scale, void* stream) {
  return launch_dh<true>(k_pages, v_pages, q, block_tables, positions, anc,
                         out, part_m, part_l, part_acc, counters, B, C, H,
                         Dh, bs, Mb, num_pages, splits, split_len, sm_scale,
                         stream);
}
