"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked ``cuda``: they skip where there is no CUDA device (a
hand-written kernel has no CPU mode). This file imports no jax, so it
also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as pa


@pytest.mark.cuda
@pytest.mark.parametrize("Dh,C,bs", [(64, 1, 16), (32, 3, 4),
                                      (128, 16, 16), (64, 4, 5),
                                      (96, 4, 16), (160, 2, 16),
                                      (192, 7, 5), (224, 16, 16),
                                      (256, 16, 16), (48, 5, 16),
                                      (80, 17, 16), (100, 33, 5),
                                      (50, 3, 4), (64, 17, 16),
                                      (64, 33, 16), (256, 64, 16),
                                      (48, 64, 16), (64, 16, 16)])
def test_kernel_matches_plain_on_card(Dh, C, bs):
    """The CUDA kernel against the plain version on the card: ragged
    positions, scattered pages, null tails, every instantiated head dim
    (the multiples of 32 to 256) and head dims between them (48, 80, 100:
    masked columns; 50: not a multiple of 4, 4-byte copies), windows of
    one to three 32-slot chunks (17, 33, 64; 16 the serving bench's
    chunk at the flagship's head dim), the context split across
    blocks with splits past a short row's last position left empty (atol
    1e-4: fp32, different summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, H, Mb = 6, 4, 8
    rng = np.random.RandomState(Dh + C)
    last = rng.randint(C - 1, Mb * bs, size=B)
    last[:2] = [Mb * bs - 1, C - 1]
    pos = last[:, None] - (C - 1) + np.arange(C)[None, :]
    tables = np.zeros((B, Mb), np.int32)
    perm = rng.permutation(B * Mb) + 1
    for b in range(B):
        n = last[b] // bs + 1
        tables[b, :n] = perm[b * Mb:b * Mb + n]
    dev = torch.device("cuda")
    k = torch.from_numpy(
        rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32)).to(dev)
    v = torch.from_numpy(
        rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.randn(B, C, H, Dh).astype(np.float32)).to(dev)
    t = torch.from_numpy(tables).to(dev)
    p = torch.from_numpy(pos.astype(np.int32)).to(dev)
    launches = pa.paged_attention.window_launches.get(C, 0)
    got = pa.paged_attention(k, v, q, t, p)
    want = pa.paged_attention_reference(k, v, q, t, p)
    torch.cuda.synchronize()
    assert pa.paged_attention.window_launches[C] == launches + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_prefill_chunk_matrix_matches_plain_on_card():
    """K2 at C=64 on the prefill-chunk window the fast path gives it
    (Dh 64, block 16, max_seq_len 512): valid spans of 1, 7, 33 and 64
    slots in one call (the rest of each window into null table entries),
    a decode row at position 500 whose window runs past the table, two
    rows on 16 shared (adopted) blocks, an inactive row (atol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    C, H, Dh, bs, Mb = 64, 8, 64, 16, 32
    rows = ((0, 1, False), (100, 7, False), (300, 33, False),
            (448, 64, False), (500, 1, False), (256, 64, True),
            (256, 5, True), (40, 0, False))
    B = len(rows)
    rng = np.random.RandomState(64)
    tables = np.zeros((B, Mb), np.int32)
    perm = rng.permutation(B * Mb) + 1
    for b, (start, span, adopts) in enumerate(rows):
        if span:
            n = min((start + span - 1) // bs + 1, Mb)
            tables[b, :n] = perm[b * Mb:b * Mb + n]
            if adopts:
                tables[b, :16] = perm[-16:]
    pos = np.array([r[0] for r in rows])[:, None] + np.arange(C)[None, :]
    dev = torch.device("cuda")
    k = torch.from_numpy(
        rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32)).to(dev)
    v = torch.from_numpy(
        rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.randn(B, C, H, Dh).astype(np.float32)).to(dev)
    t = torch.from_numpy(tables).to(dev)
    p = torch.from_numpy(pos.astype(np.int32)).to(dev)
    launches = pa.paged_attention.window_launches.get(C, 0)
    got = pa.paged_attention(k, v, q, t, p)
    want = pa.paged_attention_reference(k, v, q, t, p)
    torch.cuda.synchronize()
    assert pa.paged_attention.window_launches[C] == launches + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_two_threads_two_streams_on_card():
    """Two K2 callers at once, as two serving replicas call it: each on
    its own thread and CUDA stream, 200 launches each over inputs of its
    own (a context split across blocks, so each stream's zeroed count
    buffer is used). Every output equals the plain version's (atol
    1e-4), the two streams' count buffers are distinct, and the launch
    counts sum exactly (no increment lost between threads)."""
    import threading

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, C, H, Dh, bs, Mb, n = 4, 1, 8, 64, 16, 32, 200
    dev = torch.device("cuda", 0)

    def inputs(seed):
        rng = np.random.RandomState(seed)
        tables = (rng.permutation(B * Mb) + 1).reshape(B, Mb)
        pos = rng.randint(Mb * bs // 2, Mb * bs, size=(B, C))
        return [torch.from_numpy(a).to(dev) for a in (
            rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32),
            rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32),
            rng.randn(B, C, H, Dh).astype(np.float32),
            tables.astype(np.int32), pos.astype(np.int32))]

    args = [inputs(1), inputs(2)]
    torch.cuda.synchronize()
    wants = [pa.paged_attention_reference(*a) for a in args]
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    outs, errors = [[], []], []
    start = threading.Barrier(2)

    def caller(i):
        try:
            torch.cuda.set_device(dev)
            with torch.cuda.stream(streams[i]):
                start.wait()
                for _ in range(n):
                    outs[i].append(pa.paged_attention(*args[i]))
                streams[i].synchronize()
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    launches = pa.paged_attention.window_launches.get(C, 0)
    threads = [threading.Thread(target=caller, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert pa.paged_attention.window_launches[C] == launches + 2 * n
    keys = {(dev, s.cuda_stream) for s in streams}
    assert len(keys) == 2 and keys <= set(pa._counters)
    for got, want in zip(outs, wants):
        assert len(got) == n
        for o in (got[0], got[n // 2], got[-1]):
            np.testing.assert_allclose(o.cpu().numpy(), want.cpu().numpy(),
                                       atol=1e-4, rtol=1e-4)
        assert all(torch.equal(o, got[0]) for o in got)


@pytest.mark.cuda
def test_fast_path_engine_matches_reference_on_card():
    """The flagship decoder at full width (vocab 32000, d_model 512, 8
    heads, 6 layers, d_ff 2048) behind ``ServingEngine(prefill_chunk=64,
    prefix_cache=True)`` on the card: 4 prompts on a 128-token shared
    prefix after a priming request, each token-identical to
    reference_decode; every request adopted the 8 shared blocks, K2 ran
    at C=64, and the pool drains clean."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from paddle_tpu_torch.serving import (GenerationConfig, GenerationModel,
                                          ServingEngine, reference_decode)

    cfg = GenerationConfig(vocab_size=32000, d_model=512, n_heads=8,
                           n_layers=6, d_ff=2048, max_seq_len=512)
    model = GenerationModel.random(cfg, seed=0)
    rng = np.random.RandomState(11)
    shared = rng.randint(0, cfg.vocab_size, size=128).tolist()
    prompts = [shared + rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in (2, 5, 8, 3)]
    refs = [reference_decode(model, p, 8) for p in prompts]
    launches = pa.paged_attention.window_launches.get(64, 0)
    with ServingEngine(model, max_batch=4, max_seq_len=cfg.max_seq_len,
                       block_size=16, prefill_chunk=64,
                       prefix_cache=True) as engine:
        engine.generate(shared + [7], max_new_tokens=2, timeout=600)
        base = engine.stats()["default"]["prefix_blocks_reused"]
        reqs = [engine.submit(p, max_new_tokens=8) for p in prompts]
        got = [r.wait(600) for r in reqs]
        stats = engine.stats()["default"]
    assert got == refs
    assert stats["prefix_blocks_reused"] - base == 4 * 8
    assert pa.paged_attention.window_launches[64] > launches
    pool = engine._workers["default"].pool
    assert pool.check_invariants() == []
    assert pool.stats()["blocks_in_use"] == 0


@pytest.mark.cuda
def test_int8_store_engine_matches_reference_on_card():
    """The flagship decoder at full width over the weight-only int8
    store (``GenerationModel.quantized()``: 26 int8 weights, each
    dequantized where a step uses it) behind ``ServingEngine(
    prefill_chunk=16)`` on the card: 4 prompts, each token-identical to
    ``reference_decode`` over the dequantized weights; K2 ran at C=16
    and C=1, and the engine reports the int8 store."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from paddle_tpu_torch.serving import (GenerationConfig, GenerationModel,
                                          ServingEngine, reference_decode)

    cfg = GenerationConfig(vocab_size=32000, d_model=512, n_heads=8,
                           n_layers=6, d_ff=2048, max_seq_len=512)
    model = GenerationModel.random(cfg, seed=0).quantized()
    rng = np.random.RandomState(12)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in (5, 17, 33, 12)]
    refs = [reference_decode(model, p, 8) for p in prompts]
    before = dict(pa.paged_attention.window_launches)
    with ServingEngine(model, max_batch=4, max_seq_len=cfg.max_seq_len,
                       block_size=16, prefill_chunk=16) as engine:
        reqs = [engine.submit(p, max_new_tokens=8) for p in prompts]
        got = [r.wait(600) for r in reqs]
    stats = engine.stats()["default"]
    assert got == refs
    assert stats["weight_only_int8"]
    assert stats["weight_store"]["n_int8"] == 2 + 4 * cfg.n_layers
    for c in (1, 16):
        assert pa.paged_attention.window_launches[c] > before.get(c, 0)
    assert engine._workers["default"].pool.check_invariants() == []


@pytest.mark.cuda
@pytest.mark.parametrize("W,D,Dh,bs", [(2, 6, 64, 16), (1, 4, 32, 4),
                                       (3, 8, 128, 16), (1, 31, 128, 16),
                                       (4, 4, 64, 5), (2, 6, 96, 16),
                                       (1, 15, 160, 16), (3, 4, 192, 5),
                                       (2, 6, 224, 16), (1, 31, 256, 16),
                                       (4, 8, 64, 16), (7, 9, 64, 16),
                                       (2, 8, 48, 16), (1, 40, 80, 16),
                                       (4, 8, 100, 16), (3, 7, 256, 16)])
def test_tree_kernel_matches_plain_on_card(W, D, Dh, bs):
    """K3 against its plain version on the card: tree windows C = 1 + W*D
    of one to three 32-slot chunks (33 and 64: ancestor masks of two
    words a slot), every instantiated head dim (the multiples of 32 to
    256) and head dims between them (48, 80, 100), window bases on and
    off block boundaries, a window running past the table, an inactive
    row (position 0, null table), null tails; at width 1 also against
    K2 (atol 1e-4: fp32, different summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import paged_attention_tree as pat
    from paddle_tpu_torch.serving import tree_topology

    B, H, Mb = 6, 4, 8
    C = 1 + W * D
    T = Mb * bs
    rng = np.random.RandomState(W * 100 + D)
    pos0 = rng.randint(1, T - C + 1, size=B)
    pos0[:3] = [0, T - C + 2, bs]
    tables = np.zeros((B, Mb), np.int32)
    perm = rng.permutation(B * Mb) + 1
    for b in range(1, B):
        n = min((pos0[b] + C - 1) // bs + 1, Mb)
        tables[b, :n] = perm[b * Mb:b * Mb + n]
    pos = pos0[:, None] + np.arange(C)[None, :]
    dev = torch.device("cuda")
    k = torch.from_numpy(
        rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32)).to(dev)
    v = torch.from_numpy(
        rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.randn(B, C, H, Dh).astype(np.float32)).to(dev)
    t = torch.from_numpy(tables).to(dev)
    p = torch.from_numpy(pos.astype(np.int32)).to(dev)
    anc = torch.from_numpy(tree_topology(W, D)[2]).to(dev)
    launches = pat.paged_attention_tree.launches
    got = pat.paged_attention_tree(k, v, q, t, p, anc)
    want = pat.paged_attention_tree_reference(k, v, q, t, p, anc)
    torch.cuda.synchronize()
    assert pat.paged_attention_tree.launches == launches + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    if W == 1:
        lin = pa.paged_attention(k, v, q, t, p)
        np.testing.assert_allclose(got.cpu().numpy(), lin.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_tree_kernel_wrapper_checks_on_card():
    """The wrapper refuses what the kernel does not take, naming it; a
    window of 33 slots and head dim 48 (refused before the kernel took
    any window and head dim) run and match the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import paged_attention_tree as pat

    dev = torch.device("cuda")
    k = torch.zeros(5, 4, 2, 64, device=dev)
    tables = torch.zeros(1, 2, dtype=torch.int32, device=dev)

    def call(C=5, anc=None, Dh=64):
        kk = k if Dh == 64 else torch.zeros(5, 4, 2, Dh, device=dev)
        q = torch.zeros(1, C, 2, Dh, device=dev)
        pos = torch.arange(C, dtype=torch.int32, device=dev)[None]
        if anc is None:
            anc = torch.eye(C, dtype=torch.bool, device=dev)
        return pat.paged_attention_tree(kk, kk, q, tables, pos, anc)

    for C, Dh in ((33, 64), (5, 48)):
        kk = torch.randn(5, 4, 2, Dh, device=dev)
        q = torch.randn(1, C, 2, Dh, device=dev)
        pos = torch.arange(C, dtype=torch.int32, device=dev)[None]
        tab = torch.tensor([[3, 1]], dtype=torch.int32, device=dev)
        anc = torch.ones(C, C, dtype=torch.bool, device=dev).tril()
        got = pat.paged_attention_tree(kk, kk, q, tab, pos, anc)
        want = pat.paged_attention_tree_reference(kk, kk, q, tab, pos, anc)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="head_dim 260 is above"):
        call(Dh=260)
    with pytest.raises(ValueError, match="tree window C=8193"):
        call(C=pat.MAX_TREE_WINDOW + 1)
    with pytest.raises(TypeError, match="anc must be torch.bool"):
        call(anc=torch.eye(5, device=dev))
    with pytest.raises(ValueError, match=r"anc must be \[C, C\]"):
        call(anc=torch.eye(4, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError, match="anc is on cpu"):
        call(anc=torch.eye(5, dtype=torch.bool))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Tq,Tk,causal,dtype,layout", [
    (2, 3, 256, 256, True, "float32", "bhtd"),
    (2, 2, 192, 192, True, "bfloat16", "bthd"),
    (1, 2, 128, 320, False, "float32", "bthd"),
    (1, 1, 100, 100, True, "bfloat16", "bhtd"),   # ragged tiles
    (1, 2, 72, 200, False, "bfloat16", "bhtd"),
    (1, 2, 1, 1, True, "bfloat16", "bhtd"),       # one row, one key
    (2, 3, 65, 65, True, "bfloat16", "bthd"),     # one row past a tile
    (2, 1, 129, 129, True, "bfloat16", "bhtd"),   # past a 128-row block
    (160, 8, 128, 128, True, "bfloat16", "bthd"),  # B*H 1280
])
def test_flash_attention_kernels_match_plain_on_card(B, H, Tq, Tk, causal,
                                                     dtype, layout):
    """K1's forward and backward kernels against the plain version's
    forward and autograd on the same inputs on the card, in [B, H, T, Dh]
    and through the strided views of [B, T, H, Dh] tensors. Tolerance:
    fp32 atol/rtol 1e-4 (different order of sums); bf16 outputs atol/rtol
    1e-2 (both sides round to bf16, 1 ulp is at most 2^-7 |want|), bf16
    grads atol 3e-2, rtol 1e-2 (the kernel's delta uses the bf16-rounded
    O, and the tensor-core kernels round P and dS to bf16; the CPU test
    `test_tc_kernel_numerics_within_card_limits` emulates that). bf16
    takes the tensor-core route both ways; fp32 the 3xTF32 tensor-core
    route both ways."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(Tq + Tk)
    dev, tdt = torch.device("cuda"), getattr(torch, dtype)

    def make(T):
        shape = (B, H, T, 64) if layout == "bhtd" else (B, T, H, 64)
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        t = t.to(dev, tdt)
        return t if layout == "bhtd" else t.transpose(1, 2)

    q, k, v, g = make(Tq), make(Tk), make(Tk), make(Tq)
    tols = ({"out": (1e-4, 1e-4), "grads": (1e-4, 1e-4)}
            if dtype == "float32"
            else {"out": (1e-2, 1e-2), "grads": (3e-2, 1e-2)})
    before = _flash_counts(fa, dtype)
    out, grads = _flash_against_plain(fa, q, k, v, g, causal, tols)
    assert _flash_counts(fa, dtype) == tuple(n + 1 for n in before[:4]) + (
        before[4],)
    assert out.stride() == q.stride()   # written where the layout says


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Tq,Tk,causal,dtype,layout,Dh", [
    (2, 3, 256, 256, True, "bfloat16", "bthd", 128),
    (1, 2, 128, 256, False, "bfloat16", "bhtd", 128),
    (2, 3, 256, 256, True, "float32", "bhtd", 128),
    (1, 2, 128, 256, False, "float32", "bthd", 128),
    (2, 1, 129, 129, True, "bfloat16", "bhtd", 128),  # past a 128-row block
    (1, 2, 100, 100, True, "float32", "bhtd", 128),   # ragged tiles
    (2, 2, 256, 256, True, "bfloat16", "bthd", 96),   # padded to 128
    (1, 2, 128, 256, False, "float32", "bhtd", 96),
    (2, 2, 256, 256, True, "bfloat16", "bthd", 256),
    (1, 2, 128, 256, False, "bfloat16", "bhtd", 256),
    (2, 2, 256, 256, True, "float32", "bhtd", 256),
    (1, 2, 128, 256, False, "float32", "bthd", 256),
    (1, 2, 100, 100, True, "bfloat16", "bhtd", 256),  # ragged tiles
    (2, 2, 256, 256, True, "bfloat16", "bhtd", 192),  # padded to 256
    (1, 2, 128, 256, False, "float32", "bthd", 192),
    (2, 2, 256, 256, True, "float32", "bthd", 160),
    (1, 2, 128, 256, False, "bfloat16", "bhtd", 160),
])
def test_flash_attention_wide_heads_match_plain_on_card(B, H, Tq, Tk, causal,
                                                        dtype, layout, Dh):
    """K1 at head dims 128 and 256 (every route's second and third
    instantiations) and at 96, 160 and 192, which the wrapper zero-pads
    to 128 or 256 (q, k, v in the forward and dO in the backward: 4
    copies counted) and slices back, against the plain version's forward
    and autograd at the true head dim and its default scale Dh^-0.5.
    Tolerances as in test_flash_attention_kernels_match_plain_on_card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(Tq + Tk + Dh)
    dev, tdt = torch.device("cuda"), getattr(torch, dtype)

    def make(T):
        shape = (B, H, T, Dh) if layout == "bhtd" else (B, T, H, Dh)
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        t = t.to(dev, tdt)
        return t if layout == "bhtd" else t.transpose(1, 2)

    q, k, v, g = make(Tq), make(Tk), make(Tk), make(Tq)
    tols = ({"out": (1e-4, 1e-4), "grads": (1e-4, 1e-4)}
            if dtype == "float32"
            else {"out": (1e-2, 1e-2), "grads": (3e-2, 1e-2)})
    padded = fa.kernel_head_dim(Dh) != Dh
    before = _flash_counts(fa, dtype)
    out, grads = _flash_against_plain(fa, q, k, v, g, causal, tols)
    assert _flash_counts(fa, dtype) == tuple(n + 1 for n in before[:4]) + (
        before[4] + (4 if padded else 0),)
    assert out.shape == q.shape
    assert all(d.shape == t.shape for d, t in zip(grads, (q, k, v)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,H,Tq,Tk,causal,layout,Dh", [
    (1, 2, 128, 128, True, "bhtd", 320),    # padded to 384
    (2, 2, 200, 200, True, "bthd", 384),    # ragged tiles
    (2, 2, 256, 256, True, "bthd", 512),
    (1, 2, 72, 200, False, "bhtd", 512),    # cross, ragged
])
def test_flash_attention_head_dims_past_256_match_plain_on_card(
        B, H, Tq, Tk, causal, layout, Dh, dtype):
    """F1c: head dims above the largest instantiation run on the kernels
    (a block a 128-column part of the outputs, the head dim streamed in
    128-column chunks to form the scores) and match the plain version
    forward and backward, by their dtype's routes; 320 runs zero-padded
    to 384 (4 copies counted). Tolerances as in
    test_flash_attention_kernels_match_plain_on_card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(Tq + Tk + Dh)
    dev, tdt = torch.device("cuda"), getattr(torch, dtype)

    def make(T):
        shape = (B, H, T, Dh) if layout == "bhtd" else (B, T, H, Dh)
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        t = t.to(dev, tdt)
        return t if layout == "bhtd" else t.transpose(1, 2)

    q, k, v, g = make(Tq), make(Tk), make(Tk), make(Tq)
    tols = ({"out": (1e-4, 1e-4), "grads": (1e-4, 1e-4)}
            if dtype == "float32"
            else {"out": (1e-2, 1e-2), "grads": (3e-2, 1e-2)})
    padded = fa.kernel_head_dim(Dh) != Dh
    before = _flash_counts(fa, dtype)
    out, grads = _flash_against_plain(fa, q, k, v, g, causal, tols)
    assert _flash_counts(fa, dtype) == tuple(n + 1 for n in before[:4]) + (
        before[4] + (4 if padded else 0),)
    assert out.shape == q.shape
    assert all(d.shape == t.shape for d, t in zip(grads, (q, k, v)))


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [64, 96, 128, 256])
@pytest.mark.parametrize("B,H,Tq,Tk,causal,layout", [
    (2, 3, 256, 256, True, "bthd"),
    (1, 2, 128, 320, False, "bhtd"),
    (1, 2, 100, 100, True, "bhtd"),    # ragged tiles
    (1, 1, 72, 200, False, "bthd"),
])
def test_flash_attention_f32tc_forward_matches_plain_on_card(B, H, Tq, Tk,
                                                             causal, layout,
                                                             Dh):
    """The fp32 forward on the tensor cores (3xTF32) against the plain
    version, causal and cross, at every instantiated head dim and 96
    (padded to 128): out within atol/rtol 1e-4 (fp32 accuracy), the lse
    it writes equal to the plain log-sum-exp within 1e-4, one launch by
    the "f32tc" route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(Tq + Tk + Dh)

    def make(T):
        shape = (B, H, T, Dh) if layout == "bhtd" else (B, T, H, Dh)
        t = torch.from_numpy(
            (2 * rng.standard_normal(shape)).astype(np.float32)).cuda()
        return t if layout == "bhtd" else t.transpose(1, 2)

    q, k, v = make(Tq), make(Tk), make(Tk)
    scale = Dh ** -0.5
    n = fa.flash_attention_fwd.launches_by_route["f32tc"]
    out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches_by_route["f32tc"] == n + 1
    want = fa.flash_attention_reference(q, k, v, causal, scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        s = s.masked_fill(~torch.ones(Tq, Tk, dtype=torch.bool,
                                      device="cuda").tril(), float("-inf"))
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lse.cpu().numpy(),
                               torch.logsumexp(s, -1).cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [64, 96, 128, 256])
@pytest.mark.parametrize("B,H,Tq,Tk,causal,layout", [
    (2, 3, 256, 256, True, "bthd"),
    (1, 2, 128, 320, False, "bhtd"),
    (1, 2, 100, 100, True, "bhtd"),    # ragged tiles
    (1, 1, 72, 200, False, "bthd"),
])
def test_flash_attention_f32tc_backward_matches_plain_on_card(B, H, Tq, Tk,
                                                              causal, layout,
                                                              Dh):
    """The fp32 backward on the tensor cores (3xTF32) against the plain
    version's autograd, on the forward test's shapes and inputs: dq, dk,
    dv within atol/rtol 1e-4 (fp32 accuracy), one launch each way by the
    "f32tc" route; two backward calls on the same inputs bitwise equal
    (no atomics: the sums do not depend on the order blocks run in)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(Tq + Tk + Dh)

    def make(T):
        shape = (B, H, T, Dh) if layout == "bhtd" else (B, T, H, Dh)
        t = torch.from_numpy(
            (2 * rng.standard_normal(shape)).astype(np.float32)).cuda()
        return t if layout == "bhtd" else t.transpose(1, 2)

    q, k, v, g = make(Tq), make(Tk), make(Tk), make(Tq)
    before = _flash_counts(fa, "float32")
    _flash_against_plain(fa, q, k, v, g, causal,
                         {"out": (1e-4, 1e-4), "grads": (1e-4, 1e-4)})
    padded = fa.kernel_head_dim(Dh) != Dh
    assert _flash_counts(fa, "float32") == tuple(
        n + 1 for n in before[:4]) + (before[4] + (4 if padded else 0),)
    if not padded:
        scale = Dh ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        first = fa.flash_attention_bwd(q, k, v, o, lse, g, causal, scale)
        again = fa.flash_attention_bwd(q, k, v, o, lse, g, causal, scale)
        torch.cuda.synchronize()
        for name, x, y in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(x, y), name


def _flash_counts(fa, dtype):
    """(fwd launches, bwd launches, fwd and bwd launches by the route of
    `dtype` (bf16: "tc"; fp16: "fp16"; fp32: "f32tc"; both ways), copies
    of both)."""
    f, b = fa.flash_attention_fwd, fa.flash_attention_bwd
    fr = br = {"bfloat16": "tc", "float16": "fp16"}.get(dtype, "f32tc")
    return (f.launches, b.launches, f.launches_by_route[fr],
            b.launches_by_route[br], f.copies + b.copies)


def _flash_against_plain(fa, q, k, v, g, causal, tols):
    """K1 forward and autograd against the plain version's on the same
    inputs, to `tols`; returns the kernels' (out, grads)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    ref_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    ref = fa.flash_attention_reference(*ref_leaves, causal=causal)
    ref_grads = torch.autograd.grad(ref, ref_leaves, g)
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               (out,) + grads, (ref,) + ref_grads):
        assert got.dtype == q.dtype and torch.isfinite(got).all(), name
        atol, rtol = tols["out" if name == "out" else "grads"]
        np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                                   want.detach().float().cpu().numpy(),
                                   err_msg=name, atol=atol, rtol=rtol)
    return out, grads


# fp16 against the plain version: outputs atol/rtol 2e-3 (both sides round
# to fp16, 1 ulp is at most 2^-10 |want|); grads atol 4e-3, rtol 2e-3 (P,
# dS and the delta's O rounded to fp16 in the kernel, 8x finer than the
# bf16 limits' 2^-7)
FP16_TOLS = {"out": (2e-3, 2e-3), "grads": (4e-3, 2e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Tq,Tk,causal,layout,Dh", [
    (2, 3, 256, 256, True, "bthd", 64),
    (1, 2, 128, 320, False, "bhtd", 64),
    (1, 1, 100, 100, True, "bhtd", 64),    # ragged tiles
    (2, 1, 129, 129, True, "bthd", 64),    # past a 128-row block
    (2, 3, 256, 256, True, "bthd", 128),
    (1, 2, 128, 256, False, "bhtd", 128),
    (2, 2, 256, 256, True, "bthd", 96),    # padded to 128
    (1, 2, 128, 256, False, "bhtd", 192),  # padded to 256
])
def test_flash_attention_fp16_matches_plain_on_card(B, H, Tq, Tk, causal,
                                                    layout, Dh):
    """F3: K1's fp16 route (the tensor-core source's kernels instantiated
    for fp16) forward and backward against the plain version's forward
    and autograd, at Dh 64 and 128 and at 96 and 192, which the wrapper
    zero-pads (4 counted copies); both ways by the "fp16" route.
    Tolerance: FP16_TOLS."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(Tq + Tk + Dh + 16)
    dev = torch.device("cuda")

    def make(T):
        shape = (B, H, T, Dh) if layout == "bhtd" else (B, T, H, Dh)
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        t = t.to(dev, torch.float16)
        return t if layout == "bhtd" else t.transpose(1, 2)

    q, k, v, g = make(Tq), make(Tk), make(Tk), make(Tq)
    padded = fa.kernel_head_dim(Dh) != Dh
    before = _flash_counts(fa, "float16")
    out, grads = _flash_against_plain(fa, q, k, v, g, causal, FP16_TOLS)
    assert _flash_counts(fa, "float16") == tuple(
        n + 1 for n in before[:4]) + (before[4] + (4 if padded else 0),)
    assert out.shape == q.shape
    if not padded:
        assert out.stride() == q.stride()


@pytest.mark.cuda
def test_flash_attention_tc_copies_misaligned_views_on_card():
    """bf16 views whose row stride (68 elements, 136 bytes) is not a
    multiple of 16 bytes: the wrapper copies them, counts each copy, and
    the tensor-core kernels still agree with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(68)
    dev = torch.device("cuda")

    def make():
        t = rng.standard_normal((2, 3, 96, 68)).astype(np.float32)
        return torch.from_numpy(t).to(dev, torch.bfloat16)[..., :64]

    q, k, v, g = make(), make(), make(), make()
    before = _flash_counts(fa, "bfloat16")
    _flash_against_plain(fa, q, k, v, g, True,
                         {"out": (1e-2, 1e-2), "grads": (3e-2, 1e-2)})
    # q, k, v copied by the forward (the backward reads those copies and
    # the aligned o), dO by the backward
    assert _flash_counts(fa, "bfloat16") == tuple(
        n + 1 for n in before[:4]) + (before[4] + 4,)


@pytest.mark.cuda
def test_flash_attention_f32tc_copies_misaligned_views_on_card():
    """fp32 views whose row stride (66 floats, 264 bytes) is not a
    multiple of 16 bytes: the 3xTF32 forward's wrapper copies q, k and v
    and the backward's dO (4 copies counted; the backward reads the
    forward's copies and its aligned o), and both kernels still agree
    with the plain version. The backward called on misaligned q, k, v, o
    and dO copies all five and agrees with the plain version's
    autograd."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(66)

    def make():
        t = rng.standard_normal((2, 3, 96, 66)).astype(np.float32)
        return torch.from_numpy(t).cuda()[..., :64]

    q, k, v, g = make(), make(), make(), make()
    before = _flash_counts(fa, "float32")
    _flash_against_plain(fa, q, k, v, g, True,
                         {"out": (1e-4, 1e-4), "grads": (1e-4, 1e-4)})
    assert _flash_counts(fa, "float32") == tuple(
        n + 1 for n in before[:4]) + (before[4] + 4,)

    o = make()
    o.copy_(fa.flash_attention_reference(q, k, v, True))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        fa.flash_attention_reference(*leaves, causal=True), leaves, g)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 64 ** -0.5
    lse = torch.logsumexp(s.masked_fill(~torch.ones(
        96, 96, dtype=torch.bool, device="cuda").tril(), float("-inf")), -1)
    copies = fa.flash_attention_bwd.copies
    got = fa.flash_attention_bwd(q, k, v, o, lse.contiguous(), g, True,
                                 64 ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.copies == copies + 5
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.cpu().numpy(), w.cpu().numpy(),
                                   err_msg=name, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 7, 33])
@pytest.mark.parametrize("K,N", [(1, 1), (5, 3), (129, 129), (2048, 129),
                                 (129, 32000), (64, 4)])
def test_int8_matmul_kernel_matches_plain_on_card(M, K, N):
    """K4 against its plain version on the card, bitwise (fp32 bit
    patterns, so the sign of a zero counts): tails of M, N and K, w
    holding -128, a few activations past the int8 range, one that
    rounds to -0.0; also through a strided 3-D view of x."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import int8_matmul as im

    rng = np.random.RandomState(M * 1000 + K + N)
    dev = torch.device("cuda")
    x_np = (1.5 * rng.randn(M, 2, K)).astype(np.float32)
    x_np[0, :, 0] = -1e-4   # quantizes to -0.0: the sums must be +0
    base = torch.from_numpy(x_np).to(dev)
    w_np = rng.randint(-128, 128, size=(K, N)).astype(np.int8)
    w_np.flat[::7] = -128
    w = torch.from_numpy(w_np).to(dev)
    dq = torch.from_numpy(((rng.rand(N) + 0.1) * 3 / 127 ** 2)
                          .astype(np.float32)).to(dev)
    for x in (base[:, 0].contiguous(), base[:, 1:]):
        key = (M, K, N)
        launches = im.int8_matmul.launches.get(key, 0)
        got = im.int8_matmul(x, w, dq, 127.0 / 3.0)
        want = im.int8_matmul_reference(x, w, dq, 127.0 / 3.0)
        torch.cuda.synchronize()
        assert im.int8_matmul.launches[key] == launches + 1
        assert got.shape == want.shape == tuple(x.shape[:-1]) + (N,)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [127, 128, 129])
@pytest.mark.parametrize("K", [31, 32, 33, 127, 128, 129])
@pytest.mark.parametrize("N", [7, 8, 9, 127, 128, 129])
def test_int8_matmul_tile_edges_match_plain_on_card(M, K, N):
    """K4 bitwise against its plain version on the edges of the product's
    tiles: K one either side of the mma's k32 and of a 128-k stage, M one
    either side of a block's 128 rows, N either side of an n8 mma tile
    and of a block's 128 columns; x contiguous and a strided 3-D view."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import int8_matmul as im

    rng = np.random.RandomState(M * 1000 + K * 10 + N)
    dev = torch.device("cuda")
    base = torch.from_numpy((1.5 * rng.randn(M, 2, K)).astype(np.float32))
    base = base.to(dev)
    w_np = rng.randint(-128, 128, size=(K, N)).astype(np.int8)
    w_np.flat[::7] = -128
    w = torch.from_numpy(w_np).to(dev)
    dq = torch.from_numpy(((rng.rand(N) + 0.1) * 3 / 127 ** 2)
                          .astype(np.float32)).to(dev)
    for x in (base[:, 0].contiguous(), base[:, 1:]):
        got = im.int8_matmul(x, w, dq, 127.0 / 3.0)
        want = im.int8_matmul_reference(x, w, dq, 127.0 / 3.0)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_int8_matmul_wrapper_checks_on_card():
    """The wrapper refuses what the kernel does not take, naming it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import int8_matmul as im

    dev = torch.device("cuda")
    x = torch.zeros(4, 8, device=dev)
    w = torch.zeros(8, 6, dtype=torch.int8, device=dev)
    dq = torch.ones(6, device=dev)
    with pytest.raises(TypeError, match="w_int8 must be torch.int8"):
        im.int8_matmul(x, w.float(), dq, 1.0)
    with pytest.raises(TypeError, match="x must be torch.float32"):
        im.int8_matmul(x.half(), w, dq, 1.0)
    with pytest.raises(TypeError, match="dq_scale must be torch.float32"):
        im.int8_matmul(x, w, dq.double(), 1.0)
    with pytest.raises(ValueError, match="do not match"):
        im.int8_matmul(torch.zeros(4, 7, device=dev), w, dq, 1.0)
    with pytest.raises(ValueError, match="do not match"):
        im.int8_matmul(x, w, torch.ones(5, device=dev), 1.0)
    with pytest.raises(ValueError, match=r"x must be \[..., K\]"):
        im.int8_matmul(torch.zeros(8, device=dev), w, dq, 1.0)
    with pytest.raises(ValueError, match="dq_scale is on cpu"):
        im.int8_matmul(x, w, dq.cpu(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        im.int8_matmul(x, torch.zeros(6, 8, dtype=torch.int8,
                                      device=dev).t(), dq, 1.0)
    with pytest.raises(ValueError, match="exact only for K"):
        im.int8_matmul(torch.zeros(1, 1 << 17, device=dev),
                       torch.zeros(1 << 17, 1, dtype=torch.int8, device=dev),
                       torch.ones(1, device=dev), 1.0)


# ---------------------------------------------------------------------------
# on the card: an fp32 convolution is full fp32 whatever the TF32 switch
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_fp32_conv_ignores_the_tf32_switch_on_the_card():
    """The conv op's output and grads are bitwise the same with TF32 on
    and off (``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32``), forward and backward, and
    the switches are left as they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the TF32 switches are the card's")
    from paddle_tpu_torch.core.lowering import LoweringContext
    from paddle_tpu_torch.ops import registry

    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(8, 64, 28, 28).astype(np.float32)).cuda()
    w = torch.from_numpy(
        rng.randn(128, 64, 3, 3).astype(np.float32) * 0.05).cuda()
    g = torch.from_numpy(rng.randn(8, 128, 28, 28).astype(np.float32)).cuda()
    impl = registry.get("conv2d").impl
    attrs = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
             "groups": 1}
    switches = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = [m.allow_tf32 for m in switches]
    results = []
    try:
        for tf32 in (True, False):
            for m in switches:
                m.allow_tf32 = tf32
            xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
            out = impl(LoweringContext(x.device),
                       {"Input": [xl], "Filter": [wl]}, attrs)["Output"][0]
            results.append([out.detach()] + list(
                torch.autograd.grad(out, [xl, wl], g)))
            assert all(m.allow_tf32 is tf32 for m in switches)
    finally:
        for m, v in zip(switches, saved):
            m.allow_tf32 = v
    for a, b in zip(*results):
        assert torch.equal(a, b)
