"""The port's ZeRO ladder (``paddle_tpu_torch/parallel/zero.py``'s
ShardedAdam, ``amp``'s bucket helpers, ``async_engine.HostStateStager``)
held against the JAX package's on the CPU: the JAX ``ShardedAdam`` on a
mesh of the first n CPU devices, the port's on gloo groups of n ranks
(``torch_zero_workers`` on ``torch_dp_workers.pool``; each world one
pool, every rung of a world in one call), n = 2 and 4, and on a line of
one rank in this process.

Limits against JAX, from the same arrays, 3 steps of Adam at lr 1e-2:
the losses to rtol 1e-6 (bf16 wire 1e-5); the parameters and the gathered m and v to
atol 1e-6, rtol 1e-5 (bf16 wire: test_zero.py's atol 1e-3, rtol 1e-2
for the parameters). The JAX step reduces n copies of one global grad,
the port the ranks' grads of their own rows, so the grads agree to fp32
rounding, not bit for bit; Adam's update divides by sqrt(v), so a grad's
last-bit change moves an element by well under 1e-6 here. Within the
port: the elementwise problem bitwise across every path, the matmul
problem bitwise across the bucketed rungs and overlap on/off, the
offload checkpoint resume bitwise at worlds 1 and 2.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import test_zero as TZ
from paddle_tpu import amp as jamp
from paddle_tpu.models import transformer as JT
from paddle_tpu.parallel import ShardedAdam as JShardedAdam

import torch
import torch_dp_workers as W
import torch_zero_workers as Z
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.parallel import ShardedAdam, ZeroLayoutError
from paddle_tpu_torch.parallel.mesh import Mesh as PMesh
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

TINY = TZ._TINY_MB
ARRAYS = {"ew_w": TZ._EW_W, "ew_b": TZ._EW_B, "ew_x": TZ._EW_X,
          "ew_y": TZ._EW_Y, "mm_w": TZ._MM_W, "mm_b": TZ._MM_B,
          "mm_x": TZ._MM_X, "mm_y": TZ._MM_Y}
# name: ShardedAdam keywords (the same for both packages; grad_dtype by name)
RUNGS = {
    "per_leaf": {},
    "bucketed": {"bucket_mb": TINY},
    "bucketed_overlap": {"bucket_mb": TINY, "overlap": True},
    "zero2_overlap": {"bucket_mb": TINY, "zero_stage": 2, "overlap": True},
    "zero2_1mb": {"bucket_mb": 1, "zero_stage": 2},
    "zero3": {"bucket_mb": TINY, "zero_stage": 3},
    "zero3_overlap": {"bucket_mb": TINY, "zero_stage": 3, "overlap": True},
    "offload": {"bucket_mb": TINY, "offload": True},
    "zero3_offload_overlap": {"bucket_mb": TINY, "zero_stage": 3,
                              "offload": True, "overlap": True},
    "zero2_bf16": {"bucket_mb": 1, "zero_stage": 2, "overlap": True,
                   "grad_dtype": "bfloat16"},
}
BITWISE_MM = ("bucketed", "bucketed_overlap", "zero2_overlap", "zero3",
              "zero3_overlap", "offload", "zero3_offload_overlap")
ATOL, RTOL = 1e-6, 1e-5
BF16_ATOL, BF16_RTOL = 1e-3, 1e-2
# a bf16 wire rounds each rank's grad (the port) or the global grad (JAX)
# to 8 bits before the sum: the steps' losses then agree to ~2e-6
BF16_LOSS_RTOL = 1e-5
WORLDS = (2, 4)


def _jax_kw(kw):
    kw = dict(kw)
    if kw.get("grad_dtype") == "bfloat16":
        kw["grad_dtype"] = jnp.bfloat16
    return kw


def jax_run(kw, problem, n, steps=3):
    """test_zero's `_run` on a mesh of the first n CPU devices: (params,
    losses, global state as numpy lists in the plan's order, plan)."""
    fresh, loss_fn, x, y = problem()
    mesh = Mesh(np.array(jax.devices()[:n]), ["dp"])
    opt = JShardedAdam(learning_rate=1e-2, axis_name="dp", **_jax_kw(kw))
    p = fresh()
    st = opt.init_state(p, mesh)
    zero3 = opt._plan["stage"] == 3
    if zero3:
        p = opt.shard_params(p, mesh)
    step = opt.make_step(mesh, loss_fn)
    losses = []
    for _ in range(steps):
        p, st, loss = step(p, st, x, y)
        losses.append(float(loss))
    if zero3:
        p = opt.gather_params(p)
    if getattr(step, "close", None):
        step.close()
    plan = None
    if opt._layout is not None:
        plan = [{"indices": list(b.indices), "offsets": list(b.offsets),
                 "sizes": list(b.sizes), "size": b.size,
                 "padded": b.padded, "segment": b.segment,
                 "dtype": str(np.dtype(b.dtype))}
                for b in opt._layout]
    state = {k: [np.asarray(a, np.float32) for a in jax.tree.leaves(st[k])]
             for k in ("m", "v")}
    return ({k: np.asarray(v) for k, v in p.items()}, losses, state, plan)


@pytest.fixture(scope="module")
def port():
    """Every rung on both problems at each world: {n: rank results}."""
    out = {}
    for n in WORLDS:
        res = W.pool(n).run("torch_zero_workers:ladder", arrays=ARRAYS,
                            rungs=RUNGS)
        for r in res:
            assert "error" not in r, r["error"]
        out[n] = res
    return out


@pytest.fixture(scope="module")
def jax_ref():
    return {(n, prob, name): jax_run(kw, getattr(TZ, "_%s_problem" % prob),
                                     n)
            for n in WORLDS for prob in ("ew", "mm")
            for name, kw in RUNGS.items()}


# ---------------------------------------------------------------------------
# the bucket helpers against JAX's, no processes
# ---------------------------------------------------------------------------


def _fields(buckets):
    return [(list(b.indices), list(b.offsets), list(b.sizes), b.size,
             b.padded, b.segment) for b in buckets]


@pytest.mark.parametrize("order", ["forward", "backward"])
@pytest.mark.parametrize("cap,pad", [(64, 1), (100, 4), (1 << 20, 8),
                                     (300, 3)])
def test_plan_buckets_matches_jax(order, cap, pad):
    rng = np.random.RandomState(1)
    shapes = [(5, 3), (7,), (2, 2), (40,), (3, 3, 3), ()]
    leaves = [np.asarray(rng.randn(*s), np.float32) for s in shapes]
    j = jamp.plan_buckets([jnp.asarray(x) for x in leaves], cap,
                          pad_multiple=pad, order=order)
    p = pamp.plan_buckets([torch.from_numpy(np.array(x)) for x in leaves],
                          cap, pad_multiple=pad, order=order)
    assert _fields(p) == _fields(j)
    # a forced collective dtype: bf16 halves the bytes, so more fits
    jb = jamp.plan_buckets([jnp.asarray(x) for x in leaves], cap,
                           pad_multiple=pad, dtype=jnp.bfloat16, order=order)
    pb = pamp.plan_buckets([torch.from_numpy(np.array(x)) for x in leaves],
                           cap, pad_multiple=pad, dtype=torch.bfloat16,
                           order=order)
    assert _fields(pb) == _fields(jb)
    assert all(b.dtype == torch.bfloat16 for b in pb)
    assert [b.nbytes() for b in pb] == [b.nbytes() for b in jb]


def test_plan_buckets_groups_by_dtype_like_jax():
    leaves = [np.zeros((4,), np.float32), np.zeros((6,), np.float16),
              np.zeros((4,), np.float32), np.zeros((2,), np.float16)]
    j = jamp.plan_buckets([jnp.asarray(x) for x in leaves], 1 << 10,
                          pad_multiple=4)
    p = pamp.plan_buckets([torch.from_numpy(x) for x in leaves], 1 << 10,
                          pad_multiple=4)
    assert _fields(p) == _fields(j)
    assert [str(b.dtype) for b in p] == ["torch.float32", "torch.float16"]


def test_bucket_telemetry():
    obs_metrics.enable()
    try:
        reg = obs_metrics.registry()
        base = reg.counter("amp/buckets").value
        bs = pamp.plan_buckets([torch.zeros(5), torch.zeros(70)], 64,
                               pad_multiple=4)
        assert reg.counter("amp/buckets").value == base + len(bs) == base + 2
        assert reg.gauge("amp/bucket_bytes").value == (8 + 72) * 4
    finally:
        obs_metrics.disable()


def test_bucket_size_validation():
    """test_zero.py's test_bucket_size_validation on the port."""
    with pytest.raises(ValueError):
        pamp.mb_to_bucket_bytes(float("nan"))
    with pytest.raises(ValueError):
        pamp.mb_to_bucket_bytes(-1)
    assert pamp.mb_to_bucket_bytes(0) is None
    assert pamp.mb_to_bucket_bytes(0.5) == jamp.mb_to_bucket_bytes(0.5)
    leaves = [torch.zeros(8)]
    for bad in (0, -4, float("nan"), None):
        with pytest.raises(ValueError, match="positive capacity"):
            pamp.plan_buckets(leaves, bad)
    with pytest.raises(ValueError, match="unknown order"):
        pamp.plan_buckets(leaves, 64, order="sideways")


def test_bucket_env_validation(monkeypatch):
    """test_zero.py's test_bucket_env_validation on the port."""
    monkeypatch.setenv("PTPU_AMP_BUCKET_MB", "nan")
    with pytest.raises(ValueError, match="PTPU_AMP_BUCKET_MB"):
        pamp.bucket_bytes_from_env()
    monkeypatch.setenv("PTPU_AMP_BUCKET_MB", "-2")
    with pytest.raises(ValueError, match="PTPU_AMP_BUCKET_MB"):
        pamp.bucket_bytes_from_env()
    monkeypatch.setenv("PTPU_AMP_BUCKET_MB", "lots")
    with pytest.raises(ValueError, match="PTPU_AMP_BUCKET_MB"):
        pamp.bucket_bytes_from_env()
    monkeypatch.setenv("PTPU_AMP_BUCKET_MB", "0")
    assert pamp.bucket_bytes_from_env(default_mb=4) is None
    monkeypatch.setenv("PTPU_AMP_BUCKET_MB", "2")
    assert pamp.bucket_bytes_from_env() == 2 << 20
    monkeypatch.delenv("PTPU_AMP_BUCKET_MB")
    assert pamp.bucket_bytes_from_env() == jamp.bucket_bytes_from_env()
    assert pamp.bucket_bytes_from_env(default_mb=None) is None


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_flatten_unflatten_roundtrip_matches_jax(dtype):
    """test_zero.py's test_backward_order_bucket_roundtrip, each flat
    buffer equal to JAX's (each leaf at its offset, cast, the pad
    zeroed)."""
    rng = np.random.RandomState(0)
    arrs = [rng.randn(5, 3).astype(np.float32),
            rng.randn(7).astype(np.float32),
            rng.randn(2, 2).astype(np.float32)]
    jl = [jnp.asarray(a) for a in arrs]
    pl = [torch.from_numpy(a.copy()) for a in arrs]
    jdt = jnp.bfloat16 if dtype else None
    pdt = torch.bfloat16 if dtype else None
    jb = jamp.plan_buckets(jl, 48, pad_multiple=8, order="backward",
                           dtype=jdt)
    pb = pamp.plan_buckets(pl, 48, pad_multiple=8, order="backward",
                           dtype=pdt)
    assert pb[0].indices[0] == 2
    got = {}
    for j, p in zip(jb, pb):
        pflat = pamp.flatten_bucket(p, pl)
        jflat = np.asarray(jamp.flatten_bucket(j, jl), np.float32)
        assert pflat.shape == (p.padded,)
        np.testing.assert_array_equal(pflat.float().numpy(), jflat)
        assert not pflat[p.size:].any()
        got.update(pamp.unflatten_bucket(p, pflat.float(), pl))
    for i, leaf in enumerate(pl):
        if dtype is None:
            np.testing.assert_array_equal(got[i].numpy(), leaf.numpy())
        else:
            np.testing.assert_array_equal(
                got[i].numpy(), leaf.to(torch.bfloat16).float().numpy())
    # a missing leaf (no grad) flattens as zeros; fp32 override
    flat = pamp.flatten_bucket(pb[0], [None] * 3, dtype=torch.float32)
    assert flat.dtype == torch.float32 and not flat.any()


def test_flagship_leaf_order_matches_jax():
    """The flagship tree's leaves in the port's order (ShardedAdam's,
    ``transformer.tree_leaves``'s) are the JAX tree's leaves in
    jax.tree.flatten's order: path for path, shape for shape."""
    from paddle_tpu_torch.parallel.zero import _flatten

    for tie in (True, False):
        jc = JT.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                  n_layers=2, d_ff=64, max_seq_len=16,
                                  dtype=jnp.float32, tie_embeddings=tie)
        jp = JT.init_params(jax.random.PRNGKey(0), jc)
        paths = [tuple(k.key for k in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(jp)[0]]
        pp = PT.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

        def walk(tree, prefix=()):
            if isinstance(tree, dict):
                return [x for k in sorted(tree)
                        for x in walk(tree[k], prefix + (k,))]
            return [prefix]

        assert walk(pp) == paths
        leaves = _flatten(pp)[0]
        assert [tuple(x.shape) for x in leaves] == \
            [tuple(x.shape) for x in jax.tree.leaves(jp)]
        assert all(a is b for a, b in zip(leaves, PT.tree_leaves(pp)))
        assert ("lm_head",) in paths or tie


# ---------------------------------------------------------------------------
# the ladder against the JAX ShardedAdam, worlds 2 and 4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("prob", ["ew", "mm"])
def test_ladder_matches_jax(port, jax_ref, n, prob):
    for name, kw in RUNGS.items():
        jp, jl, jst, jplan = jax_ref[(n, prob, name)]
        res = port[n][0][prob][name]
        msg = "%s %s n=%d" % (prob, name, n)
        assert res["plan"] == jplan, msg
        bf16 = kw.get("grad_dtype") == "bfloat16"
        np.testing.assert_allclose(res["losses"], jl,
                                   rtol=BF16_LOSS_RTOL if bf16 else 1e-6,
                                   err_msg=msg)
        atol, rtol = (BF16_ATOL, BF16_RTOL) if bf16 else (ATOL, RTOL)
        for k in jp:
            np.testing.assert_allclose(res["params"][k], jp[k], atol=atol,
                                       rtol=rtol, err_msg=msg + " " + k)
        if bf16:
            continue
        for key in ("m", "v"):
            assert len(res[key]) == len(jst[key]), msg
            for a, b in zip(res[key], jst[key]):
                assert a.shape == b.shape, msg
                np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                           err_msg=msg + " " + key)
        assert res["step"] == 3


@pytest.mark.parametrize("n", WORLDS)
def test_ranks_agree_and_hold_a_shard(port, n):
    """Every rank returns the same loss and the same (gathered) params
    and state; a rank holds 1/n of the padded state."""
    for prob in ("ew", "mm"):
        for name in RUNGS:
            ranks = [r[prob][name] for r in port[n]]
            for x in ranks[1:]:
                assert x["losses"] == ranks[0]["losses"], (prob, name)
                for k in x["params"]:
                    np.testing.assert_array_equal(x["params"][k],
                                                  ranks[0]["params"][k])
            total = sum(a.nbytes for a in ranks[0]["m"] + ranks[0]["v"])
            assert all(n * x["state_bytes"] == total for x in ranks), \
                (prob, name)


@pytest.mark.parametrize("n", WORLDS)
def test_port_bitwise_within(port, n):
    """The elementwise problem bitwise across every path (params,
    losses); the matmul problem bitwise across the bucketed rungs,
    overlap on/off included, with their state."""
    ew = port[n][0]["ew"]
    for name, kw in RUNGS.items():
        if kw.get("grad_dtype"):
            continue
        for k in ew["per_leaf"]["params"]:
            np.testing.assert_array_equal(ew[name]["params"][k],
                                          ew["per_leaf"]["params"][k],
                                          err_msg=name)
        np.testing.assert_allclose(ew[name]["losses"],
                                   ew["per_leaf"]["losses"], rtol=1e-6)
    mm = port[n][0]["mm"]
    base = mm["bucketed"]
    for name in BITWISE_MM:
        assert mm[name]["losses"] == base["losses"], name
        for k in base["params"]:
            np.testing.assert_array_equal(mm[name]["params"][k],
                                          base["params"][k], err_msg=name)
    # the state of rungs with one plan: every bucket the same
    for a, b in (("bucketed", "offload"),
                 ("bucketed_overlap", "zero2_overlap"),
                 ("zero2_overlap", "zero3_overlap"),
                 ("zero3_overlap", "zero3_offload_overlap")):
        assert mm[a]["plan"] == mm[b]["plan"]
        for key in ("m", "v"):
            for x, y in zip(mm[a][key], mm[b][key]):
                np.testing.assert_array_equal(x, y, err_msg=a + b + key)


@pytest.mark.parametrize("n", WORLDS)
def test_counted_collectives_follow_the_plan(port, n):
    """Per step: per-leaf L reduce-scatters and L gathers, bucketed B and
    B, ZeRO-3 B parameter gathers and B reduce-scatters with no
    gather-back; one loss all-reduce each (3 steps)."""
    for prob in ("ew", "mm"):
        for name, kw in RUNGS.items():
            res = port[n][0][prob][name]
            B = len(res["plan"]) if res["plan"] else 2   # 2 leaves
            zero3 = kw.get("zero_stage") == 3
            want = {"zero_reduce_scatter": 3 * B,
                    "zero_gather": 0 if zero3 else 3 * B,
                    "zero_param_gather": 3 * B if zero3 else 0,
                    "zero_loss": 3}
            assert res["counts"] == want, (prob, name, res["counts"])


@pytest.mark.parametrize("n", WORLDS)
def test_overlap_issues_in_segment_order(port, n):
    """test_zero.py's overlap receipts on the port: the backward-order
    plan (segment 0 starts at the last leaf), each step's collectives
    issued in segment order from the backward's hooks; without overlap
    the non-hooked path keeps no record."""
    for prob in ("ew", "mm"):
        res = port[n][0][prob]["bucketed_overlap"]
        plan = res["plan"]
        assert len(plan) >= 2
        assert plan[0]["indices"][0] == 1          # the last leaf, "w"
        assert sorted(i for b in plan for i in b["indices"]) == [0, 1]
        rec = res["record"]
        assert rec["segments"] == list(range(len(plan)))
        assert rec["hooks"] == 2
        assert port[n][0][prob]["bucketed"]["record"] is None
        assert port[n][0][prob]["zero2_1mb"]["record"]["segments"] == [0]


# ---------------------------------------------------------------------------
# the flagship at world 2
# ---------------------------------------------------------------------------

FLAGSHIP = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                max_seq_len=16)
FLAGSHIP_RUNGS = {"per_leaf": {},
                  "zero2_overlap": {"bucket_mb": 0.01, "zero_stage": 2,
                                    "overlap": True},
                  "zero3": {"bucket_mb": 0.01, "zero_stage": 3}}
# the flagship's losses and leaves against JAX after 2 steps at lr 1e-3:
# the fp32 forward sums in another order (einsums, the chunked CE), so
# the grads agree to ~1e-6 of their size; Adam turns that into element
# moves of lr times a ratio that a near-cancelling grad can flip, so the
# leaves are held to 1e-4 (a tenth of one step's move) and the losses to
# 1e-5
FLAGSHIP_LOSS_RTOL = 1e-5
FLAGSHIP_ATOL = 1e-4


def test_flagship_matches_jax():
    """JAX ShardedAdam on the JAX ``single_chip_loss`` (2 layers, d_model
    32, 2 heads, vocab 64, batch 8, seq 16, fp32) against the port's at
    world 2, from one init."""
    jc = JT.TransformerConfig(dtype=jnp.float32, **FLAGSHIP)
    jp = JT.init_params(jax.random.PRNGKey(0), jc)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 64, (8, 16)).astype(np.int32)
    labs = np.roll(toks, -1, axis=1)
    mesh = Mesh(np.array(jax.devices()[:2]), ["dp"])

    def loss_fn(p, tok, lab):
        return JT.single_chip_loss(p, tok, lab, jc)

    ref = {}
    for name, kw in FLAGSHIP_RUNGS.items():
        opt = JShardedAdam(learning_rate=1e-3, axis_name="dp", **kw)
        p = jax.tree.map(jnp.asarray, jp)
        st = opt.init_state(p, mesh)
        if kw.get("zero_stage") == 3:
            p = opt.shard_params(p, mesh)
        step = opt.make_step(mesh, loss_fn)
        losses = []
        for _ in range(2):
            p, st, loss = step(p, st, jnp.asarray(toks), jnp.asarray(labs))
            losses.append(float(loss))
        if kw.get("zero_stage") == 3:
            p = opt.gather_params(p)
        ref[name] = (losses, [np.asarray(x) for x in jax.tree.leaves(p)])
    res = W.pool(2).run(
        "torch_zero_workers:flagship",
        params=jax.tree.map(np.asarray, jp),
        cfg=dict(FLAGSHIP, dtype="float32"), tokens=toks, labels=labs,
        rungs=FLAGSHIP_RUNGS)
    for r in res:
        assert "error" not in r, r["error"]
    for name in FLAGSHIP_RUNGS:
        losses, leaves = ref[name]
        got = res[0][name]
        np.testing.assert_allclose(got["losses"], losses,
                                   rtol=FLAGSHIP_LOSS_RTOL, err_msg=name)
        assert got["losses"][1] < got["losses"][0]
        for i, want in enumerate(leaves):
            np.testing.assert_allclose(got["params"][str(i)], want,
                                       atol=FLAGSHIP_ATOL, err_msg=name)
        for k in got["params"]:
            np.testing.assert_array_equal(got["params"][k],
                                          res[1][name]["params"][k])
    # within the port: bitwise across the rungs on one rank
    for k in res[0]["per_leaf"]["params"]:
        np.testing.assert_array_equal(res[0]["zero3"]["params"][k],
                                      res[0]["zero2_overlap"]["params"][k])
    # the unused leaf (b2, no grad) did not hold back the overlap chain
    rec = res[0]["zero2_overlap"]["record"]
    assert rec["segments"] == list(range(len(rec["segments"])))
    assert sum(h > 0 for h in rec["hooks_after"]) >= len(rec["segments"]) - 1


# ---------------------------------------------------------------------------
# layout, validation, environment and metrics (test_zero.py :192-490) on a
# line of one rank in this process
# ---------------------------------------------------------------------------

_KW = dict(learning_rate=1e-2)


def _solo():
    return PMesh(Z.solo_group())


def _mm():
    return Z.problem("mm", ARRAYS)


def test_zero3_shard_gather_roundtrip_at_world_2():
    """Each rank holds 1/2 of every bucket; gather_params gives the tree
    back bitwise, in the leaves' dtypes."""
    res = W.pool(2).run("torch_zero_workers:roundtrip", arrays=ARRAYS)
    for r in res:
        assert "error" not in r, r["error"]
        assert all(2 * s == p for s, p in zip(r["shard"], r["padded"]))
        assert r["equal"] and r["dtypes"] == ["float32", "float32"]
    assert res[0]["first"] != res[1]["first"]   # different halves


def test_offload_state_lives_on_host():
    fresh, loss_fn, batch = Z.problem("ew", ARRAYS)
    opt = ShardedAdam(bucket_mb=TINY, offload=True, **_KW)
    _p, _l, st, step = Z.run(opt, fresh, loss_fn, batch, mesh=_solo())
    step.close()
    assert all(x.device.type == "cpu" for x in st["m"] + st["v"])
    assert st["step"].device.type == "cpu" and int(st["step"]) == 3


def test_overlap_ratio_gather_bytes_and_offload_bytes_metrics():
    obs_metrics.enable()
    try:
        reg = obs_metrics.registry()
        fresh, loss_fn, batch = _mm()
        mesh = _solo()
        opt = ShardedAdam(bucket_mb=TINY, zero_stage=3, overlap=True, **_KW)
        opt.init_state(fresh(), mesh)
        opt.make_step(mesh, loss_fn)
        nb = len(opt._layout)
        assert nb == 2
        assert reg.gauge("zero/overlap_ratio").value == (nb - 1) / nb
        assert reg.gauge("zero/gather_bytes").value == sum(
            b.padded * 4 for b in opt._layout)
        # a later overlap-off optimizer leaves the receipt alone
        opt2 = ShardedAdam(bucket_mb=TINY, **_KW)
        opt2.init_state(fresh(), mesh)
        opt2.make_step(mesh, loss_fn)
        assert reg.gauge("zero/overlap_ratio").value == (nb - 1) / nb
        base = reg.counter("zero/offload_bytes").value
        efresh, eloss, ebatch = Z.problem("ew", ARRAYS)
        opt3 = ShardedAdam(bucket_mb=TINY, offload=True, **_KW)
        _p, _l, _st, step = Z.run(opt3, efresh, eloss, ebatch, steps=1,
                                  mesh=mesh)
        step.close()
        # m and v in, then out: (4 + 64) floats each way, twice
        assert reg.counter("zero/offload_bytes").value - base == \
            2 * 2 * (4 + 64) * 4
    finally:
        obs_metrics.disable()


def test_make_step_requires_init_state_when_bucketed():
    opt = ShardedAdam(bucket_mb=1, **_KW)
    with pytest.raises(ZeroLayoutError):
        opt.make_step(_solo(), lambda p, x, y: 0.0)


def test_make_step_raises_on_changed_bucket_mb():
    fresh, loss_fn, _batch = _mm()
    mesh = _solo()
    opt = ShardedAdam(bucket_mb=1, **_KW)
    opt.init_state(fresh(), mesh)
    opt.bucket_mb = 2
    with pytest.raises(ZeroLayoutError, match="changed after init_state"):
        opt.make_step(mesh, loss_fn)


def test_make_step_raises_on_env_flip_after_init(monkeypatch):
    monkeypatch.delenv("PTPU_AMP_BUCKET_MB", raising=False)
    fresh, loss_fn, _batch = _mm()
    mesh = _solo()
    opt = ShardedAdam(**_KW)
    opt.init_state(fresh(), mesh)
    monkeypatch.setenv("PTPU_AMP_BUCKET_MB", "1")
    with pytest.raises(ZeroLayoutError, match="changed after init_state"):
        opt.make_step(mesh, loss_fn)


def test_zero23_overlap_offload_require_bucketing():
    fresh, _loss, _batch = _mm()
    for kw in ({"zero_stage": 2}, {"zero_stage": 3}, {"overlap": True},
               {"offload": True}):
        with pytest.raises(ValueError, match="requires gradient bucket"):
            ShardedAdam(**_KW, **kw).init_state(fresh(), _solo())


def test_env_knobs(monkeypatch):
    fresh, _loss, _batch = _mm()
    monkeypatch.setenv("PTPU_ZERO_STAGE", "2")
    monkeypatch.setenv("PTPU_ZERO_OVERLAP", "1")
    monkeypatch.setenv("PTPU_ZERO_OFFLOAD", "1")
    monkeypatch.setenv("PTPU_AMP_BUCKET_MB", "1")
    opt = ShardedAdam(**_KW)
    st = opt.init_state(fresh(), _solo())
    assert opt._plan["stage"] == 2 and opt._plan["overlap"]
    assert opt._plan["offload"] and st["m"][0].device.type == "cpu"
    assert opt._layout[0].indices[0] == 1         # backward order
    # the constructor's arguments win over the environment
    opt = ShardedAdam(zero_stage=1, overlap=False, offload=False, **_KW)
    assert opt._resolve_config()["stage"] == 1
    assert not opt._resolve_config()["overlap"]
    monkeypatch.setenv("PTPU_ZERO_STAGE", "seven")
    with pytest.raises(ValueError, match="PTPU_ZERO_STAGE"):
        ShardedAdam(**_KW)._resolve_config()
    for bad in ("4", "0"):
        monkeypatch.setenv("PTPU_ZERO_STAGE", bad)
        with pytest.raises(ValueError, match="zero_stage"):
            ShardedAdam(**_KW)._resolve_config()
    monkeypatch.setenv("PTPU_ZERO_STAGE", "1")
    monkeypatch.setenv("PTPU_ZERO_OVERLAP", "maybe")
    with pytest.raises(ValueError, match="PTPU_ZERO_OVERLAP"):
        ShardedAdam(**_KW)._resolve_config()
    for spelling, want in (("True", True), ("YES", True), ("No", False)):
        monkeypatch.setenv("PTPU_ZERO_OVERLAP", spelling)
        assert ShardedAdam(**_KW)._resolve_config()["overlap"] is want


def test_offload_step_survives_failed_call():
    """A step that fails mid-flight leaves the stager usable: the next
    calls run clean and match the never-failed run bitwise."""
    res = Z.failed_call(ARRAYS, group=Z.solo_group())
    for k in res["ref"]["params"]:
        np.testing.assert_array_equal(res["failed"]["params"][k],
                                      res["ref"]["params"][k])
    assert res["failed"]["losses"] == res["ref"]["losses"]


def test_offload_remake_step_keeps_first_callable_alive():
    fresh, loss_fn, batch = Z.problem("ew", ARRAYS)
    mesh = _solo()
    opt = ShardedAdam(bucket_mb=TINY, offload=True, **_KW)
    p = fresh()
    st = opt.init_state(p, mesh)
    s1 = opt.make_step(mesh, loss_fn)
    s2 = opt.make_step(mesh, loss_fn)
    p, st, _l = s1(p, st, *batch)
    p, st, _l = s2(p, st, *batch)
    s1.close()
    p, st, _l = s2(p, st, *batch)
    s2.close()
    assert int(st["step"]) == 3


def test_tied_and_checkpointed_leaves_fire_once():
    """The overlap hooks under the flagship's non-reentrant
    ``torch.utils.checkpoint`` remat and its tied embedding (read by the
    embedding and the head): one hook a leaf a step; b2, which the loss
    never reads, is skipped, not waited for."""
    cfg = PT.TransformerConfig(dtype="float32", remat=True, **FLAGSHIP)
    params = PT.init_params(cfg, device="cpu")
    n_leaves = len(PT.tree_leaves(params))
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, 64, (4, 16)).astype(np.int32))
    opt = ShardedAdam(bucket_mb=0.01, zero_stage=2, overlap=True, **_KW)
    mesh = _solo()
    st = opt.init_state(params, mesh)
    step = opt.make_step(mesh, lambda p, t, l: PT.single_chip_loss(
        p, t, l, cfg))
    for _ in range(2):
        params, st, _loss = step(params, st, toks, toks.roll(-1, 1))
        rec = step.issue_record
        assert rec["hooks"] == n_leaves - 1        # all but b2, once each
        assert rec["segments"] == list(range(len(opt._layout)))
        assert rec["hooks_after"][-1] == 0 and rec["hooks_after"][0] > 0


def test_offload_checkpoint_resume_bitwise_at_world_1(tmp_path):
    res = Z.offload_resume(ARRAYS, str(tmp_path), group=Z.solo_group())
    _check_resume(res)


def test_offload_checkpoint_resume_bitwise_at_world_2(tmp_path):
    res = W.pool(2).run("torch_zero_workers:offload_resume", arrays=ARRAYS,
                        directory=str(tmp_path))
    for r in res:
        assert "error" not in r, r["error"]
        _check_resume(r)
    assert sorted(os.listdir(tmp_path)) == ["rank_0", "rank_1"]


def _check_resume(res):
    """Saved at step 2 (a directory a rank, the manifest published),
    restored into a fresh optimizer, 2 more steps: bitwise the
    uninterrupted 4-step run."""
    assert res["held"]["manifest"] and res["held"]["step"] == 2
    assert set(res["held"]["m_device"]) == {"cpu"}
    for k in res["ref"]:
        np.testing.assert_array_equal(res["resumed"][k], res["ref"][k])
    assert res["losses"] == res["ref_losses"][2:]


# ---------------------------------------------------------------------------
# every rank issues in one order: a planted out-of-order issue fails
# ---------------------------------------------------------------------------

_ORDER_CHILD = textwrap.dedent('''
    import os, sys
    sys.path[:0] = [%(root)r, %(tests)r]
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from paddle_tpu_torch.parallel import zero
    from paddle_tpu_torch.parallel.mesh import init_data_group
    import torch_zero_workers as Z
    arrays = dict(np.load(%(arrays)r))
    init_data_group("cpu")
    if %(planted)r and int(os.environ["PADDLE_TRAINER_ID"]) == 1:
        # this rank issues its buckets in reverse segment order
        issue = zero._IssueChain._issue
        def finish(self):
            for k in reversed(range(self.next, len(self.layout))):
                issue(self, k)
            self.next = len(self.layout)
            for w in self.works:
                if w is not None:
                    w.wait()
            return self.out
        zero._IssueChain.finish = finish
    from paddle_tpu_torch.parallel import ShardedAdam
    fresh, loss_fn, batch = Z.problem("mm", arrays)
    opt = ShardedAdam(learning_rate=1e-2, bucket_mb=1e-4, zero_stage=2)
    _p, losses, _st, _s = Z.run(opt, fresh, loss_fn, batch)
    print("losses", losses, flush=True)
''')


def _order_run(tmp_path, planted, timeout=60):
    """Two gloo ranks in processes of their own; each killed at
    `timeout` s. Returns their exit codes (None: killed)."""
    path = str(tmp_path / "arrays.npz")
    np.savez(path, **ARRAYS)
    code = _ORDER_CHILD % {"root": str(W.ROOT), "tests": str(W.ROOT / "tests"),
                           "arrays": path, "planted": planted}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        env=dict(os.environ, PADDLE_TRAINER_ID=str(r), PADDLE_TRAINERS_NUM="2",
                 PADDLE_TRAINER_ENDPOINTS="127.0.0.1:%d" % port))
        for r in range(2)]
    codes = []
    for p in procs:
        try:
            p.communicate(timeout=timeout)
            codes.append(p.returncode)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            codes.append(None)
    return codes


def test_out_of_order_issue_fails_not_hangs(tmp_path):
    """Stage 2's buckets (b: 4 floats, w: 64) issued in reverse order on
    one rank: the ranks' reduce-scatters no longer pair, and the run
    fails within its own time limit instead of hanging the suite; the
    same run in segment order passes."""
    assert _order_run(tmp_path, planted=False) == [0, 0]
    codes = _order_run(tmp_path, planted=True, timeout=30)
    assert all(c != 0 for c in codes), codes
