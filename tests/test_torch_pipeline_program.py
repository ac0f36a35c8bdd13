"""The Fluid pipeline through the port's ``CompiledProgram.with_data_parallel``
(``BuildStrategy.pipeline_stages`` and its knobs,
``paddle_tpu_torch/parallel/pipeline_program.py`` and
``pipeline_schedule.py``) over gloo groups of 2 and 4 CPU ranks
(``torch_pp_workers`` on ``torch_dp_workers.pool``), held against the
JAX package:

(a) the schedule tables, ``stats()`` and the stash slot counts equal
JAX's ``build_schedule`` bitwise, and ``_validate`` raises on a corrupted
table; (b) ``split_sections``, ``assign_stages``, the crossing vars, the
param lists and the scalar fetches equal the JAX step's, name for name,
on each program of ``tests/test_pipeline_program.py`` built by each
package and on the headline program at full width, whose split,
crossings and schedules ``tests/data/pp_plan_headline.json`` (written
from the JAX package, read by ``chip_smoke.py`` phase 19a) holds; (c)
the pipelined trajectories against the JAX ``Executor.run`` trajectory
from the same numpy init, at the JAX tests' own limits (rtol 1e-5, atol
1e-6 for the MLPs; rtol 1e-4, atol 1e-5 for the LM with recompute
segments), the ranks' parameters bitwise equal; (d) the bf16 fetch rule,
pinned on the JAX package first; (e) the raises, in JAX's words; (f) the
counted P2P bytes against the prediction.
"""

import json
import os
import pathlib

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import paddle_tpu as jfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.parallel import pipeline_program as jpp
from paddle_tpu.parallel.pipeline_schedule import build_schedule as jsched

import torch_dp_workers as W
import torch_pp_workers as P
from torch_parity import assert_programs_equal
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (  # noqa: F401 (the autouse fixture)
    pin_jax_init_draw as _pin_jax_init_draw)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TABLE = ROOT / "tests" / "data" / "pp_plan_headline.json"
COLS = ("fwd_mb", "fwd_chunk", "fwd_read", "fwd_save", "fwd_recv",
        "bwd_mb", "bwd_chunk", "bwd_read", "cot_read", "cot_recv")
# phase 19's schedules (pp, M, v) and splits (pp, v, rows a microbatch:
# 160 / (dp · M))
HEADLINE_SCHEDULES = ((4, 8, 1), (2, 4, 1), (2, 4, 2))
HEADLINE_SPLITS = ((4, 1, 20), (2, 1, 20), (2, 2, 20), (2, 1, 40))


def _schedule_dict(s):
    return {"tables": {k: getattr(s, k).tolist() for k in COLS},
            "stats": s.stats(),
            "slots": [s.arrive_slots, s.input_slots, s.cot_slots]}


# ---------------------------------------------------------------------------
# (a) schedules
# ---------------------------------------------------------------------------

SPREAD = [(2, 1, 4), (2, 2, 4), (4, 1, 8), (4, 2, 8), (3, 2, 6), (4, 4, 16)]


@pytest.mark.parametrize("pp,v,M", SPREAD,
                         ids=["%d-%d-%d" % c for c in SPREAD])
def test_schedule_tables_equal_jax(pp, v, M):
    """(a) test_schedule_tables_validated's spread: every table int32
    for int32, the stats and the slot counts."""
    from paddle_tpu_torch.parallel.pipeline_schedule import build_schedule

    j, p = jsched(pp, M, v), build_schedule(pp, M, v)
    for k in COLS:
        assert getattr(p, k).dtype == np.int32
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k), k)
    assert p.stats() == j.stats()
    assert (p.arrive_slots, p.input_slots, p.cot_slots) == \
        (j.arrive_slots, j.input_slots, j.cot_slots)
    assert p.K == j.K and p.S == j.S


@pytest.mark.parametrize("pp,M,v", HEADLINE_SCHEDULES,
                         ids=["%d-%d-%d" % c for c in HEADLINE_SCHEDULES])
def test_headline_schedules_equal_jax_and_table(pp, M, v):
    """(a) phase 19's schedules: the port's equal JAX's and the table's
    (the bubble: 0.43 at (4, 8, 1), 0.33 at (2, 4, 1) and (2, 4, 2))."""
    from paddle_tpu_torch.parallel.pipeline_schedule import build_schedule

    table = json.loads(TABLE.read_text())["schedules"]["%d_%d_%d"
                                                      % (pp, M, v)]
    got = _schedule_dict(build_schedule(pp, M, v))
    assert got == _schedule_dict(jsched(pp, M, v))
    assert got == table
    assert abs(got["stats"]["bubble_fraction"]
               - {(4, 8, 1): 6 / 14, (2, 4, 1): 2 / 6,
                  (2, 4, 2): 4 / 12}[(pp, M, v)]) < 1e-12


@pytest.mark.parametrize("col,delta", [("fwd_read", 1), ("bwd_read", 1),
                                       ("fwd_mb", 1), ("cot_read", 1)])
def test_validate_raises_on_a_corrupted_table(col, delta):
    """(a) _validate rejects a table whose slot or unit was moved, as
    JAX's does."""
    from paddle_tpu_torch.parallel import pipeline_schedule as ps

    for mod, build in ((ps, ps.build_schedule), (None, jsched)):
        s = build(4, 8, 2)
        t = getattr(s, col)
        idx = tuple(np.argwhere(t >= 0)[len(np.argwhere(t >= 0)) // 2])
        t[idx] += delta
        validate = ps._validate if mod is not None else \
            __import__("paddle_tpu.parallel.pipeline_schedule",
                       fromlist=["_validate"])._validate
        with pytest.raises(AssertionError):
            validate(s)


# ---------------------------------------------------------------------------
# (b) analysis
# ---------------------------------------------------------------------------


def _jax_mesh(pp, tp):
    devs = np.array(jax.devices())
    names = ("dp", "pp") + (("tp",) if tp > 1 else ())
    shape = (len(devs) // (pp * tp), pp) + ((tp,) if tp > 1 else ())
    return Mesh(devs.reshape(shape), axis_names=names)


def _steps(fluid_pair, strategy, fetch=None):
    """(JAX step, port step) of the same program under `strategy`:
    `fluid_pair` (JAX program, port program, JAX loss, port loss)."""
    from paddle_tpu_torch.parallel.pipeline_program import \
        PipelineProgramStep

    jmain, pmain, jloss, ploss, feeds = fluid_pair
    pp = strategy.get("pipeline_stages", 1)
    tp = strategy.get("tensor_parallel_degree", 1)
    jstep = jpp.PipelineProgramStep(
        jmain, feeds, [jloss.name] + list(fetch or ()), _jax_mesh(pp, tp),
        P.strategy_of(jfluid, strategy), jloss.name)
    shape = {"dp": 8 // (pp * tp), "pp": pp, "tp": tp}
    pstep = PipelineProgramStep(
        pmain, {n: (16, 16) for n in feeds},
        [ploss.name] + list(fetch or ()), shape,
        P.strategy_of(__import__("paddle_tpu_torch"), strategy),
        ploss.name)
    return jstep, pstep


def _pair(name, **kw):
    import paddle_tpu_torch as pfluid

    jmain, _, jloss = P.build(jfluid, name, **kw)
    pmain, _, ploss = P.build(pfluid, name, **kw)
    feeds = sorted(v.name for v in pmain.global_block().vars.values()
                   if getattr(v, "is_data", False))
    return jmain, pmain, jloss, ploss, feeds


def _same_analysis(j, p):
    jf, jpost = jpp.split_sections(j.block)
    from paddle_tpu_torch.parallel.pipeline_program import split_sections

    pf, ppost = split_sections(p.block)
    assert [o.type for o in pf] == [o.type for o in jf]
    assert [o.type for o in ppost] == [o.type for o in jpost]
    assert p.stage_of == j.stage_of
    assert p.crossing == j.crossing
    assert p.produced_at == j.produced_at
    assert p.dparam_names == j.dparam_names
    assert p.cparam_names == j.cparam_names
    assert p.grad_of == j.grad_of
    assert p.scalar_names == j.scalar_names
    assert (p.loss_idx, p.loss_stage) == (j.loss_idx, j.loss_stage)
    assert (p.M, p.v, p.S, p.stash_activations) == \
        (j.M, j.v, j.S, j.stash_activations)
    assert sorted(p.mut_names) == sorted(j.mut_names)
    assert sorted(p.const_names) == sorted(j.const_names)
    assert p.state_out == j.state_out
    assert p._plan.summary() == {n: tuple(s) for n, s in
                                 j._plan.summary().items()}


ANALYSIS = [
    ("mlp", {}, {"pipeline_stages": 2, "pipeline_microbatches": 4}, None),
    ("mlp", {"opt": "adam"}, {"pipeline_stages": 2, "pipeline_microbatches": 2,
                              "tensor_parallel_degree": 2, "reduce": True},
     None),
    ("annotated", {}, {"pipeline_stages": 4}, None),
    ("lm", {}, {"pipeline_stages": 2, "pipeline_microbatches": 2,
                "tensor_parallel_degree": 2}, None),
    ("metric", {}, {"pipeline_stages": 2, "pipeline_microbatches": 4},
     ["mae"]),
    ("mlp", {"width": 24, "depth": 4},
     {"pipeline_stages": 2, "pipeline_microbatches": 4,
      "pipeline_virtual_stages": 2}, None),
    ("mlp", {"width": 24, "depth": 4},
     {"pipeline_stages": 2, "pipeline_microbatches": 4,
      "pipeline_virtual_stages": 2, "pipeline_activation_stash": True},
     None),
    ("lm", {"remat": False, "opt": "sgd", "dtype": "bfloat16", "amp": True},
     {"pipeline_stages": 4, "pipeline_microbatches": 4}, None),
]


@pytest.mark.parametrize("name,kw,strategy,fetch", ANALYSIS,
                         ids=["mlp", "mlp_tp_reduce", "annotated", "lm_tp",
                              "metric", "mlp_v2", "mlp_v2_stash",
                              "lm_bf16_pp4"])
def test_analysis_equals_jax(name, kw, strategy, fetch):
    """(b) each program of tests/test_pipeline_program.py, built by each
    package: the sections, the stage split, the crossings, the params,
    the scalar fetches and the plan, name for name."""
    pair = _pair(name, **kw)
    names = P.fetch_names(pair[0], pair[2], fetch)[1:]
    jstep, pstep = _steps(pair, strategy, names)
    _same_analysis(jstep, pstep)


def headline(fluid, cfg=None):
    """bench.py's headline program (bench.build_program: bf16-stored
    params, remat off, the legacy AMP decorator over SGD(0.01), the
    compile-pipeline receipt) at full width or at the widths `cfg`,
    under a fresh name scope."""
    from importlib import import_module

    cfg = dict(cfg or {"seq_len": 512})
    tf = import_module(fluid.__name__ + ".models.transformer_fluid")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = tf.build(remat=False, dtype="bfloat16", **cfg)
        fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.SGD(0.01), init_loss_scaling=1.0,
            use_dynamic_loss_scaling=False).minimize(loss)
        c = fluid.layers.scale(
            fluid.layers.fill_constant([1], "float32", 1.5), scale=0.5)
        d1 = fluid.layers.scale(loss, scale=3.0)
        d2 = fluid.layers.scale(loss, scale=3.0)
        fluid.layers.elementwise_add(fluid.layers.elementwise_add(d1, d2), c)
    return main, loss


def jax_split_table(main, loss, pp, v, rows, seq):
    """The JAX step's split of a headline program at (pp, v): the stage
    of every forward op, each cut's crossing vars, its wire as the JAX
    step probes it (`_probe_layouts`: each var's shape and dtype at a
    microbatch of `rows` rows of `seq` tokens) and its (forward,
    cotangent) bytes a microbatch, the cotangent's the floating vars
    with a grad var."""
    step = jpp.PipelineProgramStep(
        main, ["labels", "tokens"], [loss.name], _jax_mesh(pp, 1),
        P.strategy_of(jfluid, {"pipeline_stages": pp,
                               "pipeline_microbatches": 4,
                               "pipeline_virtual_stages": v}), loss.name)
    block = main.global_block()

    def struct(n):
        var = block._find_var_recursive(n)
        return jax.ShapeDtypeStruct(tuple(var.shape),
                                    jfluid.framework.dtype_to_np(var.dtype))

    feeds = {n: jax.ShapeDtypeStruct((rows, seq), np.int32)
             for n in ("labels", "tokens")}
    layouts = step._probe_layouts(
        {n: struct(n) for n in step.dparam_names},
        {n: struct(n) for n in step.cparam_names}, feeds)
    wires, cut_bytes = [], []
    for names, lay in zip(step.crossing, layouts):
        ent = {n: (list(sh), np.dtype(dt).name) for n, sh, dt in
               lay.fent + lay.ient}
        wire = [[n] + list(ent[n]) for n in names]
        f = b = 0
        for n, shape, dt in wire:
            nb = int(np.prod(shape)) * np.dtype(
                jfluid.framework.dtype_to_np(dt)).itemsize
            f += nb
            if dt in ("float16", "bfloat16", "float32", "float64") \
                    and block._find_var_recursive(n + "@GRAD") is not None:
                b += nb
        wires.append(wire)
        cut_bytes.append([f, b])
    return {"pp": pp, "v": v, "stage_of": list(step.stage_of),
            "crossing": step.crossing, "wire": wires,
            "cut_bytes": cut_bytes}


def jax_headline_table(cfg=None, splits=HEADLINE_SPLITS):
    """The table phase 19 reads, from the JAX package: the headline
    program's split at each of `splits` (pp, v, rows: phase 19's) with
    its wires at a microbatch of that many rows (full width, or the
    widths `cfg`), and phase 19's schedules."""
    main, loss = headline(jfluid, cfg)
    seq = (cfg or {"seq_len": 512})["seq_len"]
    out = {"splits": {}, "schedules": {}}
    for pp, v, rows in splits:
        out["splits"]["pp%d_v%d_r%d" % (pp, v, rows)] = jax_split_table(
            main, loss, pp, v, rows, seq)
    for pp, M, v in HEADLINE_SCHEDULES:
        out["schedules"]["%d_%d_%d" % (pp, M, v)] = \
            _schedule_dict(jsched(pp, M, v))
    return out


def test_headline_table_written_from_jax():
    """(b) the committed table is what the JAX package gives. A missing
    or stale table fails; ``PTPU_WRITE_PP_TABLE=1 python -m pytest
    tests/test_torch_pipeline_program.py -k table_written`` (re)writes
    it from the JAX package first."""
    want = json.loads(json.dumps(jax_headline_table()))
    if os.environ.get("PTPU_WRITE_PP_TABLE") == "1":
        TABLE.write_text(json.dumps(want, indent=1, sort_keys=True) + "\n")
    assert TABLE.exists(), "%s is missing" % TABLE
    assert json.loads(TABLE.read_text()) == want


@pytest.mark.parametrize("pp,v,rows", HEADLINE_SPLITS,
                         ids=["pp%d_v%d_r%d" % c for c in HEADLINE_SPLITS])
def test_headline_split_equals_table(pp, v, rows):
    """(b) the port's split of the headline program at full width: the
    stage of every forward op and the crossing vars of every cut equal
    the table's, and each wire var's elements are its declared shape's
    at a microbatch's rows (phase 19 holds the port's wires, dtypes
    too, to the table); the headline program built here is
    bench.build_program's."""
    import paddle_tpu_torch as pfluid
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.parallel.pipeline_program import \
        PipelineProgramStep

    table = json.loads(TABLE.read_text())["splits"][
        "pp%d_v%d_r%d" % (pp, v, rows)]
    main, loss = headline(pfluid)
    with pfluid.unique_name.guard():
        bmain = bench.build_program(512, "bfloat16", "legacy")[0]
    assert_programs_equal(main, bmain)
    step = PipelineProgramStep(
        main, {"labels": (160, 512), "tokens": (160, 512)}, [loss.name],
        {"dp": 1, "pp": pp, "tp": 1},
        P.strategy_of(pfluid, {"pipeline_stages": pp,
                               "pipeline_microbatches": 4,
                               "pipeline_virtual_stages": v}), loss.name)
    assert step.stage_of == table["stage_of"]
    assert step.crossing == table["crossing"]
    block = main.global_block()
    for wire in table["wire"]:
        for name, shape, _ in wire:
            declared = [rows if d < 0 else d
                        for d in block._find_var_recursive(name).shape]
            assert np.prod(shape) == np.prod(declared), name
    # every layer's attention lies whole in one stage
    fmha = [s for op, s in zip(step.fwd_ops, step.stage_of)
            if op.type == "fused_multihead_attention"]
    assert len(fmha) == 6 and fmha == sorted(fmha)


# ---------------------------------------------------------------------------
# (c) trajectories against the JAX Executor.run trajectory
# ---------------------------------------------------------------------------

_JAX_RUNS = {}


def jax_trajectory(name, feed, steps, build_kw=None, fetch=None):
    """The JAX package's Executor.run from its startup init: (init,
    [fetches a step], persistables after); each run once a process."""
    key = (name, steps, repr(sorted((build_kw or {}).items())),
           repr(fetch), tuple((k, v.tobytes()) for k, v in
                              sorted(feed.items())))
    if key not in _JAX_RUNS:
        main, startup, loss = P.build(jfluid, name, **(build_kw or {}))
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in main.global_block().vars.values()
                       if v.persistable and scope.get(v.name) is not None)
        init = {n: np.array(scope.get(n), copy=True) for n in names}
        fetches = P.fetch_names(main, loss, fetch)
        outs = [[np.asarray(f, np.float32).reshape(-1) for f in
                 exe.run(main, feed=feed, fetch_list=fetches, scope=scope)]
                for _ in range(steps)]
        after = {n: np.asarray(scope.get(n)).astype(np.float32)
                 for n in names}
        _JAX_RUNS[key] = init, outs, after
    return _JAX_RUNS[key]


def ok(results):
    for r in results:
        assert "error" not in r, r["error"]
    return results


def same_on_every_rank(results):
    first = results[0]
    for r in results[1:]:
        for n, v in first["params"].items():
            np.testing.assert_array_equal(r["params"][n], v, err_msg=n)
        for a, b in zip(r["fetches"], first["fetches"]):
            for (_, x), (_, y) in zip(a, b):
                np.testing.assert_array_equal(x, y)


def p2p_as_predicted(results, steps):
    """(f) each rank's counted pp_fwd / pp_bwd bytes: its stages' cuts ×
    M a step, from the layouts the run learnt; the exchanges counted
    once a call under pp_p2p, with the two directions' bytes."""
    for r in results:
        f, b = r["expected_p2p"]
        c = r["counts"]
        assert (c["pp_fwd_bytes"], c["pp_bwd_bytes"]) == \
            (steps * f, steps * b)
        assert c["pp_p2p_bytes"] == c["pp_fwd_bytes"] + c["pp_bwd_bytes"]
        assert c["pp_p2p"] >= max(c["pp_fwd"], c["pp_bwd"]) > 0
    total_f = sum(r["counts"]["pp_fwd_bytes"] for r in results)
    total_b = sum(r["counts"]["pp_bwd_bytes"] for r in results)
    assert total_f > 0 and total_b > 0


TRAJ = [
    (2, "mlp", {}, {"pipeline_stages": 2, "pipeline_microbatches": 4},
     (1e-5, 1e-6)),
    (4, "mlp", {}, {"pipeline_stages": 2, "pipeline_microbatches": 4},
     (1e-5, 1e-6)),
    (4, "annotated", {}, {"pipeline_stages": 4}, (1e-5, 1e-6)),
    (4, "lm", {}, {"pipeline_stages": 2, "pipeline_microbatches": 2,
                   "tensor_parallel_degree": 2}, (1e-4, 1e-5)),
    (4, "mlp", {"opt": "adam"}, {"pipeline_stages": 2,
                                 "pipeline_microbatches": 2,
                                 "reduce": True}, (1e-4, 1e-5)),
    (2, "mlp", {"width": 24, "depth": 4},
     {"pipeline_stages": 2, "pipeline_microbatches": 4,
      "pipeline_virtual_stages": 2}, (1e-5, 1e-6)),
    (2, "mlp", {"width": 24, "depth": 3},
     {"pipeline_stages": 2, "pipeline_microbatches": 4,
      "pipeline_activation_stash": True}, (1e-5, 1e-6)),
    (2, "mlp", {"width": 24, "depth": 4},
     {"pipeline_stages": 2, "pipeline_microbatches": 4,
      "pipeline_virtual_stages": 2, "pipeline_activation_stash": True},
     (1e-5, 1e-6)),
    (4, "mlp", {"width": 24, "depth": 4},
     {"pipeline_stages": 2, "pipeline_microbatches": 4,
      "pipeline_virtual_stages": 2, "tensor_parallel_degree": 2},
     (1e-4, 1e-5)),
]


def _feed_of(name):
    return {"mlp": P.mlp_feed, "annotated": P.annotated_feed,
            "lm": P.lm_feed, "metric": lambda: P.mlp_feed("sm")}[name]()


@pytest.mark.parametrize(
    "world,name,kw,strategy,tol", TRAJ,
    ids=["pp2_w2", "dp2_pp2", "pp4_annotated", "pp2_tp2_lm_adam",
         "dp2_pp2_reduce_adam", "v2", "stash", "v2_stash", "v2_tp2"])
def test_trajectory_matches_jax(world, name, kw, strategy, tol):
    """(c) 3 steps from the JAX startup init: the losses and every
    parameter within the JAX test's limits of the JAX Executor.run
    trajectory on the global batch; every rank's fetches and parameters
    bitwise equal; (f) the P2P bytes as predicted; the units a rank
    runs, M a stage each way."""
    rtol, atol = tol
    feed, steps = _feed_of(name), 3
    init, jl, jafter = jax_trajectory(name, feed, steps, kw)
    res = ok(W.pool(world).run(
        "torch_pp_workers:train", name=name, init=W.pack(init), feed=feed,
        steps=steps, strategy=strategy, build_kw=kw))
    same_on_every_rank(res)
    np.testing.assert_allclose(
        [f[0][1][0] for f in res[0]["fetches"]], [j[0][0] for j in jl],
        rtol=rtol, atol=atol)
    for n, want in jafter.items():
        if n in res[0]["params"] and want.dtype.kind == "f":
            np.testing.assert_allclose(res[0]["params"][n], want,
                                       rtol=rtol, atol=atol, err_msg=n)
    p2p_as_predicted(res, steps)
    pp = strategy["pipeline_stages"]
    v = strategy.get("pipeline_virtual_stages", 1)
    M = strategy.get("pipeline_microbatches", pp)
    for r in res:
        assert r["units"] == {"fwd": M * v, "bwd": M * v}
    if name == "lm":
        assert any("tp" in str(s) for s in res[0]["summary"].values())
    if strategy.get("reduce"):
        assert res[0]["zero"]


@pytest.mark.parametrize("world,strategy", [
    (2, {"pipeline_stages": 2, "pipeline_microbatches": 2}),
    (4, {"pipeline_stages": 2, "pipeline_microbatches": 4,
         "pipeline_virtual_stages": 2})], ids=["pp2", "dp2_pp2_v2"])
def test_dropout_masks_repeat_in_the_recomputed_forward(world, strategy):
    """The LM with dropout: the backward unit's recomputed forward draws
    the forward unit's masks, so the run without the stash equals the
    run with it bitwise (fetches and parameters)."""
    import paddle_tpu_torch as pfluid

    kw = {"remat": False, "opt": "sgd", "dropout": 0.1}
    main, startup, _ = P.build(pfluid, "lm", **kw)
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(startup, scope=scope)
    init = W.pack({n: W._host(scope.get(n)) for n in scope.local_var_names()
                   if hasattr(scope.get(n), "clone")})
    feed = P.lm_feed(rows=8)
    runs = [ok(W.pool(world).run(
        "torch_pp_workers:train", name="lm", init=init, feed=feed, steps=2,
        build_kw=kw, strategy=dict(strategy,
                                   pipeline_activation_stash=stash)))
        for stash in (False, True)]
    for a, b in zip(*runs):
        for (_, x), (_, y) in zip(sum(a["fetches"], []),
                                  sum(b["fetches"], [])):
            np.testing.assert_array_equal(x, y)
        for n, v in a["params"].items():
            np.testing.assert_array_equal(v, b["params"][n], err_msg=n)
    same_on_every_rank(runs[0])


def test_microbatch_streams_draw_their_own_masks():
    """A stateful op's generator mixes in the pipeline's microbatch
    stream: the same stream draws the same values, another stream (or
    none, outside the pipeline) others."""
    import torch

    from paddle_tpu_torch.core.lowering import LoweringContext

    def draw(stream):
        ctx = LoweringContext("cpu", seed=7, step=3)
        ctx.stream = stream
        return torch.rand(64, generator=ctx.generator({"__op_seed__": 5}))

    assert torch.equal(draw(1), draw(1))
    assert not torch.equal(draw(0), draw(1))
    assert not torch.equal(draw(None), draw(0))


def test_scalar_metric_fetch_matches_jax():
    """(c) a scalar metric fetched beside the loss: each the mean of its
    microbatch values, both within rtol 1e-5 of Executor.run's."""
    feed = _feed_of("metric")
    init, jl, _ = jax_trajectory("metric", feed, 2, fetch=["mae"])
    res = ok(W.pool(2).run(
        "torch_pp_workers:train", name="metric", init=W.pack(init),
        feed=feed, steps=2, fetch=["mae"],
        strategy={"pipeline_stages": 2, "pipeline_microbatches": 4}))
    same_on_every_rank(res)
    for got, want in zip(res[0]["fetches"], jl):
        np.testing.assert_allclose([got[0][1][0], got[1][1][0]],
                                   [want[0][0], want[1][0]], rtol=1e-5)
    assert len(res[0]["scalars"]) == 2


# ---------------------------------------------------------------------------
# (d) the bf16 fetch rule
# ---------------------------------------------------------------------------


def _bf16(x):
    import ml_dtypes

    return float(np.float32(x).astype(ml_dtypes.bfloat16))


def _rule(values):
    """The pipelined fetch of a bf16-declared scalar: the mean of the
    microbatches' values (as each stage computed it, in fp32), cast to
    bf16."""
    return _bf16(np.float32(sum(float(v) for v in values)) / len(values))


def test_jax_bf16_fetch_rule():
    """(d) the JAX package's pipelined step (pp 2, M 2 on the 8-device
    mesh: dp 4, eight microbatches of 2 rows) fetches a bf16-declared
    loss as a bfloat16 array holding the mean of the eight microbatch
    losses (each bf16, as Executor.run fetches it on those rows) cast to
    bf16, which is not the whole batch's bf16 loss."""
    main, startup, loss = P.build(jfluid, "bf16")
    feed = P.bf16_feed()
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    exe.run(startup, scope=scope)
    mbs = []
    for r in range(0, 16, 2):
        v, = exe.run(main, feed={"bf_x": feed["bf_x"][r:r + 2]},
                     fetch_list=[loss], scope=scope)
        assert np.asarray(v).dtype.name == "bfloat16"
        mbs.append(float(np.asarray(v, np.float32).ravel()[0]))
    whole, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    bs = jfluid.BuildStrategy()
    bs.pipeline_stages = 2
    bs.pipeline_microbatches = 2
    prog = jfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs)
    got, = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    assert np.asarray(got).dtype.name == "bfloat16"
    got = float(np.asarray(got, np.float32).ravel()[0])
    assert got == _rule(mbs)
    assert got != float(np.asarray(whole, np.float32).ravel()[0])


@pytest.mark.parametrize("world,strategy", [
    (2, {"pipeline_stages": 2, "pipeline_microbatches": 2}),
    (4, {"pipeline_stages": 2, "pipeline_microbatches": 2})],
    ids=["pp2", "dp2_pp2"])
def test_port_bf16_fetch_rule(world, strategy):
    """(d) the port's pipelined fetch of the same bf16 loss, at its own
    world: a bfloat16 tensor holding the JAX rule's value over its own
    microbatches (the port's Executor.run on each one's rows), not the
    whole batch's."""
    import paddle_tpu_torch as pfluid

    main, startup, loss = P.build(pfluid, "bf16")
    feed = P.bf16_feed()
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(startup, scope=scope)
    n = (world // strategy["pipeline_stages"]) \
        * strategy["pipeline_microbatches"]
    rows = 16 // n
    mbs = [float(exe.run(main, feed={"bf_x": feed["bf_x"][r:r + rows]},
                         fetch_list=[loss], scope=scope)[0].ravel()[0])
           for r in range(0, 16, rows)]
    whole = float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0].ravel()[0])
    res = ok(W.pool(world).run("torch_pp_workers:train", name="bf16",
                               init={}, feed=feed, steps=1,
                               strategy=strategy))
    for r in res:
        dtype, val = r["fetches"][0][0]
        assert dtype == "torch.bfloat16"
        assert float(val[0]) == _rule(mbs) != whole


# ---------------------------------------------------------------------------
# (e) the raises
# ---------------------------------------------------------------------------


def _jax_raise(name, feed, strategy, fetch=None, no_loss=False):
    """The message the JAX package's pipelined run raises."""
    main, startup, loss = P.build(jfluid, name)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    exe.run(startup, scope=scope)
    prog = jfluid.CompiledProgram(main).with_data_parallel(
        loss_name=None if no_loss else loss.name,
        build_strategy=P.strategy_of(jfluid, strategy))
    fetches = [loss.name]
    if fetch == "relu":
        fetches = [next(op.output_names()[0] for op in
                        main.global_block().ops if op.type == "relu")]
    try:
        exe.run(prog, feed=feed, fetch_list=fetches, scope=scope)
    except Exception as e:  # noqa: BLE001 (the message is the result)
        return "%s: %s" % (type(e).__name__, e)
    return None


PP2 = {"pipeline_stages": 2}
RAISES = [
    ("no_loss", "mlp", P.mlp_feed(), PP2, {"no_loss": True}),
    ("no_backward", "forward_only",
     {"fo_x": np.zeros((8, 16), np.float32)}, PP2, {}),
    ("microbatches", "mlp", P.mlp_feed(),
     {"pipeline_stages": 2, "pipeline_microbatches": 1}, {}),
    ("batch", "mlp", P.mlp_feed(batch=15),
     {"pipeline_stages": 2, "pipeline_microbatches": 2}, {}),
    ("stamps_v2", "annotated", P.annotated_feed(),
     {"pipeline_stages": 2, "pipeline_virtual_stages": 2}, {}),
    ("persistable", "bn", {"bn_x": np.zeros((8, 8), np.float32),
                           "bn_y": np.zeros((8, 1), np.float32)}, PP2, {}),
    ("inplace", "inplace", {"ip_x": np.zeros((8, 8), np.float32),
                            "ip_y": np.zeros((8, 1), np.float32)}, PP2, {}),
    ("non_scalar_fetch", "mlp", P.mlp_feed(), PP2, {"fetch": "relu"}),
    ("post_read", "post_read", {"pr_x": np.zeros((8, 16), np.float32),
                                "pr_y": np.zeros((8, 1), np.float32)},
     PP2, {}),
    ("stage_range", "annotated", P.annotated_feed(), PP2, {}),
]


@pytest.mark.parametrize("case,name,feed,strategy,kw", RAISES,
                         ids=[r[0] for r in RAISES])
def test_raises_in_jax_words(case, name, feed, strategy, kw):
    """(e) each raise of the JAX step, type and words equal."""
    want = _jax_raise(name, feed, strategy, **kw)
    assert want is not None
    if case == "batch":
        # dp·M: 4 · 2 on the JAX package's 8 devices, 1 · 2 here
        want = want.replace("microbatches = 8", "microbatches = 2")
    got = W.pool(2).run("torch_pp_workers:raises", name=name, feed=feed,
                        strategy=strategy, **kw)
    assert got[0] == got[1] == want


def test_check_nan_inf_raises_in_jax_words():
    """(e) FLAGS_check_nan_inf (the environment's spelling in the port,
    set_flags in the JAX package)."""
    from paddle_tpu import flags

    flags.set_flags({"FLAGS_check_nan_inf": True})
    try:
        want = _jax_raise("mlp", P.mlp_feed(), PP2)
    finally:
        flags.set_flags({"FLAGS_check_nan_inf": False})
    got = W.pool(2).run("torch_pp_workers:raises", name="mlp",
                        feed=P.mlp_feed(), strategy=PP2,
                        env={"FLAGS_check_nan_inf": "1"})
    assert got[0] == got[1] == want
    assert "FLAGS_check_nan_inf" in want


def test_sequence_parallel_still_raises_naming_item_9():
    """(e) sequence_parallel_degree, alone or with pp, still raises."""
    from paddle_tpu_torch.compiler import BuildStrategy, check_build_strategy

    for pp in (1, 2):
        bs = BuildStrategy()
        bs.sequence_parallel_degree = 2
        bs.pipeline_stages = pp
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md Queue 1 item 9"):
            check_build_strategy(bs)


def test_world_pp_tp_must_divide():
    """(e) a world that pp·tp does not divide raises in JAX's words."""
    got = W.pool(2).run("torch_pp_workers:raises", name="mlp",
                        feed=P.mlp_feed(),
                        strategy={"pipeline_stages": 2,
                                  "tensor_parallel_degree": 2})
    assert got[0] == got[1] == (
        "ValueError: pipeline_stages * tensor_parallel_degree = 2 * 2 "
        "does not divide the 2-device mesh")


def test_pipeline_stage_stamps_like_jax():
    """pipeline_stage(i) stamps the ops appended in its scope, nested
    scopes restore the outer stamp, and an op keeps a stamp it has."""
    import paddle_tpu_torch as pfluid

    for fluid in (jfluid, pfluid):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            with fluid.pipeline_stage(1):
                h = fluid.layers.fc(x, 4)
                with fluid.pipeline_stage(2):
                    h = fluid.layers.relu(h)
                h = fluid.layers.scale(h, 2.0)
                main.global_block().append_op(
                    "scale", {"X": [h]}, {"Out": [h]},
                    {"scale": 1.0, "__pipeline_stage__": 5})
            fluid.layers.mean(h)
        stamps = [op.attrs.get("__pipeline_stage__")
                  for op in main.global_block().ops]
        assert stamps == [1, 1, 2, 1, 5, None], (fluid.__name__, stamps)
