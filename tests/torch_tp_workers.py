"""Rank cases for the port's tensor-parallel and ZeRO-1 tests
(``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_chip_smoke_tp.py``), run on the gloo groups of
``torch_dp_workers.pool`` as
``pool.run("torch_tp_workers:<case>", ...)``.

The builders take the Fluid module (``paddle_tpu`` or
``paddle_tpu_torch``), so a test builds the same program in both
packages: the planner tests' programs (``tests/test_sharding_planner.py``),
the graft entry's dp x tp x ZeRO-1 program
(``__graft_entry__._dryrun_fluid_data_parallel``), the small Fluid LM and
a column-sharded fc split into pieces.
"""

import importlib

import numpy as np

from torch_dp_workers import _host, _tensor

# ---------------------------------------------------------------------------
# programs (either package)
# ---------------------------------------------------------------------------


def build_mlp(fluid, prefix="tp", emb=False, annotate=None):
    """test_sharding_planner's `_mlp` under Adam(0.01); `annotate` sets a
    var's shard_spec after the build."""
    L = fluid.layers
    if emb:
        ids = L.data(name=prefix + "_ids", shape=[8], dtype="int64")
        h = L.embedding(ids, size=[64, 16],
                        param_attr=fluid.ParamAttr(name=prefix + "_emb"))
        h = L.reduce_mean(h, dim=1)
    else:
        h = L.data(name=prefix + "_x", shape=[16], dtype="float32")
    y = L.data(name=prefix + "_y", shape=[1], dtype="int64")
    for i in (1, 2):
        h = L.fc(h, size=32, act="relu",
                 param_attr=fluid.ParamAttr(name="%s_w%d" % (prefix, i)),
                 bias_attr=fluid.ParamAttr(name="%s_b%d" % (prefix, i)))
    pred = L.fc(h, size=4, act="softmax",
                param_attr=fluid.ParamAttr(name=prefix + "_w3"),
                bias_attr=fluid.ParamAttr(name=prefix + "_b3"))
    loss = L.mean(L.cross_entropy(input=pred, label=y))
    for name, spec in (annotate or {}).items():
        fluid.default_main_program().global_block().var(name).shard_spec = \
            tuple(spec)
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def mlp_feed(seed=0, rows=32):
    rng = np.random.RandomState(seed)
    return {"tp_y": rng.randint(0, 4, (rows, 1)).astype(np.int64),
            "tp_x": rng.rand(rows, 16).astype(np.float32)}


def build_annotated(fluid):
    """test_tp_embedding_and_explicit_annotation's program: an embedding
    and an fc annotated (None, "tp"), SGD(0.05)."""
    L = fluid.layers
    ids = L.data(name="e_ids", shape=[8], dtype="int64")
    y = L.data(name="e_y", shape=[1], dtype="int64")
    h = L.embedding(ids, size=[64, 16],
                    param_attr=fluid.ParamAttr(name="e_emb"))
    h = L.reduce_mean(h, dim=1)
    h = L.fc(h, size=32, act="relu",
             param_attr=fluid.ParamAttr(name="e_w1", shard_spec=(None, "tp")))
    pred = L.fc(h, size=4, act="softmax",
                param_attr=fluid.ParamAttr(name="e_w2"))
    loss = L.mean(L.cross_entropy(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return loss


def annotated_feed(seed=1, rows=32):
    rng = np.random.RandomState(seed)
    return {"e_ids": rng.randint(0, 64, (rows, 8)).astype(np.int64),
            "e_y": rng.randint(0, 4, (rows, 1)).astype(np.int64)}


def build_fit(fluid):
    """test_fit_truncates_rank_mismatched_specs' program."""
    L = fluid.layers
    x = L.data(name="rm_x", shape=[16], dtype="float32")
    h = L.fc(x, 32, param_attr=fluid.ParamAttr(
        name="rm_w", shard_spec=(None, "tp")),
        bias_attr=fluid.ParamAttr(name="rm_b", shard_spec=(None, "tp")))
    loss = L.mean(h)
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def build_noop(fluid):
    """test_tp_silent_noop_warns' program: no dim divides tp = 2."""
    L = fluid.layers
    x = L.data(name="nw_x", shape=[7], dtype="float32")
    loss = L.mean(L.fc(x, 5, act="relu"))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def build_conv(fluid):
    """test_conv_chain_auto_tp_parity's program: conv (column) + bn +
    relu + conv (row) + pool + fc, Adam(0.01)."""
    L = fluid.layers
    img = L.data(name="cv_img", shape=[4, 8, 8], dtype="float32")
    y = L.data(name="cv_y", shape=[1], dtype="int64")
    h = L.conv2d(img, num_filters=8, filter_size=3, padding=1)
    h = L.batch_norm(h)
    h = L.relu(h)
    h = L.conv2d(h, num_filters=8, filter_size=3, padding=1,
                 bias_attr=False)
    h = L.pool2d(h, pool_size=2, pool_type="max", pool_stride=2)
    h = L.reshape(h, shape=[0, 8 * 4 * 4])
    logits = L.fc(h, 4)
    loss = L.mean(L.softmax_with_cross_entropy(logits, y))
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def conv_feed(seed=0, rows=16):
    rng = np.random.RandomState(seed)
    return {"cv_img": rng.rand(rows, 4, 8, 8).astype(np.float32),
            "cv_y": rng.randint(0, 4, (rows, 1)).astype(np.int64)}


def build_graft(fluid, tp=2):
    """__graft_entry__._dryrun_fluid_data_parallel's program: a vocab
    embedding, an annotated column fc, a recompute segment and the CE
    head under Adam(0.01)."""
    L = fluid.layers
    ids = L.data(name="ids", shape=[8], dtype="int64")
    y = L.data(name="y", shape=[1], dtype="int64")
    emb = L.embedding(ids, size=[64, 16],
                      param_attr=fluid.ParamAttr(name="dr_emb"))
    x = L.reduce_mean(emb, dim=1)
    h = L.fc(x, 16 * tp, act="relu", param_attr=fluid.ParamAttr(
        name="dr_w1", shard_spec=(None, "tp")))

    def seg(t):
        return L.fc(t, 16, act="gelu",
                    param_attr=fluid.ParamAttr(name="dr_w2"))

    h = L.recompute(seg, h)
    logits = L.fc(h, 4, param_attr=fluid.ParamAttr(name="dr_w3"))
    loss = L.mean(L.softmax_with_cross_entropy(logits, y))
    fluid.optimizer.Adam(0.01).minimize(loss)
    return loss


def graft_feed(seed=0, rows=32):
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, 64, (rows, 8)).astype(np.int64),
            "y": rng.randint(0, 4, (rows, 1)).astype(np.int64)}


LM = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          seq_len=16)


def build_lm(fluid, remat=True, dtype="float32", opt="adam", amp=False):
    """test_fluid_transformer_tp_dp_mesh's LM (vocab 128, d 32, 4 heads,
    2 layers, d_ff 64, seq 16) under Adam(0.01), or SGD(0.01) with the
    headline's legacy AMP at a static loss scale of 1."""
    tf = importlib.import_module(fluid.__name__
                                 + ".models.transformer_fluid")
    _, _, loss = tf.build(remat=remat, dtype=dtype, **LM)
    o = fluid.optimizer.Adam(learning_rate=0.01) if opt == "adam" \
        else fluid.optimizer.SGD(0.01)
    if amp:
        o = fluid.contrib.mixed_precision.decorate(
            o, init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
    o.minimize(loss)
    return loss


def lm_feed(seed=5, rows=8):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, 128, (rows, 16)).astype(np.int32),
            "labels": rng.randint(0, 128, (rows, 16)).astype(np.int32)}


def build_split(fluid):
    """A column-sharded fc [16 -> 3·8] split into three pieces on its
    sharded axis, then a product of the pieces: a split that kept each
    rank's own columns as they lie would pair the wrong pieces."""
    L = fluid.layers
    x = L.data(name="sp_x", shape=[16], dtype="float32")
    qkv = L.fc(x, 24, param_attr=fluid.ParamAttr(
        name="sp_w", shard_spec=(None, "tp")), bias_attr=False)
    q, k, v = L.split(qkv, num_or_sections=3, dim=-1)
    out = L.elementwise_add(L.elementwise_mul(q, k), v)
    loss = L.mean(L.fc(out, 1, param_attr=fluid.ParamAttr(name="sp_o")))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def split_feed(seed=0, rows=8):
    rng = np.random.RandomState(seed)
    return {"sp_x": rng.randn(rows, 16).astype(np.float32)}


def build_edges(fluid):
    """A vocab-row embedding with a padding_idx, and a column-sharded
    head under the hard-label CE with ignored labels (-100), SGD(0.1)."""
    L = fluid.layers
    ids = L.data(name="pe_ids", shape=[8], dtype="int64")
    y = L.data(name="pe_y", shape=[1], dtype="int64")
    h = L.embedding(ids, size=[64, 16], padding_idx=3,
                    param_attr=fluid.ParamAttr(name="pe_emb"))
    logits = L.fc(L.reduce_mean(h, dim=1), 8, param_attr=fluid.ParamAttr(
        name="pe_w", shard_spec=(None, "tp")))
    loss = L.mean(L.softmax_with_cross_entropy(logits, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def edges_feed(seed=0, rows=16):
    """Ids with the padding id 3 in every row; a quarter of the labels
    ignored."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 64, (rows, 8)).astype(np.int64)
    ids[:, ::3] = 3
    y = rng.randint(0, 8, (rows, 1)).astype(np.int64)
    y[::4] = -100
    return {"pe_ids": ids, "pe_y": y}


BUILDERS = {"edges": build_edges, "mlp": build_mlp,
            "annotated": build_annotated, "fit": build_fit,
            "noop": build_noop, "conv": build_conv, "graft": build_graft,
            "lm": build_lm, "split": build_split}


def build(fluid, name, **kw):
    """(main, startup, loss) of builder `name` under a fresh name scope
    (the port's op seeds pinned as ``torch_dp_workers.build`` pins
    them)."""
    if fluid.__name__ == "paddle_tpu_torch":
        from paddle_tpu_torch import layer_helper

        layer_helper._op_seed_counter[0] = 1000
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = BUILDERS[name](fluid, **kw)
    return main, startup, loss


def strategy_of(fluid, strategy):
    """A BuildStrategy from {knob: value}; "reduce" True selects
    ReduceStrategy.Reduce."""
    bs = fluid.BuildStrategy()
    for k, v in (strategy or {}).items():
        if k == "reduce":
            bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce \
                if v else fluid.BuildStrategy.ReduceStrategy.AllReduce
        else:
            setattr(bs, k, v)
    return bs


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------


def _plant(fault):
    """Plant a known fault in this rank: 'local_split' (split keeps the
    rank's columns as they lie), 'no_enter' (a column-parallel product's
    replicated X enters without its grad's sum), 'ce_no_max' (the
    vocab-parallel CE without its MAX all-reduce) or 'whole_moments'
    (ZeRO-1 state left whole, its update on every row). Returns the
    undo."""
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.parallel import collective, planner

    if fault == "local_split":
        rule = registry.get("split").tp
        saved = rule.plan

        def local(top):
            top.outs["Out"] = [top.mark("X")] * len(top.op.outputs["Out"])
            return True
        rule.plan = local
        return lambda: setattr(rule, "plan", saved)
    if fault == "no_enter":
        saved = collective._EnterTp.backward

        def keep(ctx, g):
            return g, None
        collective._EnterTp.backward = staticmethod(keep)
        return lambda: setattr(collective._EnterTp, "backward", saved)
    if fault == "ce_no_max":
        saved = collective.reduce_tp

        def no_max(x, group, op="sum"):
            return x.clone() if op == "max" else saved(x, group, op)
        collective.reduce_tp = no_max
        return lambda: setattr(collective, "reduce_tp", saved)
    if fault == "whole_moments":
        saved = planner.state_layout

        def whole(*a, **k):
            layout, _ = saved(*a, **k)
            return layout, set()
        planner.state_layout = whole
        return lambda: setattr(planner, "state_layout", saved)
    raise ValueError(fault)


def train(name, init, feed, steps=2, build_kw=None, strategy=None,
          fault=None):
    """Build `name` in the port, load `init`, run `steps` steps of
    CompiledProgram.with_data_parallel under `strategy` on the global
    batch `feed`. Returns the losses, every persistable whole after the
    run (``compiler.gather_persistables``), the collective counts, the
    plan's predictions, its summary, seams and layout, and each
    persistable's shape and bytes as the rank holds it."""
    import warnings

    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.compiler import gather_persistables
    from paddle_tpu_torch.parallel import collective

    main, startup, loss = build(fluid, name, **(build_kw or {}))
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    exe.run(startup, scope=scope)
    for n, item in init.items():
        old = scope.get(n)
        scope.set(n, _tensor(item).to(old.dtype).reshape(old.shape))
    undo = _plant(fault) if fault else None
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=strategy_of(fluid, strategy))
    try:
        collective.reset_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outs = [exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
                    for _ in range(steps)]
        counts = dict(collective.counts)
    finally:
        if undo is not None:
            undo()
    step = next(iter(prog._compiled_steps.values()))
    names = [v.name for v in main.global_block().vars.values()
             if v.persistable and isinstance(scope.get(v.name),
                                             torch.Tensor)]
    whole = gather_persistables(scope)
    return {
        "losses": [np.asarray(o[0]).reshape(-1).copy() for o in outs],
        "counts": counts, "warnings": [str(w.message) for w in caught],
        "summary": step._plan.summary(), "seams": list(step.plan.seams),
        "layout": dict(step.layout), "zero": sorted(step.zero),
        "held_bytes": {n: scope.get(n).numel() * scope.get(n).element_size()
                       for n in names},
        "held_rows": {n: tuple(scope.get(n).shape) for n in names},
        "expected": None if step.plan.remat
        else step.expected_collectives(),
        "expected_tp": None if step.plan.remat else step.expected_tp(),
        "params": {n: _host(whole.get(n, scope.get(n))) for n in names}}


def raises(name, feed, strategy=None, then=None):
    """The message a sharded run of `name` raises, or None; `then`
    "save" (``io.save_persistables`` of the scope after one step) or
    "plain" (then a plain Executor.run on the scope)."""
    import tempfile

    import paddle_tpu_torch as fluid

    try:
        main, startup, loss = build(fluid, name)
        exe, scope = fluid.Executor("cpu"), fluid.Scope()
        exe.run(startup, scope=scope)
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=strategy_of(fluid, strategy))
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        if then == "save":
            with fluid.scope_guard(scope), tempfile.TemporaryDirectory() \
                    as d:
                fluid.io.save_persistables(exe, d, main_program=main)
        elif then == "plain":
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    except Exception as e:  # noqa: BLE001 (the message is the result)
        return "%s: %s" % (type(e).__name__, e)
    return None


def smoke_tp(fault=None, **kw):
    """chip_smoke.tp_rank_legs on this rank's CPU (`kw` its arguments),
    with `fault` planted (``_plant``)."""
    import importlib.util

    from torch_dp_workers import ROOT

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tp_leg", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    undo = _plant(fault) if fault else None
    try:
        return mod.tp_rank_legs(device="cpu", **kw)
    finally:
        if undo is not None:
            undo()
