"""Rank cases for the port's Fluid pipeline tests
(``tests/test_torch_pipeline_program.py``,
``tests/test_torch_chip_smoke_pp.py``), run on the gloo groups of
``torch_dp_workers.pool`` as ``pool.run("torch_pp_workers:<case>", ...)``.

The builders take the Fluid module (``paddle_tpu`` or
``paddle_tpu_torch``), so a test builds the same program in both
packages: the programs of ``tests/test_pipeline_program.py`` (the MLP,
the annotated 4-stage chain, the scalar metric, the LM with recompute
segments) and a bf16-declared loss whose microbatch values round.
"""

import importlib

import numpy as np

from torch_dp_workers import _host, _tensor
from torch_tp_workers import strategy_of  # noqa: F401 (the tests' import)

# ---------------------------------------------------------------------------
# programs (either package)
# ---------------------------------------------------------------------------


def build_mlp(fluid, prefix="pp", width=32, depth=3, opt="sgd"):
    """test_pipeline_program's `_mlp` under SGD(0.1) or Adam(0.01)."""
    L = fluid.layers
    x = L.data(name=prefix + "_x", shape=[16], dtype="float32")
    y = L.data(name=prefix + "_y", shape=[1], dtype="float32")
    h = x
    for _ in range(depth):
        h = L.fc(h, width, act="relu")
    pred = L.fc(h, 1)
    loss = L.mean(L.square_error_cost(pred, y))
    o = fluid.optimizer.Adam(learning_rate=0.01) if opt == "adam" \
        else fluid.optimizer.SGD(learning_rate=0.1)
    o.minimize(loss)
    return loss


def mlp_feed(prefix="pp", batch=16, seed=0):
    rng = np.random.RandomState(seed)
    return {prefix + "_x": rng.randn(batch, 16).astype(np.float32),
            prefix + "_y": rng.randn(batch, 1).astype(np.float32)}


def build_annotated(fluid):
    """test_pipeline_stage_annotation's chain: one fc a stage, 4 stages."""
    L = fluid.layers
    x = L.data(name="an_x", shape=[16], dtype="float32")
    y = L.data(name="an_y", shape=[1], dtype="float32")
    with fluid.pipeline_stage(0):
        h = L.fc(x, 32, act="relu")
    with fluid.pipeline_stage(1):
        h = L.fc(h, 32, act="relu")
    with fluid.pipeline_stage(2):
        h = L.fc(h, 32, act="relu")
    with fluid.pipeline_stage(3):
        pred = L.fc(h, 1)
        loss = L.mean(L.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def annotated_feed():
    return {"an_x": np.random.RandomState(1).randn(16, 16).astype(np.float32),
            "an_y": np.random.RandomState(2).randn(16, 1).astype(np.float32)}


def build_metric(fluid):
    """test_pp_scalar_metric_fetch's program: the loss and a mean
    absolute error fetched beside it."""
    L = fluid.layers
    x = L.data(name="sm_x", shape=[16], dtype="float32")
    y = L.data(name="sm_y", shape=[1], dtype="float32")
    h = L.fc(x, 32, act="relu")
    pred = L.fc(h, 1)
    loss = L.mean(L.square_error_cost(pred, y))
    L.reduce_mean(L.abs(L.elementwise_sub(pred, y)))
    fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return loss


LM = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          seq_len=16)


def build_lm(fluid, remat=True, opt="adam", dtype="float32", amp=False,
             dropout=0.0):
    """test_pp_transformer_tp_parity's LM (vocab 64, d 32, 4 heads, 2
    layers, d_ff 64, seq 16, recompute segments) under Adam(1e-3), or
    SGD(0.01) under the headline's legacy AMP decorator; `dropout` its
    dropout rate."""
    tf = importlib.import_module(fluid.__name__
                                 + ".models.transformer_fluid")
    _, _, loss = tf.build(remat=remat, dtype=dtype, dropout_rate=dropout,
                          **LM)
    o = fluid.optimizer.Adam(learning_rate=1e-3) if opt == "adam" \
        else fluid.optimizer.SGD(0.01)
    if amp:
        o = fluid.contrib.mixed_precision.decorate(
            o, init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
    o.minimize(loss)
    return loss


def lm_feed(seed=0, rows=8):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, 64, size=(rows, 16)).astype(np.int32),
            "labels": rng.randint(0, 64, size=(rows, 16)).astype(np.int32)}


def build_bf16(fluid):
    """A loss declared bfloat16: the mean of a fp32 fc over integer
    features with weights of 0.25, cast to bf16. Each microbatch's mean
    is a multiple of 1/8 in [16, 64), where bf16 keeps steps of 1/8 to
    1/4, so the microbatch values round."""
    L = fluid.layers
    x = L.data(name="bf_x", shape=[4], dtype="float32")
    h = L.fc(x, 1, param_attr=fluid.ParamAttr(
        name="bf_w", initializer=fluid.initializer.Constant(0.25)),
        bias_attr=False)
    loss = L.cast(L.mean(h), "bfloat16")
    fluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
    return loss


def bf16_feed(rows=16, seed=39):
    rng = np.random.RandomState(seed)
    return {"bf_x": rng.randint(16, 64, size=(rows, 4)).astype(np.float32)}


def build_post_read(fluid):
    """An optimizer-section op that reads a non-scalar activation."""
    L = fluid.layers
    x = L.data(name="pr_x", shape=[16], dtype="float32")
    y = L.data(name="pr_y", shape=[1], dtype="float32")
    h = L.fc(x, 8, act="relu")
    pred = L.fc(h, 1)
    loss = L.mean(L.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    L.scale(h, scale=2.0)
    return loss


def build_inplace(fluid):
    """test_pp_rejects_cross_stage_inplace_rewrite's program."""
    L = fluid.layers
    x = L.data(name="ip_x", shape=[8], dtype="float32")
    y = L.data(name="ip_y", shape=[1], dtype="float32")
    with fluid.pipeline_stage(0):
        h = L.fc(x, 16, act="relu")
    with fluid.pipeline_stage(1):
        L.increment(h, in_place=True)
        pred = L.fc(h, 1)
        loss = L.mean(L.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def build_bn(fluid):
    """test_pp_rejects_nonscalar_fetch_and_bn's batch_norm program."""
    L = fluid.layers
    img = L.data(name="bn_x", shape=[8], dtype="float32")
    yb = L.data(name="bn_y", shape=[1], dtype="float32")
    h = L.fc(img, 16)
    h = L.batch_norm(h)
    pred = L.fc(h, 1)
    loss = L.mean(L.square_error_cost(pred, yb))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def build_forward_only(fluid):
    """A program with no backward."""
    L = fluid.layers
    x = L.data(name="fo_x", shape=[16], dtype="float32")
    return L.mean(L.fc(x, 4))


BUILDERS = {"mlp": build_mlp, "annotated": build_annotated,
            "metric": build_metric, "lm": build_lm, "bf16": build_bf16,
            "post_read": build_post_read, "inplace": build_inplace,
            "bn": build_bn, "forward_only": build_forward_only}


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


def fetch_names(main, loss, fetch):
    """The fetch list: the loss, then each of `fetch` ("mae": the
    metric program's reduce_mean output; any other a var name)."""
    out = [loss.name]
    for f in fetch or ():
        if f == "mae":
            f = next(op.output_names()[0] for op in main.global_block().ops
                     if op.type == "reduce_mean")
        out.append(f)
    return out


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------


def train(name, init, feed, steps=2, build_kw=None, strategy=None,
          fetch=None):
    """Build `name` in the port, load `init`, run `steps` steps of
    CompiledProgram.with_data_parallel under `strategy` (pipeline_stages
    and the rest) on the global batch `feed`. Returns every step's
    fetches, every persistable whole after the run
    (``compiler.gather_persistables``), the P2P counts, and the step's
    analysis, wire bytes, predictions and units."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.compiler import gather_persistables
    from paddle_tpu_torch.parallel import collective

    main, startup, loss = build(fluid, name, **(build_kw or {}))
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    exe.run(startup, scope=scope)
    for n, item in init.items():
        old = scope.get(n)
        if old is not None:
            scope.set(n, _tensor(item).to(old.dtype).reshape(old.shape))
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=strategy_of(fluid, strategy))
    fetches = fetch_names(main, loss, fetch)
    collective.reset_counts()
    outs = []
    for _ in range(steps):
        got = exe.run(prog, feed=feed, fetch_list=fetches, scope=scope,
                      return_numpy=False)
        outs.append([(str(t.dtype), _host(t).reshape(-1)) for t in got])
    counts = {k: v for k, v in collective.counts.items()
              if k.startswith("pp_") or k.startswith("psum")}
    step = next(iter(prog._compiled_steps.values()))
    names = [v.name for v in main.global_block().vars.values()
             if v.persistable and isinstance(scope.get(v.name),
                                             torch.Tensor)]
    whole = gather_persistables(scope)
    wires = step.wire_bytes()
    return {
        "fetches": outs, "counts": counts,
        "stage_of": list(step.stage_of), "crossing": step.crossing,
        "dparams": step.dparam_names, "cparams": step.cparam_names,
        "scalars": step.scalar_names, "wires": wires,
        "expected_p2p": step.expected_p2p(wires),
        "units": dict(step.units), "summary": step._plan.summary(),
        "layout": dict(step.layout), "zero": sorted(step.zero),
        "params": {n: _host(whole.get(n, scope.get(n))) for n in names}}


def raises(name, feed, strategy=None, fetch=None, env=None, no_loss=False):
    """The message a pipelined run of `name` raises, or None: `fetch`
    the fetch list (default the loss; "relu" the first relu's output),
    `env` set around the run, `no_loss` with no loss_name."""
    import os

    import paddle_tpu_torch as fluid

    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        main, startup, loss = build(fluid, name)
        exe, scope = fluid.Executor("cpu"), fluid.Scope()
        exe.run(startup, scope=scope)
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=None if no_loss else loss.name,
            build_strategy=strategy_of(fluid, strategy))
        fetches = [loss.name]
        if fetch == "relu":
            fetches = [next(op.output_names()[0]
                            for op in main.global_block().ops
                            if op.type == "relu")]
        exe.run(prog, feed=feed, fetch_list=fetches, scope=scope)
    except Exception as e:  # noqa: BLE001 (the message is the result)
        return "%s: %s" % (type(e).__name__, e)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return None


def smoke_pp(fault=None, **kw):
    """chip_smoke.pp_rank_legs on this rank's CPU (`kw` its arguments),
    with `fault` planted (``chip_smoke.pp_fault``)."""
    import importlib.util

    from torch_dp_workers import ROOT

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_pp_leg", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    undo = mod.pp_fault(fault) if fault else None
    try:
        return mod.pp_rank_legs(device="cpu", **kw)
    finally:
        if undo is not None:
            undo()
