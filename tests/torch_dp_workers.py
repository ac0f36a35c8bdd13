"""Gloo worker groups for the port's data-parallel tests.

`pool(world)` spawns `world` processes once per test process (cached;
closed at exit), each a rank of a gloo group brought up through the
fleet's env contract (``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` /
``PADDLE_TRAINER_ENDPOINTS``). `Pool.run(case, **kw)` runs the function
`case` of this module (or ``"module:function"`` of another) on every
rank and returns each rank's result in rank order; a rank that raises
returns ``{"error": <message>}``.

This module imports only the port, torch and numpy: the builders take
the Fluid module (``paddle_tpu`` or ``paddle_tpu_torch``) as an argument,
so a test builds the same program in both packages.
"""

import atexit
import importlib
import multiprocessing as mp
import os
import pathlib
import socket
import sys
import traceback

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]

LM = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
          seq_len=16)


# ---------------------------------------------------------------------------
# programs (either package)
# ---------------------------------------------------------------------------


def build_mlp(fluid, lr=0.1, reg=0.0):
    """tests/test_parallel_executor.py's MLP under SGD(lr); `reg` adds
    reg * reduce_sum(pw1^2) to the loss."""
    x = fluid.layers.data(name="img", shape=[16], dtype="float32")
    y = fluid.layers.data(name="label", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=x, size=32, act="relu",
                        param_attr=fluid.ParamAttr(name="pw1"),
                        bias_attr=fluid.ParamAttr(name="pb1"))
    pred = fluid.layers.fc(input=h, size=4, act="softmax",
                           param_attr=fluid.ParamAttr(name="pw2"),
                           bias_attr=fluid.ParamAttr(name="pb2"))
    loss = fluid.layers.mean(fluid.layers.cross_entropy(input=pred,
                                                        label=y))
    if reg:
        w = fluid.default_main_program().global_block().var("pw1")
        sq = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(w, w))
        loss = fluid.layers.elementwise_add(
            loss, fluid.layers.scale(sq, scale=reg))
    fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return loss


def mlp_feed(seed=0, rows=32):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(rows, 16).astype(np.float32),
            "label": rng.randint(0, 4, size=(rows, 1)).astype(np.int64)}


def build_convbn(fluid):
    """conv + batch_norm + pool + fc classifier under Adam."""
    img = fluid.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    c = fluid.layers.conv2d(img, num_filters=4, filter_size=3, padding=1,
                            bias_attr=False)
    b = fluid.layers.batch_norm(c, act="relu")
    p = fluid.layers.pool2d(b, pool_size=2, pool_stride=2)
    pred = fluid.layers.fc(p, size=5, act="softmax")
    loss = fluid.layers.mean(fluid.layers.cross_entropy(input=pred,
                                                        label=label))
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def convbn_feed(seed=0, rows=8):
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(rows, 3, 8, 8).astype(np.float32),
            "label": rng.randint(0, 5, size=(rows, 1)).astype(np.int64)}


def build_lm(fluid, dtype="float32", amp=False, dropout=0.0):
    """The Fluid LM at 2 layers, narrow, SGD(0.01); `amp` the headline's
    legacy decorator at a static loss scale of 1."""
    tf = importlib.import_module(fluid.__name__
                                 + ".models.transformer_fluid")
    _, _, loss = tf.build(remat=False, dtype=dtype, dropout_rate=dropout,
                          **LM)
    opt = fluid.optimizer.SGD(0.01)
    if amp:
        opt = fluid.contrib.mixed_precision.decorate(
            opt, init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
    opt.minimize(loss)
    return loss


def lm_feed(seed=0, rows=8):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, LM["vocab_size"],
                       (rows, LM["seq_len"])).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def build_reduce(fluid):
    """reduce_prod, reduce_max and reduce_min over the batch axis, and
    reduce_max and reduce_min over all axes, of x - w under SGD(0.1): w
    is a parameter of 0.5s, so the feed's 0.5s give exact zeros and its
    equal values exact ties."""
    L = fluid.layers
    x = L.data(name="img", shape=[4], dtype="float32")
    w = L.create_parameter([4], "float32", attr=fluid.ParamAttr(
        name="rw", initializer=fluid.initializer.Constant(0.5)))
    r = L.elementwise_sub(x, w)
    loss = L.sums([L.mean(L.reduce_prod(r, dim=[0])),
                   L.mean(L.reduce_max(r, dim=[0])),
                   L.mean(L.reduce_min(r, dim=[0])),
                   L.reduce_max(r), L.reduce_min(r)])
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def reduce_feed():
    """8 rows. Column 0 holds one 0.5 (a zero of x - w, in the first
    rank's rows), column 1 two; column 1's largest value is in rows 0, 2
    and 6 (tied across ranks at world 2 and 4, and within the first
    rank at world 2) and its smallest in rows 3 and 7; the largest and
    smallest of all are tied too."""
    img = np.array([[0.5, 3.5, 1.25, 2.0],
                    [1.5, 1.5, 0.75, 3.5],
                    [2.5, 3.5, 1.25, 1.0],
                    [-0.5, 0.5, 2.25, 3.5],
                    [1.5, 1.5, 0.75, 2.0],
                    [2.5, 2.5, -1.5, 1.0],
                    [-0.5, 3.5, 2.25, 3.5],
                    [1.5, 0.5, -1.5, 2.0]], np.float32)
    return {"img": img}


def build_undeclared(fluid):
    """An op with no data-parallel rule (clip_by_norm) on the batch."""
    x = fluid.layers.data(name="img", shape=[16], dtype="float32")
    h = fluid.layers.fc(input=x, size=4)
    return fluid.layers.mean(fluid.layers.clip_by_norm(h, max_norm=1.0))


BUILDERS = {"mlp": build_mlp, "convbn": build_convbn, "lm": build_lm,
            "reduce": build_reduce, "undeclared": build_undeclared}


def build(fluid, name, **kw):
    """(main, startup, loss) of builder `name`, under a fresh name
    scope."""
    if fluid.__name__ == "paddle_tpu_torch":
        # the port's op seeds from a fresh process's counter, so two
        # builds in one rank draw the same dropout masks (the JAX side's
        # counters are pinned by the tests' fixture)
        from paddle_tpu_torch import layer_helper

        layer_helper._op_seed_counter[0] = 1000
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = BUILDERS[name](fluid, **kw)
    return main, startup, loss


def pack(arrays):
    """numpy arrays for a worker: bf16 (ml_dtypes) as its uint16 bits."""
    out = {}
    for n, a in arrays.items():
        a = np.asarray(a)
        out[n] = ("bf16", a.view(np.uint16).copy()) \
            if a.dtype.name == "bfloat16" else ("np", np.array(a))
    return out


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------


def _tensor(item):
    import torch

    kind, a = item
    if kind == "bf16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _host(t):
    import torch

    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _plant(fault):
    """Plant a known fault in this rank: 'sum_cotangents' (a reduction
    whose backward sums the cotangents over the ranks, as
    torch.distributed.nn.functional.all_reduce does), 'local_ties' (a
    batch max or min that splits its cotangent among the rank's own
    ties, so every tied rank takes it whole), 'local_shape' (shape
    reports the rank's rows) or 'local_bn' (batch_norm takes its
    statistics over the rank's rows). Returns the undo."""
    from paddle_tpu_torch.ops import nn_ops, registry
    from paddle_tpu_torch.parallel import collective

    if fault in ("sum_cotangents", "local_ties"):
        cls = collective._ReduceReplicated if fault == "sum_cotangents" \
            else collective._ReduceChooser
        saved = cls.backward

        def summed(ctx, g):
            return collective.all_reduce(g, ctx.group), None, None

        def local_ties(ctx, g):
            x, out = ctx.saved_tensors
            mask = (x.to(out.dtype) == out).to(out.dtype)
            ties = mask.sum(dim=ctx.dims, keepdim=True).clamp(min=1)
            return (g * mask / ties).to(x.dtype), None, None, None, None

        cls.backward = staticmethod(summed if fault == "sum_cotangents"
                                    else local_ties)
        return lambda: setattr(cls, "backward", saved)
    name, local = {"local_shape": ("shape", None),
                   "local_bn": ("batch_norm", nn_ops._batch_norm)}[fault]
    rule = registry.get(name).dp
    saved = rule.impl
    if local is None:
        def local_shape(ctx, ins, attrs, sharded):
            import torch

            x = ins["Input"][0] if "Input" in ins else ins["X"][0]
            return {"Out": [torch.tensor(tuple(x.shape), dtype=torch.int32)]}
        rule.impl = local_shape
    else:
        rule.impl = lambda ctx, ins, attrs, sharded: local(ctx, ins, attrs)
    return lambda: setattr(rule, "impl", saved)


def train(name, init, feed, steps=2, build_kw=None, strategy=None,
          fault=None, fetch_grads=(), local=False, runner="pe"):
    """Build `name` in the port, load `init` over its startup values,
    run `steps` data-parallel steps (`runner` "pe": ParallelExecutor;
    "compiled": Executor.run of CompiledProgram.with_data_parallel;
    with `local`, the plain single-device Executor instead) on the
    global batch `feed`. Returns losses, fetched grads per step, every
    persistable after the run, the collective counts and the plan's
    prediction."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import collective

    main, startup, loss = build(fluid, name, **(build_kw or {}))
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    exe.run(startup, scope=scope)
    for n, item in init.items():
        old = scope.get(n)
        scope.set(n, _tensor(item).to(old.dtype).reshape(old.shape))
    undo = _plant(fault) if fault else None
    fetch = [loss.name] + list(fetch_grads)
    bs = None
    if strategy:
        bs = fluid.BuildStrategy()
        for k, v in strategy.items():
            setattr(bs, k, getattr(fluid.BuildStrategy.GradientScaleStrategy,
                                   v) if k == "gradient_scale_strategy"
                    else v)
    try:
        if local:
            run = lambda: exe.run(main, feed=feed, fetch_list=fetch,  # noqa
                                  scope=scope)
        elif runner == "pe":
            pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                        main_program=main, scope=scope,
                                        build_strategy=bs)
            run = lambda: pe.run(fetch, feed=feed)  # noqa: E731
        else:
            prog = fluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name, build_strategy=bs)
            run = lambda: exe.run(prog, feed=feed, fetch_list=fetch,  # noqa
                                  scope=scope)
        collective.reset_counts()
        outs = [run() for _ in range(steps)]
    finally:
        if undo is not None:
            undo()
    counts = dict(collective.counts)
    expected = None
    if not local:
        steps_ = (pe._compiled if runner == "pe" else prog)._compiled_steps
        expected = next(iter(steps_.values())).expected_collectives()
    params = {v.name: _host(scope.get(v.name))
              for v in main.global_block().vars.values()
              if v.persistable and isinstance(scope.get(v.name),
                                              torch.Tensor)}
    op_types = None
    if not local:
        op_types = [o.type for o in next(iter(steps_.values()))
                    .program.global_block().ops]
    return {"losses": [np.asarray(o[0]).reshape(-1).copy() for o in outs],
            "grads": [[np.asarray(g).copy() for g in o[1:]] for o in outs],
            "params": params, "counts": counts, "expected": expected,
            "op_types": op_types}


def share_vars(init, feed, steps=3):
    """A training ParallelExecutor, then a test program's one built with
    share_vars_from=it: the test loss, and the plain Executor's on the
    same scope."""
    import paddle_tpu_torch as fluid

    main, startup, loss = build(fluid, "mlp")
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    exe.run(startup, scope=scope)
    for n, item in init.items():
        scope.set(n, _tensor(item))
    train_pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                      main_program=main, scope=scope)
    for _ in range(steps):
        train_pe.run([loss.name], feed=feed)
    test = main.clone(for_test=True)
    test_pe = fluid.ParallelExecutor(use_cuda=False, main_program=test,
                                     share_vars_from=train_pe,
                                     loss_name=loss.name)
    lv, = test_pe.run([loss.name], feed=feed)
    lv2, = exe.run(test, feed=feed, fetch_list=[loss], scope=scope)
    return {"pe": float(np.asarray(lv).mean()),
            "exe": float(np.asarray(lv2).reshape(-1)[0]),
            "device_count": test_pe.device_count}


def inplace_state(init, feed, enable_inplace):
    """One MLP step through ParallelExecutor under
    BuildStrategy.enable_inplace: whether the scope's pre-step tensor of
    pw1 still holds its start, and whether pw1 moved."""
    import paddle_tpu_torch as fluid

    main, startup, loss = build(fluid, "mlp")
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    exe.run(startup, scope=scope)
    for n, item in init.items():
        scope.set(n, _tensor(item))
    before = scope.get("pw1")
    start = before.clone()
    bs = fluid.BuildStrategy()
    bs.enable_inplace = enable_inplace
    pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                main_program=main, scope=scope,
                                build_strategy=bs)
    loss_value, = pe.run([loss.name], feed=feed)
    return {"prestep_kept": bool((before == start).all()),
            "moved": not bool((scope.get("pw1") == start).all()),
            "loss": float(np.asarray(loss_value).reshape(-1)[0])}


def raises(name, feed, strategy=None):
    """The message a data-parallel run of `name` raises, or None."""
    try:
        train(name, {}, feed, steps=1, strategy=strategy)
    except Exception as e:  # noqa: BLE001 (the message is the result)
        return "%s: %s" % (type(e).__name__, e)
    return None


def build_fleet_regression(fluid, fleet):
    """tests/test_distributed.py's collective-fleet regression, minimized
    through `fleet`.distributed_optimizer(SGD(0.1))."""
    x = fluid.layers.data(name="cx", shape=[4], dtype="float32")
    y = fluid.layers.data(name="cy", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    opt = fleet.distributed_optimizer(fluid.optimizer.SGD(0.1))
    opt.minimize(loss)
    return loss


def fleet_feed():
    rng = np.random.RandomState(0)
    xs = rng.rand(16, 4).astype(np.float32)
    return {"cx": xs, "cy": (xs.sum(1, keepdims=True) * 0.5).astype(
        np.float32)}


def fleet_regression(init, steps=10):
    """fleet.init() brings up the data group (from the env contract);
    the regression trains data-parallel through
    CompiledProgram.with_data_parallel from `init`."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.incubate.fleet.collective import fleet as cfleet

    cfleet.init(device="cpu")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = build_fleet_regression(fluid, cfleet)
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    exe.run(startup, scope=scope)
    for n, item in init.items():
        scope.set(n, _tensor(item))
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    losses = [float(exe.run(prog, feed=fleet_feed(), fetch_list=[loss],
                            scope=scope)[0][0])
              for _ in range(steps)]
    cfleet.barrier_worker()
    return {"losses": losses, "fleet_opt": main._fleet_opt,
            "worker": (cfleet.worker_index(), cfleet.worker_num()),
            "backend": cfleet._group.backend}


def benchmark(argv):
    """fluid_benchmark.run_static_model at `argv`, from the init draw of
    a fresh process."""
    from paddle_tpu_torch import fluid_benchmark, initializer, layer_helper

    initializer._global_seed_counter[0] = 0
    layer_helper._op_seed_counter[0] = 1000
    rec = {}
    out = fluid_benchmark.run_static_model(fluid_benchmark.parse_args(argv),
                                           rec)
    return {"out": out, "losses": rec["losses"]}


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_parallel_leg", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def smoke_leg(leg, **kw):
    """A leg of chip_smoke.py's phase 14 on this rank's CPU."""
    return getattr(_smoke(), leg)(device="cpu", **kw)


def smoke_vs_executor(cfg, batch, fault=None):
    """chip_smoke.dp_vs_exe_check on this rank's CPU: two steps of the
    LM at `cfg` through ParallelExecutor and through Executor.run (fp32,
    the tight limits), with `fault` planted in the first."""
    import torch

    import paddle_tpu_torch as fluid

    smoke = _smoke()
    program = smoke.build_lm(fluid, "float32", cfg=cfg)
    scope = fluid.Scope()
    fluid.Executor("cpu").run(program[1], scope=scope)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg["vocab_size"],
                       (batch, cfg["seq_len"])).astype(np.int32)
    feed = {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}

    class PE(fluid.ParallelExecutor):
        def run(self, *a, **k):
            undo = _plant(fault) if fault else None
            try:
                return super().run(*a, **k)
            finally:
                if undo is not None:
                    undo()

    return smoke.dp_vs_exe_check(torch, fluid, program, PE, "cpu",
                                 smoke._snapshot(scope), feed, "float32")


def _serve(rank, world, port, inq, outq):
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(world),
                      PADDLE_TRAINER_ENDPOINTS="127.0.0.1:%d" % port)
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.parallel.mesh import init_data_group

    init_data_group("cpu")
    while True:
        job = inq.get()
        if job is None:
            break
        case, kw = job
        try:
            if ":" in case:     # "module:function" of another worker module
                mod, name = case.split(":")
                fn = getattr(importlib.import_module(mod), name)
            else:
                fn = globals()[case]
            out = fn(**kw)
        except (Exception, SystemExit):  # noqa: BLE001 (to the test)
            out = {"error": traceback.format_exc()}
        outq.put((rank, out))


class Pool:
    """`world` gloo ranks serving cases."""

    def __init__(self, world):
        ctx = mp.get_context("spawn")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.world = world
        self.inqs = [ctx.Queue() for _ in range(world)]
        self.outq = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, port, self.inqs[r],
                                        self.outq))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, case, timeout=300, **kw):
        for q in self.inqs:
            q.put((case, kw))
        got = dict(self.outq.get(timeout=timeout) for _ in self.procs)
        return [got[r] for r in range(self.world)]

    def close(self):
        for q in self.inqs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


_POOLS = {}


def pool(world):
    if world not in _POOLS:
        _POOLS[world] = Pool(world)
    return _POOLS[world]


@atexit.register
def _close():
    for p in _POOLS.values():
        p.close()
