"""Rank cases for the port's ZeRO tests (``tests/test_torch_zero.py``,
``tests/test_torch_chip_smoke_zero.py``), run on the gloo groups of
``torch_dp_workers.pool`` as ``pool.run("torch_zero_workers:<case>",
...)``, or in the test process on a group of one (`solo_group`: a line
of one rank issues no communication).

The problems are ``tests/test_zero.py``'s, from the arrays the test
passes in. Its elementwise problem multiplies each row of x by the same
row of w, so here each row carries its index: a rank's rows of x and y
meet their own rows of w (``w[idx] * x``), the same loss split by rows.
"""

import numpy as np

from torch_dp_workers import _host


def solo_group():
    """A data group of one CPU rank with no process group behind it."""
    import torch

    from paddle_tpu_torch.parallel.mesh import DataGroup

    return DataGroup(None, 0, 1, torch.device("cpu"), "gloo")


def _mesh(group=None):
    from paddle_tpu_torch.parallel.mesh import Mesh, data_group

    return Mesh(group or data_group())


def problem(name, arrays):
    """(fresh params, loss_fn, batch) of test_zero's problem `name`
    ("ew" or "mm") from its arrays."""
    import torch

    a = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
    if name == "ew":
        def loss_fn(p, x, y, idx):
            return (((p["w"][idx] * x - y) ** 2).mean()
                    + ((p["b"] - 0.3) ** 2).mean())

        batch = (a["ew_x"], a["ew_y"], torch.arange(a["ew_x"].shape[0]))
        w, b = a["ew_w"], a["ew_b"]
    else:
        def loss_fn(p, x, y):
            return ((x @ p["w"] + p["b"] - y) ** 2).mean()

        batch = (a["mm_x"], a["mm_y"])
        w, b = a["mm_w"], a["mm_b"]
    return (lambda: {"b": b.clone(), "w": w.clone()}), loss_fn, batch


def plan_of(opt):
    """The latched bucket plan as plain lists (None per-leaf)."""
    if opt._layout is None:
        return None
    return [{"indices": list(b.indices), "offsets": list(b.offsets),
             "sizes": list(b.sizes), "size": b.size, "padded": b.padded,
             "segment": b.segment, "dtype": str(b.dtype).split(".")[-1]}
            for b in opt._layout]


def run(opt, fresh, loss_fn, batch, steps=3, mesh=None, fail_at=None):
    """`steps` ShardedAdam steps from fresh params (ZeRO-3's sharded form
    converted at both ends); `fail_at` a step index before which a call
    with a batch of 3 rows fails first. Returns (params, losses, state,
    step)."""
    import torch

    mesh = mesh or _mesh()
    p = fresh()
    st = opt.init_state(p, mesh)
    zero3 = opt._plan["stage"] == 3
    if zero3:
        p = opt.shard_params(p, mesh)
    step = opt.make_step(mesh, loss_fn)
    losses = []
    for i in range(steps):
        if i == fail_at:
            try:
                step(p, st, torch.zeros((3, 3, 3)), *batch[1:])
            except (RuntimeError, ValueError, IndexError):
                pass
            else:
                raise AssertionError("the bad batch did not fail")
        p, st, loss = step(p, st, *batch)
        losses.append(float(loss))
    if zero3:
        p = opt.gather_params(p)
    return p, losses, st, step


def rung_result(opt, p, losses, st, step):
    g = opt.gather_state(st)
    return {"params": {k: _host(v) for k, v in p.items()},
            "losses": losses,
            "m": [_host(x) for x in g["m"]], "v": [_host(x) for x in g["v"]],
            "step": g["step"], "plan": plan_of(opt),
            "record": step.issue_record,
            "state_bytes": sum(x.numel() * x.element_size() for x in
                               _leaves(st["m"]) + _leaves(st["v"])),
            "state_host": [x.device.type for x in _leaves(st["m"])]}


def _leaves(tree):
    from paddle_tpu_torch.parallel.zero import _flatten

    return _flatten(tree)[0]


def ladder(arrays, rungs, problems=("ew", "mm"), steps=3, lr=1e-2,
           group=None):
    """Every rung of `rungs` ({name: ShardedAdam keywords}) on each
    problem: {problem: {rung: rung_result}}, plus the counted ZeRO
    collectives of each run."""
    from paddle_tpu_torch.parallel import ShardedAdam
    from paddle_tpu_torch.parallel import collective as C

    out = {}
    for prob in problems:
        fresh, loss_fn, batch = problem(prob, arrays)
        out[prob] = {}
        for name, kw in rungs.items():
            C.reset_counts()
            opt = ShardedAdam(learning_rate=lr, **kw)
            res = rung_result(opt, *run(opt, fresh, loss_fn, batch, steps,
                                        _mesh(group)))
            res["counts"] = {k: C.counts[k] for k in C.ZERO_KINDS}
            out[prob][name] = res
    return out


def flagship(params, cfg, tokens, labels, rungs, steps=2, lr=1e-3):
    """The port's flagship loss (``single_chip_loss`` at `cfg`) under each
    rung from the JAX package's numpy `params`: {rung: rung_result}."""
    import torch

    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import ShardedAdam
    from paddle_tpu_torch.parallel.zero import _flatten

    tcfg = T.TransformerConfig(**cfg)
    batch = (torch.from_numpy(tokens), torch.from_numpy(labels))

    def loss_fn(p, tok, lab):
        return T.single_chip_loss(p, tok, lab, tcfg)

    out = {}
    for name, kw in rungs.items():
        opt = ShardedAdam(learning_rate=lr, **kw)
        p, losses, st, step = run(
            opt, lambda: T.params_from_numpy(params, device="cpu"),
            loss_fn, batch, steps)
        res = rung_result(opt, {str(i): x for i, x in
                                enumerate(_flatten(p)[0])}, losses, st,
                          step)
        out[name] = res
    return out


def offload_resume(arrays, directory, rank_dir=True, lr=1e-2,
                   group=None):
    """test_zero's offload checkpoint resume on the elementwise problem:
    4 uninterrupted steps, then 2 steps, a save (a directory a rank),
    a restore into a fresh optimizer and 2 more steps. Returns both
    runs' params and losses and what the restored state held."""
    import os

    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.parallel import ShardedAdam

    mesh = _mesh(group)
    fresh, loss_fn, batch = problem("ew", arrays)

    def mk():
        return ShardedAdam(bucket_mb=100 / (1 << 20), offload=True,
                           learning_rate=lr)

    p_ref, l_ref, _, s_ref = run(mk(), fresh, loss_fn, batch, 4, mesh)
    s_ref.close()
    opt = mk()
    p = fresh()
    st = opt.init_state(p, mesh)
    step = opt.make_step(mesh, loss_fn)
    for _ in range(2):
        p, st, _loss = step(p, st, *batch)
    step.close()
    ckdir = os.path.join(directory, "rank_%d" % mesh.group.rank) \
        if rank_dir else directory
    path = checkpoint.save_checkpoint(ckdir, {"params": p, "opt": st},
                                      step=2)
    opt2 = mk()
    p2 = fresh()
    st2 = opt2.init_state(p2, mesh)
    restored = checkpoint.restore_checkpoint(
        ckdir, target_state={"params": p2, "opt": st2})
    p2, st2 = restored["params"], restored["opt"]
    held = {"m_device": [x.device.type for x in st2["m"]],
            "step": int(st2["step"]),
            "manifest": os.path.isfile(os.path.join(
                path, checkpoint.MANIFEST_NAME))}
    step2 = opt2.make_step(mesh, loss_fn)
    losses = []
    for _ in range(2):
        p2, st2, loss = step2(p2, st2, *batch)
        losses.append(float(loss))
    step2.close()
    return {"ref": {k: _host(v) for k, v in p_ref.items()},
            "ref_losses": l_ref,
            "resumed": {k: _host(v) for k, v in p2.items()},
            "losses": losses, "held": held}


def roundtrip(arrays):
    """ZeRO-3's stored form on this rank: each bucket's shard and padded
    length, and whether gather_params gives the tree back bitwise."""
    from paddle_tpu_torch.parallel import ShardedAdam

    fresh, _loss, _batch = problem("mm", arrays)
    mesh = _mesh()
    opt = ShardedAdam(bucket_mb=100 / (1 << 20), zero_stage=3)
    p = fresh()
    opt.init_state(p, mesh)
    shards = opt.shard_params(p, mesh)
    back = opt.gather_params(shards)
    return {"shard": [s.numel() for s in shards],
            "padded": [b.padded for b in opt._layout],
            "first": float(shards[-1][0]),
            "equal": all(bool((back[k] == p[k]).all()) for k in p),
            "dtypes": [str(back[k].dtype).split(".")[-1] for k in sorted(p)]}


def failed_call(arrays, lr=1e-2, group=None):
    """test_zero's offload step surviving a failed call: the losses and
    params of a never-failed run and of one whose step 1 is preceded by
    a failing call."""
    from paddle_tpu_torch.parallel import ShardedAdam

    fresh, loss_fn, batch = problem("ew", arrays)
    out = {}
    for key, fail_at in (("ref", None), ("failed", 1)):
        opt = ShardedAdam(bucket_mb=100 / (1 << 20), offload=True,
                          learning_rate=lr)
        p, losses, _st, step = run(opt, fresh, loss_fn, batch,
                                   mesh=_mesh(group), fail_at=fail_at)
        step.close()
        out[key] = {"params": {k: _host(v) for k, v in p.items()},
                    "losses": losses}
    return out


def smoke_zero(fault=None, **kw):
    """chip_smoke.zero_rank_legs on this rank's CPU (`kw` its
    arguments), with `fault` planted (``chip_smoke.zero_fault``)."""
    import importlib.util

    from torch_dp_workers import ROOT

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_zero_leg", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    undo = mod.zero_fault(fault) if fault else None
    try:
        return mod.zero_rank_legs(device="cpu", **kw)
    finally:
        if undo is not None:
            undo()
