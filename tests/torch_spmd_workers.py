"""Rank-side cases of the SPMD trainer's tests, run on the gloo ranks of
``torch_dp_workers.pool`` as ``"torch_spmd_workers:<case>"``.

Trees cross the process boundary flattened to {"a/b": numpy array}
(`flat` / `unflat`). `plant(fault)` plants a known fault in this rank
and returns its undo:

- "no_pp_sum": a grad leaf replicated over pp is not summed over pp;
- "scatter_bwd_local": reduce_scatter's backward keeps this rank's
  cotangent in its own chunk (zeros elsewhere) instead of all-gathering;
- "a2a_bwd_reversed": all_to_all's backward sends chunk r to rank
  world-1-r instead of rank r;
- "drop_last_microbatch": the pipeline drops the last microbatch's grad;
- "gather_fwd_reversed": the forward all-gather of a 16-bit tensor (an
  activation of a bf16 step; the fp32 parameters' gathers are left
  right) concatenates the ranks' chunks in reverse order;
- "a2a_fwd_reversed": all_to_all's forward sends chunk r to rank
  world-1-r;
- "group_order": rank 1 creates the mesh's groups in another order.
"""

import numpy as np

from torch_dp_workers import _smoke

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
             max_seq_len=16, remat=False, dtype="float32")


def flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(flat(tree[k], prefix + k + "/"))
        else:
            out[prefix + k] = tree[k]
    return out


def unflat(items):
    tree = {}
    for path, v in items.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _host_tree(tree):
    from torch_dp_workers import _host

    return {k: _host(v) for k, v in flat(tree).items()}


def _torch_tree(items):
    import torch

    return unflat({k: torch.from_numpy(np.array(v))
                   for k, v in items.items()})


def config(**kw):
    from paddle_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**dict(SMALL, **kw))


def plant(fault):
    import torch

    from paddle_tpu_torch.parallel import collective, mesh, transformer

    if fault == "no_pp_sum":
        saved = transformer._replicated_axes

        def no_pp(spec, mesh_axes=mesh.AXES):
            return tuple(a for a in saved(spec, mesh_axes) if a != "pp")

        transformer._replicated_axes = no_pp
        return lambda: setattr(transformer, "_replicated_axes", saved)
    if fault == "scatter_bwd_local":
        cls, saved = collective._ReduceScatter, \
            collective._ReduceScatter.backward

        def local(ctx, g):
            parts = [torch.zeros_like(g)] * ctx.group.world
            parts[ctx.group.rank] = g
            return torch.cat(parts, ctx.dim), None, None

        cls.backward = staticmethod(local)
        return lambda: setattr(cls, "backward", saved)
    if fault == "a2a_bwd_reversed":
        cls, saved = collective._AllToAll, collective._AllToAll.backward

        def reversed_(ctx, g):
            return collective._exchange(g.flip(0), ctx.group, bwd=True), \
                None

        cls.backward = staticmethod(reversed_)
        return lambda: setattr(cls, "backward", saved)
    if fault == "gather_fwd_reversed":
        saved = collective._gather

        def gather_reversed(x, group, dim, bwd=False):
            out = saved(x, group, dim, bwd)
            if bwd or x.dtype == torch.float32:
                return out
            return torch.cat(out.chunk(group.world, dim)[::-1], dim)

        collective._gather = gather_reversed
        return lambda: setattr(collective, "_gather", saved)
    if fault == "a2a_fwd_reversed":
        cls, saved = collective._AllToAll, collective._AllToAll.forward

        def a2a_reversed(ctx, x, group):
            ctx.group = group
            return collective._exchange(x.flip(0), group)

        cls.forward = staticmethod(a2a_reversed)
        return lambda: setattr(cls, "forward", saved)
    if fault == "drop_last_microbatch":
        cls = transformer.SPMDTrainer
        saved = cls._accumulate

        def drop(self, acc, grads, microbatch):
            if microbatch != self.M - 1:
                saved(self, acc, grads, microbatch)

        cls._accumulate = drop
        return lambda: setattr(cls, "_accumulate", saved)
    if fault == "group_order":
        import torch.distributed as dist

        saved = mesh.group_plan
        if dist.get_rank() == 1:
            mesh.group_plan = lambda shape, unions: saved(shape, unions)[::-1]
        return lambda: setattr(mesh, "group_plan", saved)
    raise ValueError("unknown fault %r" % fault)


def _planted(fault, fn):
    undo = plant(fault) if fault else None
    try:
        return fn()
    finally:
        if undo is not None:
            undo()


def train(cfg, shape, params, tokens, labels, steps=3, M=None, lr=1e-2,
          fault=None):
    """`steps` SPMDTrainer steps at mesh `shape` on this rank's CPU from
    the full tree `params` (flat numpy) on the global batch: every
    step's loss, the full parameters after them (rank 0), the trainer's
    counts and the collective counts."""
    from paddle_tpu_torch.parallel import collective
    from paddle_tpu_torch.parallel.transformer import (SPMDTrainer,
                                                       gather_params)

    def run():
        tr = SPMDTrainer(config(**cfg), mesh_shape=shape,
                         num_microbatches=M, learning_rate=lr,
                         device="cpu")
        try:
            state = tr.init(params=_torch_tree(params))
            collective.reset_counts()
            losses = []
            for _ in range(steps):
                state, loss = tr.step(state, tokens, labels)
                losses.append(float(loss))
            counts = dict(collective.counts)
            full = gather_params(state[0], tr.specs, tr.mesh)
            return {"losses": losses, "counts": counts,
                    "trainer_counts": dict(tr.counts),
                    "coords": [tr.mesh.axis_index(a) for a in
                               ("dp", "pp", "tp")],
                    "params": _host_tree(full) if tr.mesh.rank == 0
                    else None}
        finally:
            tr.mesh.close()

    return _planted(fault, run)


def module(kind, cfg, params, h, cot):
    """`_block_sp` (kind "block", mesh (1, 1, world): tp) or `_moe_block`
    (kind "moe", mesh (world, 1, 1): ep over dp) on this rank's shard of
    the full layer `params` and of h [B, T, D] (tp: its sequence chunk;
    ep: its rows): the output, the grads of sum(out * cot) (this rank's
    chunk of cot) with respect to the local params and h, and (moe) the
    routing."""
    import torch

    from paddle_tpu_torch.parallel import transformer as PT
    from paddle_tpu_torch.parallel.mesh import SPMDMesh

    world = torch.distributed.get_world_size()
    mesh = SPMDMesh((1, 1, world) if kind == "block" else (world, 1, 1),
                    "cpu")
    try:
        c = config(**cfg)
        spec = PT.param_specs(c)
        spec = {k: s[1:] for k, s in spec["layers"].items()} \
            if kind == "block" else spec["moe"]
        local = PT.shard_params(_torch_tree(params), spec, mesh)
        leaves = {k: v.requires_grad_() for k, v in local.items()}
        h, cot = torch.from_numpy(h), torch.from_numpy(cot)
        r = mesh.rank
        if kind == "block":
            t = h.shape[1] // world
            h, cot = (x[:, r * t:(r + 1) * t] for x in (h, cot))
            fn = PT._block_sp
        else:
            b = h.shape[0] // world
            h, cot = (x[r * b:(r + 1) * b] for x in (h, cot))
            fn = PT._moe_block
        h = h.contiguous().requires_grad_()
        out = fn(leaves, h, c, mesh)
        names = sorted(leaves)
        grads = torch.autograd.grad((out * cot).sum(),
                                    [leaves[k] for k in names] + [h])
        res = {"out": out.detach().numpy(),
               "grads": {k: g.numpy() for k, g in zip(names, grads)},
               "h_grad": grads[-1].numpy()}
        if kind == "moe":
            x = h.detach().reshape(-1, h.shape[-1])
            expert, _, pos, keep, cap = PT._route(x, local["router"], c)
            res.update(expert=expert.numpy(), keep=keep.numpy(), cap=cap)
        return res
    finally:
        mesh.close()


def mesh_fault(shape, fault):
    """Bring up an SPMDMesh of `shape` with `fault` planted: the error
    it raises on this rank (None if it came up)."""
    from paddle_tpu_torch.parallel.mesh import SPMDMesh

    def run():
        try:
            SPMDMesh(shape, "cpu").close()
        except Exception as e:  # noqa: BLE001 (the message is the result)
            return "%s: %s" % (type(e).__name__, e)
        return None

    return _planted(fault, run)


def checkpoint_roundtrip(cfg, shape, params, tokens, labels, directory):
    """One step at mesh `shape`, the state gathered and saved from rank 0
    (``checkpoint.save_checkpoint``), then the next step: its loss, which
    a trainer restored from the checkpoint at another mesh must
    reproduce."""
    import torch

    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.parallel.transformer import SPMDTrainer

    tr = SPMDTrainer(config(**cfg), mesh_shape=shape, learning_rate=1e-2,
                     device="cpu")
    try:
        state = tr.init(params=_torch_tree(params))
        state, _ = tr.step(state, tokens, labels)
        full = tr.gather_state(state)
        if tr.mesh.rank == 0:
            p, m, v, step = full
            checkpoint.save_checkpoint(directory, {
                "params": p, "m": m, "v": v, "step": step}, 1)
        torch.distributed.barrier()
        _, loss = tr.step(state, tokens, labels)
        return {"loss": float(loss)}
    finally:
        tr.mesh.close()


def restore_step(cfg, shape, tokens, labels, directory):
    """The checkpoint of `checkpoint_roundtrip` restored into a fresh
    trainer at mesh `shape`: the loss of its next step."""
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.parallel.transformer import SPMDTrainer

    tr = SPMDTrainer(config(**cfg), mesh_shape=shape, learning_rate=1e-2,
                     device="cpu")
    try:
        full = checkpoint.restore_checkpoint(directory)
        state = tr.shard_state((full["params"], full["m"], full["v"],
                                full["step"]))
        _, loss = tr.step(state, tokens, labels)
        return {"loss": float(loss), "step": int(state[3])}
    finally:
        tr.mesh.close()


def smoke_spmd_rank(fault=None, **kw):
    """chip_smoke.py's phase 16c rank code on this rank's CPU, with
    `fault` planted."""
    return _planted(fault, lambda: _smoke().spmd_rank_legs(device="cpu",
                                                           **kw))
