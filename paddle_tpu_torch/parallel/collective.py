"""The collectives of the data-parallel step, over ``torch.distributed``
(NCCL on the card, gloo on the CPU).

The JAX package leaves them to GSPMD, which keeps a step's result the
single device's on the global batch. The port issues them by hand, and
two autograd Functions carry that contract through the backward:

- `reduce_replicated`: a batch reduction leaves the sharded region. The
  partial sums on the local rows are all-reduced (SUM or PROD) into the
  global value, which every rank holds; in backward the replicated
  cotangent passes through unchanged (SUM), or times the product of
  the other ranks' partials, all-gathered (PROD: finite where a partial
  is 0, as ``torch.prod``'s own backward is).
  ``torch.distributed.nn.functional.all_reduce`` would sum the
  cotangents over the ranks instead, and so scale every grad by N.
- `reduce_chooser`: a batch max or min from the local rows, all-reduced
  (MAX or MIN). In backward the cotangent is split evenly among every
  element equal to the global value, on all ranks (their count
  all-reduced), as ``torch.amax`` and ``jnp.max`` split it among ties
  on one device.
- `enter_sharded`: a replicated value (a parameter, a replicated
  activation) that an op combines with batch-sharded rows passes
  through unchanged in forward; its grad, which on each rank holds only
  the local rows' contribution, is all-reduced (SUM) in backward.

Every call goes through `all_reduce` / `all_gather_rows`, which count
calls and bytes in `counts` (``reset_counts()`` zeroes them): the card's
gate reads the port's own calls, since NCCL's all-reduce of one rank is
a copy and may launch no kernel. A line of one rank (the data line of a
(1, tp) mesh) issues no communication, but each call is still counted.

The Fluid step's tensor-parallel region (``ops/tp.py``) runs on the tp
line of the (dp, tp) mesh, with Megatron's conjugate pair and the seam:

- `enter_tp(x, group)`: a replicated operand of an op whose rank-local
  part covers only this rank's share of the output (Megatron's *f*):
  unchanged in forward, its grad summed over the tp line in backward.
- `reduce_tp(x, group, op)`: the partial results of a row-parallel
  product summed (or, for the vocab-parallel softmax, maxed) over the
  line in forward (Megatron's *g*); the replicated cotangent passes
  through unchanged in backward (SUM).
- `gather_tp(x, group, dim)`: the seam: a tp-sharded value all-gathered
  into its replicated value on `dim`; in backward, where the replicated
  cotangent is the same on every rank, this rank's slice of it.

They count under kinds of their own: "reduce_tp" and "gather_tp" for
the forward's calls (a recompute replay's too), "enter_tp_bwd" for the
backward's; the ZeRO-1 update's all-gather of a parameter's rows over
the data line counts as "zero_gather", and the gathers
of sharded fetches and of ``compiler.gather_persistables`` as
"gather_state".

The SPMD trainer's axis collectives (``parallel/transformer.py``) run on
a mesh line (``mesh.AxisGroup``) and carry the transposes JAX's
``shard_map`` applies:

- `all_gather(x, group, dim)`: ``all_gather(..., axis=dim, tiled=True)``;
  backward a sum reduce-scatter of the cotangent on `dim`.
- `reduce_scatter(x, group, dim)`: ``psum_scatter(...,
  scatter_dimension=dim, tiled=True)``; backward an all-gather.
- `all_to_all(x, group)`: ``all_to_all(split_axis=0, concat_axis=0)``
  (chunk r of dim 0 to rank r; the result's chunk s from rank s);
  backward the same exchange of the cotangent.
- `psum_leaves(tensors, group)`: sums with no backward (the per-leaf
  grad sums, the loss), the leaves in one bucket.
- `send_recv(sends, recvs, group, kind)`: one ``batch_isend_irecv``
  (the pipeline's two chains), waited on; the Fluid pipeline
  (``pipeline_program.py``) counts its exchanges under "pp_p2p" (their
  bytes split by tag into "pp_fwd_bytes" for activations and
  "pp_bwd_bytes" for cotangents) and its one-time wire layouts under
  "pp_layout".

``parallel/zero.py``'s ShardedAdam moves flat 1-D buffers over the
data group, with no backward, each call optionally async (``async_op``:
the work handle comes back beside the result, None where no
communication was issued):

- `zero_reduce_scatter(flat, group)`: the SUM over the ranks, this
  rank's 1/world slice (kind "zero_reduce_scatter"); the caller divides
  by the world in the wire dtype, as JAX divides after ``psum_scatter``
  (gloo has no AVG).
- `zero_all_gather(shard, group, kind)`: every rank's slice in rank
  order: the gather-back of updated parameter slices ("zero_gather",
  the kind ZeRO-1's gathers of the Fluid step count under), stage 3's
  start-of-step parameter gathers ("zero_param_gather") and the host
  copies of the sharded state ("gather_state").
- `zero_all_reduce(t, group)`: the loss's SUM over the ranks
  ("zero_loss").

A line of one rank makes each of them the identity, but each call is
counted all the same: ``counts[kind]`` and ``counts[kind + "_bytes"]``
for a call in a forward (a remat recompute's too), ``kind + "_bwd"``
for one a backward issues, kinds "axis_gather", "reduce_scatter",
"all_to_all", "psum", "send_recv", the pipeline's and the ZeRO kinds
above (and ``counts[tag]`` / ``counts[tag + "_bytes"]`` for the byte
tags of PP_TAGS, which have no host seconds of their own);
``host_seconds[kind]`` the host's time inside the call (NCCL returns
once the work is queued; gloo once it is done; an async call once it is
issued).
"""

import time

import torch
import torch.distributed as dist

__all__ = ["all_gather", "all_gather_rows", "all_reduce", "all_to_all",
           "counts", "enter_sharded", "enter_tp", "gather_tp",
           "host_seconds", "psum_leaves", "reduce_chooser",
           "reduce_replicated", "reduce_scatter", "reduce_tp",
           "reset_counts", "send_recv", "zero_all_gather",
           "zero_all_reduce", "zero_reduce_scatter"]

counts = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0,
          "all_gather_bytes": 0}
AXIS_KINDS = ("axis_gather", "reduce_scatter", "all_to_all", "psum",
              "send_recv", "pp_p2p", "pp_layout", "enter_tp",
              "reduce_tp", "gather_tp",
              "zero_gather", "gather_state", "zero_reduce_scatter",
              "zero_param_gather", "zero_loss")
ZERO_KINDS = ("zero_reduce_scatter", "zero_gather", "zero_param_gather",
              "zero_loss")
TP_KINDS = ("enter_tp_bwd", "reduce_tp", "gather_tp", "zero_gather")
# byte tags of a send_recv call's sends (the pipeline's two directions)
PP_TAGS = ("pp_fwd", "pp_bwd")
for _tag in PP_TAGS:
    counts[_tag] = counts[_tag + "_bytes"] = 0
for _kind in AXIS_KINDS:
    for _key in (_kind, _kind + "_bwd"):
        counts[_key] = counts[_key + "_bytes"] = 0
host_seconds = {k: 0.0 for k in AXIS_KINDS}

_OPS = {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def reset_counts():
    for k in counts:
        counts[k] = 0
    for k in host_seconds:
        host_seconds[k] = 0.0


def _nbytes(t):
    return t.numel() * t.element_size()


def all_reduce(t, group, op="sum"):
    """A new tensor: `t` reduced over the data group (t is unchanged)."""
    out = t.detach().contiguous().clone()
    counts["all_reduce"] += 1
    counts["all_reduce_bytes"] += _nbytes(out)
    if group.world > 1:
        dist.all_reduce(out, op=_OPS[op], group=group.pg)
    return out


def _all_gather(t, group):
    """Every rank's `t`, in rank order."""
    t = t.detach().contiguous()
    counts["all_gather"] += 1
    counts["all_gather_bytes"] += _nbytes(t) * group.world
    if group.world == 1:
        return [t]
    parts = [torch.empty_like(t) for _ in range(group.world)]
    dist.all_gather(parts, t, group=group.pg)
    return parts


def all_gather_rows(t, group):
    """The global value of a batch-sharded tensor: every rank's rows, in
    rank order, concatenated on dim 0."""
    return torch.cat(_all_gather(t, group), 0)


class _ReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, group, op):
        out = all_reduce(partial, group, op)
        ctx.op = op
        ctx.group = group
        if op == "prod":
            ctx.save_for_backward(partial)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.op == "sum":
            return g, None, None
        # d(product of the partials) / d(local partial): the product of
        # the other ranks' partials
        partial, = ctx.saved_tensors
        parts = _all_gather(partial, ctx.group)
        others = torch.ones_like(partial)
        for r, p in enumerate(parts):
            if r != ctx.group.rank:
                others = others * p
        return g * others, None, None


class _ReduceChooser(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dims, acc, group, op):
        local = (torch.amax if op == "max" else torch.amin)(
            x, dim=dims, keepdim=True).to(acc)
        out = all_reduce(local, group, op)
        ctx.dims = dims
        ctx.group = group
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        mask = (x.to(out.dtype) == out).to(out.dtype)
        ties = all_reduce(mask.sum(dim=ctx.dims, keepdim=True), ctx.group,
                          "sum")
        return (g * mask / ties).to(x.dtype), None, None, None, None


class _EnterSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, "sum"), None


def reduce_replicated(partial, group, op="sum"):
    """The global value of per-rank partial results, `op` "sum" or
    "prod" (see the module docstring for its backward)."""
    if partial.requires_grad and torch.is_grad_enabled():
        return _ReduceReplicated.apply(partial, group, op)
    return all_reduce(partial, group, op)


def reduce_chooser(x, dims, acc, group, op):
    """The global max or min (`op`) of batch-sharded `x` over `dims`,
    kept-dims shaped, in dtype `acc` (see the module docstring for its
    backward)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _ReduceChooser.apply(x, dims, acc, group, op)
    local = (torch.amax if op == "max" else torch.amin)(
        x, dim=dims, keepdim=True).to(acc)
    return all_reduce(local, group, op)


def enter_sharded(x, group):
    """`x` unchanged; its grad all-reduced over the group in backward.
    Outside autograd (no grad wanted) it is `x` itself."""
    if isinstance(x, torch.Tensor) and x.requires_grad \
            and torch.is_grad_enabled():
        return _EnterSharded.apply(x, group)
    return x


# ---------------------------------------------------------------------------
# the SPMD trainer's axis collectives
# ---------------------------------------------------------------------------


def _issue(kind, nbytes, bwd, fn):
    """Count one call of `kind` and run `fn` (the communication) timed."""
    key = kind + "_bwd" if bwd else kind
    counts[key] += 1
    counts[key + "_bytes"] += nbytes
    t0 = time.perf_counter()
    out = fn()
    host_seconds[kind] += time.perf_counter() - t0
    return out


def _gather(x, group, dim, bwd=False, kind="axis_gather"):
    """Every rank's `x` concatenated on `dim`, in axis order."""
    x = x.contiguous()
    if group.world == 1:
        _issue(kind, _nbytes(x), bwd, lambda: None)
        return x.view_as(x)
    # gloo wants the ranks' tensors concatenated on dim 0
    out = x.new_empty((group.world * x.shape[0],) + tuple(x.shape[1:]))
    _issue(kind, _nbytes(x), bwd,
           lambda: dist.all_gather_into_tensor(out, x, group=group.pg))
    if dim == 0:
        return out
    shape = list(x.shape)
    shape[dim] *= group.world
    return out.view((group.world,) + tuple(x.shape)).movedim(
        0, dim).reshape(shape)


def _scatter(x, group, dim, bwd=False):
    """The sum over the ranks of `x`, this rank's chunk of `dim`."""
    if group.world == 1:
        _issue("reduce_scatter", _nbytes(x), bwd, lambda: None)
        return x.view_as(x)
    if x.shape[dim] % group.world:
        raise ValueError("reduce_scatter: dim %d of %s does not split "
                         "over %d ranks" % (dim, tuple(x.shape),
                                            group.world))
    parts = x.unflatten(dim, (group.world, -1)).movedim(dim, 0).contiguous()
    out = parts.new_empty(parts.shape[1:])
    _issue("reduce_scatter", _nbytes(parts), bwd,
           lambda: dist.reduce_scatter_tensor(out, parts.flatten(0, 1),
                                              group=group.pg))
    return out


def _exchange(x, group, bwd=False):
    """all_to_all on dim 0: chunk r to rank r, chunk s of the result from
    rank s."""
    x = x.contiguous()
    if group.world == 1:
        _issue("all_to_all", _nbytes(x), bwd, lambda: None)
        return x.view_as(x)
    out = torch.empty_like(x)
    _issue("all_to_all", _nbytes(x), bwd,
           lambda: dist.all_to_all_single(out, x, group=group.pg))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.group, ctx.dim, bwd=True), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim, bwd=True), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, bwd=True), None


def _differentiable(x):
    return x.requires_grad and torch.is_grad_enabled()


def all_gather(x, group, dim):
    """JAX's ``all_gather(x, axis, axis=dim, tiled=True)`` over `group`;
    its backward reduce-scatters the cotangent."""
    if _differentiable(x):
        return _AllGather.apply(x, group, dim)
    return _gather(x, group, dim)


def reduce_scatter(x, group, dim):
    """JAX's ``psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``
    over `group`; its backward all-gathers the cotangent."""
    if _differentiable(x):
        return _ReduceScatter.apply(x, group, dim)
    return _scatter(x, group, dim)


def all_to_all(x, group):
    """JAX's ``all_to_all(x, axis, split_axis=0, concat_axis=0)`` over
    `group` (dim 0 of size group.world); its backward is the same
    exchange of the cotangent."""
    if _differentiable(x):
        return _AllToAll.apply(x, group)
    return _exchange(x, group)


def psum_leaves(tensors, group):
    """New tensors: each of `tensors` summed over `group`, all in one
    flat bucket of their common dtype (one call)."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    _issue("psum", _nbytes(flat), False,
           lambda: None if group.world == 1
           else dist.all_reduce(flat, group=group.pg))
    return [p.view_as(t) for p, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]


def send_recv(sends, recvs, group, kind="send_recv"):
    """One ``batch_isend_irecv`` of (tensor, global peer rank) sends and
    (buffer, global peer rank) receives, waited on; nothing (and no
    count) when both are empty. The call is counted once under `kind`,
    with all the bytes sent and its host seconds; a send given as
    (tensor, peer, tag) adds its bytes to ``counts[tag + "_bytes"]`` too,
    and the call to ``counts[tag]`` once for each tag it carries."""
    if not sends and not recvs:
        return
    sends = [s if len(s) == 3 else (s[0], s[1], None) for s in sends]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), peer, group.pg)
            for t, peer, _ in sends]
           + [dist.P2POp(dist.irecv, buf, peer, group.pg)
              for buf, peer in recvs])

    def run():
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    by_tag = {}
    for t, _, tag in sends:
        if tag is not None:
            by_tag[tag] = by_tag.get(tag, 0) + _nbytes(t)
    for tag, nbytes in by_tag.items():
        counts[tag] += 1
        counts[tag + "_bytes"] += nbytes
    _issue(kind, sum(_nbytes(t) for t, _, _ in sends), False, run)


# ---------------------------------------------------------------------------
# the Fluid step's tensor-parallel region
# ---------------------------------------------------------------------------


def _line_reduce(x, group, op, kind, bwd=False):
    """A new tensor: `x` reduced (`op`) over the mesh line `group`."""
    out = x.detach().contiguous().clone()
    _issue(kind, _nbytes(out), bwd,
           lambda: None if group.world == 1
           else dist.all_reduce(out, op=_OPS[op], group=group.pg))
    return out


def local_part(x, group, dim):
    """This rank's block of `dim` of a value every rank of `group`
    holds."""
    n = x.shape[dim] // group.world
    return x.narrow(dim, group.rank * n, n)


class _EnterTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _line_reduce(g, ctx.group, "sum", "enter_tp", True), None


class _ReduceTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _line_reduce(x, group, "sum", "reduce_tp")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim, kind="gather_tp")

    @staticmethod
    def backward(ctx, g):
        return local_part(g, ctx.group, ctx.dim), None, None


def enter_tp(x, group):
    """`x` unchanged; its grad summed over the tp line in backward.
    Outside autograd it is `x` itself."""
    if isinstance(x, torch.Tensor) and _differentiable(x):
        return _EnterTp.apply(x, group)
    return x


def reduce_tp(x, group, op="sum"):
    """The partial results `x` reduced over the tp line: SUM (backward:
    the cotangent as it is) or MAX (no backward: the vocab-parallel
    softmax's shift, a constant of its gradient)."""
    if op == "sum" and _differentiable(x):
        return _ReduceTp.apply(x, group)
    return _line_reduce(x, group, op, "reduce_tp")


def gather_tp(x, group, dim):
    """The replicated value of tp-sharded `x` (sharded on `dim`); its
    backward takes this rank's slice of the replicated cotangent."""
    if _differentiable(x):
        return _GatherTp.apply(x, group, dim)
    return _gather(x, group, dim, kind="gather_tp")



# ---------------------------------------------------------------------------
# ShardedAdam's flat-buffer collectives
# ---------------------------------------------------------------------------


def zero_reduce_scatter(flat, group, async_op=False):
    """The SUM over `group` of the 1-D `flat` (its length a multiple of
    the world), this rank's 1/world slice; with `async_op`, (slice, work
    handle or None)."""
    flat = flat.detach().contiguous()
    if group.world == 1:
        _issue("zero_reduce_scatter", _nbytes(flat), False, lambda: None)
        return (flat, None) if async_op else flat
    if flat.numel() % group.world:
        raise ValueError("zero_reduce_scatter: %d elements do not split "
                         "over %d ranks" % (flat.numel(), group.world))
    out = flat.new_empty(flat.numel() // group.world)
    work = _issue("zero_reduce_scatter", _nbytes(flat), False,
                  lambda: dist.reduce_scatter_tensor(
                      out, flat, group=group.pg, async_op=async_op))
    return (out, work) if async_op else out


def zero_all_gather(shard, group, kind="zero_gather", async_op=False):
    """Every rank's 1-D `shard` of `group`, concatenated in rank order;
    with `async_op`, (result, work handle or None)."""
    shard = shard.detach().contiguous()
    if group.world == 1:
        _issue(kind, _nbytes(shard), False, lambda: None)
        return (shard, None) if async_op else shard
    out = shard.new_empty(shard.numel() * group.world)
    work = _issue(kind, _nbytes(shard), False,
                  lambda: dist.all_gather_into_tensor(
                      out, shard, group=group.pg, async_op=async_op))
    return (out, work) if async_op else out


def zero_all_reduce(t, group):
    """A new tensor: `t` summed over `group` (the loss's all-reduce)."""
    out = t.detach().contiguous().clone()
    _issue("zero_loss", _nbytes(out), False,
           lambda: None if group.world == 1
           else dist.all_reduce(out, group=group.pg))
    return out
