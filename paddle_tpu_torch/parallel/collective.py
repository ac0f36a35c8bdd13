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
a copy and may launch no kernel.
"""

import torch
import torch.distributed as dist

__all__ = ["all_gather_rows", "all_reduce", "counts", "enter_sharded",
           "reduce_chooser", "reduce_replicated", "reset_counts"]

counts = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0,
          "all_gather_bytes": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def reset_counts():
    for k in counts:
        counts[k] = 0


def _nbytes(t):
    return t.numel() * t.element_size()


def all_reduce(t, group, op="sum"):
    """A new tensor: `t` reduced over the data group (t is unchanged)."""
    out = t.detach().contiguous().clone()
    counts["all_reduce"] += 1
    counts["all_reduce_bytes"] += _nbytes(out)
    dist.all_reduce(out, op=_OPS[op], group=group.pg)
    return out


def _all_gather(t, group):
    """Every rank's `t`, in rank order."""
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(group.world)]
    counts["all_gather"] += 1
    counts["all_gather_bytes"] += _nbytes(t) * group.world
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
