"""Sharded-optimizer data parallelism on ``torch.distributed`` (parity:
the JAX package's ``parallel/zero.py``: `ShardedAdam` :159,
`ZeroLayoutError` :68), the ZeRO ladder with comm/compute overlap and
host-offloaded state, over the data group (``mesh.Mesh(group,
("dp",))``: NCCL on the card, gloo on the CPU).

Sharding levels (`zero_stage` / $PTPU_ZERO_STAGE):

  1  optimizer-state sharding (the default): each gradient is
     reduce-scattered over the data axis, Adam's m and v live only as
     each rank's own shard, and the updated parameter slices all-gather
     back into the full (replicated) parameters: one collective a leaf,
     or a few large flat buckets with `bucket_mb` set.
  2  + gradient sharding: bucketing is mandatory, and each leaf's full
     gradient is taken from the backward as it lands
     (``register_post_accumulate_grad_hook``), copied into its bucket
     once the bucket's leaves are all in, and freed; past the
     reduce-scatter only the rank's bucket shard remains, so full
     gradients never outlive the backward. The update is the bucketed
     stage 1's, bit for bit.
  3  + parameter sharding: parameters are STORED as each rank's flat
     fp32 bucket shards (`shard_params`; `gather_params` gives the tree
     back), all-gathered per bucket at the start of the step, and the
     update writes the shards in place: no gather-back. The full
     parameters are dropped once the backward is done (under remat the
     backward reads them again, so not earlier).

Comm/compute overlap (`overlap` / $PTPU_ZERO_OVERLAP): the buckets are
planned in BACKWARD order (``amp.plan_buckets(order="backward")``:
segment 0 holds the leaves whose grads the backward produces first).
Each leaf's post-accumulate hook takes its grad; when every leaf of
bucket k is in, the bucket is flattened and its async reduce-scatter
issued, in segment order: bucket k never before bucket k-1, on every
rank, so the ranks' collectives match (NCCL would hang otherwise). The
autograd graph is walked before the backward, so a leaf the loss never
reads does not hold its bucket back (its grad is zeros); any bucket
still open when the backward returns is issued then, in order. The
handles are waited on before the update. The step's `issue_record`
says, for each issue, the segment and how many leaf grads the backward
produced after it (> 0: the collective had backward work to overlap).
Overlap on and off give bitwise the same parameters and state.

Host-offloaded state (`offload` / $PTPU_ZERO_OFFLOAD): m and v are the
rank's shards in host buffers (pinned on the card). The step begins
staging them in on the prefetcher's stream
(``async_engine.HostStateStager``), runs the forward, the backward and
the reduce-scatters, ends the stage-in, updates, and copies m and v
back out (the step's optimizer sync point). Bytes both ways land in
zero/offload_bytes. A step whose compute raises aborts the stage, so
the stager stays usable.

Where the port differs from the JAX step:

- the step takes the global batch and each rank computes the loss and
  grads of its own rows; the reduce-scatter sums the ranks' grads in
  the wire dtype (`grad_dtype`) and divides by the world in it, then
  casts to fp32, JAX's order of roundings (the JAX step sums n copies
  of one global grad). The returned loss is the mean of the ranks'
  losses (one counted all-reduce): the global batch's loss for a loss
  that is a row mean over equal rows. So the port meets JAX within fp32
  tolerance; within the port the bucketed rungs are bitwise equal on
  one rank, and at more ranks where their bucket plans agree (a ring
  reduce-scatter sums an element in an order set by the rank owning
  its shard, which another plan moves);
- the state holds each rank's own shard: per-leaf, the leaf's leading
  dim padded to a multiple of the world, the rank's rows; bucketed, the
  rank's padded/world slice of each bucket;
- the rungs are bitwise equal over fp32 leaves only: with leaves stored
  in bf16, stages 1/2 round each updated parameter to bf16 while stage
  3 keeps its fp32 shards.

`gather_state` / `shard_state` turn a state into the global padded
arrays of the plan's layout (the JAX step's state) and back; `leaf_state`
cuts global arrays into per-leaf tensors.
"""

import time

import torch

from .. import amp
from .. import flags as _flags
from ..async_engine import HostStateStager
from ..observability import metrics as _metrics
from . import collective as C

__all__ = ["ShardedAdam", "ZeroLayoutError"]


class ZeroLayoutError(RuntimeError):
    """The optimizer's planned state layout and the configuration seen at
    make_step time disagree (init_state never called, or a knob changed
    after it ran): re-plan with init_state instead of silently latching
    a stale layout."""


# ---------------------------------------------------------------------------
# pytrees: nested dicts (keys sorted), lists and tuples of tensors, in
# jax.tree.flatten's order
# ---------------------------------------------------------------------------


def _flatten(tree):
    """(leaves, treedef) of `tree`; None is an empty subtree."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        parts = [_flatten(tree[k]) for k in keys]
        return ([x for p in parts for x in p[0]],
                ("dict", keys, tuple(p[1] for p in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(x) for x in tree]
        return ([x for p in parts for x in p[0]],
                (type(tree).__name__, len(tree), tuple(p[1] for p in parts)))
    if tree is None:
        return [], None
    return [tree], "*"


def _unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        if d == "*":
            return next(it)
        if d is None:
            return None
        kind, keys, subs = d
        if kind == "dict":
            return {k: build(s) for k, s in zip(keys, subs)}
        items = [build(s) for s in subs]
        return tuple(items) if kind == "tuple" else items

    return build(treedef)


def _local_rows(batch, group):
    """This rank's rows (its 1/world block of dim 0) of each batch
    tensor; anything else passes as it is."""
    n, r = group.world, group.rank
    out = []
    for b in batch:
        if isinstance(b, torch.Tensor) and b.ndim and n > 1:
            if b.shape[0] % n:
                raise ValueError(
                    "a batch of %d rows does not split over %d data-"
                    "parallel ranks" % (b.shape[0], n))
            k = b.shape[0] // n
            b = b.narrow(0, r * k, k)
        out.append(b)
    return out


def _pad_rows(x, n):
    """`x` with zero rows appended to make its leading dim a multiple of
    n."""
    pad = (-x.shape[0]) % n
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def _rank_rows(x, n, r):
    """Rank r's rows of `x` with its leading dim padded to a multiple of
    n (`_pad_rows`)."""
    k = (x.shape[0] + (-x.shape[0]) % n) // n
    return _pad_rows(x, n)[r * k:(r + 1) * k]


def _reached(loss, leaves):
    """The indices of `leaves` whose grad accumulators the autograd graph
    of `loss` reaches."""
    want = {id(x): i for i, x in enumerate(leaves)}
    seen, hit, stack = {}, set(), [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or id(fn) in seen:
            continue
        seen[id(fn)] = fn            # held: ids stay unique during the walk
        var = getattr(fn, "variable", None)
        if var is not None and id(var) in want:
            hit.add(want[id(var)])
        stack.extend(f for f, _ in fn.next_functions)
    return hit


class _IssueChain:
    """One step's gradient buckets under the backward's hooks: each
    leaf's grad taken from the leaf as it lands; once a bucket's leaves
    are all in, their grads are copied into the bucket (the pad and a
    missing grad zeros) and dropped, so a full grad lives no longer than
    its bucket takes to fill, and no bucket buffer exists before its
    grads do; with `overlap`, each full bucket's async reduce-scatter is
    issued in segment order. `finish` issues what is left, in order, and
    waits."""

    def __init__(self, layout, where, n_leaves, device, group, overlap):
        self.layout, self.where = layout, where
        self.n_leaves, self.device, self.group = n_leaves, device, group
        self.overlap = overlap
        self.grads = [{} for _ in layout]
        self.bufs = [None] * len(layout)
        self.left = [len(b.indices) for b in layout]
        self.out = [None] * len(layout)
        self.works = [None] * len(layout)
        self.next = 0
        self.hooks = 0
        self.issued_at = []      # (segment, hooks fired when issued)

    def skip(self, i):
        """Leaf i gets no grad this step (the loss does not reach it)."""
        self.left[self.where[i][0]] -= 1

    def hook(self, i):
        k = self.where[i][0]

        def on_grad(p):
            self.grads[k][i] = p.grad
            p.grad = None
            self.hooks += 1
            self.left[k] -= 1
            if self.left[k] == 0:
                self._pack(k)
            if self.overlap:
                self._issue_ready()

        return on_grad

    def _pack(self, k):
        leaves = [None] * self.n_leaves
        for i, g in self.grads[k].items():
            leaves[i] = g
        self.bufs[k] = amp.flatten_bucket(self.layout[k], leaves,
                                          device=self.device)
        self.grads[k] = None

    def _issue_ready(self):
        while self.next < len(self.layout) and self.left[self.next] == 0:
            self._issue(self.next)

    def _issue(self, k):
        if self.bufs[k] is None:
            self._pack(k)
        self.out[k], self.works[k] = C.zero_reduce_scatter(
            self.bufs[k], self.group, async_op=True)
        self.issued_at.append((self.layout[k].segment, self.hooks))
        self.next = k + 1

    def finish(self):
        """Issue the buckets still open, in order (a missing grad is
        zeros), and wait on every handle (the host's time in the waits
        counts to the reduce-scatter's ``host_seconds``). Returns the
        grad shards."""
        while self.next < len(self.layout):
            self._issue(self.next)
        t0 = time.perf_counter()
        for w in self.works:
            if w is not None:
                w.wait()
        C.host_seconds["zero_reduce_scatter"] += time.perf_counter() - t0
        self.bufs = None
        return self.out

    def record(self):
        return {"segments": [s for s, _ in self.issued_at],
                "hooks_after": [self.hooks - h for _, h in self.issued_at],
                "hooks": self.hooks}


class ShardedAdam:
    """Adam with dp-sharded state (the ZeRO ladder: see the module
    docstring).

    bucket_mb: flatten gradients into same-dtype buckets of this many
    MiB for the reduce-scatter (None reads $PTPU_AMP_BUCKET_MB; 0 or an
    unset environment = one collective a leaf).
    grad_dtype: the dtype gradients are cast to BEFORE the collective
    (e.g. torch.bfloat16: half the bytes on the wire); None keeps fp32.
    zero_stage: 1 (optimizer-state sharding, default), 2 (+ gradient
    sharding), 3 (+ parameter sharding). None reads $PTPU_ZERO_STAGE.
    overlap: issue the per-bucket collectives from the backward's hooks
    in backward order (None reads $PTPU_ZERO_OVERLAP; bitwise the same
    as overlap=False).
    offload: keep m and v in host memory between steps (None reads
    $PTPU_ZERO_OFFLOAD).

    Stages 2/3, overlap and offload all require bucketing. init_state
    latches the planned layout; make_step with a configuration that no
    longer matches the plan raises ZeroLayoutError."""

    def __init__(self, learning_rate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, axis_name="dp", grad_dtype=None,
                 bucket_mb=None, zero_stage=None, overlap=None,
                 offload=None):
        self.lr = learning_rate
        self.b1, self.b2, self.eps = beta1, beta2, epsilon
        self.axis = axis_name
        if isinstance(grad_dtype, str):
            grad_dtype = getattr(torch, grad_dtype)
        self.grad_dtype = grad_dtype
        self.bucket_mb = bucket_mb
        self.zero_stage = zero_stage
        self.overlap = overlap
        self.offload = offload
        self._plan = None      # resolved config latched by init_state
        self._layout = None    # bucket plan latched by init_state
        self._group = None     # the data group init_state planned over
        self._p_treedef = None
        self._p_template = None  # each leaf's shape and dtype (meta)

    # ------------------------------------------------------------------
    # configuration
    # ------------------------------------------------------------------
    def _bucket_bytes(self):
        if self.bucket_mb is not None:
            return amp.mb_to_bucket_bytes(self.bucket_mb)
        return amp.bucket_bytes_from_env(default_mb=None)

    def _resolve_config(self):
        """The effective (validated) configuration right now: constructor
        arguments win over the environment."""
        env_stage = _flags.env("PTPU_ZERO_STAGE")
        stage = self.zero_stage if self.zero_stage is not None \
            else (env_stage if env_stage is not None else 1)
        if stage not in (1, 2, 3):
            raise ValueError("zero_stage must be 1, 2 or 3, got %r"
                             % (stage,))
        overlap = self.overlap if self.overlap is not None \
            else _flags.env("PTPU_ZERO_OVERLAP")
        offload = self.offload if self.offload is not None \
            else _flags.env("PTPU_ZERO_OFFLOAD")
        bb = self._bucket_bytes()
        needs = [k for k, on in (("zero_stage>=2", stage >= 2),
                                 ("overlap", overlap),
                                 ("offload", offload)) if on]
        if needs and not bb:
            raise ValueError(
                "%s requires gradient bucketing: set bucket_mb (or "
                "$PTPU_AMP_BUCKET_MB) to a positive MiB size"
                % " + ".join(needs))
        return {"bucket_bytes": bb, "stage": stage,
                "overlap": bool(overlap), "offload": bool(offload),
                "grad_dtype": str(self.grad_dtype)}

    def _check_plan(self, what):
        """make_step's guard: the layout init_state planned must match
        the configuration in force NOW (a bucket_mb, $PTPU_AMP_BUCKET_MB,
        stage, overlap or offload changed between the two calls would
        pair a stale state layout with another step)."""
        cfg = self._resolve_config()
        if self._plan is None:
            if cfg["bucket_bytes"] or cfg["stage"] >= 2 or cfg["offload"]:
                raise ZeroLayoutError(
                    "%s: call init_state(params, mesh) before make_step — "
                    "this configuration (%r) needs a planned state layout"
                    % (what, cfg))
            return cfg
        if cfg != self._plan:
            raise ZeroLayoutError(
                "%s: configuration changed after init_state (planned %r, "
                "now %r) — call init_state(params, mesh) again to re-plan "
                "the state layout" % (what, self._plan, cfg))
        return cfg

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self, params, mesh):
        """{"m", "v", "step"} at zero, each of m and v this rank's
        shards: per-leaf, a tree like `params` of each leaf's padded
        rows; bucketed, a list of each bucket's padded/world slice (in
        host memory under offload, pinned on the card). The resolved
        configuration is LATCHED here: make_step checks that it still
        holds."""
        cfg = self._resolve_config()
        self._plan = cfg
        group = self._group = mesh.group
        n, dev = mesh.shape[self.axis], group.device
        flat, treedef = _flatten(params)
        self._p_treedef = treedef
        self._p_template = [torch.empty(p.shape, dtype=p.dtype,
                                        device="meta") for p in flat]
        step = torch.zeros((), dtype=torch.int32, device=dev)
        if not cfg["bucket_bytes"]:
            self._layout = None

            def zeros_shard(p):
                k = (p.shape[0] + (-p.shape[0]) % n) // n
                return torch.zeros((k,) + tuple(p.shape[1:]),
                                   dtype=torch.float32, device=dev)

            return {"m": _unflatten(treedef, [zeros_shard(p) for p in flat]),
                    "v": _unflatten(treedef, [zeros_shard(p) for p in flat]),
                    "step": step}
        gdt = self.grad_dtype if self.grad_dtype is not None \
            else torch.float32
        self._layout = amp.plan_buckets(
            flat, cfg["bucket_bytes"], pad_multiple=n, dtype=gdt,
            order="backward" if cfg["overlap"] else "forward")
        if cfg["offload"]:
            pin = dev.type == "cuda"

            def zeros_flat(b):
                return torch.zeros(b.padded // n, dtype=torch.float32,
                                   pin_memory=pin)

            step = step.cpu()
        else:
            def zeros_flat(b):
                return torch.zeros(b.padded // n, dtype=torch.float32,
                                   device=dev)

        return {"m": [zeros_flat(b) for b in self._layout],
                "v": [zeros_flat(b) for b in self._layout],
                "step": step}

    def _planned(self, what):
        if self._group is None:
            raise ZeroLayoutError("%s: no planned layout — call "
                                  "init_state(params, mesh) first" % what)
        return self._group

    def gather_state(self, state):
        """The global form of a state (the JAX step's): m and v as lists
        of every rank's shards gathered ("gather_state" collectives),
        each leaf's padded rows (per-leaf, in leaf order) or each padded
        bucket (bucketed, in plan order), and the step as an int."""
        group = self._planned("gather_state")

        def full(shard):
            dev_shard = shard.to(group.device)
            out = C.zero_all_gather(dev_shard.reshape(-1), group,
                                    kind="gather_state")
            return out.view((-1,) + tuple(shard.shape[1:]))

        ms = _flatten(state["m"])[0]
        vs = _flatten(state["v"])[0]
        return {"m": [full(m) for m in ms], "v": [full(v) for v in vs],
                "step": int(state["step"])}

    def shard_state(self, global_state):
        """This rank's state from a global one (`gather_state`'s form, or
        the JAX step's state as numpy arrays: m and v in the plan's leaf
        or bucket order, padded)."""
        group = self._planned("shard_state")
        n, r, dev = group.world, group.rank, group.device
        offload = self._plan["offload"]

        def own(a):
            a = torch.as_tensor(a, dtype=torch.float32)
            k = a.shape[0] // n
            part = a[r * k:(r + 1) * k].clone()
            if offload:
                return part.pin_memory() if dev.type == "cuda" else part
            return part.to(dev)

        m = [own(x) for x in global_state["m"]]
        v = [own(x) for x in global_state["v"]]
        if self._layout is None:
            m, v = (_unflatten(self._p_treedef, m),
                    _unflatten(self._p_treedef, v))
        step = torch.tensor(int(global_state["step"]), dtype=torch.int32)
        return {"m": m, "v": v,
                "step": step if offload else step.to(dev)}

    def leaf_state(self, global_state):
        """{"m", "v"}: per-leaf tensors of each leaf's shape (the pad cut)
        from a global state, in leaf order."""
        self._planned("leaf_state")
        out = {}
        for key in ("m", "v"):
            bufs = [torch.as_tensor(x) for x in global_state[key]]
            if self._layout is None:
                out[key] = [b[:t.shape[0]] for b, t in
                            zip(bufs, self._p_template)]
                continue
            leaves = [None] * len(self._p_template)
            for b, buf in zip(self._layout, bufs):
                for i, off, sz in zip(b.indices, b.offsets, b.sizes):
                    leaves[i] = buf[off:off + sz].view(
                        tuple(self._p_template[i].shape))
            out[key] = leaves
        return out

    # ------------------------------------------------------------------
    # ZeRO-3 parameter layout
    # ------------------------------------------------------------------
    def shard_params(self, params, mesh):
        """params tree -> list of this rank's flat fp32 bucket shards (the
        ZeRO-3 stored form: 1/world of the model a rank). Requires
        init_state: the bucket layout doubles as the parameter layout, so
        gradient and parameter shards stay aligned."""
        if self._layout is None:
            raise ZeroLayoutError(
                "shard_params: call init_state(params, mesh) first — the "
                "parameter shards follow the planned bucket layout")
        flat, treedef = _flatten(params)
        if treedef != self._p_treedef:
            raise ValueError("params structure does not match the tree "
                             "init_state planned for")
        n, r = mesh.shape[self.axis], mesh.group.rank
        out = []
        for b in self._layout:
            s = b.padded // n
            full = amp.flatten_bucket(b, flat, dtype=torch.float32,
                                      device=mesh.group.device)
            out.append(full[r * s:(r + 1) * s].clone())
        return out

    def gather_params(self, pshards):
        """The tree form of ZeRO-3 sharded parameters: each bucket's shards
        all-gathered ("gather_state": every rank calls it), the leaves in
        their original dtypes."""
        group = self._planned("gather_params")
        if self._layout is None:
            raise ZeroLayoutError("gather_params: no bucket layout — "
                                  "the per-leaf path keeps full params")
        if len(pshards) != len(self._layout):
            raise ZeroLayoutError(
                "gather_params: %d shard buffers for a %d-bucket layout "
                "(sharded under a different bucket plan?)"
                % (len(pshards), len(self._layout)))
        flat = [None] * len(self._p_template)
        for b, buf in zip(self._layout, pshards):
            full = C.zero_all_gather(buf, group, kind="gather_state")
            for i, seg in amp.unflatten_bucket(b, full,
                                               self._p_template).items():
                flat[i] = seg.clone()
        return _unflatten(self._p_treedef, flat)

    # ------------------------------------------------------------------
    # update math (shared by every path: the ladder changes data
    # movement, never the arithmetic)
    # ------------------------------------------------------------------
    def _local_update(self, g_shard, p_shard, m, v, t):
        """Adam on one shard, in the JAX step's order of operations; `t`
        the fp32 step (``b ** t`` an fp32 power). Returns (p, m, v)."""
        m = self.b1 * m + (1 - self.b1) * g_shard
        v = self.b2 * v + (1 - self.b2) * torch.square(g_shard)
        mhat = m / (1 - self.b1 ** t)
        vhat = v / (1 - self.b2 ** t)
        p_new = p_shard - self.lr * mhat / (torch.sqrt(vhat) + self.eps)
        return p_new, m, v

    @staticmethod
    def _mean_loss(loss, group):
        """The mean over the ranks of each rank's loss."""
        return C.zero_all_reduce(loss.detach(), group) / group.world

    # ------------------------------------------------------------------
    def make_step(self, mesh, loss_fn):
        """A callable (params, state, *batch) -> (params, state, loss):
        each rank's grads of its rows of the global batch reduce-scattered,
        the update computed on the local shards. Stages 1/2 update the
        leaves of `params` in place and return the same tree; under
        zero_stage=3 the params position holds `shard_params`' form and
        stays sharded. Under offload the callable has `close()` (its
        stager's worker)."""
        cfg = self._check_plan("make_step")
        if cfg["overlap"]:
            # with B buckets, the first B-1 collectives each have at least
            # one backward segment still to run; only overlap-enabled
            # steps write the gauge, so it reads as the most recent one's
            nb = len(self._layout)
            _metrics.gauge("zero/overlap_ratio").set(
                (nb - 1) / nb if nb else 0.0)
        if cfg["bucket_bytes"]:
            return self._make_step_bucketed(mesh, loss_fn, cfg)
        return self._make_step_per_leaf(mesh, loss_fn)

    # -- stage 1, one collective a leaf ---------------------------------
    def _make_step_per_leaf(self, mesh, loss_fn):
        group = mesh.group
        n, r = mesh.shape[self.axis], group.rank
        gdt = self.grad_dtype if self.grad_dtype is not None \
            else torch.float32

        def step(params, state, *batch):
            flat, tdef = _flatten(params)
            local = _local_rows(batch, group)
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_() for p in flat]
                loss = loss_fn(_unflatten(tdef, leaves), *local)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            del leaves
            loss = self._mean_loss(loss, group)
            t = state["step"] + 1
            tf = t.to(torch.float32)
            new_m, new_v = [], []
            with torch.no_grad():
                for p, g, m, v in zip(flat, grads, _flatten(state["m"])[0],
                                      _flatten(state["v"])[0]):
                    # grad_dtype applies BEFORE the collective (halved wire
                    # bytes); the fp32 cast follows the division
                    g = torch.zeros_like(p) if g is None else g
                    gs = C.zero_reduce_scatter(
                        _pad_rows(g.to(gdt), n).reshape(-1), group)
                    gs = (gs / n).to(torch.float32).view(m.shape)
                    pp = _rank_rows(p.to(torch.float32), n, r)
                    p_new, m, v = self._local_update(gs, pp, m, v, tf)
                    full = C.zero_all_gather(p_new.reshape(-1), group)
                    p.copy_(full.view((-1,) + tuple(p.shape[1:]))
                            [:p.shape[0]])
                    new_m.append(m)
                    new_v.append(v)
            return params, {"m": _unflatten(tdef, new_m),
                            "v": _unflatten(tdef, new_v), "step": t}, loss

        step.issue_record = None
        return step

    # -- stages 1/2/3, bucketed, with overlap and offload ---------------
    def _make_step_bucketed(self, mesh, loss_fn, cfg):
        """Same update math as per-leaf over a few large flat buckets:
        per bucket, the grads in one buffer in grad_dtype, ONE
        reduce-scatter, the update on the local slice, then (stages 1/2)
        an all-gather back into the leaves. The parameters flatten in
        fp32 whatever the wire dtype: rounding the master copy through
        bf16 would break the mixed-precision contract."""
        layout = self._layout
        group = mesh.group
        n, r, dev = mesh.shape[self.axis], group.rank, group.device
        stage3 = cfg["stage"] == 3
        overlap = cfg["overlap"]
        hooked = overlap or cfg["stage"] >= 2
        gdt = self.grad_dtype if self.grad_dtype is not None \
            else torch.float32
        tdef, template = self._p_treedef, self._p_template
        where = {}
        for k, b in enumerate(layout):
            for i, off, sz in zip(b.indices, b.offsets, b.sizes):
                where[i] = (k, off, sz)
        if stage3:
            _metrics.gauge("zero/gather_bytes").set(sum(
                b.padded * 4 for b in layout))
        # each returned step OWNS its stager: a re-made step must not
        # break callables handed out earlier
        stager = HostStateStager(dev) if cfg["offload"] else None

        def backward_scatter(pstate, batch):
            """Forward, backward and the per-bucket reduce-scatters:
            (this rank's loss, each bucket's fp32 grad shard)."""
            local = _local_rows(batch, group)
            if stage3:
                flat = [None] * len(template)
                for b, s in zip(layout, pstate):
                    full = C.zero_all_gather(s, group,
                                             kind="zero_param_gather")
                    for i, seg in amp.unflatten_bucket(b, full,
                                                       template).items():
                        flat[i] = seg
            else:
                flat, got = _flatten(pstate)
                if got != tdef:
                    raise ValueError("params structure does not match "
                                     "the tree init_state planned for")
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_() for p in flat]
                del flat                # stage 3: the leaves hold them
                loss = loss_fn(_unflatten(tdef, leaves), *local)
                if hooked:
                    chain = _IssueChain(layout, where, len(leaves), dev,
                                        group, overlap)
                    reached = _reached(loss, leaves)
                    for i in range(len(leaves)):
                        if i not in reached:
                            chain.skip(i)
                    handles = [x.register_post_accumulate_grad_hook(
                        chain.hook(i)) for i, x in enumerate(leaves)]
                    try:
                        loss.backward()
                    finally:
                        for h in handles:
                            h.remove()
                    del leaves          # stage 3: full params freed
                    gshards = chain.finish()
                    step.issue_record = chain.record()
                else:
                    grads = torch.autograd.grad(loss, leaves,
                                                allow_unused=True)
                    del leaves
                    gshards = [C.zero_reduce_scatter(amp.flatten_bucket(
                        b, grads, device=dev), group) for b in layout]
                    del grads
            # mean-reduce in the wire dtype, then fp32 (JAX's order)
            return loss.detach(), [(g / n).to(torch.float32)
                                   for g in gshards]

        def update(pstate, gshards, ms, vs, t):
            tf = t.to(torch.float32)
            flat = None if stage3 else _flatten(pstate)[0]
            new_p, new_m, new_v = [], [], []
            with torch.no_grad():
                for k, b in enumerate(layout):
                    s = b.padded // n
                    if stage3:
                        pshard = pstate[k]
                    else:
                        pshard = amp.flatten_bucket(
                            b, flat, dtype=torch.float32,
                            device=dev)[r * s:(r + 1) * s]
                    p_new, m, v = self._local_update(gshards[k], pshard,
                                                     ms[k], vs[k], tf)
                    new_m.append(m)
                    new_v.append(v)
                    if stage3:
                        new_p.append(p_new)
                        continue
                    full = C.zero_all_gather(p_new, group)
                    for i, off, sz in zip(b.indices, b.offsets, b.sizes):
                        flat[i].copy_(full[off:off + sz].view(
                            flat[i].shape))
            return (new_p if stage3 else pstate), new_m, new_v

        def step(pstate, state, *batch):
            # the H2D copy of m/v overlaps the backward; a failing compute
            # must not wedge the stager: abort drops the staged batch, so
            # a retry starts clean
            if stager is not None:
                stager.stage_in_begin(list(state["m"]) + list(state["v"]))
            try:
                loss, gshards = backward_scatter(pstate, batch)
                if stager is not None:
                    staged = stager.stage_in_end()
            except BaseException:
                if stager is not None:
                    stager.abort()
                raise
            loss = self._mean_loss(loss, group)
            if stager is not None:
                ms, vs = staged[:len(layout)], staged[len(layout):]
            else:
                ms, vs = state["m"], state["v"]
            t = state["step"].to(dev) + 1
            new_p, new_m, new_v = update(pstate, gshards, ms, vs, t)
            if stager is None:
                return new_p, {"m": new_m, "v": new_v, "step": t}, loss
            hosts = list(state["m"]) + list(state["v"])
            stager.stage_out(new_m + new_v, hosts)
            return new_p, {"m": hosts[:len(layout)],
                           "v": hosts[len(layout):], "step": t.cpu()}, loss

        step.issue_record = None
        if stager is not None:
            step.close = stager.close
        return step
