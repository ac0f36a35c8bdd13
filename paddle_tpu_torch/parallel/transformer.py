"""The SPMD Transformer trainer on ``torch.distributed``: the port of
``paddle_tpu/parallel/transformer.py`` (dp + pp + tp + sp + ep), name for
name.

The JAX package runs one ``shard_map`` over a ("dp", "pp", "tp") mesh.
The port runs one process a rank (`mesh.SPMDMesh`: NCCL on the card,
gloo on the CPU; rank = (d·pp + p)·tp + t, the JAX mesh's layout), and
each step computes what the ``shard_map`` step computes on the same
parameters and batch:

- dp: the batch's rows split over the data axis; each grad leaf summed
  over exactly the mesh axes it is replicated on (the axes absent from
  its spec, `_replicated_axes`).
- pp: the layers split on their leading [L] axis; the 1F1B schedule
  (`SPMDTrainer._pipeline_grads`), activations and their cotangents
  sent along the stage chain.
- tp: attention heads and FFN columns split (Megatron); K1 runs on each
  rank's H/tp local heads. sp on the same axis: the residual stream
  between blocks is sequence-split [B, T/tp, D], all-gathered before a
  block's products and reduce-scattered after (`_block_sp`).
- ep on the data axis: the top-1 switch MoE (`_moe_block`), tokens
  exchanged with all-to-all, E/dp experts a rank.

The collectives (``collective.py``) are autograd Functions with the
transposes ``shard_map`` applies (all-gather <-> reduce-scatter,
all-to-all <-> all-to-all), so autograd of the rank-local loss gives
the gradient of the global loss on the local shards. With ``cfg.remat``
each block and the MoE block run under non-reentrant
``torch.utils.checkpoint``: the recompute issues the block's tp and dp
collectives again inside the backward, and every rank of a group runs
the same graph, so they meet in one order (autograd's order on the
calling thread on the CPU, on its one device thread on a card).

`shard_params` / `gather_params` cut a full tree (``init_params``, or the
JAX package's through ``models.transformer.params_from_numpy``) into
this rank's shards and put them back together.
"""

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _checkpoint

from ..models import transformer as T
from . import collective as C
from .mesh import AXES, SPMDMesh

__all__ = ["SPMDTrainer", "gather_params", "param_specs", "shard_params"]


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------


def param_specs(cfg):
    """Each leaf's spec, a tuple of mesh axis names (or None) a dim, in a
    tree congruent with ``init_params``'s."""
    specs = {
        "embed": (None, None),
        "pos_embed": (None, None),
        "final_ln_scale": (None,),
        "final_ln_bias": (None,),
        "layers": {
            "ln1_scale": ("pp", None),
            "ln1_bias": ("pp", None),
            "wqkv": ("pp", None, None, "tp", None),
            "wo": ("pp", "tp", None, None),
            "ln2_scale": ("pp", None),
            "ln2_bias": ("pp", None),
            "w1": ("pp", None, "tp"),
            "b1": ("pp", "tp"),
            "w2": ("pp", "tp", None),
            "b2": ("pp", None),
        },
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, None)
    if cfg.n_experts:
        specs["moe"] = {
            "router": (None, None),
            "w1": ("dp", None, None),
            "w2": ("dp", None, None),
        }
    return specs


def _replicated_axes(spec, mesh_axes=AXES):
    used = set(a for a in spec if a is not None)
    return tuple(a for a in mesh_axes if a not in used)


def _map_spec(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_spec(fn, tree[k], specs[k]) for k in sorted(tree)}
    return fn(tree, specs)


def _unflatten(like, leaves):
    it = iter(leaves)
    return T.tree_map(lambda _: next(it), like)


def _local(t, spec, mesh):
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = mesh.axis_size(axis)
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.axis_index(axis) * size, size)
    return t.contiguous().to(mesh.device, copy=True)


def shard_params(tree, specs, mesh):
    """This rank's shard of every leaf of the full tree `tree` (by its
    spec and the rank's mesh coordinates), each a contiguous copy on the
    mesh's device. A tree of Adam moments takes the parameters' specs."""
    return _map_spec(lambda t, s: _local(t, s, mesh), tree, specs)


def _full(t, spec, mesh):
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.axis_size(axis) > 1:
            t = C.all_gather(t.detach(), mesh.group(axis), dim)
    return t


def gather_params(tree, specs, mesh):
    """The full tree back from every rank's shards (all-gathered over
    each leaf's sharded axes, in spec order); every rank gets it."""
    return _map_spec(lambda t, s: _full(t, s, mesh), tree, specs)


# ---------------------------------------------------------------------------
# rank-local building blocks
# ---------------------------------------------------------------------------


def _block_sp(lp, h_s, cfg, mesh):
    """One transformer block on a sequence-split residual stream h_s
    [B, T/tp, D]: all_gather over tp before the products, reduce_scatter
    after (the Megatron-SP seams)."""
    dtype = cfg.dtype
    tp = mesh.group("tp")
    x = T.layer_norm(h_s, lp["ln1_scale"], lp["ln1_bias"])
    x_full = C.all_gather(x, tp, 1)                          # [B, T, D]
    attn_s = C.reduce_scatter(T.attention_block(lp, x_full, dtype), tp, 1)
    h_s = h_s + attn_s
    x = T.layer_norm(h_s, lp["ln2_scale"], lp["ln2_bias"])
    x_full = C.all_gather(x, tp, 1)
    ffn_s = C.reduce_scatter(T.ffn_block(lp, x_full, dtype), tp, 1)
    # b2 is tp-replicated: added once, on the scattered output
    return h_s + ffn_s + lp["b2"].to(dtype)


def _route(x, router, cfg):
    """The switch's routing of tokens x [N, D]: the fp32 router softmax,
    each token's expert (argmax, the first of ties) and gate, the
    capacity ``int(capacity_factor · N / E) + 1`` on the local N, each
    token's position in its expert's capacity (a cumsum in token order)
    and whether it is kept. Returns (expert, gate, pos, keep, cap)."""
    E = cfg.n_experts
    gates = torch.softmax(x.float() @ router.float(), dim=-1)
    expert = gates.argmax(-1)                                 # [N]
    gate = gates.gather(-1, expert[:, None])[:, 0]
    cap = int(cfg.expert_capacity_factor * x.shape[0] / E) + 1
    onehot = F.one_hot(expert, E)                             # [N, E]
    pos = (torch.cumsum(onehot, 0) * onehot - 1).amax(-1)     # [N]
    return expert, gate, pos, pos < cap, cap


def _moe_block(mp, h_s, cfg, mesh):
    """Top-1 switch MoE on the local tokens, the experts split over the
    dp axis (expert parallelism). h_s: [B, t, D] -> the same."""
    dtype = cfg.dtype
    dp = mesh.group("dp")
    E = cfg.n_experts
    ep = dp.world
    e_local = E // ep
    B, t, D = h_s.shape
    x = h_s.reshape(B * t, D)
    expert, gate, pos1, keep, cap = _route(x, mp["router"], cfg)
    idx_e = torch.where(keep, expert, 0)
    idx_c = torch.where(keep, pos1, 0)
    # dispatch [E, cap, D]: a dropped token adds 0 to slot (0, 0)
    disp = x.new_zeros((E, cap, D)).index_put(
        (idx_e, idx_c), torch.where(keep[:, None], x, 0).to(dtype),
        accumulate=True)
    # expert group r's slice to rank r; dim 0 of the result indexes the
    # source rank
    recv = C.all_to_all(disp.reshape(ep, e_local, cap, D), dp)
    toks = recv.transpose(0, 1).reshape(e_local, ep * cap, D)
    a = torch.bmm(toks, mp["w1"].to(dtype))
    a = F.gelu(a, approximate="tanh")
    out = torch.bmm(a, mp["w2"].to(dtype))
    # route back: the inverse exchange
    out = out.reshape(e_local, ep, cap, D).transpose(0, 1)
    back = C.all_to_all(out, dp).reshape(E, cap, D)
    # combine, the gate in fp32
    y = back[idx_e, idx_c]                                    # [N, D]
    y = torch.where(keep[:, None], y, 0).float() * gate[:, None]
    return h_s + y.reshape(B, t, D).to(dtype)


def _stage_fn(stage_params, moe_params, h_s, cfg, layers_per_stage, mesh):
    """This pp rank's slice of the layers (and the MoE block, when
    given) on a sequence-split activation; each block under
    ``torch.utils.checkpoint`` with ``cfg.remat``."""
    def run(fn, p, h):
        if cfg.remat:
            return _checkpoint.checkpoint(fn, p, h, cfg, mesh,
                                          use_reentrant=False)
        return fn(p, h, cfg, mesh)

    for i in range(layers_per_stage):
        h_s = run(_block_sp, {k: v[i] for k, v in stage_params.items()},
                  h_s)
    if moe_params is not None:
        h_s = run(_moe_block, moe_params, h_s)
    return h_s


# ---------------------------------------------------------------------------
# the SPMD train step
# ---------------------------------------------------------------------------


class SPMDTrainer:
    """The multi-parallel train step of one rank.

    `cfg` a ``TransformerConfig``; `mesh_shape` (dp, pp, tp);
    `num_microbatches` defaults to pp (the least for a full pipeline);
    Adam's `learning_rate`, `adam_b1`, `adam_b2` (eps 1e-8). The mesh
    (``SPMDMesh``, `mesh`) comes up on `device` (None:
    ``cuda:<rank % cards>``, raising without CUDA; "cpu": gloo).

    ``init(seed)`` draws the full tree (``init_params`` from a generator
    seeded `seed`: the port's draw, not the JAX key's) or takes `params`,
    a full tree, and returns this rank's state (params, m, v, step): the
    parameters' shards, fp32 moments at zero, an int32 step counter.
    ``step(state, tokens, labels)`` takes the global batch [B, T] (each
    rank reads its dp rows), updates the state's tensors in place and
    returns (state, loss), the loss the global mean cross-entropy (an
    fp32 0-dim tensor, every rank's the same). `counts` holds this
    rank's calls of the embedding ("embed") and the vocab head ("head")
    and the most microbatch inputs the pipeline's stash held at once
    ("stash_peak")."""

    def __init__(self, cfg, mesh_shape=(1, 1, 1), num_microbatches=None,
                 learning_rate=1e-3, adam_b1=0.9, adam_b2=0.98, device=None):
        dp, pp, tp = mesh_shape = tuple(mesh_shape)
        if cfg.n_layers % pp:
            raise ValueError("pp (%d) must divide n_layers (%d)"
                             % (pp, cfg.n_layers))
        if cfg.n_heads % tp or cfg.d_ff % tp:
            raise ValueError("tp (%d) must divide n_heads (%d) and d_ff "
                             "(%d)" % (tp, cfg.n_heads, cfg.d_ff))
        if cfg.max_seq_len % tp:
            raise ValueError("tp (%d) must divide max_seq_len (%d) for "
                             "sequence parallelism" % (tp, cfg.max_seq_len))
        if cfg.n_experts and cfg.n_experts % dp:
            raise ValueError("dp (%d) must divide n_experts (%d) for expert "
                             "parallelism" % (dp, cfg.n_experts))
        self.cfg = cfg
        self.mesh_shape = mesh_shape
        self.specs = param_specs(cfg)
        self._flat_specs = T.tree_leaves(self.specs)
        # groups for the single axes, the loss's three and each union a
        # grad leaf is summed over, and no other
        self.mesh = SPMDMesh(mesh_shape, device, unions=[
            a for a in map(_replicated_axes, self._flat_specs) if a])
        self.device = self.mesh.device
        self.M = num_microbatches or max(pp, 1)
        self.learning_rate = learning_rate
        self.adam_b1, self.adam_b2 = adam_b1, adam_b2
        self.layers_per_stage = cfg.n_layers // pp
        self.counts = {"embed": 0, "head": 0, "stash_peak": 0}

    # -- state ---------------------------------------------------------------
    def init(self, seed=0, params=None):
        if params is None:
            params = T.init_params(
                self.cfg, generator=torch.Generator().manual_seed(seed),
                device="cpu")
        zeros = T.tree_map(lambda p: torch.zeros(p.shape,
                                                 dtype=torch.float32),
                           params)
        return self.shard_state((params, zeros, zeros,
                                 torch.zeros((), dtype=torch.int32)))

    def shard_state(self, full_state):
        """This rank's state from a full (params, m, v, step)."""
        params, m, v, step = full_state
        return (shard_params(params, self.specs, self.mesh),
                shard_params(m, self.specs, self.mesh),
                shard_params(v, self.specs, self.mesh),
                torch.as_tensor(step, dtype=torch.int32).to(self.device,
                                                            copy=True))

    def gather_state(self, state):
        """The full (params, m, v, step) from every rank's state."""
        params, m, v, step = state
        return (gather_params(params, self.specs, self.mesh),
                gather_params(m, self.specs, self.mesh),
                gather_params(v, self.specs, self.mesh), step.clone())

    # -- the pieces of a step ------------------------------------------------
    def _seq_shard(self, x):
        tp = self.mesh.axis_size("tp")
        ts = x.shape[1] // tp
        return x[:, self.mesh.axis_index("tp") * ts:][:, :ts]

    def _embed(self, params, tokens):
        """The embedding of tokens [b, T], this tp rank's sequence
        shard."""
        self.counts["embed"] += 1
        return self._seq_shard(T.embed_tokens(params, tokens, self.cfg))

    def _head(self, params, h, labels, total_tokens):
        """The final layer norm, the full-vocab fp32 logits and this
        shard's summed -log p of `labels` over `total_tokens`."""
        self.counts["head"] += 1
        h = T.layer_norm(h, params["final_ln_scale"], params["final_ln_bias"])
        logp = torch.log_softmax(T.lm_logits(params, h, self.cfg), dim=-1)
        picked = logp.gather(-1, self._seq_shard(labels).long()[..., None])
        return -picked.sum() / total_tokens

    def _stage(self, layers, moe, h):
        return _stage_fn(layers, moe, h, self.cfg, self.layers_per_stage,
                         self.mesh)

    def _local_grads(self, params, tokens, labels):
        """pp == 1: the rank-local loss (embed, this tp rank's sequence
        shard, the stage, the head), whose sum over all ranks is the
        global mean; (contribution, grads in tree_leaves order)."""
        dp = self.mesh.axis_size("dp")
        B_local, T_full = tokens.shape
        leaves = [p.detach().requires_grad_()
                  for p in T.tree_leaves(params)]
        tree = _unflatten(params, leaves)
        with torch.enable_grad():
            h = self._embed(tree, tokens)
            h = self._stage(tree["layers"], tree.get("moe"), h)
            loss = self._head(tree, h, labels, B_local * T_full * dp)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

    def _accumulate(self, acc, grads, microbatch):
        for a, g in zip(acc, grads):
            a.add_(g.float())

    def _pipeline_grads(self, params, tokens, labels):
        """pp > 1: the 1F1B schedule over K = M + 2pp - 2 ticks. Stage r
        forwards microbatch t - r at tick t and backwards microbatch
        t - (2pp - 2 - r): the last stage turns around at once, so the
        backward drains while the forward fills, and the stash of stage
        inputs holds at most 2pp microbatches (a ring of 2pp slots). The
        backward unit recomputes the stage from its stashed input. Only
        stage 0 embeds and only the last stage runs the head. A tick
        whose microbatch lies outside [0, M) is skipped on every rank of
        the stage alike (the JAX scan runs it on garbage and masks it
        out), and a send and its receive are issued at the same tick on
        both ends. Returns (the rank's loss contribution, fp32 grads in
        tree_leaves order)."""
        cfg, mesh = self.cfg, self.mesh
        dp, pp = mesh.axis_size("dp"), mesh.axis_size("pp")
        r = mesh.axis_index("pp")
        group = mesh.group("pp")
        prev_rank = group.ranks[r - 1] if r > 0 else None
        next_rank = group.ranks[r + 1] if r < pp - 1 else None
        M = self.M
        B_local, T_full = tokens.shape
        mb = B_local // M
        total_tokens = B_local * T_full * dp
        microtoks = tokens.reshape(M, mb, T_full)
        microlabs = labels.reshape(M, mb, T_full)
        act_shape = (mb, T_full // mesh.axis_size("tp"), cfg.d_model)

        def leaves_of(tree):
            return [p.detach().requires_grad_() for p in T.tree_leaves(tree)]

        lp = params["layers"]
        lp_leaves = leaves_of(lp)
        lp_req = _unflatten(lp, lp_leaves)
        mp = params.get("moe")
        mp_leaves = leaves_of(mp) if mp is not None else []
        mp_req = _unflatten(mp, mp_leaves) if mp is not None else None
        emb_keys = ["embed", "pos_embed"]
        head_keys = ["final_ln_scale", "final_ln_bias"] + (
            ["embed"] if cfg.tie_embeddings else ["lm_head"])
        emb_leaves = [params[k].detach().requires_grad_() for k in emb_keys]
        head_leaves = [params[k].detach().requires_grad_()
                       for k in head_keys]

        def f32z(ts):
            return [torch.zeros(t.shape, dtype=torch.float32,
                                device=t.device) for t in ts]

        gL, gM, gE, gH = (f32z(lp_leaves), f32z(mp_leaves),
                          f32z(emb_leaves), f32z(head_leaves))
        loss_acc = torch.zeros((), dtype=torch.float32, device=self.device)
        ring = 2 * pp
        stash = {}
        fwd_recv = bwd_recv = None

        def valid(i):
            return 0 <= i < M

        for t in range(M + 2 * pp - 2):
            # ---- forward unit: microbatch t - r ----
            i_f = t - r
            h_out = None
            if valid(i_f):
                with torch.no_grad():
                    h_in = (self._embed(params, microtoks[i_f]) if r == 0
                            else fwd_recv)
                    h_out = self._stage(lp, mp, h_in)
                if i_f % ring in stash:
                    raise RuntimeError("the pipeline's stash slot %d is "
                                       "still held" % (i_f % ring))
                stash[i_f % ring] = h_in
                self.counts["stash_peak"] = max(self.counts["stash_peak"],
                                                len(stash))
            # ---- backward unit: microbatch t - (2pp - 2 - r) ----
            i_b = t - (2 * pp - 2 - r)
            g_in = None
            if valid(i_b):
                with torch.enable_grad():
                    if r == pp - 1:
                        # the forward of i_b ran this tick
                        h = h_out.detach().requires_grad_()
                        head = dict(params, **dict(zip(head_keys,
                                                       head_leaves)))
                        loss_i = self._head(head, h, microlabs[i_b],
                                            total_tokens)
                        gh_i = torch.autograd.grad(loss_i,
                                                   head_leaves + [h])
                        g_out = gh_i[-1]
                        self._accumulate(gH, gh_i[:-1], i_b)
                        loss_acc = loss_acc + loss_i.detach()
                    else:
                        g_out = bwd_recv
                    h_in_b = stash.pop(i_b % ring).detach().requires_grad_()
                    out = self._stage(lp_req, mp_req, h_in_b)
                    g = torch.autograd.grad(out, lp_leaves + mp_leaves
                                            + [h_in_b], g_out)
                    self._accumulate(gL, g[:len(lp_leaves)], i_b)
                    self._accumulate(gM, g[len(lp_leaves):-1], i_b)
                    g_in = g[-1]
                    if r == 0:
                        emb = dict(params, **dict(zip(emb_keys, emb_leaves)))
                        ge_i = torch.autograd.grad(
                            self._embed(emb, microtoks[i_b]), emb_leaves,
                            g_in)
                        self._accumulate(gE, ge_i, i_b)
            # ---- the chain exchanges: a receive is posted exactly when
            # its sender's unit was valid ----
            sends, recvs = [], []
            if next_rank is not None and h_out is not None:
                sends.append((h_out, next_rank))
            if prev_rank is not None and valid(t - (r - 1)):
                fwd_recv = torch.empty(act_shape, dtype=cfg.dtype,
                                       device=self.device)
                recvs.append((fwd_recv, prev_rank))
            if prev_rank is not None and g_in is not None:
                sends.append((g_in, prev_rank))
            if next_rank is not None and valid(t - (2 * pp - 3 - r)):
                bwd_recv = torch.empty(act_shape, dtype=cfg.dtype,
                                       device=self.device)
                recvs.append((bwd_recv, next_rank))
            C.send_recv(sends, recvs, group)

        grads = dict(zip(head_keys, gH))
        grads["embed"] = gE[0] + grads["embed"] if cfg.tie_embeddings \
            else gE[0]
        grads["pos_embed"] = gE[1]
        grads["layers"] = _unflatten(lp, gL)
        if mp is not None:
            grads["moe"] = _unflatten(mp, gM)
        return loss_acc, T.tree_leaves(grads)

    def _sum_grads(self, grads):
        """Each leaf summed over the axes it is replicated on: the leaves
        of one union of axes in one bucket, the unions in the order
        their first leaf comes."""
        by_axes = {}
        for i, spec in enumerate(self._flat_specs):
            axes = _replicated_axes(spec)
            if axes:
                by_axes.setdefault(axes, []).append(i)
        grads = list(grads)
        for axes, idx in by_axes.items():
            summed = C.psum_leaves([grads[i] for i in idx],
                                   self.mesh.group(axes))
            for i, g in zip(idx, summed):
                grads[i] = g
        return grads

    def _adam(self, params, grads, m, v, step):
        """Adam on the local shards in fp32 state, in JAX's order of
        operations; each new parameter cast to its leaf's dtype."""
        lr, b1, b2 = self.learning_rate, self.adam_b1, self.adam_b2
        stepf = (step + 1).to(torch.float32)
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf
        with torch.no_grad():
            for p, g, mm, vv in zip(T.tree_leaves(params), grads,
                                    T.tree_leaves(m), T.tree_leaves(v)):
                gf = g.float()
                m2 = b1 * mm + (1 - b1) * gf
                v2 = b2 * vv + (1 - b2) * gf * gf
                p.copy_(p - lr * (m2 / bc1) / (torch.sqrt(v2 / bc2) + 1e-8))
                mm.copy_(m2)
                vv.copy_(v2)
            step.add_(1)

    # -- API -----------------------------------------------------------------
    def step(self, state, tokens, labels):
        params, m, v, step = state
        dp = self.mesh.axis_size("dp")
        tokens = torch.as_tensor(tokens).to(self.device)
        labels = torch.as_tensor(labels).to(self.device)
        B, T_full = tokens.shape
        tp = self.mesh.axis_size("tp")
        if B % dp or T_full % tp or (B // dp) % self.M:
            raise ValueError(
                "batch %r: dp (%d) must divide the rows, tp (%d) the "
                "length, and the %d microbatches each rank's rows"
                % ((B, T_full), dp, tp, self.M))
        rows = B // dp
        d = self.mesh.axis_index("dp")
        tokens = tokens[d * rows:(d + 1) * rows]
        labels = labels[d * rows:(d + 1) * rows]
        if self.mesh.axis_size("pp") == 1:
            contrib, grads = self._local_grads(params, tokens, labels)
        else:
            contrib, grads = self._pipeline_grads(params, tokens, labels)
        grads = self._sum_grads(grads)
        # the contribution carries the whole 1/total_tokens scaling
        loss, = C.psum_leaves([contrib.float()], self.mesh.group(AXES))
        self._adam(params, grads, m, v, step)
        return (params, m, v, step), loss
