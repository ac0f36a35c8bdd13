"""Decode-side transformer for the serving runtime of the PyTorch port.

  * ``GenerationConfig`` — the decoder-only architecture hyperparameters
    (the shape of ``models/transformer_fluid.build`` in the JAX package:
    pre-LN blocks, fused QKV, exact-erf gelu FFN, sinusoidal position
    encoding, untied LM head).
  * ``GenerationModel`` — an ``nn.Module`` holding the weights on one
    device; ``decode_step`` is the fixed-shape continuous-batching step
    over a ``KVBlockPool`` (one token per batch slot, cache reads and
    writes through block tables, attention by the paged-attention
    kernel).
  * ``reference_decode`` — an unbatched, unpaged numpy greedy decoder
    over a contiguous cache: the oracle the batched paged step is held
    to token for token.
  * speculative decoding: ``spec_step`` (the linear verify window),
    ``spec_tree_step`` (the tree verify window over the level-order
    token tree of ``tree_topology``), ``tree_commit`` (the accepted
    path's KV compaction) and ``NGramDrafter`` (prompt-lookup drafting
    over a sequence's own history).

The weight layout is the JAX package's flat dict (``weight_names``),
the layout its ``__generation__.npz`` artifact holds, so
``GenerationModel.from_jax_weights`` serves the JAX model's weights.

The steps' calling conventions (all shapes fixed per engine):

    decode_step(kv_k, kv_v, prompt_feed, use_prompt, prev_tokens,
                positions, block_tables, active, weights=None,
                return_logits=False) -> next_tokens [, logits]
    spec_step(kv_k, kv_v, window_tokens, use_prompt, prev_tokens,
              positions, lengths, block_tables, active, weights=None,
              return_logits=False) -> next_tokens [B, C] [, logits]
    spec_tree_step(..., active, tree, weights=None, return_logits=False)
    tree_commit(kv_k, kv_v, positions, src_slots, n_commit,
                block_tables, active)

``prev_tokens`` is the device token vector the previous step returned:
decode-phase slots chain their input token on device, prefill-phase
slots override it with ``prompt_feed`` under ``use_prompt``. Inactive
slots route their cache writes to the pool's null block and their
outputs are ignored. ``kv_k``/``kv_v`` are updated in place.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.place import resolve_device
from ..ops import paged_attention as _pa
from ..ops import paged_attention_tree as _pat

# fp32 matmuls and convolutions run in full fp32, not TF32: greedy
# tokens are held identical to the fp32 reference decoder
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["GenerationConfig", "GenerationModel", "NGramDrafter",
           "parse_tree_shape", "random_weights", "reference_decode",
           "tree_topology", "weight_names"]


def parse_tree_shape(spec):
    """Parse a ``PTPU_SERVE_SPEC_TREE`` value: ``"WxD"`` (e.g. ``"2x3"``
    = width 2, depth 3) -> ``(width, depth)``; empty/None/off -> None
    (tree speculation disabled, the linear window)."""
    if not spec:
        return None
    if isinstance(spec, (tuple, list)):
        w, d = spec
    else:
        s = str(spec).strip().lower()
        if s in ("", "0", "off", "false", "no"):
            return None
        if "x" not in s:
            raise ValueError(
                "spec tree shape must look like 'WxD' (width x depth, "
                "e.g. '2x3'), got %r" % (spec,))
        w, d = s.split("x", 1)
    w, d = int(w), int(d)
    if w < 1 or d < 1:
        raise ValueError(
            "spec tree width and depth must be >= 1, got %dx%d" % (w, d))
    return w, d


def tree_topology(width, depth):
    """Static topology of the speculative token tree: ``width``
    root-anchored chains of ``depth`` draft slots in LEVEL-ORDER layout,
    slot 0 the root (the row's last committed token). Level ``l``
    (1-based) of chain ``c`` is slot ``1 + (l - 1) * width + c``; its
    parent is the same chain one level up (the root at ``l == 1``).
    Level order means any slot-prefix of the window is itself a valid
    (shallower) tree, so a row's depth clamp is its window length.

    Returns ``(parents, depths, anc)`` — int32 ``[C]``, int32 ``[C]``
    and bool ``[C, C]`` for ``C = 1 + width * depth``, with
    ``anc[j, t]`` true iff slot ``t`` is ``j`` or an ancestor of ``j``
    (slot ``j``'s in-window attention visibility: exactly its own root
    path, sibling branches mutually invisible)."""
    width, depth = int(width), int(depth)
    C = 1 + width * depth
    parents = np.zeros(C, np.int32)
    depths = np.zeros(C, np.int32)
    for level in range(1, depth + 1):
        for c in range(width):
            s = 1 + (level - 1) * width + c
            parents[s] = 0 if level == 1 else s - width
            depths[s] = level
    anc = np.zeros((C, C), bool)
    for s in range(C):
        anc[s, s] = True
        j = s
        while j:
            j = int(parents[j])
            anc[s, j] = True
    return parents, depths, anc


class GenerationConfig:
    """Decoder-only LM hyperparameters (transformer_fluid.build shape)."""

    def __init__(self, vocab_size, d_model, n_heads, n_layers, d_ff,
                 max_seq_len=512, pe_alpha=1.0, pe_beta=1.0):
        if d_model % n_heads:
            raise ValueError("n_heads must divide d_model")
        self.vocab_size = int(vocab_size)
        self.d_model = int(d_model)
        self.n_heads = int(n_heads)
        self.n_layers = int(n_layers)
        self.d_ff = int(d_ff)
        self.max_seq_len = int(max_seq_len)
        self.pe_alpha = float(pe_alpha)
        self.pe_beta = float(pe_beta)

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


# weight-name layout: one flat dict, per-layer names carry an l<i>/
# prefix; everything is fp32
_LAYER_KEYS = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wproj", "bproj",
               "ln2_scale", "ln2_bias", "wff1", "bff1", "wff2", "bff2")


def weight_names(config):
    names = ["embedding", "lm_head", "final_ln_scale", "final_ln_bias"]
    for i in range(config.n_layers):
        names.extend("l%d/%s" % (i, k) for k in _LAYER_KEYS)
    return names


def _position_encoding_table(config):
    """The ``add_position_encoding`` table:
    pe[t] = [sin(t/10000^(2i/d)) | cos(...)]."""
    d = config.d_model
    pos = np.arange(config.max_seq_len)[:, None]
    i = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / d)
    return np.concatenate([np.sin(angle), np.cos(angle)],
                          axis=1).astype(np.float32)


def random_weights(config, seed=0, scale=0.1):
    """Deterministic random weights from a numpy seed: a servable model
    with no training behind it. The same seed gives the same weights as
    the JAX package's ``random_weights``."""
    rng = np.random.RandomState(seed)
    D, F_, V = config.d_model, config.d_ff, config.vocab_size

    def w(*shape):
        return (rng.randn(*shape) * scale).astype(np.float32)

    weights = {
        "embedding": w(V, D),
        "lm_head": w(D, V),
        "final_ln_scale": np.ones(D, np.float32),
        "final_ln_bias": np.zeros(D, np.float32),
    }
    for i in range(config.n_layers):
        p = "l%d/" % i
        weights[p + "ln1_scale"] = np.ones(D, np.float32)
        weights[p + "ln1_bias"] = np.zeros(D, np.float32)
        weights[p + "wqkv"] = w(D, 3 * D)
        weights[p + "bqkv"] = np.zeros(3 * D, np.float32)
        weights[p + "wproj"] = w(D, D)
        weights[p + "bproj"] = np.zeros(D, np.float32)
        weights[p + "ln2_scale"] = np.ones(D, np.float32)
        weights[p + "ln2_bias"] = np.zeros(D, np.float32)
        weights[p + "wff1"] = w(D, F_)
        weights[p + "bff1"] = np.zeros(F_, np.float32)
        weights[p + "wff2"] = w(F_, D)
        weights[p + "bff2"] = np.zeros(D, np.float32)
    return weights


def _buffer_name(weight_name):
    return weight_name.replace("/", "__")


def _ln(h, scale, bias):
    mu = h.mean(dim=-1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
    return (h - mu) * torch.rsqrt(var + 1e-5) * scale + bias


class GenerationModel(nn.Module):
    """Config + fp32 weights on one device + the decode step.

    ``device=None`` is ``cuda:0`` and raises without CUDA; pass
    ``device="cpu"`` for the plain PyTorch path. On a CUDA device the
    paged-attention kernel is built (if needed) and loaded here, so a
    failing ``nvcc`` raises to the caller."""

    def __init__(self, config, weights, name="model", device=None):
        super().__init__()
        self.config = config
        self.name = name
        self.device = resolve_device(device)
        missing = [n for n in weight_names(config) if n not in weights]
        if missing:
            raise ValueError("missing weights: %s" % missing[:4])
        self._weight_names = weight_names(config)
        for n in self._weight_names:
            t = torch.from_numpy(np.array(weights[n], np.float32))
            self.register_buffer(_buffer_name(n),
                                 t.to(self.device).contiguous())
        self.register_buffer(
            "pe", torch.from_numpy(_position_encoding_table(config))
            .to(self.device))
        self._trees = {}  # (width, depth) -> (depths, anc) on the device
        if self.device.type == "cuda":
            _pa.load()

    @classmethod
    def random(cls, config, seed=0, name="model", device=None):
        return cls(config, random_weights(config, seed), name=name,
                   device=device)

    @classmethod
    def from_jax_weights(cls, config, weights_np, name="model",
                         device=None):
        """The port's model over the JAX model's flat weight dict, given
        as numpy arrays (``{k: np.asarray(v) for k, v in
        jax_model.weights.items()}``, or the arrays of a
        ``__generation__.npz``): it computes the same function."""
        return cls(config, weights_np, name=name, device=device)

    @property
    def weights(self):
        """{weight name: tensor} in the flat JAX layout."""
        return {n: getattr(self, _buffer_name(n))
                for n in self._weight_names}

    @torch.no_grad()
    def decode_step(self, kv_k, kv_v, prompt_feed, use_prompt, prev_tokens,
                    positions, block_tables, active, weights=None,
                    return_logits=False):
        """One fixed-shape greedy step for every batch slot (the
        counterpart of the JAX ``make_decode_step`` step). All tensors on
        the model's device: ``prompt_feed``/``prev_tokens``/``positions``
        int [B], ``use_prompt``/``active`` bool [B], ``block_tables``
        int32 [B, Mb]. Writes this token's K/V into the pool in place and
        returns ``next_tokens`` int32 [B] (and fp32 ``logits`` [B, V]
        with ``return_logits``). It is the verify window at C = 1: every
        row feeds one slot, so the paged-attention kernel runs at C = 1."""
        out = self._window_step(kv_k, kv_v, prompt_feed[:, None], use_prompt,
                                prev_tokens, positions,
                                torch.ones_like(positions), block_tables,
                                active, weights, return_logits, tree=None)
        if return_logits:
            return out[0][:, 0], out[1][:, 0]
        return out[:, 0]

    @torch.no_grad()
    def spec_step(self, kv_k, kv_v, window_tokens, use_prompt, prev_tokens,
                  positions, lengths, block_tables, active, weights=None,
                  return_logits=False):
        """The speculative linear **verify window** (the counterpart of
        the JAX ``make_spec_step`` step): ``window_tokens`` int [B, C]
        holds each row's last committed token and up to C - 1 drafts,
        ``lengths`` int [B] how many slots each row feeds; the rest as
        in ``decode_step``. Window slot ``j`` of row ``b`` processes
        position ``positions[b] + j``. Returns ``next_tokens`` int32
        [B, C], the greedy token AFTER each slot (and fp32 ``logits``
        [B, C, V]): acceptance is the longest draft prefix with
        ``window[j + 1] == next_tokens[j]``. Slots at or past
        ``lengths[b]`` write to the null block; their outputs are
        meaningless. Attention is the paged-attention kernel (K2) at
        C = window."""
        return self._window_step(kv_k, kv_v, window_tokens, use_prompt,
                                 prev_tokens, positions, lengths,
                                 block_tables, active, weights,
                                 return_logits, tree=None)

    @torch.no_grad()
    def spec_tree_step(self, kv_k, kv_v, window_tokens, use_prompt,
                       prev_tokens, positions, lengths, block_tables,
                       active, tree, weights=None, return_logits=False):
        """The speculative **tree verify window** (the counterpart of
        the JAX ``make_spec_tree_step`` step) over ``tree = (width,
        depth)``: ``window_tokens`` [B, C = 1 + width * depth] holds a
        level-order token tree (``tree_topology``), slot 0 each row's
        last committed token. Slot ``j`` writes its KV at cache position
        ``positions[b] + j`` but is encoded at position ``positions[b] +
        depth[j]`` and attends the committed prefix plus its own root
        path only (the tree-mask kernel, K3). ``next_tokens[b, j]`` is
        the greedy token after slot ``j``'s root path; the host walk
        ``scheduler.spec_tree_acceptance`` picks the accepted path. Rows
        may feed any level-order prefix of the tree via ``lengths``."""
        return self._window_step(kv_k, kv_v, window_tokens, use_prompt,
                                 prev_tokens, positions, lengths,
                                 block_tables, active, weights,
                                 return_logits, tree=tree)

    def _tree_tensors(self, width, depth):
        """(depths int64 [C], anc bool [C, C]) of the tree on the
        model's device, made once per shape."""
        key = (int(width), int(depth))
        if key not in self._trees:
            _parents, depths, anc = tree_topology(*key)
            self._trees[key] = (
                torch.from_numpy(depths).long().to(self.device),
                torch.from_numpy(anc).to(self.device).contiguous())
        return self._trees[key]

    def _window_step(self, kv_k, kv_v, window_tokens, use_prompt,
                     prev_tokens, positions, lengths, block_tables, active,
                     weights, return_logits, tree):
        """The shared body of ``spec_step`` and ``spec_tree_step``: the
        root token splice, embeddings, position encodings (window offset,
        or tree depth) and the all-slots forward."""
        cfg = self.config
        w = self.weights if weights is None else weights
        C = window_tokens.shape[1]
        tok0 = torch.where(use_prompt, window_tokens[:, 0], prev_tokens)
        tok = torch.cat([tok0[:, None], window_tokens[:, 1:]], dim=1)
        tok = tok.long().clamp(0, cfg.vocab_size - 1)
        offsets = torch.arange(C, dtype=torch.int32, device=tok.device)
        pos2d = positions.to(torch.int32)[:, None] + offsets[None, :]
        if tree is None:
            anc = None
            pe_idx = pos2d.long()
        else:
            depths, anc = self._tree_tensors(*tree)
            if anc.shape[0] != C:
                raise ValueError("a %dx%d tree window holds %d slots, "
                                 "got window_tokens of %d"
                                 % (tree[0], tree[1], anc.shape[0], C))
            # a tree slot's logical position is root + its depth
            # (siblings share one); its cache slot stays pos + j
            pe_idx = positions.long()[:, None] + depths[None, :]
        pe_idx = pe_idx.clamp(0, cfg.max_seq_len - 1)
        x = (w["embedding"][tok] * (float(cfg.d_model) ** 0.5)
             * cfg.pe_alpha + cfg.pe_beta * self.pe[pe_idx])
        logits = self._forward_window(w, x, pos2d, lengths, block_tables,
                                      active, kv_k, kv_v, anc)
        next_tokens = logits.argmax(dim=-1).to(torch.int32)
        if return_logits:
            return next_tokens, logits
        return next_tokens

    def _forward_window(self, w, x, pos2d, lengths, block_tables, active,
                        kv_k, kv_v, anc):
        """A [B, C] token window through all layers (the JAX
        ``_forward_chunk`` with ``all_slots=True``). x: [B, C, D]; pos2d
        int32 [B, C] the cache position of each slot. Writes the
        window's K/V before attending, so each slot sees itself; with
        ``anc`` (bool [C, C]) in-window visibility is the tree mask.
        Returns logits at every slot, [B, C, V]."""
        cfg = self.config
        B, C = x.shape[0], x.shape[1]
        H, Dh, D = cfg.n_heads, cfg.head_dim, cfg.d_model
        bs = kv_k.shape[2]
        Mb = block_tables.shape[1]
        sm_scale = Dh ** -0.5

        # slots past a row's length, and inactive rows, write to the
        # null block (a stale position is clamped into the table first)
        pos = pos2d.long()
        offsets = torch.arange(C, device=pos.device)
        valid = ((offsets[None, :] < lengths.long()[:, None])
                 & active[:, None])
        table_blk = block_tables.gather(1, (pos // bs).clamp(0, Mb - 1))
        write_blk = torch.where(valid, table_blk.long(),
                                torch.zeros_like(pos))
        slot_idx = pos % bs

        for i in range(cfg.n_layers):
            p = "l%d/" % i
            a = _ln(x, w[p + "ln1_scale"], w[p + "ln1_bias"])
            qkv = a @ w[p + "wqkv"] + w[p + "bqkv"]
            q, k_new, v_new = qkv.split(D, dim=-1)
            kv_k[i].index_put_((write_blk, slot_idx),
                               k_new.reshape(B, C, H, Dh))
            kv_v[i].index_put_((write_blk, slot_idx),
                               v_new.reshape(B, C, H, Dh))
            q = q.reshape(B, C, H, Dh).contiguous()
            if anc is None:
                ctx = _pa.paged_attention(kv_k[i], kv_v[i], q, block_tables,
                                          pos2d, sm_scale=sm_scale)
            else:
                ctx = _pat.paged_attention_tree(kv_k[i], kv_v[i], q,
                                                block_tables, pos2d, anc,
                                                sm_scale=sm_scale)
            x = x + ctx.reshape(B, C, D) @ w[p + "wproj"] + w[p + "bproj"]
            b2 = _ln(x, w[p + "ln2_scale"], w[p + "ln2_bias"])
            f = F.gelu(b2 @ w[p + "wff1"] + w[p + "bff1"])
            x = x + f @ w[p + "wff2"] + w[p + "bff2"]

        x = _ln(x, w["final_ln_scale"], w["final_ln_bias"])
        return x @ w["lm_head"]

    @torch.no_grad()
    def tree_commit(self, kv_k, kv_v, positions, src_slots, n_commit,
                    block_tables, active):
        """The tree window's KV compaction (the JAX
        ``make_tree_commit_step`` step), in place: the verify window
        wrote slot ``s`` at cache position ``pos + s``, but the committed
        layout needs the accepted root path contiguous after the root.
        Row ``b`` copies window slot ``src_slots[b, j]`` onto cache
        position ``positions[b] + j`` for every ``j < n_commit[b]`` (the
        engine passes ``[0, path...]``, so ``j = 0`` is the root's
        identity copy); rows with ``n_commit = 0`` or inactive write to
        the null block. Every source is gathered, in all layers, before
        any destination is written. Pure data movement: no weights, no
        kernel."""
        C = src_slots.shape[1]
        bs = kv_k.shape[2]
        Mb = block_tables.shape[1]
        pos = positions.long()[:, None]
        offsets = torch.arange(C, device=pos.device)

        def pool_index(p):
            blk = block_tables.gather(1, (p // bs).clamp(0, Mb - 1)).long()
            return blk, p % bs

        src_blk, src_slot = pool_index(pos + src_slots.long())
        k_win = kv_k[:, src_blk, src_slot]       # [L, B, C, H, Dh] copies
        v_win = kv_v[:, src_blk, src_slot]
        dst_pos = pos + offsets[None, :]
        dst_blk, dst_slot = pool_index(dst_pos)
        dst_ok = ((offsets[None, :] < n_commit.long()[:, None])
                  & active[:, None])
        dst_blk = torch.where(dst_ok, dst_blk, torch.zeros_like(dst_blk))
        kv_k[:, dst_blk, dst_slot] = k_win
        kv_v[:, dst_blk, dst_slot] = v_win


def reference_decode(model, prompt, max_new_tokens, eos_id=None,
                     margins=None):
    """Greedy-decode ONE sequence with a plain contiguous KV cache and
    full attention, in numpy — no blocks, no batching, no masking. The
    batched paged decode must match this token for token. A list passed
    as ``margins`` receives each generated token's top-2 logit margin
    (how far that argmax is from a tie)."""
    cfg = model.config
    w = {n: t.detach().cpu().numpy() for n, t in model.weights.items()}
    pe = _position_encoding_table(cfg)
    emb_scale = float(cfg.d_model) ** 0.5
    H, Dh = cfg.n_heads, cfg.head_dim
    sm_scale = Dh ** -0.5
    erf = np.vectorize(math.erf)

    def ln(h, scale, bias):
        mu = np.mean(h, keepdims=True)
        var = np.mean((h - mu) ** 2, keepdims=True)
        return (h - mu) / np.sqrt(var + 1e-5) * scale + bias

    ks = [[] for _ in range(cfg.n_layers)]
    vs = [[] for _ in range(cfg.n_layers)]
    generated = []
    w64 = {}

    def mm(x, name):
        """x @ weight. Past the first (float64) erf the activations are
        float64: they meet the weight's float64 copy, made once, where
        numpy would cast the weight again on every product."""
        m = w[name]
        if x.dtype == np.float64:
            if name not in w64:
                w64[name] = m.astype(np.float64)
            m = w64[name]
        return x @ m

    def one(tok, pos):
        x = w["embedding"][tok] * emb_scale * cfg.pe_alpha \
            + cfg.pe_beta * pe[pos]
        for i in range(cfg.n_layers):
            p = "l%d/" % i
            a = ln(x, w[p + "ln1_scale"], w[p + "ln1_bias"])
            qkv = mm(a, p + "wqkv") + w[p + "bqkv"]
            q, k_new, v_new = np.split(qkv, 3)
            ks[i].append(k_new.reshape(H, Dh))
            vs[i].append(v_new.reshape(H, Dh))
            k_ctx = np.stack(ks[i])            # [T, H, Dh]
            v_ctx = np.stack(vs[i])
            scores = np.einsum("hd,thd->ht", q.reshape(H, Dh),
                               k_ctx) * sm_scale
            scores = scores - scores.max(axis=-1, keepdims=True)
            wgt = np.exp(scores)
            wgt = wgt / wgt.sum(axis=-1, keepdims=True)
            ctx = np.einsum("ht,thd->hd", wgt, v_ctx).reshape(-1)
            x = x + mm(ctx, p + "wproj") + w[p + "bproj"]
            b2 = ln(x, w[p + "ln2_scale"], w[p + "ln2_bias"])
            h = mm(b2, p + "wff1") + w[p + "bff1"]
            # exact (erf) gelu
            h = h * 0.5 * (1.0 + erf(h / np.sqrt(2.0)))
            x = x + mm(h, p + "wff2") + w[p + "bff2"]
        x = ln(x, w["final_ln_scale"], w["final_ln_bias"])
        logits = mm(x, "lm_head")
        nxt = int(np.argmax(logits))
        return nxt, float(logits[nxt] - np.partition(logits, -2)[-2])

    nxt = margin = None
    for pos, tok in enumerate(prompt):
        nxt, margin = one(tok, pos)
    pos = len(prompt)
    while len(generated) < max_new_tokens and pos < cfg.max_seq_len:
        generated.append(nxt)
        if margins is not None:
            margins.append(margin)
        if eos_id is not None and nxt == eos_id:
            break
        nxt, margin = one(generated[-1], pos)
        pos += 1
    return generated


class NGramDrafter:
    """Prompt-lookup / n-gram drafting (zero extra weights): match the
    sequence's most recent suffix n-gram against earlier occurrences in
    its OWN prompt+output history and propose the tokens that followed
    the most recent earlier match. Strongest on templated, repetitive
    and structured generation; a miss proposes nothing and the verify
    window degrades to a plain one-token decode step.

    ``propose(history, k)`` tries match lengths from ``max_ngram`` down
    to ``min_ngram`` and returns up to ``k`` continuation tokens (empty
    when no n-gram recurs).

    With a ``seq_id`` (``propose_for`` — what the scheduler passes),
    the drafter keeps an incremental per-sequence suffix index instead
    of rescanning the full history every window: each n-gram's start
    positions are recorded once when the history first covers them (a
    shrunken or diverged history rebuilds the index), so draft-side host
    time per window is O(k + tokens newly committed), not O(L).
    ``index_ops`` counts gram insertions + occurrence probes.
    ``release(seq_id)`` drops a retired sequence's index (the
    scheduler's reap calls it)."""

    def __init__(self, max_ngram=3, min_ngram=1):
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        if self.min_ngram < 1:
            raise ValueError("min_ngram must be >= 1")
        if self.max_ngram < self.min_ngram:
            raise ValueError("max_ngram must be >= min_ngram")
        self._index = {}        # seq_id -> {len, last, grams{n: {...}}}
        self.index_ops = 0

    def release(self, seq_id):
        """Drop a retired sequence's suffix index."""
        self._index.pop(seq_id, None)

    def _indexed(self, seq_id, hist):
        """The per-sequence suffix index advanced to cover ``hist``:
        ``grams[n]`` maps each n-gram tuple to its ascending start
        positions. Only grams starting in the newly appended span are
        inserted; a history that shrank or whose last indexed token
        changed rebuilds from scratch."""
        L = len(hist)
        ent = self._index.get(seq_id)
        if (ent is None or ent["len"] > L
                or (ent["len"] > 0 and hist[ent["len"] - 1] != ent["last"])):
            ent = {"len": 0, "last": None,
                   "grams": {n: {} for n in
                             range(self.min_ngram, self.max_ngram + 1)}}
            self._index[seq_id] = ent
        L0 = ent["len"]
        for n in range(self.min_ngram, self.max_ngram + 1):
            grams = ent["grams"][n]
            for j in range(max(L0 - n + 1, 0), L - n + 1):
                grams.setdefault(tuple(hist[j:j + n]), []).append(j)
                self.index_ops += 1
        ent["len"] = L
        ent["last"] = hist[L - 1] if L else None
        return ent

    def propose_for(self, seq_id, history, k):
        """``propose`` through the per-sequence index: the same tokens
        at O(k) host cost a window."""
        return self.propose(history, k, seq_id=seq_id)

    def propose(self, history, k, seq_id=None):
        k = int(k)
        if k < 1 or len(history) < self.min_ngram + 1:
            return []
        hist = [int(t) for t in history]
        L = len(hist)
        ent = self._indexed(seq_id, hist) if seq_id is not None else None
        for n in range(min(self.max_ngram, L - 1),
                       self.min_ngram - 1, -1):
            suffix = hist[L - n:]
            # the most recent earlier occurrence able to supply a FULL
            # k-token continuation wins (a match right at the history's
            # end can only offer a truncated draft); the match must end
            # before the suffix starts so the continuation is real
            best = None
            if ent is not None:
                occ = ent["grams"][n].get(tuple(suffix), ())
                for j in reversed(occ):
                    self.index_ops += 1
                    if j >= L - n:      # the trailing suffix itself
                        continue
                    avail = min(k, L - (j + n))
                    if best is None or avail > best[1]:
                        best = (j, avail)
                    if avail >= k:
                        break
            else:
                for j in range(L - n - 1, -1, -1):
                    if hist[j:j + n] != suffix:
                        continue
                    avail = min(k, L - (j + n))
                    if best is None or avail > best[1]:
                        best = (j, avail)
                    if avail >= k:
                        break
            if best is not None:
                start = best[0] + n
                return hist[start:start + k]
        return []

    def propose_tree(self, history, width, depth, seq_id=None):
        """Tree drafting: up to ``width`` root-anchored chains of up to
        ``depth`` tokens. Chain 0 is the linear ``propose`` draft;
        alternate chains are the continuations of other occurrence
        sites of the same suffix whose next token differs. Host work is
        bounded by a per-call probe budget, O(width * depth) a window on
        the indexed path."""
        width, depth = int(width), int(depth)
        primary = self.propose(history, depth, seq_id=seq_id)
        if width <= 1 or len(history) < self.min_ngram + 1:
            return [primary] if primary else []
        hist = [int(t) for t in history]
        L = len(hist)
        chains = [primary] if primary else []
        seen = {primary[0]} if primary else set()
        for n in range(min(self.max_ngram, L - 1),
                       self.min_ngram - 1, -1):
            if seq_id is not None:
                occ = list(self._indexed(seq_id, hist)["grams"][n]
                           .get(tuple(hist[L - n:]), ()))
            else:
                suffix = hist[L - n:]
                occ = [j for j in range(L - n)
                       if hist[j:j + n] == suffix]
            budget = 8 * width + depth
            for j in reversed(occ):
                if len(chains) >= width or budget <= 0:
                    break
                budget -= 1
                self.index_ops += 1
                if j >= L - n:
                    continue
                cont = hist[j + n:j + n + depth]
                if not cont or cont[0] in seen:
                    continue
                seen.add(cont[0])
                chains.append(cont)
            if occ:
                # branches come from the longest recurring suffix only
                break
        return chains
