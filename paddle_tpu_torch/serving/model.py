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
  * chunked prefill: ``prefill_step``, the ``[B, C]`` window whose rows
    consume prompt spans (decode rows ride along as 1-token windows),
    returning each row's greedy token at its last valid slot.
  * speculative decoding: ``spec_step`` (the linear verify window),
    ``spec_tree_step`` (the tree verify window over the level-order
    token tree of ``tree_topology``), ``tree_commit`` (the accepted
    path's KV compaction), ``NGramDrafter`` (prompt-lookup drafting
    over a sequence's own history) and ``ModelDrafter`` (greedy drafts
    from a model: catch-up ``prefill_step`` chunks, then ``draft_step``,
    ``n_new`` chained one-token steps, over its own KV pool).
  * the weight-only int8 store: ``GenerationModel.quantized()`` keeps
    every 2-D weight int8 with a per-output-channel fp32 scale under
    ``<name>@qscale``; the steps dequantize each weight where they use
    it, and gather the int8 embedding rows before dequantizing them.
  * the generation artifact: ``save_generation_artifact``,
    ``verify_generation_artifact`` and ``load_generation_artifact``
    write and read the JAX package's ``__generation__.npz``, meta JSON
    and sha256 manifest; ``extract_decoder_weights`` lifts the decoder
    out of a ``models.transformer_fluid.build`` Program and its scope
    into that layout (``inference.export_generation_model`` writes it).

The weight layout is the JAX package's flat dict (``weight_names``, and
``<name>@qscale`` beside each int8 weight), the layout its
``__generation__.npz`` artifact holds, so
``GenerationModel.from_jax_weights`` serves the JAX model's weights,
fp32 or int8.

The steps' calling conventions (all shapes fixed per engine):

    decode_step(kv_k, kv_v, prompt_feed, use_prompt, prev_tokens,
                positions, block_tables, active, weights=None,
                return_logits=False) -> next_tokens [, logits]
    prefill_step(kv_k, kv_v, chunk_tokens, use_prompt, prev_tokens,
                 positions, lengths, block_tables, active, weights=None,
                 return_logits=False) -> next_tokens [B] [, logits [B, V]]
    draft_step(kv_k, kv_v, first_tokens, positions, block_tables, active,
               n_new, weights=None) -> tokens [B, n_new]
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

import hashlib
import json
import math
import os
import shutil
import threading
import zipfile

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import flags as _flags
from ..core.place import resolve_device
from ..observability import cost as _cost
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing
from ..ops import paged_attention as _pa
from ..ops import paged_attention_tree as _pat
from .kv_cache import KVBlockPool, blocks_needed

# fp32 matmuls and convolutions run in full fp32, not TF32: greedy
# tokens are held identical to the fp32 reference decoder
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["GENERATION_MANIFEST", "GENERATION_META", "GENERATION_WEIGHTS",
           "GenerationArtifactError", "GenerationConfig", "GenerationModel",
           "ModelDrafter", "NGramDrafter", "extract_decoder_weights",
           "load_generation_artifact",
           "parse_tree_shape", "random_weights", "reference_decode",
           "save_generation_artifact", "tree_topology",
           "verify_generation_artifact", "weight_names"]

# the generation artifact's files, the JAX package's names
GENERATION_WEIGHTS = "__generation__.npz"
GENERATION_META = "__generation_meta__.json"
GENERATION_MANIFEST = "__generation_manifest__.json"


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

    def to_dict(self):
        return {k: getattr(self, k) for k in
                ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
                 "max_seq_len", "pe_alpha", "pe_beta")}

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


# weight-name layout: one flat dict, per-layer names carry an l<i>/
# prefix; fp32, or (the int8 store) int8 with an fp32 <name>@qscale
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


# an int8 weight's per-output-channel scale: the key "<name>@qscale"
QSCALE = "@qscale"


def _buffer_name(weight_name):
    """The buffer holding a weight: "/" and "@" are no attribute
    names."""
    return weight_name.replace("/", "__").replace("@", "__at__")


def _host_array(value):
    """A weight as a numpy array (tensors are copied to the host)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _ln(h, scale, bias):
    mu = h.mean(dim=-1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
    return (h - mu) * torch.rsqrt(var + 1e-5) * scale + bias


class GenerationModel(nn.Module):
    """Config + weights on one device + the decode step.

    ``device=None`` is ``cuda:0`` and raises without CUDA; pass
    ``device="cpu"`` for the plain PyTorch path. On a CUDA device the
    paged-attention kernel is built (if needed) and loaded here, so a
    failing ``nvcc`` raises to the caller.

    Weights are fp32, except an int8 entry (the weight-only int8 store,
    ``quantized()``), which stays int8 beside its fp32 ``@qscale``; then
    ``weight_only_int8`` is set. Every step reads a weight through
    ``_w``, which dequantizes an int8 one where it is used: the step
    computes with exactly ``dequantized_weights()``, so a quantized
    model decodes token-identically to ``reference_decode`` over them."""

    def __init__(self, config, weights, name="model", device=None):
        super().__init__()
        self.config = config
        self.name = name
        self.device = resolve_device(device)
        missing = [n for n in weight_names(config) if n not in weights]
        if missing:
            raise ValueError("missing weights: %s" % missing[:4])
        self._weight_names = []
        for n in weight_names(config):
            for key in (n, n + QSCALE):
                if key not in weights:
                    continue
                a = _host_array(weights[key])
                a = np.array(a, np.int8 if a.dtype == np.int8
                             else np.float32)
                self.register_buffer(
                    _buffer_name(key),
                    torch.from_numpy(a).to(self.device).contiguous())
                self._weight_names.append(key)
        self.weight_only_int8 = any(
            getattr(self, _buffer_name(n)).dtype == torch.int8
            for n in self._weight_names)
        self.register_buffer(
            "pe", torch.from_numpy(_position_encoding_table(config))
            .to(self.device))
        self._trees = {}  # (width, depth) -> (depths, anc) on the device
        # window shapes whose first step was counted (metrics on)
        self._counted = set()
        self._count_lock = threading.Lock()
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
        ``__generation__.npz``; a quantized model's int8 arrays and
        ``@qscale`` scales stay an int8 store): it computes the same
        function."""
        return cls(config, weights_np, name=name, device=device)

    @property
    def weights(self):
        """{weight name: tensor} in the flat JAX layout (with the
        ``@qscale`` entries of an int8 store)."""
        return {n: getattr(self, _buffer_name(n))
                for n in self._weight_names}

    def quantized(self, name=None):
        """The weight-only int8 variant of this model, on its device:
        every 2-D fp32 weight (the embedding, qkv, proj, both FFN
        weights, the LM head) becomes int8 on the shared symmetric grid
        (``quant.quantize_symmetric``) per output column, its scale over
        127 in ``<name>@qscale``; biases and norms stay fp32. A quantized
        model returns itself. Records the ``quant/*`` weight-store
        counters."""
        from ..quant import quantize_symmetric, record_weight_store

        if self.weight_only_int8:
            return self
        qw = {}
        n_q = saved = fp32 = 0
        for k, v in self.weights.items():
            w = _host_array(v)
            if w.ndim == 2 and w.dtype == np.float32:
                q, s = quantize_symmetric(w, channel_axis=1)
                qw[k] = q
                qw[k + QSCALE] = (s / 127.0).astype(np.float32)
                n_q += 1
                saved += max(w.nbytes - q.nbytes - s.nbytes, 0)
                fp32 += w.nbytes
            else:
                qw[k] = w
        record_weight_store(n_q, saved, fp32)
        return GenerationModel(self.config, qw,
                               name=name or self.name + ".int8",
                               device=self.device)

    def dequantized_weights(self):
        """{weight name: fp32 tensor}, the int8 store multiplied back
        out (``q.float() * scale``, no ``@qscale`` entries): the values
        the quantized model's steps compute with."""
        w = self.weights
        return {k: self._w(w, k) for k in w if not k.endswith(QSCALE)}

    @staticmethod
    def _w(w, key):
        """Weight ``key`` of the dict ``w`` in fp32: an int8 one
        dequantized here, where it is used."""
        s = w.get(key + QSCALE)
        return w[key] if s is None else w[key].float() * s

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
    def prefill_step(self, kv_k, kv_v, chunk_tokens, use_prompt,
                     prev_tokens, positions, lengths, block_tables, active,
                     weights=None, return_logits=False):
        """The chunked (mixed prefill/decode) window, the counterpart of
        the JAX ``make_prefill_step`` step: ``chunk_tokens`` int [B, C],
        row ``b``'s window slot ``j`` processing position ``positions[b]
        + j`` for ``j < lengths[b]``. Prefill rows (``use_prompt``) take
        every token from ``chunk_tokens``; decode rows are 1-token
        windows whose slot 0 chains ``prev_tokens``. The window's K/V is
        written first, then attended by the paged-attention kernel (K2)
        at C = chunk. Returns ``next_tokens`` int32 [B], the greedy token
        after each row's last valid slot (``lengths - 1``), and fp32
        ``logits`` [B, V] there with ``return_logits``: the final LN and
        the head run on that slot only. Slots past a row's length write
        to the null block."""
        return self._window_step(kv_k, kv_v, chunk_tokens, use_prompt,
                                 prev_tokens, positions, lengths,
                                 block_tables, active, weights,
                                 return_logits, tree=None, all_slots=False)

    @torch.no_grad()
    def draft_step(self, kv_k, kv_v, first_tokens, positions, block_tables,
                   active, n_new, weights=None):
        """``n_new`` greedy one-token steps chained on the device (the
        counterpart of the JAX ``make_draft_step`` scan): micro-step
        ``i`` feeds row ``b``'s token at position ``positions[b] + i``,
        writes its K/V and takes its argmax as the next step's token,
        starting from ``first_tokens`` int [B]. Each micro-step is the
        decode step's body (K2 at C = 1 in every layer), queued on the
        caller's stream with no host sync between them. Returns int32
        [B, n_new]: ``tokens[b, i]`` follows the ``i + 1``-th chain
        token. Active rows need ``positions + n_new <= max_seq_len``;
        inactive rows write to the null block."""
        tok = first_tokens.to(torch.int32)
        use_prompt = torch.ones_like(active)
        ones = torch.ones_like(positions)
        out = []
        for i in range(int(n_new)):
            tok = self._window_step(kv_k, kv_v, tok[:, None], use_prompt,
                                    tok, positions + i, ones, block_tables,
                                    active, weights, False, tree=None)[:, 0]
            out.append(tok)
        if not out:
            return torch.zeros((tok.shape[0], 0), dtype=torch.int32,
                               device=tok.device)
        return torch.stack(out, dim=1)

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
                     weights, return_logits, tree, all_slots=True):
        """The shared body of every step: the root token splice,
        embeddings, position encodings (window offset, or tree depth)
        and the window forward, at every slot or (``all_slots=False``)
        at each row's last valid slot. With metrics on, the first step
        of each window shape is counted and its ``exec/*`` gauges
        published (``observability/cost.py``), as the JAX model
        publishes each step's cost at its compile."""
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
        emb = w["embedding"][tok]
        es = w.get("embedding" + QSCALE)
        if es is not None:
            # the int8 rows first, then the [B, C, D] slice dequantized:
            # the fp32 table is never made
            emb = emb.float() * es
        x = (emb * (float(cfg.d_model) ** 0.5)
             * cfg.pe_alpha + cfg.pe_beta * self.pe[pe_idx])
        fresh = False
        if _metrics.enabled():
            shape = (tuple(window_tokens.shape), tree, all_slots)
            with self._count_lock:
                fresh = shape not in self._counted
                self._counted.add(shape)
        # the window forward holds every product of the step; a window
        # shape's first (counted) step runs in the serving_compile span,
        # the JAX model's first call of a step kind
        with (_tracing.span("serving_compile", kind=str(shape)) if fresh
              else _tracing.NULL_SPAN), \
                _cost.first_step(fresh, self.device):
            logits = self._forward_window(w, x, pos2d, lengths,
                                          block_tables, active, kv_k, kv_v,
                                          anc, all_slots)
        next_tokens = logits.argmax(dim=-1).to(torch.int32)
        if return_logits:
            return next_tokens, logits
        return next_tokens

    def _forward_window(self, w, x, pos2d, lengths, block_tables, active,
                        kv_k, kv_v, anc, all_slots=True):
        """A [B, C] token window through all layers (the JAX
        ``_forward_chunk``). x: [B, C, D]; pos2d int32 [B, C] the cache
        position of each slot. Writes the window's K/V before attending,
        so each slot sees itself; with ``anc`` (bool [C, C]) in-window
        visibility is the tree mask. Returns logits at every slot, [B,
        C, V], or with ``all_slots=False`` at each row's last valid slot
        (``lengths - 1``), [B, V]."""
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
            qkv = a @ self._w(w, p + "wqkv") + w[p + "bqkv"]
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
            x = (x + ctx.reshape(B, C, D) @ self._w(w, p + "wproj")
                 + w[p + "bproj"])
            b2 = _ln(x, w[p + "ln2_scale"], w[p + "ln2_bias"])
            f = F.gelu(b2 @ self._w(w, p + "wff1") + w[p + "bff1"])
            x = x + f @ self._w(w, p + "wff2") + w[p + "bff2"]

        if not all_slots:
            last = (lengths.long() - 1).clamp(0, C - 1)
            x = x[torch.arange(B, device=x.device), last]
        x = _ln(x, w["final_ln_scale"], w["final_ln_bias"])
        return x @ self._w(w, "lm_head")

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
    (how far that argmax is from a tie). A quantized model decodes over
    its ``dequantized_weights()``, the values its steps compute with."""
    cfg = model.config
    w = (model.dequantized_weights() if model.weight_only_int8
         else model.weights)
    w = {n: t.detach().cpu().numpy() for n, t in w.items()}
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


def upload_int32(device, *arrays):
    """Host arrays on ``device`` through one packed int32 copy, as int32
    tensors of the arrays' shapes. On CUDA the copy comes from a fresh
    pinned buffer and does not synchronise (PyTorch's pinned allocator
    keeps the buffer until the copy has run)."""
    packed = np.concatenate([np.ravel(a) for a in arrays]).astype(np.int32)
    if device.type == "cuda":
        host = torch.empty(packed.shape, dtype=torch.int32, pin_memory=True)
        host.numpy()[:] = packed
        dev = host.to(device, non_blocking=True)
    else:
        dev = torch.from_numpy(packed)
    out, start = [], 0
    for a in arrays:
        out.append(dev[start:start + a.size].view(a.shape))
        start += a.size
    return out


class _DraftSeq:
    """Per-sequence drafter-side KV state: the drafter pool's owner (its
    reservation and rollback hang off this object's identity)."""

    __slots__ = ("slot", "n_cached")

    def __init__(self, slot):
        self.slot = int(slot)
        self.n_cached = 0


class ModelDrafter:
    """Greedy draft tokens from a ``GenerationModel`` over each
    sequence's committed history (the JAX package's ``ModelDrafter``).

    ``propose(history, k)`` is the host oracle (``reference_decode``,
    unbatched). The serving path is ``propose_batch`` /
    ``propose_tree_batch``: catch-up ``prefill_step`` chunks of
    ``chunk`` tokens (default ``$PTPU_SERVE_DRAFT_CHUNK``) bring each
    row's draft KV level with its history, then one ``draft_step``
    drafts the chain on the device for every row at once. Draft KV lives
    in the drafter's own ``KVBlockPool`` on the model's device, and every
    window ends with ``truncate_owner`` back to the committed history, so
    the draft pool's ``check_invariants`` is clean between windows.
    Drafting with the target model itself is accepted whole.

    ``draft_steps`` counts draft-side dispatches (catch-up chunks and
    ``draft_step`` calls)."""

    def __init__(self, model, block_size=16, chunk=None):
        if not isinstance(model, GenerationModel):
            raise TypeError("ModelDrafter needs a GenerationModel, got %r"
                            % (type(model).__name__,))
        self.model = model
        self.draft_steps = 0
        self._block_size = int(block_size)
        self._chunk = chunk
        self._pool = None
        self._tables = None
        self._max_batch = 0
        self._n_new = 0
        self._mb = 0
        self._states = {}       # seq_id -> _DraftSeq
        self._free_slots = []

    @property
    def pool(self):
        """The drafter's KV pool (None until ``bind``)."""
        return self._pool

    def propose(self, history, k):
        """The host oracle: ``k`` greedy tokens after ``history`` by
        ``reference_decode``."""
        k = int(k)
        hist = [int(t) for t in history]
        if k < 1 or not hist or len(hist) >= self.model.config.max_seq_len:
            return []
        return reference_decode(self.model, hist, k)

    def bind(self, max_batch, max_chain):
        """Size the drafter for ``max_batch`` rows and chains of up to
        ``max_chain`` tokens (the engine calls it once): builds the
        drafter's own pool on the model's device, ``max_batch *
        blocks_needed(max_seq_len)`` blocks, so a full reservation per
        row always succeeds. Growing a binding resets every sequence's
        draft state (the next window prefills again)."""
        max_batch = int(max_batch)
        max_chain = max(int(max_chain), 1)
        if (self._pool is not None and self._max_batch >= max_batch
                and self._n_new == max_chain - 1):
            return
        cfg = self.model.config
        if self._chunk is None:
            self._chunk = _flags.env("PTPU_SERVE_DRAFT_CHUNK")
        self._chunk = max(int(self._chunk), 1)
        self._max_batch = max(max_batch, self._max_batch)
        self._n_new = max_chain - 1
        self._mb = blocks_needed(cfg.max_seq_len, self._block_size)
        self._pool = KVBlockPool(cfg.n_layers, cfg.n_heads, cfg.head_dim,
                                 self._block_size, self._max_batch * self._mb,
                                 device=self.model.device)
        self._tables = np.zeros((self._max_batch, self._mb), np.int32)
        self._states = {}
        self._free_slots = list(range(self._max_batch - 1, -1, -1))

    def release(self, seq_id):
        """Free a retired sequence's draft KV (the scheduler's reap
        calls it)."""
        st = self._states.pop(seq_id, None)
        if st is None:
            return
        self._pool.free_owner(st)
        self._tables[st.slot, :] = 0
        self._free_slots.append(st.slot)

    def _state_for(self, seq_id):
        st = self._states.get(seq_id)
        if st is None:
            st = _DraftSeq(self._free_slots.pop())
            self._states[seq_id] = st
            # a full reservation up front: the pool is sized so this
            # cannot fail, and truncate_owner restores it every window
            self._pool.reserve(st, self._mb)
        return st

    def _alloc_span(self, st, start, stop):
        """Own (and map in the table) the draft blocks covering
        positions [start, stop)."""
        for b in range(blocks_needed(start, self._block_size),
                       blocks_needed(stop, self._block_size)):
            self._tables[st.slot, b] = self._pool.alloc_block(st)

    def propose_batch(self, rows, k):
        """Up to ``k`` greedy draft tokens for many sequences in a few
        batched device steps. ``rows`` is ``[(seq_id, history), ...]``;
        returns ``{seq_id: [tokens...]}`` (empty where a row is at the
        draft model's sequence cap)."""
        got = self.propose_tree_batch(
            [(sid, hist, k) for sid, hist in rows], width=1)
        return {sid: (ch[0] if ch else []) for sid, ch in got.items()}

    def propose_tree_batch(self, rows, width):
        """Tree drafts for many sequences in a few batched device steps.
        ``rows`` is ``[(seq_id, history, depth), ...]``; returns
        ``{seq_id: [chain0, chain1, ...]}``: chain 0 the greedy chain (up
        to ``depth`` tokens), chains 1.. the ``width - 1`` runners-up of
        the first token in the catch-up logits (by a stable argsort on
        the host), one token each."""
        width = int(width)
        out = {sid: [] for sid, _h, _d in rows}
        cfg = self.model.config
        work = []
        for sid, hist, depth in rows:
            hist = [int(t) for t in hist]
            depth = int(depth)
            if depth < 1 or not hist or len(hist) >= cfg.max_seq_len:
                continue
            work.append((sid, hist, min(depth, cfg.max_seq_len - len(hist))))
        if not work:
            return out
        max_depth = max(d for _s, _h, d in work)
        if self._pool is None:
            self.bind(len(work), max_depth)
        # grow a binding a call outruns (direct use; the engine binds its
        # whole geometry up front)
        new_ids = sum(1 for sid, _h, _d in work if sid not in self._states)
        if new_ids > len(self._free_slots) or max_depth - 1 > self._n_new:
            self.bind(max(self._max_batch, len(self._states) + new_ids),
                      max(max_depth, self._n_new + 1))
        B, chunk, pool = self._max_batch, self._chunk, self._pool
        dev = self.model.device

        # catch-up: history[n_cached:] through prefill chunks; each row's
        # last chunk gives draft token 1 (argmax) and the branch roots
        states = {}
        for sid, hist, _depth in work:
            st = self._state_for(sid)
            if st.n_cached > len(hist):
                # a history that shrank: rebuild from scratch
                pool.truncate_owner(st, 0)
                self._tables[st.slot, :] = 0
                st.n_cached = 0
            states[sid] = st
        final_logits = {}
        while True:
            feed = np.zeros((B, chunk), np.int32)
            lengths = np.zeros(B, np.int32)
            positions = np.zeros(B, np.int32)
            active = np.zeros(B, bool)
            finishing = []
            for sid, hist, _depth in work:
                st = states[sid]
                n = min(chunk, len(hist) - st.n_cached)
                if n <= 0:
                    continue
                feed[st.slot, :n] = hist[st.n_cached:st.n_cached + n]
                lengths[st.slot] = n
                positions[st.slot] = st.n_cached
                active[st.slot] = True
                self._alloc_span(st, st.n_cached, st.n_cached + n)
                st.n_cached += n
                if st.n_cached == len(hist):
                    finishing.append(sid)
            if not active.any():
                break
            feed_d, act_d, pos_d, len_d, tab_d = upload_int32(
                dev, feed, active, positions, lengths, self._tables)
            act_d = act_d.bool()
            _nt, logits = self.model.prefill_step(
                pool.k, pool.v, feed_d, act_d, torch.zeros_like(pos_d),
                pos_d, len_d, tab_d, act_d, return_logits=True)
            self.draft_steps += 1
            if finishing:
                lg = logits.cpu().numpy()
                for sid in finishing:
                    final_logits[sid] = lg[states[sid].slot]

        # branch roots: a stable argsort, so order[0] is np.argmax
        first_tok, alt_tok = {}, {}
        for sid, _hist, _depth in work:
            order = np.argsort(-final_logits[sid], kind="stable")
            first_tok[sid] = int(order[0])
            alt_tok[sid] = [int(t) for t in order[1:width]]

        # chain 0's tokens 2..depth in one draft_step; a row whose span
        # would cross the draft cache's cap rides inactive (chain [d1])
        scan_active = np.zeros(B, bool)
        toks = None
        if self._n_new > 0 and any(d > 1 for _s, _h, d in work):
            first = np.zeros(B, np.int32)
            positions = np.zeros(B, np.int32)
            for sid, hist, depth in work:
                st = states[sid]
                if depth < 2 or len(hist) + self._n_new > cfg.max_seq_len:
                    continue
                first[st.slot] = first_tok[sid]
                positions[st.slot] = len(hist)
                scan_active[st.slot] = True
                self._alloc_span(st, len(hist), len(hist) + self._n_new)
            if scan_active.any():
                first_d, pos_d, tab_d, act_d = upload_int32(
                    dev, first, positions, self._tables, scan_active)
                toks = self.model.draft_step(
                    pool.k, pool.v, first_d, pos_d, tab_d, act_d.bool(),
                    self._n_new).cpu().numpy()
                self.draft_steps += 1

        # chains, then the draft KV rolled back to the committed history
        for sid, hist, depth in work:
            st = states[sid]
            chain0 = [first_tok[sid]]
            if scan_active[st.slot]:
                chain0 += [int(t) for t in toks[st.slot]]
            out[sid] = [chain0[:depth]] + [[t] for t in alt_tok[sid]]
            keep = blocks_needed(len(hist), self._block_size)
            dropped = pool.truncate_owner(st, keep)
            if dropped:
                self._tables[st.slot, keep:keep + len(dropped)] = 0
            st.n_cached = len(hist)
        return out


# ---------------------------------------------------------------------------
# extraction from a transformer_fluid.build program
# ---------------------------------------------------------------------------


def extract_decoder_weights(program, scope, max_seq_len=None):
    """Lift the decoder weights out of a Program built by the port's
    ``models.transformer_fluid.build(remat=False)`` and the scope holding
    its parameters (after the startup program ran) into the serving
    layout, with the JAX package's names and arrangement.

    The walk is positional over op types, so the elementwise and reshape
    plumbing between them does not matter: the embedding comes from the
    ``lookup_table`` op, each layer's weights from the in-order
    ``layer_norm`` / ``fused_multihead_attention`` / parameter ``mul``
    ops, and the LM head from the (chunk-shared) head matmuls. Returns
    ``(GenerationConfig, {name: fp32 numpy array})``."""
    block = program.global_block()

    def _is_param(name):
        v = block._find_var_recursive(name)
        return v is not None and getattr(v, "persistable", False)

    def _val(name):
        val = scope.get(name)
        if val is None:
            raise RuntimeError(
                "parameter %r has no value — run the startup program "
                "before exporting" % name)
        if isinstance(val, torch.Tensor):
            return val.detach().float().cpu().numpy()
        return np.asarray(val, np.float32)

    emb = None
    pe_alpha = pe_beta = 1.0
    lns, atts, muls = [], [], []
    pending_mul = None
    for op in block.ops:
        if op.type == "lookup_table" and emb is None:
            emb = op.inputs["W"][0].name
        elif op.type == "add_position_encoding":
            pe_alpha = op.attrs.get("alpha", 1.0)
            pe_beta = op.attrs.get("beta", 1.0)
        elif op.type == "layer_norm":
            lns.append((op.inputs["Scale"][0].name,
                        op.inputs["Bias"][0].name))
        elif op.type == "fused_multihead_attention":
            atts.append({k: v[0].name for k, v in op.inputs.items()
                         if k != "X"})
        elif op.type == "mul" and _is_param(op.inputs["Y"][0].name):
            pending_mul = [op.inputs["Y"][0].name, None]
            muls.append(pending_mul)
        elif (op.type == "elementwise_add" and pending_mul is not None
              and _is_param(op.inputs["Y"][0].name)):
            pending_mul[1] = op.inputs["Y"][0].name
            pending_mul = None
        elif op.type == "recompute":
            raise NotImplementedError(
                "extract_decoder_weights walks the flat op list — build "
                "the program with transformer_fluid.build(remat=False)")

    if emb is None or not atts:
        raise ValueError(
            "program does not look like transformer_fluid.build output "
            "(no embedding / fused_multihead_attention ops found)")
    L = len(atts)
    if len(lns) != 2 * L + 1:
        raise ValueError(
            "expected %d layer_norm ops for %d layers, found %d — only "
            "the remat=False, dropout_rate=0 build is exportable"
            % (2 * L + 1, L, len(lns)))
    ffn_muls = muls[:2 * L]
    head_params = {m[0] for m in muls[2 * L:]}
    if len(ffn_muls) != 2 * L or len(head_params) != 1:
        raise ValueError(
            "expected 2 FFN matmuls per layer plus one shared LM-head "
            "parameter; found %d muls over params %r"
            % (len(muls), sorted({m[0] for m in muls})))

    emb_w = _val(emb)
    V, D = emb_w.shape
    H = _val(atts[0]["WQ"]).shape[1]
    F = _val(ffn_muls[0][0]).shape[1]
    config = GenerationConfig(
        vocab_size=V, d_model=D, n_heads=H, n_layers=L, d_ff=F,
        max_seq_len=max_seq_len or 512, pe_alpha=pe_alpha,
        pe_beta=pe_beta)
    weights = {"embedding": emb_w,
               "lm_head": _val(next(iter(head_params))),
               "final_ln_scale": _val(lns[2 * L][0]),
               "final_ln_bias": _val(lns[2 * L][1])}
    if weights["lm_head"].shape != (D, V):
        raise ValueError("LM head shape %r != (d_model, vocab)"
                         % (weights["lm_head"].shape,))
    zeros = np.zeros(D, np.float32)
    for i in range(L):
        p = "l%d/" % i
        att = atts[i]
        # [D, H, Dh] per-head projections -> the fused [D, 3D] qkv matmul
        weights[p + "wqkv"] = np.concatenate(
            [_val(att[k]).reshape(D, D) for k in ("WQ", "WK", "WV")],
            axis=1)
        weights[p + "bqkv"] = np.concatenate(
            [_val(att[k]).reshape(D) if k in att else zeros
             for k in ("BQ", "BK", "BV")])
        weights[p + "wproj"] = _val(att["WO"]).reshape(D, D)
        weights[p + "bproj"] = _val(att["BO"]) if "BO" in att else zeros
        weights[p + "ln1_scale"] = _val(lns[2 * i][0])
        weights[p + "ln1_bias"] = _val(lns[2 * i][1])
        weights[p + "ln2_scale"] = _val(lns[2 * i + 1][0])
        weights[p + "ln2_bias"] = _val(lns[2 * i + 1][1])
        for j, nm in ((0, "ff1"), (1, "ff2")):
            wname, bname = ffn_muls[2 * i + j]
            weights[p + "w" + nm] = _val(wname)
            weights[p + "b" + nm] = (
                _val(bname) if bname is not None
                else np.zeros(weights[p + "w" + nm].shape[1], np.float32))
    return config, weights


# ---------------------------------------------------------------------------
# the generation artifact (the JAX package's format)
# ---------------------------------------------------------------------------


class GenerationArtifactError(RuntimeError):
    """A generation artifact failed its digest or inventory check (a torn
    or corrupt export). The message names the directory and the first
    mismatch."""

    def __init__(self, dirname, reason):
        self.dirname = dirname
        self.reason = reason
        super().__init__(
            "generation artifact %s is torn or corrupt: %s — re-export "
            "it; it must never be served" % (dirname, reason))


def _weight_digest(arr):
    """sha256 over dtype, shape and bytes (the JAX package's digest)."""
    arr = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(repr(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def _fsync(path):
    """fsync a file, or (best effort) a directory."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _maybe_tear_export(dirname):
    """The ``ckpt_torn_export`` fault site: after a publish lands,
    corrupt and truncate the weights payload in place, the torn export
    the digest manifest exists to catch."""
    from ..resilience import global_injector

    if not global_injector().fire_occurrence("ckpt_torn_export"):
        return
    path = os.path.join(dirname, GENERATION_WEIGHTS)
    with open(path, "r+b") as f:
        data = f.read()
        if not data:
            return
        f.seek(0)
        f.write(bytes(b ^ 0xFF for b in data[: max(1, len(data) // 2)]))
        f.truncate(max(1, len(data) // 2))


def save_generation_artifact(dirname, config, weights):
    """Publish a generation artifact atomically, in the JAX package's
    format: an npz of fp32 weights, the config as JSON and a manifest of
    per-weight sha256 digests and file sizes. Everything is written to a
    temporary directory first; a new ``dirname`` appears by one rename,
    an existing one is replaced file by file, the manifest last.
    ``weights`` maps names to numpy arrays or tensors. The
    ``ckpt_torn_export`` fault site fires after the publish. Returns the
    npz path."""
    dirname = os.path.abspath(dirname)
    parent = os.path.dirname(dirname)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, ".ptpu_tmp_" + os.path.basename(dirname))
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    weights = {k: np.asarray(_host_array(v), np.float32)
               for k, v in weights.items()}
    np.savez(os.path.join(tmp, GENERATION_WEIGHTS), **weights)
    with open(os.path.join(tmp, GENERATION_META), "w") as f:
        json.dump(config.to_dict(), f, indent=2, sort_keys=True)
    manifest = {
        "format": 1,
        "digests": {k: _weight_digest(v) for k, v in weights.items()},
        "files": {n: os.path.getsize(os.path.join(tmp, n))
                  for n in (GENERATION_WEIGHTS, GENERATION_META)},
    }
    with open(os.path.join(tmp, GENERATION_MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    for n in (GENERATION_WEIGHTS, GENERATION_META):
        _fsync(os.path.join(tmp, n))
    if not os.path.exists(dirname):
        os.rename(tmp, dirname)
    else:
        # payloads before the manifest: a crash in between leaves a
        # mismatch the loader reports, never a silent torn read
        stale = os.path.join(dirname, GENERATION_MANIFEST)
        if os.path.exists(stale):
            os.remove(stale)
        for n in (GENERATION_WEIGHTS, GENERATION_META, GENERATION_MANIFEST):
            os.replace(os.path.join(tmp, n), os.path.join(dirname, n))
        shutil.rmtree(tmp, ignore_errors=True)
    _fsync(dirname)
    _fsync(parent)
    _maybe_tear_export(dirname)
    return os.path.join(dirname, GENERATION_WEIGHTS)


def verify_generation_artifact(dirname):
    """Check an artifact against its manifest: the file sizes, then every
    weight's sha256. Raises ``GenerationArtifactError`` on a mismatch.
    Returns True when verified, False for an artifact with no manifest
    (nothing to check against)."""
    mpath = os.path.join(dirname, GENERATION_MANIFEST)
    if not os.path.exists(mpath):
        return False
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise GenerationArtifactError(dirname, "unreadable manifest (%s)"
                                      % e)
    for n, size in manifest.get("files", {}).items():
        p = os.path.join(dirname, n)
        if not os.path.exists(p):
            raise GenerationArtifactError(dirname, "missing file %s" % n)
        if os.path.getsize(p) != int(size):
            raise GenerationArtifactError(
                dirname, "file %s is %d bytes, manifest says %d"
                % (n, os.path.getsize(p), size))
    digests = manifest.get("digests", {})
    try:
        with np.load(os.path.join(dirname, GENERATION_WEIGHTS)) as z:
            if set(z.files) != set(digests):
                raise GenerationArtifactError(
                    dirname, "weight set mismatch (%d stored vs %d in "
                    "manifest)" % (len(z.files), len(digests)))
            for k in sorted(z.files):
                if _weight_digest(z[k]) != digests[k]:
                    raise GenerationArtifactError(
                        dirname, "digest mismatch on weight %r" % k)
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise GenerationArtifactError(dirname, "unreadable weights (%s)"
                                      % e)
    return True


def load_generation_artifact(dirname, name=None, quantize=None,
                             verify=True, device=None):
    """A ``GenerationModel`` on ``device`` (None: ``cuda:0``) from an
    artifact the JAX package or ``save_generation_artifact`` wrote. An
    artifact with a manifest is verified first (``verify=False`` skips
    it); a torn one raises ``GenerationArtifactError``. ``quantize``
    (True, "weight_only" or "int8") serves it from the weight-only int8
    store (``GenerationModel.quantized``)."""
    meta_path = os.path.join(dirname, GENERATION_META)
    if not os.path.exists(meta_path):
        raise FileNotFoundError("%s has no %s — not a generation artifact"
                                % (dirname, GENERATION_META))
    if verify:
        verify_generation_artifact(dirname)
    with open(meta_path) as f:
        config = GenerationConfig.from_dict(json.load(f))
    try:
        with np.load(os.path.join(dirname, GENERATION_WEIGHTS)) as z:
            weights = {k: z[k] for k in z.files}
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise GenerationArtifactError(dirname, "unreadable weights (%s)"
                                      % e)
    model = GenerationModel(config, weights,
                            name=name or os.path.basename(
                                os.path.normpath(dirname)),
                            device=device)
    if quantize:
        if quantize not in (True, "weight_only", "int8"):
            raise ValueError(
                "quantize=%r — the serving runtime supports the "
                "weight_only int8 store (docs/QUANTIZATION.md)"
                % (quantize,))
        model = model.quantized()
    return model
