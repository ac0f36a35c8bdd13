"""Generation-serving artifacts from a training Program: the part of the
JAX package's ``inference.py`` the serving fleet needs.

``export_generation_model`` lifts the decoder of a Program built by
``models.transformer_fluid.build(remat=False)`` out of a scope into the
serving layout and publishes it atomically as the JAX package's
generation artifact (``__generation__.npz``, the config JSON and the
sha256 manifest, written last); ``load_generation_model`` serves one.
The predictor and the one-shot serving exports of the JAX module are not
ported yet.
"""

from .core.scope import global_scope

__all__ = ["export_generation_model", "load_generation_model"]


def export_generation_model(dirname, program, scope=None, max_seq_len=None):
    """Export a Program built by ``models.transformer_fluid.build``
    (``remat=False``, no dropout) as a generation artifact in
    ``dirname``: fp32 decoder weights in the serving layout, the
    ``GenerationConfig`` and a per-weight digest manifest. The publish is
    atomic (a temp dir and a rename, the manifest last), so a reader sees
    the complete artifact or the previous one, and a torn write is caught
    by ``verify_generation_artifact``. ``scope`` defaults to the global
    scope. Returns the ``GenerationConfig``."""
    from .serving import model as _serving_model

    scope = scope if scope is not None else global_scope()
    config, weights = _serving_model.extract_decoder_weights(
        program, scope, max_seq_len=max_seq_len)
    _serving_model.save_generation_artifact(dirname, config, weights)
    return config


def load_generation_model(dirname, name=None, quantize=None, device=None):
    """The ``GenerationModel`` of an exported artifact, on ``device``
    (None: ``cuda:0``), ready for ``ServingEngine``.
    ``quantize="weight_only"`` serves it from the int8 weight store."""
    from .serving import model as _serving_model

    return _serving_model.load_generation_artifact(
        dirname, name=name, quantize=quantize, device=device)
