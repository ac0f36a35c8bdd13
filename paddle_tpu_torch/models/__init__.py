"""Models of the port (parity: the JAX package's ``models/``): the
Fluid-API Transformer LM and benchmark/fluid's model set built on the
port's Fluid API — the image classifiers mnist, resnet, vgg and
se_resnext, DeepFM, the stacked LSTM, machine translation (with its beam
decoder) — and the book's word2vec; each module's `build(...)` declares
its data vars and network in the current program and returns what a
training loop needs. ``transformer`` is the native flagship: plain
functions on tensors over a parameter tree."""

from . import (deepfm, machine_translation, mnist, resnet,  # noqa: F401
               se_resnext, stacked_lstm, transformer, transformer_fluid,
               vgg, word2vec)
