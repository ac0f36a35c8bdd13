"""Models built on the port's Fluid API (parity: the JAX package's
``models/``): the Fluid-API Transformer LM and benchmark/fluid's model
set — the image classifiers mnist, resnet, vgg and se_resnext, DeepFM,
the stacked LSTM, machine translation (with its beam decoder) — and the
book's word2vec. Each module's `build(...)` declares its data vars and
network in the current program and returns what a training loop
needs."""

from . import (deepfm, machine_translation, mnist, resnet,  # noqa: F401
               se_resnext, stacked_lstm, transformer_fluid, vgg, word2vec)
