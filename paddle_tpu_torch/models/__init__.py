"""Models built on the port's Fluid API (parity: the JAX package's
``models/``): the Fluid-API Transformer LM and the image classifiers of
benchmark/fluid — mnist, resnet, vgg and se_resnext. Each module's
`build(...)` declares its data vars and network in the current program
and returns what a training loop needs."""

from . import mnist, resnet, se_resnext, transformer_fluid, vgg  # noqa: F401
