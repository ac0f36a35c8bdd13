"""IO layers (parity: python/paddle/fluid/layers/io.py `data` :39)."""

from ..framework import (convert_dtype, default_main_program,
                         default_startup_program)

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, type=None,
         append_batch_size=True, stop_gradient=True):
    """Declare a feed slot. With append_batch_size=True a leading -1
    batch dim is prepended."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    main = default_main_program().current_block()
    var = main.create_var(name=name, shape=shape, dtype=convert_dtype(dtype),
                          lod_level=lod_level, is_data=True,
                          stop_gradient=stop_gradient)
    # mirrored into startup, Fluid's dual-program convention
    sb = default_startup_program().global_block()
    if not sb.has_var(name):
        sb.create_var(name=name, shape=shape, dtype=convert_dtype(dtype),
                      lod_level=lod_level, is_data=True, stop_gradient=True)
    return var
