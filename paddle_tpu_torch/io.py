"""Moving weights between the JAX package and the port.

`scope_from_numpy` fills the port's scope from numpy arrays by name —
the JAX scope's parameters as ``np.asarray`` gives them — so both
packages can run the same program from the same weights. bf16 arrives
as ml_dtypes' ``bfloat16`` numpy dtype and is carried bit for bit.
"""

import numpy as np
import torch

__all__ = ["scope_from_numpy"]


def _to_tensor(arr):
    # a copy: np.asarray of a JAX array may alias a buffer JAX reuses
    arr = np.array(arr, order="C", copy=True)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: same bits as torch's
        return torch.from_numpy(arr.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def scope_from_numpy(scope, arrays, device=None):
    """Set scope[name] = arrays[name] for every name, on `device` (default:
    the device of the tensor it replaces). Each name must already hold a
    tensor (run the startup program first) of the same shape and dtype;
    anything else raises, naming the var."""
    for name, arr in arrays.items():
        old = scope.get(name)
        if not isinstance(old, torch.Tensor):
            raise KeyError("scope holds no tensor named %r (run the "
                           "startup program first)" % name)
        t = _to_tensor(np.asarray(arr))
        if tuple(t.shape) != tuple(old.shape) or t.dtype != old.dtype:
            raise ValueError("%r: got %s %s, the scope holds %s %s"
                             % (name, t.dtype, tuple(t.shape), old.dtype,
                                tuple(old.shape)))
        scope.set(name, t.to(device if device is not None else old.device))
