"""Model save/load (parity: the JAX package's ``io.py`` :58-240 —
save_vars, save_params, save_persistables and their loads,
save_inference_model, save_train_model, load_inference_model) and moving
weights between the JAX package and the port.

The formats are the JAX package's, so a directory either package writes
loads in the other: one ``.npy`` a var or a combined ``np.savez`` file,
and for an inference model a sealed ``__model__`` (the program's JSON
with its feed and fetch names in the frame of ``core/native.py``) beside
``__params__.npz``. Values are written as numpy arrays (a bf16 tensor as
its raw 2-byte words, the void ``|V2`` that numpy writes for the JAX
package's bfloat16 arrays) and load as tensors on the executor's device.

`scope_from_numpy` fills the port's scope from numpy arrays by name —
the JAX scope's parameters as ``np.asarray`` gives them — so both
packages can run the same program from the same weights. bf16 arrives
as ml_dtypes' ``bfloat16`` numpy dtype and is carried bit for bit.
"""

import json
import os

import numpy as np
import torch

from . import framework
from .core.place import resolve_device
from .core.scope import global_scope

__all__ = [
    "save_vars", "save_params", "save_persistables",
    "load_vars", "load_params", "load_persistables",
    "save_inference_model", "load_inference_model", "save_train_model",
    "get_program_parameter", "get_program_persistable_vars",
    "scope_from_numpy",
]


def _to_tensor(arr):
    # a copy: np.asarray of a JAX array may alias a buffer JAX reuses
    arr = np.array(arr, order="C", copy=True)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: same bits as torch's
        return torch.from_numpy(arr.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def _to_numpy(value):
    """A scope value as the numpy array the JAX package saves for it."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(value)


def _load_value(arr, var, device):
    """A loaded array as a tensor on `device`; a void 2-byte array is a
    bf16 var's raw words."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
            and var is not None and var.dtype == "bfloat16":
        arr = arr.view(np.int16)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16).to(device)
    return _to_tensor(arr).to(device)


def _device(executor):
    return executor.device if executor is not None else resolve_device(None)


def _is_persistable(var):
    return var.persistable and not var.is_data


def _is_parameter(var):
    return isinstance(var, framework.Parameter)


def get_program_parameter(program):
    return [v for v in program.global_block().vars.values()
            if _is_parameter(v)]


def get_program_persistable_vars(program):
    return [v for v in program.list_vars() if _is_persistable(v)]


def _gather(scope, var_list):
    shards = getattr(scope, "_ptpu_shards", {})
    held = sorted(v.name for v in var_list if v.name in shards)
    if held:
        raise NotImplementedError(
            "the scope holds this rank's shards of %s (a tensor-parallel or "
            "ReduceStrategy.Reduce step cut them): saving them is the "
            "multi-process checkpoint save, not ported (ROADMAP.md Queue 1 "
            "item 9); gather them with compiler.gather_persistables first"
            % held[:4])
    out = {}
    for v in var_list:
        val = scope.get(v.name)
        if val is None:
            raise RuntimeError("var %r has no value in scope; run startup "
                               "program before saving" % v.name)
        out[v.name] = _to_numpy(val)
    return out


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    main_program = main_program or framework.default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    arrays = _gather(global_scope(), vars)
    os.makedirs(dirname, exist_ok=True)
    if filename is not None:
        np.savez(os.path.join(dirname, filename), **arrays)
    else:
        for name, arr in arrays.items():
            np.save(os.path.join(dirname, name.replace("/", "__")), arr)


def save_params(executor, dirname, main_program=None, filename=None):
    main_program = main_program or framework.default_main_program()
    save_vars(executor, dirname, main_program,
              vars=get_program_parameter(main_program), filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    main_program = main_program or framework.default_main_program()
    save_vars(executor, dirname, main_program,
              vars=get_program_persistable_vars(main_program),
              filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Set each var of `vars` (default: the program's vars passing
    `predicate`) in the current scope from `dirname`, as a tensor on the
    executor's device."""
    main_program = main_program or framework.default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    scope, device = global_scope(), _device(executor)
    if filename is not None:
        path = os.path.join(dirname, filename)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path += ".npz"  # np.savez appends the suffix on save
        with np.load(path) as data:
            for v in vars:
                if v.name not in data:
                    raise RuntimeError("var %r missing in %s"
                                       % (v.name, filename))
                scope.set(v.name, _load_value(data[v.name], v, device))
    else:
        for v in vars:
            path = os.path.join(dirname, v.name.replace("/", "__") + ".npy")
            if not os.path.exists(path):
                raise RuntimeError("no saved file for var %r at %s"
                                   % (v.name, path))
            scope.set(v.name, _load_value(np.load(path), v, device))


def load_params(executor, dirname, main_program=None, filename=None):
    main_program = main_program or framework.default_main_program()
    load_vars(executor, dirname, main_program,
              vars=get_program_parameter(main_program), filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    main_program = main_program or framework.default_main_program()
    load_vars(executor, dirname, main_program,
              vars=get_program_persistable_vars(main_program),
              filename=filename)


def _prune_program(program, feed_names, fetch_vars):
    """The inference clone of `program` keeping only the ops the fetch
    vars depend on."""
    block = program.global_block()
    needed = set(v.name for v in fetch_vars)
    keep = [False] * len(block.ops)
    for i in reversed(range(len(block.ops))):
        op = block.ops[i]
        if any(n in needed for n in op.output_names()):
            keep[i] = True
            needed.update(op.input_names())
    pruned = program.clone(for_test=True)
    pb = pruned.global_block()
    pb.ops = [op for i, op in enumerate(pb.ops) if keep[i]]
    return pruned


def _write_sealed_model(dirname, program, feed_names, fetch_names,
                        model_filename=None, params_filename=None,
                        param_vars=None):
    """Write the sealed ``__model__`` frame and, when param_vars is not
    None, the ``__params__`` savez of their scope values."""
    from .core import native

    os.makedirs(dirname, exist_ok=True)
    meta = {
        "program": json.loads(program.to_json()),
        "feed_names": list(feed_names),
        "fetch_names": list(fetch_names),
    }
    model_path = os.path.join(dirname, model_filename or "__model__")
    with open(model_path, "wb") as f:
        f.write(native.program_seal(json.dumps(meta).encode("utf-8")))
    if param_vars is not None:
        arrays = _gather(global_scope(), param_vars)
        np.savez(os.path.join(dirname, params_filename or "__params__"),
                 **arrays)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False):
    """Save the inference program that computes `target_vars` from the
    feeds, and (unless `program_only`) the persistables its ops use.
    Returns the fetch names."""
    main_program = main_program or framework.default_main_program()
    pruned = _prune_program(main_program, feeded_var_names, target_vars)
    fetch_names = [v.name for v in target_vars]
    params = None
    if not program_only:
        used = set()
        for op in pruned.global_block().ops:
            used.update(op.input_names())
            used.update(op.output_names())
        params = [v for v in pruned.list_vars()
                  if _is_persistable(v) and v.name in used]
    _write_sealed_model(dirname, pruned, feeded_var_names, fetch_names,
                        model_filename, params_filename, params)
    return fetch_names


def save_train_model(dirname, feeded_var_names, target_vars, executor,
                     main_program=None):
    """Save the whole training program (backward and optimizer ops
    included) and every persistable, in the format load_inference_model
    reads."""
    main_program = main_program or framework.default_main_program()
    params = [v for v in main_program.list_vars() if _is_persistable(v)]
    _write_sealed_model(dirname, main_program, feeded_var_names,
                        [v.name for v in target_vars], param_vars=params)
    return [v.name for v in target_vars]


_REFERENCE_FORMAT = (
    "the reference framework's protobuf ProgramDesc (reference_format.py) "
    "is not ported to paddle_tpu_torch: ROADMAP.md Queue 1 item 11")


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, pserver_endpoints=None,
                         reference_format=None):
    """[program, feed names, fetch vars] of a saved model, its params set
    in the current scope as tensors on the executor's device (None: the
    card). `reference_format=True`, or a ``__model__`` that is neither a
    sealed frame nor JSON, raises NotImplementedError."""
    from .core import native, serde

    if reference_format:
        raise NotImplementedError(_REFERENCE_FORMAT)
    model_path = os.path.join(dirname, model_filename or "__model__")
    with open(model_path, "rb") as f:
        raw = f.read()
    if native.is_sealed(raw):
        meta = json.loads(native.program_unseal(raw).decode("utf-8"))
    else:
        try:
            meta = json.loads(raw.decode("utf-8"))  # the pre-seal format
        except ValueError:  # UnicodeDecodeError is one
            raise NotImplementedError(_REFERENCE_FORMAT) from None
    program = serde.program_from_desc(meta["program"])
    params_path = os.path.join(dirname, params_filename or "__params__")
    if not params_path.endswith(".npz"):
        params_path += ".npz"
    if os.path.exists(params_path):
        scope, device = global_scope(), _device(executor)
        block = program.global_block()
        with np.load(params_path) as data:
            for name in data.files:
                scope.set(name, _load_value(data[name],
                                            block._find_var_recursive(name),
                                            device))
    feed_names = meta["feed_names"]
    fetch_vars = [program.global_block().var(n) for n in meta["fetch_names"]]
    return [program, feed_names, fetch_vars]


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
