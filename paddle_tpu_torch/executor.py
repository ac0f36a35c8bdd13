"""Executor (parity: the JAX package's ``executor.py`` `Executor.run`
:416 and its `_CompiledStep` :99-259).

`run()` executes a program's global block op by op in eager PyTorch on
the executor's device (``core/lowering.py``): forward ops, generic grad
ops and the optimizer's update ops. Per (program, feed signature,
fetches) a `_Step` is cached that holds the persistable-state plan — which
scope tensors the step reads and which it writes — and the step's memory
plan (when each intermediate can be dropped). Parameters are updated in
place in the scope, as the JAX step does by donating its state.

Not ported: the asynchronous in-flight window, `prefetch`, the program
optimization passes, compile telemetry, RPC ops and the nan checks. A
CUDA graph of the step is later work.
"""

import numpy as np
import torch

from . import framework
from .core.lowering import LoweringContext, execute_block
from .core.place import resolve_device
from .core.scope import global_scope

__all__ = ["Executor", "global_scope"]

_INT32 = np.iinfo(np.int32)


def _feed_signature(feed):
    return tuple(sorted((k, tuple(np.shape(v)), str(v.dtype))
                        for k, v in feed.items()))


def classify_persistable_state(block, fetch_names):
    """(read_names, write_names): the persistable vars a step reads
    before writing them (they must be in the scope) and the ones it
    writes (they go back to the scope)."""
    produced, state_in, state_out = set(), [], set()
    for op in block.ops:
        for name in op.input_names():
            v = block._find_var_recursive(name)
            if v is not None and v.persistable and name not in produced \
                    and name not in state_in:
                state_in.append(name)
        for name in op.output_names():
            produced.add(name)
            v = block._find_var_recursive(name)
            if v is not None and v.persistable:
                state_out.add(name)
    for name in fetch_names:
        v = block._find_var_recursive(name)
        if v is not None and v.persistable and name not in produced \
                and name not in state_in:
            state_in.append(name)
    return state_in, sorted(state_out)


def check_feed_int64(name, value, dtype):
    """An int64 feed narrowed to a declared int32 var must fit: an id
    above 2^31 would be cut silently."""
    if value.dtype not in (torch.int64, torch.uint64) \
            or dtype != torch.int32 or value.numel() == 0:
        return
    mx, mn = int(value.max()), int(value.min())
    if mx > _INT32.max or mn < _INT32.min:
        raise ValueError("feed %r holds int64 ids outside the int32 range "
                         "of its declared var; hash them to int32 first"
                         % name)


class _Step:
    """The plan of one (program, feed signature, fetches)."""

    def __init__(self, program, feed_names, fetch_names):
        self.program = program
        self.block = block = program.global_block()
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.state_in, self.state_out = classify_persistable_state(
            block, self.fetch_names)
        self.recorded = frozenset(id(op.attrs["__fwd_op__"])
                                  for op in block.ops
                                  if "__fwd_op__" in op.attrs)
        # drop each intermediate after the last op that names it; keep
        # persistables (they go back to the scope) and fetches
        keep = set(self.fetch_names)
        last = {}
        for i, op in enumerate(block.ops):
            for name in op.input_names() + op.output_names():
                v = block._find_var_recursive(name)
                if name not in keep and not (v is not None
                                             and v.persistable):
                    last[name] = i
        self.free_after = {}
        for name, i in last.items():
            self.free_after.setdefault(i, []).append(name)

    def _feed_tensor(self, name, value, device):
        v = self.block._find_var_recursive(name)
        t = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(value))
        if v is not None and v.shape is not None:
            want = framework.torch_dtype(v.dtype)
            check_feed_int64(name, t, want)
            t = t.to(device=device, dtype=want)
        return t.to(device)

    def run(self, scope, feed, device):
        env = {}
        for name in self.state_in:
            val = scope.get(name)
            if val is None:
                raise RuntimeError(
                    "persistable var %r is not initialized — run the "
                    "startup program first (exe.run(startup_program))"
                    % name)
            env[name] = val
        for name in self.feed_names:
            env[name] = self._feed_tensor(name, feed[name], device)
        step = int(scope.get("__step_counter__", 0) or 0)
        ctx = LoweringContext(device, self.program.random_seed or 0, step,
                              self.recorded)
        execute_block(self.block, env, ctx, self.free_after)
        for name in self.state_out:
            if name in env:
                scope.set(name, env[name])
        scope.set("__step_counter__", step + 1)
        return [env[n] for n in self.fetch_names]


def _to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:  # numpy has no bf16
        t = t.float()
    return t.cpu().numpy()


class Executor:
    """Runs programs on one device: `place=None` is ``cuda:0`` (and raises
    without CUDA); the tests pass ``place="cpu"``."""

    def __init__(self, place=None):
        self.device = resolve_device(place)
        self._cache = {}

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run `program` (default: the default main program) once.
        Feeds are numpy arrays or tensors, cast to their declared dtype
        and moved to the device; fetches come back as numpy arrays (bf16
        as float32) or, with return_numpy=False, as device tensors."""
        if program is None:
            program = framework.default_main_program()
        feed = {k: v if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in (feed or {}).items()}
        scope = scope if scope is not None else global_scope()
        fetch_names = [v.name if isinstance(v, framework.Variable)
                       else str(v) for v in (fetch_list or [])]
        key = (id(program), program.version, _feed_signature(feed),
               tuple(fetch_names))
        step = self._cache.get(key)
        if step is None:
            step = self._cache[key] = _Step(program, feed.keys(),
                                            fetch_names)
        fetches = step.run(scope, feed, self.device)
        if return_numpy:
            return [_to_numpy(t) for t in fetches]
        return fetches
