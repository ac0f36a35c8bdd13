"""The parity harness shared by the tests that hold the PyTorch port
against the JAX package: pin the JAX package's init draw, carry a JAX
scope's arrays into a port scope (``paddle_tpu_torch.io.scope_from_numpy``)
and compare two programs op by op.

A test module takes a fixture by importing it:

    from torch_parity import pin_jax_init_draw  # noqa: F401 (autouse)
"""

import numpy as np
import pytest

from paddle_tpu_torch.io import scope_from_numpy

# attrs drawn from process-wide counters, which differ between packages
SEED_ATTRS = frozenset({"__op_seed__"})


def set_jax_init_counters(value):
    """Set the JAX package's process-wide init counters, which pick the
    initial weights its startup program draws."""
    from paddle_tpu import initializer, layer_helper

    initializer._global_seed_counter[0] = value
    layer_helper._op_seed_counter[0] = value


@pytest.fixture(autouse=True)
def pin_jax_init_draw():
    """Start the JAX package's process-wide init counters at 0 (a fresh
    process's draw, whichever JAX tests ran before in this process) and
    restore them after."""
    from paddle_tpu import initializer, layer_helper

    saved = (initializer._global_seed_counter[0],
             layer_helper._op_seed_counter[0])
    set_jax_init_counters(0)
    yield
    (initializer._global_seed_counter[0],
     layer_helper._op_seed_counter[0]) = saved


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the importing module's tests on one torch thread, restored
    after: their eager ops are small, so one thread runs them fastest,
    and the parallel test run's workers share the machine's cores
    (torch's default of a thread a core in each worker oversubscribes
    them many times over)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def persistable_names(program):
    return sorted(v.name for v in program.global_block().vars.values()
                  if v.persistable)


def carry_scope(jscope, pscope, names):
    """Copy the JAX scope's arrays `names` into the port's scope; returns
    the copies (the JAX executor donates its state buffers to the next
    step, so they are copied before any run)."""
    start = {n: np.array(jscope.get(n), copy=True) for n in names}
    scope_from_numpy(pscope, start)
    return start


def op_attrs(op):
    out = {}
    for k, v in op.attrs.items():
        if k in SEED_ATTRS:
            continue
        if k == "__fwd_op__":  # the forward op, by its place in the block
            v = ("op", v.block.ops.index(v), v.type)
        elif type(v).__name__ == "Block":  # a sub-block, by its index
            v = ("block", v.idx)
        out[k] = v
    return out


def program_ops(program):
    """(type, inputs, outputs, attrs) of each op of the global block."""
    return [(op.type,
             {s: [v.name for v in vs] for s, vs in op.inputs.items()},
             {s: [v.name for v in vs] for s, vs in op.outputs.items()},
             op_attrs(op))
            for op in program.global_block().ops]


def program_vars(program):
    return {v.name: (v.shape, v.dtype, v.persistable, v.stop_gradient,
                     type(v).__name__, getattr(v, "trainable", None),
                     getattr(v, "shard_spec", None))
            for v in program.global_block().vars.values()}


def assert_programs_equal(jprog, pprog, label=""):
    """The same ops in order (slots, var names, attrs but the seeds) and
    the same vars (shape, dtype, persistability, stop_gradient, kind,
    trainability, sharding)."""
    j_ops, p_ops = program_ops(jprog), program_ops(pprog)
    assert [o[0] for o in p_ops] == [o[0] for o in j_ops], label
    for i, (jo, po) in enumerate(zip(j_ops, p_ops)):
        assert po == jo, "%s op %d (%s)" % (label, i, jo[0])
    assert program_vars(pprog) == program_vars(jprog), label
