"""The port's Fluid front end builds the same programs as the JAX
package: for ``transformer_fluid.build`` (small config, fp32 and the
headline bf16 + legacy AMP decorator), the main and startup programs
have the same ops in order, the same slot -> var names, the same attrs
(the per-op random seeds, which come from process-wide counters, aside),
and the same var declarations — names, shapes, dtypes, persistability —
so weights cross between the packages by name."""

import pytest

import paddle_tpu as jfluid
from paddle_tpu import unique_name as j_unique
from paddle_tpu.models import transformer_fluid as j_tf

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.models import transformer_fluid as p_tf

CFG = dict(vocab_size=96, d_model=64, n_heads=2, n_layers=2, d_ff=128,
           seq_len=128, head_chunk=64)
# counters shared by every program a process builds
_SEED_ATTRS = {"__op_seed__"}
# the JAX decorator always makes dynamic loss scaling's step counters;
# the port scales statically only and makes none
_JAX_ONLY = ("good_steps", "bad_steps")


def _jax_only(name):
    return name.startswith(_JAX_ONLY)


def _build(fluid, tf, unique_name, dtype, amp):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = tf.build(remat=False, dtype=dtype, **CFG)
        opt = fluid.optimizer.SGD(0.01)
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(
                opt, init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
        opt.minimize(loss)
    return main, startup


def _attrs(op):
    out = {}
    for k, v in op.attrs.items():
        if k in _SEED_ATTRS:
            continue
        if k == "__fwd_op__":  # the forward op, by its place in the block
            v = ("op", v.block.ops.index(v), v.type)
        out[k] = v
    return out


def _ops(program):
    return [(op.type,
             {s: [v.name for v in vs] for s, vs in op.inputs.items()},
             {s: [v.name for v in vs] for s, vs in op.outputs.items()},
             _attrs(op))
            for op in program.global_block().ops
            if not all(_jax_only(v.name) for vs in op.outputs.values()
                       for v in vs)]


def _vars(program):
    return {v.name: (v.shape, v.dtype, v.persistable, v.stop_gradient,
                     type(v).__name__,
                     getattr(v, "trainable", None),
                     getattr(v, "shard_spec", None))
            for v in program.global_block().vars.values()
            if not _jax_only(v.name)}


@pytest.mark.parametrize("dtype,amp", [("float32", False),
                                       ("bfloat16", True)])
def test_programs_match_the_jax_package(dtype, amp):
    j_main, j_start = _build(jfluid, j_tf, j_unique, dtype, amp)
    p_main, p_start = _build(pfluid, p_tf, p_unique, dtype, amp)
    for name, jp, pp in (("main", j_main, p_main),
                         ("startup", j_start, p_start)):
        j_ops, p_ops = _ops(jp), _ops(pp)
        assert [o[0] for o in p_ops] == [o[0] for o in j_ops], name
        for i, (jo, po) in enumerate(zip(j_ops, p_ops)):
            assert po == jo, "%s op %d (%s)" % (name, i, jo[0])
        assert _vars(pp) == _vars(jp), name
    params = {p.name: (p.shape, p.dtype) for p in p_main.all_parameters()}
    assert params == {p.name: (p.shape, p.dtype)
                      for p in j_main.all_parameters()}
    # the shared head weight, the attention and fc weights by their names
    assert {"lm_head_w", "embedding_0.w_0", "fc_0.w_0",
            "fused_multihead_attention_0_wq"} <= set(params)
    assert p_main.param_grad_map == j_main.param_grad_map


@pytest.mark.parametrize("for_test", [False, True])
def test_clone_matches_the_jax_package(for_test):
    """``Program.clone``: for_test=True prunes the backward, optimizer and
    loss-scaling ops as the JAX package's clone does (the bf16 program
    under the AMP decorator has all three), for_test=False keeps every
    op; grad ops point at the clone's own forward ops."""
    j_main, _ = _build(jfluid, j_tf, j_unique, "bfloat16", True)
    p_main, _ = _build(pfluid, p_tf, p_unique, "bfloat16", True)
    j_clone, p_clone = (j_main.clone(for_test=for_test),
                        p_main.clone(for_test=for_test))
    assert _ops(p_clone) == _ops(j_clone)
    assert _vars(p_clone) == _vars(j_clone)
    types = [op.type for op in p_clone.global_block().ops]
    if for_test:
        assert "sgd" not in types and len(types) < len(p_main.global_block()
                                                         .ops)
        assert not any("__fwd_op__" in op.attrs
                       for op in p_clone.global_block().ops)
    else:
        assert types == [op.type for op in p_main.global_block().ops]
        ops = p_clone.global_block().ops
        assert all(op.attrs["__fwd_op__"] in ops for op in ops
                   if "__fwd_op__" in op.attrs)
