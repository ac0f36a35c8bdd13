"""The port's learning-rate schedules held against the JAX package's on
the CPU: each schedule appends the same ops, and its value over 12 runs
of its program equals JAX's within rtol 1e-6 (the powers, exponentials
and cosines are XLA's on one side and torch's on the other: a few fp32
ulps). The step counter `@step_counter@` reads the number of runs in
both: int64 in the port, as declared, and int32 in the JAX scope (x64
is off there). `piecewise_decay` (a Switch of less_than cases) gives
JAX's rates bitwise."""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core.scope import Scope as JScope

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import unique_name as p_unique

SCHEDULES = {
    "noam": lambda L: L.noam_decay(64, 4),
    "exponential": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(
        0.1, 3, 0.5, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 3, 0.5),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(
        0.1, 3, 0.5, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 3, 0.5),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(
        0.1, 3, 0.5, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 5, 0.001, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(
        0.1, 5, 0.001, power=2.0, cycle=True),
    "cosine": lambda L: L.cosine_decay(0.1, 3, 4),
    "linear_warmup": lambda L: L.linear_lr_warmup(0.1, 4, 0.0, 0.1),
    "linear_warmup_over_exponential": lambda L: L.linear_lr_warmup(
        L.exponential_decay(1e-3, 1000, 0.9), warmup_steps=4, start_lr=0.0,
        end_lr=1e-3),
}


def _build(fluid, unique_name, name):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        lr = SCHEDULES[name](fluid.layers)
    return main, startup, lr


def _ops(program):
    return [(op.type,
             {s: [v.name for v in vs] for s, vs in op.inputs.items()},
             {s: [v.name for v in vs] for s, vs in op.outputs.items()},
             op.attrs)
            for op in program.global_block().ops]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_over_12_runs(name):
    jm, js, jlr = _build(jfluid, j_unique, name)
    pm, ps, plr = _build(pfluid, p_unique, name)
    assert _ops(pm) == _ops(jm)
    counter = pm.global_block().var("@step_counter@")
    assert (counter.dtype, counter.persistable) == ("int64", True)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    pexe, pscope = pfluid.Executor("cpu"), pfluid.Scope()
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    got, want = [], []
    for run in range(1, 13):
        jv, jc = jexe.run(jm, fetch_list=[jlr, "@step_counter@"],
                          scope=jscope)
        pv, pc = pexe.run(pm, fetch_list=[plr, "@step_counter@"],
                          scope=pscope)
        assert pc.dtype == np.int64 and int(pc[0]) == run
        assert int(np.asarray(jc)[0]) == run
        want.append(float(np.asarray(jv).reshape(-1)[0]))
        got.append(float(pv.reshape(-1)[0]))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert len(set(want)) > 1  # the schedule moved


def test_linear_warmup_reads_its_closed_form():
    """The phase-6e schedule: 1e-3 * t / 4 while t < 4, then
    1e-3 * 0.9^(t / 1000), t the run's counter."""
    pm, ps, plr = _build(pfluid, p_unique, "linear_warmup_over_exponential")
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(ps, scope=scope)
    for t in range(1, 9):
        v, = exe.run(pm, fetch_list=[plr], scope=scope)
        want = 1e-3 * t / 4 if t < 4 else 1e-3 * 0.9 ** (t / 1000)
        np.testing.assert_allclose(v[0], want, rtol=1e-6)


def test_piecewise_decay_raises_naming_the_slice():
    """piecewise_decay raised, naming the control-flow slice, until that
    slice landed; now it is held against JAX's: the same global ops and
    Switch sub-blocks, and over 12 runs (boundaries 2 and 4, so every
    case and the default run) the same rate, bitwise (the Switch writes
    constants), read from its persistable var."""
    def build(fluid, unique_name):
        main, startup = fluid.Program(), fluid.Program()
        with unique_name.guard(), fluid.program_guard(main, startup):
            lr = fluid.layers.piecewise_decay([2, 4], [0.1, 0.01, 0.001])
        return main, startup, lr

    jm, js, jlr = build(jfluid, j_unique)
    pm, ps, plr = build(pfluid, p_unique)
    assert plr.name == jlr.name and plr.persistable
    assert [[op.type for op in b.ops] for b in pm.blocks] == [
        [op.type for op in b.ops] for b in jm.blocks]
    assert [op.type for op in pm.global_block().ops].count("cond") == 3
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    pexe, pscope = pfluid.Executor("cpu"), pfluid.Scope()
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    got, want = [], []
    for _ in range(12):
        want.append(float(np.asarray(jexe.run(jm, fetch_list=[jlr],
                                               scope=jscope)[0])[0]))
        got.append(float(pexe.run(pm, fetch_list=[plr],
                                  scope=pscope)[0][0]))
    assert got == want
    np.testing.assert_array_equal(
        np.float32(got), np.float32([0.1] + [0.01] * 2 + [0.001] * 9))
