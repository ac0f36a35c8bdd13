"""The port's control flow held against the JAX package on the CPU: each
test of ``tests/test_control_flow.py`` built in both packages from the
same layers, run from the same weights (the JAX startup's values copied
into the port's scope) on the same seeded feeds.

Tolerances: bitwise where the ops are elementwise or exact (the loops'
counters and sums, the branches, the row merge, the step-function
schedule); fp32 rtol 1e-6 of each element plus 1e-6 of the tensor's
largest where a reduction or a product is summed in another order (the
RNNs' products, the While's grads, the trained weights), and the losses of 25 training steps to rtol 1e-5 plus 1e-6 of
the first loss (the error compounds through the steps, and the loss
falls to ~1e-13 of its start).

Where the JAX test pins a mechanism of the traced loop, the port test
asserts the port's documented behaviour instead: a tensor array carried
through a While is, in the JAX package, a fixed-capacity buffer whose
unwritten tail is zeros (and it warns); in the port it is a list holding
exactly what was written, so the concat has the live entries only and
nothing warns. The cond and While predicates are read on the host, one
read a cond and one a trip (``ops.controlflow.host_syncs``).
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core.scope import Scope as JScope

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.ops import controlflow as p_cf
from torch_parity import (  # noqa: F401 (the autouse fixture)
    pin_jax_init_draw as _pin_jax_init_draw)


class _Run:
    """One package's program, startup, executor and scope."""

    def __init__(self, fluid, unique_name, build):
        self.fluid = fluid
        self.main, self.startup = fluid.Program(), fluid.Program()
        with unique_name.guard(), fluid.program_guard(self.main,
                                                      self.startup):
            self.out = build(fluid)
        if fluid is jfluid:
            self.exe, self.scope = jfluid.Executor(jfluid.CPUPlace()), \
                JScope()
        else:
            self.exe, self.scope = pfluid.Executor("cpu"), pfluid.Scope()
        self.exe.run(self.startup, scope=self.scope)

    def run(self, feed=None, fetch=None):
        fetch = [v.name if hasattr(v, "name") else v
                 for v in (fetch if fetch is not None else self.out)]
        out = self.exe.run(self.main, feed=feed or {}, fetch_list=fetch,
                           scope=self.scope)
        return [np.asarray(o) for o in out]


def _pair(build):
    """The program built in both packages; the port's scope takes the
    JAX startup's persistables (int32 there: x64 is off; int64 in the
    port, as declared)."""
    j = _Run(jfluid, j_unique, build)
    p = _Run(pfluid, p_unique, build)
    names = [v.name for v in j.main.global_block().vars.values()
             if v.persistable and j.scope.get(v.name) is not None]
    arrays = {}
    for n in names:
        a = np.asarray(j.scope.get(n))
        want = p.main.global_block().var(n).dtype
        arrays[n] = a.astype(np.int64) if want == "int64" else a
    scope_from_numpy(p.scope, arrays)
    return j, p


def _same(got, want, rtol=0.0):
    """Bitwise, or with `rtol` to rtol of each element plus rtol of the
    tensor's largest (an element of a sum near 0 keeps the rounding of
    its larger terms)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if rtol:
            np.testing.assert_allclose(
                g, w, rtol=rtol, atol=rtol * float(np.abs(w).max()))
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype))


def test_while_loop_sums():
    def build(fluid):
        L = fluid.layers
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        ten = L.fill_constant(shape=[1], dtype="int64", value=10)
        acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = L.less_than(x=i, y=ten)
        loop = L.While(cond=cond)
        with loop.block():
            L.increment(x=acc, value=2.0, in_place=True)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=ten, cond=cond)
        return [acc, i]

    j, p = _pair(build)
    p_cf.reset_counts()
    got = p.run()
    assert p_cf.host_syncs == {"cond": 0, "while": 11}  # 10 trips, 1 exit
    _same(got, j.run())
    assert float(got[0][0]) == 20.0 and int(got[1][0]) == 10


def _cond_build(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32")
    flag = L.data(name="flag", shape=[1], dtype="bool")
    return [L.cond(flag, lambda: L.scale(x, scale=2.0),
                   lambda: L.scale(x, scale=-1.0))]


def test_cond_selects_branch():
    j, p = _pair(_cond_build)
    xd = np.arange(8, dtype=np.float32).reshape(2, 4)
    for flag in (True, False):
        feed = {"x": xd, "flag": np.array([flag])}
        p_cf.reset_counts()
        got = p.run(feed)
        assert p_cf.host_syncs["cond"] == 1
        _same(got, j.run(feed))
        np.testing.assert_array_equal(got[0], xd * 2.0 if flag else -xd)


def test_cond_gradient_flows():
    def build(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[4], dtype="float32")
        flag = L.data(name="flag", shape=[1], dtype="bool")
        w = L.create_parameter(shape=[4, 4], dtype="float32", name="w_cond")
        h = L.mul(x, w)
        out = L.cond(flag, lambda: L.scale(h, scale=3.0),
                     lambda: L.scale(h, scale=1.0))
        loss = L.mean(out)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss, "w_cond@GRAD", "w_cond"]

    j, p = _pair(build)
    before = p.scope.get("w_cond").numpy().copy()
    for flag in (True, False):
        feed = {"x": np.ones((2, 4), np.float32), "flag": np.array([flag])}
        got = p.run(feed)
        _same(got, j.run(feed), rtol=1e-6)
        np.testing.assert_allclose(got[1], np.full((4, 4), (
            3.0 if flag else 1.0) / 4), rtol=1e-6)
    assert not np.allclose(before, p.scope.get("w_cond").numpy())


def _piecewise(fluid):
    return [fluid.layers.piecewise_decay(boundaries=[3, 6],
                                         values=[1.0, 0.5, 0.1])]


def test_switch_piecewise():
    j, p = _pair(_piecewise)
    got, want = [], []
    for _ in range(8):
        p_cf.reset_counts()
        got.append(float(p.run()[0][0]))
        # one predicate read a case and one for the default
        assert p_cf.host_syncs["cond"] == 3
        want.append(float(j.run()[0][0]))
    assert got == want
    np.testing.assert_array_equal(
        np.float32(got), np.float32([1.0, 1.0, 0.5, 0.5, 0.5, 0.1, 0.1, 0.1]))


T, B, D = 5, 3, 4


def _rnn_build(fluid, remat=False, grad=False, tanh=False):
    L = fluid.layers
    x = L.data(name="x", shape=[B, D], dtype="float32")   # time-major
    x.shape = (T, B, D)
    h0 = L.fill_constant(shape=[B, D], dtype="float32", value=0.0)
    w = L.create_parameter(shape=[D, D], dtype="float32", name="w_rnn")
    rnn = L.StaticRNN(remat=remat)
    with rnn.step():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(init=h0)
        if tanh:
            h = L.tanh(L.elementwise_add(L.mul(x_t, w), h_prev))
        else:
            h = L.scale(L.elementwise_add(x_t, h_prev), scale=0.5)
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    out = rnn()
    if not grad:
        return [out]
    loss = L.mean(out)
    fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return [loss, out, "w_rnn@GRAD", "w_rnn"]


def test_static_rnn_matches_numpy_scan():
    j, p = _pair(_rnn_build)
    xd = np.random.RandomState(0).rand(T, B, D).astype(np.float32)
    got = p.run({"x": xd})
    _same(got, j.run({"x": xd}))
    h, want = np.zeros((B, D), np.float32), []
    for t in range(T):
        h = 0.5 * (xd[t] + h)
        want.append(h)
    np.testing.assert_allclose(got[0], np.stack(want), rtol=1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_static_rnn_gradient_to_params(remat):
    """The grad and the SGD update of the weight the body reads, against
    JAX's; with remat the replayed steps give what the recorded loop
    gives."""
    j, p = _pair(lambda f: _rnn_build(f, remat=remat, grad=True, tanh=True))
    xd = np.random.RandomState(1).rand(T, B, D).astype(np.float32)
    before = p.scope.get("w_rnn").numpy().copy()
    got = p.run({"x": xd})
    _same(got, j.run({"x": xd}), rtol=1e-6)
    assert not np.allclose(before, got[3])


def test_dynamic_rnn_respects_lengths():
    Bd, Td, Dd = 3, 6, 2

    def build(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[Td, Dd], dtype="float32")
        lens = L.data(name="lens", shape=[1], dtype="int64")
        drnn = L.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x, sequence_length=lens)
            h_prev = drnn.memory(shape=[Bd, Dd], value=0.0)
            h = L.elementwise_add(x_t, h_prev)
            drnn.update_memory(h_prev, h)
            drnn.output(h)
        return [drnn()]

    j, p = _pair(build)
    feed = {"x": np.ones((Bd, Td, Dd), np.float32),
            "lens": np.array([[2], [4], [6]], np.int64)}
    got = p.run(feed)
    _same(got, j.run(feed))
    for b, n in enumerate([2, 4, 6]):
        want = np.arange(1, Td + 1).astype(np.float32)
        want[n:] = 0.0
        np.testing.assert_array_equal(got[0][b, :, 0], want)


def test_ifelse_rowwise_merge():
    def build(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[1], dtype="float32")
        zero = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        ie = L.IfElse(L.greater_than(x, zero))
        with ie.true_block():
            ie.output(L.scale(x, scale=10.0))
        with ie.false_block():
            ie.output(L.scale(x, scale=-1.0))
        return [ie()]

    j, p = _pair(build)
    feed = {"x": np.array([[1.0], [-2.0], [3.0]], np.float32)}
    got = p.run(feed)
    _same(got, j.run(feed))
    np.testing.assert_array_equal(got[0], [[10.0], [2.0], [30.0]])


@pytest.mark.parametrize("sched,args,check", [
    ("exponential_decay", dict(learning_rate=1.0, decay_steps=2,
                               decay_rate=0.5),
     lambda v: v[1] < v[0]),
    ("noam_decay", dict(d_model=64, warmup_steps=4),
     lambda v: v[1] > v[0]),
    ("cosine_decay", dict(learning_rate=1.0, step_each_epoch=1, epochs=10),
     lambda v: v[2] < v[0]),
    ("polynomial_decay", dict(learning_rate=1.0, decay_steps=5),
     lambda v: v[2] < v[0]),
])
def test_lr_schedules(sched, args, check):
    j, p = _pair(lambda f: [getattr(f.layers, sched)(**args)])
    got = [float(p.run()[0][0]) for _ in range(4)]
    want = [float(j.run()[0][0]) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert check(got), (sched, got)


def test_optimizer_with_lr_variable():
    def build(fluid):
        L = fluid.layers
        lr = L.exponential_decay(learning_rate=0.1, decay_steps=1,
                                 decay_rate=0.9)
        x = L.data(name="x", shape=[4], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        pred = L.fc(input=x, size=1)
        loss = L.mean(L.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
        return [loss, lr]

    j, p = _pair(build)
    rng = np.random.RandomState(0)
    for _ in range(3):
        feed = {"x": rng.rand(8, 4).astype(np.float32),
                "y": rng.rand(8, 1).astype(np.float32)}
        got = p.run(feed)
        _same(got, j.run(feed), rtol=1e-6)
    assert np.isfinite(got[0]).all()


XW = np.array([[0.5, -1.0, 2.0, 0.25]], np.float32)
W0 = np.array([[0.3, 0.7, -0.2, 1.1]], np.float32)


def _while_grad_build(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32")
    w = L.create_parameter(
        shape=[1, 4], dtype="float32", name="w_while",
        default_initializer=fluid.initializer.Constant(0.0))
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    three = L.fill_constant(shape=[1], dtype="int64", value=3)
    acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    acc.stop_gradient = False
    cond = L.less_than(x=i, y=three)
    loop = L.While(cond=cond, max_trip_count=5)
    with loop.block():
        # acc <- 0.5 acc + sum(w * x): the grad depends on the trips
        s = L.reduce_sum(L.elementwise_mul(w, x))
        L.assign(L.elementwise_add(L.scale(acc, scale=0.5), s), acc)
        L.increment(x=i, value=1, in_place=True)
        L.less_than(x=i, y=three, cond=cond)
    loss = L.mean(acc)
    (_, g), = fluid.append_backward(loss, parameter_list=[w])
    return [loss, g]


def test_while_backward_matches_numeric_grad():
    """The grad of the loop's recorded trips equals the grad of JAX's
    masked scan and a central difference of the program."""
    j, p = _pair(_while_grad_build)
    j.scope.set("w_while", W0.copy())
    p.scope.set("w_while", torch.tensor(W0))
    feed = {"x": XW}
    got = p.run(feed)
    _same(got, j.run(feed), rtol=1e-6)

    def loss_at(wv):
        p.scope.set("w_while", torch.tensor(wv.astype(np.float32)))
        return float(p.run(feed)[0].ravel()[0])

    g = got[1].reshape(-1)
    eps = 1e-3
    num = np.zeros(4)
    for k in range(4):
        e = np.zeros((1, 4), np.float32)
        e[0, k] = eps
        num[k] = (loss_at(W0 + e) - loss_at(W0 - e)) / (2 * eps)
    np.testing.assert_allclose(g, num, rtol=1e-3, atol=1e-4)
    # acc_3 = (0.25 + 0.5 + 1) * sum(w * x)
    np.testing.assert_allclose(g, 1.75 * XW.reshape(-1), rtol=1e-6)


def test_while_training_inside_loop_decreases_loss():
    def build(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[4], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        w = L.create_parameter(shape=[1, 4], dtype="float32",
                               name="w_train_while")
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        two = L.fill_constant(shape=[1], dtype="int64", value=2)
        acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        acc.stop_gradient = False
        cond = L.less_than(x=i, y=two)
        loop = L.While(cond=cond, max_trip_count=4)
        with loop.block():
            s = L.reduce_sum(L.elementwise_mul(w, x))
            L.assign(L.elementwise_add(acc, s), acc)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=two, cond=cond)
        loss = L.mean(L.square_error_cost(L.reshape(acc, [-1, 1]), y))
        fluid.optimizer.SGD(0.02).minimize(loss)
        return [loss]

    j, p = _pair(build)
    feed = {"x": np.array([[1.0, -0.5, 0.25, 2.0]], np.float32),
            "y": np.array([[3.0]], np.float32)}
    got = [float(p.run(feed)[0].ravel()[0]) for _ in range(25)]
    want = [float(j.run(feed)[0].ravel()[0]) for _ in range(25)]
    # the loss falls to ~1e-13 of its start: near 0 the limit is 1e-6 of
    # the first loss (the steps' rounding, carried)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * want[0])
    assert got[-1] < got[0] * 0.05, (got[0], got[-1])


@pytest.mark.parametrize("fluid", [jfluid, pfluid], ids=["jax", "port"])
def test_while_without_max_trip_raises_on_backward(fluid):
    with fluid.program_guard(fluid.Program(), fluid.Program()):
        L = fluid.layers
        x = L.data(name="x", shape=[4], dtype="float32")
        w = L.create_parameter(shape=[1, 4], dtype="float32",
                               name="w_dynamic_while")
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        two = L.fill_constant(shape=[1], dtype="int64", value=2)
        acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        acc.stop_gradient = False
        cond = L.less_than(x=i, y=two)
        loop = L.While(cond=cond)  # no max_trip_count: forward only
        with loop.block():
            s = L.reduce_sum(L.elementwise_mul(w, x))
            L.assign(L.elementwise_add(acc, s), acc)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=two, cond=cond)
        loss = L.mean(acc)
        with pytest.raises(RuntimeError, match="max_trip_count"):
            fluid.optimizer.SGD(0.1).minimize(loss)


def test_while_carry_produced_by_trainable_ops_no_double_count():
    """A carry produced by differentiable ops before the While (input X
    and output Out of the op under one name): its input grad replaces
    the grad var. acc0 = sum(w*x), halved three times: dL/dw = x / 8."""
    xd = np.array([[1.0, -2.0, 0.5, 4.0]], np.float32)

    def build(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[4], dtype="float32")
        w = L.create_parameter(
            shape=[1, 4], dtype="float32", name="w_carry",
            default_initializer=fluid.initializer.Constant(0.2))
        acc = L.reduce_sum(L.elementwise_mul(w, x), keep_dim=True)
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        three = L.fill_constant(shape=[1], dtype="int64", value=3)
        cond = L.less_than(x=i, y=three)
        loop = L.While(cond=cond, max_trip_count=5)
        with loop.block():
            L.assign(L.scale(acc, scale=0.5), acc)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=three, cond=cond)
        loss = L.mean(acc)
        (_, g), = fluid.append_backward(loss, parameter_list=[w])
        return [g]

    j, p = _pair(build)
    got = p.run({"x": xd})
    _same(got, j.run({"x": xd}))
    np.testing.assert_array_equal(got[0].reshape(-1), 0.125 * xd.reshape(-1))


def _truncated(fluid):
    L = fluid.layers
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    n = L.fill_constant(shape=[1], dtype="int64", value=10)
    acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    cond = L.less_than(x=i, y=n)
    loop = L.While(cond=cond, max_trip_count=3)  # needs 10
    with loop.block():
        L.increment(x=acc, value=1.0, in_place=True)
        L.increment(x=i, value=1, in_place=True)
        L.less_than(x=i, y=n, cond=cond)
    return [acc, i]


def test_while_truncation_warns():
    j, p = _pair(_truncated)
    for r in (j, p):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = r.run()
        assert float(got[0][0]) == 3.0 and int(got[1][0]) == 3
        assert any("truncated" in str(w.message) for w in caught), [
            str(w.message) for w in caught]


def _array_loop(n_live, max_trip):
    def build(fluid):
        L = fluid.layers
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=n_live)
        x = L.fill_constant(shape=[2], dtype="float32", value=1.5)
        arr = L.create_array("float32")
        cond = L.less_than(x=i, y=n)
        loop = L.While(cond=cond, max_trip_count=max_trip)
        with loop.block():
            L.array_write(x=x, i=i, array=arr)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=n, cond=cond)
        out, _ = L.tensor_array_to_tensor(arr, axis=0)
        return [out]

    return build


def test_empty_array_written_inside_while():
    j, p = _pair(_array_loop(4, 4))
    got = p.run()
    _same(got, j.run())
    np.testing.assert_array_equal(got[0].reshape(-1, 2), np.full((4, 2),
                                                                  1.5))


def test_array_concat_capacity_warns_on_early_exit():
    """The JAX array buffer holds max_trip_count entries, the tail past
    the 2 live ones zeros, and warns; the port's list holds the 2 live
    entries, equal to JAX's prefix, with no warning."""
    j, p = _pair(_array_loop(2, 5))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = j.run()[0].reshape(-1, 2)
    assert any("static capacity" in str(w.message) for w in caught)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = p.run()[0].reshape(-1, 2)
    assert not caught, [str(w.message) for w in caught]
    assert want.shape == (5, 2) and got.shape == (2, 2)
    np.testing.assert_array_equal(got, want[:2])
    np.testing.assert_array_equal(want[2:], 0.0)


def test_array_write_in_a_loop_without_max_trip_raises():
    """Both packages refuse a tensor-array write in a While with no
    max_trip_count when the program runs."""
    j, p = _pair(_array_loop(3, None))
    for r in (j, p):
        with pytest.raises(RuntimeError, match="max_trip_count"):
            r.run()


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mode", ["reverse", "max_len"])
def test_recurrent_reverse_and_max_len_match_jax(mode, remat):
    """The recurrent op's other attrs, set on the op of both packages'
    programs: `is_reverse` runs the steps from the last (outputs stay at
    their step's index); with no step input, `max_len` gives the length.
    The grads of the weight the body reads, recorded or replayed."""
    def build(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[B, D], dtype="float32")
        x.shape = (T, B, D)
        h0 = L.fill_constant(shape=[B, D], dtype="float32", value=0.5)
        w = L.create_parameter(shape=[D, D], dtype="float32", name="w_rev")
        rnn = L.StaticRNN(remat=remat)
        with rnn.step():
            if mode == "reverse":
                inp = rnn.step_input(x)
            else:
                inp = L.scale(x, scale=0.0, bias=0.25)   # a closure read
            h_prev = rnn.memory(init=h0)
            h = L.tanh(L.elementwise_add(L.mul(h_prev, w), inp
                                         if mode == "reverse" else h_prev))
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()
        op = [o for o in fluid.default_main_program().global_block().ops
              if o.type == "recurrent"][0]
        if mode == "reverse":
            op.attrs["is_reverse"] = True
        else:
            op.attrs["max_len"] = 3
        loss = L.mean(out)
        (_, g), = fluid.append_backward(loss, parameter_list=[w])
        return [out, rnn.final_memories[0], g]

    j, p = _pair(build)
    xd = np.random.RandomState(3).rand(T, B, D).astype(np.float32)
    got = p.run({"x": xd})
    _same(got, j.run({"x": xd}), rtol=1e-6)
    assert got[0].shape[0] == (T if mode == "reverse" else 3)


def test_state_plan_sees_what_a_branch_writes():
    """The executor's state plan takes a persistable a branch writes only
    from the cond op's outputs: the piecewise rate, the parameters the
    merged update writes and the merge buffers are step outputs; Adam's
    moments and beta powers, written in the branch but not listed, are
    not (the JAX package's plan, which both run)."""
    from paddle_tpu_torch.executor import classify_persistable_state

    def build(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[4], dtype="float32")
        y = L.fc(x, 3, param_attr=fluid.ParamAttr(name="w_gm"),
                 bias_attr=False)
        loss = L.mean(y)
        lr = L.piecewise_decay([2], [0.1, 0.01])
        fluid.optimizer.GradientMergeOptimizer(
            fluid.optimizer.Adam(lr), k_steps=2).minimize(loss)
        return [loss, lr]

    j, p = _pair(build)
    _, _, out = classify_persistable_state(p.main.global_block(), [])
    lr = p.out[1].name
    assert {lr, "w_gm", "w_gm_grad_merge_0", "@gradient_merge_step@",
            "@step_counter@"} <= set(out)
    assert not [n for n in out if "moment" in n or "_pow_acc" in n]
    for _ in range(4):
        _same(p.run({"x": np.ones((2, 4), np.float32)}),
              j.run({"x": np.ones((2, 4), np.float32)}), rtol=1e-6)
