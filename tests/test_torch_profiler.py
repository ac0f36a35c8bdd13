"""The port's ``profiler.py`` held against the JAX package's: the event
table (``record_event``, ``event_stats``, ``_print_summary``), sessions
(one at a time; the lowering's ``fluid/`` op ranges only inside one) and
the device table by Fluid op: ``device_op_profile``'s rows in the JAX
row schema, built from a ``torch.profiler`` chrome trace by giving each
CUDA kernel to the innermost op range around its launch, kernels
launched from autograd's thread inside a grad op's range included, and
the kernels outside every range kept as one ``(unattributed)`` row.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu import profiler as jprofiler

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import profiler
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.core import lowering
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

MAIN, AUTOGRAD, WORKER = 11, 12, 13
FWD = "fused_multihead_attention__attn_0.tmp_0"
GRAD = "fused_multihead_attention_grad__q_GRAD"


def _ev(name, cat, ts, dur, tid, pid=4242, **args):
    ev = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
          "ts": ts, "dur": dur}
    if args:
        ev["args"] = args
    return ev


def _range(op, ts, dur, tid=MAIN):
    return _ev("fluid/" + op, "user_annotation", ts, dur, tid)


def _launch(corr, ts, tid=MAIN, kernel="k", dur=10.0, cat="cuda_runtime"):
    """A launch on host thread `tid` at `ts` and its kernel on the card
    (pid 0, the stream's tid), joined by the correlation id."""
    return [_ev("cudaLaunchKernel", cat, ts, 1.0, tid, correlation=corr),
            _ev(kernel, "kernel", ts + 50.0, dur, 7, pid=0,
                correlation=corr)]


def synthetic_trace(backward_outside=False):
    """A step's trace in torch.profiler's chrome format: the attention
    op's forward with K1's kernel; a recompute segment with a nested mul
    (a kernel in each); the attention grad op, whose two K1 backward
    kernels are launched from autograd's device thread while the main
    thread blocks inside the op's range (with `backward_outside`, after
    it ended); a serving worker's own range overlapping a later main
    range; and one kernel outside every range."""
    grad_at = 900.0 if backward_outside else 520.0
    evs = [_ev("step", "user_annotation", 0.0, 1000.0, MAIN),
           _range(FWD, 10.0, 30.0),
           _range("recompute__x", 100.0, 200.0),
           _range("mul__y", 110.0, 40.0),
           _range(GRAD, 500.0, 100.0),
           _range("serving_op__w", 700.0, 100.0, tid=WORKER),
           _range("mul__late", 720.0, 40.0),
           _ev("aten::mm", "cpu_op", 112.0, 5.0, MAIN)]
    evs += _launch(1, 20.0, kernel="flash_fwd_tc_kernel", dur=40.0)
    evs += _launch(2, 120.0, dur=5.0)                    # mul__y
    evs += _launch(3, 200.0, dur=7.0)                    # recompute__x
    evs += _launch(4, grad_at, AUTOGRAD, "flash_bwd_tc_kernel", dur=60.0)
    evs += _launch(5, grad_at + 20.0, AUTOGRAD, "flash_bwd_dq_kernel",
                   dur=20.0, cat="cuda_driver")
    evs += _launch(6, 730.0, WORKER, dur=3.0)             # its own range
    evs += _launch(7, 980.0, dur=2.0)                     # no fluid range
    evs.append(_ev("memcpy", "gpu_memcpy", 990.0, 4.0, 7, pid=0,
                   correlation=8))
    return {"traceEvents": evs}


def test_kernels_attributed_across_threads():
    got = [(r["kernel"], r["op"], r["us"])
           for r in profiler.kernel_attribution(synthetic_trace())]
    assert got == [("flash_fwd_tc_kernel", FWD, 40.0),
                   ("k", "mul__y", 5.0), ("k", "recompute__x", 7.0),
                   ("flash_bwd_tc_kernel", GRAD, 60.0),
                   ("flash_bwd_dq_kernel", GRAD, 20.0),
                   ("k", "serving_op__w", 3.0), ("k", None, 2.0)]


def test_backward_outside_every_range_is_unattributed():
    got = {r["kernel"]: r["op"]
           for r in profiler.kernel_attribution(
               synthetic_trace(backward_outside=True))}
    assert got["flash_bwd_tc_kernel"] is None
    assert got["flash_bwd_dq_kernel"] is None


def test_launch_placed_by_its_host_op():
    """A runtime call whose timestamp (another clock) lies past its op's
    range is placed by the host op active at it (its "External id");
    without one it falls outside the range."""
    evs = [_range("mul__a", 0.0, 10.0),
           _ev("aten::mm", "cpu_op", 2.0, 5.0, MAIN, **{"External id": 7})]
    launch, kernel = _launch(1, 11.5, dur=3.0)
    launch["args"]["External id"] = 7
    stray, kernel2 = _launch(2, 11.5, dur=1.0)
    got = profiler.kernel_attribution(
        {"traceEvents": evs + [launch, kernel, stray, kernel2]})
    assert [(r["op"], r["us"]) for r in got] == [("mul__a", 3.0),
                                                  (None, 1.0)]


def test_stale_launch_of_a_correlation_id_passed_over():
    """Two launches carry one correlation id (one from before the
    session's own): the kernel goes with the last one issued before it
    started."""
    evs = [_range("mul__a", 100.0, 10.0)]
    stale, _ = _launch(5, 3.0)
    launch, kernel = _launch(5, 104.0, dur=2.0)
    late, _ = _launch(5, 900.0)
    got = profiler.kernel_attribution(
        {"traceEvents": evs + [stale, launch, late, kernel]})
    assert [(r["op"], r["us"]) for r in got] == [("mul__a", 2.0)]


def test_kernel_placed_by_its_own_host_op():
    """A kernel that names its host op ("External id") is placed by that
    op's start, on the ranges' clock, whatever its runtime call's
    timestamp says (here past the range, on another clock)."""
    evs = [_range("mul__a", 0.0, 10.0),
           _ev("aten::mm", "cpu_op", 2.0, 5.0, MAIN, **{"External id": 7})]
    launch, kernel = _launch(1, 11.5, dur=3.0)
    kernel["args"]["External id"] = 7
    got = profiler.kernel_attribution({"traceEvents": evs + [launch, kernel]})
    assert [(r["op"], r["us"]) for r in got] == [("mul__a", 3.0)]


def test_launch_after_its_kernel_on_a_skewed_clock_is_kept():
    """The card's clock behind the host's: a kernel seems to start before
    its only launch, which still places it."""
    evs = [_range("mul__a", 100.0, 10.0)]
    launch, kernel = _launch(5, 104.0, dur=2.0)
    kernel["ts"] = 103.0
    got = profiler.kernel_attribution({"traceEvents": evs + [launch, kernel]})
    assert [(r["op"], r["us"]) for r in got] == [("mul__a", 2.0)]


def test_device_op_profile_rows():
    rows = profiler.device_op_profile(synthetic_trace())
    total = 40 + 5 + 7 + 60 + 20 + 3 + 2
    by = {r["op"]: r for r in rows}
    assert [r["op"] for r in rows] == [GRAD, FWD, "recompute__x",
                                       "mul__y", "serving_op__w",
                                       "(unattributed)"]
    assert by[GRAD] == {"op": GRAD, "type": "fused_multihead_attention_grad",
                        "calls": 1, "total_us": 80.0, "avg_us": 80.0,
                        "share_pct": round(100.0 * 80 / total, 2)}
    assert by["(unattributed)"]["calls"] == 1
    assert by["(unattributed)"]["total_us"] == 2.0
    assert sum(r["total_us"] for r in rows) == total
    assert profiler.device_op_profile(synthetic_trace(), top=2) == rows[:2]


def _jax_rows(table):
    """The JAX package's device_op_profile over an hlo_stats table of
    (framework op name, occurrences, total us) rows."""
    doc = {"cols": [{"label": "Framework op name"},
                    {"label": "#Occurrences"},
                    {"label": "Total time (us)"}],
           "rows": [{"c": [{"v": "jit(step)/fluid/%s/dot" % op},
                           {"v": n}, {"v": us}]}
                    for op, n, us in table]}
    return jprofiler.device_op_profile(None, _tool_data=json.dumps(doc))


def test_rows_equal_jax_schema():
    """Two runs of each of two ops, every kernel inside its op: the rows
    equal the JAX package's for the same per-op device time."""
    evs = [_range("mul__a", 0.0, 10.0), _range("mul__a", 20.0, 10.0),
           _range("softmax__b", 40.0, 10.0),
           _range("softmax__b", 60.0, 10.0)]
    for corr, (ts, us) in enumerate(((2.0, 3.25), (22.0, 4.5),
                                     (42.0, 1.125), (62.0, 1.0))):
        evs += _launch(corr, ts, dur=us)
    got = profiler.device_op_profile({"traceEvents": evs})
    want = _jax_rows([("mul__a", 2, 3.25), ("mul__a", 2, 4.5),
                      ("softmax__b", 2, 2.125)])
    assert got == want


def test_print_device_op_profile_layout(capsys):
    rows = profiler.print_device_op_profile(synthetic_trace(), top=3)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["Event", "Calls", "Total(us)", "Ave(us)",
                                "Ratio."]
    assert len(lines) == 4 and len(rows) == 3
    assert lines[1].startswith(GRAD[:44])
    assert lines[1].endswith("%")


def _tiny_program():
    main, startup = pfluid.Program(), pfluid.Program()
    with p_unique.guard(), pfluid.program_guard(main, startup):
        x = pfluid.layers.data(name="x", shape=[4], dtype="float32")
        loss = pfluid.layers.mean(pfluid.layers.fc(input=x, size=2))
        pfluid.optimizer.SGD(0.1).minimize(loss)
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 4), np.float32)}

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope)

    return main, step


def _annotations(events):
    return [e["name"] for e in events
            if e.get("cat") == "user_annotation"]


def test_session_op_ranges_only_while_open(tmp_path):
    """Inside a session every op of the step, forward and grad, runs in
    its fluid/ range; after it closes a step enters none (seen by a
    plain torch.profiler session)."""
    main, step = _tiny_program()
    step()
    path = str(tmp_path / "trace.json")
    with profiler.profiler("CPU", profile_path=path):
        assert profiler.session_open() and lowering._OP_RANGES
        step()
    assert not profiler.session_open() and not lowering._OP_RANGES
    ranges = [n for n in _annotations(profiler.trace_events(path))
              if n.startswith("fluid/")]
    ops = main.global_block().ops
    assert sorted(ranges) == sorted("fluid/" + lowering._op_scope_name(op)
                                    for op in ops)
    assert any("_grad__" in n for n in ranges)
    assert profiler.device_op_profile(path) == []
    assert profiler.device_op_profile() == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    assert not any(n.startswith("fluid/")
                   for n in _annotations(profiler.trace_events(prof)))


def test_second_session_raises():
    profiler.start_profiler("CPU")
    try:
        with pytest.raises(RuntimeError, match="already open"):
            profiler.start_profiler("All")
    finally:
        profiler.stop_profiler()
    profiler.stop_profiler()  # no session: a no-op
    with pytest.raises(ValueError):
        profiler.start_profiler("TPU")
    assert not profiler.session_open()


def test_trace_dir_and_cuda_profiler(tmp_path, capsys):
    main, step = _tiny_program()
    profiler.start_profiler("All", trace_dir=str(tmp_path / "d"))
    step()
    profiler.stop_profiler()
    assert os.path.exists(tmp_path / "d" / profiler.TRACE_FILE)
    assert profiler.device_op_profile(str(tmp_path / "d")) == []
    out = str(tmp_path / "nv.json")
    with profiler.cuda_profiler(out):
        step()
    assert "fluid/" in open(out).read()
    profiler.print_device_op_profile(out)
    assert "no CUDA kernels" in capsys.readouterr().out


@contextlib.contextmanager
def _fresh_tables():
    profiler.reset_profiler()
    jprofiler.reset_profiler()
    try:
        yield
    finally:
        profiler.reset_profiler()
        jprofiler.reset_profiler()


def _table(mod, sorted_key):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod._print_summary(sorted_key)
    return buf.getvalue()


@pytest.mark.parametrize("sorted_key", ["total", "calls", "max"])
def test_event_table_equals_jax(sorted_key):
    """The same observations give the JAX package's event_stats and the
    same table, a zero-call event printed with '-'."""
    with _fresh_tables():
        for mod in (profiler, jprofiler):
            for name, vals in (("fwd", (0.002, 0.004)), ("bwd", (0.01,)),
                               ("opt", (0.001, 0.001, 0.003))):
                for v in vals:
                    mod._legacy.histogram(name).observe(v)
            mod._legacy.histogram("never")
        assert profiler.event_stats() == jprofiler.event_stats()
        got = _table(profiler, sorted_key)
        assert got == _table(jprofiler, sorted_key)
        assert "never" in got and got.rstrip().splitlines()[-1].endswith("-")


def test_record_event_and_dump_chrome_trace(tmp_path, capsys):
    """record_event: a row of the table always; inside a session also a
    range of the torch trace and an event of dump_chrome_trace."""
    with _fresh_tables():
        with profiler.record_event("outside"):
            pass
        profiler.start_profiler("CPU")
        with profiler.record_event("inside"):
            torch.ones(2).sum()
        profiler.stop_profiler("calls")
        table = capsys.readouterr().out
        assert "inside" in table and "outside" in table
        stats = profiler.event_stats()
        assert stats["inside"]["calls"] == stats["outside"]["calls"] == 1
        assert "inside" in _annotations(profiler.trace_events(None))
        n = profiler.dump_chrome_trace(str(tmp_path / "host.json"))
        doc = json.load(open(tmp_path / "host.json"))
        assert n == 1 and [e["name"] for e in doc["traceEvents"]] == \
            ["inside"]
        assert doc["traceEvents"][0]["ph"] == "X"
