"""``spans.reduce_spans`` on synthetic profiler events (no card needed), the
harness's own reduction unmoved by the program's annotations, and the
spans of the tiny program traced on the CPU."""

from __future__ import annotations

import types

import pytest
import torch

from perfbench_helpers import tiny_cell

MAIN, AUTOGRAD = 1, 2


def _event(name, start, end, device=False, id=0, thread=MAIN, annotation=False):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, device_type=kind, id=id, thread=thread,
                                 is_user_annotation=annotation,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def _span(name, start, end):
    return _event("maxstyle/" + name, start, end, annotation=True)


def _launch(id, at, thread=MAIN, name="cudaLaunchKernel"):
    return _event(name, at, at + 1, id=id, thread=thread)


def _kernel(name, start, end, id):
    return _event(name, start, end, device=True, id=id)


def _step_events():
    """One step (times in the profiler's microseconds): an inner loop with
    an ``inner_grad`` inside it, then ``backward``, whose kernel the
    autograd engine's thread launches; an operator that shares a kernel's
    id; a copy; a device-side annotation."""
    return [_span("step", 0, 100), _span("inner_loop", 10, 40), _span("inner_grad", 20, 30),
            _span("backward", 50, 90),
            _event("aten::mm", 5, 6, id=7),              # a host operator sharing id 7
            _launch(3, 12), _kernel("k_loop", 13, 18, 3),
            _launch(4, 25), _kernel("k_grad", 26, 35, 4),
            _launch(7, 60, thread=AUTOGRAD), _kernel("k_bwd", 70, 80, 7),
            _launch(8, 92, name="cudaMemcpyAsync"), _kernel("Memcpy HtoD", 95, 99, 8),
            _event("maxstyle/backward", 50, 95, device=True, annotation=True)]


def _reduce(events, steps=1):
    from perfbench.spans import reduce_spans
    return reduce_spans(events, steps)


def test_the_autograd_threads_kernel_goes_to_backward():
    r = _reduce(_step_events())
    bwd = r["paths"]["step > backward"]
    assert bwd["launches"] == 1 and bwd["busy_ms"] == pytest.approx(10e-3)
    assert r["phases"]["backward"]["busy_ms"] == pytest.approx(10e-3)
    assert r["unlinked"] == 0


def test_nested_spans_take_their_kernels_and_roll_up_to_their_phase():
    r = _reduce(_step_events())
    assert r["paths"]["step > inner_loop > inner_grad"]["busy_ms"] == pytest.approx(9e-3)
    assert r["paths"]["step > inner_loop"]["busy_ms"] == pytest.approx(5e-3)
    loop = r["phases"]["inner_loop"]
    assert loop["busy_ms"] == pytest.approx(14e-3) and loop["launches"] == 2
    assert loop["calls"] == 1 and loop["host_ms"] == pytest.approx(30e-3)
    assert r["paths"]["step > inner_loop"]["self_ms"] == pytest.approx(20e-3)
    assert r["paths"]["step"]["self_ms"] == pytest.approx(100e-3 - 30e-3 - 40e-3)
    # the copy is busy time of the span its launch fell in, and no launch
    step = r["phases"]["step"]
    assert step["busy_ms"] == pytest.approx(4e-3) and step["launches"] == 0


def test_a_gap_goes_to_the_span_open_at_its_start():
    r = _reduce(_step_events())
    # the gaps 18-26 (inner_grad opens at 20) and 35-70 begin in inner_loop
    assert r["paths"]["step > inner_loop"]["idle_ms"] == pytest.approx((26 - 18 + 70 - 35) * 1e-3)
    assert r["paths"]["step > backward"]["idle_ms"] == pytest.approx((95 - 80) * 1e-3)
    assert r["phases"]["inner_loop"]["idle_ms"] == pytest.approx(43e-3)


def test_device_annotations_are_neither_busy_time_nor_launches():
    events = _step_events()
    with_marks = _reduce(events)
    without = _reduce([e for e in events if e.name != "maxstyle/backward"
                       or e.device_type != torch.autograd.DeviceType.CUDA])
    assert with_marks == without
    unflagged = _event("maxstyle/inner_loop", 10, 40, device=True)  # named, not flagged
    assert _reduce(events + [unflagged]) == without
    total = sum(p["busy_ms"] for p in with_marks["phases"].values())
    assert total == pytest.approx((5 + 9 + 10 + 4) * 1e-3)


def test_a_kernel_without_its_launch_is_unlinked_and_placed_by_its_start():
    events = _step_events() + [_kernel("k_lost", 52, 54, 99)]
    r = _reduce(events)
    assert r["unlinked"] == 1
    assert r["phases"]["backward"]["launches"] == 2


def test_an_unlinked_kernel_stays_between_its_neighbours_launches():
    """The device lags the host: a kernel with no launch record that ran
    between two linked ones was launched between their launches, in the
    first span, though it started on the device in the last."""
    events = [_span("step", 0, 100), _span("augment", 0, 10), _span("inner_loop", 10, 20),
              _span("backward", 20, 100),
              _launch(1, 2), _kernel("k1", 50, 51, 1), _kernel("k_lost", 52, 53, 99),
              _launch(3, 4), _kernel("k3", 54, 55, 3)]
    r = _reduce(events)
    assert r["unlinked"] == 1
    assert r["phases"]["augment"]["launches"] == 3
    assert r["phases"]["backward"]["launches"] == 0


def test_work_outside_every_span():
    from perfbench.spans import OUTSIDE
    r = _reduce([_launch(1, 0), _kernel("k", 1, 2, 1), _span("step", 5, 9),
                 _launch(2, 6), _kernel("k", 6, 8, 2)], steps=2)
    assert r["phases"][OUTSIDE]["busy_ms"] == pytest.approx(0.5e-3)
    assert r["phases"][OUTSIDE]["idle_ms"] == pytest.approx(2e-3)   # the gap 2-6, a step
    assert r["phases"]["step"]["calls"] == 0.5


def test_phase_busy_ms_reads_a_phase_or_nothing():
    from perfbench.spans import phase_busy_ms
    r = _reduce(_step_events())
    assert phase_busy_ms(r, "backward") == pytest.approx(10e-3)
    assert phase_busy_ms(r, "optimizer") is None
    # a program without spans: its device time is all outside
    bare = _reduce([e for e in _step_events() if not e.name.startswith("maxstyle/")])
    assert phase_busy_ms(bare, "backward") is None


def test_the_harness_reduction_is_the_same_with_the_programs_annotations(monkeypatch):
    """``harness.traced_stretch`` reduces the same events with and without
    the program's spans on the host and their device-side copies."""
    from perfbench import harness
    plain = [e for e in _step_events() if not e.name.startswith("maxstyle/")]
    marked = _step_events()
    marker = _event("perfbench_stretch", -1, 101, annotation=True)

    class Profile:
        events_ = None

        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return Profile.events_

    prog = types.SimpleNamespace(state=None, generator=None, next_batch=lambda: None,
                                 step=lambda state, raw, gen: (state, {}))
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    out = []
    for events in (plain, marked):
        Profile.events_ = events + [marker]
        out.append(harness.traced_stretch(prog, 1, "cpu"))
    assert out[0] == out[1]
    assert out[0]["launches"] == 3 and out[0]["busy_s"] == pytest.approx(28e-6)


def test_the_tiny_programs_spans_on_the_cpu():
    from perfbench.spans import PHASES, measure
    line = measure(tiny_cell("fcn16_acdc.maxstyle", check_steps=1), 3700000001, 2, "cpu")
    sp = line["spans"]
    for phase in PHASES + ("branches", "loader_wait"):
        assert sp["phases"][phase]["calls"] == 1, phase
        assert sp["phases"][phase]["host_ms"] > 0
    assert sp["phases"]["step"]["calls"] == 1
    assert sp["paths"]["step > inner_loop > inner_grad"]["calls"] == 1  # n_iter 1
    assert line["launches"] == 0 and line["phase_sum_ms"] == 0 and sp["unlinked"] == 0
    assert line["traced_step_ms"] > 0
