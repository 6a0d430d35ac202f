"""The benchmark's own arithmetic: FLOPs, bytes, the trace's reduction and
the metric readers."""

from __future__ import annotations

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench_helpers import standard_cell


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


def test_conv_flops_by_hand():
    from perfbench.reference import nets as N
    P = N.Params()
    x = torch.empty((20, 16, 96, 96), device="meta")
    got = _flops(lambda: N.conv(P, "c", x, 32, 3))
    assert got == 2 * 20 * 32 * 96 * 96 * 16 * 3 * 3


def test_vit_block_flops_by_hand():
    from perfbench.reference import nets as N
    P = N.Params()
    b, n, d, heads, mlp = 20, 144, 768, 12, 3072
    t = torch.empty((b, n, d), device="meta")
    got = _flops(lambda: N.load_family("unetr").vit_block(P, "blk", t))
    hand = (2 * b * n * d * 3 * d            # qkv
            + 2 * b * heads * n * n * (d // heads) * 2  # scores and the weighted sum
            + 2 * b * n * d * d              # out_proj
            + 2 * 2 * b * n * d * mlp)       # the MLP's two products
    assert got == hand


def test_step_flops_count_the_passes():
    """The MaxStyle step counts more than the standard one, and the count
    of the FCN step at the cell's size is within the range the port's own
    counter gave (872 GFLOP at batch 20, 192^2)."""
    from perfbench.harness import count_flops
    from perfbench.manifest import load_cell
    ms = count_flops(load_cell("fcn16_acdc.maxstyle"))
    std = count_flops(standard_cell())
    assert std < ms
    assert 0.5e12 < ms < 1.0e12


# PERF.md's kernel table, bound column (µs) at the headline's hook shapes
# [20,16,96^2], [20,16,192^2], [20,1,192^2] and the warp's 10 x 224^2 -> 192^2
TABLE = {"maxstyle_stats": (3.52, 14.09, 0.88), "maxstyle_apply": (7.05, 28.17, 1.76),
         "maxstyle_bwd": (10.57, 42.26, 2.64)}
HOOKS = ((20, 16, 96, 96), (20, 16, 192, 192), (20, 1, 192, 192))


@pytest.mark.parametrize("kernel", sorted(TABLE))
def test_style_bytes_match_the_kernel_table(kernel):
    from perfbench.roofline import style_bound_s
    for shape, us in zip(HOOKS, TABLE[kernel]):
        assert round(style_bound_s(kernel, *shape) * 1e6, 2) == us


def test_warp_bytes_match_the_kernel_table():
    from perfbench.roofline import warp_bound_s
    assert round(warp_bound_s(10, 224, 192) * 1e6, 2) == 2.96


def _event(name, start, end, device):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, device_type=kind,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_trace_reduction():
    from perfbench.trace import reduce_events
    events = [_event("k1", 0, 10, True), _event("k2", 5, 20, True),
              _event("Memcpy HtoD", 30, 40, True), _event("k1", 60, 70, True),
              _event("aten::mm", 15, 65, False), _event("aten::add", 39, 50, False)]
    r = reduce_events(events, 100e-6, 2)
    assert r["launches"] == 3
    assert r["busy_s"] == pytest.approx(40e-6)
    assert r["by_name"]["k1"] == [2, pytest.approx(20e-6)]
    # gaps 20-30 under aten::mm, 40-60 under aten::add (the innermost)
    assert dict((k, v) for k, v in r["idle_gaps"]) == {"aten::add": pytest.approx(20e-6),
                                                        "aten::mm": pytest.approx(10e-6)}


def _run(**kw):
    from perfbench.manifest import load_cell
    run = {"cell": load_cell("fcn16_acdc.maxstyle"), "flops_per_step": 67e10,
           "slices_per_step": 20, "n_raw": 10, "pad": 224, "crop": 192, "setup_s": 12.0,
           "window": {"seconds": 2.0, "steps": 10, "step_ms": [float(i) for i in range(1, 11)],
                      "loader_wait_s": 0.01, "peak_bytes": 2 ** 31}}
    run.update(kw)
    return run


def test_readers():
    from perfbench.manifest import reader
    from perfbench.roofline import style_bound_s, warp_bound_s
    trace = {"steps": 2, "window_s": 1.0, "busy_s": 0.3, "launches": 100,
             "by_name": {"maxstyle_stats_kernel": [42, 1e-3], "maxstyle_bwd_kernel": [30, 2e-3],
                         "warp_bilinear_nearest_kernel<4>": [2, 20e-6]}}
    run = _run(trace=trace, host_syncs={"syncs": 3, "steps": 2})
    assert reader("slices_per_s")(run) == pytest.approx(100.0)
    assert reader("step_ms_p90")(run) == 9.0
    assert reader("setup_s")(run) == 12.0
    assert reader("loader_wait_ms")(run) == pytest.approx(1.0)
    assert reader("launches_per_step")(run) == 50
    assert reader("host_syncs_per_step")(run) == 1.5
    assert reader("device_idle_pct")(run) == pytest.approx(25.0)
    assert reader("step_mfu")(run) == pytest.approx(5.0)
    assert reader("step_mfu.device")(run) == pytest.approx(100 * 67e10 * 2 / 0.3 / 67e12)
    assert reader("slices_per_s.host_paced")(run) == pytest.approx(100.0)
    assert reader("step_device_ms")(_run(device_stretch={"steps": 8, "busy_s": 0.96})) \
        == pytest.approx(120.0)
    assert reader("peak_mem_gib")(run) == 2.0
    bound = sum(42 / 3 * style_bound_s("maxstyle_stats", *s)
                + 30 / 3 * style_bound_s("maxstyle_bwd", *s) for s in HOOKS)
    assert reader("style_kernels_roofline")(run) == pytest.approx(100 * bound / 3e-3)
    assert reader("warp_roofline")(run) == pytest.approx(100 * 2 * warp_bound_s(10, 224, 192)
                                                         / 20e-6)


def test_readers_find_nothing_without_a_trace():
    from perfbench.manifest import reader
    run = _run()
    for name in ("launches_per_step", "host_syncs_per_step", "device_idle_pct",
                 "style_kernels_roofline", "warp_roofline", "step_mfu.device",
                 "step_device_ms"):
        assert reader(name)(run) is None
    std = _run(cell=standard_cell(),
               trace={"steps": 1, "window_s": 1.0, "busy_s": 0.5, "launches": 5, "by_name": {}})
    assert reader("style_kernels_roofline")(std) is None


def test_the_device_stretch_counts_the_cards_busy_time_alone(monkeypatch):
    """``harness.device_stretch`` runs its steps under a profiler of the
    device alone and sums the union of the device's intervals: overlaps
    once, the program's spans mirrored on the device and host events not
    at all."""
    from perfbench import harness

    def kineto(name, start, end, cuda=True, annotation=False):
        dt = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
        return types.SimpleNamespace(name=lambda: name, device_type=lambda: dt,
                                     start_ns=lambda: start, duration_ns=lambda: end - start,
                                     is_user_annotation=lambda: annotation)

    events = [kineto("k1", 0, 10_000), kineto("k2", 5_000, 20_000),
              kineto("Memcpy HtoD", 30_000, 40_000), kineto("k3", 60_000, 60_000),
              kineto("maxstyle/step", 0, 90_000, annotation=True),
              kineto("cudaLaunchKernel", 0, 90_000, cuda=False)]
    seen = {}

    class Profile:
        def __init__(self, activities):
            seen["activities"] = activities
            self.profiler = types.SimpleNamespace(
                kineto_results=types.SimpleNamespace(events=lambda: events))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    steps = []
    prog = types.SimpleNamespace(state=0, generator=None, next_batch=lambda: None,
                                 step=lambda state, raw, gen: (steps.append(state) or state + 1,
                                                               {}))
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    out = harness.device_stretch(prog, 3, "cpu")
    assert seen["activities"] == [torch.profiler.ProfilerActivity.CUDA]
    assert steps == [0, 1, 2] and prog.state == 3
    assert out == {"steps": 3, "busy_s": pytest.approx(30e-6), "events": 3}
