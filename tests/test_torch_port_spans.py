"""The port's phase spans (``utils/profiling.span``) in the MaxStyle train
step: under a recording profiler every phase appears once a step as a child
of ``maxstyle/step``, and without one no span enters ``record_function``."""

from __future__ import annotations

import pytest
import torch

from maxstyle_tpu_torch.config import (DataConfig, ExperimentConfig, LearningConfig,
                                       MaxStyleConfig, SegmentationModelConfig)
from maxstyle_tpu_torch.data.prefetch import prefetch
from maxstyle_tpu_torch.flagship import config_solver, make_raw_batches, workload_policy
from maxstyle_tpu_torch.train_step import make_fused_train_step
from maxstyle_tpu_torch.utils import profiling

N_ITER = 2
PHASES = ("augment", "standard_pass", "inner_loop", "hard_pass", "branches", "backward",
          "optimizer")


def _tiny_step():
    cfg = ExperimentConfig(
        data=DataConfig(pad_size=(40, 40, 1), crop_size=(32, 32, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(network_type="FCN_16_standard_no_STN",
                                                   num_classes=4),
        learning=LearningConfig(lr=1e-4, batch_size=4, optimizer_type="AdamW", max_style=True),
        max_style=MaxStyleConfig(n_iter=N_ITER, decoder_layers_indexes=(3, 4, 5)))
    solver = config_solver(cfg, "cpu")
    state = solver.init_state(0)
    fused = make_fused_train_step(solver, workload_policy(cfg), keep_orig=True)
    raw = make_raw_batches(1, 2, 40, seed=3, device="cpu")
    raw = {"image": raw["image"][0], "label": raw["label"][0]}
    return fused, state, raw, torch.Generator().manual_seed(0)


def _spans(prof):
    """The program's spans as (name, start, end, thread), by start."""
    cpu = torch.autograd.DeviceType.CPU
    return sorted(((e.name[len(profiling.SPAN_PREFIX):], e.time_range.start, e.time_range.end,
                    e.thread) for e in prof.events()
                   if e.device_type == cpu and e.name.startswith(profiling.SPAN_PREFIX)),
                  key=lambda s: s[1])


def _parent(spans, child):
    """The innermost span of the child's thread that encloses it."""
    _, s, t, thread = child
    outer = [p for p in spans if p is not child and p[3] == thread and p[1] <= s and t <= p[2]]
    return max(outer, key=lambda p: p[1])[0] if outer else None


def test_a_profiled_step_shows_every_phase_once_under_step():
    fused, state, raw, gen = _tiny_step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fused(state, raw, gen)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert names.count("step") == 1
    for phase in PHASES:
        assert names.count(phase) == 1, phase
        assert _parent(spans, next(s for s in spans if s[0] == phase)) == "step", phase
    # the phases follow one another in the step's order
    assert [n for n in names if n in PHASES] == list(PHASES)
    for inner in ("inner_grad", "inner_adam"):
        assert names.count(inner) == N_ITER
        assert all(_parent(spans, s) == "inner_loop" for s in spans if s[0] == inner)
    nets = {n for n in names if n.startswith("net/")}
    assert nets == {"net/image_encoder", "net/image_decoder", "net/segmentation_decoder"}
    # the hard-example pass's forward is its own, not the standard pass's
    hard = [_parent(spans, s) for s in spans if s[0] == "net/segmentation_decoder"]
    assert hard.count("standard_pass") == 1 and hard.count("hard_pass") == 1
    assert hard.count("inner_loop") == N_ITER


def test_without_a_profiler_no_span_enters_record_function(monkeypatch):
    fused, state, raw, gen = _tiny_step()

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    state, metrics = fused(state, raw, gen)
    assert state.step == 1 and torch.isfinite(metrics["loss/total"])
    assert list(prefetch([1, 2, 3], depth=2)) == [1, 2, 3]


def test_the_loader_wait_span_is_the_consumers():
    """``loader_wait`` is recorded on the consuming (profiled) thread."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = list(prefetch(range(3), depth=1, transform=lambda x: x + 1))
    assert got == [1, 2, 3]
    waits = [s for s in _spans(prof) if s[0] == "loader_wait"]
    # one wait an item and one for the end of the stream
    assert len(waits) == 4
    assert len({s[3] for s in waits}) == 1


@pytest.mark.parametrize("recording", [False, True])
def test_span_is_a_record_function_only_while_recording(recording):
    if recording:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            ctx = profiling.span("phase")
            assert isinstance(ctx, torch.profiler.record_function)
            assert ctx.name == "maxstyle/phase"
    else:
        assert profiling.span("phase") is profiling.span("other")
