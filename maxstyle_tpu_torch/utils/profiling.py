"""Tracing / profiling hooks.

Counterpart of ``maxstyle_tpu/utils/profiling.py``: :func:`trace` records a
``torch.profiler`` trace (host operators, and the device's kernels when a
GPU is present) into a log directory, viewable in Perfetto or TensorBoard;
:func:`span` marks a phase of the program in whatever profiler is
recording; :func:`parameter_count` and :func:`parameter_bytes` as in the
JAX package; :func:`reestimate_batch_stats` re-estimates the BatchNorm
running statistics with the port's own train-mode update.

Spans. The train step, the solver and the prefetch iterator open
``span(name)`` around their phases (``maxstyle/step``, ``maxstyle/augment``,
``maxstyle/inner_loop``, ...). While a ``torch.profiler`` records on the
calling thread, a span is a ``record_function`` annotation named
``"maxstyle/" + name``: the profiler keeps it in memory with the host
operators and kernels it encloses, on the same clock, and writes it out
with its trace (``trace`` here, ``profile_slice``, the benchmark's traced
stretch). Otherwise a span costs one check of the profiler's state and
enters nothing. There is no switch: spans exist exactly when something
profiles. torch's profiler records the thread that started it and the
autograd engine's threads, not other Python threads: the prefetch
thread's host-to-device copies have no span of their own.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Iterable, Optional, Union

import torch
from torch import nn

from maxstyle_tpu_torch.models.layers import BatchNorm

Params = Union[nn.Module, Iterable[torch.Tensor], Dict[str, torch.Tensor]]

SPAN_PREFIX = "maxstyle/"
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager marking the phase ``name`` of the program: a
    ``record_function("maxstyle/" + name)`` while a profiler records on
    this thread, else a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace of the block into ``log_dir`` (one
    ``*.pt.trace.json`` file a trace); yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _tensors(params: Params):
    if isinstance(params, nn.Module):
        return list(params.parameters())
    if isinstance(params, dict):
        return list(params.values())
    return list(params)


def parameter_count(params: Params) -> int:
    """Total parameter count of a module (its parameters, not its BatchNorm
    buffers), a {name: tensor} mapping or a sequence of tensors (the
    reference's SizeEstimator analogue, model_util.py:513-589)."""
    return sum(int(t.numel()) for t in _tensors(params))


def parameter_bytes(params: Params) -> int:
    return sum(int(t.numel()) * t.element_size() for t in _tensors(params))


@torch.no_grad()
def reestimate_batch_stats(module: nn.Module, batches: Iterable[torch.Tensor],
                           forward: Optional[Callable[[nn.Module, torch.Tensor], object]] = None
                           ) -> Dict[str, torch.Tensor]:
    """BN running-statistics re-estimation over a dataset (the reference's
    ``adaptive_bn``/``reset_bn`` test-time adaptation helpers): each batch
    runs ``forward(module, batch)`` (by default ``module(batch, "train")``),
    so every port ``BatchNorm`` updates its running statistics as in
    training (momentum 0.1, unbiased running variance). Returns a copy of
    the running statistics {name: tensor}."""
    forward = forward or (lambda m, b: m(b, "train"))
    for batch in batches:
        forward(module, batch)
    return {f"{name}.{buf}": getattr(m, buf).clone()
            for name, m in module.named_modules() if isinstance(m, BatchNorm)
            for buf in ("running_mean", "running_var")}
