"""Tracing / profiling hooks.

Counterpart of ``maxstyle_tpu/utils/profiling.py``: :func:`trace` records a
``torch.profiler`` trace (host operators, and the device's kernels when a
GPU is present) into a log directory, viewable in Perfetto or TensorBoard;
:class:`StepTimer`, :func:`parameter_count` and :func:`parameter_bytes` as
in the JAX package; :func:`reestimate_batch_stats` re-estimates the
BatchNorm running statistics with the port's own train-mode update.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch
from torch import nn

from maxstyle_tpu_torch.models.layers import BatchNorm

Params = Union[nn.Module, Iterable[torch.Tensor], Dict[str, torch.Tensor]]


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


class StepTimer:
    """Wall-clock step-time statistics (compile step excluded by skipping
    the first `warmup` samples)."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.samples = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.samples.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {"steps": 0}
        arr = np.asarray(self.samples)
        return {"steps": len(arr), "mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)),
                "p95_s": float(np.percentile(arr, 95)),
                "steps_per_sec": float(1.0 / arr.mean())}


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
