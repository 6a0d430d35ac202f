"""The reduction of a profiler trace to what the per-layer metrics read.

From the events of ``torch.profiler`` over a stretch of steps: the kernels
launched, each kernel name's launches and device seconds, the union of the
intervals in which anything ran on the device (busy), and the idle gaps,
each put down to the innermost host operator (of any thread) that was
running when it began.
"""

from __future__ import annotations

import bisect
import collections
import os
import warnings
from typing import Dict, List, Tuple

import torch

NOT_KERNELS = ("Memcpy", "Memset")


def _span(e) -> Tuple[float, float]:
    return float(e.time_range.start), float(e.time_range.end)


def merge(spans) -> List[List[float]]:
    """The union of intervals (start, end), as sorted disjoint intervals."""
    merged: List[List[float]] = []
    for s, t in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def reduce_events(events, window_s: float, steps: int) -> dict:
    """{"steps", "window_s", "busy_s", "launches", "by_name": {name: [count,
    seconds]}, "device_ops", "idle_gaps"} of the events of one traced
    stretch (times in the profiler's microseconds)."""
    dev, host = [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(e)
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append(e)
    by_name: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0.0])
    launches = 0
    spans = []
    for e in dev:
        s, t = _span(e)
        if t <= s:
            continue
        spans.append((s, t))
        rec = by_name[e.name]
        rec[0] += 1
        rec[1] += (t - s) * 1e-6
        if not e.name.startswith(NOT_KERNELS):
            launches += 1
    merged = merge(spans)
    busy_us = sum(t - s for s, t in merged)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)
            if merged[i + 1][0] > merged[i][1]]
    return {"steps": steps, "window_s": window_s, "busy_s": busy_us * 1e-6,
            "launches": launches,
            "by_name": {k: list(v) for k, v in by_name.items()},
            "device_ops": sorted(([k, v[1]] for k, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": _gaps_by_host_op(gaps, host)}


def _gaps_by_host_op(gaps, host) -> List[list]:
    """The idle gaps' seconds summed by the innermost host operator (of any
    thread: the autograd engine runs the backward pass on a thread of its
    own) running when each gap began; the ten largest."""
    if not gaps:
        return []
    ops = sorted((_span(e) + (e.name,) for e in host), key=lambda x: x[0])
    starts = [o[0] for o in ops]
    total: Dict[str, float] = collections.defaultdict(float)
    for s, t in gaps:
        best = None
        i = bisect.bisect_right(starts, s)
        # the innermost (latest-starting) operator still running at s
        for j in range(i - 1, max(i - 4096, -1), -1):
            o = ops[j]
            if o[1] >= s:
                best = o[2]
                break
        total[best or "(host, between operators)"] += (t - s) * 1e-6
    return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:10]


def is_sync_warning(w) -> bool:
    """A warning of ``set_sync_debug_mode("warn")`` that reports a host
    sync, and not the note that the mode is a prototype (as the port's
    ``profile_slice.is_sync_warning``)."""
    text = str(w.message)
    return "synchroniz" in text and "prototype feature" not in text


def count_host_syncs(fn) -> Tuple[int, Dict[str, int]]:
    """The host's waits for the device while ``fn()`` runs, and where."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}"
                                for w in caught if is_sync_warning(w))
    return sum(where.values()), dict(where)
