"""The program's phase spans in a traced stretch: device time, launches and
idle gaps put down to the spans of ``maxstyle_tpu_torch.utils.profiling.span``.

    python3 perfbench/spans.py --workload <cell> --seed <n> [--steps 4] [--out <file>]

builds the cell's program as a run of ``run.py`` does (set-up with the
checked steps, then the warm-up), traces one stretch of ``--steps`` steps
with ``harness.traced_stretch`` (one profiled step not counted, then a
marker range that ends after a synchronize), and prints the span table on
standard error and one JSON line on standard output: the stretch's mean
step on the profiler's clock, the device busy time and launches a step by
``trace.reduce_events``, the six phases' busy time and their sum.
``--out`` appends the line, with the whole reduction, to a file. A run of
``run.py --trace 1`` keeps the same reduction of its own stretch, which the
phase metrics read (``phase_reader``).

One stretch a process, as a run traces: on the H100 with torch 2.11 a
second profiler session in the same process lost device events (launches
a step 0.1-1% short) and once every launch's link.
"""

from __future__ import annotations

import sys
from pathlib import Path

if __name__ == "__main__":
    # the checkout's root in place of this folder, whose module names
    # ("trace", "inputs") would shadow others
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import bisect  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
from typing import Dict, List  # noqa: E402

import torch  # noqa: E402

from perfbench.trace import NOT_KERNELS  # noqa: E402

SPAN_PREFIX = "maxstyle/"
OUTSIDE = "(outside the program's spans)"
PATH_SEP = " > "
# the phases of a MaxStyle step, children of the span ``step``
PHASES = ("augment", "standard_pass", "inner_loop", "hard_pass", "backward", "optimizer")
MARKER = "perfbench_stretch"


def _interval(e):
    return float(e.time_range.start), float(e.time_range.end)


def reduce_spans(events, steps: int) -> dict:
    """The device time, launches and idle gaps of one traced stretch put
    down to the program's spans (host user annotations named
    ``maxstyle/<name>``), a step.

    A device event belongs to the innermost program span (of any thread:
    the autograd engine launches the backward pass's kernels from threads
    of its own while the main thread waits in ``backward``) whose host
    interval contains the start of the host event that launched it. The
    link is the profiler's correlation id: a kernel or copy on the card has
    the same ``id`` as the CUDA API call that launched it
    (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...:
    host events whose names start with ``cu``); of several host events with
    that id the latest such call starting no later than the device event
    is the launch. The profiler drops API records now and then (on
    the H100 with torch 2.11, 57 to 50268 of about 55000 device events in
    5 of 16 stretches, none in the others): a device event with no such call
    counts as ``unlinked`` and is placed at its start on the device, held
    between the launches of the linked device events before and after it
    on the device (a stream runs its work in launch order), so a device
    that lags the host cannot push it into a later span. Device-side
    annotations (user annotations, or named after a program span) are
    neither busy time nor launches.

    The idle gaps are the gaps between the merged device intervals, as in
    ``trace.reduce_events``; each belongs to the innermost program span
    open when it began. Device time and gaps under no span go to
    ``(outside the program's spans)``.

    Returns {"steps", "unlinked", "paths", "phases"}: ``paths`` by span
    path (names without the prefix, outermost first, joined by " > "),
    ``phases`` by phase (a path's name under ``step``, else its first
    name); each {"calls", "host_ms", "self_ms", "busy_ms", "launches",
    "idle_ms"} a step. A phase's calls and host times are those of its top
    span; its device numbers are its whole subtree's, its busy time the
    union of its device intervals."""
    cpu = torch.autograd.DeviceType.CPU
    spans, launches_by_id, dev = [], collections.defaultdict(list), []
    for e in events:
        annotation = getattr(e, "is_user_annotation", False)
        if e.device_type == cpu:
            if e.name.startswith(SPAN_PREFIX):
                spans.append(_interval(e) + (e.name[len(SPAN_PREFIX):], e.thread))
            elif e.name.startswith("cu") and not annotation:
                launches_by_id[e.id].append(float(e.time_range.start))
        elif not (annotation or e.name.startswith(SPAN_PREFIX)):
            s, t = _interval(e)
            if t > s:
                dev.append((s, t, e))
    paths, host, own = _span_paths(spans)
    innermost = _Innermost(spans, paths)
    rows: Dict[str, dict] = collections.defaultdict(_row)
    for path, h, o in zip(paths, host, own):
        rows[path]["calls"] += 1
        rows[path]["host_us"] += h
        rows[path]["self_us"] += o
    dev.sort(key=lambda d: d[0])
    launched = [max((x for x in launches_by_id.get(e.id, ()) if x <= s), default=None)
                for s, _, e in dev]
    unlinked = launched.count(None)
    for i, (before, after) in enumerate(zip(_running(launched, max, -math.inf),
                                            _running(launched[::-1], min, math.inf)[::-1])):
        if launched[i] is None:
            launched[i] = max(before, min(dev[i][0], after))
    for (s, t, e), at in zip(dev, launched):
        row = rows[innermost.at(at)]
        row["intervals"].append((s, t))
        row["launches"] += not e.name.startswith(NOT_KERNELS)
    merged = _merge(sorted((s, t) for s, t, _ in dev))
    for a, b in zip(merged, merged[1:]):
        rows[innermost.at(a[1])]["idle_us"] += b[0] - a[1]
    phases: Dict[str, dict] = collections.defaultdict(_row)
    for path, row in rows.items():
        top = _phase_path(path)
        ph = phases[top.split(PATH_SEP)[-1]]
        if path == top:
            for k in ("calls", "host_us", "self_us"):
                ph[k] += row[k]
        ph["launches"] += row["launches"]
        ph["idle_us"] += row["idle_us"]
        ph["intervals"] += row["intervals"]
    return {"steps": steps, "unlinked": unlinked,
            "paths": {p: _per_step(r, steps) for p, r in sorted(rows.items())},
            "phases": {p: _per_step(r, steps) for p, r in sorted(phases.items())}}


def _running(values, pick, start) -> List[float]:
    """For each position, ``pick`` of the values (None left out) before
    it, or ``start``."""
    out, acc = [], start
    for v in values:
        out.append(acc)
        if v is not None:
            acc = pick(acc, v)
    return out


def _row() -> dict:
    return {"calls": 0, "host_us": 0.0, "self_us": 0.0, "launches": 0, "idle_us": 0.0,
            "intervals": []}


def _merge(intervals) -> List[List[float]]:
    """Sorted intervals merged where they touch or overlap."""
    merged: List[List[float]] = []
    for s, t in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def _span_paths(spans):
    """Each span's path (the spans enclosing it on its own thread,
    outermost first), host time and self time (host time less that of its
    direct children), in microseconds."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][0], -spans[i][1]))
    paths, host, own = [""] * len(spans), [0.0] * len(spans), [0.0] * len(spans)
    stacks: Dict[object, list] = collections.defaultdict(list)
    for i in order:
        s, t, name, thread = spans[i]
        stack = stacks[thread]
        while stack and spans[stack[-1]][1] <= s:
            stack.pop()
        paths[i] = paths[stack[-1]] + PATH_SEP + name if stack else name
        host[i] = own[i] = t - s
        if stack:
            own[stack[-1]] -= t - s
        stack.append(i)
    return paths, host, own


class _Innermost:
    """The path of the innermost span (the latest-starting one, of any
    thread) open at a host time, looked up in the elementary intervals
    between the spans' boundaries."""

    def __init__(self, spans, paths):
        self.bounds = sorted({x for s, t, _, _ in spans for x in (s, t)})
        self.owner = []
        for b in self.bounds:
            open_ = [(s, -t, i) for i, (s, t, _, _) in enumerate(spans) if s <= b < t]
            self.owner.append(paths[max(open_)[2]] if open_ else OUTSIDE)

    def at(self, x: float) -> str:
        i = bisect.bisect_right(self.bounds, x) - 1
        return self.owner[i] if i >= 0 else OUTSIDE


def _phase_path(path: str) -> str:
    """The path of the phase a span path belongs to."""
    names = path.split(PATH_SEP)
    return PATH_SEP.join(names[:2]) if names[0] == "step" and len(names) > 1 else names[0]


def _per_step(row: dict, steps: int) -> dict:
    busy = sum(t - s for s, t in _merge(sorted(row["intervals"])))
    return {"calls": row["calls"] / steps, "host_ms": row["host_us"] * 1e-3 / steps,
            "self_ms": row["self_us"] * 1e-3 / steps, "busy_ms": busy * 1e-3 / steps,
            "launches": row["launches"] / steps, "idle_ms": row["idle_us"] * 1e-3 / steps}


def phase_busy_ms(spans: dict, phase: str):
    """A phase's device busy ms a step in ``reduce_spans``' result, or None
    where the stretch had no such span (a program without spans)."""
    row = spans["phases"].get(phase)
    return row["busy_ms"] if row and row["calls"] else None


def phase_reader(phase: str):
    """The ``read(run)`` of a phase metric: the phase's device busy ms a
    step in the traced stretch of a ``--trace 1`` run, or None without
    one."""

    def read(run):
        t = run.get("trace")
        return phase_busy_ms(t["spans"], phase) if t and "spans" in t else None
    return read


def span_table(spans: dict) -> str:
    """``reduce_spans``' result as text: the phases, then every path."""
    head = (f"{'span':<58}{'calls':>7}{'host ms':>10}{'self ms':>10}{'busy ms':>10}"
            f"{'launches':>10}{'idle ms':>9}")

    def lines(rows):
        return [f"{name[:57]:<58}{r['calls']:>7.2f}{r['host_ms']:>10.3f}{r['self_ms']:>10.3f}"
                f"{r['busy_ms']:>10.3f}{r['launches']:>10.1f}{r['idle_ms']:>9.3f}"
                for name, r in rows.items()]
    return "\n".join([f"phases, a step (unlinked device events: {spans['unlinked']})", head]
                     + lines(spans["phases"]) + ["", "paths, a step", head]
                     + lines(spans["paths"]))


def measure(cell, seed: int, steps: int, device) -> dict:
    """The cell's program set up as a run sets it up, then one traced
    stretch of ``steps`` steps."""
    from perfbench.harness import free, prepare, sync, traced_stretch
    prog, _ = prepare(cell, seed, device)
    for _ in range(cell.traffic["warmup_steps"]):
        prog.state, _ = prog.step(prog.state, prog.next_batch(), prog.generator)
    sync(prog.device)
    ev = traced_stretch(prog, steps, prog.device)
    free(prog)
    sp = ev["spans"]
    phases = {p: phase_busy_ms(sp, p) for p in PHASES}
    return {"workload": cell.name, "seed": seed, "steps": steps,
            "traced_step_ms": 1e3 * ev["window_s"] / steps, "busy_ms": 1e3 * ev["busy_s"] / steps,
            "launches": ev["launches"] / steps, "phase_busy_ms": phases,
            "phase_sum_ms": sum(v or 0.0 for v in phases.values()), "spans": sp}


def main(argv=None) -> int:
    import argparse

    from perfbench.manifest import load_cell
    from perfbench.run import card_limit, fixed_environment
    ap = argparse.ArgumentParser(description="the program's spans in a traced stretch")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    fixed_environment()
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("perfbench.spans: needs a CUDA device", file=sys.stderr)
        return 3
    line = measure(load_cell(args.workload), args.seed, args.steps, "cuda")
    line["card"] = card_limit()
    print(f"{line['workload']} seed {line['seed']}: traced step {line['traced_step_ms']:.3f} ms, "
          f"busy {line['busy_ms']:.3f} ms, six phases {line['phase_sum_ms']:.3f} ms\n"
          f"{span_table(line['spans'])}", file=sys.stderr)
    print(json.dumps({k: v for k, v in line.items() if k != "spans"}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
