"""The benchmark of the PyTorch and CUDA port, ``maxstyle_tpu_torch``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card this process is started
on and prints, as its last line of standard output, one JSON object:
``correct``, ``attempted`` (steps in the window), ``failed`` (those whose
loss was not finite), ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown`` of the traced stretch, and last ``checks``:
each number the correctness check compared, with its limit. The same
numbers are the last lines of standard error; with ``--trace 1`` the
table of the program's spans in the traced stretch comes before them.

Exits with another code, and prints no result, without a CUDA device (or
with fewer than the cell asks for), and when a module of JAX or of the
JAX package (``jax``, ``jaxlib``, ``flax``, ``optax``, ``maxstyle_tpu``,
compared by whole top-level names) is loaded once the window has closed.
The kernels build into the checkout's ``build/kernels/``; every other
cache a run could write is pointed under ``build/perfbench/``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root in place of this folder, whose module names
# ("trace", "inputs") would shadow others
sys.path[0] = str(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "maxstyle_tpu")


def fixed_environment() -> None:
    """Caches at fixed paths inside the checkout, and one host thread for
    torch's CPU operators: the step's host work is the main thread's, and
    an idle pool spinning beside it made host-bound cells' step times
    spread twice as wide, at the same median rate (PERF.md, section 2)."""
    cache = ROOT / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi failed"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "nvidia-smi failed"


def result(cell, run: dict, trace: bool) -> dict:
    """The result line of a run (``run`` from ``harness.run_cell``)."""
    import torch

    from perfbench import check
    from perfbench.manifest import read_metrics

    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, run)
    chk = run["check"]
    numbers = chk.get("numbers", {})
    correct = ("error" not in chk and check.verdict(numbers, cell.limits)
               and run["window"]["failed"] == 0)
    cuda = torch.cuda.is_available()
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": run["window"]["peak_bytes"]}
    out = {"correct": bool(correct), "attempted": run["window"]["steps"],
           "failed": run["window"]["failed"], "metrics": metrics, "device": device}
    t = run.get("trace")
    if t:
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    checks = {k: {"value": numbers.get(k), "limit": v} for k, v in cell.limits.items()}
    if "error" in chk:
        checks["error"] = chk["error"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative whole number")
    fixed_environment()
    import torch
    torch.set_num_threads(1)

    from perfbench.harness import run_cell
    from perfbench.manifest import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this process sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 4
    line = result(cell, run, bool(args.trace))
    line["device"]["card"] = card_limit()
    sys.stdout.flush()
    if args.trace:
        from perfbench.spans import span_table
        print(span_table(run["trace"]["spans"]), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c if name == 'error' else c['value']}"
              f"{'' if name == 'error' else ' limit ' + str(c['limit'])}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
