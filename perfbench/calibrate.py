"""The readings the correctness limits are set from, at a cell's own size.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 [--out FILE]

For each seed, in one process on the card: the program's checked steps
(set-up as a run makes it, no window), then the reference over the same
steps and draws in float64 (the check's reference) and, against it: the
program; the control, the reference in float32 with TF32 on, one precision
below the configuration's float32 with TF32 off (the CPU tests pass
``control="bfloat16"``); the program's checked steps again with TF32 on
(``program_tf32``, on the card only); and the reference in float32 with
half of each batch left out (a fault). Prints one JSON line a seed with
each number of each against the float64 reference. A state left unchanged
reads 1 on ``change_gap`` by the measure's definition and is not run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def calibrate(cell, seed: int, device, control="tf32") -> dict:
    import torch

    from perfbench import check, harness
    t0 = time.perf_counter()
    seconds = {}

    def program(tf32):
        t = time.perf_counter()
        prog, record = harness.prepare(cell, seed, device, tf32=tf32)
        dev, pool = prog.device, prog.pool
        harness.free(prog)
        seconds["program_tf32" if tf32 else "program"] = time.perf_counter() - t
        return record, pool, dev

    def reference(name, **kw):
        t = time.perf_counter()
        out = harness.reference_readings(cell, seed, record, steps, dev, **kw)
        seconds[name] = time.perf_counter() - t
        return out

    record, pool, dev = program(False)
    steps = harness.reference_steps(cell, seed, record, pool, dev)
    ref = reference("reference", dtype=harness.REFERENCE_DTYPE)
    dtype = control if control == "tf32" else getattr(torch, control)
    out = {"workload": cell.name, "seed": seed,
           "program": check.gaps(harness.readings(record), ref),
           f"control_{control}": check.gaps(reference("control", dtype=dtype), ref),
           "fault_half_batch": check.gaps(reference("fault", half_batch=True), ref)}
    if torch.device(dev).type == "cuda":
        record_tf32, _, _ = program(True)
        out["program_tf32"] = check.gaps(harness.readings(record_tf32), ref)
    out["loss"] = {"program": record["loss"], "reference": ref["loss"]}
    out["seconds"] = {**seconds, "all": time.perf_counter() - t0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    from perfbench.manifest import load_cell
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(calibrate(cell, seed, "cuda"))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
