"""Render the port's throughput history: ``build/flagship_history.jsonl``.

    python -m maxstyle_tpu_torch.scripts.bench_summary [--last 8] [--k 3]

Counterpart of ``scripts/bench_summary.py``. Every ``python -m
maxstyle_tpu_torch.flagship`` run appends one timestamped row (workload,
steps/s, the card's name and power limit, and what ``utils/gpulock``'s
``chip_lock`` saw). The headline of a workload is the median of its K most
recent uncontended rows: a row is contended when the lock was contended or
not acquired. Contended rows are listed but never enter a headline. The
history lives under the checkout's gitignored ``build/``: each machine
keeps its own, and none of it is committed.
"""

import argparse
import json
import time

from maxstyle_tpu_torch.flagship import HISTORY


def load_rows(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def is_contended(row):
    lock = row.get("chip_lock") or {}
    return bool(lock.get("contended")) or not lock.get("acquired", False)


def headline(rows, workload, k=3):
    """{"steps_per_sec", "n", "card", "latest_ts"} of ``workload``'s median
    over its ``k`` newest uncontended rows, or None."""
    clean = [r for r in rows if r.get("workload") == workload and not is_contended(r)]
    recent = sorted(clean, key=lambda r: r.get("ts", 0))[-k:]
    if not recent:
        return None
    vals = sorted(r["steps_per_s"] for r in recent)
    return {"steps_per_sec": vals[len(vals) // 2], "n": len(recent),
            "card": recent[-1].get("card"), "latest_ts": recent[-1].get("ts")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--last", type=int, default=8)
    ap.add_argument("--k", type=int, default=3)
    opt = ap.parse_args(argv)
    rows = load_rows(HISTORY)

    print(f"{'when (UTC)':20} {'workload':20} {'steps/s':>8}  contention")
    for r in rows[-opt.last:]:
        when = time.strftime("%Y-%m-%d %H:%M", time.gmtime(r.get("ts", 0)))
        note = ("CONTENDED" if is_contended(r)
                else f"clean (waited {r['chip_lock']['waited_s']}s)")
        print(f"{when:20} {r['workload']:20} {r['steps_per_s']:8.3f}  {note}")

    print()
    for workload in sorted({r["workload"] for r in rows}):
        h = headline(rows, workload, opt.k)
        if h:
            print(json.dumps({"workload": workload, "headline_steps_per_sec": h["steps_per_sec"],
                              "median_of_last_n_uncontended": h["n"], "card": h["card"]}))
        else:
            print(f"{workload}: no uncontended rows yet")


if __name__ == "__main__":
    main()
