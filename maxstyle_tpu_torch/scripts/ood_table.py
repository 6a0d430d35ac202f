"""Summarize ood_method_comparison JSONL checkpoints into markdown tables.

    python -m maxstyle_tpu_torch.scripts.ood_table [FILE.jsonl ...]

Counterpart of ``scripts/ood_table.py``: on the same files it prints the
same text, byte for byte. Groups rows by (steps, batch, hw,
style_group_size) workload, then prints one mean±std-over-seeds markdown
table per workload. Numpy only: it runs anywhere, with no device. Without
arguments it renders the port's 600-step records.
"""

import json
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np

RECORDS = Path(__file__).resolve().parent / "records"
# canonical column order; files with other eval domains (e.g. the gamma
# probe's gamma1.5/gamma3.0/gamma_raw) fall back to their rows' own key order
DOMAINS = ["iid", "gamma", "bias", "ghosting", "spike"]


def _domains_for(methods):
    """Column set for one workload: canonical if it matches, else the
    union of the rows' dice keys in first-seen order."""
    seen = []
    for per_seed in methods.values():
        for dice in per_seed.values():
            for k in dice:
                if k not in seen:
                    seen.append(k)
    return DOMAINS if set(seen) == set(DOMAINS) else seen


def load(paths):
    groups = defaultdict(lambda: defaultdict(dict))  # wl -> method -> seed
    for path in paths:
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                wl = (r["steps"], r["batch"], r["hw"], r.get("style_group_size"))
                groups[wl][r["method"]][r["seed"]] = r["dice"]
    return groups


def cell(vals):
    if len(vals) > 1:
        return f"{np.mean(vals):.3f}±{np.std(vals):.3f}"
    return f"{np.mean(vals):.4f}"


def main(paths):
    # style_group_size is None for ungrouped arms; it sorts as -1, so a file
    # mixing grouped and ungrouped workloads sorts without a TypeError
    for wl, methods in sorted(load(paths).items(),
                              key=lambda kv: kv[0][:3] + (
                                  -1 if kv[0][3] is None else kv[0][3],)):
        steps, batch, hw, group = wl
        domains = _domains_for(methods)
        print(f"\n### steps={steps} batch={batch} hw={hw} "
              f"style_group_size={group}")
        print("| method | seeds | " + " | ".join(domains) + " | OOD avg |")
        print("|---|---|" + "---|" * (len(domains) + 1))
        for method, per_seed in methods.items():
            seeds = sorted(per_seed)
            cells = [cell([per_seed[s][d] for s in seeds]) for d in domains]
            ood = cell([np.mean([per_seed[s][d] for d in domains
                                 if d != "iid"]) for s in seeds])
            print(f"| {method} | {','.join(map(str, seeds))} | "
                  + " | ".join(cells) + f" | **{ood}** |")


if __name__ == "__main__":
    main(sys.argv[1:] or [str(RECORDS / "ood_multiseed_h100.jsonl")])
