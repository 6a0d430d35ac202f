"""Helpers of the benchmark's tests."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_cell(name: str, pad: int = 40, crop: int = 32, batch: int = 4, pool: int = 16,
              n_iter: int = 1, check_steps: int = 3):
    """The cell ``name`` at a size the CPU holds: only pads, crops, batch,
    pool and the inner loop's length are cut."""
    from perfbench.manifest import load_cell
    cell = load_cell(name)
    d = cell.config["experiment"]["data"]
    d["pad_size"] = [pad, pad, 1]
    d["crop_size"] = [crop, crop, 1]
    cell.traffic["experiment"]["learning"]["batch_size"] = batch
    cell.traffic["pool_slices"] = pool
    cell.traffic["warmup_steps"] = 1
    cell.traffic["check_steps"] = check_steps
    if "max_style" in cell.traffic["experiment"]:
        cell.traffic["experiment"]["max_style"]["n_iter"] = n_iter
    return cell


def standard_cell(config: str = "fcn16_acdc"):
    """The cell ``<config>.maxstyle`` on the shipped standard job
    (``traffic/standard.json``, kept for the standard cells' return)."""
    import dataclasses
    import json

    from perfbench.manifest import HERE, load_cell
    with open(HERE / "traffic" / "standard.json") as f:
        traffic = json.load(f)
    return dataclasses.replace(load_cell(f"{config}.maxstyle"), name=f"{config}.standard",
                               traffic=traffic)
