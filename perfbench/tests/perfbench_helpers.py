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


def reference_steps(cell, seed: int, n_steps: int):
    """``n_steps`` checked steps as the reference takes them, on the CPU,
    without the program: the pool's slices in order, the benchmark's
    augmentation, style and noise draws of each step from ``seed``."""
    import torch

    from perfbench import inputs
    exp = cell.experiment()
    crop, pad = exp["data"]["crop_size"][0], exp["data"]["pad_size"][0]
    batch = exp["learning"]["batch_size"]
    n_raw = batch // 2 if exp["data"]["keep_orig_image_label_pair_for_training"] else batch
    pool = inputs.SlicePool(seed, cell.traffic["pool_slices"], pad)
    job = cell.job()
    steps = []
    for k in range(n_steps):
        idx = list(range(k * n_raw, (k + 1) * n_raw))
        aug = inputs.draw_aug(inputs.generator(seed, "aug", k), cell.config["augmentation"],
                              n_raw, (pad, pad), (crop, crop))
        style = (inputs.draw_style(inputs.generator(seed, "style", k), batch, job["max_style"])
                 if job["max_style"] else None)
        noise = torch.randn((batch, 1, crop, crop), generator=inputs.generator(seed, "noise", k))
        steps.append({"image": torch.from_numpy(pool.images[idx]),
                      "label": torch.from_numpy(pool.labels[idx]).long(),
                      "aug_draws": aug, "style_init": style, "noise": noise})
    return steps


def reference_run(cell, seed: int, n_steps: int, dtype=None):
    """The reference's ``train_steps`` over ``reference_steps`` from the
    benchmark's weights of ``seed``, on the CPU."""
    import torch

    from perfbench import inputs
    from perfbench.reference import nets as N
    from perfbench.reference import step as R
    exp = cell.experiment()
    crop, pad = exp["data"]["crop_size"][0], exp["data"]["pad_size"][0]
    net = cell.net()
    weights = inputs.make_weights(N.param_specs(net, crop), seed, "cpu")
    return R.train_steps(net, weights, reference_steps(cell, seed, n_steps), cell.job(),
                         cell.config["augmentation"], (pad, pad), (crop, crop),
                         dtype=dtype or torch.float32)
