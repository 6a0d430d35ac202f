"""The synthetic phantom task, and the RandConv view-BatchNorm A/B on it.

    python -m maxstyle_tpu_torch.scripts.ab_randconv_bn [--steps 320]
        [--hw 192] [--batch 10] [--seed 0] [--device cpu]

Counterpart of ``scripts/ab_randconv_bn.py``. The task: disks of three
radius classes on a noisy background (:func:`phantom_batch`), scored by
the Dice of each foreground class (:func:`dice_per_class`). Both are numpy
copies of the script's, so from the same ``np.random.RandomState`` they
give its arrays bit for bit: the data stream of the two packages is the
same, step by step.

The A/B trains ``rand_conv`` twice from the same seeds and data stream,
with ``learning.randconv_view_bn`` "frozen" and then "train" (the three
random-conv view forwards with frozen BatchNorm statistics, or updating
them as the reference does), and scores each on the same validation
phantoms with eval-mode ``encode_image`` and ``decode``, the argmax taken
on the device. The step's draws come from a ``torch.Generator`` seeded
with ``seed + 2``; JAX keys and torch generators cannot draw alike, so
across packages only the data stream is the same.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from maxstyle_tpu_torch.config import (DataConfig, ExperimentConfig, LearningConfig,
                                       SegmentationModelConfig)
from maxstyle_tpu_torch.flagship import config_solver
from maxstyle_tpu_torch.train import to_device
from maxstyle_tpu_torch.train_step import make_train_step


def phantom_batch(rng: np.random.RandomState, n: int, hw: int):
    """Disks of 3 radius classes on a noisy background: images [n,hw,hw,1]
    float32 in [0, 1] and labels [n,hw,hw] int32."""
    imgs = np.zeros((n, hw, hw), np.float32)
    labs = np.zeros((n, hw, hw), np.int32)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    for i in range(n):
        k = rng.randint(1, 4)  # class 1..3
        r = hw * (0.08 + 0.07 * k)
        cy = rng.uniform(0.3, 0.7) * hw
        cx = rng.uniform(0.3, 0.7) * hw
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        mask = d < r
        imgs[i] = 0.2 + 0.15 * rng.randn(hw, hw).astype(np.float32)
        imgs[i][mask] += 0.25 * k
        labs[i][mask] = k
        imgs[i] = np.clip(imgs[i], 0, 1)
    return imgs[..., None], labs


def dice_per_class(pred, lab, n_classes=4):
    """The Dice of each class 1..n_classes-1; NaN where neither map has it."""
    out = []
    for c in range(1, n_classes):
        p = pred == c
        g = lab == c
        denom = p.sum() + g.sum()
        out.append(2.0 * np.logical_and(p, g).sum() / denom if denom else np.nan)
    return out


def train_steps(solver, state, steps: int, data_rng: np.random.RandomState,
                generator: torch.Generator, batch: int, hw: int, log_every: int = 0,
                tag: str = ""):
    """``steps`` training steps on phantom batches drawn from ``data_rng``,
    each copied to the device from pinned memory without blocking. The
    losses stay on the device (every ``log_every`` steps one is printed).
    Returns (state, the last step's metrics or None)."""
    step = make_train_step(solver)
    metrics = None
    for i in range(steps):
        imgs, labs = phantom_batch(data_rng, batch, hw)
        state, metrics = step(state, to_device({"image": imgs, "label": labs}, solver.device),
                              generator)
        if log_every and i % log_every == 0:
            print(f"  [{tag}] step {i}: total={float(metrics['loss/total']):.4f} "
                  f"rc={float(metrics['loss/hard/rand_conv']):.4f}", flush=True)
    return state, metrics


def run(view_bn: str, steps: int, hw: int, batch: int, seed: int, device=None):
    """(validation Dice, final loss, training seconds) of one arm."""
    cfg = ExperimentConfig(
        data=DataConfig(crop_size=(hw, hw, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(network_type="FCN_16_standard_no_STN"),
        learning=LearningConfig(batch_size=batch, rand_conv=True, randconv_view_bn=view_bn,
                                n_epochs=1))
    solver = config_solver(cfg, device)
    state = solver.init_state(seed)
    gen = torch.Generator(device=solver.device).manual_seed(seed + 2)
    t0 = time.time()
    state, metrics = train_steps(solver, state, steps, np.random.RandomState(seed + 1), gen,
                                 batch, hw, log_every=80, tag=view_bn)
    loss = float(metrics["loss/total"]) if metrics else float("nan")  # --steps 0: eval only
    train_s = time.time() - t0

    # eval-mode validation (running statistics: where the two modes can differ)
    nets = state.modules
    val_rng = np.random.RandomState(999)  # the same validation set for both arms
    dices = []
    with torch.no_grad():
        for _ in range(4):
            imgs, labs = phantom_batch(val_rng, batch, hw)
            x = to_device({"image": imgs}, solver.device)["image"].permute(0, 3, 1, 2)
            _, z_s = solver.encode_image(nets, x, mode="eval")
            logits = solver.decode(nets, "segmentation_decoder", z_s, mode="eval")
            pred = logits.argmax(1).cpu().numpy()
            for j in range(batch):
                dices.append(np.nanmean(dice_per_class(pred[j], labs[j])))
    return float(np.nanmean(dices)), loss, train_s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=320)
    ap.add_argument("--hw", type=int, default=192)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; the GPU by default ('cpu' to run on the CPU)")
    opt = ap.parse_args(argv)

    from maxstyle_tpu_torch.solver import resolve_device
    dev = resolve_device(opt.device)
    print(f"devices: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    results = {}
    for mode in ("frozen", "train"):
        print(f"== arm: randconv_view_bn={mode}")
        d, loss, secs = run(mode, opt.steps, opt.hw, opt.batch, opt.seed, dev)
        results[mode] = (d, loss)
        print(f"  -> val Dice(fg mean) {d:.4f}  final loss {loss:.4f} ({secs:.0f}s)")
    df, dt = results["frozen"][0], results["train"][0]
    print(f"\nA/B summary ({opt.steps} steps, batch {opt.batch}, {opt.hw}^2):")
    print(f"  frozen view BN : Dice {df:.4f}")
    print(f"  train  view BN : Dice {dt:.4f}")
    print(f"  delta (train - frozen): {dt - df:+.4f}")


if __name__ == "__main__":
    main()
