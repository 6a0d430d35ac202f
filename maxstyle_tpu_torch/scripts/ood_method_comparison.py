"""The paper's claim tested end to end on synthetic data: adversarial style
augmentation (MaxStyle) makes segmentation more robust out of domain than
standard training.

    python -m maxstyle_tpu_torch.scripts.ood_method_comparison [--steps 600]
        [--hw 192] [--batch 10] [--seed 0 | --seeds 1,2,3]
        [--style_group_size G] [--out results.jsonl]
        [--methods standard,max_style,...] [--domains iid,gamma,bias,ghosting,spike]
        [--stop_file PATH] [--device cpu]

Counterpart of ``scripts/ood_method_comparison.py``, with its flags, output
lines and JSONL keys. The training domain is the 3-class disk phantom
(``ab_randconv_bn.phantom_batch``), clean, with a fixed intensity profile.
The test domains are the same phantoms under corruptions no method sees in
training (:func:`corrupt`): a gamma shift and the k-space artefacts of
``data/artefacts.py`` (bias field, ghosting, spike). Every method trains
FCN_16_standard_no_STN (4 classes, AdamW) with the same seeds and data
stream; only the method flag differs. Each arm is evaluated with
``solver.predict`` (eval mode, no input normalization: the phantoms are in
[0, 1] already) on 6 validation batches from ``RandomState(999)``,
corrupted from ``RandomState(777)``, the argmax on the device and the Dice
on the host; a domain's Dice is the mean over its slices of the mean over
the foreground classes.

Seeding: the weights come from ``init_state(seed)``, the phantom stream
from ``RandomState(seed + 1)`` and the step's draws from one
``torch.Generator`` seeded with ``seed + 2``, drawn in step order. JAX keys
and torch generators cannot draw alike (README "Parity notes"), so across
the two packages only the data stream is identical: their Dice tables
compare as distributions over seeds, not seed by seed. On the GPU a seed is
not reproducible bit for bit either: cuDNN's float32 training differs run
to run.

``--steps 0`` only evaluates the initial weights. ``--seeds`` runs every
method at each seed and reports mean+/-std a cell. ``--out`` appends one
JSON line per (method, seed) as it lands, and a restart skips the cells
already recorded at the same steps, batch, hw and style group. If a
``--stop_file`` is given and exists, the sweep exits before its next arm;
there is no default path, so a stop file left by an earlier campaign
stops nothing it was not given to. Each arm holds
``utils/gpulock.chip_lock``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from maxstyle_tpu_torch.config import (DataConfig, ExperimentConfig, LearningConfig,
                                       MaxStyleConfig, SegmentationModelConfig)
from maxstyle_tpu_torch.data import artefacts
from maxstyle_tpu_torch.flagship import config_solver
from maxstyle_tpu_torch.scripts.ab_randconv_bn import dice_per_class, phantom_batch, train_steps
from maxstyle_tpu_torch.solver import resolve_device
from maxstyle_tpu_torch.train import to_device

def corrupt(kind: str, imgs: np.ndarray, rng: np.random.RandomState):
    """[N,H,W,1] -> corrupted copy; per-volume k-space artefacts.

    Gamma variants of the evaluation probe:
      gamma       — x**2.2 then per-slice min-max re-norm (the canonical column)
      gamma{X}    — x**X then re-norm, e.g. gamma1.5 / gamma3.0
      gamma_raw   — x**2.2 without the re-norm (x in [0,1] stays in [0,1])
    """
    x = imgs[..., 0]
    if kind == "iid":
        return imgs
    if kind == "gamma_raw":
        out = np.clip(x, 0, 1) ** 2.2
        return out.astype(np.float32)[..., None]
    if kind.startswith("gamma"):
        out = np.clip(x, 0, 1) ** (2.2 if kind == "gamma" else float(kind[5:]))
    elif kind == "bias":
        out = artefacts.random_bias_field(x, rng)
    elif kind == "ghosting":
        out = artefacts.random_ghosting(x, rng)
    elif kind == "spike":
        out = artefacts.random_spike(x, rng)
    else:
        raise ValueError(kind)
    # per-slice min-max back to [0,1] (the eval pipeline normalizes too)
    mn = out.min(axis=(1, 2), keepdims=True)
    mx = out.max(axis=(1, 2), keepdims=True)
    return ((out - mn) / (mx - mn + 1e-8)).astype(np.float32)[..., None]


def make_config(method: str, hw: int, batch: int, style_group_size=None):
    kw = {} if method == "standard" else {method: True}
    return ExperimentConfig(
        data=DataConfig(crop_size=(hw, hw, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(network_type="FCN_16_standard_no_STN"),
        learning=LearningConfig(batch_size=batch, n_epochs=1, **kw),
        max_style=MaxStyleConfig(style_group_size=style_group_size))


def predict_labels(solver, nets, imgs: np.ndarray) -> np.ndarray:
    """The argmax labels [N,H,W] of images [N,H,W,1], taken on the device."""
    x = to_device({"image": imgs}, solver.device)["image"]
    logits = solver.predict(nets, x, softmax=False, normalize_input=False)
    return logits.argmax(-1).cpu().numpy()


def evaluate(solver, nets, domains, batch: int, hw: int):
    """{domain: Dice} over the 6 validation batches of every arm."""
    results = {}
    for kind in domains:
        val_rng = np.random.RandomState(999)   # the same validation volumes everywhere
        cor_rng = np.random.RandomState(777)   # the same corruption draws
        dices = []
        for _ in range(6):
            imgs, labs = phantom_batch(val_rng, batch, hw)
            pred = predict_labels(solver, nets, corrupt(kind, imgs, cor_rng))
            for j in range(batch):
                dices.append(np.nanmean(dice_per_class(pred[j], labs[j])))
        results[kind] = float(np.nanmean(dices))
    return results


def train_and_eval(method: str, steps: int, hw: int, batch: int, seed: int, domains,
                   style_group_size=None, *, device=None, state_dicts=None):
    """({domain: Dice}, the last step's loss, training seconds) of one arm.
    ``state_dicts`` ({module: state dict}, e.g. from ``convert.py``) replaces
    the weights of ``init_state(seed)``."""
    solver = config_solver(make_config(method, hw, batch, style_group_size), device)
    state = solver.init_state(seed, state_dicts=state_dicts)
    gen = torch.Generator(device=solver.device).manual_seed(seed + 2)
    t0 = time.time()
    state, metrics = train_steps(solver, state, steps, np.random.RandomState(seed + 1), gen,
                                 batch, hw)
    # the one read of a loss, after the loop; --steps 0 is the eval-only run
    loss = float(metrics["loss/total"]) if metrics else float("nan")
    train_s = time.time() - t0
    return evaluate(solver, state.modules, domains, batch, hw), loss, train_s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--hw", type=int, default=192)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0,
                    help="single seed (ignored when --seeds is given)")
    ap.add_argument("--seeds", type=str, default=None,
                    help="comma list, e.g. 0,1,2 — mean+/-std table")
    ap.add_argument("--style_group_size", type=int, default=None,
                    help="MaxStyle stat-group size for scaled batches "
                         "(config.MaxStyleConfig.style_group_size)")
    ap.add_argument("--out", type=str, default=None,
                    help="JSONL checkpoint: append one line per "
                         "(method, seed); skip cells already present")
    ap.add_argument("--methods", type=str, default="standard,max_style")
    ap.add_argument("--domains", type=str, default="iid,gamma,bias,ghosting,spike",
                    help="eval domains; gamma1.5/gamma3.0/gamma_raw probe "
                         "the gamma-column eval artifact")
    ap.add_argument("--stop_file", type=str, default=None,
                    help="if this path exists, exit cleanly before the "
                         "next arm (bounds a background campaign)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; the GPU by default ('cpu' to run on the CPU)")
    opt = ap.parse_args(argv)
    domains = opt.domains.split(",")
    seeds = [int(s) for s in opt.seeds.split(",")] if opt.seeds else [opt.seed]
    methods = opt.methods.split(",")

    done = {}
    if opt.out and os.path.exists(opt.out):
        with open(opt.out) as f:
            for line in f:
                rec = json.loads(line)
                if (rec.get("steps") == opt.steps
                        and rec.get("batch") == opt.batch
                        and rec.get("hw") == opt.hw
                        and rec.get("style_group_size") == opt.style_group_size):
                    done[(rec["method"], rec["seed"])] = rec["dice"]

    dev = resolve_device(opt.device)
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    print(f"devices: {dev} ({device_name})")
    from maxstyle_tpu_torch.utils.gpulock import chip_lock, yield_to_bench
    table = {}  # method -> seed -> {domain: dice}
    stopped = False
    for method in methods:
        table[method] = {}
        for seed in seeds:
            if (method, seed) in done:
                table[method][seed] = done[(method, seed)]
                print(f"== {method} seed {seed}: cached from {opt.out}", flush=True)
                continue
            if opt.stop_file and os.path.exists(opt.stop_file):
                print(f"== stop file {opt.stop_file} present — exiting "
                      f"before {method} seed {seed}", flush=True)
                stopped = True
                break
            yield_to_bench()  # let a waiting benchmark go first
            print(f"== training {method} seed {seed} ({opt.steps} steps, "
                  f"batch {opt.batch}, group {opt.style_group_size})", flush=True)
            with chip_lock(f"ood:{method}:s{seed}"):
                res, loss, secs = train_and_eval(
                    method, opt.steps, opt.hw, opt.batch, seed, domains,
                    opt.style_group_size, device=dev)
            table[method][seed] = res
            row = "  ".join(f"{k}={v:.4f}" for k, v in res.items())
            print(f"  {method} s{seed}: {row}  (final loss {loss:.3f}, "
                  f"{secs:.0f}s)", flush=True)
            if opt.out:
                with open(opt.out, "a") as f:
                    f.write(json.dumps({
                        "method": method, "seed": seed, "steps": opt.steps,
                        "batch": opt.batch, "hw": opt.hw,
                        "style_group_size": opt.style_group_size,
                        "platform": dev.type, "device": device_name,
                        "dice": res, "final_loss": loss,
                        "train_s": secs}) + "\n")
        if stopped:
            break

    print("\nOOD Dice summary (mean over foreground classes"
          + (f", mean+/-std over seeds {seeds}" if len(seeds) > 1 else "")
          + "):")
    hdr = ("method".ljust(14)
           + "".join(d.rjust(16) for d in domains) + "         OOD avg")
    print(hdr)
    for method, per_seed in table.items():
        have = [s for s in seeds if s in per_seed]  # the stop file may truncate
        if not have:
            continue
        cells = []
        for d in domains:
            vals = [per_seed[s][d] for s in have]
            cells.append(f"{np.mean(vals):.3f}+/-{np.std(vals):.3f}"
                         if len(have) > 1 else f"{np.mean(vals):.4f}")
        ood_per_seed = [np.mean([per_seed[s][d] for d in domains
                                 if d != "iid"]) for s in have]
        ood = (f"{np.mean(ood_per_seed):.3f}+/-{np.std(ood_per_seed):.3f}"
               if len(have) > 1 else f"{np.mean(ood_per_seed):.4f}")
        print(method.ljust(14) + "".join(c.rjust(16) for c in cells)
              + ood.rjust(17))


if __name__ == "__main__":
    main()
