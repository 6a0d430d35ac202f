"""The port's entry points: MaxStyle training workloads built from a config.

Counterpart of ``__graft_entry__._flagship_solver`` and
``bench.measure_throughput`` of the JAX package.

* :func:`config_solver` builds the solver of any :class:`ExperimentConfig`;
  :func:`load_config` reads a file under ``configs/`` with an optional
  ``image_interp`` override, the knob that the JAX package's ``train.py``
  reads (``data.image_interp``).
* :func:`flagship_solver` is the headline configuration
  (configs/ACDC/1500_epoch/MICCAI2022_MaxStyle.json): FCN_16_standard_no_STN,
  effective batch 20 (10 augmented + 10 original slices), 224^2 padded
  slices cropped to 192^2 with policy ACDC_affine_elastic_intensity, AdamW
  1e-4, and the MaxStyle inner loop Adam(0.1) x 5 at decoder hooks (3, 4, 5).
* :func:`prostate_cubic_solver` is configs/Prostate/MICCAI2022_MaxStyle.json
  with ``image_interp="cubic"``: 288^2 pads cropped to 224^2, 2 classes,
  policy Prostate_affine_elastic_intensity, the order-3 spline warp.
* :data:`WORKLOADS` names every workload: ``headline``, ``prostate_cubic``,
  and one a method-branch config at its published sizes —
  ``prostate_{mixstyle,dsu,lsm,rsc,randconv,adv_noise,adv_bias}``
  (configs/Prostate/, 288^2 -> 224^2, 2 classes), ``acdc_lsm``
  (configs/ACDC/1500_epoch/MICCAI2021_LSM.json, 224^2 -> 192^2, 4 classes)
  — and ``prostate_standard`` (configs/Prostate/standard_training.json), the
  base they are compared with; and one a network family on the headline's
  file (configs/ACDC/1500_epoch/MICCAI2022_MaxStyle.json, its widths and
  MaxStyle loop) with another network_type: ``headline_stn``
  (FCN_16_standard), ``headline_ds_fcn`` (DS_FCN_16_standard),
  ``headline_unet`` (Unet_16_Unet_im_recon_no_STN), ``headline_unetr``
  (UnetTransformer_16_no_STN: a ViT-B/16 at hidden 768, 12 layers, over the
  192^2 crops), ``headline_swin_unetr`` (SwinUNETR_16_no_STN: feature 48,
  depths 2-2-2-2, window 7, over the 192^2 crops); and the headline's file
  with one learning option changed: ``headline_bf16`` (``compute_dtype="bfloat16"``: bf16 activations,
  float32 weights, optimizer state, BatchNorm statistics and losses),
  ``headline_unetr_bf16`` (``headline_unetr`` so) and ``headline_ngf``
  (``rec_loss_type="ngf"``, the normalized-gradient-field reconstruction
  loss); and ``acdc_b80_grouped``, configs/TPU/ACDC_MaxStyle_b80_grouped.json
  as shipped: the headline's step at effective batch 80 (40 augmented + 40
  original slices, 224^2 -> 192^2, AdamW) with the MaxStyle statistics
  taken over style groups of 20.
* :func:`measure_throughput` times ``make_multi_step`` on synthetic raw
  slices, with the policy, sizes and class count of the solver's config;
  ``python3 -m maxstyle_tpu_torch.flagship --workload <name>`` prints its
  steps/s as one JSON line (K = 4, rounds of 2 calls, as ``chip_smoke.py``
  runs it) and appends it, with the card lock's contention, to the history
  ``build/flagship_history.jsonl`` that ``scripts/bench_summary`` renders.
  Run as ``PYTHONPATH=<checkout> python3
  maxstyle_tpu_torch/flagship.py ...`` it times another checkout's step.

Every entry point runs on the GPU unless the caller passes ``device="cpu"``;
without a GPU and without that request it raises.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from pathlib import Path
from typing import Optional

import torch

from maxstyle_tpu_torch.config import (DataConfig, ExperimentConfig, LearningConfig,
                                       MaxStyleConfig, SegmentationModelConfig)
from maxstyle_tpu_torch.data import augment as A
from maxstyle_tpu_torch.solver import TripletSegmentationSolver, resolve_device
from maxstyle_tpu_torch.train_step import make_multi_step

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
PROSTATE_MAXSTYLE = CONFIGS / "Prostate" / "MICCAI2022_MaxStyle.json"
ACDC_MAXSTYLE = CONFIGS / "ACDC" / "1500_epoch" / "MICCAI2022_MaxStyle.json"
ACDC_B80_GROUPED = CONFIGS / "TPU" / "ACDC_MaxStyle_b80_grouped.json"
HISTORY = CONFIGS.parent / "build" / "flagship_history.jsonl"


def set_float32_policy(device: torch.device) -> None:
    """Whatever the port computes in float32 (everything, or under
    ``compute_dtype="bfloat16"`` the norms, the style ops and the losses)
    runs with TF32 off for both convolutions and matrix products: the JAX
    package's float32 semantics, against which the port is held. Whether
    TF32 pays on the H100 is for a measured change to decide."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def load_config(path, image_interp: Optional[str] = None) -> ExperimentConfig:
    """A config file, with ``data.image_interp`` replaced when given."""
    cfg = ExperimentConfig.from_json(str(path))
    if image_interp is not None:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                image_interp=image_interp))
    return cfg


def config_solver(cfg: ExperimentConfig, device=None) -> TripletSegmentationSolver:
    """The solver of ``cfg`` on ``device`` (the GPU by default)."""
    dev = resolve_device(device)
    set_float32_policy(dev)
    return TripletSegmentationSolver(cfg, device=dev)


def flagship_solver(hw: int = 192, batch: int = 20, max_style: bool = True,
                    style_group_size=None, device=None) -> TripletSegmentationSolver:
    """The headline MaxStyle solver (effective batch ``batch``, crops ``hw``)."""
    cfg = ExperimentConfig(
        data=DataConfig(crop_size=(hw, hw, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(
            network_type="FCN_16_standard_no_STN", num_classes=4),
        learning=LearningConfig(lr=1e-4, batch_size=batch, optimizer_type="AdamW",
                                max_style=max_style),
        max_style=MaxStyleConfig(n_iter=5, decoder_layers_indexes=(3, 4, 5),
                                 style_group_size=style_group_size),
    )
    return config_solver(cfg, device)


def prostate_cubic_solver(device=None) -> TripletSegmentationSolver:
    """The Prostate MaxStyle solver with the cubic image warp."""
    return config_solver(load_config(PROSTATE_MAXSTYLE, image_interp="cubic"), device)


def make_raw_batches(k_inner: int, half_batch: int, pad: int, seed: int,
                     device, num_classes: int = 4) -> dict:
    """Synthetic raw slices made on the device from ``seed``: images
    clip(0.5 + 0.25 N(0,1), 0, 1), labels uniform in {0..num_classes-1}
    (int32)."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (k_inner, half_batch, pad, pad)
    image = torch.clamp(0.5 + 0.25 * torch.randn(shape, generator=g, device=device), 0, 1)
    label = torch.randint(0, num_classes, shape, generator=g, device=device, dtype=torch.int32)
    return {"image": image, "label": label}


def workload_policy(cfg: ExperimentConfig) -> A.AugPolicy:
    """The augmentation policy of ``cfg``: its policy name, pad and crop
    sizes and image interpolation."""
    d = cfg.data
    return A.get_policy(d.data_aug_policy, tuple(d.pad_size[:2]), tuple(d.crop_size[:2]),
                        image_interp=d.image_interp)


def measure_throughput(solver: TripletSegmentationSolver, k_inner: int = 16,
                       n_calls: int = 2, n_repeats: int = 3, seed: int = 0):
    """Median steps/s of the solver's workload: one warm-up call of
    ``make_multi_step`` (K = ``k_inner`` steps), then ``n_repeats`` timed
    rounds of ``n_calls`` calls, each bracketed by
    ``torch.cuda.synchronize()``. The policy, sizes, class count, loader
    batch and the keep-original pairing come from the solver's config.
    Returns (steps/s, state, metrics of the last call)."""
    dev = solver.device
    cfg = solver.config
    policy = workload_policy(cfg)
    state = solver.init_state(seed)
    raw = make_raw_batches(k_inner, cfg.train_batch_size, policy.pad_hw[0], seed + 1, dev,
                           num_classes=cfg.segmentation_model.num_classes)
    multi = make_multi_step(solver, policy,
                            keep_orig=cfg.data.keep_orig_image_label_pair_for_training,
                            n_inner=k_inner)
    gen = torch.Generator(device=dev).manual_seed(seed + 10)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    state, metrics = multi(state, raw, gen)
    sync()
    rates = []
    for _ in range(n_repeats):
        sync()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            state, metrics = multi(state, raw, gen)
        sync()
        rates.append(n_calls * k_inner / (time.perf_counter() - t0))
    rates.sort()
    return rates[len(rates) // 2], state, metrics


def config_file_solver(path, device=None) -> TripletSegmentationSolver:
    """The solver of the config file ``path`` as shipped."""
    return config_solver(load_config(path), device)


def family_solver(network_type: str = "FCN_16_standard_no_STN", device=None,
                  **learning) -> TripletSegmentationSolver:
    """The headline's config file with ``network_type`` in place of its
    FCN_16_standard_no_STN and the ``learning`` options given."""
    cfg = load_config(ACDC_MAXSTYLE)
    cfg = dataclasses.replace(
        cfg, segmentation_model=dataclasses.replace(cfg.segmentation_model,
                                                    network_type=network_type),
        learning=dataclasses.replace(cfg.learning, **learning))
    return config_solver(cfg, device)


# the network families on the headline's config
FAMILIES = {"headline_stn": "FCN_16_standard", "headline_ds_fcn": "DS_FCN_16_standard",
            "headline_unet": "Unet_16_Unet_im_recon_no_STN",
            "headline_unetr": "UnetTransformer_16_no_STN",
            "headline_swin_unetr": "SwinUNETR_16_no_STN"}
# the method-branch configs and the standard training they are compared with
BRANCH_CONFIGS = {
    "prostate_standard": CONFIGS / "Prostate" / "standard_training.json",
    "prostate_mixstyle": CONFIGS / "Prostate" / "MixStyle.json",
    "prostate_dsu": CONFIGS / "Prostate" / "DSU.json",
    "prostate_lsm": CONFIGS / "Prostate" / "MICCAI2021_LSM.json",
    "prostate_rsc": CONFIGS / "Prostate" / "RSC.json",
    "prostate_randconv": CONFIGS / "Prostate" / "RandConv.json",
    "prostate_adv_noise": CONFIGS / "Prostate" / "adv_noise.json",
    "prostate_adv_bias": CONFIGS / "Prostate" / "adv_bias.json",
    "acdc_lsm": CONFIGS / "ACDC" / "1500_epoch" / "MICCAI2021_LSM.json",
}
WORKLOADS = {"headline": flagship_solver, "prostate_cubic": prostate_cubic_solver,
             **{name: functools.partial(config_file_solver, path)
                for name, path in BRANCH_CONFIGS.items()},
             **{name: functools.partial(family_solver, network_type)
                for name, network_type in FAMILIES.items()},
             "headline_bf16": functools.partial(family_solver, compute_dtype="bfloat16"),
             "headline_unetr_bf16": functools.partial(family_solver, FAMILIES["headline_unetr"],
                                                      compute_dtype="bfloat16"),
             "headline_ngf": functools.partial(family_solver, rec_loss_type="ngf"),
             "acdc_b80_grouped": functools.partial(config_file_solver, ACDC_B80_GROUPED)}


def main(argv=None) -> None:
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description="steps/s of a MaxStyle training workload")
    ap.add_argument("--workload", choices=sorted(WORKLOADS), default="headline")
    args = ap.parse_args(argv)
    from maxstyle_tpu_torch.timing import card
    from maxstyle_tpu_torch.utils.gpulock import chip_lock
    with chip_lock(f"flagship {args.workload}", bench_priority=True) as lock:
        solver = WORKLOADS[args.workload](device="cuda")
        # the median of 5 timed rounds of 2 calls
        rate, _, _ = measure_throughput(solver, k_inner=4, n_calls=2, n_repeats=5)
    row = {"workload": args.workload, "steps_per_s": rate,
           "device": torch.cuda.get_device_name(0), "card": card(),
           "package": sys.modules["maxstyle_tpu_torch"].__file__}
    print(json.dumps(row))
    HISTORY.parent.mkdir(parents=True, exist_ok=True)
    with open(HISTORY, "a") as f:
        f.write(json.dumps({**row, "ts": time.time(), "chip_lock": lock}) + "\n")


if __name__ == "__main__":
    main()
