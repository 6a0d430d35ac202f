"""The port's entry point: the headline MaxStyle training workload.

Counterpart of ``__graft_entry__._flagship_solver`` and
``bench.measure_throughput`` of the JAX package, with the same workload and
constants: the reference's headline configuration
(configs/ACDC/1500_epoch/MICCAI2022_MaxStyle.json) — FCN_16_standard_no_STN,
effective batch 20 (10 augmented + 10 original slices), 224^2 padded slices
cropped to 192^2 with policy ACDC_affine_elastic_intensity, AdamW 1e-4, and
the MaxStyle inner loop Adam(0.1) x 5 at decoder hooks (3, 4, 5).

Both functions run on the GPU unless the caller passes ``device="cpu"``;
without a GPU and without that request they raise.
"""

from __future__ import annotations

import time

import torch

from maxstyle_tpu_torch.config import (DataConfig, ExperimentConfig, LearningConfig,
                                       MaxStyleConfig, SegmentationModelConfig)
from maxstyle_tpu_torch.data import augment as A
from maxstyle_tpu_torch.solver import TripletSegmentationSolver, resolve_device
from maxstyle_tpu_torch.train_step import make_multi_step


def set_float32_policy(device: torch.device) -> None:
    """The port computes in float32, TF32 off for both convolutions and
    matrix products: the JAX package's float32 semantics, against which the
    port is held. Whether bf16 or TF32 pays on the H100 is for a measured
    change to decide."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def flagship_solver(hw: int = 192, batch: int = 20, max_style: bool = True,
                    style_group_size=None, device=None) -> TripletSegmentationSolver:
    """The headline MaxStyle solver (effective batch ``batch``, crops ``hw``)."""
    dev = resolve_device(device)
    set_float32_policy(dev)
    cfg = ExperimentConfig(
        data=DataConfig(crop_size=(hw, hw, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(
            network_type="FCN_16_standard_no_STN", num_classes=4),
        learning=LearningConfig(lr=1e-4, batch_size=batch, optimizer_type="AdamW",
                                max_style=max_style),
        max_style=MaxStyleConfig(n_iter=5, decoder_layers_indexes=(3, 4, 5),
                                 style_group_size=style_group_size),
    )
    return TripletSegmentationSolver(cfg, device=dev)


def make_raw_batches(k_inner: int, half_batch: int, pad: int, seed: int,
                     device) -> dict:
    """Synthetic raw slices made on the device from ``seed``: images
    clip(0.5 + 0.25 N(0,1), 0, 1), labels uniform in {0..3} (int32)."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (k_inner, half_batch, pad, pad)
    image = torch.clamp(0.5 + 0.25 * torch.randn(shape, generator=g, device=device), 0, 1)
    label = torch.randint(0, 4, shape, generator=g, device=device, dtype=torch.int32)
    return {"image": image, "label": label}


def measure_throughput(solver: TripletSegmentationSolver, half_batch: int = 10,
                       pad: int = 224, crop: int = 192, k_inner: int = 16,
                       n_calls: int = 2, n_repeats: int = 3, seed: int = 0):
    """Median steps/s of the headline workload on ``solver``: one warm-up
    call of ``make_multi_step`` (K = ``k_inner`` steps), then ``n_repeats``
    timed rounds of ``n_calls`` calls, each bracketed by
    ``torch.cuda.synchronize()``. Returns (steps/s, state, metrics of the
    last call)."""
    dev = solver.device
    policy = A.get_policy("ACDC_affine_elastic_intensity", (pad, pad), (crop, crop))
    state = solver.init_state(seed)
    raw = make_raw_batches(k_inner, half_batch, pad, seed + 1, dev)
    multi = make_multi_step(solver, policy, keep_orig=True, n_inner=k_inner)
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
