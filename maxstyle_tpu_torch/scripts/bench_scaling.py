"""Throughput against batch size on the GPU.

    python -m maxstyle_tpu_torch.scripts.bench_scaling [--device cpu]

Counterpart of ``scripts/bench_scaling.py``. Sweeps the effective batch over
20, 40, 80 and 160 at fixed workload semantics: the headline MaxStyle step
(``flagship.flagship_solver``: on-device augmentation of 224^2 raw slices
to 192^2 crops paired with the originals, standard training, the 5-step
adversarial inner loop, hard-example training, AdamW). Above 20 the style
statistics are taken over groups of 20 (``max_style.style_group_size``),
the reference's batch-20 semantics. Each rate is
``flagship.measure_throughput``'s (K=4 steps a call, one warm-up call,
then the median of rounds of 2 calls), as every other rate of the port is
timed.

Prints one JSON line with the device, then one per batch:
``effective_batch``, ``steps_per_sec``, ``slices_per_sec``,
``sec_per_step``, ``style_group_size``, ``peak_memory_gib``
(``torch.cuda.max_memory_allocated`` over the timed run), and the FLOPs of
one step's convolutions and matrix products: ``conv_mm_gflop_per_step``,
counted by ``torch.utils.flop_counter.FlopCounterMode`` over one step at
that batch, ``conv_mm_tflop_per_s`` (that count times steps/s) and
``conv_mm_share_of_fp32_peak`` (against the H100's dense float32 peak of
67 TFLOP/s; TF32 is off). The count sees only aten's convolutions and
matrix products: the port's CUDA kernels (the style statistics, map and
backward, the warp) and every elementwise op are invisible to it, so it is
a lower bound on the step's arithmetic, and not the JAX script's XLA cost
analysis.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from maxstyle_tpu_torch.flagship import (flagship_solver, make_raw_batches, measure_throughput,
                                         workload_policy)
from maxstyle_tpu_torch.timing import FP32_OPS_PER_S
from maxstyle_tpu_torch.train_step import make_fused_train_step

BATCHES = (20, 40, 80, 160)
GROUP = 20


def conv_mm_flops(solver) -> int:
    """The FLOPs of aten's convolutions and matrix products in one fused
    training step of ``solver`` on synthetic raw slices."""
    cfg = solver.config
    policy = workload_policy(cfg)
    raw = make_raw_batches(1, cfg.train_batch_size, policy.pad_hw[0], 1, solver.device,
                           num_classes=cfg.segmentation_model.num_classes)
    step = make_fused_train_step(solver, policy,
                                 keep_orig=cfg.data.keep_orig_image_label_pair_for_training)
    gen = torch.Generator(device=solver.device).manual_seed(2)
    with FlopCounterMode(display=False) as counter:
        step(solver.init_state(0), {k: v[0] for k, v in raw.items()}, gen)
    return counter.get_total_flops()


def sweep(batches=BATCHES, group: int = GROUP, hw: int = 192, k_inner: int = 4,
          rounds: int = 3, device=None):
    """One dict per effective batch (style groups of ``group`` above it)."""
    for eff_batch in batches:
        g = group if eff_batch > group else None
        solver = flagship_solver(hw=hw, batch=eff_batch, style_group_size=g, device=device)
        cuda = solver.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        rate, _, _ = measure_throughput(solver, k_inner=k_inner, n_calls=2, n_repeats=rounds)
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
        flop = conv_mm_flops(solver)
        yield {"effective_batch": eff_batch,
               "steps_per_sec": rate,
               "slices_per_sec": rate * eff_batch,
               "sec_per_step": 1.0 / rate,
               "style_group_size": g,
               "peak_memory_gib": peak,
               "conv_mm_gflop_per_step": flop / 1e9,
               "conv_mm_tflop_per_s": rate * flop / 1e12,
               "conv_mm_share_of_fp32_peak": rate * flop / FP32_OPS_PER_S}
        del solver


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; the GPU by default ('cpu' to run on the CPU)")
    opt = ap.parse_args(argv)
    from maxstyle_tpu_torch.solver import resolve_device
    from maxstyle_tpu_torch.timing import card
    from maxstyle_tpu_torch.utils.gpulock import chip_lock, yield_to_bench

    dev = resolve_device(opt.device)
    print(json.dumps({"backend": dev.type,
                      **({"device": torch.cuda.get_device_name(dev), "card": card()}
                         if dev.type == "cuda" else {})}), flush=True)
    yield_to_bench()  # let a waiting benchmark go first
    with chip_lock("bench_scaling"):
        for line in sweep(device=dev):
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
