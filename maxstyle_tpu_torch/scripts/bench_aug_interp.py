"""On-device augmentation throughput: the bilinear against the cubic warp.

    python -m maxstyle_tpu_torch.scripts.bench_aug_interp [--batch 10]
        [--iters 50] [--pad 224] [--crop 192] [--device cpu]

Counterpart of ``scripts/bench_aug_interp.py``: ``augment_batch_inner`` of
policy ACDC_affine_elastic_intensity, as the training step calls it
(draws, affine matrix, smoothed elastic field, the warp kernel, intensity),
with ``image_interp`` "bilinear" (the composed bilinear warp) and "cubic"
(the spline prefilter and the cubic warp), on synthetic padded slices made
on the device. One warm-up call, then ``--iters`` calls between two
``torch.cuda.synchronize()``; prints the time of a batch and slices/s for
each. This is the augmentation path alone, not ``bench_style``'s kernel
rows.
"""

from __future__ import annotations

import argparse
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--pad", type=int, default=224)
    ap.add_argument("--crop", type=int, default=192)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; the GPU by default ('cpu' to run on the CPU)")
    opt = ap.parse_args(argv)

    from maxstyle_tpu_torch.data import augment as A
    from maxstyle_tpu_torch.flagship import make_raw_batches
    from maxstyle_tpu_torch.solver import resolve_device
    from maxstyle_tpu_torch.utils.gpulock import chip_lock, yield_to_bench

    dev = resolve_device(opt.device)
    print(f"devices: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""), flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    raw = make_raw_batches(1, opt.batch, opt.pad, 1, dev)
    imgs, labs = raw["image"][0], raw["label"][0]
    yield_to_bench()
    with chip_lock("bench_aug_interp"):
        for interp in ("bilinear", "cubic"):
            pol = A.get_policy("ACDC_affine_elastic_intensity", (opt.pad, opt.pad),
                               (opt.crop, opt.crop), image_interp=interp)
            gen = torch.Generator(device=dev).manual_seed(0)
            A.augment_batch_inner(gen, imgs, labs, pol)  # warm-up (and kernel build)
            sync()
            t0 = time.perf_counter()
            for _ in range(opt.iters):
                A.augment_batch_inner(gen, imgs, labs, pol)
            sync()
            dt = time.perf_counter() - t0
            print(f"{interp}: {dt / opt.iters * 1e3:.3f} ms / {opt.batch}-slice "
                  f"batch ({opt.batch / (dt / opt.iters):.0f} slices/s)", flush=True)


if __name__ == "__main__":
    main()
