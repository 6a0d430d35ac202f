"""Where the time of a training step goes, on the GPU.

    python3 -m maxstyle_tpu_torch.profile_slice [--workload headline|prostate_cubic]
                                                [--k-inner 4] [--top 25]

Warms up one ``make_multi_step`` call of the workload (``headline``: the
flagship, effective batch 20 at 192^2; ``prostate_cubic``: the Prostate
MaxStyle config with the cubic warp, effective batch 20 at 224^2; both
MaxStyle n_iter=5), then traces one more call with ``torch.profiler`` and
prints: the wall time of the traced call, the summed device time of all
kernels and the device's busy share (device time over wall time), the
device launches a step, the launches and device time per step of the
port's CUDA kernels, the kernels with the most device time, and those with
the most launches.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from maxstyle_tpu_torch.flagship import WORKLOADS, make_raw_batches, workload_policy
from maxstyle_tpu_torch.train_step import make_multi_step

# symbol fragments of the port's kernels in the profiler's kernel names
PORT_KERNELS = {name: f"{name}_kernel" for name in
                ("maxstyle_stats", "maxstyle_apply", "maxstyle_bwd", "warp_bilinear_nearest",
                 "warp_cubic_nearest")}


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=sorted(WORKLOADS), default="headline")
    ap.add_argument("--k-inner", type=int, default=4)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    solver = WORKLOADS[args.workload](device="cuda")
    cfg = solver.config
    state = solver.init_state(0)
    policy = workload_policy(cfg)
    raw = make_raw_batches(args.k_inner, cfg.train_batch_size, policy.pad_hw[0], 1,
                           solver.device, num_classes=cfg.segmentation_model.num_classes)
    multi = make_multi_step(solver, policy,
                            keep_orig=cfg.data.keep_orig_image_label_pair_for_training,
                            n_inner=args.k_inner)
    gen = torch.Generator(device=solver.device).manual_seed(10)
    state, _ = multi(state, raw, gen)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = multi(state, raw, gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    float(metrics["loss/total"])

    # device-side events only: an operator's row repeats its kernels' time,
    # and so does a user range's on the device timeline (the optimizer's
    # "Optimizer.step#AdamW.step")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    steps = args.k_inner
    print(f"profile: {args.workload} on {torch.cuda.get_device_name(0)}; "
          f"one call of {steps} steps")
    if device_ms == 0.0:
        print("profile: the profiler reported no device time: not measured")
        return
    print(f"profile: wall {wall_ms:.3f} ms ({wall_ms / steps:.3f} ms/step) under the "
          f"profiler; kernel device time {device_ms:.3f} ms "
          f"({device_ms / steps:.3f} ms/step); device busy share "
          f"{device_ms / wall_ms:.4f}")
    print(f"profile: device launches {sum(e.count for e in kernels) / steps:.1f}/step "
          f"(every kernel)")
    for name, frag in PORT_KERNELS.items():
        evts = [e for e in kernels if frag in e.key]
        us = sum(_device_us(e) for e in evts)
        calls = sum(e.count for e in evts)
        print(f"profile: port kernel {name}: {calls / steps:.1f} launches/step, "
              f"{us / 1e3 / steps:.4f} ms/step device")
    kernels.sort(key=_device_us, reverse=True)
    for e in kernels[:args.top]:
        print(f"profile: {_device_us(e) / 1e3 / steps:9.4f} ms/step "
              f"{e.count / steps:7.1f} calls/step  {e.key[:110]}")
    kernels.sort(key=lambda e: e.count, reverse=True)
    for e in kernels[:10]:
        print(f"profile: most launched {e.count / steps:7.1f} calls/step "
              f"{_device_us(e) / 1e3 / steps:9.4f} ms/step  {e.key[:110]}")


if __name__ == "__main__":
    main()
