"""Where the time of a training step goes, on the GPU.

    python3 -m maxstyle_tpu_torch.profile_slice [--workload NAME [NAME ...]]
                                                [--ood-arm METHOD [METHOD ...]]
                                                [--k-inner 4] [--top 25]
                                                [--without-live-running-stats]

For each workload of ``flagship.WORKLOADS`` (``headline``: the flagship,
effective batch 20 at 192^2; ``prostate_cubic``: the Prostate MaxStyle
config with the cubic warp, effective batch 20 at 224^2; both MaxStyle
n_iter=5; the method-branch configs and ``prostate_standard``; the network
families ``headline_stn``, ``headline_ds_fcn``, ``headline_unet``,
``headline_unetr``), in one
process: warms up one ``make_multi_step`` call, runs one more with
``torch.cuda.set_sync_debug_mode("warn")`` to count the host's waits for
the device (each warning is one; the lines that caused them are printed),
times two more calls untraced, then traces one more call with
``torch.profiler`` and prints: the host syncs a step, the peak device
memory, the steps a second of the untraced calls, the wall time of the
traced call, the summed device time of all kernels and the device's busy
share (device time over wall time), the device launches a step, the
launches and device time per step of the port's CUDA kernels and of the
dtype casts (``aten::_to_copy``: the bf16 policy's), the kernels
with the most device time, those with the most launches, and the
operators with the most host time.

``--ood-arm`` profiles, for each METHOD, the training loop of that arm of
``scripts/ood_method_comparison`` (batch 10 at 192^2, seed 1; the
numpy phantom draws and their copies to the card included) the same way:
two warm-up steps, K steps timed untraced, K more traced. Without
``--workload`` it profiles only the arms.

``--without-live-running-stats`` runs the AdvNoise/AdvBias steps without
``layers.live_running_stats``: their eval-mode consistency then normalizes
with the running statistics as constants, which is not the JAX step's
gradient. It exists only to price that repair against the step without it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import time
import warnings

import torch
from torch.profiler import ProfilerActivity, profile

from maxstyle_tpu_torch import train_step
from maxstyle_tpu_torch.flagship import WORKLOADS, make_raw_batches, workload_policy
from maxstyle_tpu_torch.train_step import make_multi_step

# symbol fragments of the port's kernels in the profiler's kernel names
PORT_KERNELS = {name: f"{name}_kernel" for name in
                ("maxstyle_stats", "maxstyle_apply", "maxstyle_bwd", "warp_bilinear_nearest",
                 "warp_cubic_nearest", "linear_gemm")}


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _device_total_us(evt) -> float:
    """An operator's device time with its children's (the kernels it ran)."""
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def is_sync_warning(w: warnings.WarningMessage) -> bool:
    """Whether a warning recorded under ``set_sync_debug_mode("warn")`` is a
    host sync, and not the note, given once a process when the mode is first
    set, that the mode is a prototype."""
    text = str(w.message)
    return "synchroniz" in text and "prototype feature" not in text


def host_syncs(fn) -> collections.Counter:
    """The host's waits for the device while ``fn()`` runs, by the Python
    line that caused each: the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                               if is_sync_warning(w))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", nargs="+", choices=sorted(WORKLOADS), default=None)
    ap.add_argument("--ood-arm", nargs="+", default=[], metavar="METHOD")
    ap.add_argument("--k-inner", type=int, default=4)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--without-live-running-stats", action="store_true")
    args = ap.parse_args()
    if args.without_live_running_stats:
        train_step.live_running_stats = lambda nets: contextlib.nullcontext()
        print("profile: without live running statistics (not the JAX step's gradient)")
    from maxstyle_tpu_torch.utils.gpulock import chip_lock
    with chip_lock("profile_slice"):
        for name in args.workload or ([] if args.ood_arm else ["headline"]):
            profile_workload(name, args.k_inner, args.top)
        for method in args.ood_arm:
            profile_ood_arm(method, args.k_inner, args.top)


def profile_ood_arm(method: str, steps: int, top: int) -> None:
    """One OOD arm's training loop: steps/s untraced, then traced."""
    import numpy as np

    from maxstyle_tpu_torch.flagship import config_solver
    from maxstyle_tpu_torch.scripts.ab_randconv_bn import train_steps
    from maxstyle_tpu_torch.scripts.ood_method_comparison import make_config
    hw, batch, seed = 192, 10, 1
    solver = config_solver(make_config(method, hw, batch), "cuda")
    state = solver.init_state(seed)
    data_rng = np.random.RandomState(seed + 1)
    gen = torch.Generator(device=solver.device).manual_seed(seed + 2)

    def run(n):
        nonlocal state
        state, metrics = train_steps(solver, state, n, data_rng, gen, batch, hw)
        torch.cuda.synchronize()
        return metrics

    run(2)
    t0 = time.perf_counter()
    run(steps)
    print(f"profile: ood_{method}: {steps / (time.perf_counter() - t0):.4f} steps/s over "
          f"{steps} untraced steps (batch {batch} @{hw}^2, phantom draws included)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = run(steps)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    float(metrics["loss/total"])
    report(f"ood_{method}", prof, wall_ms, steps, top)


def profile_workload(workload: str, k_inner: int, top: int) -> None:
    solver = WORKLOADS[workload](device="cuda")
    cfg = solver.config
    state = solver.init_state(0)
    policy = workload_policy(cfg)
    raw = make_raw_batches(k_inner, cfg.train_batch_size, policy.pad_hw[0], 1,
                           solver.device, num_classes=cfg.segmentation_model.num_classes)
    multi = make_multi_step(solver, policy,
                            keep_orig=cfg.data.keep_orig_image_label_pair_for_training,
                            n_inner=k_inner)
    gen = torch.Generator(device=solver.device).manual_seed(10)
    torch.cuda.reset_peak_memory_stats()
    state, _ = multi(state, raw, gen)
    torch.cuda.synchronize()

    def one_call():
        nonlocal state
        state, _ = multi(state, raw, gen)

    syncs = host_syncs(one_call)
    torch.cuda.synchronize()
    steps = k_inner
    call_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        one_call()
        torch.cuda.synchronize()
        call_ms.append(1e3 * (time.perf_counter() - t0))
    print(f"profile: {workload}: {1e3 * 2 * steps / sum(call_ms):.4f} steps/s over two "
          f"untraced calls of {steps} steps ({call_ms[0]:.3f} and {call_ms[1]:.3f} ms)")
    print(f"profile: {workload}: host syncs {sum(syncs.values()) / steps:.2f}/step "
          f"(set_sync_debug_mode warnings over one call of {steps} steps"
          f"{', at ' + str(dict(syncs)) if syncs else ''}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = multi(state, raw, gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    float(metrics["loss/total"])
    report(workload, prof, wall_ms, steps, top)


def report(workload: str, prof, wall_ms: float, steps: int, top: int) -> None:
    """Prints what a trace of ``steps`` steps over ``wall_ms`` shows."""
    # device-side events only: an operator's row repeats its kernels' time,
    # and so does a user range's on the device timeline (the optimizer's
    # "Optimizer.step#AdamW.step")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    print(f"profile: {workload} on {torch.cuda.get_device_name(0)}; "
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
    # dtype conversions (.to / .float(), forward and backward): the casts of
    # the bf16 policy around the convolutions, norms, style ops and losses
    casts = [e for e in prof.key_averages() if e.key == "aten::_to_copy"]
    print(f"profile: dtype casts (aten::_to_copy) {sum(e.count for e in casts) / steps:.1f} "
          f"calls/step, {sum(_device_total_us(e) for e in casts) / 1e3 / steps:.4f} "
          f"ms/step device")
    kernels.sort(key=_device_us, reverse=True)
    for e in kernels[:top]:
        print(f"profile: {_device_us(e) / 1e3 / steps:9.4f} ms/step "
              f"{e.count / steps:7.1f} calls/step  {e.key[:110]}")
    kernels.sort(key=lambda e: e.count, reverse=True)
    for e in kernels[:10]:
        print(f"profile: most launched {e.count / steps:7.1f} calls/step "
              f"{_device_us(e) / 1e3 / steps:9.4f} ms/step  {e.key[:110]}")
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in ops[:10]:
        print(f"profile: host {e.self_cpu_time_total / 1e3 / steps:9.4f} ms/step "
              f"{e.count / steps:7.1f} calls/step  {e.key[:110]}")


if __name__ == "__main__":
    main()
