"""One run of one cell: set-up, the measured window, the traced stretches
and the check of the program's first steps against the reference.

The loop is ``train.train_network``'s for each step, less validation, the
logger's drain and checkpoints: ``HostBatchLoader`` over the slice pool,
reshuffled every epoch, behind ``prefetch(depth, transform=train.to_device)``
restarted at every epoch, and ``make_fused_train_step``'s step with one
generator. Set-up builds the solver and its state from the benchmark's
weights, runs the first ``check_steps`` steps through that same feed and
call with the benchmark's draws (``overrides``), records what the check
compares, warms up ``warmup_steps`` more, and hands the same state to the
window. After the window an untraced run profiles ``device_steps`` steps
more for the device's busy time, and a traced run traces its stretches.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Dict, List

import torch

from perfbench import check, inputs
from perfbench.manifest import Cell
from perfbench.reference import nets as N
from perfbench.reference import step as R

# The check's reference runs in float64, so that a gap is the program's own
# round-off and not the sum of two float32 programs' (PERF.md, section 2).
REFERENCE_DTYPE = torch.float64


class Program:
    """The system under test, built from the cell: the solver, its state from
    the given weights, the fused step and the epoch-restarting feed."""

    def __init__(self, cell: Cell, seed: int, weights: Dict[str, torch.Tensor], device):
        from maxstyle_tpu_torch.config import ExperimentConfig
        from maxstyle_tpu_torch.data import augment as A
        from maxstyle_tpu_torch.data.datasets import HostBatchLoader
        from maxstyle_tpu_torch.flagship import config_solver
        from maxstyle_tpu_torch.train_step import make_fused_train_step

        self.cfg = ExperimentConfig.from_dict(cell.experiment())
        d = self.cfg.data
        self.solver = config_solver(self.cfg, device)
        self.device = self.solver.device
        self.policy = A.get_policy(d.data_aug_policy, tuple(d.pad_size[:2]),
                                   tuple(d.crop_size[:2]), image_interp=d.image_interp)
        self.state = self.solver.init_state(0, state_dicts=inputs.by_module(weights))
        self.step = make_fused_train_step(self.solver, self.policy,
                                          d.keep_orig_image_label_pair_for_training)
        self.pool = inputs.SlicePool(seed, cell.traffic["pool_slices"], d.pad_size[0])
        self.loader = HostBatchLoader(self.pool, self.cfg.train_batch_size,
                                      seed=inputs.stream_seed(seed, "loader") % 2 ** 32)
        self.depth = cell.traffic["loader_depth"]
        self.generator = inputs.generator(seed, "step", device=self.device)
        self._feed = self._epochs()

    def _epochs(self):
        from maxstyle_tpu_torch.data.prefetch import prefetch
        from maxstyle_tpu_torch.train import to_device
        while True:
            for raw in prefetch(self.loader, depth=self.depth,
                                transform=lambda r: to_device(r, self.device)):
                yield raw

    def next_batch(self):
        return next(self._feed)

    def close(self):
        self._feed.close()

    def leaves(self) -> Dict[str, torch.nn.Parameter]:
        return {f"{mod}.{name}": p for mod, module in self.state.modules.items()
                for name, p in module.named_parameters()}

    def first_gradient_norms(self) -> Dict[str, float]:
        """Each leaf's gradient as AdamW holds it after one step: the first
        moment over (1 - beta1)."""
        out = {}
        for mod, opt in self.state.optimizers.items():
            beta1 = opt.param_groups[0]["betas"][0]
            for name, p in self.state.modules[mod].named_parameters():
                st = opt.state.get(p, {})
                out[f"{mod}.{name}"] = (float(st["exp_avg"].norm()) / (1 - beta1)
                                        if "exp_avg" in st else float("nan"))
        return out

    def style_init(self, draws):
        from maxstyle_tpu_torch.ops.maxstyle import MaxStyleParams, MaxStyleState
        params, states = {}, {}
        for h, (p, s) in draws.items():
            c = p["gamma_noise"].shape[1]
            nan = torch.full((1, c, 1, 1), float("nan"), device=self.device)
            params[h] = MaxStyleParams(p["lmda"].clone(), p["gamma_noise"].clone(),
                                       p["beta_noise"].clone())
            states[h] = MaxStyleState(s["perm"].clone(), s["gate"].clone(), nan, nan.clone())
        return params, states


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def count_flops(cell: Cell) -> float:
    """Floating-point operations of one step's convolutions and matrix
    products, counted by ``FlopCounterMode`` over the reference's passes on
    ``meta`` tensors of the cell's shapes."""
    from torch.utils.flop_counter import FlopCounterMode
    exp = cell.experiment()
    net = cell.net()
    crop = exp["data"]["crop_size"][0]
    specs = N.param_specs(net, crop)
    with FlopCounterMode(display=False) as counter:
        R.flop_step(net, specs, cell.job(), exp["learning"]["batch_size"], crop)
    return float(counter.get_total_flops())


def prepare(cell: Cell, seed: int, device, tf32: bool = False):
    """Set-up up to the warm-up: the program from the benchmark's weights,
    then the checked steps through its feed and call with the benchmark's
    draws. Returns (program, what the check needs of its steps).
    ``tf32`` turns TF32 on for the checked steps (a control of the
    calibration: the program one precision below its configuration)."""
    exp = cell.experiment()
    net = cell.net()
    specs = N.param_specs(net, exp["data"]["crop_size"][0])
    weights = inputs.make_weights(specs, seed, device)
    prog = Program(cell, seed, weights, device)
    del weights
    record = {"loss": [], "std_loss": [], "std_parts": [], "raw": [], "draws": [], "specs": specs, "net": net}
    policy = _float32_policy(tf32=True) if tf32 else contextlib.nullcontext()
    with policy:
        _checked_steps(cell, seed, prog, record)
    start = inputs.make_weights(specs, seed, prog.device)
    record["change_norm"] = {name: float((p.detach() - start[name]).norm())
                             for name, p in prog.leaves().items()}
    return prog, record


def _checked_steps(cell: Cell, seed: int, prog: Program, record: dict) -> None:
    exp = cell.experiment()
    crop = exp["data"]["crop_size"][0]
    pad = exp["data"]["pad_size"][0]
    dev = prog.device
    job = cell.job()
    n_raw = prog.cfg.train_batch_size
    batch = exp["learning"]["batch_size"]
    for k in range(cell.traffic["check_steps"]):
        raw = prog.next_batch()
        aug = inputs.draw_aug(inputs.generator(seed, "aug", k, device=dev),
                              cell.config["augmentation"], n_raw, (pad, pad), (crop, crop))
        style = (inputs.draw_style(inputs.generator(seed, "style", k, device=dev), batch,
                                   job["max_style"]) if job["max_style"] else None)
        ov = {"aug_draws": {key: t.clone() for key, t in aug.items()}}
        if style is not None:
            ov["style_init"] = prog.style_init(style)
        noise_gen = inputs.generator(seed, "noise", k, device=dev)
        prog.state, metrics = prog.step(prog.state, raw, noise_gen, ov)
        record["loss"].append(float(metrics["loss/total"]))
        record["std_loss"].append(float(metrics["loss/standard/total"]))
        record["std_parts"].append([float(metrics["loss/standard/seg"]),
                                    float(metrics["loss/standard/image"])])
        record["raw"].append(raw)
        record["draws"].append((aug, style))
        if k == 0:
            record["grad_norm"] = prog.first_gradient_norms()


def readings(record: dict) -> dict:
    return {k: record[k] for k in ("loss", "std_loss", "std_parts", "grad_norm", "change_norm")}


def free(prog: Program) -> None:
    """Close the feed and let the program's state go."""
    dev = prog.device
    prog.close()
    prog.state = prog.step = prog.solver = None
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run: returns what the metric readers and the result line need."""
    exp = cell.experiment()
    tr = cell.traffic
    flops = count_flops(cell)
    prog, record = prepare(cell, seed, device)
    dev = prog.device
    for _ in range(tr["warmup_steps"]):
        prog.state, _ = prog.step(prog.state, prog.next_batch(), prog.generator)
    sync(dev)

    run = {"cell": cell, "flops_per_step": flops,
           "slices_per_step": exp["learning"]["batch_size"],
           "n_raw": prog.cfg.train_batch_size, "pad": exp["data"]["pad_size"][0],
           "crop": exp["data"]["crop_size"][0]}
    run["window"] = window(prog, seconds, dev)
    run["setup_s"] = run["window"].pop("t_start") - t0
    if not trace and torch.device(dev).type == "cuda":
        run["device_stretch"] = device_stretch(prog, tr["device_steps"], dev)
    if trace:
        run["trace"] = traced_stretch(prog, tr["trace_steps"], dev)
        run["host_syncs"] = host_sync_stretch(prog, tr["sync_steps"], dev)
    pool = prog.pool
    free(prog)
    del prog
    run["check"] = reference_check(cell, seed, record, pool, dev)
    return run


def window(prog: Program, seconds: float, dev) -> dict:
    """The measured window: steps until ``seconds`` have passed on the host,
    then a synchronize. Step times from CUDA events recorded on the stream
    at each step boundary, read afterwards."""
    cuda = torch.device(dev).type == "cuda"
    losses, marks, wait = [], [], 0.0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    t_start = time.perf_counter()
    host_marks = [t_start]
    while True:
        tw = time.perf_counter()
        raw = prog.next_batch()
        wait += time.perf_counter() - tw
        prog.state, metrics = prog.step(prog.state, raw, prog.generator)
        losses.append(metrics["loss/total"])
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            host_marks.append(time.perf_counter())
        if time.perf_counter() - t_start >= seconds:
            break
    sync(dev)
    t_end = time.perf_counter()
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        peak = torch.cuda.max_memory_allocated()
    else:
        step_ms = [1e3 * (b - a) for a, b in zip(host_marks, host_marks[1:])]
        peak = 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return {"t_start": t_start, "seconds": t_end - t_start, "steps": len(step_ms),
            "step_ms": step_ms, "loader_wait_s": wait, "peak_bytes": peak, "failed": failed}


def device_stretch(prog: Program, steps: int, dev) -> dict:
    """``steps`` steps just after the window under ``torch.profiler``
    recording the device alone: the union of the intervals in which a
    kernel, a copy or a fill ran on the card. The profiler slows the host's
    side of a step, and a host that stands still leaves the card idle, not
    busy, so the busy time is the step's work on the card whatever the
    host's load."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench.trace import merge
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            prog.state, _ = prog.step(prog.state, prog.next_batch(), prog.generator)
        sync(dev)
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA
             and not e.is_user_annotation() and e.duration_ns() > 0]
    busy_ns = sum(t - s for s, t in merge(spans))
    return {"steps": steps, "busy_s": busy_ns * 1e-9, "events": len(spans)}


def traced_stretch(prog: Program, steps: int, dev) -> dict:
    """``steps`` steps under ``torch.profiler``, after one profiled step
    that is not counted; reduced by ``trace.reduce_events`` over the span of
    a marker range that ends after a synchronize, user annotations left
    out, and under ``"spans"`` by ``spans.reduce_spans`` over the same
    range with them (the program's phases)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench.spans import MARKER, reduce_spans
    from perfbench.trace import reduce_events
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prog.state, _ = prog.step(prog.state, prog.next_batch(), prog.generator)
        sync(dev)
        t_a = time.perf_counter()
        with record_function(MARKER):
            for _ in range(steps):
                prog.state, _ = prog.step(prog.state, prog.next_batch(), prog.generator)
            sync(dev)
        t_b = time.perf_counter()
    events = prof.events()
    marker = [e for e in events if e.name == MARKER
              and e.device_type == torch.autograd.DeviceType.CPU]
    lo, hi = (float(marker[0].time_range.start), float(marker[0].time_range.end)) \
        if marker else (-math.inf, math.inf)
    inside = [e for e in events if e.name != MARKER
              and float(e.time_range.start) >= lo and float(e.time_range.end) <= hi]
    window_s = (hi - lo) * 1e-6 if marker else t_b - t_a
    out = reduce_events([e for e in inside if not getattr(e, "is_user_annotation", False)],
                        window_s, steps)
    out["spans"] = reduce_spans(inside, steps)
    return out


def host_sync_stretch(prog: Program, steps: int, dev) -> dict:
    from perfbench.trace import count_host_syncs

    def run():
        for _ in range(steps):
            prog.state, _ = prog.step(prog.state, prog.next_batch(), prog.generator)
        sync(dev)

    n, where = count_host_syncs(run)
    return {"syncs": n, "steps": steps, "where": where}


def reference_steps(cell: Cell, seed: int, record: dict, pool, dev):
    """The checked steps as the reference takes them: the pool's own copy of
    each slice the feed delivered (found by its bytes), the same draws and
    the noise drawn again from the same stream. Raises ValueError when the
    feed delivered a slice that is not the pool's, or one twice."""
    exp = cell.experiment()
    crop = exp["data"]["crop_size"][0]
    steps, seen = [], []
    for k, (raw, (aug, style)) in enumerate(zip(record["raw"], record["draws"])):
        images = raw["image"].cpu().numpy()
        labels = raw["label"].cpu().numpy()
        idx = [pool.index_of(im) for im in images]
        if min(idx) < 0 or any((pool.labels[i] != lab).any() for i, lab in zip(idx, labels)):
            raise ValueError(f"step {k}: the feed delivered a slice that is not the pool's")
        seen += idx
        steps.append({"image": torch.from_numpy(pool.images[idx]).to(dev),
                      "label": torch.from_numpy(pool.labels[idx]).long().to(dev),
                      "aug_draws": aug, "style_init": style,
                      "noise": torch.randn((exp["learning"]["batch_size"], 1, crop, crop),
                                           generator=inputs.generator(seed, "noise", k,
                                                                      device=dev),
                                           device=dev)})
    if len(set(seen)) != len(seen):
        raise ValueError("the checked steps repeat a slice")
    return steps


def reference_check(cell: Cell, seed: int, record: dict, pool, dev) -> dict:
    """The compared numbers of the program's checked steps against the
    reference's, or why none could be had."""
    try:
        steps = reference_steps(cell, seed, record, pool, dev)
        ref = reference_readings(cell, seed, record, steps, dev, dtype=REFERENCE_DTYPE)
        return {"numbers": check.gaps(readings(record), ref)}
    except ValueError as e:
        return {"error": str(e)}


def reference_readings(cell: Cell, seed: int, record: dict, steps, dev, dtype=torch.float32,
                       half_batch: bool = False) -> dict:
    """The reference's losses, first gradient norms and change norms over
    ``steps`` from the benchmark's weights. ``dtype`` float64 is the
    check's reference (weights and AdamW in float64 too); "tf32" runs it in
    float32 with TF32 on, another torch dtype in that dtype (controls);
    ``half_batch`` leaves out half of each batch (a fault)."""
    exp = cell.experiment()
    crop = exp["data"]["crop_size"][0]
    pad = exp["data"]["pad_size"][0]
    tensors = inputs.make_weights(record["specs"], seed, dev)
    if dtype == torch.float64:
        tensors = {k: t.double() for k, t in tensors.items()}
    start = {k: t.clone() for k, t in tensors.items()}
    with _float32_policy(tf32=dtype == "tf32"):
        out = R.train_steps(record["net"], tensors, steps, cell.job(),
                            cell.config["augmentation"], (pad, pad), (crop, crop),
                            dtype=torch.float32 if dtype == "tf32" else dtype,
                            half_batch=half_batch)
    out["change_norm"] = {k: float((p - start[k]).norm()) for k, p in out["params"].items()}
    del out["params"], tensors, start
    return out


class _float32_policy:
    """The reference's float32: TF32 off for convolutions and matrix
    products (on for the TF32 control); the flags are restored after."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


