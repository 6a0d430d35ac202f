"""Build and drive the PyTorch/CUDA port (maxstyle_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits nonzero:

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — the four CUDA kernels from maxstyle_tpu_torch/csrc/ (nvcc,
             sm_90a, one process per source, started together);
3. kernels — each kernel against its plain PyTorch version on the card at
             every main-path shape, with the stated tolerance, and the
             kernel's, the plain version's and (where one PyTorch call
             computes the same function) the library call's times;
4. reference — on a small input, the MaxStyle generation through the
             kernels against the plain autograd op, and the stylized and
             predicted outputs finite and of the expected shape;
5. slice   — the headline training step at full width (effective batch 20,
             224 -> 192, MaxStyle n_iter=5, K=4 steps a call): finite losses,
             launch counts of exactly 21/21/15/1 per step, and steps/s.

Before the last line it prints one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}. Without a GPU, or without
the package beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
K_INNER = 4
PER_STEP = {"maxstyle_stats": 21, "maxstyle_apply": 21, "maxstyle_bwd": 15,
            "warp_bilinear_nearest": 1}
# the style hooks of one decode at 192^2: hook 3 (16 ch @ 96^2), hook 4
# (16 ch @ 192^2), hook 5 (1 ch @ 192^2); effective batch 20
STYLE_SHAPES = ((20, 16, 96, 96), (20, 16, 192, 192), (20, 1, 192, 192))
WARP_SHAPE = (10, 224, 192)  # N, padded source side, crop side


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def bound_ms(nbytes: float, ops: float) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def cuda_ms(fn, n_buffers: int, iters: int = 20, reps: int = 5) -> float:
    """Median per-call device time of fn(i), by CUDA events around the
    replay of a CUDA graph of ``iters`` calls that cycle through
    ``n_buffers`` input copies (so inputs come from device memory, not L2).
    The graph keeps the host's launch cost out of the time: a single small
    launch from Python takes longer on the host than on the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_buffers)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_buffers)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    times.sort()
    return times[len(times) // 2]


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"device: {name}; count {torch.cuda.device_count()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"nvidia-smi: {card}")
    return name, card


def phase_build():
    from maxstyle_tpu_torch import kernels
    t0 = time.perf_counter()
    secs = kernels.build_all()
    for src, log in kernels.BUILD_LOG.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build {src}.cu: {'; '.join(regs)}")
    print(f"build: {len(kernels.SOURCES)} sources in {secs:.2f} s "
          f"(phase {time.perf_counter() - t0:.2f} s)")


def _style_case(shape, copies, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, c = shape[:2]
    xs = [torch.randn(shape, generator=g, device="cuda") * 2 + 1 for _ in range(copies)]
    gs = [torch.randn(shape, generator=g, device="cuda") for _ in range(copies)]
    scale = torch.randn((b, c), generator=g, device="cuda")
    shift = torch.randn((b, c), generator=g, device="cuda")
    return xs, gs, scale, shift


def phase_kernels():
    """Each kernel vs its plain version at every main-path shape."""
    import torch
    from maxstyle_tpu_torch.ops import maxstyle_kernels as mk
    from maxstyle_tpu_torch.ops import warp_kernels as wk

    def norm_err(k, p, ref_abs):
        return float(((k - p).abs() / ref_abs.clamp_min(1e-30)).max())

    rows = {name: {"name": name, "route": "cuda", "shapes": []} for name in PER_STEP}
    rows["maxstyle_stats"].update(source="maxstyle_tpu_torch/csrc/maxstyle.cu",
                                  replaces="maxstyle_tpu/ops/maxstyle_pallas.py:47")
    rows["maxstyle_apply"].update(source="maxstyle_tpu_torch/csrc/maxstyle.cu",
                                  replaces="maxstyle_tpu/ops/maxstyle_pallas.py:57")
    rows["maxstyle_bwd"].update(source="maxstyle_tpu_torch/csrc/maxstyle.cu",
                                replaces="maxstyle_tpu/ops/maxstyle_pallas.py:62")
    rows["warp_bilinear_nearest"].update(source="maxstyle_tpu_torch/csrc/warp.cu",
                                         replaces="maxstyle_tpu/ops/warp_pallas.py:46")
    ok = True
    for si, shape in enumerate(STYLE_SHAPES):
        n_el = math.prod(shape)
        b, c = shape[:2]
        copies = max(2, int(math.ceil(200e6 / (n_el * 4))))  # > 4x the 50 MB L2
        xs, gs, scale, shift = _style_case(shape, copies, seed=si)
        x, g = xs[0], gs[0]
        s4 = scale[:, :, None, None]
        t4 = shift[:, :, None, None]

        # stats: sum and sum of squares per plane; tolerance 1e-5 of sum|terms|
        k, p = mk.channel_sums(x), mk.channel_sums_plain(x)
        ref_abs = torch.stack([x.abs().sum((2, 3)), (x * x).sum((2, 3))], 1)
        err = norm_err(k, p, ref_abs)
        rows["maxstyle_stats"]["shapes"].append(dict(
            shape=list(shape), max_abs_err=float((k - p).abs().max()), rel_err=err,
            tol=1e-5, ms=cuda_ms(lambda i: mk.channel_sums(xs[i]), copies),
            plain_ms=cuda_ms(lambda i: mk.channel_sums_plain(xs[i]), copies),
            library_ms=cuda_ms(lambda i: torch.var_mean(xs[i], dim=(2, 3)), copies),
            bound_ms=bound_ms(n_el * 4 + b * 2 * c * 4, 3 * n_el)))
        ok &= err <= 1e-5

        # apply: out = x * scale + shift; tolerance 1e-6 of max|out|
        # (the kernel fuses the multiply-add, the plain version rounds twice)
        k, p = mk.plane_affine(x, scale, shift), mk.plane_affine_plain(x, scale, shift)
        err = float((k - p).abs().max() / p.abs().max())
        rows["maxstyle_apply"]["shapes"].append(dict(
            shape=list(shape), max_abs_err=float((k - p).abs().max()), rel_err=err,
            tol=1e-6, ms=cuda_ms(lambda i: mk.plane_affine(xs[i], scale, shift), copies),
            plain_ms=cuda_ms(lambda i: mk.plane_affine_plain(xs[i], scale, shift), copies),
            library_ms=cuda_ms(lambda i: torch.addcmul(t4, xs[i], s4), copies),
            bound_ms=bound_ms(2 * n_el * 4 + 2 * b * c * 4, 2 * n_el)))
        ok &= err <= 1e-6

        # bwd: dx = g * scale (exact), sums of g and g*x (1e-5 of sum|terms|)
        (dk, sk), (dp, sp) = mk.plane_affine_bwd(g, x, scale), mk.plane_affine_bwd_plain(g, x, scale)
        ref_abs = torch.stack([g.abs().sum((2, 3)), (g * x).abs().sum((2, 3))], 1)
        err = max(float((dk - dp).abs().max()), norm_err(sk, sp, ref_abs))
        rows["maxstyle_bwd"]["shapes"].append(dict(
            shape=list(shape),
            max_abs_err=max(float((dk - dp).abs().max()), float((sk - sp).abs().max())),
            rel_err=err, tol=1e-5,
            ms=cuda_ms(lambda i: mk.plane_affine_bwd(gs[i], xs[i], scale), copies),
            plain_ms=cuda_ms(lambda i: mk.plane_affine_bwd_plain(gs[i], xs[i], scale), copies),
            library_ms=None,
            bound_ms=bound_ms(3 * n_el * 4 + 3 * b * c * 4, 4 * n_el)))
        ok &= err <= 1e-5
        del xs, gs

    # warp: bit-exact (the kernel rounds each op as the plain version does)
    n, H, h = WARP_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    copies = 8
    imgs = [torch.rand((n, H, H), generator=gen, device="cuda") for _ in range(copies)]
    labs = [torch.randint(0, 4, (n, H, H), generator=gen, device="cuda", dtype=torch.int32)
            for _ in range(copies)]
    sys_ = [torch.rand((n, h, h), generator=gen, device="cuda") * (H + 4) - 2
            for _ in range(copies)]
    sxs = [torch.rand((n, h, h), generator=gen, device="cuda") * (H + 4) - 2
           for _ in range(copies)]
    ki, kl = wk.warp_bilinear_nearest(imgs[0], labs[0], sys_[0], sxs[0])
    pi, pl = wk.warp_bilinear_nearest_plain(imgs[0], labs[0], sys_[0], sxs[0])
    img_err = float((ki - pi).abs().max())
    lab_err = int((kl != pl).sum())
    px = n * h * h
    rows["warp_bilinear_nearest"]["shapes"].append(dict(
        shape=[n, H, H, h, h], max_abs_err=img_err, label_mismatches=lab_err, tol=0.0,
        ms=cuda_ms(lambda i: wk.warp_bilinear_nearest(imgs[i], labs[i], sys_[i], sxs[i]),
                   copies),
        plain_ms=cuda_ms(lambda i: wk.warp_bilinear_nearest_plain(imgs[i], labs[i], sys_[i],
                                                                   sxs[i]), copies),
        library_ms=None,
        bound_ms=bound_ms(n * H * H * 8 + px * 8 + px * 8, 20 * px)))
    ok &= img_err == 0.0 and lab_err == 0

    for row in rows.values():
        for s in row["shapes"]:
            print(f"kernel {row['name']} {s['shape']}: max abs err {s['max_abs_err']:.3e}, "
                  f"checked err {s.get('rel_err', s['max_abs_err']):.3e} (tol {s['tol']}) "
                  f"ms {s['ms']:.5f} plain {s['plain_ms']:.5f} "
                  f"library {s['library_ms']} bound {s['bound_ms']:.5f}")
    if not ok:
        fail("a kernel disagrees with its plain version")
    return rows


def phase_reference():
    """Small input (batch 4 at 64^2), on the card: one styled decode and the
    inner loss's gradients with respect to the style tensors, through the
    kernels and through the plain autograd op (ops/maxstyle.py), from the
    same weights and draws; then a full generation and a prediction, which
    must be finite and of the expected shape."""
    import torch
    from maxstyle_tpu_torch import losses
    from maxstyle_tpu_torch.flagship import flagship_solver
    from maxstyle_tpu_torch.ops import maxstyle as ms
    from maxstyle_tpu_torch.ops.maxstyle_kernels import apply_maxstyle_kernels

    solver = flagship_solver(hw=64, batch=4, device="cuda")
    nets = solver.init_state(seed=3).modules
    cfg = solver.config.max_style
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.rand((4, 1, 64, 64), generator=gen, device="cuda")
    label = torch.randint(0, 4, (4, 64, 64), generator=gen, device="cuda")
    with torch.no_grad():
        z_i, _ = solver.encode_image(nets, x, mode="frozen")
    sp, st = {}, {}
    for idx, c in zip((3, 4, 5), (16, 16, 1)):
        sp[idx], st[idx] = ms.init_maxstyle(gen, 4, c, cfg)
        st[idx].gate = torch.ones((), device="cuda")

    results = {}
    for name, op in (("kernels", apply_maxstyle_kernels), ("plain", ms.apply_maxstyle)):
        live = {idx: ms.MaxStyleParams(*(t.clone().requires_grad_(True)
                                         for t in sp[idx].tensors())) for idx in sp}
        fns = {idx: (lambda v, idx=idx: op(v, live[idx], st[idx], cfg)[0]) for idx in live}
        recon = solver.decode(nets, "image_decoder", z_i, mode="frozen", style_fns=fns)
        _, z_s = solver.encode_image(nets, recon, mode="frozen")
        pred = solver.decode(nets, "segmentation_decoder", z_s, mode="frozen")
        loss = -losses.cross_entropy_2d(pred, label)
        grads = torch.autograd.grad(loss, [t for idx in live for t in live[idx].tensors()])
        results[name] = (recon.detach(), grads)
    recon_err = float((results["kernels"][0] - results["plain"][0]).abs().max())
    grad_ok = all(bool(((gk - gp).abs() <= 2e-3 * gp.abs() + 2e-4 * gp.abs().max().clamp_min(1))
                       .all()) for gk, gp in zip(results["kernels"][1], results["plain"][1]))
    grad_err = max(float((gk - gp).abs().max())
                   for gk, gp in zip(results["kernels"][1], results["plain"][1]))

    stylized = solver.generate_max_style_image(nets, z_i, reference_segmentation=label,
                                               ms_cfg=cfg, generator=gen)
    pred = solver.predict(nets, x.permute(0, 2, 3, 1), softmax=True)
    print(f"reference: styled decode kernels vs plain op max err {recon_err:.3e} (tol 1e-4); "
          f"style grads max err {grad_err:.3e} (rtol 2e-3) ok={grad_ok}; "
          f"generation {tuple(stylized.shape)}, predict {tuple(pred.shape)}")
    if recon_err > 1e-4 or not grad_ok:
        fail("the kernels' MaxStyle op disagrees with the plain autograd op")
    if not (torch.isfinite(stylized).all() and torch.isfinite(pred).all()):
        fail("non-finite stylized image or prediction")
    if stylized.shape != (4, 1, 64, 64) or pred.shape != (4, 64, 64, 4):
        fail("unexpected output shapes")


def phase_slice(card: str):
    import torch
    from maxstyle_tpu_torch import kernels
    from maxstyle_tpu_torch.flagship import flagship_solver, measure_throughput

    solver = flagship_solver(hw=192, batch=20, device="cuda")
    kernels.reset_launches()
    t0 = time.perf_counter()
    rate, state, metrics = measure_throughput(solver, half_batch=10, pad=224, crop=192,
                                              k_inner=K_INNER, n_calls=2, n_repeats=3)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    steps = state.step
    last = {k: float(v) for k, v in metrics.items()}
    print(f"slice: metrics of the last call (mean of {K_INNER} steps) {json.dumps(last)}")
    print(f"slice: launches over {steps} steps {json.dumps(launches)}")
    print(f"slice: {rate:.4f} steps/s (median of 3 rounds of 2 calls x {K_INNER} steps, "
          f"effective batch 20 @192^2, float32) on {card}; "
          f"phase {time.perf_counter() - t0:.1f} s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if steps != K_INNER * (1 + 2 * 3):
        fail(f"the slice ran {steps} steps, expected {K_INNER * 7}")
    if not all(math.isfinite(v) for v in last.values()):
        fail("non-finite loss in the training slice")
    for name, per in PER_STEP.items():
        if launches[name] != per * steps:
            fail(f"{name}: {launches[name]} launches over {steps} steps, "
                 f"expected {per} per step")
    return launches, rate


def main():
    try:
        import torch
        import maxstyle_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable beside this script: {e}")
    name, card = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_reference()
    launches, _ = phase_slice(card)

    out = []
    for kname, row in rows.items():
        shapes = row.pop("shapes")

        def total(key):
            vals = [s[key] for s in shapes]
            return None if any(v is None for v in vals) else sum(vals)

        out.append({**row, "launches": launches[kname],
                    "max_abs_err": max(s["max_abs_err"] for s in shapes),
                    "ms": total("ms"), "plain_ms": total("plain_ms"),
                    "bound_ms": total("bound_ms"), "bound_by": "bytes",
                    "library_ms": total("library_ms"), "shapes": shapes})
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
