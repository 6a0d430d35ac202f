"""Build and drive the PyTorch/CUDA port (maxstyle_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits nonzero:

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — every CUDA source of maxstyle_tpu_torch/csrc/ (nvcc, sm_90a,
             one process per source, started together);
3. kernels — each kernel against its plain PyTorch version on the card at
             every main-path shape, with the stated tolerance, and the
             kernel's, the plain version's and (where one PyTorch call
             computes the same function) the library call's times: the
             MaxStyle kernels at the hook shapes of both training cells
             (stats and bwd also at five ragged shapes, and twice on one
             input, bit for bit; beside them the launch floor, the time of
             fill_ on a one-element tensor; the style map, whose kernel folds
             its own coefficients, bit-equal in scale and shift and over two
             calls, also over every branch of the map), the bilinear warp
             (N=10, 224 -> 192; its composed entry, the main path's, bit
             for bit at the policy's draws with the elastic gate on and
             off, with no elastic branch and at a matrix across both rims,
             timed beside the parent's route as its library time; also at
             the Prostate branch paths' N=10, 288 -> 224), the
             spline prefilter's matrix form against its recursion and the
             cubic warp (N=10, 288 -> 224), both warps' coordinate entries
             bit for bit at the policy's, uniform and rim-straddling
             coordinates, and conv3x3_bn_stats at its bench's three shapes
             (timed) and at ragged shapes that reach every masked edge;
4. reference — on a small input, the MaxStyle generation through the
             kernels against the plain autograd op, and the stylized and
             predicted outputs finite and of the expected shape;
5. slice   — the headline training step at full width (effective batch 20,
             224 -> 192, MaxStyle n_iter=5, K=4 steps a call): finite losses,
             launch counts of exactly 21/21/15/1 per step (stats, apply, bwd,
             bilinear warp), and steps/s;
6. slice_prostate_cubic — the Prostate MaxStyle config with the cubic warp
             at full width (effective batch 20, 288 -> 224, 2 classes,
             n_iter=5, K=4): finite losses, launches of exactly 21/21/15 per
             step and 1 cubic warp, 0 bilinear, and steps/s;
7. conv_bn_fusion — the entry point ``python3 -m
             maxstyle_tpu_torch.proto_conv_bn_fusion``: its ``--check``
             and its bench, which must launch the fused kernel;
8. slice_<branch config> — each method-branch config as shipped, at full
             width (flagship.WORKLOADS: the seven Prostate baselines,
             effective batch 20 at 288 -> 224, 2 classes, and ACDC LSM at
             224 -> 192, 4 classes), one warm-up call and one timed round
             of 2 calls of K=4 steps: finite losses, a non-zero branch
             channel, exactly 1 bilinear warp and 0 other kernel launches
             per step, steps/s and peak memory;
9. train_cli — the training CLI as a user runs it (``train.main``) on a
             synthetic ACDC tree written from a numpy seed into a temporary
             directory under build/: the 15 patients of
             acdc_split("10", 0), frames ES and ED, 10 slices of 256x216 at
             spacing (1.5625, 1.5625, 10) with 4-class concentric labels, and
             an OOD suite ACDC/{pid}/img.nii.gz of 5 patients. The config is
             configs/ACDC/1500_epoch/MICCAI2022_MaxStyle.json with only
             root_dir and n_epochs (2) changed: effective batch 20, 224 ->
             192, MaxStyle n_iter=5, AdamW, 20 steps an epoch, with --seed 1
             --auto_test. Checked: the run directory, the event file, the
             scalars JSON with finite validation mIoU, model/best and
             model/epoch_0, dataset_summary.csv; launches of exactly 21/21/15
             MaxStyle and 1 bilinear warp a step plus 1 warp a validation
             batch, none in the evaluation; best reloaded into a fresh
             solver predicts bit-equal to the state it was saved from; the
             inference CLI writes every output and launches nothing. Printed
             beside the card's name and power limit: the second epoch's
             steps/s and host syncs a step against measure_throughput's and
             the flagship step's on the same config in the same process;
             more host syncs a step than the flagship step fails.
10. device_resident — the same config trained from the tree's training
             split held on the card (``data/device_data.py``): the slices
             uploaded once, one warm-up call, one call counting the host
             syncs and 3 timed calls without instrumentation, of K=4 steps
             each of make_device_train_loop, each step drawing its slices on
             the card. Checked: exactly 21/21/15 MaxStyle and 1 bilinear warp
             launches a step, finite losses, every parameter tensor
             changed, no more host syncs a step than the flagship step's.
             Printed: steps/s beside train_cli's measure_throughput, the
             resident bytes and the peak memory.
11. reference_import — seeded state dicts in the reference's naming at
             the headline widths (image_encoder, segmentation_decoder with
             NN up, image_decoder with Conv2 up) saved as .pth files, then:
             train.main --torch_ckpt_dir for 1 epoch (the weights before its
             first step equal the files' tensors bit for bit, the transposed
             convs unflipped; 21/21/15/1 launches a step and 1 warp a
             validation batch); infer.main --torch_ckpt_dir (no launch);
             demo_generate_styles --n_iter 5 at 192^2, 8 samples (21/21/15
             launches in each of its 2 generation calls, the PNG decodes);
             artefacts.main (numpy, on the host) on the OOD suite and
             evaluate(save_top_k=2) on its RandomMotion copy (4 panels that
             decode, the two CSV files, no launch).

The tree of phases 9-11 is written once under build/ and deleted at the
end. Each of the phases from 5 on is a path: every launch count is set to 0 just
before it and read just after. Before the last line it prints one JSON object with
every kernel's numbers; the last line is {"ok": true, "device": {...}}.
Without a GPU, or without the package beside it, it exits nonzero and prints
no result.
"""

from __future__ import annotations

import json
import math
import re
import sys
import time

K_INNER = 4
KERNELS = ("maxstyle_stats", "maxstyle_apply", "maxstyle_bwd", "warp_bilinear_nearest",
           "warp_cubic_nearest", "conv3x3_bn_stats")
# launches per step of each training path; every other kernel launches 0 times
PER_STEP = {
    "slice": {"maxstyle_stats": 21, "maxstyle_apply": 21, "maxstyle_bwd": 15,
              "warp_bilinear_nearest": 1},
    "slice_prostate_cubic": {"maxstyle_stats": 21, "maxstyle_apply": 21, "maxstyle_bwd": 15,
                             "warp_cubic_nearest": 1},
}
# the method-branch paths: (flagship workload, the branch's loss channel)
BRANCH_PATHS = {
    "slice_prostate_mixstyle": ("prostate_mixstyle", "loss/hard/mix_style"),
    "slice_prostate_dsu": ("prostate_dsu", "loss/hard/DSU"),
    "slice_prostate_lsm": ("prostate_lsm", "loss/hard/total"),
    "slice_prostate_rsc": ("prostate_rsc", "loss/hard/RSC"),
    "slice_prostate_randconv": ("prostate_randconv", "loss/hard/rand_conv"),
    "slice_prostate_adv_noise": ("prostate_adv_noise", "loss/hard/adv_noise"),
    "slice_prostate_adv_bias": ("prostate_adv_bias", "loss/hard/adv_bias"),
    "slice_acdc_lsm": ("acdc_lsm", "loss/hard/total"),
}
PER_STEP.update({path: {"warp_bilinear_nearest": 1} for path in BRANCH_PATHS})
# the train_cli phase: the shipped config, the changes made to it, and the
# synthetic ACDC tree (slices a volume, slice height and width, spacing)
TRAIN_CLI_CONFIG = "configs/ACDC/1500_epoch/MICCAI2022_MaxStyle.json"
TRAIN_CLI_CHANGES = {"learning": {"n_epochs": 2}}
ACDC_TREE = {"slices": 10, "hw": (256, 216), "spacing": (1.5625, 1.5625, 10.0),
             "ood_patients": 5}
# launches a step of the CLI's training step, and of a validation batch
PER_STEP["train_cli"] = PER_STEP["slice"]
PER_VAL_BATCH = {"warp_bilinear_nearest": 1}
# the device-resident loop runs the CLI's step; a MaxStyle generation call
# (the style demo's) launches a step's MaxStyle kernels and no warp
PER_STEP["device_resident"] = PER_STEP["slice"]
PER_GENERATION = {"maxstyle_stats": 21, "maxstyle_apply": 21, "maxstyle_bwd": 15}
# the reference_import phase trains the train_cli config for one epoch
REFERENCE_IMPORT_CHANGES = {"learning": {"n_epochs": 1}}
# which path's run each kernel's "launches" is read from
LAUNCH_PATH = {"maxstyle_stats": "slice", "maxstyle_apply": "slice", "maxstyle_bwd": "slice",
               "warp_bilinear_nearest": "slice", "warp_cubic_nearest": "slice_prostate_cubic",
               "conv3x3_bn_stats": "conv_bn_fusion"}
# stats and bwd are also checked at ragged shapes: hw % 4 != 0, hw = 1, a
# plane that is not a whole number of float4 steps, and two that split over
# a cluster with a short last rank (on 132 SMs: 130^2 into 8 ranks of 2116
# values and a last of 2088 on the float4 path; 101^2 into 4 ranks of 2552
# and a last of 2545 on the scalar path)
# the bilinear warp of the Prostate branch paths: N=10, 288 -> 224
BRANCH_WARP_SHAPE = (10, 288, 224)
STYLE_RAGGED = ((3, 5, 7, 9), (2, 1, 1, 1), (4, 3, 33, 31), (2, 1, 130, 130), (1, 1, 101, 101))

SOURCES = {
    "maxstyle_stats": ("maxstyle_tpu_torch/csrc/maxstyle.cu",
                       "maxstyle_tpu/ops/maxstyle_pallas.py:47"),
    "maxstyle_apply": ("maxstyle_tpu_torch/csrc/maxstyle.cu",
                       "maxstyle_tpu/ops/maxstyle_pallas.py:57"),
    "maxstyle_bwd": ("maxstyle_tpu_torch/csrc/maxstyle.cu",
                     "maxstyle_tpu/ops/maxstyle_pallas.py:62"),
    "warp_bilinear_nearest": ("maxstyle_tpu_torch/csrc/warp.cu",
                              "maxstyle_tpu/ops/warp_pallas.py:46"),
    "warp_cubic_nearest": ("maxstyle_tpu_torch/csrc/warp_cubic.cu",
                           "maxstyle_tpu/ops/warp_pallas.py:184"),
    "conv3x3_bn_stats": ("maxstyle_tpu_torch/csrc/conv_bn_stats.cu",
                         "scripts/proto_conv_bn_fusion.py:41"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke needs a GPU")
    from maxstyle_tpu_torch.flagship import set_float32_policy
    from maxstyle_tpu_torch.timing import card
    name = torch.cuda.get_device_name(0)
    smi = card()
    print(f"device: {name}; count {torch.cuda.device_count()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    set_float32_policy(torch.device("cuda"))
    return name, smi


def _ptxas_report(log: str):
    """(kernel, registers line, spills line) for each entry function in an
    nvcc -Xptxas -v log; a conv kernel is named by its Cfg<N, MT, WG>, a bwd
    kernel by its <threads, evict-first stores>, an apply kernel by its
    vector type."""
    out, name, spills = [], "?", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cfg = re.search(r"CfgILi(\d+)ELi(\d+)ELi(\d+)E", ln)
            kern = re.search(r"(\w+?_kernel)", ln)
            targs = re.search(r"_kernelILi(\d+)ELb([01])E", ln)
            name = (f"Cfg<{', '.join(cfg.groups())}>" if cfg else
                    re.sub(r"^_Z\d+", "", kern.group(1)) if kern else ln.split("'")[1][:40])
            vec = re.search(r"_kernelI(6float4|f)E", ln)
            if targs and not cfg:
                name += f"<{targs.group(1)}, {targs.group(2)}>"
            elif vec:
                name += "<float4>" if vec.group(1) == "6float4" else "<float>"
        elif "spill" in ln:
            spills = ln.strip()
        elif "Used" in ln and "registers" in ln:
            out.append((name, ln.split(":", 1)[1].strip(), spills))
    return out


def phase_build():
    from maxstyle_tpu_torch import kernels
    t0 = time.perf_counter()
    secs = kernels.build_all()
    for src, log in kernels.BUILD_LOG.items():
        for name, regs, spills in _ptxas_report(log):
            print(f"build {src}.cu {name}: {regs}; {spills}")
    print(f"build: {len(kernels.SOURCES)} sources in {secs:.2f} s "
          f"(phase {time.perf_counter() - t0:.2f} s)")


def _roof(nbytes, ops):
    """bound_ms and bound_by of float32 work: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    from maxstyle_tpu_torch.timing import bound_by, bound_ms
    return {"bound_ms": bound_ms(nbytes, ops), "bound_by": bound_by(nbytes, ops)}


def _row_bound_by(shapes):
    """The term that sets most of a row's summed bound."""
    share = {}
    for s in shapes:
        share[s["bound_by"]] = share.get(s["bound_by"], 0.0) + s["bound_ms"]
    return max(share, key=share.get)


def _stats_err(k, p):
    """Largest relative difference of the kernel's (mu, sig) from the plain
    version's."""
    return max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max()) for a, b in zip(k, p))


def _bwd_err(k, p, g, x):
    """(largest difference, checked error): dx exact, the sums relative to
    the sums of |terms|."""
    import torch
    (dk, sk), (dp, sp) = k, p
    ref_abs = torch.stack([g.abs().sum((2, 3)), (g * x).abs().sum((2, 3))], 1)
    dx_err = float((dk - dp).abs().max())
    return (max(dx_err, float((sk - sp).abs().max())),
            max(dx_err, float(((sk - sp).abs() / ref_abs.clamp_min(1e-30)).max())))


def _bit_equal(a, b):
    import torch
    return all(torch.equal(u, v) for u, v in zip(a, b))


def _style_inputs(shape, gen, gate, spread_rows, lmda_lo=0.0, lmda_hi=1.0):
    """The style inputs of style_apply after x, for x of ``shape``: lmda
    uniform in [lmda_lo, lmda_hi), noise N(0, 1), the moments of a random
    input, a never-identity permutation, spreads of ``spread_rows`` rows,
    the gate."""
    import torch
    from maxstyle_tpu_torch.ops import maxstyle_kernels as mk
    b, c = shape[:2]
    lmda = torch.rand((b, 1), generator=gen, device="cuda") * (lmda_hi - lmda_lo) + lmda_lo
    gn, bn = (torch.randn((b, c), generator=gen, device="cuda") for _ in range(2))
    mu, sig = mk.channel_moments_plain(torch.randn(shape, generator=gen, device="cuda") * 2 + 1,
                                       1e-6)
    perm = torch.roll(torch.randperm(b, generator=gen, device="cuda"), 1)
    gstd, bstd = (torch.rand((spread_rows, c), generator=gen, device="cuda") for _ in range(2))
    return (lmda, gn, bn, mu, sig, perm, gstd, bstd, torch.full((1, 1), gate, device="cuda"))


def _apply_agrees(k, p, again):
    """(scale, shift, mu2 and sig2 bit-equal to the plain version's and the
    whole result bit-equal over two calls, out's error over max|out|)."""
    same = _bit_equal(k[1:], p[1:]) and _bit_equal(k, again)
    return same, float((k[0] - p[0]).abs().max() / p[0].abs().max().clamp_min(1e-30))


def _parent_apply(cfg, x, args):
    """The apply call as the parent made it: the permuted moments gathered,
    the coefficients folded by torch ops, then one addcmul."""
    import torch
    from maxstyle_tpu_torch.ops import maxstyle_kernels as mk
    lmda, gn, bn, mu, sig, perm, gstd, bstd, gate = args
    scale, shift = mk._coefficients(cfg, lmda, gn, bn, mu, sig, mu[perm], sig[perm],
                                    gstd, bstd, gate)
    return torch.addcmul(shift[:, :, None, None], x, scale[:, :, None, None])


def _apply_branches(rows):
    """The apply kernel over every branch of the style map (mix_style,
    no_noise, the gate, spreads [1,C] or [B,C], lmda inside or outside
    [0, 1]) at a float4 and a scalar shape: scale bit-equal, out within
    1e-6 of max|out|, bit-equal over two calls."""
    import torch
    from maxstyle_tpu_torch.config import MaxStyleConfig
    from maxstyle_tpu_torch.ops import maxstyle_kernels as mk

    ok, checks = True, []
    for shape in ((4, 16, 24, 24), (4, 3, 33, 31)):
        g = torch.Generator(device="cuda").manual_seed(40)
        x = torch.randn(shape, generator=g, device="cuda") * 2 + 1
        for mix in (True, False):
            for no_noise in (False, True):
                for gate in (1.0, 0.0):
                    for rows_ in (1, shape[0]):
                        for lo, hi in ((0.0, 1.0), (-1.0, 2.0)):
                            cfg = MaxStyleConfig(mix_style=mix, no_noise=no_noise)
                            args = _style_inputs(shape, g, gate, rows_, lo, hi)
                            same, err = _apply_agrees(mk.style_apply(cfg, x, *args),
                                                      mk.style_apply_plain(cfg, x, *args),
                                                      mk.style_apply(cfg, x, *args))
                            checks.append(dict(shape=list(shape), mix_style=mix,
                                               no_noise=no_noise, gate=gate,
                                               spread_rows=rows_, lmda=[lo, hi],
                                               bit_equal=same, rel_err=err, tol=1e-6))
                            ok &= same and err <= 1e-6
    rows["maxstyle_apply"]["branch_checks"] = checks
    bad = [c for c in checks if not (c["bit_equal"] and c["rel_err"] <= 1e-6)]
    print(f"kernel maxstyle_apply branches: {len(checks) - len(bad)} of {len(checks)} agree "
          f"(scale, shift, mu[perm], sig[perm] bit-equal; out within 1e-6 of max|out|; "
          f"bit-equal over two calls)" + (f"; first failure {bad[0]}" if bad else ""))
    return ok


def _style_rows(rows, cell, shapes, eps):
    """The three MaxStyle kernels against their plain versions at one cell's
    hook shapes; stats and bwd also twice on one input, bit for bit. Returns
    whether all agree."""
    import torch
    from maxstyle_tpu_torch.config import MaxStyleConfig
    from maxstyle_tpu_torch.ops import maxstyle_kernels as mk
    from maxstyle_tpu_torch.timing import copies_beyond_l2, cuda_ms

    ok = True
    for si, shape in enumerate(shapes):
        n_el = math.prod(shape)
        b, c = shape[:2]
        copies = copies_beyond_l2(n_el * 4)
        g = torch.Generator(device="cuda").manual_seed(si)
        xs = [torch.randn(shape, generator=g, device="cuda") * 2 + 1 for _ in range(copies)]
        gs = [torch.randn(shape, generator=g, device="cuda") for _ in range(copies)]
        scale = torch.randn((b, c), generator=g, device="cuda")
        x, gr = xs[0], gs[0]

        # stats: mu and sig per plane, rtol 1e-5; bit-equal over two calls
        k, p = mk.channel_moments(x, eps), mk.channel_moments_plain(x, eps)
        err = _stats_err(k, p)
        same = _bit_equal(k, mk.channel_moments(x, eps))
        rows["maxstyle_stats"]["shapes"].append(dict(
            cell=cell, shape=list(shape),
            max_abs_err=max(float((a - b_).abs().max()) for a, b_ in zip(k, p)), rel_err=err,
            tol=1e-5, bit_equal_over_two_calls=same,
            ms=cuda_ms(lambda i: mk.channel_moments(xs[i], eps), copies),
            plain_ms=cuda_ms(lambda i: mk.channel_moments_plain(xs[i], eps), copies),
            library_ms=cuda_ms(lambda i: torch.var_mean(xs[i], dim=(2, 3)), copies),
            **_roof(n_el * 4 + 2 * b * c * 4, 3 * n_el)))
        ok &= err <= 1e-5 and same

        # apply (coefficients folded in): scale and shift bit-equal to
        # _coefficients on the card, out within 1e-6 of max|out| (the
        # kernel fuses the multiply-add), bit-equal over two calls; the
        # library time is the parent's route (gathers, _coefficients in
        # torch, addcmul)
        cfg = MaxStyleConfig()
        args = _style_inputs(shape, g, 1.0, 1)
        k, p = mk.style_apply(cfg, x, *args), mk.style_apply_plain(cfg, x, *args)
        ok_apply, err = _apply_agrees(k, p, mk.style_apply(cfg, x, *args))
        rows["maxstyle_apply"]["shapes"].append(dict(
            cell=cell, shape=list(shape), max_abs_err=float((k[0] - p[0]).abs().max()),
            rel_err=err, tol=1e-6, coefficients_bit_equal=ok_apply,
            ms=cuda_ms(lambda i: mk.style_apply(cfg, xs[i], *args), copies),
            plain_ms=cuda_ms(lambda i: mk.style_apply_plain(cfg, xs[i], *args), copies),
            library_ms=cuda_ms(lambda i: _parent_apply(cfg, xs[i], args), copies),
            **_roof(2 * n_el * 4 + 8 * b * c * 4 + 3 * b * 4 + 4 * c * 4 + 4,
                    2 * n_el + 25 * b * c)))
        ok &= ok_apply and err <= 1e-6

        # bwd: dx = g * scale (exact), sums of g and g*x (1e-5 of sum|terms|);
        # bit-equal over two calls
        kb = mk.plane_affine_bwd(gr, x, scale)
        max_err, err = _bwd_err(kb, mk.plane_affine_bwd_plain(gr, x, scale), gr, x)
        same = _bit_equal(kb, mk.plane_affine_bwd(gr, x, scale))
        rows["maxstyle_bwd"]["shapes"].append(dict(
            cell=cell, shape=list(shape), max_abs_err=max_err, rel_err=err, tol=1e-5,
            bit_equal_over_two_calls=same,
            ms=cuda_ms(lambda i: mk.plane_affine_bwd(gs[i], xs[i], scale), copies),
            plain_ms=cuda_ms(lambda i: mk.plane_affine_bwd_plain(gs[i], xs[i], scale), copies),
            library_ms=None,
            **_roof(3 * n_el * 4 + 3 * b * c * 4, 4 * n_el)))
        ok &= err <= 1e-5 and same
        del xs, gs
    return ok


def _style_ragged(rows, eps):
    """Stats and bwd at ragged shapes (hw % 4 != 0, hw = 1, a plane cut
    unevenly, within a block and across a cluster's ranks), against their
    plain versions and bit-equal over two calls."""
    import torch
    from maxstyle_tpu_torch.ops import maxstyle_kernels as mk

    ok = True
    for name in ("maxstyle_stats", "maxstyle_bwd"):
        rows[name]["ragged_checks"] = []
    for i, shape in enumerate(STYLE_RAGGED):
        g = torch.Generator(device="cuda").manual_seed(20 + i)
        x = torch.randn(shape, generator=g, device="cuda") * 2 + 1
        gr = torch.randn(shape, generator=g, device="cuda")
        scale = torch.randn(shape[:2], generator=g, device="cuda")
        k_ranks, per_rank = mk._tiling(x)
        k = mk.channel_moments(x, eps)
        err, same = _stats_err(k, mk.channel_moments_plain(x, eps)), _bit_equal(
            k, mk.channel_moments(x, eps))
        kb = mk.plane_affine_bwd(gr, x, scale)
        _, berr = _bwd_err(kb, mk.plane_affine_bwd_plain(gr, x, scale), gr, x)
        bsame = _bit_equal(kb, mk.plane_affine_bwd(gr, x, scale))
        for name, e, s in (("maxstyle_stats", err, same), ("maxstyle_bwd", berr, bsame)):
            rows[name]["ragged_checks"].append(dict(shape=list(shape), rel_err=e, tol=1e-5,
                                                    bit_equal_over_two_calls=s,
                                                    cluster=k_ranks, per_rank=per_rank))
            print(f"kernel {name} ragged {list(shape)} (cluster of {k_ranks}, {per_rank} "
                  f"values a rank): checked err {e:.3e} (tol 1e-5), bit-equal over two calls {s}")
            ok &= e <= 1e-5 and s
    return ok


def _warp_case(shape, policy_name, seed, copies):
    """Copies of images in [0, 1), int32 labels and three sets of source
    coordinates: uniform ones reaching 2 pixels outside the source on every
    side (the edge cases), the main path's own, drawn from the policy, and
    a grid stretched over [-2.5, H+1.5] on both axes, so that tiles straddle
    both rims."""
    import torch
    from maxstyle_tpu_torch.bench_style import rim_coords
    from maxstyle_tpu_torch.data import augment as A
    n, H, h = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    policy = A.get_policy(policy_name, (H, H), (h, h))
    case = {"img": [], "lab": [], "uniform": [], "policy": [], "rim": []}
    for _ in range(copies):
        case["img"].append(torch.rand((n, H, H), generator=gen, device="cuda"))
        case["lab"].append(torch.randint(0, 4, (n, H, H), generator=gen, device="cuda",
                                         dtype=torch.int32))
        case["uniform"].append(tuple(torch.rand((n, h, h), generator=gen, device="cuda")
                                     * (H + 3) - 2 for _ in range(2)))
        case["policy"].append(tuple(t.contiguous() for t in
                                    A.aug_coords(A.draw_aug(gen, policy, n), policy)))
        case["rim"].append(rim_coords(gen, n, H, h))
    return case, gen


def _rim_inputs(oy, ox, H, h):
    """(mat, oy, ox) of a matrix that stretches each crop over [-2.5, H+1.5]
    on both axes, so that pixels straddle both rims."""
    import torch
    s = (H + 4) / (h - 1)
    c = (H - 1) / 2.0
    mat = torch.zeros((oy.shape[0], 2, 3), device=oy.device)
    mat[:, 0, 0] = s
    mat[:, 1, 1] = s
    mat[:, 0, 2] = -2.5 - c - s * (oy.float() - c)
    mat[:, 1, 2] = -2.5 - c - s * (ox.float() - c)
    return mat, oy, ox


def _bilinear_rows(rows):
    """The bilinear warp at the headline shape. The composed entry (the main
    path's) bit for bit against its plain version at the policy's draws with
    the elastic gate on for even samples and off for odd ones, with no
    elastic branch (policy ACDC_affine) and at a matrix that stretches the
    crop over both rims; the coordinate entry bit for bit at uniform, policy
    and rim coordinates; at every pixels-a-thread variant, the composed
    entry on a ragged 45-column crop and the coordinate entry on an
    unaligned view of coordinates. Timed: the composed entry at the policy's draws
    (ms), its plain version, the parent's route (library_ms), and the
    coordinate entry at the policy's and at uniform coordinates. The bound
    counts the images and labels, the field's crop window, the outputs and
    the per-sample inputs."""
    import torch
    from maxstyle_tpu_torch.bench_style import (WARP_POLICY, WARP_SHAPE, composed_inputs,
                                                parent_route)
    from maxstyle_tpu_torch.data import augment as A
    from maxstyle_tpu_torch.ops import warp_kernels as wk
    from maxstyle_tpu_torch.timing import copies_beyond_l2, cuda_ms

    n, H, h = WARP_SHAPE
    px = n * h * h
    copies = copies_beyond_l2(n * H * H * 16 + px * 8)
    case, gen = _warp_case(WARP_SHAPE, WARP_POLICY, 7, copies)
    imgs, labs = case["img"], case["lab"]
    comp = [composed_inputs(gen, A.get_policy(WARP_POLICY, (H, H), (h, h)), n)
            for _ in range(copies)]
    no_elastic = composed_inputs(gen, A.get_policy("ACDC_affine", (H, H), (h, h)), n)
    composed_cases = {"policy": comp[0], "no_elastic": no_elastic,
                      "rim": _rim_inputs(*comp[0][1:3], H, h)}

    def composed(i, args, fn=wk.warp_bilinear_nearest_affine):
        return fn(imgs[i], labs[i], *args[:3], (h, h), *args[3:])

    checks = {}
    for kind, args in composed_cases.items():
        (ki, kl), (pi, pl) = (composed(0, args, f) for f in
                              (wk.warp_bilinear_nearest_affine,
                               wk.warp_bilinear_nearest_affine_plain))
        checks[f"composed_{kind}"] = (float((ki - pi).abs().max()), int((kl != pl).sum()))
    for kind in ("uniform", "policy", "rim"):
        (ki, kl), (pi, pl) = (f(imgs[0], labs[0], *case[kind][0]) for f in
                              (wk.warp_bilinear_nearest, wk.warp_bilinear_nearest_plain))
        checks[f"coords_{kind}"] = (float((ki - pi).abs().max()), int((kl != pl).sum()))
    # a ragged crop (45 columns: a scalar tail), and 48 columns given as an
    # unaligned view of the coordinates
    r_img = torch.rand((3, 50, 50), generator=gen, device="cuda")
    r_lab = torch.randint(0, 4, (3, 50, 50), generator=gen, device="cuda", dtype=torch.int32)
    r_comp = composed_inputs(gen, A.get_policy(WARP_POLICY, (50, 50), (45, 45)), 3)
    c48 = composed_inputs(gen, A.get_policy(WARP_POLICY, (50, 50), (48, 48)), 3)
    r_sy, r_sx = (torch.cat([torch.zeros(1, device="cuda"), t.flatten()])[1:].view(t.shape)
                  for t in wk.compose_coords(*c48[:3], (50, 50), (48, 48), *c48[3:]))
    for kind, (k, p) in (
            ("composed", (wk.warp_bilinear_nearest_affine(r_img, r_lab, *r_comp[:3], (45, 45),
                                                          *r_comp[3:]),
                          wk.warp_bilinear_nearest_affine_plain(r_img, r_lab, *r_comp[:3],
                                                                (45, 45), *r_comp[3:]))),
            ("coords_unaligned", (wk.warp_bilinear_nearest(r_img, r_lab, r_sy, r_sx),
                                  wk.warp_bilinear_nearest_plain(r_img, r_lab, r_sy, r_sx)))):
        checks[f"ragged_{kind}"] = (float((k[0] - p[0]).abs().max()), int((k[1] != p[1]).sum()))
    for name, (err, lab_err) in checks.items():
        print(f"kernel warp_bilinear_nearest {name}: max abs err {err:.3e}, "
              f"label mismatches {lab_err} (tol 0)")
    ok = all(err == 0.0 and lab_err == 0 for err, lab_err in checks.values())
    rows["warp_bilinear_nearest"]["shapes"].append(dict(
        cell="headline", shape=[n, H, H, h, h], tol=0.0,
        max_abs_err=max(e for e, _ in checks.values()),
        label_mismatches=sum(m for _, m in checks.values()),
        checks={k: {"max_abs_err": e, "label_mismatches": m} for k, (e, m) in checks.items()},
        ms=cuda_ms(lambda i: composed(i, comp[i]), copies),
        plain_ms=cuda_ms(lambda i: composed(i, comp[i], wk.warp_bilinear_nearest_affine_plain),
                         copies),
        library_ms=cuda_ms(lambda i: parent_route(imgs[i], labs[i], *comp[i][:3], (h, h),
                                                  *comp[i][3:]), copies),
        coords_entry_ms=cuda_ms(lambda i: wk.warp_bilinear_nearest(
            imgs[i], labs[i], *case["policy"][i]), copies),
        uniform_coords_ms=cuda_ms(lambda i: wk.warp_bilinear_nearest(
            imgs[i], labs[i], *case["uniform"][i]), copies),
        **_roof(n * H * H * 8 + px * 8 + px * 8 + n * (24 + 8 + 8 + 4 + 4), 40 * px)))
    return ok


def _bilinear_prostate_row(rows):
    """The composed bilinear warp at the branch paths' Prostate shape (N=10,
    288 -> 224, policy Prostate_affine_elastic_intensity): bit for bit
    against its plain version at the policy's draws (elastic gate on for
    even samples, off for odd ones) and at a matrix across both rims, and
    timed beside its plain version and the parent's route. Its row entry is
    the "prostate" cell, which the row's summed numbers leave out."""
    import torch
    from maxstyle_tpu_torch.bench_style import composed_inputs, parent_route
    from maxstyle_tpu_torch.data import augment as A
    from maxstyle_tpu_torch.ops import warp_kernels as wk
    from maxstyle_tpu_torch.timing import copies_beyond_l2, cuda_ms

    n, H, h = BRANCH_WARP_SHAPE
    px = n * h * h
    copies = copies_beyond_l2(n * H * H * 16 + px * 8)
    gen = torch.Generator(device="cuda").manual_seed(8)
    policy = A.get_policy("Prostate_affine_elastic_intensity", (H, H), (h, h))
    imgs = [torch.rand((n, H, H), generator=gen, device="cuda") for _ in range(copies)]
    labs = [torch.randint(0, 2, (n, H, H), generator=gen, device="cuda", dtype=torch.int32)
            for _ in range(copies)]
    comp = [composed_inputs(gen, policy, n) for _ in range(copies)]

    def composed(i, args, fn=wk.warp_bilinear_nearest_affine):
        return fn(imgs[i], labs[i], *args[:3], (h, h), *args[3:])

    checks = {}
    for kind, args in (("policy", comp[0]), ("rim", _rim_inputs(*comp[0][1:3], H, h)
                                             + comp[0][3:])):
        (ki, kl), (pi, pl) = (composed(0, args, f) for f in
                              (wk.warp_bilinear_nearest_affine,
                               wk.warp_bilinear_nearest_affine_plain))
        checks[f"composed_{kind}"] = (float((ki - pi).abs().max()), int((kl != pl).sum()))
        print(f"kernel warp_bilinear_nearest prostate composed_{kind}: max abs err "
              f"{checks[f'composed_{kind}'][0]:.3e}, label mismatches "
              f"{checks[f'composed_{kind}'][1]} (tol 0)")
    rows["warp_bilinear_nearest"]["shapes"].append(dict(
        cell="prostate", shape=[n, H, H, h, h], tol=0.0,
        max_abs_err=max(e for e, _ in checks.values()),
        label_mismatches=sum(m for _, m in checks.values()),
        checks={k: {"max_abs_err": e, "label_mismatches": m} for k, (e, m) in checks.items()},
        ms=cuda_ms(lambda i: composed(i, comp[i]), copies),
        plain_ms=cuda_ms(lambda i: composed(i, comp[i], wk.warp_bilinear_nearest_affine_plain),
                         copies),
        library_ms=cuda_ms(lambda i: parent_route(imgs[i], labs[i], *comp[i][:3], (h, h),
                                                  *comp[i][3:]), copies),
        **_roof(n * H * H * 8 + px * 8 + px * 8 + n * (24 + 8 + 8 + 4 + 4), 40 * px)))
    return all(err == 0.0 and lab_err == 0 for err, lab_err in checks.values())


def _warp_rows(rows):
    """Both warps against their plain versions, bit for bit (the bilinear
    warp in :func:`_bilinear_rows`); the cubic warp at uniform, at the main
    path's and at rim-straddling coordinates, also bit-equal over two calls,
    timed at the main path's and at uniform ones; and the prefilter's
    matrix form against its recursion at atol 1e-5."""
    from maxstyle_tpu_torch.bench_style import CUBIC_SHAPE
    from maxstyle_tpu_torch.ops import spline
    from maxstyle_tpu_torch.ops import warp_kernels as wk
    from maxstyle_tpu_torch.timing import copies_beyond_l2, cuda_ms

    def mismatch(kernel, plain, images, case):
        """(largest image difference, label mismatches) over every kind of
        coordinates."""
        img_err, lab_err = 0.0, 0
        for coords in ("uniform", "policy", "rim"):
            (ki, kl), (pi, pl) = (f(images, case["lab"][0], *case[coords][0])
                                  for f in (kernel, plain))
            img_err = max(img_err, float((ki - pi).abs().max()))
            lab_err += int((kl != pl).sum())
        return img_err, lab_err

    ok = _bilinear_rows(rows)
    ok &= _bilinear_prostate_row(rows)
    n, H, h = CUBIC_SHAPE
    px = n * h * h
    copies = copies_beyond_l2(n * H * H * 8 + px * 8)
    case, _ = _warp_case(CUBIC_SHAPE, "Prostate_affine_elastic_intensity", 7, copies)
    labs, crd = case["lab"], case["policy"]
    # float operations a pixel: taps and weights
    row = dict(shape=[n, H, H, h, h], tol=0.0, library_ms=None,
               **_roof(n * H * H * 8 + px * 8 + px * 8, 70 * px))
    coefs = [spline.spline_filter2d_matrix(im) for im in case["img"]]
    pre_err = float((coefs[0] - spline.spline_filter2d(case["img"][0])).abs().max())
    img_err, lab_err = mismatch(wk.sample_cubic_nearest, wk.sample_cubic_nearest_plain,
                                coefs[0], case)
    whole_err, whole_lab = mismatch(wk.warp_cubic_nearest, wk.warp_cubic_nearest_plain,
                                    case["img"][0], case)
    same = all(_bit_equal(*(wk.sample_cubic_nearest(coefs[0], labs[0], *case[k][0])
                            for _ in range(2))) for k in ("uniform", "policy", "rim"))
    ok &= pre_err <= 1e-5 and whole_err == 0.0 and whole_lab == 0 and same
    row.update(cell="prostate_cubic", prefilter_matrix_vs_loop_err=pre_err,
               bit_equal_over_two_calls=same,
               prefilter_tol=1e-5, wrapper_err=whole_err, wrapper_label_mismatches=whole_lab,
               ms=cuda_ms(lambda i: wk.sample_cubic_nearest(coefs[i], labs[i], *crd[i]),
                          copies),
               plain_ms=cuda_ms(
                   lambda i: wk.sample_cubic_nearest_plain(coefs[i], labs[i], *crd[i]),
                   copies),
               uniform_coords_ms=cuda_ms(lambda i: wk.sample_cubic_nearest(
                   coefs[i], labs[i], *case["uniform"][i]), copies),
               prefilter_ms=cuda_ms(lambda i: spline.spline_filter2d_matrix(
                   case["img"][i]), copies))
    row.update(max_abs_err=img_err, label_mismatches=lab_err)
    rows["warp_cubic_nearest"]["shapes"].append(row)
    ok &= img_err == 0.0 and lab_err == 0
    del case
    return ok


def _conv_rows(rows):
    """conv3x3_bn_stats against its plain version with the prototype's
    check() tolerances: timed at the bench's shapes, and checked at ragged
    shapes (channels off the 8-channel chunk, Cout above one block's
    channels, sides off the tile, rows the tensor map cannot describe).
    The bound is the tensor cores' (three TF32 products); the float32 bound
    of the CUDA cores stays beside it as ffma_bound_ms."""
    import torch.nn.functional as F
    from maxstyle_tpu_torch import proto_conv_bn_fusion as P
    from maxstyle_tpu_torch.timing import bound_ms, copies_beyond_l2, cuda_ms

    ok = True
    for i, shape in enumerate(P.SHAPES):
        bsz, hw, c = shape
        copies = copies_beyond_l2(4 * bsz * c * hw * hw)
        xs, w, b = P.make_case(shape, i, "cuda", copies)
        res = P.compare(P.conv3x3_bn_stats(xs[0], w, b), P.conv3x3_bn_stats_plain(xs[0], w, b))
        bound, bound_by = P.bound(shape)
        rows["conv3x3_bn_stats"]["shapes"].append(dict(
            cell="conv_bn_fusion", shape=list(shape), max_abs_err=res["max_abs_err"],
            rel_err=res["worst"], tol=1.0, errors_in_tolerances=res,
            ms=cuda_ms(lambda k: P.conv3x3_bn_stats(xs[k], w, b), copies),
            plain_ms=cuda_ms(lambda k: P.conv3x3_bn_stats_plain(xs[k], w, b), copies),
            library_ms=cuda_ms(lambda k: P.conv_stats_library(xs[k], w, b), copies),
            cudnn_conv_ms=cuda_ms(lambda k: F.conv2d(xs[k], w, b, padding=1), copies),
            bound_ms=bound, bound_by=bound_by,
            ffma_bound_ms=bound_ms(*P.work(shape))))
        ok &= res["worst"] <= 1.0
        del xs
    checks = rows["conv3x3_bn_stats"]["ragged_checks"] = []
    for i, shape in enumerate(P.RAGGED_SHAPES):
        (x,), w, b = P.make_case(shape, 10 + i, "cuda")
        res = P.compare(P.conv3x3_bn_stats(x, w, b), P.conv3x3_bn_stats_plain(x, w, b))
        checks.append(dict(shape=list(shape), max_abs_err=res["max_abs_err"], rel_err=res["worst"],
                           tol=1.0, errors_in_tolerances=res))
        print(f"kernel conv3x3_bn_stats ragged (B, Cin, Cout, H, W) {list(shape)}: "
              f"worst {res['worst']:.3e} of the tolerances (tol 1.0)")
        ok &= res["worst"] <= 1.0
    return ok


def phase_kernels():
    """Each kernel vs its plain version at every main-path shape."""
    rows = {name: {"name": name, "route": "cuda", "source": SOURCES[name][0],
                   "replaces": SOURCES[name][1], "shapes": []} for name in KERNELS}
    from maxstyle_tpu_torch.config import MaxStyleConfig
    from maxstyle_tpu_torch.bench_style import STYLE_SHAPES, launch_floor_ms
    eps = MaxStyleConfig().eps
    ok = True
    for cell, shapes in STYLE_SHAPES.items():
        ok &= _style_rows(rows, cell, shapes, eps)
    ok &= _style_ragged(rows, eps)
    ok &= _apply_branches(rows)
    floor = launch_floor_ms()
    print(f"launch floor: fill_ of a one-element tensor {floor:.5f} ms a launch "
          f"(CUDA-graph replay)")
    for name in ("maxstyle_stats", "maxstyle_bwd"):
        rows[name]["launch_floor_ms"] = floor
    ok &= _warp_rows(rows)
    ok &= _conv_rows(rows)
    for row in rows.values():
        for s in row["shapes"]:
            extra = "".join(f" {k} {s[k]:.5f}" for k in
                            ("coords_entry_ms", "uniform_coords_ms", "prefilter_ms",
                             "cudnn_conv_ms",
                             "ffma_bound_ms") if k in s)
            print(f"kernel {row['name']} {s['cell']} {s['shape']}: "
                  f"max abs err {s['max_abs_err']:.3e}, "
                  f"checked err {s.get('rel_err', s['max_abs_err']):.3e} (tol {s['tol']}) "
                  f"ms {s['ms']:.5f} plain {s['plain_ms']:.5f} "
                  f"library {s['library_ms']} bound {s['bound_ms']:.5f} ({s['bound_by']}){extra}")
    print(f"kernel warp_cubic_nearest prefilter: matrix vs recursion max err "
          f"{rows['warp_cubic_nearest']['shapes'][0]['prefilter_matrix_vs_loop_err']:.3e} "
          f"(tol 1e-5)")
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


def phase_train(path: str, solver, smi: str, desc: str, rounds: int = 3,
                channel: str = None):
    """Drive one training path: K_INNER-step calls of make_multi_step (one
    warm-up, then ``rounds`` rounds of 2), with the launch counts set to 0
    just before and read just after. Checks finite losses, a non-zero
    ``channel`` when given, and the launches per step of PER_STEP[path]."""
    import torch
    from maxstyle_tpu_torch import kernels
    from maxstyle_tpu_torch.flagship import measure_throughput

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rate, state, metrics = measure_throughput(solver, k_inner=K_INNER, n_calls=2,
                                              n_repeats=rounds)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    steps = state.step
    last = {k: float(v) for k, v in metrics.items()}
    print(f"{path}: metrics of the last call (mean of {K_INNER} steps) {json.dumps(last)}")
    print(f"{path}: launches over {steps} steps {json.dumps(launches)}")
    print(f"{path}: {rate:.4f} steps/s (median of {rounds} rounds of 2 calls x {K_INNER} steps, "
          f"{desc}, float32) on {smi}; phase {time.perf_counter() - t0:.1f} s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if steps != K_INNER * (1 + 2 * rounds):
        fail(f"{path} ran {steps} steps, expected {K_INNER * (1 + 2 * rounds)}")
    if not all(math.isfinite(v) for v in last.values()):
        fail(f"non-finite loss in {path}")
    if channel is not None and last[channel] == 0.0:
        fail(f"{path}: the branch channel {channel} is 0")
    for name in KERNELS:
        want = PER_STEP[path].get(name, 0) * steps
        if launches[name] != want:
            fail(f"{path}: {name} launched {launches[name]} times over {steps} steps, "
                 f"expected {want}")
    return launches


def phase_conv_bn_fusion():
    """The conv+BN-statistics entry point, as a user runs it: --check, then
    the bench."""
    from maxstyle_tpu_torch import kernels
    from maxstyle_tpu_torch import proto_conv_bn_fusion as P

    kernels.reset_launches()
    if P.main(["--check"]) != 0:
        fail("proto_conv_bn_fusion --check failed")
    P.main([])
    launches = dict(kernels.LAUNCHES)
    print(f"conv_bn_fusion: launches {json.dumps(launches)}")
    if launches["conv3x3_bn_stats"] == 0 or any(
            n for k, n in launches.items() if k != "conv3x3_bn_stats"):
        fail("the conv_bn_fusion entry point did not run (only) the fused kernel")
    return launches


def _write_acdc_tree(root, seed=0):
    """The synthetic ACDC tree of the train_cli phase under ``root``:
    {root}/train/{ES,ED}/{pid}_img.nrrd and _seg.nrrd for the patients of
    acdc_split("10", 0), and {root}/ACDC/{pid}/img.nii.gz and seg.nii.gz, an
    OOD suite. Labels are 4-class concentric discs around a jittered centre
    on every slice; images are a level a class plus N(0, 0.05) noise.
    Returns (train patients, validation patients)."""
    import os

    import numpy as np
    from maxstyle_tpu_torch.data import medio
    from maxstyle_tpu_torch.data.splits import acdc_split

    split = acdc_split("10", 0)
    rng = np.random.RandomState(seed)
    s, (h, w) = ACDC_TREE["slices"], ACDC_TREE["hw"]
    spacing = ACDC_TREE["spacing"]
    yy, xx = np.mgrid[:h, :w]

    def volume():
        cy, cx = h / 2 + rng.uniform(-8, 8), w / 2 + rng.uniform(-8, 8)
        radii = np.sort(rng.uniform(0.06, 0.16, 3)) * min(h, w)
        r = np.hypot(yy - cy, xx - cx)
        lab = np.zeros((s, h, w), np.uint8)
        for k, rad in zip((3, 2, 1), radii[::-1]):
            lab[:, r < rad * rng.uniform(0.9, 1.1)] = k
        level = np.array([0.1, 0.8, 0.4, 0.6], np.float32)
        img = level[lab] + 0.05 * rng.randn(s, h, w).astype(np.float32)
        return img.astype(np.float32), lab

    for pid in sorted(set(split["train"] + split["validate"])):
        for frame in ("ES", "ED"):
            d = os.path.join(root, "train", frame)
            os.makedirs(d, exist_ok=True)
            img, lab = volume()
            medio.write_nrrd(os.path.join(d, f"{pid}_img.nrrd"), img, spacing, compress=False)
            medio.write_nrrd(os.path.join(d, f"{pid}_seg.nrrd"), lab, spacing, compress=False)
    for i in range(ACDC_TREE["ood_patients"]):
        d = os.path.join(root, "ACDC", f"patient{i:03d}")
        os.makedirs(d)
        img, lab = volume()
        medio.write_nifti(os.path.join(d, "img.nii.gz"), img, spacing)
        medio.write_nifti(os.path.join(d, "seg.nii.gz"), lab, spacing)
    return split["train"], split["validate"]


def _flagship_syncs(solver):
    """Host syncs a step of the flagship path (make_multi_step on synthetic
    raw slices of the solver's config, K_INNER steps a call), counted by
    profile_slice.host_syncs over one call after a warm-up call."""
    import torch
    from maxstyle_tpu_torch.flagship import make_raw_batches, workload_policy
    from maxstyle_tpu_torch.profile_slice import host_syncs
    from maxstyle_tpu_torch.train_step import make_multi_step

    cfg = solver.config
    policy = workload_policy(cfg)
    state = solver.init_state(0)
    raw = make_raw_batches(K_INNER, cfg.train_batch_size, policy.pad_hw[0], 1, solver.device,
                           num_classes=cfg.segmentation_model.num_classes)
    multi = make_multi_step(solver, policy,
                            keep_orig=cfg.data.keep_orig_image_label_pair_for_training,
                            n_inner=K_INNER)
    gen = torch.Generator(device=solver.device).manual_seed(10)
    multi(state, raw, gen)
    torch.cuda.synchronize()
    syncs = host_syncs(lambda: multi(state, raw, gen))
    torch.cuda.synchronize()
    return sum(syncs.values()) / K_INNER, dict(syncs)


class _CliProbe:
    """What the train_cli phase observes inside ``train.main``, through
    wrappers of the CLI's step factory, checkpoint writer and auto_test:
    the steps run, the second epoch's wall time and host syncs (from a
    synchronize before its first step to one after its last), a copy of
    the modules at each save of 'best', and the launches made during the
    evaluation."""

    def __init__(self, steps_per_epoch):
        self.steps_per_epoch = steps_per_epoch
        self.steps = 0
        self.epoch2_s = None
        self.syncs = None
        self.best_copy = None
        self.eval_launches = None

    def wrap_step_factory(self, factory):
        import os
        import warnings

        import torch
        from maxstyle_tpu_torch.profile_slice import is_sync_warning

        def make(*args, **kwargs):
            step = factory(*args, **kwargs)
            window = {}

            def probed(*a, **kw):
                first = self.steps == self.steps_per_epoch
                last = self.steps == 2 * self.steps_per_epoch - 1
                if first:
                    torch.cuda.synchronize()
                    window["cm"] = warnings.catch_warnings(record=True)
                    window["caught"] = window["cm"].__enter__()
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    window["t0"] = time.perf_counter()
                out = step(*a, **kw)
                self.steps += 1
                if last:
                    torch.cuda.set_sync_debug_mode("default")
                    window["cm"].__exit__(None, None, None)
                    torch.cuda.synchronize()
                    self.epoch2_s = time.perf_counter() - window["t0"]
                    self.syncs = [f"{os.path.relpath(w.filename)}:{w.lineno}"
                                  for w in window["caught"] if is_sync_warning(w)]
                return out
            return probed
        return make

    def wrap_save(self, save):
        def probed(directory, name, state, *a, **kw):
            path = save(directory, name, state, *a, **kw)
            if name == "best":
                self.best_copy = {k: {n: t.detach().clone() for n, t in m.state_dict().items()}
                                  for k, m in state.modules.items()}
            return path
        return probed

    def wrap_auto_test(self, auto_test):
        from maxstyle_tpu_torch import kernels

        def probed(*a, **kw):
            before = dict(kernels.LAUNCHES)
            rows = auto_test(*a, **kw)
            self.eval_launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
            return rows
        return probed


def _acdc_config(tmp: str, directory: str, changes):
    """TRAIN_CLI_CONFIG with its root_dir on the synthetic tree under ``tmp``
    and ``changes`` ({block: {key: value}}) applied, written into
    ``directory``; returns (its path, the ExperimentConfig)."""
    import os

    from maxstyle_tpu_torch.config import ExperimentConfig

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, TRAIN_CLI_CONFIG)) as f:
        raw_cfg = json.load(f)
    raw_cfg["data"]["root_dir"] = os.path.join(tmp, "train")
    for block, block_changes in changes.items():
        raw_cfg[block].update(block_changes)
    os.makedirs(directory, exist_ok=True)
    cfg_path = os.path.join(directory, os.path.basename(TRAIN_CLI_CONFIG))
    with open(cfg_path, "w") as f:
        json.dump(raw_cfg, f)
    return cfg_path, ExperimentConfig.from_dict(raw_cfg)


def phase_train_cli(smi: str, tmp: str, train_pids, val_pids):
    """The training CLI end to end on the card (see the module docstring,
    phase 9) on the synthetic ACDC tree under ``tmp``, then the inference
    CLI on the OOD suite. Returns (launches, measure_throughput's steps/s
    and the flagship step's host syncs a step on the same config)."""
    import os

    import torch
    from maxstyle_tpu_torch import evaluate, infer, kernels, train
    from maxstyle_tpu_torch.data import augment as A
    from maxstyle_tpu_torch.data.datasets import HostBatchLoader
    from maxstyle_tpu_torch.flagship import config_solver, measure_throughput
    from maxstyle_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    cfg_path, cfg = _acdc_config(tmp, tmp, TRAIN_CLI_CHANGES)
    n_epochs, batch = cfg.learning.n_epochs, cfg.learning.batch_size
    frames, slices = len(cfg.data.frame), ACDC_TREE["slices"]
    steps_per_epoch = len(train_pids) * frames * slices // cfg.train_batch_size
    val_batches = -(-len(val_pids) * frames * slices // batch)

    probe = _CliProbe(steps_per_epoch)
    patches = [(train, "make_fused_train_step", probe.wrap_step_factory),
               (ckpt, "save_checkpoint", probe.wrap_save),
               (evaluate, "auto_test", probe.wrap_auto_test)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, wrap in patches:
        setattr(mod, name, wrap(getattr(mod, name)))
    save_dir = os.path.join(tmp, "saved")
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        train.main(["--json_config_path", cfg_path, "--save_dir", save_dir,
                    "--data_setting", "10", "--cval", "0", "--seed", "1", "--auto_test",
                    "--test_root_dir", tmp])
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    # the run directory
    config_name = os.path.splitext(os.path.basename(cfg_path))[0]
    run_dir = os.path.join(save_dir, f"train_ACDC_10_n_cls_{cfg.segmentation_model.num_classes}",
                           config_name, "0")
    log_dir, model_dir = os.path.join(run_dir, "log"), os.path.join(run_dir, "model")
    need = [os.path.join(run_dir, "config.json"), os.path.join(model_dir, "best", "state.pt"),
            os.path.join(model_dir, "best", "meta.json"),
            os.path.join(model_dir, "epoch_0", "state.pt"),
            os.path.join(log_dir, f"{config_name}_0.json"),
            os.path.join(model_dir, "report", "dataset_summary.csv"),
            os.path.join(model_dir, "report", "ACDC", "iter_1_detailed.csv")]
    missing = [p for p in need if not os.path.exists(p)]
    events = [f for f in os.listdir(log_dir) if f.startswith("events.out.tfevents.")]
    if missing or not events:
        fail(f"train_cli: missing from the run directory: {missing or 'the event file'}")
    with open(os.path.join(log_dir, f"{config_name}_0.json")) as f:
        history = json.load(f)
    ious = [h["val_iou"] for h in history]
    with open(os.path.join(model_dir, "report", "dataset_summary.csv")) as f:
        summary = f.read().splitlines()
    print(f"train_cli: {probe.steps} steps in {n_epochs} epochs, validation mIoU {ious}, "
          f"train.main {cli_s:.1f} s; dataset_summary.csv: {len(summary) - 1} row(s) of "
          f"{len(summary[0].split(','))} columns, first fields {summary[-1].split(',')[:3]}")
    if len(ious) != n_epochs or not all(math.isfinite(v) for v in ious):
        fail(f"train_cli: validation mIoU {ious} is not one finite value an epoch")
    if len(summary) != 2 or not summary[1].startswith("ACDC,"):
        fail(f"train_cli: dataset_summary.csv should hold one ACDC row, got {summary}")

    # launches: a step's, plus a validation batch's, and none in the evaluation
    steps = n_epochs * steps_per_epoch
    print(f"train_cli: launches over {steps} steps and {n_epochs * val_batches} validation "
          f"batches {json.dumps(launches)}; during the evaluation "
          f"{json.dumps(probe.eval_launches)}")
    if probe.steps != steps:
        fail(f"train_cli ran {probe.steps} steps, expected {steps}")
    for name in KERNELS:
        want = (PER_STEP["train_cli"].get(name, 0) * steps
                + PER_VAL_BATCH.get(name, 0) * n_epochs * val_batches)
        if launches[name] != want:
            fail(f"train_cli: {name} launched {launches[name]} times, expected {want}")
    if probe.eval_launches is None or any(probe.eval_launches.values()):
        fail(f"train_cli: the evaluation launched port kernels: {probe.eval_launches}")

    # best, reloaded into a fresh solver, against the state it was saved from
    val_set = train.build_datasets(cfg, "10", 0)[1]
    raw = train.to_device(next(iter(HostBatchLoader(val_set, batch, drop_last=False,
                                                     shuffle=False))), torch.device("cuda"))
    x, _ = A.norm_batch(raw["image"], raw["label"], cfg.crop_hw)
    fresh = config_solver(cfg, "cuda")
    kept = fresh.init_state(0)
    for k, sd in probe.best_copy.items():
        kept.modules[k].load_state_dict(sd, strict=True)
    loaded, meta = ckpt.load_checkpoint(model_dir, "best", fresh.init_state(0))
    a, b = fresh.predict(kept.modules, x), fresh.predict(loaded.modules, x)
    same = torch.equal(a, b) and torch.equal(a.argmax(-1), b.argmax(-1))
    print(f"train_cli: best (epoch {meta['epoch']}, mIoU {meta['best_score']:.4f}) reloaded: "
          f"logits on a validation batch {tuple(a.shape)} bit-equal {same}")
    if not same:
        fail("train_cli: the reloaded best checkpoint predicts otherwise than the saved state")

    # the inference CLI on the OOD suite
    kernels.reset_launches()
    out_dir = os.path.join(tmp, "predictions")
    infer.main(["--json_config_path", cfg_path, "--ckpt_dir", model_dir, "--ckpt", "best",
                "--input_dir", os.path.join(tmp, "ACDC"), "--out_dir", out_dir,
                "--uncertainty"])
    outs = sorted(os.listdir(out_dir))
    want_outs = sorted(f"patient{i:03d}_{kind}.nrrd" for i in range(ACDC_TREE["ood_patients"])
                       for kind in ("pred", "entropy"))
    if outs != want_outs or any(kernels.LAUNCHES.values()):
        fail(f"train_cli: inference wrote {outs} and launched {dict(kernels.LAUNCHES)}")
    print(f"train_cli: inference wrote {len(outs)} files, no port kernel launched")

    # the second epoch against the flagship path on the same config
    cli_rate = steps_per_epoch / probe.epoch2_s
    cli_syncs = len(probe.syncs) / steps_per_epoch
    solver = config_solver(cfg, "cuda")
    flag_rate, _, _ = measure_throughput(solver, k_inner=K_INNER, n_calls=2, n_repeats=2)
    flag_syncs, flag_where = _flagship_syncs(solver)
    where = {k: probe.syncs.count(k) for k in sorted(set(probe.syncs))}
    print(f"train_cli: second epoch {cli_rate:.4f} steps/s, {cli_syncs:.2f} host syncs a step "
          f"(at {where}); measure_throughput on the same config {flag_rate:.4f} steps/s "
          f"(median of 2 rounds of 2 calls x {K_INNER} steps), flagship step "
          f"{flag_syncs:.2f} host syncs a step (at {flag_where}); on {smi}; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    if cli_syncs > flag_syncs:
        fail(f"train_cli: {cli_syncs} host syncs a step, more than the flagship step's "
             f"{flag_syncs}")
    return launches, flag_rate, flag_syncs


def phase_device_resident(smi: str, tmp: str, flag_rate: float, flag_syncs: float):
    """The device-resident loop (phase 10): the synthetic tree's training
    split uploaded to the card once, then one warm-up call, one call whose
    host syncs are counted, and 3 timed calls without instrumentation, each
    of K_INNER steps of ``make_device_train_loop`` on the train_cli config."""
    import torch
    from maxstyle_tpu_torch import kernels, train
    from maxstyle_tpu_torch.data.device_data import DeviceDataset, make_device_train_loop
    from maxstyle_tpu_torch.flagship import config_solver, workload_policy
    from maxstyle_tpu_torch.profile_slice import host_syncs

    t_phase = time.perf_counter()
    _, cfg = _acdc_config(tmp, tmp, TRAIN_CLI_CHANGES)
    solver = config_solver(cfg, "cuda")
    train_set = train.build_datasets(cfg, "10", 0)[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = DeviceDataset.from_slice_dataset(train_set, device="cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    run = make_device_train_loop(solver, workload_policy(cfg),
                                 cfg.data.keep_orig_image_label_pair_for_training,
                                 half_batch=cfg.train_batch_size, steps_per_call=K_INNER)
    state = solver.init_state(0)
    w0 = {k: p.detach().clone() for k, p in state.modules.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(21)
    kernels.reset_launches()
    state, metrics = run(state, data.images, data.labels, gen)
    results = []
    syncs = host_syncs(lambda: results.append(run(state, data.images, data.labels, gen)))
    state, metrics = results[-1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        state, metrics = run(state, data.images, data.labels, gen)
    torch.cuda.synchronize()
    rate = 3 * K_INNER / (time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    steps = state.step
    last = {k: float(v) for k, v in metrics.items()}
    changed = sum(not torch.equal(w0[k], p) for k, p in state.modules.named_parameters())
    per_step = sum(syncs.values()) / K_INNER
    print(f"device_resident: {len(data)} slices {tuple(data.images.shape[1:])} resident, "
          f"{data.nbytes} bytes, uploaded in {upload_s:.2f} s; metrics of the last call "
          f"{json.dumps(last)}")
    print(f"device_resident: launches over {steps} steps {json.dumps(launches)}; "
          f"{changed} of {len(w0)} parameter tensors changed")
    print(f"device_resident: {rate:.4f} steps/s (3 calls x {K_INNER} steps after a warm-up "
          f"call and the call counting syncs) against measure_throughput's {flag_rate:.4f} on the same config; "
          f"{per_step:.2f} host syncs a step (at {dict(syncs)}) against the flagship step's "
          f"{flag_syncs:.2f}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"on {smi}; phase {time.perf_counter() - t_phase:.1f} s")
    if steps != 5 * K_INNER:
        fail(f"device_resident ran {steps} steps, expected {5 * K_INNER}")
    if not all(math.isfinite(v) for v in last.values()) or last["loss/hard/total"] == 0.0:
        fail(f"device_resident: non-finite or missing losses {last}")
    if changed != len(w0):
        fail(f"device_resident: only {changed} of {len(w0)} parameter tensors changed")
    for name in KERNELS:
        want = PER_STEP["device_resident"].get(name, 0) * steps
        if launches[name] != want:
            fail(f"device_resident: {name} launched {launches[name]} times over {steps} "
                 f"steps, expected {want}")
    if per_step > flag_syncs:
        fail(f"device_resident: {per_step} host syncs a step, more than the flagship step's "
             f"{flag_syncs}")
    return launches


def _reference_state_dicts(seed: int, num_classes: int, r: int = 4, latent: int = 128):
    """Seeded state dicts in the reference's naming (Dual_Branch_Encoder,
    MyDecoder with NN up for the segmentation and Conv2 up for the image),
    with num_batches_tracked buffers, built as
    tests/test_torch_import_encoder.py builds them: conv weights and biases
    0.1 N(0,1), BatchNorm scales |0.1 N(0,1)| + 0.5, running variances
    likewise, biases and means 0.1 N(0,1)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.1)

    def bn(sd, name, c):
        sd[f"{name}.weight"] = rnd(c).abs() + 0.5
        sd[f"{name}.bias"] = rnd(c)
        sd[f"{name}.running_mean"] = rnd(c)
        sd[f"{name}.running_var"] = rnd(c).abs() + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(1000)

    def conv(sd, name, cin, cout, k, bias=True):
        sd[f"{name}.weight"] = rnd(cout, cin, k, k)
        if bias:
            sd[f"{name}.bias"] = rnd(cout)

    enc = {}
    chans = [64 // r, 128 // r, 256 // r, 512 // r, 512 // r]
    conv(enc, "general_encoder.inc.0", 1, chans[0], 3)
    bn(enc, "general_encoder.inc.1", chans[0])
    conv(enc, "general_encoder.inc.3", chans[0], chans[0], 3)
    bn(enc, "general_encoder.inc.4", chans[0])
    cin = chans[0]
    for i, cout in enumerate(chans[1:], start=1):
        q = f"general_encoder.down{i}"
        conv(enc, f"{q}.down", cin, cin, 3)
        conv(enc, f"{q}.conv.0", cin, cout, 3)
        bn(enc, f"{q}.conv.1", cout)
        conv(enc, f"{q}.conv.3", cout, cout, 3)
        bn(enc, f"{q}.conv.4", cout)
        conv(enc, f"{q}.conv_input", cin, cout, 1)
        cin = cout
    conv(enc, "general_encoder.final_conv.0", cin, latent, 1)
    bn(enc, "general_encoder.final_conv.1", latent)
    for i in (0, 3):
        conv(enc, f"code_decoupler.{i}", latent, latent, 3, bias=False)
        bn(enc, f"code_decoupler.{i + 1}", latent)

    def decoder(up_type, out_ch):
        sd = {}
        dchans = [latent, 256 // r, 128 // r, 64 // r, 64 // r]
        for i in range(1, 5):
            cin, cout = dchans[i - 1], dchans[i]
            if up_type == "Conv2":
                sd[f"up{i}.up.weight"] = rnd(cin, cin, 2, 2)
                sd[f"up{i}.up.bias"] = rnd(cin)
            conv(sd, f"up{i}.conv.0", cin, cout, 3)
            bn(sd, f"up{i}.conv.1", cout)
            conv(sd, f"up{i}.conv.3", cout, cout, 3)
            bn(sd, f"up{i}.conv.4", cout)
            conv(sd, f"up{i}.conv_input", cin, cout, 1)
        conv(sd, "final_conv", dchans[4], out_ch, 1)
        return sd

    return {"image_encoder": enc, "segmentation_decoder": decoder("NN", num_classes),
            "image_decoder": decoder("Conv2", 1)}


def _tensor_multiset(tensors):
    """Sorted (shape, bytes) of each tensor: equal multisets mean every
    tensor arrived with its bits, wherever it went."""
    return sorted((tuple(t.shape), t.detach().cpu().contiguous().numpy().tobytes())
                  for t in tensors)


def phase_reference_import(smi: str, tmp: str):
    """Reference-format .pth files through the training CLI, the inference
    CLI and the style demo, then an artefacted OOD suite generated and
    evaluated with top-k panels (phase 11)."""
    import os

    import torch
    from maxstyle_tpu_torch import demo_generate_styles, evaluate, infer, kernels, train
    from maxstyle_tpu_torch.data import artefacts
    from maxstyle_tpu_torch.flagship import config_solver
    from maxstyle_tpu_torch.metrics import table_columns
    from maxstyle_tpu_torch.utils.torch_import import (import_module_checkpoint,
                                                       import_module_checkpoints)
    from maxstyle_tpu_torch.utils.visualize import read_png

    t_phase = time.perf_counter()
    work = os.path.join(tmp, "reference_import")
    ref = os.path.join(work, "pth")
    os.makedirs(ref)
    cfg_path, cfg = _acdc_config(tmp, work, REFERENCE_IMPORT_CHANGES)
    files = _reference_state_dicts(seed=31, num_classes=cfg.segmentation_model.num_classes)
    for name, sd in files.items():
        torch.save(sd, os.path.join(ref, f"{name}.pth"))
    total = {k: 0 for k in KERNELS}

    def launched(what, want_per, times):
        got = dict(kernels.LAUNCHES)
        for k in KERNELS:
            total[k] += got[k]
        print(f"reference_import: {what}: launches {json.dumps(got)}")
        for k in KERNELS:
            want = sum(per.get(k, 0) * n for per, n in zip(want_per, times))
            if got[k] != want:
                fail(f"reference_import: {what}: {k} launched {got[k]} times, expected {want}")

    # 1. the training CLI, from the files' weights
    first = {}
    factory = train.make_fused_train_step

    def probed_factory(*a, **kw):
        step = factory(*a, **kw)

        def probed(state, *sa, **skw):
            if not first:
                first.update({k: {n: t.detach().clone() for n, t in m.state_dict().items()}
                              for k, m in state.modules.items()})
            return step(state, *sa, **skw)
        return probed

    train.make_fused_train_step = probed_factory
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        train.main(["--json_config_path", cfg_path, "--save_dir", os.path.join(work, "saved"),
                    "--data_setting", "10", "--cval", "0", "--seed", "1",
                    "--torch_ckpt_dir", ref])
    finally:
        train.make_fused_train_step = factory
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_set, val_set = train.build_datasets(cfg, "10", 0)
    n_train = len(train_set) // cfg.train_batch_size
    n_val = -(-len(val_set) // cfg.learning.batch_size)
    launched(f"train.main --torch_ckpt_dir, 1 epoch ({train_s:.1f} s)",
             [PER_STEP["slice"], PER_VAL_BATCH], [n_train, n_val])
    bad = []
    for name, sd in files.items():
        want = import_module_checkpoint(os.path.join(ref, f"{name}.pth"), name)
        got = first[name]
        if set(got) != set(want) or not all(torch.equal(got[k].cpu(), want[k]) for k in want):
            bad.append(f"{name} (mapped)")
        plain = [t for k, t in sd.items() if not k.endswith("num_batches_tracked")]
        if _tensor_multiset(plain) != _tensor_multiset(got.values()):
            bad.append(f"{name} (tensor bits)")
    flips = [i for i in range(1, 5)
             if not torch.equal(first["image_decoder"][f"up{i}.up.conv.weight"].cpu(),
                                files["image_decoder"][f"up{i}.up.weight"])]
    print(f"reference_import: weights before step 1 equal the files' tensors bit for bit: "
          f"{not bad} {bad}; transposed convs unflipped: {not flips}")
    if bad or flips:
        fail(f"reference_import: imported weights differ from the files: {bad}, up{flips}")

    # 2. the inference CLI
    kernels.reset_launches()
    out_dir = os.path.join(work, "predictions")
    infer.main(["--json_config_path", cfg_path, "--torch_ckpt_dir", ref,
                "--input_dir", os.path.join(tmp, "ACDC"), "--out_dir", out_dir])
    outs = sorted(os.listdir(out_dir))
    launched("infer.main --torch_ckpt_dir", [], [])
    if len(outs) != ACDC_TREE["ood_patients"]:
        fail(f"reference_import: inference wrote {outs}")

    # 3. the style demo: two generation calls through the adversarial loop
    kernels.reset_launches()
    png = os.path.join(work, "maxstyle_samples.png")
    demo_generate_styles.main(["--torch_ckpt_dir", ref, "--image", "none", "--crop", "192",
                               "--n_samples", "8", "--n_iter", "5", "--out", png])
    torch.cuda.synchronize()
    launched("demo_generate_styles --n_iter 5, 2 generation calls", [PER_GENERATION], [2])
    pix, text = read_png(png)
    print(f"reference_import: demo grid {pix.shape} decoded, titles {sorted(set(text.values()))}")
    if pix.shape != (4 * 192, 4 * 192, 3) or not pix.any():
        fail(f"reference_import: the demo's PNG is {pix.shape}")

    # 4. an artefacted OOD suite, generated on the host, then evaluated with panels
    solver = config_solver(cfg, "cuda")
    kernels.reset_launches()
    suites = os.path.join(work, "ood")
    t0 = time.perf_counter()
    artefacts.main(["--root_dir", os.path.join(tmp, "ACDC"), "--out_root", suites,
                    "--artefact", "all", "--crop", *map(str, cfg.crop_hw), "--repeats", "1"])
    art_s = time.perf_counter() - t0
    state = solver.init_state(0)
    import_module_checkpoints(state.modules, ref, solver.spec)
    report = os.path.join(work, "report")
    t0 = time.perf_counter()
    means, _, rows = evaluate.evaluate(solver, state, "RandomMotion", suites,
                                       crop_hw=cfg.crop_hw, new_spacing=cfg.data.new_spacing,
                                       save_report_dir=report, save_top_k=2)
    eval_s = time.perf_counter() - t0
    launched("artefacts.main + evaluate(save_top_k=2)", [], [])
    panels = sorted(d for d in os.listdir(report) if os.path.isdir(os.path.join(report, d)))
    shapes = [read_png(os.path.join(report, d, "Seg_plots.png"))[0].shape for d in panels]
    csvs = sorted(f for f in os.listdir(report) if f.endswith(".csv"))
    dice = {c: round(m, 4) for c, m in zip(table_columns(rows)[1:], means) if c.endswith("Dice")}
    print(f"reference_import: artefacts.main wrote {sorted(os.listdir(suites))} in "
          f"{art_s:.1f} s; evaluate on RandomMotion ({len(rows)} volumes, {eval_s:.1f} s): "
          f"mean Dice {dice}, panels {panels} of {shapes}, {csvs}")
    if len(panels) != 4 or [p.split("_")[0] for p in panels] != ["top1", "top2", "worst1",
                                                                  "worst2"]:
        fail(f"reference_import: expected 4 top-k panels, got {panels}")
    if csvs != ["iter_1_detailed.csv", "iter_1_summary.csv"]:
        fail(f"reference_import: report CSV files {csvs}")
    print(f"reference_import: on {smi}; phase {time.perf_counter() - t_phase:.1f} s")
    return total


def main():
    t_start = time.perf_counter()
    try:
        import torch
        import maxstyle_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable beside this script: {e}")
    from maxstyle_tpu_torch.flagship import WORKLOADS, flagship_solver, prostate_cubic_solver

    name, smi = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_reference()
    paths = {
        "slice": phase_train("slice", flagship_solver(hw=192, batch=20, device="cuda"), smi,
                             "headline, effective batch 20 @192^2"),
        "slice_prostate_cubic": phase_train(
            "slice_prostate_cubic", prostate_cubic_solver(device="cuda"), smi,
            "Prostate cubic, effective batch 20 @224^2"),
        "conv_bn_fusion": phase_conv_bn_fusion(),
    }
    for path, (workload, channel) in BRANCH_PATHS.items():
        solver = WORKLOADS[workload](device="cuda")
        hw = solver.config.crop_hw[0]
        paths[path] = phase_train(path, solver, smi,
                                  f"{workload}, effective batch "
                                  f"{solver.config.learning.batch_size} @{hw}^2",
                                  rounds=1, channel=channel)
        del solver
    import os
    import shutil
    import tempfile
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="acdc_tree_", dir=build)
    try:
        train_pids, val_pids = _write_acdc_tree(tmp)
        paths["train_cli"], flag_rate, flag_syncs = phase_train_cli(smi, tmp, train_pids,
                                                                    val_pids)
        paths["device_resident"] = phase_device_resident(smi, tmp, flag_rate, flag_syncs)
        paths["reference_import"] = phase_reference_import(smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    out = []
    for kname, row in rows.items():
        shapes = row.pop("shapes")
        # a MaxStyle row sums one styled decode of the headline cell (its
        # three hook shapes); the other rows sum their own shapes
        main = [s for s in shapes if s["cell"] != "prostate"]

        def total(key):
            vals = [s[key] for s in main]
            return None if any(v is None for v in vals) else sum(vals)

        out.append({**row, "launches": paths[LAUNCH_PATH[kname]][kname],
                    "launches_by_path": {p: n[kname] for p, n in paths.items()},
                    "max_abs_err": max(s["max_abs_err"] for s in shapes),
                    "ms": total("ms"), "plain_ms": total("plain_ms"),
                    "bound_ms": total("bound_ms"), "bound_by": _row_bound_by(main),
                    "library_ms": total("library_ms"), "shapes": shapes})
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
