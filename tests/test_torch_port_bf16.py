"""The bf16 compute policy of the port against the JAX package's.

Policy (the properties of tests/test_dtype.py, on the port): with
``learning.compute_dtype="bfloat16"`` activations are bf16 while the
weights, the optimizer's moments and the BatchNorm statistics stay float32;
the forward emits bf16; every loss is float32; "auto" resolves to float32
off a TPU; an unknown dtype raises ValueError.

Parity. bf16 rounds every activation to 8 bits of mantissa, so the port and
JAX cannot agree bit for bit, nor even to a fixed tolerance: which pixels
and which gradient elements round the other way differs between two
correct implementations. Both are therefore held against one float64
reference, and the port's distance from it is bounded by JAX's own:

    dist(port bf16, ref) <= BAR_FACTOR * dist(JAX bf16, ref) + FLOOR * scale

with ``dist`` the largest absolute difference and ``scale`` the largest
absolute value of the reference's output (a loss, a module's gradients or
its BatchNorm statistics). The reference is the port in float64 (float32
policy, float64 weights and activations, the losses in float32 as in both
packages), given the same weights and the same draws: earlier slices' tests
hold that path against JAX at float32 (tests/test_torch_port_train_step.py
and the family and branch step tests), and JAX's own float64 run would draw
other random numbers (``jax.random`` draws in the default float dtype).
Weights are JAX's seed-0 float32 init, converted by ``convert.py``;
gradients are read from JAX's AdamW first moment (m = 0.1 g after one
step) and from the port's ``.grad``. AdamW's first step is ~lr*sign(g), so
the weights after it say little more than the gradients' signs: the
gradients are compared instead.

The forward (``predict``, eval mode, the STN's refinement with n_iter=2) is
held at the same bar, and its argmax agrees with the reference's on at
least ARGMAX_AGREEMENT (99%) of the pixels, as tests/test_dtype.py holds
JAX's bf16 against its float32; or, where JAX's own bf16 agreement is lower,
the port misses at most BAR_FACTOR times as many pixels as JAX. That is
DS_FCN at init (JAX 0.961, port 0.956): its eval-mode spectral norm divides
by u.Wv of the initial random u and v, with no power iteration, and the
logits run up to 41.

The step tests of the five families are test_torch_port_bf16_steps.py's,
those of the seven branch flags test_torch_port_bf16_branches.py's.

Measured on the CPU (ratio = dist(port) / dist(JAX); "of bar" = dist(port)
/ bar). Logits: ratio 0.87-1.58, at most 0.39 of the bar; argmax agreement
0.956 (DS_FCN), 0.990-0.998 elsewhere. Steps, over the five families and
the seven branch flags: gradients
ratio <= 1.50, statistics <= 1.87, both within 0.45 of the bar. Loss terms
ratio <= 2 but for the reconstruction losses and the STN's shape loss,
which the port rounds once more than XLA's fused bf16 ops do (conv, bias
and activation are one rounding there): ratio up to 21 (FCN_16_standard's
hard-example image loss, 1.1e-4 of 3.3e-2, 0.73 of the bar, carried by the
floor). The totals are sums of held terms, and whether their errors cancel
is chance (FCN_16_standard's hard total: JAX's seg and shape errors cancel,
the port's add), so they are not held on their own.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.config import (DataConfig, ExperimentConfig, LearningConfig,
                                 MaxStyleConfig, SegmentationModelConfig)
from maxstyle_tpu.data import augment as JA
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu.train_step import make_train_step as j_make_train_step
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver
from maxstyle_tpu_torch.train_step import LOSS_KEYS, make_train_step
from tests.test_torch_port_grad_bars import torch_default_dtype
from tests.test_torch_port_train_step import (CROP, HALF, LR, PAD, jax_styles, port_styles,
                                              style_values, to_np)

torch.set_num_threads(2)

N = 2 * HALF
BAR_FACTOR = 4.0
FLOOR = 2.0 ** -8
ARGMAX_AGREEMENT = 0.99
FAMILIES = ("FCN_16_standard_no_STN", "FCN_16_standard", "DS_FCN_16_standard",
            "Unet_16_Unet_im_recon_no_STN", "UnetTransformer_16_no_STN")


def config(network_type="FCN_16_standard_no_STN", compute_dtype="bfloat16", **learning):
    """hw 32 (40^2 pads), effective batch 4, 4 classes, AdamW, MaxStyle
    n_iter=2 at hooks 3, 4, 5 (on unless ``learning`` says otherwise)."""
    learning = {"max_style": True, **learning}
    return ExperimentConfig(
        data=DataConfig(crop_size=(CROP, CROP, 1), pad_size=(PAD, PAD, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(network_type=network_type, num_classes=4),
        learning=LearningConfig(lr=LR, batch_size=N, optimizer_type="AdamW",
                                compute_dtype=compute_dtype, **learning),
        max_style=MaxStyleConfig(n_iter=2, decoder_layers_indexes=(3, 4, 5)))


def with_dtype(cfg, compute_dtype):
    return dataclasses.replace(cfg, learning=dataclasses.replace(cfg.learning,
                                                                 compute_dtype=compute_dtype))


@functools.lru_cache(maxsize=1)
def batch():
    """(image [N,H,W,1], label [N,H,W], noisy image): two augmented slices
    and their center-cropped originals, and the pinned input noise."""
    rng = np.random.RandomState(0)
    raw_img = np.clip(0.5 + 0.25 * rng.randn(HALF, PAD, PAD), 0, 1).astype(np.float32)
    raw_lab = rng.randint(0, 4, (HALF, PAD, PAD)).astype(np.int32)
    policy = JA.get_policy("ACDC_affine_elastic_intensity", (PAD, PAD), (CROP, CROP))
    aug_i, aug_l = JA.augment_batch_inner(jax.random.key(1), jnp.asarray(raw_img),
                                          jnp.asarray(raw_lab), policy)
    org_i, org_l = JA.norm_batch(jnp.asarray(raw_img), jnp.asarray(raw_lab), (CROP, CROP))
    image = np.concatenate([np.asarray(aug_i), np.asarray(org_i)])
    label = np.concatenate([np.asarray(aug_l), np.asarray(org_l)]).astype(np.int32)
    noise = 0.05 * np.random.RandomState(2).randn(*image.shape).astype(np.float32)
    image_n = np.clip(image + noise, image.min(), image.max()).astype(np.float32)
    return image, label, image_n


def _float64(sds):
    return {n: {k: v.double() for k, v in sd.items()} for n, sd in sds.items()}


def port_state(cfg, params, stats, dtype):
    """The port's solver of ``cfg`` and a state from the converted weights;
    with ``dtype`` float64 the modules are a float64 copy under the float32
    policy (the reference)."""
    if dtype == torch.float64:
        cfg = with_dtype(cfg, "float32")
    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    state = ts.init_state(state_dicts=convert.convert_train_state(params, stats))
    if dtype == torch.float64:
        state.modules.to(dtype)
    return ts, state


def jax_adam_grads(opt_states):
    """{module: gradient tree} from optax AdamW's first moment after one
    step (m = (1 - b1) g, b1 = 0.9)."""
    out = {}
    for name, st in opt_states.items():
        adam = [s for s in jax.tree_util.tree_leaves(st, is_leaf=lambda s: hasattr(s, "mu"))
                if hasattr(s, "mu")][0]
        out[name] = jax.tree_util.tree_map(lambda m: np.asarray(m, np.float64) / 0.1, adam.mu)
    return out


def jax_bf16_step(cfg, step_key=3):
    """One JAX step of ``cfg`` (bf16) from its seed-0 weights on the test's
    batch, with the noisy input and, under MaxStyle, the style draws pinned."""
    solver = JSolver(cfg, maxstyle_backend="jnp")
    state = solver.init_state(jax.random.key(0), (CROP, CROP), batch_size=N)
    params0, stats0 = to_np(state.params), to_np(state.batch_stats)  # the step donates state
    image, label, image_n = batch()
    ov = {"image_n": jnp.asarray(image_n)}
    if cfg.learning.max_style:
        ov["style_init"] = jax_styles(style_values())
    key = jax.random.key(step_key)
    new_state, metrics = j_make_train_step(solver)(
        state, {"image": jnp.asarray(image), "label": jnp.asarray(label)}, key, overrides=ov)
    grads = convert.convert_train_state(jax_adam_grads(new_state.opt_states), {})
    return dict(cfg=cfg, key=key, params0=params0, stats0=stats0, image_n=image_n,
                metrics={k: float(v) for k, v in metrics.items()},
                grads={n: {k: v.double() for k, v in g.items()} for n, g in grads.items()},
                stats=_float64(convert.convert_train_state(to_np(new_state.params),
                                                           to_np(new_state.batch_stats))))


def port_step(r, dtype, branch_draws=None):
    """The port's step on ``jax_bf16_step``'s batch, weights and draws, in
    bf16 or as the float64 reference: (metrics, {module: grads}, {module:
    state dict}), all float64."""
    ts, state = port_state(r["cfg"], r["params0"], r["stats0"], dtype)
    image, label, image_n = batch()
    ov = {"image_n": torch.from_numpy(image_n)}
    if r["cfg"].learning.max_style:
        ov["style_init"] = port_styles(style_values())
    if branch_draws is not None:
        ov["branch_draws"] = branch_draws
    with torch_default_dtype(torch.float64 if dtype == torch.float64 else torch.float32):
        state, m = make_train_step(ts)(state, {"image": torch.from_numpy(image),
                                               "label": torch.from_numpy(label)},
                                       torch.Generator().manual_seed(0), overrides=ov)
    grads = {n: {k: p.grad.double() for k, p in mod.named_parameters()}
             for n, mod in state.modules.items()}
    sds = {n: {k: v.double() for k, v in mod.state_dict().items()}
           for n, mod in state.modules.items()}
    return {k: float(v) for k, v in m.items()}, grads, sds


def _dist(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in b)


def _scale(t):
    return max(float(v.abs().max()) for v in t.values())


def assert_within_bar(what, port_d, jax_d, scale, record):
    bar = BAR_FACTOR * jax_d + FLOOR * scale
    record.append((what, port_d, jax_d, scale))
    assert port_d <= bar, (f"{what}: port bf16 {port_d:.3e} from the float64 reference, JAX "
                           f"bf16 {jax_d:.3e}, bar {bar:.3e}")


def assert_step_matches(r, branch_draws=None):
    """The port's bf16 step against the float64 reference, within the bar
    of JAX's bf16 step: every loss, each module's gradients and BatchNorm
    statistics (and spectral-norm vectors). Returns the measured rows."""
    m16, g16, s16 = port_step(r, torch.bfloat16, branch_draws)
    m64, g64, s64 = port_step(r, torch.float64, branch_draws)
    record = []
    assert all(np.isfinite(v) for v in m16.values())
    for key in LOSS_KEYS:
        if key.endswith("/total"):
            continue  # a sum of held terms, whose errors cancel or add by chance
        assert_within_bar(key, abs(m16[key] - m64[key]), abs(r["metrics"][key] - m64[key]),
                          abs(m64[key]), record)
    for name, ref in g64.items():
        assert_within_bar(f"{name} gradients", _dist(g16[name], ref),
                          _dist(r["grads"][name], ref), _scale(ref), record)
        keys = [k for k in s64[name] if k.endswith(("running_mean", "running_var", ".u", ".v"))]
        if keys:
            ref_s = {k: s64[name][k] for k in keys}
            assert_within_bar(f"{name} statistics", _dist(s16[name], ref_s),
                              _dist(r["stats"][name], ref_s), _scale(ref_s), record)
    return record


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


def _solver(compute_dtype, **learning):
    return TSolver(tconfig.ExperimentConfig.from_dict(
        dataclasses.asdict(config(compute_dtype=compute_dtype, **learning))), device="cpu")


def _tiny_batch():
    g = torch.Generator().manual_seed(1)
    return {"image": torch.clamp(0.5 + 0.2 * torch.randn((N, CROP, CROP, 1), generator=g), 0, 1),
            "label": torch.randint(0, 4, (N, CROP, CROP), generator=g)}


def test_bf16_keeps_master_state_f32():
    solver = _solver("bfloat16")
    assert solver.compute_dtype == torch.bfloat16
    state = solver.init_state(0)
    for t in list(state.modules.parameters()) + list(state.modules.buffers()):
        assert t.dtype == torch.float32


def test_bf16_forward_emits_bf16():
    solver = _solver("bfloat16")
    state = solver.init_state(0)
    pred = solver.predict(state.modules, torch.zeros((N, CROP, CROP, 1)))
    assert pred.dtype == torch.bfloat16 and pred.shape == (N, CROP, CROP, 4)


def test_bf16_full_maxstyle_step_finite_and_state_stays_f32():
    solver = _solver("bfloat16")
    state = solver.init_state(0)
    state, metrics = make_train_step(solver)(state, _tiny_batch(), torch.Generator().manual_seed(3))
    assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics
    assert all(v.dtype == torch.float32 for v in metrics.values())
    for t in list(state.modules.parameters()) + list(state.modules.buffers()):
        assert t.dtype == torch.float32
    for opt in state.optimizers.values():
        for st in opt.state.values():
            assert all(v.dtype == torch.float32 for v in st.values() if v.is_floating_point())


@pytest.mark.parametrize("name", ["auto", "float32", "f32"])
def test_auto_and_f32_resolve_to_float32(name):
    assert _solver(name).compute_dtype == torch.float32


def test_bf16_aliases_resolve_to_bfloat16():
    assert _solver("bf16").compute_dtype == _solver("bfloat16").compute_dtype == torch.bfloat16


def test_unknown_dtype_rejected():
    with pytest.raises(ValueError):
        _solver("float16")


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


def argmax_agreement(a, b):
    return float((a.argmax(-1) == b.argmax(-1)).double().mean())


@pytest.mark.parametrize("network_type", FAMILIES)
def test_bf16_forward_matches_jax_within_bar(network_type):
    """``predict`` (eval mode; with the STN, its refinement, n_iter=2) from
    the seed-0 weights: the logits within the bar, and their argmax."""
    cfg = config(network_type)
    solver = JSolver(cfg, maxstyle_backend="jnp")
    state = solver.init_state(jax.random.key(0), (CROP, CROP), batch_size=N)
    image = batch()[0]
    n_iter = 2 if solver.spec.has_stn else 1
    want16 = solver.predict(state.params, state.batch_stats, jnp.asarray(image), n_iter=n_iter)
    assert want16.dtype == jnp.bfloat16
    params, stats = to_np(state.params), to_np(state.batch_stats)
    out = {}
    for dtype in (torch.bfloat16, torch.float64):
        ts, st = port_state(cfg, params, stats, dtype)
        out[dtype] = ts.predict(st.modules, torch.from_numpy(image), n_iter=n_iter)
    assert out[torch.bfloat16].dtype == torch.bfloat16
    ref = out[torch.float64]
    got = out[torch.bfloat16].double()
    jax16 = torch.from_numpy(np.asarray(want16, np.float64))
    assert_within_bar("logits", float((got - ref).abs().max()), float((jax16 - ref).abs().max()),
                      float(ref.abs().max()), [])
    missed = 1.0 - argmax_agreement(got, ref)
    assert missed <= max(1.0 - ARGMAX_AGREEMENT, BAR_FACTOR * (1.0 - argmax_agreement(jax16, ref)))

