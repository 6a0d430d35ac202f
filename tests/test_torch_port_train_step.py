"""One full MaxStyle training step of the port against the JAX package's.

JAX builds the batch (half-batch 2 augmented by ``augment_batch_inner``
with the Pallas warp, plus the center-cropped originals; 40^2 pads, 32^2
crops) and runs one ``make_train_step`` step with the Pallas MaxStyle op and
n_iter=5. The port runs its ``make_train_step`` on the same batch from the
converted weights. Both sides get the same draws through ``overrides``:
the noisy input ``image_n`` and the style parameters/state ``style_init``.

Compared, with these tolerances:

* the standard losses: rtol 1e-4 (one forward, as in test_torch_port_model);
* the hard-example losses and the total: rtol 2e-3. The stylized image
  comes out of five Adam(0.1) steps, whose updates lr*m/(sqrt(v)+eps) scale
  small gradient differences up (the JAX package's own reference test
  measured a self-drift of ~1e-2 at five steps when the input moves by
  1e-6); the measured gap here is 1.9e-4;
* the weights after AdamW: every element within the sign-flip bound
  2.1*lr + 1e-6 (the first Adam step is ~lr*sign(g), and a gradient of
  rounding-noise size can flip sign), and the update direction of each
  module with cosine > 0.95 against JAX's. At 32^2 the encoder's deepest
  layers see 2x2 and 4x4 maps, so many of their weights' gradients are sums
  of a few terms near the rounding floor: 1.6% of the encoder's weights
  step the other way (cosine 0.967, measured). A composition or optimizer
  fault would decorrelate the whole update instead;
* the BatchNorm running statistics (and a spectral-norm conv's power
  iteration vectors u and v): rtol 1e-4 / atol 5e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.config import (DataConfig, ExperimentConfig, LearningConfig,
                                 MaxStyleConfig, SegmentationModelConfig)
from maxstyle_tpu.data import augment as JA
from maxstyle_tpu.ops import maxstyle as jms
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu.train_step import LOSS_KEYS as J_LOSS_KEYS
from maxstyle_tpu.train_step import make_train_step as j_make_train_step
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.data import augment as TA
from maxstyle_tpu_torch.ops import maxstyle as tms
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver
from maxstyle_tpu_torch.train_step import LOSS_KEYS, make_multi_step, make_train_step

torch.set_num_threads(2)

PAD, CROP, HALF = 40, 32, 2
LR = 1e-4
INDEXES = (3, 4, 5)
CHANNELS = {3: 16, 4: 16, 5: 1}


def config(n_iter=5):
    return ExperimentConfig(
        data=DataConfig(crop_size=(CROP, CROP, 1), pad_size=(PAD, PAD, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(
            network_type="FCN_16_standard_no_STN", num_classes=4),
        learning=LearningConfig(lr=LR, batch_size=2 * HALF, optimizer_type="AdamW",
                                max_style=True),
        max_style=MaxStyleConfig(n_iter=n_iter, decoder_layers_indexes=INDEXES))


def to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def style_values(seed=7):
    rng = np.random.RandomState(seed)
    n = 2 * HALF
    out = {}
    for idx in INDEXES:
        c = CHANNELS[idx]
        out[idx] = dict(lmda=rng.rand(n, 1, 1, 1).astype(np.float32),
                        gn=rng.randn(n, 1, 1, c).astype(np.float32),
                        bn=rng.randn(n, 1, 1, c).astype(np.float32),
                        perm=np.roll(np.arange(n), 1 + idx % 2))
    return out


def jax_styles(values):
    params, state = {}, {}
    for idx, v in values.items():
        c = v["gn"].shape[-1]
        params[idx] = jms.MaxStyleParams(lmda=jnp.asarray(v["lmda"]),
                                         gamma_noise=jnp.asarray(v["gn"]),
                                         beta_noise=jnp.asarray(v["bn"]))
        nan = jnp.full((1, 1, 1, c), jnp.nan)
        state[idx] = jms.MaxStyleState(perm=jnp.asarray(v["perm"]),
                                       gate=jnp.asarray(1.0, jnp.float32),
                                       gamma_std=nan, beta_std=nan)
    return params, state


def port_styles(values):
    params, state = {}, {}
    for idx, v in values.items():
        c = v["gn"].shape[-1]
        params[idx] = tms.MaxStyleParams(lmda=torch.from_numpy(v["lmda"]),
                                         gamma_noise=nchw(v["gn"]), beta_noise=nchw(v["bn"]))
        nan = torch.full((1, c, 1, 1), float("nan"))
        state[idx] = tms.MaxStyleState(perm=torch.from_numpy(v["perm"]),
                                       gate=torch.tensor(1.0), gamma_std=nan,
                                       beta_std=nan.clone())
    return params, state


def jax_step(cfg, step_key=3, init_cfg=None):
    """One JAX step of ``cfg`` on the test's batch, from its seed-0 weights,
    with the noisy input and the style draws pinned. The weights are those
    of ``init_cfg``, by default ``config()``: JAX's init runs the modules
    without a dropout rng, and dropout holds no weights."""
    solver = JSolver(cfg, maxstyle_backend="pallas")
    init_cfg = init_cfg or config(cfg.max_style.n_iter)
    state = JSolver(init_cfg, maxstyle_backend="pallas").init_state(
        jax.random.key(0), (CROP, CROP), batch_size=2 * HALF)
    params0, stats0 = to_np(state.params), to_np(state.batch_stats)

    rng = np.random.RandomState(0)
    raw_img = np.clip(0.5 + 0.25 * rng.randn(HALF, PAD, PAD), 0, 1).astype(np.float32)
    raw_lab = rng.randint(0, 4, (HALF, PAD, PAD)).astype(np.int32)
    policy = JA.get_policy("ACDC_affine_elastic_intensity", (PAD, PAD), (CROP, CROP))
    aug_i, aug_l = JA.augment_batch_inner(jax.random.key(1), jnp.asarray(raw_img),
                                          jnp.asarray(raw_lab), policy, warp_backend="pallas")
    org_i, org_l = JA.norm_batch(jnp.asarray(raw_img), jnp.asarray(raw_lab), (CROP, CROP))
    image = np.concatenate([np.asarray(aug_i), np.asarray(org_i)])
    label = np.concatenate([np.asarray(aug_l), np.asarray(org_l)]).astype(np.int32)
    noise = 0.05 * np.random.RandomState(2).randn(*image.shape).astype(np.float32)
    image_n = np.clip(image + noise, image.min(), image.max()).astype(np.float32)
    values = style_values()

    step = j_make_train_step(solver)
    new_state, metrics = step(state, {"image": jnp.asarray(image), "label": jnp.asarray(label)},
                              jax.random.key(step_key),
                              overrides={"image_n": jnp.asarray(image_n),
                                         "style_init": jax_styles(values)})
    return dict(cfg=cfg, params0=params0, stats0=stats0, image=image, label=label,
                image_n=image_n, values=values,
                params1=to_np(new_state.params), stats1=to_np(new_state.batch_stats),
                metrics={k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def jax_run():
    return jax_step(config())


def assert_port_step_matches(r, extra_overrides=None, update_cosine=True, stats_rtol=1e-4):
    """The port's step on ``jax_step``'s batch and draws, from the same
    weights, against JAX's losses, weights and BatchNorm statistics at the
    tolerances of this module's docstring (the update cosines only with
    ``update_cosine``; the statistics at ``stats_rtol``)."""
    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(r["cfg"])),
                 device="cpu")
    state = ts.init_state(state_dicts=convert.convert_train_state(r["params0"], r["stats0"]))
    step = make_train_step(ts)
    state, m = step(state, {"image": torch.from_numpy(r["image"]),
                            "label": torch.from_numpy(r["label"])},
                    torch.Generator().manual_seed(0),
                    overrides={"image_n": torch.from_numpy(r["image_n"]),
                               "style_init": port_styles(r["values"]),
                               **(extra_overrides or {})})

    assert set(m) == set(J_LOSS_KEYS) | {"loss/total"} and LOSS_KEYS == J_LOSS_KEYS
    for key in LOSS_KEYS + ("loss/total",):
        rtol = 1e-4 if key.startswith("loss/standard") else 2e-3
        np.testing.assert_allclose(float(m[key]), r["metrics"][key], rtol=rtol, atol=1e-6,
                                   err_msg=key)

    before = convert.convert_train_state(r["params0"], r["stats0"])
    after = convert.convert_train_state(r["params1"], r["stats1"])
    for name, module in state.modules.items():
        sd = module.state_dict()
        ours, theirs = [], []
        for key, want in after[name].items():
            got = sd[key]
            if key.endswith(("running_mean", "running_var", ".u", ".v")):
                # BatchNorm statistics, and the spectral-norm conv's u and v
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=stats_rtol,
                                           atol=5e-5, err_msg=f"{name}.{key}")
                continue
            diff = float((got - want).abs().max())
            assert diff <= 2.1 * LR + 1e-6, f"{name}.{key}: weight diff {diff:.2e}"
            ours.append((got - before[name][key]).double().flatten())
            theirs.append((want - before[name][key]).double().flatten())
        a, b = torch.cat(ours), torch.cat(theirs)
        cos = float(a @ b / (a.norm() * b.norm() + 1e-12))
        assert cos > 0.95 or not update_cosine, f"{name}: update cosine {cos:.4f}"
    assert state.step == 1


def test_one_step_matches_jax(jax_run):
    assert_port_step_matches(jax_run)


def test_multi_step_runs_end_to_end_on_cpu():
    cfg = tconfig.ExperimentConfig.from_dict(dataclasses.asdict(config(n_iter=2)))
    ts = TSolver(cfg, device="cpu")
    state = ts.init_state(seed=1)
    g = torch.Generator().manual_seed(5)
    k = 2
    raw = {"image": torch.rand((k, HALF, PAD, PAD), generator=g),
           "label": torch.randint(0, 4, (k, HALF, PAD, PAD), generator=g, dtype=torch.int32)}
    policy = TA.get_policy("ACDC_affine_elastic_intensity", (PAD, PAD), (CROP, CROP))
    multi = make_multi_step(ts, policy, keep_orig=True, n_inner=k)
    w0 = state.modules["image_encoder"].general_encoder.inc.conv1.weight.detach().clone()
    state, m = multi(state, raw, g)
    assert state.step == k and set(m) == set(LOSS_KEYS) | {"loss/total"}
    assert all(np.isfinite(float(v)) for v in m.values())
    assert float(m["loss/hard/total"]) > 0 and float(m["loss/standard/total"]) > 0
    assert not torch.equal(w0, state.modules["image_encoder"].general_encoder.inc.conv1.weight)


def test_every_jax_branch_flag_and_shipped_config_builds_a_step():
    """make_train_step accepts each flag that the JAX package wires, alone
    and all together, and builds the step of every shipped config. On the
    STN family (FCN_16_standard, MaxStyle n_iter=1) each of those steps also
    runs: finite losses, the branch's channel and the hard-example shape
    channel non-zero where the branch feeds them."""
    from pathlib import Path

    from maxstyle_tpu.train_step_branches import SUPPORTED

    channel = {"latent_DA": "loss/hard/total", "RSC": "loss/hard/RSC",
               "mix_style": "loss/hard/mix_style", "DSU": "loss/hard/DSU",
               "rand_conv": "loss/hard/rand_conv", "adv_noise": "loss/hard/adv_noise",
               "adv_bias": "loss/hard/adv_bias"}
    cfg = config()
    stn = dataclasses.replace(config(n_iter=1), segmentation_model=dataclasses.replace(
        cfg.segmentation_model, network_type="FCN_16_standard"))
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.rand((2 * HALF, CROP, CROP, 1), generator=g),
             "label": torch.randint(0, 4, (2 * HALF, CROP, CROP), generator=g)}
    for flags in [{f} for f in sorted(SUPPORTED)] + [set(SUPPORTED)]:
        c = dataclasses.replace(cfg, learning=dataclasses.replace(
            cfg.learning, **{f: True for f in flags}))
        ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(c)), device="cpu")
        assert all(getattr(ts.config.learning, f) is True for f in flags)
        assert callable(make_train_step(ts))
        c = dataclasses.replace(stn, learning=dataclasses.replace(
            stn.learning, **{f: True for f in flags}))
        ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(c)), device="cpu")
        state, m = make_train_step(ts)(ts.init_state(seed=0), batch, g)
        assert all(np.isfinite(float(v)) for v in m.values()), flags
        ran = flags - {"mix_style"} if "DSU" in flags else flags  # DSU replaces MixStyle
        assert all(float(m[channel[f]]) != 0.0 for f in ran), flags
        assert float(m["loss/hard/shape"]) > 0 and float(m["loss/standard/gt_shape"]) > 0
    shipped = sorted((Path(__file__).resolve().parents[1] / "configs").rglob("*.json"))
    assert len(shipped) == 16
    for path in shipped:
        ts = TSolver(tconfig.ExperimentConfig.from_json(str(path)), device="cpu")
        assert callable(make_train_step(ts)), path



@pytest.mark.parametrize("kw", [{}, {"mix_style": False}, {"no_noise": True}])
def test_styled_decode_and_its_style_grads_match_jax(jax_run, kw):
    """The styled decode of the inner adversarial loop, for the headline
    config and the two that drop a learnable tensor: the first decode (which
    caches the spreads) at rtol 1e-4 / atol 5e-5, and the gradients of a
    reconstruction loss on a decode with the cached spreads, with respect to
    the style tensors, at rtol 2e-3 / atol 1e-3 of each tensor's largest
    gradient.

    Two things are not compared, for reasons of conditioning at this size.
    Whole generations: the first Adam step moves each element by
    ~lr*sign(g), so gradients at rounding-noise size (a channel whose spread
    over the batch is ~0) flip sign and move by 2*lr. And the gradients of
    the full inner loss -CE(seg(enc(dec(styles)))): they cross the
    encoder's BatchNorms over 16 values a channel, where the JAX package's
    own two MaxStyle paths (jnp and Pallas) already disagree by up to 2%.
    The full step above holds the loop's outcome through its losses."""
    from maxstyle_tpu import losses as jlosses
    from maxstyle_tpu.ops.maxstyle_pallas import apply_maxstyle_pallas
    from maxstyle_tpu_torch import losses as tlosses
    from maxstyle_tpu_torch.ops.maxstyle_kernels import apply_maxstyle_kernels

    r = jax_run
    cfg = dataclasses.replace(r["cfg"], max_style=dataclasses.replace(r["cfg"].max_style,
                                                                      **kw))
    js = JSolver(cfg, maxstyle_backend="pallas")
    params = jax.tree_util.tree_map(jnp.asarray, r["params0"])
    stats = jax.tree_util.tree_map(jnp.asarray, r["stats0"])
    clean = jnp.asarray(r["image"])
    (z_i, _), _ = js.encode_image(params, stats, clean, mode="frozen")

    def j_decode(sp, st):
        new = dict(st)

        def hook(idx):
            def f(v):
                out, new[idx] = apply_maxstyle_pallas(v, sp[idx], st[idx], cfg.max_style)
                return out
            return f
        out, _ = js.decode("image_decoder", params, stats, z_i, mode="frozen",
                           style_fns={idx: hook(idx) for idx in INDEXES})
        return out, new

    def j_loss(sp, st):
        recon, _ = j_decode(sp, st)
        return jlosses.image_recon_loss(recon, clean)

    jsp, jst = jax_styles(r["values"])
    j_recon, jst = j_decode(jsp, jst)
    j_grads = jax.grad(j_loss)(jsp, jst)

    tcfg = tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg))
    ts = TSolver(tcfg, device="cpu")
    nets = ts.init_state(state_dicts=convert.convert_train_state(r["params0"], r["stats0"])).modules
    tz_i, _ = ts.encode_image(nets, nchw(r["image"]), mode="frozen")

    def t_decode(sp, st):
        new = dict(st)

        def hook(idx):
            def f(v):
                out, new[idx] = apply_maxstyle_kernels(v, sp[idx], st[idx], tcfg.max_style)
                return out
            return f
        out = ts.decode(nets, "image_decoder", tz_i.detach(), mode="frozen",
                        style_fns={idx: hook(idx) for idx in INDEXES})
        return out, new

    tsp, tst = port_styles(r["values"])
    with torch.no_grad():
        t_recon, tst = t_decode(tsp, tst)
    np.testing.assert_allclose(t_recon.numpy(), np.asarray(j_recon).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=5e-5)
    for idx in INDEXES:
        np.testing.assert_allclose(tst[idx].gamma_std.numpy(),
                                   np.asarray(jst[idx].gamma_std).transpose(0, 3, 1, 2),
                                   rtol=1e-4, atol=1e-6)

    live = {idx: tms.MaxStyleParams(*(t.clone().requires_grad_(True)
                                      for t in tsp[idx].tensors())) for idx in INDEXES}
    recon, _ = t_decode(live, tst)
    loss = tlosses.image_recon_loss(recon, nchw(r["image"]))
    leaves = [t for idx in INDEXES for t in live[idx].tensors()]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = [a for idx in INDEXES for a in (j_grads[idx].lmda, j_grads[idx].gamma_noise,
                                           j_grads[idx].beta_noise)]
    for got, leaf, w in zip(grads, leaves, want):
        got = torch.zeros_like(leaf) if got is None else got
        w = np.asarray(w)
        w = w if w.shape[-1] == 1 and w.ndim == 4 and got.shape[1] == 1 else w.transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got.numpy(), w, rtol=2e-3,
                                   atol=1e-3 * max(float(np.abs(w).max()), 1e-12))


def test_inner_adam_matches_optax():
    """The inner loop's Adam against optax.adam(0.1) over three steps, to
    1e-5 (1e-4 of a step): the bias corrections round in another order."""
    import optax
    from maxstyle_tpu_torch.solver import _inner_adam
    rng = np.random.RandomState(4)
    p0 = [rng.randn(4, 3).astype(np.float32), rng.randn(4, 1).astype(np.float32)]
    gs = [[rng.randn(*p.shape).astype(np.float32) for p in p0] for _ in range(3)]
    tx = optax.adam(0.1)
    jp = [jnp.asarray(p) for p in p0]
    opt = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    m1 = [torch.zeros_like(p) for p in tp]
    m2 = [torch.zeros_like(p) for p in tp]
    for t, g in enumerate(gs, 1):
        upd, opt = tx.update([jnp.asarray(x) for x in g], opt, jp)
        jp = optax.apply_updates(jp, upd)
        _inner_adam(tp, [torch.from_numpy(x) for x in g], m1, m2, t, 0.1)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
