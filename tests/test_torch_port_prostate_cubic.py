"""One fused training step of the Prostate MaxStyle config with the cubic
warp, in the port against the JAX package.

The config is configs/Prostate/MICCAI2022_MaxStyle.json with
``image_interp="cubic"`` (2 classes, policy
Prostate_affine_elastic_intensity, AdamW 1e-4, MaxStyle n_iter=5 at hooks
3, 4, 5, keep-original pairing), cut to pads of 40^2, crops of 32^2 and an
effective batch of 4. JAX runs the body of its ``make_fused_train_step``
(``augment_batch_inner`` with the Pallas cubic warp kernel in interpret
mode, the centre-cropped originals, then ``make_train_step``) with the
noisy input and the style tensors injected; the port runs its
``make_fused_train_step`` from the converted weights with the same
augmentation draws, noisy input and style tensors. The tolerances are those
of tests/test_torch_port_train_step.py: standard losses rtol 1e-4, hard
losses and the total rtol 2e-3, weights within the sign-flip bound of one
AdamW step, running statistics rtol 1e-4. The update cosine of each module
against JAX's is held above 0.9, not 0.95: measured 0.956 (image encoder),
0.971 (segmentation decoder) and 0.945 (image decoder), the same to four
digits when JAX's own augmented batch is fed to the port's step, so the
augmentation (3e-6 apart) plays no part. It is the first Adam step's
~lr*sign(g) acting on gradients of rounding-noise size, as in that test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_augment import jax_draws
from test_torch_port_train_step import jax_styles, port_styles, style_values, to_np

from maxstyle_tpu.config import ExperimentConfig as JConfig
from maxstyle_tpu.data import augment as JA
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu.train_step import make_train_step as j_make_train_step
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.flagship import (PROSTATE_MAXSTYLE, config_solver, load_config,
                                         workload_policy)
from maxstyle_tpu_torch.train_step import LOSS_KEYS, make_fused_train_step

torch.set_num_threads(2)

PAD, CROP, HALF, LR = 40, 32, 2, 1e-4


def shrink(cfg):
    """Pads 40^2, crops 32^2, effective batch 4: the CPU size of the test."""
    data = dataclasses.replace(cfg.data, pad_size=(PAD, PAD, 1), crop_size=(CROP, CROP, 1))
    return dataclasses.replace(cfg, data=data, learning=dataclasses.replace(
        cfg.learning, batch_size=2 * HALF))


@pytest.fixture(scope="module")
def run():
    jcfg = JConfig.from_json(str(PROSTATE_MAXSTYLE))
    jcfg = shrink(dataclasses.replace(jcfg, data=dataclasses.replace(
        jcfg.data, image_interp="cubic")))
    tcfg = shrink(load_config(PROSTATE_MAXSTYLE, image_interp="cubic"))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.segmentation_model.num_classes == 2 and tcfg.max_style.n_iter == 5

    solver = JSolver(jcfg, maxstyle_backend="pallas")
    state = solver.init_state(jax.random.key(0), (CROP, CROP), batch_size=2 * HALF)
    params0, stats0 = to_np(state.params), to_np(state.batch_stats)
    rng = np.random.RandomState(0)
    raw_img = np.clip(0.5 + 0.25 * rng.randn(HALF, PAD, PAD), 0, 1).astype(np.float32)
    raw_lab = rng.randint(0, 2, (HALF, PAD, PAD)).astype(np.int32)
    policy = JA.get_policy(jcfg.data.data_aug_policy, (PAD, PAD), (CROP, CROP),
                           image_interp="cubic")
    k_aug, k_step = jax.random.split(jax.random.key(1))
    aug_i, aug_l = JA.augment_batch_inner(k_aug, jnp.asarray(raw_img), jnp.asarray(raw_lab),
                                          policy, warp_backend="pallas")
    org_i, org_l = JA.norm_batch(jnp.asarray(raw_img), jnp.asarray(raw_lab), (CROP, CROP))
    image = np.concatenate([np.asarray(aug_i), np.asarray(org_i)])
    label = np.concatenate([np.asarray(aug_l), np.asarray(org_l)]).astype(np.int32)
    noise = 0.05 * np.random.RandomState(2).randn(*image.shape).astype(np.float32)
    image_n = np.clip(image + noise, image.min(), image.max()).astype(np.float32)
    values = style_values()
    new_state, metrics = j_make_train_step(solver)(
        state, {"image": jnp.asarray(image), "label": jnp.asarray(label)}, k_step,
        overrides={"image_n": jnp.asarray(image_n), "style_init": jax_styles(values)})

    ts = config_solver(tcfg, device="cpu")
    tstate = ts.init_state(state_dicts=convert.convert_train_state(params0, stats0))
    fused = make_fused_train_step(ts, workload_policy(tcfg), keep_orig=True)
    tstate, tm = fused(tstate, {"image": torch.from_numpy(raw_img),
                                "label": torch.from_numpy(raw_lab)},
                       torch.Generator().manual_seed(0),
                       overrides={"aug_draws": jax_draws(jax.random.split(k_aug, HALF), policy),
                                  "image_n": torch.from_numpy(image_n),
                                  "style_init": port_styles(values)})
    return dict(params0=params0, stats0=stats0, params1=to_np(new_state.params),
                stats1=to_np(new_state.batch_stats),
                metrics={k: float(v) for k, v in metrics.items()},
                tstate=tstate, tmetrics={k: float(v) for k, v in tm.items()})


def test_losses_match_jax(run):
    m, want = run["tmetrics"], run["metrics"]
    assert set(m) == set(LOSS_KEYS) | {"loss/total"}
    assert all(np.isfinite(v) for v in m.values()) and m["loss/hard/total"] > 0
    for key in LOSS_KEYS + ("loss/total",):
        rtol = 1e-4 if key.startswith("loss/standard") else 2e-3
        np.testing.assert_allclose(m[key], want[key], rtol=rtol, atol=1e-6, err_msg=key)


def test_weights_after_adamw_match_jax(run):
    before = convert.convert_train_state(run["params0"], run["stats0"])
    after = convert.convert_train_state(run["params1"], run["stats1"])
    for name, module in run["tstate"].modules.items():
        sd = module.state_dict()
        ours, theirs = [], []
        for key, want in after[name].items():
            got = sd[key]
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=5e-5,
                                           err_msg=f"{name}.{key}")
                continue
            diff = float((got - want).abs().max())
            assert diff <= 2.1 * LR + 1e-6, f"{name}.{key}: weight diff {diff:.2e}"
            ours.append((got - before[name][key]).double().flatten())
            theirs.append((want - before[name][key]).double().flatten())
        a, b = torch.cat(ours), torch.cat(theirs)
        cos = float(a @ b / (a.norm() * b.norm() + 1e-12))
        assert cos > 0.9, f"{name}: update cosine {cos:.4f}"
    assert run["tstate"].step == 1
