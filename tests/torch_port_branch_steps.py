"""Shared helpers of the whole-step branch tests (tests/test_torch_port_branch_step_*.py).

One JAX ``make_train_step`` step of a method-branch config on a 40^2 -> 32^2
batch (half-batch 2 augmented by the Pallas warp plus the center-cropped
originals, 4 classes, FCN_16_standard_no_STN, AdamW 1e-4), with the noisy
input pinned; then the port's step on the same batch from the converted
weights, given the draws JAX made. Those are rebuilt from JAX's own key
chain: ``prng.split_dict(key, ("noise", "maxstyle", "dropout",
"branches"))``, ``fold_in(k["branches"], 1..6)`` for latent_DA, RSC,
MixStyle/DSU, RandConv, AdvNoise and AdvBias, then each op's splits.

The bars are those of tests/test_torch_port_train_step.py
(``assert_port_step_matches``): standard losses rtol 1e-4; branch channels
and the total rtol 2e-3; weights within 2.1*lr + 1e-6 and each module's
update cosine > 0.95; BatchNorm statistics rtol 1e-4 / atol 5e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from maxstyle_tpu import prng
from maxstyle_tpu.config import (DataConfig, ExperimentConfig, LearningConfig,
                                 SegmentationModelConfig)
from maxstyle_tpu.data import augment as JA
from maxstyle_tpu.ops import randconv as jrc
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu.train_step import make_train_step as j_make_train_step
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.flagship import BRANCH_CONFIGS
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver
from tests.test_torch_port_train_step import (CROP, HALF, LR, PAD, assert_port_step_matches,
                                              nchw, to_np)

N = 2 * HALF
# the fold_in index of each branch in apply_enabled_branches
BRANCH_INDEX = {"latent_DA": 1, "RSC": 2, "mix_style": 3, "DSU": 3, "rand_conv": 4,
                "adv_noise": 5, "adv_bias": 6}


def branch_config(flag, **learning):
    """The test's config with one branch on; latent_DA takes the shipped
    Prostate LSM config's masking settings."""
    lda = ExperimentConfig.from_json(str(BRANCH_CONFIGS["prostate_lsm"])).latent_DA
    return ExperimentConfig(
        data=DataConfig(crop_size=(CROP, CROP, 1), pad_size=(PAD, PAD, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(
            network_type="FCN_16_standard_no_STN", num_classes=4),
        learning=LearningConfig(lr=LR, batch_size=N, optimizer_type="AdamW",
                                **{flag: True}, **learning),
        latent_DA=lda)


def jax_branch_step(cfg, step_key=3):
    """One JAX step of ``cfg`` from seed-0 weights on the test's batch."""
    solver = JSolver(cfg, maxstyle_backend="pallas")
    state = solver.init_state(jax.random.key(0), (CROP, CROP), batch_size=N)
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
    key = jax.random.key(step_key)
    new_state, metrics = j_make_train_step(solver)(
        state, {"image": jnp.asarray(image), "label": jnp.asarray(label)}, key,
        overrides={"image_n": jnp.asarray(image_n)})
    return dict(cfg=cfg, key=key, params0=params0, stats0=stats0, image=image, label=label,
                image_n=image_n, values={},
                params1=to_np(new_state.params), stats1=to_np(new_state.batch_stats),
                metrics={k: float(v) for k, v in metrics.items()})


def port_shapes(r):
    """Shapes the draws need: the encoder hooks' and the two codes'."""
    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(r["cfg"])),
                 device="cpu")
    nets = ts.init_state(state_dicts=convert.convert_train_state(r["params0"],
                                                                 r["stats0"])).modules
    hooks = {}
    with torch.no_grad():
        z = nets["image_encoder"].encode(nchw(r["image_n"]), "frozen",
                                         {i: (lambda v, i=i: hooks.setdefault(i, v.shape)
                                              and v) for i in range(1, 7)})
        z_i, z_s = ts.filter_code(nets, z, mode="frozen")
    return hooks, tuple(z_i.shape), tuple(z_s.shape)


def _masking_draws(key, n_methods, code_shape, rate):
    b, c, h, w = code_shape
    k_sel, k_op = jax.random.split(key)
    k_pct, k_soft = jax.random.split(k_op)
    return {"switch": torch.tensor(int(jax.random.randint(k_sel, (), 0, n_methods))),
            "pct_u": torch.tensor(float(jax.random.uniform(k_pct))),
            "soft_channel": torch.from_numpy(np.array(jax.random.uniform(k_soft, (b, c)))),
            "soft_spatial": torch.from_numpy(np.array(jax.random.uniform(k_soft, (b, h * w)))),
            "keep": nchw(jax.random.bernoulli(k_op, 1.0 - rate, (b, 1, 1, c)))}


def jax_branch_draws(r, flag):
    """The draws JAX's step made for branch ``flag``, in the port's layout."""
    k = prng.split_dict(r["key"], ("noise", "maxstyle", "dropout", "branches"))
    rng = jax.random.fold_in(k["branches"], BRANCH_INDEX[flag])
    hooks, zi_shape, zs_shape = port_shapes(r)
    if flag in ("mix_style", "DSU"):
        out = {}
        for idx in ((1, 2, 3, 4, 5, 6) if flag == "DSU" else (1, 2, 3)):
            c = hooks[idx][1]
            k_gate, k_lmda, k_perm, k_g1, k_g2 = jax.random.split(jax.random.fold_in(rng, idx), 5)
            d = {"gate_u": torch.tensor(float(jax.random.uniform(k_gate)))}
            if flag == "DSU":
                d["g_mu"] = nchw(jax.random.normal(k_g1, (N, 1, 1, c)))
                d["g_sig"] = nchw(jax.random.normal(k_g2, (N, 1, 1, c)))
            else:
                d["lmda"] = torch.from_numpy(np.array(jax.random.beta(k_lmda, 0.1, 0.1,
                                                                      (N, 1, 1, 1))))
                d["perm"] = torch.from_numpy(np.array(jax.random.permutation(k_perm, N)))
            out[idx] = d
        return out
    if flag == "latent_DA":
        k_img, _ = jax.random.split(rng)
        c = r["cfg"].latent_DA.image_code
        n = {"random": 3, "RSC": 2, "no_dropout": 2}.get(c.mask_type, 1)
        return {"image": _masking_draws(k_img, n, zi_shape, c.max_threshold)}
    if flag == "RSC":
        k_i, k_s = jax.random.split(rng)
        return {"image": _masking_draws(k_i, 2, zi_shape, 1.0 / 3),
                "shape": _masking_draws(k_s, 2, zs_shape, 1.0 / 3)}
    if flag == "rand_conv":
        views = []
        for i in range(3):
            _, k_size, k_w, k_alpha = jax.random.split(jax.random.fold_in(rng, i), 4)
            idx = int(jax.random.randint(k_size, (), 0, len(jrc.KERNEL_CANDIDATES)))
            w = np.array(np.asarray(jax.random.normal(k_w, (7, 7, 1, 1))).transpose(3, 2, 0, 1))
            views.append({"k": torch.tensor(jrc.KERNEL_CANDIDATES[idx]),
                          "w": torch.from_numpy(w),
                          "alpha": torch.tensor(float(jax.random.uniform(k_alpha)))})
        return views
    if flag == "adv_noise":
        return {"d": nchw(jax.random.normal(rng, (N, CROP, CROP, 1)))}
    if flag == "adv_bias":
        return {"cp": nchw(jax.random.uniform(rng, (N, 5, 5, 1), minval=-1.0, maxval=1.0))}
    raise ValueError(flag)


def check_branch_step(flag, **learning):
    """The port's step against JAX's for a config with branch ``flag`` on."""
    r = jax_branch_step(branch_config(flag, **learning))
    channel = {"latent_DA": "loss/hard/total", "RSC": "loss/hard/RSC",
               "mix_style": "loss/hard/mix_style", "DSU": "loss/hard/DSU",
               "rand_conv": "loss/hard/rand_conv", "adv_noise": "loss/hard/adv_noise",
               "adv_bias": "loss/hard/adv_bias"}[flag]
    assert r["metrics"][channel] != 0.0
    assert_port_step_matches(r, {"branch_draws": {flag: jax_branch_draws(r, flag)}})
    return r
