"""The STN (shape refinement) family in the port against the JAX package.

FCN_16_standard and its variants at 64x64, batch 4, from converted weights:

* ``construct_input``: a label map one-hot and detached, logits softened by
  softmax(x / 2), each with and without an image beside it, at rtol 1e-6;
* the standard pass of every shape input mode (seg_only, w_image,
  w_recon_image, w_dual_image) and of the other grammar variants
  (share_code, w_o_filter, NN_decoder, z_score, identity): the four losses
  (rtol 1e-4) and every module's BatchNorm statistics after it (rtol 1e-4
  / atol 5e-5); for seg_only and w_dual_image also every parameter's
  gradient of the summed losses;
* ``run`` (train mode) and ``predict``'s logits with the STN refinement at
  ``n_iter=2`` (and without it at ``n_iter=1``; predict after a train
  pass, so that eval mode normalizes with trained statistics);
* ``separate_training`` stops the shape losses' gradient at the logits;
* one whole ``make_train_step`` step with MaxStyle (n_iter=1) at
  test_torch_port_train_step's 32x32 and bars, and one with LSM, whose
  masked shape code adds the perturbed-segmentation loss.

Forwards are held at test_torch_port_model's rtol 1e-4 / atol 5e-5, except
logits (up to ~15 here with random weights): rtol 1e-4 with an absolute
floor of 1e-4 of the largest value. Measured on seg_only, both sides'
float32 logits lie 7.5e-6 / 8.4e-6 (y0, port / JAX) and 3.6e-5 / 4.2e-5
(the refined ones) of the largest value away from the port's own float64
ones.
Gradients are held with ``test_torch_port_grad_bars.assert_grads_match``:
each side's float32 gradients lie up to 3.2e-2 (the port) and 3.3e-2
(JAX) of a module's largest gradient away from float64 (the summed losses,
"train" mode; the image encoder of seg_only, 1.8e-2 / 1.9e-2 for the shape
encoder), since the STN's losses cross two more encoder/decoder stacks
whose deepest BatchNorms normalize 64 values a channel. So the port's
float64 gradients are held against JAX's float64 ones at 1e-6 of a
module's largest (measured 1.2e-8), and the float32 gaps against JAX's own
distance from float64 (that module's docstring).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu import prng
from maxstyle_tpu.config import (DataConfig, ExperimentConfig, LearningConfig,
                                 SegmentationModelConfig)
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu.solver import construct_input as j_construct_input
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver
from maxstyle_tpu_torch.solver import construct_input as t_construct_input
from tests.test_torch_port_grad_bars import assert_grads_match, jax_grads, port_grads
from tests.test_torch_port_train_step import assert_port_step_matches, config, jax_step

torch.set_num_threads(2)

HW, N = 64, 4
FWD = dict(rtol=1e-4, atol=5e-5)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def stn_config(network_type="FCN_16_standard", norm="min_max", **learning):
    return ExperimentConfig(
        data=DataConfig(crop_size=(HW, HW, 1), num_classes=4, intensity_norm_type=norm),
        segmentation_model=SegmentationModelConfig(network_type=network_type, num_classes=4),
        learning=LearningConfig(lr=1e-4, batch_size=N, optimizer_type="AdamW", **learning))


def make_pair(cfg):
    js = JSolver(cfg)
    state = js.init_state(jax.random.key(0), (HW, HW), batch_size=N)
    params, stats = to_np(state.params), to_np(state.batch_stats)
    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    rng = np.random.RandomState(0)
    x = rng.rand(N, HW, HW, 1).astype(np.float32)
    label = rng.randint(0, 4, (N, HW, HW)).astype(np.int32)
    nets = ts.init_state(state_dicts=convert.convert_train_state(params, stats)).modules
    return js, params, stats, ts, nets, x, label


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or FWD))


def close_scaled(t, j):
    """Logits, at rtol 1e-4 and an absolute floor of 1e-4 of their largest
    value (module docstring)."""
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-4,
                               atol=1e-4 * float(np.abs(j).max()))


@pytest.mark.parametrize("with_image", [False, True])
def test_construct_input_matches_jax(with_image):
    rng = np.random.RandomState(1)
    logits = (3 * rng.randn(2, 6, 5, 4)).astype(np.float32)
    label = rng.randint(0, 4, (2, 6, 5)).astype(np.int32)
    image = rng.rand(2, 6, 5, 2).astype(np.float32)
    img_j = jnp.asarray(image) if with_image else None
    img_t = nchw(image) if with_image else None
    for seg_j, seg_t, is_label in ((label, torch.from_numpy(label), True),
                                   (logits, nchw(logits), False)):
        want = j_construct_input(jnp.asarray(seg_j), img_j, 4, apply_softmax=not is_label,
                                 is_labelmap=is_label, temperature=2.0)
        got = t_construct_input(seg_t, img_t, 4, apply_softmax=not is_label,
                                is_labelmap=is_label, temperature=2.0)
        close(got, np.asarray(want).transpose(0, 3, 1, 2), rtol=1e-6, atol=1e-7)
        assert got.shape[1] == 4 + (2 if with_image else 0)


def check_standard_pass(network_type, grads, norm="min_max"):
    js, params, stats, ts, nets, x, label = make_pair(stn_config(network_type, norm))
    image = np.clip(x + 0.05 * np.random.RandomState(2).randn(*x.shape), 0, 1)
    image = image.astype(np.float32)

    def loss_fn(p, dtype=jnp.float32):
        s = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), stats)
        out, aux, new_stats = js.standard_training(
            p, s, jnp.asarray(x, dtype), jnp.asarray(label), jnp.asarray(image, dtype),
            mode="train")
        return sum(out), (out, aux, new_stats)

    (_, (jout, jaux, jstats)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    if grads:
        def port_run(n, dtype):
            out, _ = ts.standard_training(n, nchw(x).to(dtype), torch.from_numpy(label).long(),
                                          nchw(image).to(dtype), mode="train")
            sum(out).backward()

        assert_grads_match(port_grads(nets, port_run),
                           jax_grads(lambda p, dtype: jax.grad(
                               lambda q: loss_fn(q, dtype)[0])(p), params, jgrads))
    out, aux = ts.standard_training(nets, nchw(x), torch.from_numpy(label).long(), nchw(image),
                                    mode="train")
    for got, want in zip(out, jout):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4, atol=1e-6)
    assert float(out[2].detach()) > 0 and float(out[3].detach()) > 0
    close_scaled(aux.p_recon, np.asarray(jaux.p_recon).transpose(0, 3, 1, 2))
    want_stats = convert.convert_train_state(params, to_np(jstats))
    for name, module in nets.items():
        sd = module.state_dict()
        for key, want in want_stats[name].items():
            if key.endswith(("running_mean", "running_var")):
                close(sd[key], want.numpy(), err_msg=f"{name}.{key}", **FWD)


@pytest.mark.parametrize("network_type", ["FCN_16_standard", "FCN_16_standard_w_dual_image"])
def test_standard_pass_losses_stats_and_grads(network_type):
    check_standard_pass(network_type, grads=True)


@pytest.mark.parametrize("network_type,norm", [
    ("FCN_16_standard_w_image", "min_max"),
    ("FCN_16_standard_w_recon_image_share_code", "min_max"),
    ("FCN_16_standard_w_image_w_o_filter", "min_max"),
    ("FCN_16_standard_w_recon_image_NN_decoder", "min_max"),
    ("FCN_16_standard_w_dual_image_z_score", "min_max"),
    ("FCN_16_standard_identity", "z_score")])
def test_every_shape_input_mode_and_variant_matches(network_type, norm):
    check_standard_pass(network_type, grads=False, norm=norm)


@pytest.fixture(scope="module")
def seg_only():
    return make_pair(stn_config())


def test_run_and_predict_refine_with_the_stn(seg_only):
    js, params, stats, ts, nets, x, label = seg_only
    recon, y0, refined, jstats = js.run(params, stats, jnp.asarray(x), mode="train",
                                        normalize_input=True)
    t_recon, t_y0, t_refined = ts.run(nets, nchw(x), mode="train", normalize_input=True)
    close(t_recon, np.asarray(recon).transpose(0, 3, 1, 2))
    for t, j in ((t_y0, y0), (t_refined, refined)):
        close_scaled(t, np.asarray(j).transpose(0, 3, 1, 2))
    assert not torch.allclose(t_refined, t_y0)
    jstats = jax.tree_util.tree_map(jnp.asarray, jstats)
    for n_iter in (1, 2):
        want = js.predict(params, jstats, jnp.asarray(x), n_iter=n_iter)
        got = ts.predict(nets, torch.from_numpy(x), n_iter=n_iter)
        close_scaled(got, want)
    assert not torch.allclose(ts.predict(nets, torch.from_numpy(x), n_iter=1),
                              ts.predict(nets, torch.from_numpy(x), n_iter=2))


def test_separate_training_stops_the_shape_gradient_at_the_logits():
    _, _, _, ts, nets, x, label = make_pair(stn_config())
    ts.config = dataclasses.replace(ts.config, learning=dataclasses.replace(
        ts.config.learning, separate_training=True))
    out, _ = ts.standard_training(nets, nchw(x), torch.from_numpy(label).long(), nchw(x),
                                  mode="frozen")
    out[3].backward()  # the refined prediction's loss
    assert all(p.grad is None for p in nets["segmentation_decoder"].parameters())
    assert all(p.grad is not None for p in nets["shape_encoder"].parameters())


def test_one_stn_step_with_maxstyle_matches_jax():
    """MaxStyle's hard-example pass adds the refinement loss of the stylized
    image's prediction (h_shape1) to loss/hard/shape."""
    base = config(n_iter=1)
    cfg = dataclasses.replace(base, segmentation_model=dataclasses.replace(
        base.segmentation_model, network_type="FCN_16_standard"))
    r = jax_step(cfg, init_cfg=cfg)
    assert r["metrics"]["loss/hard/shape"] > 0 and r["metrics"]["loss/standard/gt_shape"] > 0
    assert_port_step_matches(r)


def test_one_stn_step_with_lsm_matches_jax():
    """LSM on the STN: the masked shape code's segmentation, decoded with
    the live segmentation decoder, adds its refinement loss; the masking
    draws of both codes come from JAX's key chain."""
    from tests.torch_port_branch_steps import (_masking_draws, branch_config, jax_branch_draws,
                                               jax_branch_step, port_shapes)
    base = branch_config("latent_DA")
    cfg = dataclasses.replace(base, segmentation_model=dataclasses.replace(
        base.segmentation_model, network_type="FCN_16_standard"))
    r = jax_branch_step(cfg)
    draws = jax_branch_draws(r, "latent_DA")
    k = prng.split_dict(r["key"], ("noise", "maxstyle", "dropout", "branches"))
    _, k_seg = jax.random.split(jax.random.fold_in(k["branches"], 1))
    c = cfg.latent_DA.shape_code
    _, _, zs_shape = port_shapes(r)
    draws["shape"] = _masking_draws(k_seg, {"random": 3, "RSC": 2, "no_dropout": 2}.get(
        c.mask_type, 1), zs_shape, c.max_threshold)
    assert r["metrics"]["loss/hard/shape"] > 0
    assert_port_step_matches(r, {"branch_draws": {"latent_DA": draws}})


def test_evaluation_harness_refines_with_the_stn_at_n_iter_2(seg_only):
    """``evaluate.TestSegmentationNetwork(n_iter=2)`` predicts through the
    STN: its argmax over a volume (chunks of 3 slices, the last padded)
    agrees with JAX's ``predict(n_iter=2)`` on all but near-tied pixels
    (at most 0.1%), and differs from its own n_iter=1 prediction."""
    import types

    from maxstyle_tpu_torch.evaluate import TestSegmentationNetwork

    js, params, stats, ts, nets, x, _ = seg_only
    nets = ts.init_state(state_dicts=convert.convert_train_state(params, stats)).modules
    volume = np.concatenate([x[..., 0], x[:1, ..., 0]])  # 5 slices
    state = types.SimpleNamespace(modules=nets)
    preds = {n: TestSegmentationNetwork(ts, state, None, maximum_batch_size=3, n_iter=n,
                                        crop_hw=(HW, HW)).predict_volume(volume)
             for n in (1, 2)}
    want = np.asarray(js.predict(params, stats, jnp.asarray(volume[..., None]), n_iter=2,
                                 normalize_input=False)).argmax(-1)
    assert preds[2].shape == want.shape == (5, HW, HW)
    assert np.mean(preds[2] == want) >= 0.999
    assert np.mean(preds[2] != preds[1]) > 0.01
