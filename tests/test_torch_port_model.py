"""The port's FCN model family, losses and intensity ops against the JAX
package's, on the same weights (flax params converted by convert.py).

FCN_16_standard_no_STN at 32x32, batch 4. Forwards of the encoder, the code
decoupler, both decoders and the whole standard pass are compared in the
"train", "frozen" and "eval" BatchNorm modes, and so are the running
statistics after a train-mode pass, at rtol 1e-4 / atol 5e-5 on O(1)
values. The atol is looser than 1e-5 because the encoder's last BatchNorms
normalize over only 16 values a channel (batch 4 at 2x2), which turns the
two frameworks' float32 rounding (single-pass E[x^2]-E[x]^2 variance in the
JAX package, torch's own elsewhere) into differences of up to 1.6e-5.
Parameter gradients of the standard loss are compared at rtol 1e-3 with an
absolute floor of 1e-3 of each module's largest gradient: the same
amplification, carried back to the encoder's stem, reaches 4.8e-4 of the
largest gradient, and a conv bias that feeds a BatchNorm has a gradient of
pure rounding noise (~1e-8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu import losses as jlosses
from maxstyle_tpu.config import (DataConfig, ExperimentConfig, LearningConfig,
                                 SegmentationModelConfig)
from maxstyle_tpu.models.registry import parse_network_type as j_parse
from maxstyle_tpu.ops import intensity as jint
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu_torch import convert, losses as tlosses
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch.models.registry import parse_network_type as t_parse
from maxstyle_tpu_torch.ops import intensity as tint
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver

torch.set_num_threads(2)

HW, N = 32, 4
FWD = dict(rtol=1e-4, atol=5e-5)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def pair():
    cfg = ExperimentConfig(
        data=DataConfig(crop_size=(HW, HW, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(
            network_type="FCN_16_standard_no_STN", num_classes=4),
        learning=LearningConfig(lr=1e-4, batch_size=N, optimizer_type="AdamW"))
    js = JSolver(cfg)
    state = js.init_state(jax.random.key(0), (HW, HW), batch_size=N)
    params, stats = to_np(state.params), to_np(state.batch_stats)
    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    tstate = ts.init_state(state_dicts=convert.convert_train_state(params, stats))
    rng = np.random.RandomState(0)
    x = rng.rand(N, HW, HW, 1).astype(np.float32)
    label = rng.randint(0, 4, (N, HW, HW)).astype(np.int32)
    return js, params, stats, ts, tstate, x, label


def fresh(pair):
    """Port modules reloaded from the JAX weights (tests may update stats)."""
    _, params, stats, ts, _, _, _ = pair
    return ts.init_state(state_dicts=convert.convert_train_state(params, stats)).modules


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or FWD))


@pytest.mark.parametrize("mode", ["train", "frozen", "eval"])
def test_encoder_and_decoders_forward(pair, mode):
    js, params, stats, ts, _, x, _ = pair
    nets = fresh(pair)
    enc = js.modules["image_encoder"]
    (z_i, z_s), _ = js.encode_image(params, stats, jnp.asarray(x), mode=mode)
    tz_i, tz_s = ts.encode_image(nets, nchw(x), mode=mode)
    close(tz_i, np.asarray(z_i).transpose(0, 3, 1, 2))
    close(tz_s, np.asarray(z_s).transpose(0, 3, 1, 2))
    assert enc is not None
    for name, code in (("segmentation_decoder", z_s), ("image_decoder", z_i)):
        out, _ = js.decode(name, params, stats, code, mode=mode)
        tout = ts.decode(nets, name, nchw(code), mode=mode)
        close(tout, np.asarray(out).transpose(0, 3, 1, 2))


def test_decoder_split_at_a_hook_is_exact(pair):
    js, params, stats, ts, _, x, _ = pair
    nets = fresh(pair)
    code = nchw(np.random.RandomState(1).rand(N, HW // 16, HW // 16, 128).astype(np.float32))
    full = ts.decode(nets, "image_decoder", code, mode="frozen")
    pre = ts.decode(nets, "image_decoder", code, mode="frozen", stop_before_hook=3)
    rest = ts.decode(nets, "image_decoder", pre, mode="frozen", start_at_hook=3)
    assert torch.equal(full, rest)


def test_standard_pass_losses_stats_and_grads(pair):
    js, params, stats, ts, _, x, label = pair
    nets = fresh(pair)

    def loss_fn(p):
        (seg, img, gt, shape), _, new_stats = js.standard_training(
            p, stats, jnp.asarray(x), jnp.asarray(label), jnp.asarray(x), mode="train")
        return seg + img + gt + shape, (seg, img, new_stats)

    (total, (seg, img, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    (tseg, timg, _, _), _ = ts.standard_training(nets, nchw(x), torch.from_numpy(label).long(),
                                                 nchw(x), mode="train")
    ttotal = tseg + timg
    ttotal.backward()
    close(tseg, seg)
    close(timg, img)

    want_stats = convert.convert_train_state(to_np(params), to_np(new_stats))
    want_grads = convert.convert_train_state(to_np(grads), {})
    for name, module in nets.items():
        sd = module.state_dict()
        for key, want in want_stats[name].items():
            if key.endswith(("running_mean", "running_var")):
                close(sd[key], want.numpy())
        gmax = max(float(g.abs().max()) for g in want_grads[name].values())
        for pname, p in module.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want_grads[name][pname].numpy(),
                                       rtol=1e-3, atol=1e-3 * gmax, err_msg=f"{name}.{pname}")


def test_losses_and_intensity_ops_match():
    rng = np.random.RandomState(3)
    logits = (rng.randn(2, 8, 8, 4) * 3).astype(np.float32)
    label = rng.randint(0, 4, (2, 8, 8)).astype(np.int32)
    img = (rng.rand(2, 8, 8, 1) * 4 - 1).astype(np.float32)
    tl, tlab, timg = nchw(logits), torch.from_numpy(label), nchw(img)
    close(tlosses.cross_entropy_2d(tl, tlab), jlosses.cross_entropy_2d(logits, label))
    w = [0.1, 0.2, 0.3, 0.4]
    close(tlosses.cross_entropy_2d(tl, tlab, weight=w),
          jlosses.cross_entropy_2d(logits, label, weight=w))
    close(tlosses.basic_loss_fn(tl, tlab, "cross entropy", class_weights=w),
          jlosses.basic_loss_fn(logits, label, "cross entropy", class_weights=w))
    for rt in ("l2", "l1"):
        close(tlosses.image_recon_loss(timg, timg * 0.5, rt),
              jlosses.image_recon_loss(img, img * 0.5, rt))
    close(tlosses.one_hot(tlab, 4), np.asarray(jlosses.one_hot(label, 4)).transpose(0, 3, 1, 2))
    for t_fn, j_fn in ((tint.rescale_intensity, jint.rescale_intensity),
                       (tint.z_score_intensity, jint.z_score_intensity),
                       (tint.instance_norm, jint.instance_norm)):
        close(t_fn(timg), np.asarray(j_fn(img)).transpose(0, 3, 1, 2))
    close(tlosses.basic_loss_fn(tl, tlab, "dice"), jlosses.basic_loss_fn(logits, label, "dice"))
    with pytest.raises(NotImplementedError):
        tlosses.basic_loss_fn(tl, tlab, "hinge")


@pytest.mark.parametrize("nt", [
    "FCN_16_standard_no_STN", "FCN_64_standard", "FCN_16_standard_w_dual_image_z_score",
    "FCN_16_standard_w_image_identity_share_code", "FCN_16_no_im_recon_w_o_filter_no_STN",
    "FCN_16_standard_w_recon_image_NN_decoder", "DS_FCN_16_standard",
    "Unet_16_Unet_im_recon_no_STN", "UnetTransformer_enable_code_filter_16"])
@pytest.mark.parametrize("norm", ["min_max", "z_score"])
def test_network_type_grammar_matches(nt, norm):
    assert dataclasses.asdict(t_parse(nt, norm)) == dataclasses.asdict(j_parse(nt, norm))


def test_init_statistics_follow_the_jax_scheme():
    """Init parity is statistical: Kaiming fan-in conv weights, zero biases,
    BatchNorm scale N(1, 0.02), transposed conv N(0, 0.02)."""
    cfg = tconfig.ExperimentConfig()
    nets = TSolver(cfg, device="cpu").build_modules(seed=0)
    dec = nets["image_decoder"]
    w = nets["image_encoder"].general_encoder.down2.conv1.weight
    fan_in = w.shape[1] * 9
    assert abs(float(w.detach().std()) - (2.0 / fan_in) ** 0.5) < 0.05 * (2.0 / fan_in) ** 0.5
    assert float(nets["image_encoder"].general_encoder.down2.conv1.bias.detach().abs().max()) == 0.0
    bn = torch.cat([m.weight.detach() for m in nets.modules() if type(m).__name__ == "BatchNorm"])
    assert abs(float(bn.mean()) - 1.0) < 0.005 and abs(float(bn.std()) - 0.02) < 0.003
    up = dec.up1.up.conv.weight.detach()
    assert abs(float(up.std()) - 0.02) < 0.002 and float(dec.up1.up.conv.bias.detach().abs().max()) == 0


@pytest.mark.parametrize("n_train", [1, 2])
def test_live_running_stats_match_jax_differentiating_through_the_update(n_train):
    """Inside ``live_running_stats`` a BatchNorm's "train" pass normalizes
    and updates its running statistics from one set of batch moments, and
    an "eval" pass differentiates through those updated statistics, as the
    JAX step does when its loss reads the statistics it just updated. One
    layer, ``n_train`` train passes then an eval pass, against the JAX
    package's BatchNorm: outputs and statistics at rtol 1e-5, gradients of
    the inputs and the affine parameters at rtol 1e-4."""
    from maxstyle_tpu.models.layers import BatchNorm as JBN
    from maxstyle_tpu_torch.models.layers import BatchNorm as TBN, live_running_stats

    rs = np.random.RandomState(7 + n_train)
    xs = [(rs.randn(4, 6, 5, 3) * 1.7 + 0.4).astype(np.float32) for _ in range(n_train + 1)]
    gs = [rs.randn(4, 6, 5, 3).astype(np.float32) for _ in range(n_train + 1)]
    scale = (1.0 + 0.1 * rs.randn(3)).astype(np.float32)
    bias = (0.1 * rs.randn(3)).astype(np.float32)
    stats0 = {"mean": (0.2 * rs.randn(3)).astype(np.float32),
              "var": (1.0 + 0.3 * rs.rand(3)).astype(np.float32)}

    def j_loss(xs_, scale_, bias_):
        params = {"scale": scale_, "bias": bias_}
        stats, ys = stats0, []
        for x in xs_[:-1]:
            y, upd = JBN(use_running_average=False).apply(
                {"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
            stats, ys = upd["batch_stats"], ys + [y]
        ys.append(JBN(use_running_average=True).apply(
            {"params": params, "batch_stats": stats}, xs_[-1]))
        return sum(jnp.sum(y * g) for y, g in zip(ys, gs)), (ys, stats)

    (_, (jys, jstats)), jgrads = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        [jnp.asarray(x) for x in xs], jnp.asarray(scale), jnp.asarray(bias))

    bn = TBN(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(stats0["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats0["var"]))
    txs = [nchw(x).requires_grad_(True) for x in xs]
    with live_running_stats(bn):
        tys = [bn(x, "train") for x in txs[:-1]] + [bn(txs[-1], "eval")]
        sum((y * nchw(g)).sum() for y, g in zip(tys, gs)).backward()
    tight = dict(rtol=1e-5, atol=1e-5)
    for ty, jy in zip(tys, jys):
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy).transpose(0, 3, 1, 2),
                                   **tight)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(jstats["mean"]), **tight)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(jstats["var"]), **tight)
    for tx, jg in zip(txs, jgrads[0]):
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg).transpose(0, 3, 1, 2),
                                   rtol=1e-4, atol=1e-4 * float(np.abs(jg).max()))
    for tp, jg in ((bn.weight, jgrads[1]), (bn.bias, jgrads[2])):
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(jg).max()))
    # on exit the layer is back to cuDNN's train pass, which the live one matches
    x = nchw(xs[0])
    with torch.no_grad():
        plain = bn(x, "train")
        bn.running_mean.copy_(torch.from_numpy(stats0["mean"]))
        with live_running_stats(bn):
            live = bn(x, "train")
    np.testing.assert_allclose(live.numpy(), plain.numpy(), **tight)
