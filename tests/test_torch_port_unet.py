"""The Unet family in the port against the JAX package.

* ``Norm2d`` "instance", "instance_affine" and "none" (rtol / atol 1e-5).
* The x2 upsamplers at odd and even sizes: bilinear with align_corners
  (``F.interpolate`` against JAX's two constant-matrix contractions: equal
  to rounding, held at rtol 1e-6 / atol 1e-6), and the learned ``Conv2``
  and ``Conv4`` transposed convs from converted (spatially flipped) kernels
  (rtol 1e-5 / atol 1e-6; Conv4 is flax's 4x4 stride-2 "SAME" padding, two
  rows of the dilated input on each side, as torch's padding=1).
* The solver on Unet_16_standard_no_STN and Unet_16_Unet_im_recon_no_STN,
  each with and without ``enable_code_filter``, at 64x64, batch 4, from
  converted weights: the two code pyramids (or z_i, the bottom level) in
  every BatchNorm mode; the standard pass's losses, BatchNorm statistics
  and gradients; the styled decode of a ``UnetDecoder`` image decoder at
  the MaxStyle hooks 3, 4, 5 (no prefix hoisting) and its style gradients.
* One whole ``make_train_step`` step with MaxStyle (n_iter=1) for
  Unet_16_Unet_im_recon_no_STN with and without code filters, at
  test_torch_port_train_step's 32x32 and bars.

Bars: test_torch_port_model's forwards (rtol 1e-4 / atol 5e-5) and
statistics (rtol 1e-4 / atol 5e-5); codes and logits at rtol 1e-4 with an
absolute floor of 1e-4 of their largest value, parameter gradients with
``test_torch_port_grad_bars.assert_grads_match`` (the port's float64
gradients against JAX's float64 ones at 1e-6 of a module's largest, the
float32 gaps against JAX's own distance from float64), and the styled
decode's style gradients at rtol 2e-3 with a floor of 2e-2 of each
tensor's largest gradient and cosine > 0.999. Measured on
Unet_16_standard_no_STN at this size against the port's own float64: the
bottom code x5 lies 7.2e-5 (the port) and 1.2e-4 (JAX) away (largest value
4.8); the encoder's gradients 1.3e-2 and 7.4e-3 of its largest; the hook-3
style noise gradients (largest ~2e-5) 5.4e-3 and 7.6e-3 of theirs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.config import (DataConfig, ExperimentConfig, LearningConfig,
                                 SegmentationModelConfig)
from maxstyle_tpu.models import layers as jl
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.models import layers as tl
from maxstyle_tpu_torch.models.unet import UnetDecoder, UnetEncoder
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver
from tests.test_torch_port_grad_bars import assert_grads_match, jax_grads, port_grads
from tests.test_torch_port_train_step import (INDEXES, assert_port_step_matches, config,
                                              jax_step, jax_styles, port_styles)

torch.set_num_threads(2)

HW, N = 64, 4
FWD = dict(rtol=1e-4, atol=5e-5)
TYPES = ["Unet_16_standard_no_STN", "Unet_16_standard_enable_code_filter_no_STN",
         "Unet_16_Unet_im_recon_no_STN", "Unet_16_Unet_im_recon_enable_code_filter_no_STN"]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def close(t, j, err_msg="", **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), err_msg=err_msg,
                               **(tol or FWD))


def close_scaled(t, j):
    """rtol 1e-4 with an absolute floor of 1e-4 of the largest value."""
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-4,
                               atol=1e-4 * float(np.abs(j).max()))


@pytest.mark.parametrize("hw", [(5, 7), (6, 4)])
def test_bilinear_upsample_matches_jax_at_odd_and_even_sizes(hw):
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    want = jl.upsample2x(jnp.asarray(x), "bilinear")
    got = tl.upsample2x(nchw(x), "bilinear")
    assert got.shape == (2, 3, 2 * hw[0], 2 * hw[1])
    close(got, np.asarray(want).transpose(0, 3, 1, 2), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("up_type", ["Conv2", "Conv4"])
@pytest.mark.parametrize("hw", [(5, 7), (6, 4)])
def test_transposed_conv_upsamplers_match_jax(up_type, hw):
    rng = np.random.RandomState(1)
    x = rng.randn(2, *hw, 3).astype(np.float32)
    mod = jl.Upsampler(up_type, features=3)
    variables = mod.init(jax.random.key(2), jnp.asarray(x))
    want = mod.apply(variables, jnp.asarray(x))
    up = tl.Upsampler(up_type, features=3)
    # the flax path up/ConvTranspose_0 is the port's up.conv
    sd = convert.flax_to_state_dict({"up": to_np(variables["params"])})
    up.load_state_dict({k[len("up."):]: v for k, v in sd.items()}, strict=True)
    got = up(nchw(x))
    assert got.shape == (2, 3, 2 * hw[0], 2 * hw[1])
    close(got, np.asarray(want).transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["instance", "instance_affine", "none"])
def test_other_norm_kinds_match_jax(kind):
    """The Norm2d kinds besides "batch" (every mode alike); the affine
    instance norm with a non-trivial scale and bias."""
    rng = np.random.RandomState(3)
    x = (2.0 * rng.randn(2, 5, 7, 4) + 0.5).astype(np.float32)
    mod = jl.Norm2d(kind)
    variables = mod.init(jax.random.key(0), jnp.asarray(x), train=False)
    if kind == "instance_affine":
        variables = {"params": {"scale": jnp.asarray(1.0 + rng.rand(4), jnp.float32),
                                "bias": jnp.asarray(rng.randn(4), jnp.float32)}}
    norm = tl.Norm2d(kind, 4)
    norm.load_state_dict(convert.flax_to_state_dict(to_np(variables.get("params", {}))),
                         strict=True)
    for mode in ("train", "eval"):
        want = mod.apply(variables, jnp.asarray(x), train=mode == "train")
        close(norm(nchw(x), mode), np.asarray(want).transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-5)


def unet_config(network_type):
    return ExperimentConfig(
        data=DataConfig(crop_size=(HW, HW, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(network_type=network_type, num_classes=4),
        learning=LearningConfig(lr=1e-4, batch_size=N, optimizer_type="AdamW"))


def make_pair(network_type):
    cfg = unet_config(network_type)
    js = JSolver(cfg)
    state = js.init_state(jax.random.key(0), (HW, HW), batch_size=N)
    params, stats = to_np(state.params), to_np(state.batch_stats)
    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    nets = ts.init_state(state_dicts=convert.convert_train_state(params, stats)).modules
    rng = np.random.RandomState(0)
    x = rng.rand(N, HW, HW, 1).astype(np.float32)
    label = rng.randint(0, 4, (N, HW, HW)).astype(np.int32)
    return js, params, stats, ts, nets, x, label


@pytest.fixture(scope="module", params=TYPES)
def pair(request):
    return make_pair(request.param)


def as_list(code):
    return list(code) if isinstance(code, (list, tuple)) else [code]


def test_modules_are_the_unet_family(pair):
    _, _, _, ts, nets, _, _ = pair
    assert isinstance(nets["image_encoder"], UnetEncoder)
    assert isinstance(nets["segmentation_decoder"], UnetDecoder)
    im_recon = "Unet_im_recon" in ts.spec.network_type
    assert isinstance(nets["image_decoder"], UnetDecoder) == im_recon
    assert nets["image_encoder"].enable_code_filter == ts.spec.unet_code_filter


@pytest.mark.parametrize("mode", ["train", "frozen", "eval"])
def test_code_pyramids_match_jax(pair, mode):
    js, params, stats, ts, _, x, _ = pair
    nets = ts.init_state(state_dicts=convert.convert_train_state(params, stats)).modules
    (z_i, z_s), new_stats = js.encode_image(params, stats, jnp.asarray(x), mode=mode)
    tz_i, tz_s = ts.encode_image(nets, nchw(x), mode=mode)
    assert len(as_list(tz_s)) == 5
    assert len(as_list(tz_i)) == (5 if "Unet_im_recon" in ts.spec.network_type else 1)
    for t, j in zip(as_list(tz_i) + as_list(tz_s), as_list(z_i) + as_list(z_s)):
        close_scaled(t, np.asarray(j).transpose(0, 3, 1, 2))
    want = convert.convert_train_state(params, to_np(new_stats))["image_encoder"]
    for key, value in nets["image_encoder"].state_dict().items():
        close(value, want[key].numpy(), err_msg=key)


def test_standard_pass_losses_stats_and_grads(pair):
    js, params, stats, ts, nets, x, label = pair
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
    nets = ts.init_state(state_dicts=convert.convert_train_state(params, stats)).modules

    def port_run(n, dtype):
        out, _ = ts.standard_training(n, nchw(x).to(dtype), torch.from_numpy(label).long(),
                                      nchw(image).to(dtype), mode="train")
        sum(out).backward()

    assert_grads_match(port_grads(nets, port_run),
                       jax_grads(lambda p, dtype: jax.grad(lambda q: loss_fn(q, dtype)[0])(p),
                                 params, jgrads))
    out, aux = ts.standard_training(nets, nchw(x), torch.from_numpy(label).long(), nchw(image),
                                    mode="train")
    for got, want in zip(out, jout):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4, atol=1e-6)
    close_scaled(aux.y0, np.asarray(jaux.y0).transpose(0, 3, 1, 2))
    close(aux.recon_image, np.asarray(jaux.recon_image).transpose(0, 3, 1, 2))
    want_stats = convert.convert_train_state(params, to_np(jstats))
    for name, module in nets.items():
        sd = module.state_dict()
        for key, want in want_stats[name].items():
            if key.endswith(("running_mean", "running_var")):
                close(sd[key], want.numpy(), err_msg=f"{name}.{key}")


def test_styled_decode_of_the_image_decoder_matches_jax(pair):
    """The MaxStyle hooks 3, 4, 5 of the image decoder (a UnetDecoder over
    the pyramid for Unet_im_recon, the FCN Decoder over the bottom level
    otherwise) through the port's fused op and JAX's plain one: the decode
    and the gradients of a reconstruction loss with respect to the style
    tensors; and a full generation runs and stays finite."""
    from maxstyle_tpu import losses as jlosses
    from maxstyle_tpu.ops import maxstyle as jms
    from maxstyle_tpu_torch import losses as tlosses
    from maxstyle_tpu_torch.ops import maxstyle as tms
    from maxstyle_tpu_torch.ops.maxstyle_kernels import apply_maxstyle_kernels
    from tests.test_torch_port_train_step import style_values

    js, params, stats, ts, nets, x, label = pair
    cfg = js.config.max_style
    values = style_values()  # for a batch of 4
    (z_i, _), _ = js.encode_image(params, stats, jnp.asarray(x), mode="frozen")

    def j_decode(sp, st):
        new = dict(st)

        def hook(idx):
            def f(v):
                out, new[idx] = jms.apply_maxstyle(v, sp[idx], st[idx], cfg)
                return out
            return f
        out, _ = js.decode("image_decoder", params, stats, z_i, mode="frozen",
                           style_fns={idx: hook(idx) for idx in INDEXES})
        return out, new

    jsp, jst = jax_styles(values)
    j_recon, jst = j_decode(jsp, jst)
    j_grads = jax.grad(lambda sp: jlosses.image_recon_loss(j_decode(sp, jst)[0],
                                                           jnp.asarray(x)))(jsp)

    tz_i, _ = ts.encode_image(nets, nchw(x), mode="frozen")
    tsp, tst = port_styles(values)

    def t_decode(sp, st):
        new = dict(st)

        def hook(idx):
            def f(v):
                out, new[idx] = apply_maxstyle_kernels(v, sp[idx], st[idx], ts.config.max_style)
                return out
            return f
        code = [c.detach() for c in tz_i] if isinstance(tz_i, list) else tz_i.detach()
        return ts.decode(nets, "image_decoder", code, mode="frozen",
                         style_fns={idx: hook(idx) for idx in INDEXES}), new

    with torch.no_grad():
        t_recon, tst = t_decode(tsp, tst)
    close(t_recon, np.asarray(j_recon).transpose(0, 3, 1, 2))
    live = {idx: tms.MaxStyleParams(*(t.clone().requires_grad_(True)
                                      for t in tsp[idx].tensors())) for idx in INDEXES}
    recon, _ = t_decode(live, tst)
    leaves = [t for idx in INDEXES for t in live[idx].tensors()]
    grads = torch.autograd.grad(tlosses.image_recon_loss(recon, nchw(x)), leaves,
                                allow_unused=True)
    want = [a for idx in INDEXES for a in (j_grads[idx].lmda, j_grads[idx].gamma_noise,
                                           j_grads[idx].beta_noise)]
    for got, leaf, w in zip(grads, leaves, want):
        got = torch.zeros_like(leaf) if got is None else got
        w = np.asarray(w)
        w = w if w.ndim == 4 and w.shape[-1] == 1 and got.shape[1] == 1 else w.transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got.numpy(), w, rtol=2e-3,
                                   atol=2e-2 * max(float(np.abs(w).max()), 1e-12))
        a, b = got.double().flatten(), torch.from_numpy(np.ascontiguousarray(w)).double().flatten()
        assert float(a @ b / (a.norm() * b.norm() + 1e-30)) > 0.999
    stylized = ts.generate_max_style_image(
        nets, tz_i, reference_segmentation=torch.from_numpy(label).long(),
        ms_cfg=dataclasses.replace(ts.config.max_style, n_iter=1),
        generator=torch.Generator().manual_seed(0))
    assert stylized.shape == (N, 1, HW, HW) and bool(torch.isfinite(stylized).all())


@pytest.mark.parametrize("network_type", ["Unet_16_Unet_im_recon_no_STN",
                                          "Unet_16_Unet_im_recon_enable_code_filter_no_STN"])
def test_one_unet_step_with_maxstyle_matches_jax(network_type):
    base = config(n_iter=1)
    cfg = dataclasses.replace(base, segmentation_model=dataclasses.replace(
        base.segmentation_model, network_type=network_type))
    r = jax_step(cfg, init_cfg=cfg)
    assert r["metrics"]["loss/hard/total"] > 0
    assert_port_step_matches(r)
