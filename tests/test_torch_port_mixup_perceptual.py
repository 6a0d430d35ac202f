"""The port's mixup, window masking and VGG perceptual loss against the JAX
package's ``ops/mixup.py`` and ``ops/perceptual.py``.

Mixup and in/outpainting: JAX's draws, rebuilt from its keys (the
(lam, perm) of ``sample_mixup``; each sample's blocks from
``fold_in(split(key, batch)[b], i)``), are given to the port, whose outputs
must then equal JAX's (rtol 1e-6); the port's own draws are checked
statistically (Beta moments, permutations, block ranges, the keep rate, the
noise's mean, and the masked share against JAX's over 400 samples).

The VGG loss runs on the small-channel VGG16-shaped plan and the synthetic
torchvision-layout state dict of tests/test_perceptual_parity.py (the plan
monkeypatched into both packages), at rtol 1e-4 (a deep conv stack in two
summation orders), with its gradient at rtol 1e-3 / atol 1e-3 of the
largest: gray and RGB inputs below 224 (bilinear upsampling), above it
(jax.image.resize's antialiased shrink) and one of each axis, without the
resize, and a subset of blocks; the JAX layout's .npz loads into both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.ops import mixup as jm
from maxstyle_tpu.ops import perceptual as jp
from maxstyle_tpu_torch.ops import mixup as tm
from maxstyle_tpu_torch.ops import perceptual as tp
from tests.test_perceptual_parity import make_tv_sd
from tests.test_torch_port_losses_menu import close, labels, logits, nchw

SMALL_PLAN = [(8, 2), (16, 2), (24, 3), (32, 3), (32, 3)]


def jax_mixup_draw(key, batch, alpha=0.2):
    d = jm.sample_mixup(key, batch, alpha)
    return tm.MixupDraw(lam=torch.tensor(float(d.lam)),
                        perm=torch.from_numpy(np.array(d.perm)).long())


def test_mixup_data_and_loss_match_with_jax_draws():
    key = jax.random.key(3)
    x = np.random.RandomState(0).rand(4, 12, 12, 1).astype(np.float32)
    y = labels(1, (4, 12, 12))
    jd = jm.sample_mixup(key, 4)
    td = jax_mixup_draw(key, 4)
    xm, ym = tm.mixup_data(td, nchw(x), torch.from_numpy(y), 4)
    jxm, jym = jm.mixup_data(jd, jnp.asarray(x), jnp.asarray(y), 4)
    close(xm, np.moveaxis(np.asarray(jxm), -1, 1), rtol=1e-6)
    close(ym, np.moveaxis(np.asarray(jym), -1, 1), rtol=1e-6)
    lg = logits(2, (4, 12, 12, 4))
    close(tm.mixup_loss(nchw(lg), torch.from_numpy(y), td, 4),
          jm.mixup_loss(jnp.asarray(lg), jnp.asarray(y), jd, 4), rtol=1e-5)


def jax_block_draws(key, batch, h, w, cnt=5, keep_prob=0.95):
    """``_random_blocks_mask``'s draws from its key, as ``tm.draw_blocks``
    lays them out."""
    out = {k: np.zeros((batch, cnt), np.int64) for k in ("bh", "bw", "y0", "x0")}
    out["go"] = np.zeros((batch, cnt), bool)
    for b, k in enumerate(jax.random.split(key, batch)):
        for i in range(cnt):
            ks = jax.random.split(jax.random.fold_in(k, i), 5)
            out["bh"][b, i] = int(jax.random.randint(ks[0], (), h // 6, h // 3 + 1))
            out["bw"][b, i] = int(jax.random.randint(ks[1], (), w // 6, w // 3 + 1))
            out["y0"][b, i] = int(jax.random.randint(ks[2], (), 3, h - h // 3 - 3))
            out["x0"][b, i] = int(jax.random.randint(ks[3], (), 3, w - w // 3 - 3))
            out["go"][b, i] = bool(jax.random.uniform(ks[4]) < keep_prob)
    return {k: torch.from_numpy(v) for k, v in out.items()}


@pytest.mark.parametrize("outpaint", [False, True])
def test_window_masking_matches_with_jax_draws(outpaint):
    key = jax.random.key(5)
    img = np.random.RandomState(4).rand(3, 36, 30, 2).astype(np.float32)
    k_mask, k_noise = jax.random.split(key)
    draws = {"blocks": jax_block_draws(k_mask, 3, 36, 30),
             "noise": nchw(np.asarray(jax.random.uniform(k_noise, img.shape)))}
    mask = tm._random_blocks_mask(draws["blocks"], 36, 30)
    close(mask, np.moveaxis(np.asarray(jm._random_blocks_mask(k_mask, 3, 36, 30)), -1, 1))
    t_fn, j_fn = ((tm.random_outpainting, jm.random_outpainting) if outpaint
                  else (tm.random_inpainting, jm.random_inpainting))
    close(t_fn(nchw(img), draws), np.moveaxis(np.asarray(j_fn(key, jnp.asarray(img))), -1, 1),
          rtol=1e-6)


def test_port_draws_statistics():
    g = torch.Generator().manual_seed(0)
    lams = torch.stack([tm.sample_mixup(g, 6, 0.2).lam for _ in range(4000)]).double()
    # Beta(0.2, 0.2): mean 1/2, variance 1 / (4 (2 alpha + 1)) = 0.1786
    assert abs(float(lams.mean()) - 0.5) < 0.02
    assert abs(float(lams.var()) - 1 / 5.6) < 0.01
    perm = tm.sample_mixup(g, 6).perm
    assert sorted(perm.tolist()) == list(range(6))

    h, w, n = 48, 40, 400
    blocks = tm.draw_blocks(g, n, h, w)
    assert int(blocks["bh"].min()) == h // 6 and int(blocks["bh"].max()) == h // 3
    assert int(blocks["bw"].min()) == w // 6 and int(blocks["bw"].max()) == w // 3
    assert int(blocks["y0"].min()) == 3 and int(blocks["y0"].max()) == h - h // 3 - 4
    assert int(blocks["x0"].min()) == 3 and int(blocks["x0"].max()) == w - w // 3 - 4
    assert abs(float(blocks["go"].double().mean()) - 0.95) < 0.015
    covered = tm._random_blocks_mask(blocks, h, w).mean(dim=(1, 2, 3)).double()
    jax_covered = np.asarray(jm._random_blocks_mask(jax.random.key(1), n, h, w)).mean((1, 2, 3))
    # the masked share of a sample: same distribution (means within 4 standard errors)
    se = np.sqrt(covered.var().item() / n + jax_covered.var() / n)
    assert abs(float(covered.mean()) - jax_covered.mean()) < 4 * se
    noise = tm.draw_window_masking(g, (8, 1, h, w))["noise"]
    assert abs(float(noise.mean()) - 0.5) < 0.01 and 0.0 <= float(noise.min())


@pytest.fixture()
def small_plan(monkeypatch):
    monkeypatch.setattr(jp, "_VGG16_PLAN", SMALL_PLAN)
    monkeypatch.setattr(tp, "_VGG16_PLAN", SMALL_PLAN)
    return SMALL_PLAN


@pytest.mark.parametrize("shape,layers,resize", [
    ((2, 48, 48, 1), (1, 2, 3, 4), True),
    ((2, 40, 56, 3), (1, 2, 3, 4), True),
    ((1, 256, 288, 1), (1, 2, 3, 4), True),
    ((1, 250, 180, 1), (1, 3), True),
    ((2, 32, 32, 1), (2, 4), False),
])
def test_vgg_perceptual_loss_matches(small_plan, shape, layers, resize):
    rng = np.random.RandomState(0)
    tv = make_tv_sd(rng, small_plan)
    sd = tp.convert_vgg16_torchvision(tv)
    params = jp.convert_vgg16_torchvision({k: v.numpy() for k, v in tv.items()})
    x = rng.rand(*shape).astype(np.float32)
    y = rng.rand(*shape).astype(np.float32)
    want = jp.vgg_perceptual_loss(jnp.asarray(x), jnp.asarray(y), variables={"params": params},
                                  layers=layers, resize=resize)
    xt = nchw(x).requires_grad_(True)
    got = tp.vgg_perceptual_loss(xt, nchw(y), state_dict=sd, layers=layers, resize=resize)
    close(got, want, rtol=1e-4)
    got.backward()
    jg = np.asarray(jax.grad(lambda p: jp.vgg_perceptual_loss(
        p, jnp.asarray(y), variables={"params": params}, layers=layers, resize=resize))(
        jnp.asarray(x)))
    np.testing.assert_allclose(np.moveaxis(xt.grad.numpy(), 1, -1), jg, rtol=1e-3,
                               atol=1e-3 * float(np.abs(jg).max()))


def test_npz_weights_load_into_both(small_plan, tmp_path):
    rng = np.random.RandomState(1)
    params = jp.convert_vgg16_torchvision({k: v.numpy() for k, v in
                                           make_tv_sd(rng, small_plan).items()})
    path = tmp_path / "vgg.npz"
    np.savez(path, **{f"{name}/{leaf}": a for name, leaves in params.items()
                      for leaf, a in leaves.items()})
    x, y = rng.rand(1, 40, 40, 1).astype(np.float32), rng.rand(1, 40, 40, 1).astype(np.float32)
    close(tp.vgg_perceptual_loss(nchw(x), nchw(y), weights_path=str(path)),
          jp.vgg_perceptual_loss(jnp.asarray(x), jnp.asarray(y), weights_path=str(path)),
          rtol=1e-4)
    sd = tp.load_vgg_params(str(path))
    assert set(sd) == set(tp.VGG16Features(n_blocks=5).state_dict())


def test_seeded_init_and_identical_inputs(small_plan):
    """Without weights the trunk is flax's init drawn from seed 0 (JAX's
    key(0) draws cannot be reproduced): the same loss every call, LeCun
    scale truncated at two standard deviations, zero biases; identical
    inputs give 0."""
    x = torch.rand(1, 1, 32, 32, generator=torch.Generator().manual_seed(2))
    y = torch.rand(1, 1, 32, 32, generator=torch.Generator().manual_seed(3))
    a = tp.vgg_perceptual_loss(x, y)
    assert torch.isfinite(a) and float(a) > 0
    assert float(tp.vgg_perceptual_loss(x, y)) == float(a)
    assert abs(float(tp.vgg_perceptual_loss(x, x))) < 1e-6
    sd0, sd1 = tp.VGG16Features(seed=0).state_dict(), tp.VGG16Features(seed=1).state_dict()
    w, std = sd0["block2_conv1.weight"], (1.0 / (8 * 9)) ** 0.5
    assert abs(float(w.std()) - std) < 0.05 * std
    assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6
    assert not torch.equal(w, sd1["block2_conv1.weight"]) and not sd0["block1_conv1.bias"].any()
