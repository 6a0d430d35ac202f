"""RandConv, AdvNoise and AdvBias of the port against the JAX package's.

* RandConv: each kernel size k in {1, 3, 5, 7} through the ``fixed`` hook
  (numpy weights), and the random path with JAX's own draws (k, the 7x7
  weights, alpha) from its key splits; rtol 1e-5.
* The bias field: the per-axis resize matrices bit-equal to the formula
  of ``jax.image.resize`` (its ``compute_weight_mat``, run op by op) at the
  Prostate and ACDC shapes (bicubic 5 -> 56 and 5 -> 96, bilinear 56 -> 224
  and 96 -> 192) and the whole-step tests' (32^2); the resize and the field
  against ``jax.image.resize`` at atol 1e-6 at the whole-step tests' size,
  and the field at the published sizes against its float64 value at atol
  1e-6. ``jax.image.resize`` itself lies up to 2.2e-6 from that float64
  value there (its weights are computed inside jit, where XLA's fused
  arithmetic moves them by up to 4.8e-7), so at those sizes the port is
  held to it at 3e-6. ``F.interpolate``'s bicubic is shown to differ.
* Both attacks through a small conv net defined alike on both sides from
  numpy weights, with JAX's draws (AdvNoise's d, AdvBias's control points):
  the attacked image and the consistency loss at rtol 1e-5, the loss's
  gradients with respect to the net's weights at rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax._src.image import scale as jscale

from maxstyle_tpu.ops import advchain as jadv
from maxstyle_tpu.ops import randconv as jrc
from maxstyle_tpu_torch.ops import advchain as tadv
from maxstyle_tpu_torch.ops import randconv as trc

torch.set_num_threads(2)


def nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def image(seed, n=3, h=20, w=24, c=1):
    return np.random.RandomState(seed).rand(n, h, w, c).astype(np.float32)


@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("c", [1, 3])
def test_rand_conv_fixed_kernel_matches_jax(k, c):
    x = image(k, c=c)
    w = np.random.RandomState(10 + k).randn(k, k, c, c).astype(np.float32) / k
    alpha = 0.3
    want = jrc.rand_conv_augment(jax.random.key(0), jnp.asarray(x), fixed=(k, w, alpha))
    got = trc.rand_conv_augment(nchw(x), fixed=(k, w, alpha))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-6)


def jax_rand_conv_draws(key, c):
    _, k_size, k_w, k_alpha = jax.random.split(key, 4)
    idx = int(jax.random.randint(k_size, (), 0, len(jrc.KERNEL_CANDIDATES)))
    w = np.asarray(jax.random.normal(k_w, (7, 7, c, c))).transpose(3, 2, 0, 1)
    return {"k": torch.tensor(jrc.KERNEL_CANDIDATES[idx]), "w": torch.from_numpy(np.array(w)),
            "alpha": torch.tensor(float(jax.random.uniform(k_alpha)))}


def test_rand_conv_random_path_matches_jax_at_every_kernel_size():
    sizes = set()
    for seed in range(12):
        x = image(seed)
        key = jax.random.key(seed)
        draws = jax_rand_conv_draws(key, 1)
        sizes.add(int(draws["k"]))
        want = jrc.rand_conv_augment(key, jnp.asarray(x))
        got = trc.rand_conv_augment(nchw(x), draws)
        np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                                   rtol=1e-5, atol=1e-6)
    assert sizes == {1, 3, 5, 7}
    d = trc.draw_rand_conv(torch.Generator().manual_seed(0), 2)
    assert int(d["k"]) in trc.KERNEL_CANDIDATES and d["w"].shape == (2, 2, 7, 7)


@pytest.mark.parametrize("n_in,n_out,method", [(5, 56, "bicubic"), (5, 96, "bicubic"),
                                                (56, 224, "bilinear"), (96, 192, "bilinear"),
                                                (5, 8, "bicubic"), (16, 32, "bilinear"),
                                                (7, 3, "bicubic"), (9, 4, "bilinear")])
def test_resize_weights_equal_jax_formula(n_in, n_out, method):
    kernel = {"bicubic": jscale._fill_keys_cubic_kernel,
              "bilinear": jscale._fill_triangle_kernel}[method]
    want = np.asarray(jscale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, kernel, True))
    np.testing.assert_array_equal(tadv.resize_weights_np(n_in, n_out, method), want.T)


@pytest.mark.parametrize("n_in,n_out,method", [(5, 8, "bicubic"), (5, 16, "bicubic"),
                                                (8, 32, "bilinear"), (16, 32, "bilinear"),
                                                (7, 3, "bicubic"), (9, 4, "bilinear")])
def test_resize_matches_jax_image_resize(n_in, n_out, method):
    x = np.random.RandomState(n_in).uniform(-1, 1, (2, n_in, n_in + 1, 1)).astype(np.float32)
    m = n_out + 3
    want = jax.image.resize(jnp.asarray(x), (2, n_out, m, 1), method=method)
    got = tadv.resize(nchw(x), (n_out, m), method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)


def float64_field(cp, hw, downscale):
    low = hw[0] // downscale
    a = tadv.resize_weights_np(cp.shape[1], low, "bicubic").astype(np.float64)
    b = tadv.resize_weights_np(low, hw[0], "bilinear").astype(np.float64)
    field = np.einsum("yh,nhw,xw->nyx", a, cp[..., 0].astype(np.float64), a)
    return np.einsum("yh,nhw,xw->nyx", b, field, b)[:, None]


@pytest.mark.parametrize("hw,downscale", [((224, 224), 4), ((192, 192), 2), ((32, 32), 4),
                                          ((32, 32), 2)])
def test_bias_field_matches_jax_and_not_torch_bicubic(hw, downscale):
    cp = np.random.RandomState(0).uniform(-1, 1, (2, 5, 5, 1)).astype(np.float32)
    want = np.asarray(jadv.bias_field_from_control_points(jnp.asarray(cp), hw, downscale))
    got = tadv.bias_field_from_control_points(nchw(cp), hw, downscale)
    np.testing.assert_allclose(got.numpy(), float64_field(cp, hw, downscale), rtol=0, atol=1e-6)
    if hw[0] <= 32:
        np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2), rtol=0, atol=1e-6)
    else:
        # jax.image.resize computes its weights inside jit, where XLA's fused
        # arithmetic moves them by up to 4.8e-7 from the formula: at the
        # published sizes its field lies up to 2.2e-6 from the float64 one
        np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2), rtol=0, atol=3e-6)
    low = (hw[0] // downscale, hw[1] // downscale)
    torch_bicubic = F.interpolate(F.interpolate(nchw(cp), size=low, mode="bicubic"),
                                  size=hw, mode="bilinear")
    assert float((torch_bicubic - got).abs().max()) > 0.05
    assert tadv.control_grid_shape(hw) == (5, 5)


NC = 3


def net_weights(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, 3, 1, 6).astype(np.float32) * 0.5,
            rng.randn(1, 1, 6, NC).astype(np.float32) * 0.5)


def jax_net(ws):
    w1, w2 = ws

    def f(x):
        dn = ("NHWC", "HWIO", "NHWC")
        h = jnp.tanh(jax.lax.conv_general_dilated(x, w1, (1, 1), "SAME",
                                                  dimension_numbers=dn))
        return jax.lax.conv_general_dilated(h, w2, (1, 1), "SAME", dimension_numbers=dn)
    return f


def torch_net(ws):
    w1, w2 = ws

    def f(x):
        return F.conv2d(torch.tanh(F.conv2d(x, w1, padding=1)), w2)
    return f


@pytest.mark.parametrize("kind", ["adv_noise", "adv_bias"])
@pytest.mark.parametrize("seed", [0, 1])
def test_attacks_match_jax(kind, seed):
    x = image(seed, n=2, h=16, w=16)
    ws = net_weights(seed)
    p0 = np.random.RandomState(5 + seed).randn(2, 16, 16, NC).astype(np.float32)
    key = jax.random.key(20 + seed)
    if kind == "adv_noise":
        def j(w):
            return jadv.adv_noise_attack(jax_net(w), jnp.asarray(x), jnp.asarray(p0), key=key)
        draws = {"d": nchw(jax.random.normal(key, x.shape))}
        attack = tadv.adv_noise_attack
    else:
        def j(w):
            return jadv.adv_bias_attack(jax_net(w), jnp.asarray(x), jnp.asarray(p0), key=key,
                                        downscale=2)
        draws = {"cp": nchw(jax.random.uniform(key, (2, 5, 5, 1), minval=-1.0, maxval=1.0))}

        def attack(*a, **kw):
            return tadv.adv_bias_attack(*a, downscale=2, **kw)
    j_adv, j_loss = j([jnp.asarray(w) for w in ws])
    j_grads = jax.grad(lambda w: j(w)[1])([jnp.asarray(w) for w in ws])

    t_ws = [torch.from_numpy(np.array(w.transpose(3, 2, 0, 1))).requires_grad_(True)
            for w in ws]
    t_adv, t_loss = attack(torch_net(t_ws), nchw(x), nchw(p0), draws)
    t_loss.backward()
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-5)
    for tw, jg in zip(t_ws, j_grads):
        jg = np.asarray(jg).transpose(3, 2, 0, 1)
        np.testing.assert_allclose(tw.grad.numpy(), jg, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(jg).max()))


def test_compose_chains_noise_then_bias():
    x = image(3, n=2, h=16, w=16)
    ws = net_weights(3)
    p0 = np.random.RandomState(9).randn(2, 16, 16, NC).astype(np.float32)
    key = jax.random.key(7)
    want_x, want = jadv.compose_adversarial_attack(
        jax_net([jnp.asarray(w) for w in ws]), jnp.asarray(x), jnp.asarray(p0),
        transforms=("noise", "bias"), key=key)
    k0, k1 = jax.random.fold_in(key, 0), jax.random.fold_in(key, 1)
    draws = [{"d": nchw(jax.random.normal(k0, x.shape))},
             {"cp": nchw(jax.random.uniform(k1, (2, 5, 5, 1), minval=-1.0, maxval=1.0))}]
    t_ws = [torch.from_numpy(np.array(w.transpose(3, 2, 0, 1))) for w in ws]
    got_x, got = tadv.compose_adversarial_attack(torch_net(t_ws), nchw(x), nchw(p0), draws,
                                                 transforms=("noise", "bias"))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
