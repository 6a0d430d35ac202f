"""``if_sn`` (flax ``nn.SpectralNorm`` over every conv of a down block) in
the port against the JAX package's ``ResConvDown(if_sn=True)`` and the
encoder, with the weights, ``u`` and ``sigma`` carried across by
``convert.py``; the cases of ``tests/test_models.py::TestSpectralNorm``.

Held: the block's forward in "train" (batch statistics) and "eval" at
rtol 1e-5 / atol 1e-5, the stored ``u`` and ``sigma`` after a "train"
pass (and unchanged after "frozen" and "eval"), the kernel gradients of
the output's sum at rtol 1e-4 / atol 1e-5 of the largest, sigma's
convergence to the top singular value over 30 training passes (rtol 1e-2,
the JAX test's bar), and the encoder's plumbing. The domain-specific
quirk stays: without ``if_sn`` a DS block's conv1 is ``TorchSNConv3x3``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.models import encoder_decoder as jed
from maxstyle_tpu.models.layers import ResConvDown as JResConvDown
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.models import encoder_decoder as ted
from maxstyle_tpu_torch.models import layers as tl

torch.set_num_threads(2)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@functools.lru_cache(maxsize=None)
def jax_block(num_domains):
    x = np.random.RandomState(0).rand(2, 16, 16, 4).astype(np.float32)
    jm = JResConvDown(8, if_sn=True, num_domains=num_domains)
    return jm, jm.init(jax.random.key(0), jnp.asarray(x), train=True), x


def block_pair(num_domains=1):
    """The JAX block (initialised once) and a fresh port block with its
    weights and spectral-norm state."""
    jm, v, x = jax_block(num_domains)
    tm = tl.ResConvDown(4, 8, if_sn=True, num_domains=num_domains)
    tm.load_state_dict(convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                         v["params"]),
                                                  jax.tree_util.tree_map(np.asarray,
                                                                         v["batch_stats"])),
                       strict=True)
    return jm, v, tm, x


def test_every_conv_of_the_block_is_spectral_normed_and_converts():
    jm, v, tm, _ = block_pair()
    groups = [k for k in v["batch_stats"] if k.startswith("SpectralNorm")]
    assert len(groups) == 4
    for name in ("down", "conv1", "conv2", "conv_input"):
        conv = getattr(tm, name)
        assert isinstance(conv, tl.SpectralNormConv2d)
        assert conv.u.shape == (1, conv.weight.shape[0]) and conv.sigma.shape == ()
    assert isinstance(tl.ResConvDown(4, 8, num_domains=2).conv1, tl.TorchSNConv3x3)
    assert isinstance(tl.ResConvDown(4, 8, num_domains=2, if_sn=True).conv1,
                      tl.SpectralNormConv2d)


@pytest.mark.parametrize("num_domains", [1, 2])
def test_block_forward_stats_and_grads_match_jax(num_domains):
    jm, v, tm, x = block_pair(num_domains)
    # "train": batch statistics, u and sigma written
    out_j, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    out_t = tm(nchw(x), "train")
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    want = convert.flax_to_state_dict({}, jax.tree_util.tree_map(np.asarray,
                                                                 mut["batch_stats"]))
    sd = tm.state_dict()
    for key, w in want.items():
        if key.endswith((".u", ".sigma")):
            np.testing.assert_allclose(sd[key].numpy(), w.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=key)
    # "frozen" and "eval" compute the same power iteration and write nothing
    before = {k: t.clone() for k, t in sd.items() if k.endswith((".u", ".sigma"))}
    for mode in ("frozen", "eval"):
        tm(nchw(x), mode)
        assert all(torch.equal(tm.state_dict()[k], t) for k, t in before.items()), mode
    v2 = {"params": v["params"], "batch_stats": mut["batch_stats"]}
    ev_j = jm.apply(v2, jnp.asarray(x), train=False)
    np.testing.assert_allclose(tm(nchw(x), "eval").detach().numpy(),
                               np.asarray(ev_j).transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-5)

    # gradients of the "eval" output's sum with respect to every kernel
    def j_loss(p):
        return jnp.sum(jm.apply({"params": p, "batch_stats": mut["batch_stats"]},
                                jnp.asarray(x), train=False))

    g_j = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            jax.grad(j_loss)(v["params"])))
    tm.zero_grad()
    tm(nchw(x), "eval").sum().backward()
    for name, p in tm.named_parameters():
        if name.endswith("weight") and p.dim() == 4:
            g = g_j[name]
            np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=1e-4,
                                       atol=1e-5 * float(g.abs().max()), err_msg=name)


def test_sigma_converges_to_top_singular_value():
    _, _, tm, x = block_pair()
    for _ in range(30):
        tm(nchw(x), "train")
    w = tm.conv1.weight.detach().numpy()
    true_sigma = np.linalg.svd(w.reshape(w.shape[0], -1), compute_uv=False)[0]
    np.testing.assert_allclose(float(tm.conv1.sigma), true_sigma, rtol=1e-2)


def test_encoder_if_sn_plumbing_matches_jax():
    x = np.random.RandomState(1).rand(1, 32, 32, 1).astype(np.float32)
    jenc = jed.DualBranchEncoder(z_level_1_ch=16, z_level_2_ch=16, feature_reduce=8,
                                 if_sn=True)
    v = jenc.init(jax.random.key(0), jnp.asarray(x), train=False)
    z_j, zs_j = jenc.apply(v, jnp.asarray(x), train=False)
    tenc = ted.DualBranchEncoder(1, 16, 16, feature_reduce=8, if_sn=True)
    tenc.load_state_dict(convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, v["params"]),
        jax.tree_util.tree_map(np.asarray, v["batch_stats"])), strict=True)
    with torch.no_grad():
        z_t, zs_t = tenc(nchw(x), "eval")
    assert z_t.shape == zs_t.shape == (1, 16, 2, 2)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(zs_t.numpy(), np.asarray(zs_j).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-5)
