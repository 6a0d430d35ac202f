"""The port's KL, contour and consistency losses against the JAX package's.

The method branches use ``kl_divergence`` (AdvNoise), ``contour_loss``
through its dense Sobel, and ``segmentation_consistency`` with the "kl"
and "contour" divergences at scale 0 (AdvBias). Same numpy inputs on both
sides; forward rtol 1e-5, gradients rtol 1e-4 (atol 1e-4 of the largest
gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu import losses as jl
from maxstyle_tpu_torch import losses as tl

torch.set_num_threads(2)


def nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def logits(seed, n=2, h=12, w=10, c=3, scale=2.0):
    return (scale * np.random.RandomState(seed).randn(n, h, w, c)).astype(np.float32)


def assert_grads_close(got, want):
    want = np.asarray(want).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_dense_sobel_sums_channels_then_broadcasts():
    x = logits(0, c=3)
    gx, gy = jl._dense_sobel(jnp.asarray(x))
    tx, ty = tl._dense_sobel(nchw(x))
    np.testing.assert_allclose(tx.numpy(), np.asarray(gx).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(gy).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(tx[:, 0], tx[:, 2])


def test_kl_divergence_and_its_gradient_match_jax():
    ref, pred = logits(1), logits(2)
    want, jg = jax.value_and_grad(lambda p: jl.kl_divergence(jnp.asarray(ref), p))(
        jnp.asarray(pred))
    tp = nchw(pred).requires_grad_(True)
    got = tl.kl_divergence(nchw(ref), tp)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert_grads_close(tp.grad, jg)


@pytest.mark.parametrize("one_hot_target", [True, False])
def test_contour_loss_matches_jax(one_hot_target):
    probs = jax.nn.softmax(jnp.asarray(logits(3, c=4)), axis=-1)
    if one_hot_target:
        tgt = np.random.RandomState(4).randint(0, 4, (2, 12, 10)).astype(np.int32)
        t_tgt = torch.from_numpy(tgt).long()
    else:
        tgt = np.asarray(jax.nn.softmax(jnp.asarray(logits(4, c=4)), axis=-1))
        t_tgt = nchw(tgt)
    mask = (np.random.RandomState(5).rand(2, 12, 10, 1) > 0.3).astype(np.float32)

    def j(p):
        return jl.contour_loss(p, jnp.asarray(tgt), num_classes=4,
                               one_hot_target=one_hot_target, mask=jnp.asarray(mask))

    want, jg = jax.value_and_grad(j)(probs)
    tp = nchw(probs).requires_grad_(True)
    got = tl.contour_loss(tp, t_tgt, num_classes=4, one_hot_target=one_hot_target,
                          mask=nchw(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert_grads_close(tp.grad, jg)


@pytest.mark.parametrize("types,weights", [(("kl", "contour"), (1.0, 0.5)), (("kl",), (1.0,)),
                                           (("contour",), (1.0,))])
@pytest.mark.parametrize("c", [2, 4])
def test_segmentation_consistency_matches_jax(types, weights, c):
    out, ref = logits(6, c=c), logits(7, c=c)

    def j(o):
        return jl.segmentation_consistency(o, jnp.asarray(ref), divergence_types=types,
                                           divergence_weights=weights)

    want, jg = jax.value_and_grad(j)(jnp.asarray(out))
    to = nchw(out).requires_grad_(True)
    got = tl.segmentation_consistency(to, nchw(ref), divergence_types=types,
                                      divergence_weights=weights)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert_grads_close(to.grad, jg)


def test_unported_consistency_options_raise():
    """Every divergence and scale of the JAX package is ported
    (test_torch_port_losses_menu.py holds them); an unknown divergence
    raises, as in the JAX package."""
    x = nchw(logits(8))
    with pytest.raises(NotImplementedError):
        tl.segmentation_consistency(x, x, divergence_types=("hinge",), divergence_weights=(1.0,))
    assert torch.isfinite(tl.segmentation_consistency(x, x, divergence_types=("mse",),
                                                      divergence_weights=(1.0,), scales=(0, 1)))
