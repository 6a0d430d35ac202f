"""The port's ``losses_extra`` against the JAX package's at float32.

All thirteen functions on seeded numpy inputs (NHWC on the JAX side, NCHW
on the port's), values at rtol 1e-5 / atol 1e-6 and, for the losses a model
is trained through, the gradient with respect to the first input at rtol
1e-4 / atol 1e-4 of the largest gradient (the two sides sum in different
orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu import losses_extra as je
from maxstyle_tpu_torch import losses_extra as te
from tests.test_torch_port_losses_menu import close, grad_close, image, labels, logits, nchw


def test_gram_matrix_and_style_loss():
    a, b = logits(0, (2, 8, 8, 6)), logits(1, (2, 8, 8, 6))
    close(te.gram_matrix_2d(nchw(a)), je.gram_matrix_2d(jnp.asarray(a)), atol=1e-5)
    close(te.style_loss(nchw(a), nchw(b)), je.style_loss(jnp.asarray(a), jnp.asarray(b)))
    grad_close(lambda p: te.style_loss(p, nchw(b)),
               lambda p: je.style_loss(p, jnp.asarray(b)), a)


@pytest.mark.parametrize("margin", [1.0, 30.0])
def test_contrastive_and_triplet(margin):
    a, b, c = logits(2, (4, 4, 4, 3)), logits(3, (4, 4, 4, 3)), logits(4, (4, 4, 4, 3))
    lab = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    close(te.contrastive_loss(nchw(a), nchw(b), torch.from_numpy(lab), margin),
          je.contrastive_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(lab), margin),
          atol=1e-4)
    grad_close(lambda p: te.contrastive_loss(p, nchw(b), torch.from_numpy(lab), margin),
               lambda p: je.contrastive_loss(p, jnp.asarray(b), jnp.asarray(lab), margin), a)
    close(te.triplet_loss(nchw(a), nchw(b), nchw(c), margin),
          je.triplet_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), margin))
    grad_close(lambda p: te.triplet_loss(p, nchw(b), nchw(c)),
               lambda p: je.triplet_loss(p, jnp.asarray(b), jnp.asarray(c)), a)


def test_brier_and_cross_entropy_3d():
    x, y = logits(5), labels(6)
    close(te.brier_loss(nchw(x), torch.from_numpy(y)),
          je.brier_loss(jnp.asarray(x), jnp.asarray(y)))
    grad_close(lambda p: te.brier_loss(p, torch.from_numpy(y)),
               lambda p: je.brier_loss(p, jnp.asarray(y)), x)
    x3, y3 = logits(7, (2, 3, 8, 8, 4)), labels(8, (2, 3, 8, 8))
    for w in (None, (0.1, 0.2, 0.3, 0.4)):
        for avg in (True, False):
            close(te.cross_entropy_3d(nchw(x3), torch.from_numpy(y3), weight=w, size_average=avg),
                  je.cross_entropy_3d(jnp.asarray(x3), jnp.asarray(y3), weight=w,
                                      size_average=avg), atol=1e-4)
    grad_close(lambda p: te.cross_entropy_3d(p, torch.from_numpy(y3)),
               lambda p: je.cross_entropy_3d(p, jnp.asarray(y3)), x3)


@pytest.mark.parametrize("window", [9, 4, 5])
def test_ncc_and_local_ncc(window):
    x, y = image(9, (2, 20, 18, 1)), image(10, (2, 20, 18, 1))
    close(te.ncc_loss(nchw(x), nchw(y)), je.ncc_loss(jnp.asarray(x), jnp.asarray(y)))
    grad_close(lambda p: te.ncc_loss(p, nchw(y)), lambda p: je.ncc_loss(p, jnp.asarray(y)), x)
    close(te.local_ncc_loss(nchw(x), nchw(y), window),
          je.local_ncc_loss(jnp.asarray(x), jnp.asarray(y), window), rtol=1e-4)
    grad_close(lambda p: te.local_ncc_loss(p, nchw(y), window),
               lambda p: je.local_ncc_loss(p, jnp.asarray(y), window), x)


@pytest.mark.parametrize("beta", [1.0 / 9, 0.5])
def test_smooth_l1_and_laplacian(beta):
    x, y = logits(11, scale=0.3), logits(12, scale=0.3)
    close(te.smooth_l1_loss(nchw(x), nchw(y), beta),
          je.smooth_l1_loss(jnp.asarray(x), jnp.asarray(y), beta))
    grad_close(lambda p: te.smooth_l1_loss(p, nchw(y), beta),
               lambda p: je.smooth_l1_loss(p, jnp.asarray(y), beta), x)
    close(te.laplacian_smoothness_loss(nchw(x)), je.laplacian_smoothness_loss(jnp.asarray(x)))
    grad_close(te.laplacian_smoothness_loss, je.laplacian_smoothness_loss, x)


def test_hierarchical_loss():
    y = labels(13)
    multi = [logits(14, (2, 16, 16, 2)), logits(15, (2, 16, 16, 3)), logits(16)]
    for w in ((1.0, 1.0, 1.0), (0.5, 0.3, 0.2)):
        close(te.hierarchical_loss([nchw(m) for m in multi], torch.from_numpy(y), w),
              je.hierarchical_loss([jnp.asarray(m) for m in multi], jnp.asarray(y), w))


@pytest.mark.parametrize("threshold", [0.5, 0.8])
def test_semi_supervised_helpers(threshold):
    x = logits(17, scale=1.5)
    p = np.asarray(je.sharpen_predictions(jnp.asarray(x), 1.0))  # the softmax
    got = te.filter_unlabelled_predictions(nchw(p), threshold)
    want = je.filter_unlabelled_predictions(jnp.asarray(p), threshold)
    close(got, np.moveaxis(np.asarray(want), -1, 1))
    assert 0.0 < float(got.mean()) < 1.0
    for t in (0.5, 2.0):
        close(te.sharpen_predictions(nchw(x), t),
              np.moveaxis(np.asarray(je.sharpen_predictions(jnp.asarray(x), t)), -1, 1))
