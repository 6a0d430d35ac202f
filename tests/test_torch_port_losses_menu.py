"""The port's loss library against the JAX package's ``losses.py`` at float32.

Seeded numpy inputs go through both (NHWC on the JAX side, NCHW on the
port's). Every value is held at rtol 1e-5 / atol 1e-6 and every gradient
with respect to the trained input at rtol 1e-4 / atol 1e-4 of the largest
gradient (the two sides sum in different orders). Covered: the NGF
reconstruction loss and its pieces (the 7x7 blur of sigma 1, zero "SAME" padding, a
stop-gradient target), the soft-target cross entropy (mask, is_gt, class
weights), soft Dice (masks, soft targets, squared union, class subsets, 3D
labels), focal, the entropies, JS, TV, the cosine loss, every
``basic_loss_fn`` type, and ``segmentation_consistency`` with every
divergence at scales 0, 1 and 2 with masks and ``is_gt``. Unknown types
still raise NotImplementedError, as in the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu import losses as jl
from maxstyle_tpu_torch import losses as tl

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4


def nchw(a):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def to_nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def logits(seed, shape=(2, 16, 16, 4), scale=3.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def labels(seed, shape=(2, 16, 16), classes=4):
    return np.random.RandomState(seed).randint(0, classes, shape).astype(np.int32)


def image(seed, shape=(2, 24, 24, 1)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got,
                                          np.float64),
                               np.asarray(want, np.float64), rtol=rtol, atol=atol)


def grad_close(fn_t, fn_j, x):
    """The gradient of a scalar loss with respect to its first (NHWC) input."""
    xt = nchw(x).requires_grad_(True)
    fn_t(xt).backward()
    want = np.asarray(jax.grad(fn_j)(jnp.asarray(x)))
    got = to_nhwc(xt.grad)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * float(np.abs(want).max()) + 1e-9)


# ---------------------------------------------------------------------------
# NGF
# ---------------------------------------------------------------------------


def test_gaussian_blur_is_7x7_zero_padded():
    x = image(0)
    got = tl._gaussian_blur3(nchw(x))
    close(got, np.moveaxis(np.asarray(jl._gaussian_blur3(jnp.asarray(x))), -1, 1))
    k = tl._gaussian_kernel(1.0, 1, torch.device("cpu"))
    assert k.shape == (1, 1, 7, 7)
    # zero padding: a constant image darkens at the rim
    one = tl._gaussian_blur3(torch.ones(1, 1, 9, 9))
    assert float(one[0, 0, 4, 4]) == pytest.approx(1.0, abs=1e-6)
    assert float(one[0, 0, 0, 0]) < 0.6


def test_normalized_cross_correlation_matches():
    x, y = image(1, (3, 8, 8, 2)), image(2, (3, 8, 8, 2))
    close(tl.normalized_cross_correlation(nchw(x), nchw(y)),
          jl.normalized_cross_correlation(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("shape", [(2, 24, 24, 1), (3, 17, 21, 1)])
def test_ngf_loss_value_and_gradient(shape):
    x, y = image(3, shape), image(4, shape)
    close(tl.ngf_loss(nchw(x), nchw(y)), jl.ngf_loss(jnp.asarray(x), jnp.asarray(y)))
    close(tl.image_recon_loss(nchw(x), nchw(y), "ngf"),
          jl.image_recon_loss(jnp.asarray(x), jnp.asarray(y), "ngf"))
    grad_close(lambda p: tl.ngf_loss(p, nchw(y)), lambda p: jl.ngf_loss(p, jnp.asarray(y)), x)
    # the target takes no gradient
    assert not tl.ngf_loss(nchw(x), nchw(y).requires_grad_(True)).requires_grad


def test_ngf_loss_of_bf16_prediction_is_float32():
    x, y = image(5), image(6)
    got = tl.ngf_loss(nchw(x).bfloat16(), nchw(y))
    assert got.dtype == torch.float32
    close(got, jl.ngf_loss(jnp.asarray(x, jnp.bfloat16), jnp.asarray(y)), rtol=1e-4)


# ---------------------------------------------------------------------------
# cross entropy, Dice, focal, entropies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("is_gt", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_soft_target_cross_entropy(is_gt, weighted, masked):
    x, t = logits(7), logits(8)
    if is_gt:
        t = np.asarray(jax.nn.softmax(jnp.asarray(t), -1))
    w = (0.1, 0.2, 0.3, 0.4) if weighted else None
    m = (np.random.RandomState(9).rand(2, 16, 16, 1) > 0.3).astype(np.float32) if masked else None
    kw_t = dict(weight=w, is_gt=is_gt, mask=None if m is None else nchw(m))
    kw_j = dict(weight=w, is_gt=is_gt, mask=None if m is None else jnp.asarray(m))
    close(tl.cross_entropy_2d(nchw(x), nchw(t), **kw_t),
          jl.cross_entropy_2d(jnp.asarray(x), jnp.asarray(t), **kw_j))
    grad_close(lambda p: tl.cross_entropy_2d(p, nchw(t), **kw_t),
               lambda p: jl.cross_entropy_2d(p, jnp.asarray(t), **kw_j), x)


def test_hard_label_cross_entropy_with_mask_and_sum():
    x, y = logits(10), labels(11)
    m = (np.random.RandomState(12).rand(2, 16, 16, 1) > 0.5).astype(np.float32)
    close(tl.cross_entropy_2d(nchw(x), torch.from_numpy(y), mask=nchw(m), size_average=False),
          jl.cross_entropy_2d(jnp.asarray(x), jnp.asarray(y), mask=jnp.asarray(m),
                              size_average=False), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kw", [{}, {"squared_union": True}, {"class_ids": [1, 2, 3]},
                                {"class_ids": [2], "squared_union": True}])
def test_soft_dice_hard_labels(kw):
    x, y = logits(13), labels(14)
    close(tl.soft_dice_loss(nchw(x), torch.from_numpy(y), 4, **kw),
          jl.soft_dice_loss(jnp.asarray(x), jnp.asarray(y), 4, **kw))
    grad_close(lambda p: tl.soft_dice_loss(p, torch.from_numpy(y), 4, **kw),
               lambda p: jl.soft_dice_loss(p, jnp.asarray(y), 4, **kw), x)


@pytest.mark.parametrize("is_gt", [False, True])
def test_soft_dice_soft_targets_and_mask(is_gt):
    x, t = logits(15), logits(16)
    if is_gt:
        t = np.asarray(jax.nn.softmax(jnp.asarray(t), -1))
    m = (np.random.RandomState(17).rand(2, 16, 16, 1) > 0.4).astype(np.float32)
    close(tl.soft_dice_loss(nchw(x), nchw(t), 4, mask=nchw(m), is_gt=is_gt),
          jl.soft_dice_loss(jnp.asarray(x), jnp.asarray(t), 4, mask=jnp.asarray(m), is_gt=is_gt))


def test_soft_dice_3d_labels():
    x = logits(18, (2, 3, 8, 8, 4))  # [B,D,H,W,C]
    y = labels(19, (2, 3, 8, 8))
    close(tl.soft_dice_loss(nchw(x), torch.from_numpy(y), 4),
          jl.soft_dice_loss(jnp.asarray(x), jnp.asarray(y), 4))


@pytest.mark.parametrize("alpha", [None, 0.25, (0.1, 0.2, 0.3, 0.4)])
@pytest.mark.parametrize("size_average", [True, False])
def test_focal_loss(alpha, size_average):
    x, y = logits(20), labels(21, classes=2 if alpha == 0.25 else 4)
    if alpha == 0.25:
        x = x[..., :2]
    close(tl.focal_loss(nchw(x), torch.from_numpy(y), alpha=alpha, size_average=size_average),
          jl.focal_loss(jnp.asarray(x), jnp.asarray(y), alpha=alpha, size_average=size_average),
          atol=1e-5)
    grad_close(lambda p: tl.focal_loss(p, torch.from_numpy(y), alpha=alpha),
               lambda p: jl.focal_loss(p, jnp.asarray(y), alpha=alpha), x)


@pytest.mark.parametrize("base", [2, "e"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_entropy_of_probabilities(base, normalize, masked):
    p = np.asarray(jax.nn.softmax(jnp.asarray(logits(22)), -1))
    m = (np.random.RandomState(23).rand(2, 16, 16, 1) > 0.5).astype(np.float32) if masked else None
    close(tl.entropy_loss_probs(nchw(p), base=base, normalize=normalize,
                                mask=None if m is None else nchw(m)),
          jl.entropy_loss_probs(jnp.asarray(p), base=base, normalize=normalize,
                                mask=None if m is None else jnp.asarray(m)))


def test_entropy_of_logits_js_tv_and_cosine():
    x, y = logits(24), logits(25)
    close(tl.entropy_loss_logits(nchw(x)), jl.entropy_loss_logits(jnp.asarray(x)))
    grad_close(tl.entropy_loss_logits, jl.entropy_loss_logits, x)
    close(tl.js_divergence(nchw(x), nchw(y)), jl.js_divergence(jnp.asarray(x), jnp.asarray(y)))
    grad_close(lambda p: tl.js_divergence(p, nchw(y)),
               lambda p: jl.js_divergence(p, jnp.asarray(y)), x)
    for w in (1.0, 0.3):
        close(tl.tv_loss(nchw(x), w), jl.tv_loss(jnp.asarray(x), w))
    grad_close(tl.tv_loss, jl.tv_loss, x)
    close(tl.cosine_similarity_loss(nchw(x), nchw(y)),
          jl.cosine_similarity_loss(jnp.asarray(x), jnp.asarray(y)))
    grad_close(lambda p: tl.cosine_similarity_loss(p, nchw(y)),
               lambda p: jl.cosine_similarity_loss(p, jnp.asarray(y)), x)


# ---------------------------------------------------------------------------
# the basic_loss_fn menu and the consistency family
# ---------------------------------------------------------------------------

MENU = ("cross entropy", "weighted cross entropy", "dice", "weighted dice",
        "foreground dice", "focal", "contour_smooth")


@pytest.mark.parametrize("loss_type", MENU)
@pytest.mark.parametrize("class_weights", [None, (0.1, 0.2, 0.3, 0.4)])
def test_basic_loss_fn_menu(loss_type, class_weights):
    x, y = logits(26), labels(27)
    close(tl.basic_loss_fn(nchw(x), torch.from_numpy(y), loss_type, class_weights),
          jl.basic_loss_fn(jnp.asarray(x), jnp.asarray(y), loss_type, class_weights))
    grad_close(lambda p: tl.basic_loss_fn(p, torch.from_numpy(y), loss_type, class_weights),
               lambda p: jl.basic_loss_fn(p, jnp.asarray(y), loss_type, class_weights), x)


def test_basic_loss_fn_of_bf16_logits_is_float32():
    """bf16 logits give a float32 loss. Every type but "contour_smooth"
    casts them to float32 first, as JAX's does (rtol 1e-4). That one takes
    the softmax in bf16 on both sides, whose roundings differ: held at
    bf16's resolution, rtol 2^-8 (measured 4.5e-4)."""
    x, y = logits(28), labels(29)
    for loss_type in MENU:
        got = tl.basic_loss_fn(nchw(x).bfloat16(), torch.from_numpy(y), loss_type)
        assert got.dtype == torch.float32
        close(got, jl.basic_loss_fn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(y), loss_type),
              rtol=2.0 ** -8 if loss_type == "contour_smooth" else 1e-4, atol=1e-5)


def test_unknown_types_raise():
    x = nchw(logits(30))
    with pytest.raises(NotImplementedError):
        tl.basic_loss_fn(x, torch.zeros((2, 16, 16), dtype=torch.long), "hinge")
    with pytest.raises(NotImplementedError):
        tl.image_recon_loss(x, x, "ssim")
    with pytest.raises(NotImplementedError):
        tl.segmentation_consistency(x, x, divergence_types=("wasserstein",),
                                    divergence_weights=(1.0,))


DIVERGENCES = ("kl", "ce", "weighted ce", "Dice", "mse", "contour")


@pytest.mark.parametrize("div", DIVERGENCES)
@pytest.mark.parametrize("scales", [(0,), (0, 1, 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_segmentation_consistency(div, scales, masked):
    out, ref = logits(31), logits(32)
    m = (np.random.RandomState(33).rand(2, 16, 16, 4) > 0.3).astype(np.float32) if masked else None
    kw = dict(divergence_types=(div,), divergence_weights=(0.7,), scales=scales,
              class_weights=(0.1, 0.2, 0.3, 0.4))
    close(tl.segmentation_consistency(nchw(out), nchw(ref), mask=None if m is None else nchw(m),
                                      **kw),
          jl.segmentation_consistency(jnp.asarray(out), jnp.asarray(ref),
                                      mask=None if m is None else jnp.asarray(m), **kw))
    grad_close(lambda p: tl.segmentation_consistency(p, nchw(ref), **kw),
               lambda p: jl.segmentation_consistency(p, jnp.asarray(ref), **kw), out)


@pytest.mark.parametrize("div", ("kl", "ce", "Dice", "mse", "contour"))
def test_segmentation_consistency_against_ground_truth(div):
    out = logits(34)
    onehot = np.asarray(jax.nn.one_hot(labels(35), 4))
    kw = dict(divergence_types=(div, "kl"), divergence_weights=(1.0, 0.5), scales=(0, 1),
              is_gt=True)
    close(tl.segmentation_consistency(nchw(out), nchw(onehot), **kw),
          jl.segmentation_consistency(jnp.asarray(out), jnp.asarray(onehot), **kw))


def test_kl_divergence_against_one_hot():
    out = logits(36)
    onehot = np.asarray(jax.nn.one_hot(labels(37), 4))
    close(tl.kl_divergence(nchw(onehot), nchw(out), is_gt=True),
          jl.kl_divergence(jnp.asarray(onehot), jnp.asarray(out), is_gt=True))
