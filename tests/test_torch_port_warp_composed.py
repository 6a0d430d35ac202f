"""The bilinear warp with its coordinates composed in the kernel.

``warp_bilinear_nearest_affine`` takes the inverse affine matrix, the crop
offsets and the smoothed elastic field (with alpha and the gate) instead of
source coordinates; its plain version (what the wrapper runs on CPU
tensors) is ``compose_coords`` followed by ``warp_bilinear_nearest_plain``,
and the CUDA kernel repeats its float operations in the same order. Held
here, bit for bit (``torch.equal``):

* against ``aug_coords`` + ``warp_bilinear_nearest_plain`` on the same
  draws, and against the route it replaced (``bench_style.parent_route``:
  the field times alpha at full size, its window gathered, times the gate),
  for several seeds with the elastic gate on for some samples and off for
  others;
* for a policy with no elastic branch (no field);
* for a matrix that stretches the crop over [-2.5, H+1.5], so that pixels
  straddle both rims.

A crop window that leaves the source raises (the kernel clamps its field
window to the source instead of reading outside the field).

And the augmentation's kernel backend, which now takes this route for the
bilinear policies, against JAX's ``augment_batch_inner`` with the Pallas
warp in interpret mode, at the atol 1e-4 and the label rule of
``tests/test_torch_port_augment.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.data import augment as JA
from maxstyle_tpu_torch.bench_style import parent_route
from maxstyle_tpu_torch.data import augment as TA
from maxstyle_tpu_torch.ops import warp_kernels as wk
from tests.test_torch_port_augment import jax_draws

torch.set_num_threads(2)

PAD, CROP = (40, 40), (32, 32)
N = 5


def case(seed, policy_name, gate=(1.0, 0.0, 1.0, 0.0, 0.0)):
    """Images, labels, the policy and its draws, with the elastic gate
    uniform set so that the gate is ``gate`` per sample."""
    policy = TA.get_policy(policy_name, PAD, CROP)
    g = torch.Generator().manual_seed(seed)
    images = torch.rand((N,) + PAD, generator=g)
    labels = torch.randint(0, 4, (N,) + PAD, generator=g, dtype=torch.int32)
    d = TA.draw_aug(g, policy, N)
    d["elastic_u"] = torch.tensor([0.0 if on else 1.0 for on in gate])
    return images, labels, policy, d


def composed(images, labels, policy, d):
    return wk.warp_bilinear_nearest_affine(images, labels, TA.affine_matrix(d, policy),
                                           d["oy"], d["ox"], policy.crop_hw,
                                           *TA.elastic_field(d, policy))


def assert_equal(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_composed_matches_coordinates_and_the_parent_route(seed):
    images, labels, policy, d = case(seed, "ACDC_affine_elastic_intensity")
    sm, alpha, gate = TA.elastic_field(d, policy)
    assert gate.tolist() == [1.0, 0.0, 1.0, 0.0, 0.0]
    got = composed(images, labels, policy, d)
    assert got[0].shape == (N,) + CROP and got[1].dtype == torch.int32
    assert_equal(got, wk.warp_bilinear_nearest_plain(images, labels, *TA.aug_coords(d, policy)))
    assert_equal(got, parent_route(images, labels, TA.affine_matrix(d, policy), d["oy"],
                                   d["ox"], CROP, sm, alpha, gate))
    # the field moves the gated samples only
    flat = wk.warp_bilinear_nearest_affine(images, labels, TA.affine_matrix(d, policy),
                                           d["oy"], d["ox"], CROP)
    for i, on in enumerate(gate.tolist()):
        assert torch.equal(got[0][i], flat[0][i]) == (on == 0.0), i


def test_composed_without_an_elastic_branch():
    images, labels, policy, d = case(3, "ACDC_affine")
    assert TA.elastic_field(d, policy) == ()
    assert_equal(composed(images, labels, policy, d),
                 wk.warp_bilinear_nearest_plain(images, labels, *TA.aug_coords(d, policy)))


def test_composed_with_a_matrix_across_both_rims():
    images, labels, policy, d = case(4, "ACDC_affine_elastic_intensity")
    (H, W), (h, w) = PAD, CROP
    s = (H + 4) / (h - 1)
    c = (H - 1) / 2.0
    mat = torch.zeros((N, 2, 3))
    mat[:, 0, 0] = mat[:, 1, 1] = s
    mat[:, 0, 2] = -2.5 - c - s * (d["oy"].float() - c)
    mat[:, 1, 2] = -2.5 - c - s * (d["ox"].float() - c)
    sy, sx = wk.compose_coords(mat, d["oy"], d["ox"], PAD, CROP)
    assert float(sy.min()) < -2.0 and float(sy.max()) > H + 1.0
    assert float(sx.min()) < -2.0 and float(sx.max()) > W + 1.0
    field = TA.elastic_field(d, policy)
    for args in ((), field):
        got = wk.warp_bilinear_nearest_affine(images, labels, mat, d["oy"], d["ox"], CROP, *args)
        want = wk.warp_bilinear_nearest_plain(
            images, labels, *wk.compose_coords(mat, d["oy"], d["ox"], PAD, CROP, *args))
        assert_equal(got, want)
        assert bool((got[1] == 0).any()) and bool((got[0] == 0).any())


@pytest.mark.parametrize("axis,offset", [("oy", -1), ("oy", PAD[0] - CROP[0] + 1),
                                         ("ox", -1), ("ox", PAD[1] - CROP[1] + 1)])
def test_crop_window_outside_the_source_raises(axis, offset):
    images, labels, policy, d = case(5, "ACDC_affine_elastic_intensity")
    d[axis] = d[axis].clone()
    d[axis][2] = offset
    for field in ((), TA.elastic_field(d, policy)):
        with pytest.raises(ValueError, match="crop window"):
            wk.warp_bilinear_nearest_affine(images, labels, TA.affine_matrix(d, policy),
                                            d["oy"], d["ox"], CROP, *field)


@pytest.mark.parametrize("name,seed", [("ACDC_affine_elastic_intensity", 21),
                                       ("ACDC_affine", 22), ("affine_elastic", 23)])
def test_kernel_backend_matches_jax_pallas_path(name, seed):
    jp, tp = JA.get_policy(name, PAD, CROP), TA.get_policy(name, PAD, CROP)
    rng = np.random.RandomState(seed)
    imgs = rng.rand(4, *PAD).astype(np.float32)
    labs = rng.randint(0, 4, (4,) + PAD).astype(np.int32)
    key = jax.random.key(seed)
    img_j, lab_j = JA.augment_batch_inner(key, jnp.asarray(imgs), jnp.asarray(labs), jp,
                                          warp_backend="pallas")
    keys = jax.random.split(key, 4)
    img_t, lab_t = TA.augment_batch_inner(None, torch.from_numpy(imgs), torch.from_numpy(labs),
                                          tp, draws=jax_draws(keys, jp))
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
    # labels agree wherever no coordinate sits on a rounding boundary
    sy, sx = jax.vmap(lambda k: JA._aug_coords(k, jp))(keys)
    frac = np.concatenate([np.asarray(sy) % 1.0, np.asarray(sx) % 1.0])
    near = np.abs(frac - 0.5) < 1e-4
    safe = ~(near[:4] | near[4:])
    np.testing.assert_array_equal(lab_t.numpy()[safe], np.asarray(lab_j)[safe])


def test_wrapper_refuses_non_cpu_tensors_without_plain_fallback():
    """Only CPU tensors take the plain version; any other device goes to the
    kernel path, which checks its inputs and raises rather than falling
    back."""
    meta = dict(device="meta")
    args = (torch.empty((1, 4, 4), **meta), torch.empty((1, 4, 4), dtype=torch.int32, **meta),
            torch.empty((1, 2, 3), **meta), torch.zeros((1,), dtype=torch.int64, **meta),
            torch.zeros((1,), dtype=torch.int64, **meta), (2, 2))
    field = (torch.empty((1, 2, 4, 4), **meta), torch.empty((1,), **meta),
             torch.empty((1,), **meta))
    with pytest.raises(ValueError):
        wk.warp_bilinear_nearest_affine(*args)
    with pytest.raises(ValueError):
        wk.warp_bilinear_nearest_affine(*args, *field)
    cpu = [torch.zeros((1, 4, 4)), torch.zeros((1, 4, 4), dtype=torch.int32),
           torch.eye(2, 3)[None], torch.zeros((1,), dtype=torch.int64),
           torch.zeros((1,), dtype=torch.int64)]
    img, lab = wk.warp_bilinear_nearest_affine(*cpu, (2, 2))
    assert img.shape == (1, 2, 2) and lab.dtype == torch.int32
