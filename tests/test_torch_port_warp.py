"""The port's augmentation warp against the JAX package's.

The plain version of the warp kernel (ops/warp_kernels.py, which is what the
wrapper runs on CPU tensors) is held against the JAX
``warp_bilinear_nearest`` Pallas kernel in interpret mode: image atol 1e-5,
labels exactly equal (both round half up). The gather path of the port's
augment module is held against the JAX gather path (``_sample_bilinear`` /
``_sample_nearest``, labels rounding half to even) at the same tolerances.

The cubic warp's plain version (prefilter in matrix form, then the 16-tap
sampler in the CUDA kernel's order) is held against the JAX
``warp_cubic_nearest`` Pallas kernel in interpret mode and against JAX's
``map_coordinates_cubic``: image atol 2e-5 (tests/test_warp_pallas.py),
labels exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.data import augment as JA
from maxstyle_tpu.ops.spline import map_coordinates_cubic as jax_map_cubic
from maxstyle_tpu.ops.warp_pallas import warp_bilinear_nearest as jax_warp
from maxstyle_tpu.ops.warp_pallas import warp_cubic_nearest as jax_warp_cubic
from maxstyle_tpu_torch.data import augment as TA
from maxstyle_tpu_torch.ops import warp_kernels as wk

torch.set_num_threads(2)


def make_case(n, src, out_hw, seed, margin):
    """Random images, labels and source coordinates reaching ``margin``
    pixels outside the source on every side, plus exact half-pixel and
    boundary points."""
    rng = np.random.RandomState(seed)
    img = rng.rand(n, src, src).astype(np.float32)
    lab = rng.randint(0, 4, (n, src, src)).astype(np.int32)
    h, w = out_hw
    sy = (rng.rand(n, h, w) * (src - 1 + 2 * margin) - margin).astype(np.float32)
    sx = (rng.rand(n, h, w) * (src - 1 + 2 * margin) - margin).astype(np.float32)
    special = np.array([0.5, 1.5, -0.5, src - 0.5, src - 1.0, 0.0, -0.25, src - 0.75],
                       np.float32)
    sy[0, 0, :len(special)] = special
    sx[0, 0, :len(special)] = special[::-1]
    return img, lab, sy, sx


CASES = {
    # pixel counts 2304, 1089 (not a multiple of 1024) and the main path's N=10
    "48x48": (3, 40, (48, 48), 0, 3.0),
    "33x33": (2, 40, (33, 33), 1, 6.0),
    "inside": (2, 24, (20, 20), 2, 0.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_warp_matches_pallas_kernel(name):
    n, src, out_hw, seed, margin = CASES[name]
    img, lab, sy, sx = make_case(n, src, out_hw, seed, margin)
    ji, jl = jax_warp(jnp.asarray(img), jnp.asarray(lab), jnp.asarray(sy), jnp.asarray(sx),
                      out_hw, interpret=True)
    ti, tl = wk.warp_bilinear_nearest(*map(torch.from_numpy, (img, lab, sy, sx)))
    assert ti.shape == (n,) + out_hw and tl.dtype == torch.int32
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("name", sorted(CASES))
def test_gather_path_matches_jax_gather(name):
    n, src, out_hw, seed, margin = CASES[name]
    img, lab, sy, sx = make_case(n, src, out_hw, seed, margin)
    import jax
    ji = jax.vmap(JA._sample_bilinear)(jnp.asarray(img), jnp.asarray(sy), jnp.asarray(sx))
    jl = jax.vmap(lambda l, y, x: JA._sample_nearest(l.astype(jnp.float32), y, x))(
        jnp.asarray(lab), jnp.asarray(sy), jnp.asarray(sx))
    t = [torch.from_numpy(a) for a in (img, lab, sy, sx)]
    ti = TA.sample_bilinear(t[0], t[2], t[3])
    tl = TA.sample_nearest(t[1].float(), t[2], t[3])
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_half_pixel_rounding_differs_as_documented():
    """At an exact half-pixel coordinate the kernel path rounds up and the
    gather path rounds half to even."""
    lab = torch.arange(16, dtype=torch.int32).reshape(1, 4, 4)
    sy = torch.full((1, 1, 1), 0.5)
    sx = torch.full((1, 1, 1), 2.0)
    _, up = wk.warp_bilinear_nearest(torch.zeros(1, 4, 4), lab, sy, sx)
    even = TA.sample_nearest(lab.float(), sy, sx)
    assert int(up) == 1 * 4 + 2 and int(even) == 0 * 4 + 2


CUBIC_CASES = {
    # N=3, 40^2 -> 32^2 reaching 3 pixels outside, and the identity warp
    "outside": (3, 40, (32, 32), 5, 3.0),
    "inside": (2, 24, (20, 20), 6, 0.0),
}


@pytest.mark.parametrize("name", sorted(CUBIC_CASES))
def test_plain_cubic_warp_matches_pallas_kernel(name):
    n, src, out_hw, seed, margin = CUBIC_CASES[name]
    img, lab, sy, sx = make_case(n, src, out_hw, seed, margin)
    ji, jl = jax_warp_cubic(jnp.asarray(img), jnp.asarray(lab), jnp.asarray(sy),
                            jnp.asarray(sx), out_hw, interpret=True)
    ti, tl = wk.warp_cubic_nearest(*map(torch.from_numpy, (img, lab, sy, sx)))
    assert ti.shape == (n,) + out_hw and tl.dtype == torch.int32
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=2e-5)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_plain_cubic_warp_identity_and_jax_spline():
    n, src = 3, 40
    img, lab, _, _ = make_case(n, src, (src, src), 7, 0.0)
    yy, xx = np.mgrid[0:src, 0:src].astype(np.float32)
    sy, sx = np.broadcast_to(yy, (n, src, src)).copy(), np.broadcast_to(xx, (n, src, src)).copy()
    ti, tl = wk.warp_cubic_nearest_plain(*map(torch.from_numpy, (img, lab, sy, sx)))
    np.testing.assert_allclose(ti.numpy(), img, atol=2e-5)
    np.testing.assert_array_equal(tl.numpy(), lab)
    img, lab, sy, sx = make_case(n, src, (32, 32), 8, 3.0)
    import jax
    want = jax.vmap(jax_map_cubic)(jnp.asarray(img), jnp.asarray(sy), jnp.asarray(sx))
    ti, _ = wk.warp_cubic_nearest_plain(*map(torch.from_numpy, (img, lab, sy, sx)))
    np.testing.assert_allclose(ti.numpy(), np.asarray(want), atol=2e-5)


def test_wrapper_refuses_non_cpu_tensors_without_plain_fallback():
    """Only CPU tensors take the plain version; any other device goes to the
    kernel path, which checks its inputs and raises rather than falling back."""
    meta = [torch.empty((1, 4, 4), device="meta"), torch.empty((1, 4, 4), device="meta",
                                                                dtype=torch.int32),
            torch.empty((1, 2, 2), device="meta"), torch.empty((1, 2, 2), device="meta")]
    with pytest.raises(ValueError):
        wk.warp_bilinear_nearest(*meta)
    with pytest.raises(ValueError):
        wk.warp_cubic_nearest(*meta)
