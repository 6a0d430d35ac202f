"""The port's augmentation against the JAX package's, given JAX's draws.

The test replays the JAX key layout of ``_aug_coords``/``_affine_matrix``
(augment.py:171-192, 334-356) and ``_post_warp_intensity`` (:375-386, and the
gamma branch's fold_in(key, 99)) to obtain the numbers JAX drew, feeds them
to the port's deterministic functions, and compares:

* coordinates: atol 1e-4 pixels. The elastic field is smoothed noise times
  alpha ~ 1.5-2 H (60-80 pixels at H=40) from two different float32 FFTs,
  and the affine part multiplies coordinates of up to ~40 pixels; the two
  agree to 8e-6 pixels here, and 1e-4 leaves a margin of ten.
* intensity output: atol 1e-5 (min-max normalized to [0, 1]).
* the whole batch augmentation against JAX's ``augment_batch_inner`` with
  the Pallas warp: image atol 1e-4; labels equal except where a coordinate
  lies within 1e-4 pixels of a rounding boundary. With the cubic policy, the
  port's two backends against JAX's two backends, at the same tolerances.
* the bicubic resize against ``jax.image.resize``: atol 1e-6; the V2 and V1
  bias fields, fed the control grids JAX drew from the same keys: atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.data import augment as JA
from maxstyle_tpu_torch.data import augment as TA

torch.set_num_threads(2)

PAD, CROP = (40, 40), (32, 32)
POLICIES = ["ACDC_affine_elastic_intensity", "Prostate_affine_elastic_intensity",
            "affine_gamma_elastic", "no_aug", "ACDC_affine_elastic_bias", "ACDC_affine_all",
            "ACDC_affine_perturb", "Atrial_perturb"]


def jax_draws(keys, p: JA.AugPolicy):
    """The numbers JAX's augmentation draws from each per-sample key."""
    H, W = p.pad_hw
    h, w = p.crop_hw
    rows = []
    for key in keys:
        k = jax.random.split(key, 9)
        ks = jax.random.split(k[0], 8)
        kf1, kf2 = jax.random.split(ks[7])
        k_gate, k_c, k_b = jax.random.split(k[7], 3)
        k_g1, k_g2 = jax.random.split(jax.random.fold_in(key, 99))
        k_bg, k_bf = jax.random.split(k[8])
        k_vg, k_vf, k_vn = jax.random.split(jax.random.fold_in(key, 101), 3)
        cps = p.perturb_v1_control_points
        k_grids = jax.random.split(k_vf, len(cps))
        u = jax.random.uniform
        rows.append({
            "theta_deg": u(ks[0], minval=-p.rotate_deg, maxval=p.rotate_deg),
            "shear_deg": u(ks[1], minval=-p.shear_deg, maxval=p.shear_deg),
            "zy": u(ks[2], minval=p.zoom_range[0], maxval=p.zoom_range[1]),
            "zx": u(ks[3], minval=p.zoom_range[0], maxval=p.zoom_range[1]),
            "ty": u(ks[4], minval=-p.shift_frac[0], maxval=p.shift_frac[0]),
            "tx": u(ks[5], minval=-p.shift_frac[1], maxval=p.shift_frac[1]),
            "group": jax.random.randint(ks[6], (), 0, max(len(p.rotate_groups), 1)),
            "flip_h_u": u(kf1), "flip_v_u": u(kf2),
            "oy": jax.random.randint(k[1], (), 0, H - h + 1),
            "ox": jax.random.randint(k[2], (), 0, W - w + 1),
            "elastic_u": u(k[3]),
            "alpha": H * u(k[4], minval=p.elastic_alpha_range[0],
                           maxval=p.elastic_alpha_range[1]),
            "sigma": H * u(k[5], minval=p.elastic_sigma_range[0],
                           maxval=p.elastic_sigma_range[1]),
            "elastic_noise": u(jax.random.split(k[6])[0], (2, H, W), minval=-1.0, maxval=1.0),
            "intensity_u": u(k_gate),
            "contrast": u(k_c, minval=p.contrast_range[0], maxval=p.contrast_range[1]),
            "brightness": u(k_b, minval=p.brightness_range[0], maxval=p.brightness_range[1]),
            "gamma_u": u(k_g1),
            "gamma": u(k_g2, minval=p.gamma_range[0], maxval=p.gamma_range[1]),
            "bias_u": u(k_bg),
            "bias_grid": u(k_bf, TA.bias_grid_hw((h, w)), minval=-1.0, maxval=1.0),
            "v1_u": u(k_vg),
            **{f"v1_grid{cp}": u(kg, (cp, cp)) for kg, cp in zip(k_grids, cps)},
            "v1_noise": jax.random.normal(k_vn, (h, w)),
        })
    return {name: torch.from_numpy(np.stack([np.asarray(r[name]) for r in rows]))
            for name in rows[0]}


def keys_for(seed, n):
    return jax.random.split(jax.random.key(seed), n)


@pytest.mark.parametrize("name", POLICIES)
def test_coords_match_jax(name):
    jp, tp = JA.get_policy(name, PAD, CROP), TA.get_policy(name, PAD, CROP)
    keys = keys_for(3, 6)
    sy_j, sx_j = jax.vmap(lambda k: JA._aug_coords(k, jp))(keys)
    sy, sx = TA.aug_coords(jax_draws(keys, jp), tp)
    np.testing.assert_allclose(sy.numpy(), np.asarray(sy_j), atol=1e-4)
    np.testing.assert_allclose(sx.numpy(), np.asarray(sx_j), atol=1e-4)


@pytest.mark.parametrize("name", POLICIES)
def test_post_warp_intensity_matches_jax(name):
    jp, tp = JA.get_policy(name, PAD, CROP), TA.get_policy(name, PAD, CROP)
    keys = keys_for(4, 6)
    img = np.random.RandomState(0).rand(6, *CROP).astype(np.float32) * 3 - 1
    out_j = jax.vmap(lambda k, i: JA._post_warp_intensity(k, i, jp))(keys, jnp.asarray(img))
    out = TA.post_warp_intensity(jax_draws(keys, jp), torch.from_numpy(img), tp)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-5)


def test_batch_augmentation_matches_jax_pallas_path():
    name = "ACDC_affine_elastic_intensity"
    jp, tp = JA.get_policy(name, PAD, CROP), TA.get_policy(name, PAD, CROP)
    rng = np.random.RandomState(1)
    imgs = rng.rand(4, *PAD).astype(np.float32)
    labs = rng.randint(0, 4, (4,) + PAD).astype(np.int32)
    key = jax.random.key(9)
    img_j, lab_j = JA.augment_batch_inner(key, jnp.asarray(imgs), jnp.asarray(labs), jp,
                                          warp_backend="pallas")
    keys = jax.random.split(key, 4)
    img_t, lab_t = TA.augment_batch_inner(None, torch.from_numpy(imgs), torch.from_numpy(labs),
                                          tp, draws=jax_draws(keys, jp))
    assert img_t.shape == (4,) + CROP + (1,) and lab_t.shape == (4,) + CROP
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
    # labels agree wherever no coordinate sits on a rounding boundary
    sy, sx = jax.vmap(lambda k: JA._aug_coords(k, jp))(keys)
    frac = np.concatenate([np.asarray(sy) % 1.0, np.asarray(sx) % 1.0])
    near = np.abs(frac - 0.5) < 1e-4
    safe = ~(near[:4] | near[4:])
    np.testing.assert_array_equal(lab_t.numpy()[safe], np.asarray(lab_j)[safe])


def test_center_crop_norm_matches_jax():
    rng = np.random.RandomState(2)
    imgs = (rng.rand(3, *PAD) * 5 - 2).astype(np.float32)
    labs = rng.randint(0, 4, (3,) + PAD).astype(np.int32)
    img_j, lab_j = JA.norm_batch(jnp.asarray(imgs), jnp.asarray(labs), CROP)
    img_t, lab_t = TA.norm_batch(torch.from_numpy(imgs), torch.from_numpy(labs), CROP)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-6)
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))


def test_policy_registry_matches_jax():
    import dataclasses
    names = ["no_aug", "affine", "scale", "elastic", "gamma", "gamma_elastic", "ACDC_affine",
             "ACDC_affine_intensity", "ACDC_affine_elastic", "ACDC_affine_elastic_intensity",
             "ACDC_affine_elastic_bias", "ACDC_affine_all",
             "Prostate_affine_elastic_intensity", "UKBB_affine_elastic_intensity_aug",
             "gamma_scale", "affine_elastic", "affine_gamma", "affine_gamma_elastic",
             "elastic_scale", "elastic_v2", "ACDC_affine_perturb", "ACDC_affine_perturb_v2",
             "Atrial_basic", "Atrial_perturb"]
    for n in names:
        assert dataclasses.asdict(TA.get_policy(n, PAD, CROP)) == \
            dataclasses.asdict(JA.get_policy(n, PAD, CROP)), n
    with pytest.raises(KeyError):
        TA.get_policy("nope")


def test_unported_branches_raise():
    """Every branch of the JAX module is ported; what has no counterpart is
    refused: the JAX backend name "pallas" (the port's is "kernel") and an
    unknown interpolation."""
    p = TA.get_policy("ACDC_affine_elastic_bias", PAD, CROP)
    with pytest.raises(ValueError):
        TA.augment_batch_inner(torch.Generator(), torch.zeros(1, *PAD),
                               torch.zeros(1, *PAD, dtype=torch.int32), p,
                               warp_backend="pallas")
    with pytest.raises(ValueError, match="image_interp"):
        TA.get_policy("no_aug", PAD, CROP, image_interp="bicubic")


@pytest.mark.parametrize("backend", ["kernel", "gather"])
def test_cubic_batch_augmentation_matches_jax(backend):
    name = "Prostate_affine_elastic_intensity"
    jp = JA.get_policy(name, PAD, CROP, image_interp="cubic")
    tp = TA.get_policy(name, PAD, CROP, image_interp="cubic")
    rng = np.random.RandomState(3)
    imgs = rng.rand(3, *PAD).astype(np.float32)
    labs = rng.randint(0, 2, (3,) + PAD).astype(np.int32)
    key = jax.random.key(12)
    img_j, lab_j = JA.augment_batch_inner(key, jnp.asarray(imgs), jnp.asarray(labs), jp,
                                          warp_backend="pallas" if backend == "kernel"
                                          else "gather")
    keys = jax.random.split(key, 3)
    img_t, lab_t = TA.augment_batch_inner(None, torch.from_numpy(imgs), torch.from_numpy(labs),
                                          tp, warp_backend=backend, draws=jax_draws(keys, jp))
    assert img_t.shape == (3,) + CROP + (1,) and lab_t.dtype == torch.int32
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
    sy, sx = jax.vmap(lambda k: JA._aug_coords(k, jp))(keys)
    frac = np.concatenate([np.asarray(sy) % 1.0, np.asarray(sx) % 1.0])
    near = np.abs(frac - 0.5) < 1e-4
    safe = ~(near[:3] | near[3:])
    np.testing.assert_array_equal(lab_t.numpy()[safe], np.asarray(lab_j)[safe])


@pytest.mark.parametrize("src,dst", [((2, 2), (32, 32)), ((4, 4), (32, 32)),
                                     ((8, 8), (192, 192)), ((6, 6), (192, 192)),
                                     ((7, 7), (224, 224))])
def test_resize_bicubic_matches_jax(src, dst):
    grid = np.random.RandomState(src[0]).rand(2, *src).astype(np.float32) * 2 - 1
    want = np.stack([np.asarray(jax.image.resize(jnp.asarray(g), dst, method="bicubic"))
                     for g in grid])
    got = TA.resize_bicubic(torch.from_numpy(grid), dst)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_bias_fields_match_jax():
    hw, cps = (32, 32), (2, 4, 8)
    keys = keys_for(5, 3)
    want_v2 = np.stack([np.asarray(JA._bias_field(k, hw, 0.2)) for k in keys])
    grids = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
        k, TA.bias_grid_hw(hw), minval=-1.0, maxval=1.0)) for k in keys]))
    np.testing.assert_allclose(TA.bias_field(grids, hw, 0.2).numpy(), want_v2, atol=1e-5)

    want_v1 = np.stack([np.asarray(JA._multiscale_bias_field(k, hw, cps, 16.0, 0.3))
                        for k in keys])
    per_scale = [[np.asarray(jax.random.uniform(kg, (cp, cp)))
                  for kg, cp in zip(jax.random.split(k, len(cps)), cps)] for k in keys]
    v1_grids = [torch.from_numpy(np.stack([s[i] for s in per_scale])) for i in range(len(cps))]
    got = TA.multiscale_bias_field(v1_grids, hw, cps, 16.0, 0.3)
    np.testing.assert_allclose(got.numpy(), want_v1, atol=1e-5)


def test_generator_draws_are_distributed_like_the_policy():
    p = TA.get_policy("ACDC_affine_elastic_intensity", PAD, CROP)
    d = TA.draw_aug(torch.Generator().manual_seed(0), p, 4000)
    assert float(d["theta_deg"].abs().max()) <= 15.0
    assert 0.8 <= float(d["zy"].min()) and float(d["zy"].max()) <= 1.1
    assert set(d["group"].unique().tolist()) == set(range(8))
    assert int(d["oy"].max()) == PAD[0] - CROP[0] and int(d["oy"].min()) == 0
    assert abs(float((d["elastic_u"] < 0.5).float().mean()) - 0.5) < 0.05
    assert 1.5 * PAD[0] <= float(d["alpha"].min()) and float(d["alpha"].max()) <= 2.0 * PAD[0]
    assert tuple(d["elastic_noise"].shape) == (4000, 2) + PAD
    assert "bias_u" not in d and "v1_u" not in d


def test_optional_branches_draw_after_the_common_stream():
    """The bias-field and V1 draws come after every other draw, so a policy
    without them draws the same numbers as before, and one with them draws
    the same common numbers."""
    base = TA.get_policy("ACDC_affine_elastic_intensity", PAD, CROP)
    both = TA.get_policy("ACDC_affine_all", PAD, CROP)
    both = __import__("dataclasses").replace(both, perturb_v1_prob=0.5)
    d0 = TA.draw_aug(torch.Generator().manual_seed(1), base, 5)
    d1 = TA.draw_aug(torch.Generator().manual_seed(1), both, 5)
    for key, val in d0.items():
        torch.testing.assert_close(d1[key], val, rtol=0, atol=0)
    assert tuple(d1["bias_grid"].shape) == (5, 2, 2)
    assert tuple(d1["v1_grid8"].shape) == (5, 8, 8) and tuple(d1["v1_noise"].shape) == (5,) + CROP
    assert float(d1["bias_grid"].min()) >= -1.0 and float(d1["v1_grid4"].max()) < 1.0
