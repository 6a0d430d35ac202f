"""The port's per-plane moments and the tiling of its cluster kernels.

``channel_moments_plain`` (what ``channel_moments`` runs on CPU tensors, and
what the CUDA kernel is held to on the card) against the JAX stats path:
``maxstyle_pallas._batched_stats`` (Pallas in interpret mode on the CPU)
finished as ``apply_maxstyle_pallas`` finishes it (maxstyle_pallas.py:266-270).
Inputs come from a numpy seed; tolerance rtol 1e-5 / atol 1e-6 (two float32
reductions in different orders).

``_plane_tiling`` decides how the moments and bwd kernels cut each plane
into the ranks of a thread-block cluster; it is checked at both training
cells' hook shapes and at ragged ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.ops.maxstyle_pallas import _batched_stats
from maxstyle_tpu_torch.ops import maxstyle_kernels as mk

torch.set_num_threads(2)

EPS = 1e-6
H100_SMS = 132


def jax_moments(x_nchw: np.ndarray, eps: float):
    """mu, sig [B, C] from the Pallas stats kernel, finished as at
    maxstyle_pallas.py:266-270."""
    b, c, h, w = x_nchw.shape
    hw = h * w
    x2d = jnp.asarray(x_nchw.transpose(0, 2, 3, 1).reshape(b, hw, c))
    stats = _batched_stats(x2d)
    s, sq = stats[:, 0, :], stats[:, 1, :]
    mu = s / hw
    var = jnp.maximum(sq / hw - mu * mu, 0.0) * (hw / max(hw - 1, 1))
    return np.asarray(mu), np.asarray(jnp.sqrt(var + eps))


def make_input(name: str) -> np.ndarray:
    rng = np.random.RandomState(sum(map(ord, name)))
    shape = MOMENT_CASES[name]
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    if name == "constant_planes":
        # exactly representable values and squares: var is 0, sig sqrt(eps)
        x[0, 1] = 1.5
        x[1, 0] = -3.0
    return x


MOMENT_CASES = {
    "hook5_like_c1": (4, 1, 32, 32),
    "hook3_like": (4, 16, 12, 12),
    "hw_1": (3, 5, 1, 1),
    "constant_planes": (2, 3, 8, 8),
    "hw_not_multiple_of_4": (3, 5, 7, 9),
}


@pytest.mark.parametrize("name", sorted(MOMENT_CASES))
def test_moments_match_the_jax_stats_path(name):
    x = make_input(name)
    mu_j, sig_j = jax_moments(x, EPS)
    mu, sig = mk.channel_moments(torch.from_numpy(x), EPS)
    assert mu.shape == sig.shape == x.shape[:2]
    assert mu.dtype == sig.dtype == torch.float32
    np.testing.assert_allclose(mu.numpy(), mu_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sig.numpy(), sig_j, rtol=1e-5, atol=1e-6)
    if name in ("hw_1", "constant_planes"):
        const = np.ptp(x.reshape(*x.shape[:2], -1), axis=2) == 0
        assert const.any()
        np.testing.assert_array_equal(sig.numpy()[const], np.float32(np.sqrt(np.float32(EPS))))


# (B, C, HW): the style hooks of both training cells (effective batch 20;
# hooks 3, 4, 5) and ragged shapes
HOOKS = {"headline_h3": (20, 16, 96 * 96), "headline_h4": (20, 16, 192 * 192),
         "headline_h5": (20, 1, 192 * 192), "prostate_h3": (20, 16, 112 * 112),
         "prostate_h4": (20, 16, 224 * 224), "prostate_h5": (20, 1, 224 * 224)}
RAGGED = {"3x5x7x9": (3, 5, 7 * 9), "2x1x1x1": (2, 1, 1), "4x3x33x31": (4, 3, 33 * 31),
          "2x1x130x130": (2, 1, 130 * 130), "1x1x101x101": (1, 1, 101 * 101)}


@pytest.mark.parametrize("sm_count", [H100_SMS, 1, 1000])
@pytest.mark.parametrize("name", sorted({**HOOKS, **RAGGED}))
def test_plane_tiling_covers_every_value_once(name, sm_count):
    b, c, hw = {**HOOKS, **RAGGED}[name]
    k, per_rank = mk._plane_tiling(b, c, hw, sm_count)
    assert k in (1, 2, 4, 8)
    assert per_rank > 0 and per_rank % 4 == 0
    # rank r of every plane's cluster covers [r * per_rank, min(hw, (r+1) * per_rank))
    spans = [(min(hw, r * per_rank), min(hw, (r + 1) * per_rank)) for r in range(k)]
    count = np.zeros(hw, np.int64)
    for begin, end in spans:
        count[begin:end] += 1
    assert (count == 1).all()
    if hw >= k:
        assert all(end > begin for begin, end in spans)
    grid = b * c * k
    assert grid % k == 0 and grid <= 2 ** 31 - 1   # the grid's x dimension


@pytest.mark.parametrize("name,k,per_rank,last", [("2x1x130x130", 8, 2116, 2088),
                                                   ("1x1x101x101", 4, 2552, 2545)])
def test_ragged_planes_split_over_a_cluster_with_a_short_last_rank(name, k, per_rank, last):
    """The two ragged shapes that chip_smoke.py uses to reach the cross-rank
    reduction with a short last rank: on 132 SMs 130^2 (float4 path) splits
    over 8 ranks and 101^2 (hw % 4 != 0, scalar path) over 4."""
    b, c, hw = RAGGED[name]
    assert mk._plane_tiling(b, c, hw, H100_SMS) == (k, per_rank)
    assert hw - (k - 1) * per_rank == last
    assert 0 < last < per_rank


@pytest.mark.parametrize("name", sorted(HOOKS))
def test_plane_tiling_fills_the_card_in_one_wave(name):
    """On 132 SMs the 20-plane hooks split each plane over a cluster of 8
    (160 blocks); the 320-plane hooks keep one block a plane (320 blocks; an
    SM holds 4 blocks of 512 threads, so all run in one wave)."""
    b, c, hw = HOOKS[name]
    k, per_rank = mk._plane_tiling(b, c, hw, H100_SMS)
    blocks = b * c * k
    assert H100_SMS <= blocks <= 4 * H100_SMS
    assert k == (8 if c == 1 else 1)
    assert per_rank >= mk.MIN_RANK_VALUES
