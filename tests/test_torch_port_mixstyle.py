"""MixStyle and DSU of the port against the JAX package's.

``apply_mixstyle`` takes its draws from JAX's own key splits (gate, lmda,
perm and the DSU normals, laid out NCHW) and is held against JAX's
``apply_mixstyle`` on the same input: forward rtol 1e-5, gradients rtol
1e-4. The encoder replay (``generate_style_augmented_latent_code``) is held
the same way from converted weights at 64^2, at the model forward's bar
of tests/test_torch_port_model.py (rtol 1e-4 / atol 5e-5, on values up to
3.8). At 32^2 the deepest hooks normalize 4 values a plane and the two
float32 replays differ by up to 5.8e-5; there a float64 replay of the
port is the witness: the port's float32 lies within 1e-5 of it (5.4e-6
measured), JAX's float32 up to 5.5e-5 away, so the gap is JAX's rounding
(single-pass variance), not a difference in what is computed. The port's own
draws are checked by distribution: lmda ~ Beta(0.1, 0.1) by a KS test
against scipy.
"""

import dataclasses


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from maxstyle_tpu.config import (DataConfig, ExperimentConfig, LearningConfig,
                                 SegmentationModelConfig)
from maxstyle_tpu.ops import maxstyle as jms
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.ops import maxstyle as tms
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver

torch.set_num_threads(2)


def nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def jax_mixstyle_draws(key, b, c, mix):
    """The numbers JAX's apply_mixstyle draws from ``key``, in the port's
    layout (ops/maxstyle.py apply_mixstyle's splits)."""
    k_gate, k_lmda, k_perm, k_g1, k_g2 = jax.random.split(key, 5)
    d = {"gate_u": torch.tensor(float(jax.random.uniform(k_gate)))}
    if mix == "gaussian":
        d["g_mu"] = nchw(jax.random.normal(k_g1, (b, 1, 1, c)))
        d["g_sig"] = nchw(jax.random.normal(k_g2, (b, 1, 1, c)))
        return d
    d["lmda"] = torch.from_numpy(np.array(jax.random.beta(k_lmda, 0.1, 0.1, (b, 1, 1, 1))))
    if mix == "random":
        perm = np.asarray(jax.random.permutation(k_perm, b))
    else:
        rev = np.arange(b - 1, -1, -1)
        half = b // 2
        perm = np.concatenate([np.asarray(jax.random.permutation(k_perm, jnp.asarray(rev[:half]))),
                               np.asarray(jax.random.permutation(k_g1, jnp.asarray(rev[half:])))])
    d["perm"] = torch.from_numpy(perm.astype(np.int64))
    return d


@pytest.mark.parametrize("mix", ["random", "crossdomain", "gaussian"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_mixstyle_matches_jax(mix, seed):
    b, h, w, c = 6, 7, 9, 5
    x = (np.random.RandomState(seed).randn(b, h, w, c) * 1.5 + 0.5).astype(np.float32)
    key = jax.random.key(seed)
    jcfg = jms.MixStyleConfig(p=0.5, mix=mix)
    tcfg = tms.MixStyleConfig(p=0.5, mix=mix)
    g = np.random.RandomState(10 + seed).randn(b, h, w, c).astype(np.float32)

    def j(v):
        return jnp.sum(jms.apply_mixstyle(key, v, jcfg) * g)

    want = jms.apply_mixstyle(key, jnp.asarray(x), jcfg)
    jg = jax.grad(j)(jnp.asarray(x))
    draws = jax_mixstyle_draws(key, b, c, mix)
    tx = nchw(x).requires_grad_(True)
    got = tms.apply_mixstyle(tx, tcfg, draws)
    (got * nchw(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-4 * float(np.abs(jg).max()))


@pytest.mark.parametrize("gate_u", [0.3, 0.7])
def test_gate_is_arithmetic_and_fixed_lmda_and_perm_are_used(gate_u):
    b, c = 4, 3
    x = torch.randn(b, c, 5, 5, generator=torch.Generator().manual_seed(0))
    cfg = tms.MixStyleConfig(p=0.5)
    draws = {"gate_u": torch.tensor(gate_u), "lmda": torch.full((b, 1, 1, 1), 0.25),
             "perm": torch.tensor([1, 0, 3, 2])}
    out = tms.apply_mixstyle(x, cfg, draws)
    jcfg = jms.MixStyleConfig(p=0.5, lmda=0.25, perm=(1, 0, 3, 2))
    # JAX draws its own gate: pick the key whose gate matches
    key = next(k for k in (jax.random.key(i) for i in range(50))
               if (float(jax.random.uniform(jax.random.split(k, 5)[0])) <= 0.5)
               == (gate_u <= 0.5))
    want = jms.apply_mixstyle(key, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    if gate_u > 0.5:
        assert torch.equal(out, x)


def test_port_draws_lmda_from_beta_and_valid_permutations():
    g = torch.Generator().manual_seed(3)
    cfg = tms.MixStyleConfig(mix="random")
    lmdas = torch.cat([tms.draw_mixstyle(g, 50, 2, cfg)["lmda"].flatten() for _ in range(40)])
    assert float(lmdas.min()) >= 0.0 and float(lmdas.max()) <= 1.0
    # float32 rounds the ~10% of Beta(0.1, 0.1)'s mass within 6e-8 of 1 to
    # 1.0 exactly, an atom that a KS test cannot take: hold the share above
    # 0.99 with a binomial test, and the draws below it with a KS test
    # against the distribution conditioned on x < 0.99
    beta = stats.beta(0.1, 0.1)
    x = lmdas.double().numpy()
    low = x[x < 0.99]
    assert stats.binomtest(len(x) - len(low), len(x), 1.0 - beta.cdf(0.99)).pvalue > 1e-3
    assert stats.kstest(low, lambda v: beta.cdf(v) / beta.cdf(0.99)).pvalue > 1e-3
    d = tms.draw_mixstyle(g, 8, 2, tms.MixStyleConfig(mix="crossdomain"))
    perm = d["perm"].tolist()
    assert sorted(perm[:4]) == [4, 5, 6, 7] and sorted(perm[4:]) == [0, 1, 2, 3]
    d = tms.draw_mixstyle(g, 8, 3, tms.MixStyleConfig(mix="gaussian"))
    assert set(d) == {"gate_u", "g_mu", "g_sig"} and d["g_mu"].shape == (8, 3, 1, 1)


@pytest.mark.parametrize("mix,layers", [("random", (1, 2, 3)), ("gaussian", (1, 2, 3, 4, 5, 6))])
def test_encoder_replay_matches_jax(mix, layers):
    HW = 64  # noqa: N806
    cfg = ExperimentConfig(
        data=DataConfig(crop_size=(HW, HW, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(network_type="FCN_16_standard_no_STN",
                                                   num_classes=4),
        learning=LearningConfig(batch_size=4, optimizer_type="AdamW"))
    js = JSolver(cfg)
    state = js.init_state(jax.random.key(0), (HW, HW), batch_size=4)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    bstats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    image = np.random.RandomState(1).rand(4, HW, HW, 1).astype(np.float32)
    rng = jax.random.key(5)
    z_i, z_s = js.generate_style_augmented_latent_code(
        state.params, state.batch_stats, jnp.asarray(image), layers_indexes=layers, mix=mix,
        rng=rng)

    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    nets = ts.init_state(state_dicts=convert.convert_train_state(params, bstats)).modules
    shapes = {}
    nets["image_encoder"].encode(nchw(image), "frozen",
                                 {i: (lambda v, i=i: shapes.setdefault(i, v.shape) and v)
                                  for i in layers})
    draws = {i: jax_mixstyle_draws(jax.random.fold_in(rng, i), 4, shapes[i][1], mix)
             for i in layers}
    with torch.no_grad():
        t_i, t_s = ts.generate_style_augmented_latent_code(
            nets, nchw(image), layers_indexes=layers, mix=mix, generator=None, draws=draws)
    assert any(float(d["gate_u"]) <= 0.5 for d in draws.values())
    for got, want in ((t_i, z_i), (t_s, z_s)):
        w = np.asarray(want).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("mix,layers", [("random", (1, 2, 3)), ("gaussian", (1, 2, 3, 4, 5, 6))])
def test_encoder_replay_at_32_differs_from_jax_by_jax_rounding_alone(mix, layers):
    """At 32^2 the port's float32 replay lies within 1e-5 of its float64
    replay on the same weights and draws, and its distance to JAX's replay
    is no more than JAX's own distance from float64 plus that 1e-5."""
    HW = 32  # noqa: N806
    cfg = ExperimentConfig(
        data=DataConfig(crop_size=(HW, HW, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(network_type="FCN_16_standard_no_STN",
                                                   num_classes=4),
        learning=LearningConfig(batch_size=4, optimizer_type="AdamW"))
    js = JSolver(cfg)
    state = js.init_state(jax.random.key(0), (HW, HW), batch_size=4)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    bstats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    image = np.random.RandomState(1).rand(4, HW, HW, 1).astype(np.float32)
    rng = jax.random.key(5)
    want = js.generate_style_augmented_latent_code(
        state.params, state.batch_stats, jnp.asarray(image), layers_indexes=layers, mix=mix,
        rng=rng)

    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    nets = ts.init_state(state_dicts=convert.convert_train_state(params, bstats)).modules
    shapes = {}
    nets["image_encoder"].encode(nchw(image), "frozen",
                                 {i: (lambda v, i=i: shapes.setdefault(i, v.shape) and v)
                                  for i in layers})
    draws = {i: jax_mixstyle_draws(jax.random.fold_in(rng, i), 4, shapes[i][1], mix)
             for i in layers}
    with torch.no_grad():
        got = ts.generate_style_augmented_latent_code(
            nets, nchw(image), layers_indexes=layers, mix=mix, generator=None, draws=draws)
        nets64 = {k: v.double() for k, v in nets.items()}
        draws64 = {i: {k: v.double() if v.is_floating_point() else v for k, v in d.items()}
                   for i, d in draws.items()}
        exact = ts.generate_style_augmented_latent_code(
            nets64, nchw(image).double(), layers_indexes=layers, mix=mix, generator=None,
            draws=draws64)
    for t, j, e in zip(got, want, exact):
        t, j, e = t.numpy(), np.asarray(j).transpose(0, 3, 1, 2), e.numpy()
        np.testing.assert_allclose(t, e, rtol=1e-5, atol=1e-5)
        assert np.abs(t - j).max() <= np.abs(j - e).max() + 1e-5
