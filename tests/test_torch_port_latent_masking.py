"""Latent-code masking (LSM / RSC) of the port against the JAX package's.

Both sides probe the same decoder (tanh, then a 1x1 linear map, from numpy
weights) and take their draws from JAX's own key splits (the method index,
the percentile's uniform, the soft masks' uniforms and dropout's keep-mask,
laid out NCHW). Every ``perturb_type`` and loss is covered, hard and soft,
with a fixed and a random threshold.

Masks must be equal. An entry may differ only where its score (the mean
gradient of its channel or position, as JAX computes it) lies within
float32 rounding of the threshold, and the test checks that for every
differing entry. Where the masks agree, the masked codes agree at rtol
1e-5, and the gradient of the masked code (``if_detach=False``) at rtol
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.ops import latent_masking as jlm
from maxstyle_tpu_torch.ops import latent_masking as tlm

torch.set_num_threads(2)

B, H, W, C, NC = 3, 5, 6, 8, 3
N_METHODS = {"random": 3, "RSC": 2, "no_dropout": 2}


def nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def decoders(out_ch, seed=0):
    w = np.random.RandomState(seed).randn(C, out_ch).astype(np.float32)

    def jdec(code):
        return jnp.einsum("bhwc,ck->bhwk", jnp.tanh(code), jnp.asarray(w))

    def tdec(code):
        return torch.einsum("bchw,ck->bkhw", torch.tanh(code), torch.from_numpy(w))

    return jdec, tdec


def jax_masking_draws(key, perturb_type, threshold):
    """The numbers JAX's perturb_latent_code draws from ``key``."""
    k_sel, k_op = jax.random.split(key)
    k_pct, k_soft = jax.random.split(k_op)
    keep = jax.random.bernoulli(k_op, 1.0 - threshold, (B, 1, 1, C))
    n = N_METHODS.get(perturb_type, 1)
    return {"switch": torch.tensor(int(jax.random.randint(k_sel, (), 0, n))),
            "pct_u": torch.tensor(float(jax.random.uniform(k_pct))),
            "soft_channel": torch.from_numpy(np.array(jax.random.uniform(k_soft, (B, C)))),
            "soft_spatial": torch.from_numpy(np.array(jax.random.uniform(k_soft, (B, H * W)))),
            "keep": nchw(keep)}


def scores_and_cut(grad, method, threshold, random_threshold, pct_u):
    """JAX's scores [B,M] and thresholds [B,1] of the channel or spatial mask."""
    g = np.asarray(grad)
    if method == "channel":
        score, m = g.reshape(B, H * W, C).mean(axis=1), C
    else:
        score, m = g.mean(axis=-1).reshape(B, H * W), H * W
    pct = np.float32(threshold) * (np.float32(pct_u) if random_threshold else np.float32(1))
    k = int(np.clip(np.floor(np.float32(m) * pct), 0, m - 1))
    return score, np.sort(score, axis=1)[:, ::-1][:, k:k + 1]


def run_case(perturb_type, loss_type, if_soft, random_threshold, seed, if_detach=True):
    rng = np.random.RandomState(seed)
    code = rng.randn(B, H, W, C).astype(np.float32)
    if loss_type == "ce":
        target = rng.randint(0, NC, (B, H, W)).astype(np.int32)
        t_target = torch.from_numpy(target).long()
        jdec, tdec = decoders(NC, seed)
    else:
        target = rng.rand(B, H, W, 1).astype(np.float32)
        t_target = nchw(target)
        jdec, tdec = decoders(1, seed)
    threshold = 0.33
    key = jax.random.key(100 + seed)
    kw = dict(perturb_type=perturb_type, threshold=threshold, if_soft=if_soft,
              random_threshold=random_threshold, loss_type=loss_type, if_detach=if_detach)
    j_masked, j_mask = jlm.perturb_latent_code(jnp.asarray(code), jdec, jnp.asarray(target),
                                               num_classes=NC, key=key, **kw)
    draws = jax_masking_draws(key, perturb_type, threshold)
    t_code = nchw(code).requires_grad_(True)
    t_masked, t_mask = tlm.perturb_latent_code(t_code, tdec, t_target, num_classes=NC,
                                               draws=draws, **kw)
    return dict(code=code, jdec=jdec, target=target, loss_type=loss_type, kw=kw, key=key,
                draws=draws, threshold=threshold, j_masked=j_masked, j_mask=j_mask,
                t_code=t_code, t_masked=t_masked, t_mask=t_mask)


def chosen_method(perturb_type, switch):
    table = {"random": ("dropout", "spatial", "channel"), "RSC": ("spatial", "channel"),
             "no_dropout": ("spatial", "channel")}
    return table[perturb_type][switch] if perturb_type in table else perturb_type


def assert_masks_agree(r):
    want_mask = np.asarray(r["j_mask"]).transpose(0, 3, 1, 2)
    got_mask = r["t_mask"].detach().numpy()
    differ = got_mask != want_mask
    method = chosen_method(r["kw"]["perturb_type"], int(r["draws"]["switch"]))
    if differ.any():
        # only entries whose score lies within float32 rounding of the cut
        assert method in ("channel", "spatial"), "a dropout mask differs"
        grad = jax.grad(lambda c: jlm._mask_loss(r["jdec"](c), jnp.asarray(r["target"]),
                                                 r["loss_type"], NC))(jnp.asarray(r["code"]))
        score, cut = scores_and_cut(grad, method, r["threshold"],
                                    r["kw"]["random_threshold"], float(r["draws"]["pct_u"]))
        near = np.abs(score - cut) <= 8 * np.finfo(np.float32).eps * np.abs(score).max()
        if method == "channel":
            entry = differ.any(axis=(2, 3))
        else:
            entry = differ.any(axis=1).reshape(B, H * W)
        assert np.all(near[entry]), "a mask entry differs away from the threshold"
    same = ~differ
    np.testing.assert_allclose(r["t_masked"].detach().numpy()[same],
                               np.asarray(r["j_masked"]).transpose(0, 3, 1, 2)[same],
                               rtol=1e-5, atol=1e-6)
    return method


@pytest.mark.parametrize("perturb_type", ["dropout", "channel", "spatial", "random", "RSC",
                                          "no_dropout"])
@pytest.mark.parametrize("loss_type", ["mse", "ce", "corr", "l1"])
def test_perturb_latent_code_matches_jax(perturb_type, loss_type):
    methods = set()
    for seed, (if_soft, random_threshold) in enumerate([(False, False), (True, True),
                                                        (True, False), (False, True)]):
        r = run_case(perturb_type, loss_type, if_soft, random_threshold, seed)
        methods.add(assert_masks_agree(r))
        assert not r["t_masked"].requires_grad
    if perturb_type in ("dropout", "channel", "spatial"):
        assert methods == {perturb_type}


@pytest.mark.parametrize("perturb_type", ["RSC", "random"])
def test_masked_code_gradient_without_detach_matches_jax(perturb_type):
    for seed in range(3):
        r = run_case(perturb_type, "corr", False, False, seed, if_detach=False)
        assert_masks_agree(r)
        g = np.random.RandomState(seed).randn(B, H, W, C).astype(np.float32)

        def j(c):
            masked, _ = jlm.perturb_latent_code(c, r["jdec"], jnp.asarray(r["target"]),
                                                num_classes=NC, key=r["key"], **r["kw"])
            return jnp.sum(masked * g)

        jg = np.asarray(jax.grad(j)(jnp.asarray(r["code"]))).transpose(0, 3, 1, 2)
        (r["t_masked"] * nchw(g)).sum().backward()
        np.testing.assert_allclose(r["t_code"].grad.numpy(), jg, rtol=1e-4, atol=1e-6)


def test_threshold_mask_cuts_at_the_sorted_index():
    score = torch.tensor([[0.5, 0.1, 0.9, 0.3], [0.2, 0.8, 0.4, 0.6]])
    # k = 1: the cut is each row's second largest score, strictly above it is masked
    mask = tlm._threshold_mask(score, torch.tensor(1.0), None)
    assert mask.tolist() == [[1, 1, 0, 1], [1, 0, 1, 1]]
    soft = tlm._threshold_mask(score, torch.tensor(1.0), torch.full((2, 4), 0.5))
    assert soft.tolist() == [[1, 1, 0.25, 1], [1, 0.25, 1, 1]]
    assert tlm._threshold_mask(score, torch.tensor(0.0), None).sum() == 8
    # k beyond the row clamps to the last index: nothing lies above the minimum's cut
    assert tlm._threshold_mask(score, torch.tensor(9.0), None).sum() == 2


def test_port_draws_have_the_documented_shapes():
    d = tlm.draw_masking(torch.Generator().manual_seed(0), (B, C, H, W), "random", 0.33)
    assert d["switch"].shape == () and 0 <= int(d["switch"]) < 3
    assert d["soft_channel"].shape == (B, C) and d["soft_spatial"].shape == (B, H * W)
    assert d["keep"].dtype == torch.bool and d["keep"].shape == (B, C, 1, 1)
