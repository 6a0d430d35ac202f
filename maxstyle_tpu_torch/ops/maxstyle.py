"""MaxStyle: adversarial style composition op, and MixStyle / DSU (plain
PyTorch, NCHW).

Counterpart of ``maxstyle_tpu/ops/maxstyle.py``. The MaxStyle op is a
function of an explicit parameter/state pair rather than a stateful module:

* :class:`MaxStyleParams` — the learnable style tensors the inner
  adversarial loop optimizes: ``lmda`` [B,1,1,1], ``gamma_noise`` and
  ``beta_noise`` [B,C,1,1].
* :class:`MaxStyleState` — per-batch constants: the non-identity batch
  permutation, the Bernoulli gate, and the stat spreads ``gamma_std`` /
  ``beta_std`` ([1,C,1,1], or [B,C,1,1] with ``style_group_size``), NaN
  until the first application caches them.

Instance statistics and spreads are detached and ``lmda`` is clamped to
[0, 1], so gradients flow only through the affine path, ``lmda`` (inside the
clamp) and the two noise tensors. This module is the autograd reference that
the fused kernels in ``ops/maxstyle_kernels.py`` are held against.

Inside a data group (``parallel/mesh.sharded``) x holds the rank's rows of
the global batch: the params hold the same rows, the state's permutation
indexes global rows, the instance statistics of every rank are gathered
so that a partner's come from its rank and the spreads are taken over the
global batch (or global style group), and the MixStyle/DSU draws are
those of the global batch, of which each call takes the rank's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from maxstyle_tpu_torch import prng
from maxstyle_tpu_torch.config import MaxStyleConfig
from maxstyle_tpu_torch.parallel import mesh


@dataclasses.dataclass
class MaxStyleParams:
    lmda: torch.Tensor         # [B,1,1,1]
    gamma_noise: torch.Tensor  # [B,C,1,1]
    beta_noise: torch.Tensor   # [B,C,1,1]

    def tensors(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.lmda, self.gamma_noise, self.beta_noise


@dataclasses.dataclass
class MaxStyleState:
    perm: torch.Tensor       # [B] int64, never the identity
    gate: torch.Tensor       # [] float32: 1.0 apply, 0.0 no-op
    gamma_std: torch.Tensor  # [1,C,1,1] or [B,C,1,1]; NaN until cached
    beta_std: torch.Tensor


def _group_size(cfg: MaxStyleConfig, batch_size: int) -> int:
    """The style group: the whole batch unless a smaller divisor is set."""
    g = cfg.style_group_size
    if g is None or g >= batch_size:
        return batch_size
    if batch_size % g:
        raise ValueError(
            f"style_group_size={g} must divide the style batch "
            f"({batch_size}) — pad or change the batch")
    return g


def draw_beta(generator: torch.Generator, alpha: float, shape) -> torch.Tensor:
    """Beta(alpha, alpha) draws as X / (X + Y) of two Gamma(alpha) draws from
    ``generator`` (``torch.distributions.Beta`` takes no generator)."""
    a = torch.full((2,) + tuple(shape), alpha, device=generator.device)
    gam = torch._standard_gamma(a, generator=generator)
    total = gam[0] + gam[1]
    # both gammas may underflow to 0 at small alpha: fall back to the Beta
    # distribution's limit, a fair coin between 0 and 1
    return torch.where(total > 0, gam[0] / total.clamp_min(1e-38), (gam[0] >= gam[1]).float())


def draw_maxstyle(generator: torch.Generator, batch_size: int, num_features: int,
                  cfg: MaxStyleConfig) -> Dict[str, torch.Tensor]:
    """The random part of :func:`init_maxstyle`: raw permutations (one per
    style group), the gate's uniform, lmda and the two noise tensors."""
    dev = generator.device
    g = _group_size(cfg, batch_size)
    perms = torch.stack([torch.randperm(g, generator=generator, device=dev)
                         for _ in range(batch_size // g)])
    gate_u = torch.rand((), generator=generator, device=dev)
    lmda_shape = (batch_size, 1, 1, 1)
    if cfg.always_use_beta:
        lmda = draw_beta(generator, cfg.alpha, lmda_shape)
    else:
        lmda = torch.rand(lmda_shape, generator=generator, device=dev)
    noise_shape = (batch_size, num_features, 1, 1)
    gn = torch.randn(noise_shape, generator=generator, device=dev)
    bn = torch.randn(noise_shape, generator=generator, device=dev)
    return {"perms": perms, "gate_u": gate_u, "lmda": lmda,
            "gamma_noise": gn, "beta_noise": bn}


def maxstyle_from_draws(draws: Dict[str, torch.Tensor], cfg: MaxStyleConfig
                        ) -> Tuple[MaxStyleParams, MaxStyleState]:
    """The deterministic part of :func:`init_maxstyle` (maxstyle.py:54-94 of
    the JAX package): never-identity permutations laid out block-diagonally
    over the style groups, the gate, and the learnable/zero switches."""
    perms = torch.as_tensor(draws["perms"])
    n_groups, g = perms.shape
    b = n_groups * g
    dev = perms.device
    perms = torch.stack([prng.non_identity_permutation(p) for p in perms])
    perm = (perms + torch.arange(n_groups, device=dev)[:, None] * g).reshape(b)
    gate = (draws["gate_u"] < cfg.p).float()
    lmda = draws["lmda"] if cfg.mix_style else torch.zeros_like(draws["lmda"])
    if cfg.noise_learnable and not cfg.no_noise:
        gn, bn = draws["gamma_noise"], draws["beta_noise"]
    else:
        gn = torch.zeros_like(draws["gamma_noise"])
        bn = torch.zeros_like(draws["beta_noise"])
    c = gn.shape[1]
    nan_c = torch.full((1 if g == b else b, c, 1, 1), float("nan"), device=dev)
    return (MaxStyleParams(lmda=lmda, gamma_noise=gn, beta_noise=bn),
            MaxStyleState(perm=perm, gate=gate, gamma_std=nan_c,
                          beta_std=nan_c.clone()))


def init_maxstyle(generator: torch.Generator, batch_size: int, num_features: int,
                  cfg: MaxStyleConfig) -> Tuple[MaxStyleParams, MaxStyleState]:
    """Fresh per-batch style parameters and state, on the generator's device."""
    return maxstyle_from_draws(
        draw_maxstyle(generator, batch_size, num_features, cfg), cfg)


def learnable_mask(cfg: MaxStyleConfig) -> Tuple[float, float, float]:
    """0/1 factors for (lmda, gamma_noise, beta_noise): which tensors the
    inner optimizer may update."""
    mix = 1.0 if (cfg.mix_style and cfg.mix_learnable) else 0.0
    noi = 1.0 if (cfg.noise_learnable and not cfg.no_noise) else 0.0
    return mix, noi, noi


def instance_stats(x: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Detached per-(sample, channel) spatial mean and std, with the unbiased
    variance of torch's ``x.var``."""
    x = x.detach()
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=x.shape[2] * x.shape[3] > 1)
    return mu, torch.sqrt(var + eps)


def _group_std(v: torch.Tensor, g: int) -> torch.Tensor:
    """Unbiased std over the batch axis within each style group:
    [B,C,1,1] -> [1,C,1,1] when g == B, else [B,C,1,1] with each row
    carrying its group's spread."""
    b, c = v.shape[:2]
    v = v.detach()
    if g == b:
        return v.std(dim=0, keepdim=True, unbiased=b > 1)
    vg = v.reshape(b // g, g, c)
    std = vg.std(dim=1, keepdim=True, unbiased=g > 1).expand(b // g, g, c)
    return std.reshape(b, c, 1, 1)


def cached_spreads(state: MaxStyleState, sig: torch.Tensor, mu: torch.Tensor,
                   g: int) -> MaxStyleState:
    """Fill the NaN-sentinel spreads from this batch's stats; keep cached ones."""
    gamma_std = torch.where(torch.isnan(state.gamma_std), _group_std(sig, g),
                            state.gamma_std)
    beta_std = torch.where(torch.isnan(state.beta_std), _group_std(mu, g),
                           state.beta_std)
    return dataclasses.replace(state, gamma_std=gamma_std, beta_std=beta_std)


def _styling_float(x: torch.Tensor) -> torch.Tensor:
    """x in float32 when it is half precision: the style statistics and the
    mixing run at full precision (the JAX ops' cast under bf16 compute)."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def is_noop(x: torch.Tensor, cfg: MaxStyleConfig) -> bool:
    b, _, h, w = x.shape
    return mesh.global_batch(b) <= 1 or h * w == 1 or (not cfg.mix_style and cfg.no_noise)


def local_params(params: MaxStyleParams) -> MaxStyleParams:
    """The rank's rows of style params of the global batch."""
    return MaxStyleParams(*(mesh.local_rows(t) for t in params.tensors()))


def _local_spread(std: torch.Tensor) -> torch.Tensor:
    """A spread's rows for this rank: [1,C,1,1] as it is, [B,C,1,1] sliced."""
    return std if std.shape[0] == 1 else mesh.local_rows(std)


def apply_maxstyle(x: torch.Tensor, params: MaxStyleParams, state: MaxStyleState,
                   cfg: MaxStyleConfig) -> Tuple[torch.Tensor, MaxStyleState]:
    """Forward pass of the op on x [B,C,H,W]; returns (out, state') where
    state' carries the spreads cached on first application. Half-precision
    activations are styled in float32 and cast back."""
    if is_noop(x, cfg):
        return x, state
    in_dtype = x.dtype
    x = _styling_float(x)
    mu, sig = instance_stats(x, cfg.eps)
    x_normed = (x - mu) / sig
    mu_g, sig_g = mesh.gather_rows(mu), mesh.gather_rows(sig)
    new_state = cached_spreads(state, sig_g, mu_g, _group_size(cfg, mu_g.shape[0]))

    if cfg.mix_style:
        lm = params.lmda.clamp(0.0, 1.0)
        perm = mesh.local_rows(state.perm)
        sig_mix = sig * (1.0 - lm) + sig_g[perm] * lm
        mu_mix = mu * (1.0 - lm) + mu_g[perm] * lm
    else:
        sig_mix, mu_mix = sig, mu

    if cfg.no_noise:
        x_aug = sig_mix * x_normed + mu_mix
    else:
        x_aug = ((sig_mix + params.gamma_noise * _local_spread(new_state.gamma_std)) * x_normed
                 + (mu_mix + params.beta_noise * _local_spread(new_state.beta_std)))
    return (state.gate * x_aug + (1.0 - state.gate) * x).to(in_dtype), new_state


# ---------------------------------------------------------------------------
# MixStyle / DSU (non-learnable style mixing; advanced/mixstyle.py:6-108)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MixStyleConfig:
    p: float = 0.5
    alpha: float = 0.1
    eps: float = 1e-8
    mix: str = "random"  # "random" | "crossdomain" | "gaussian" (DSU)


def _batch_std(v: torch.Tensor) -> torch.Tensor:
    """torch.std(v, dim=0), unbiased over the batch: [B,C,1,1] -> [1,C,1,1]."""
    return v.detach().std(dim=0, keepdim=True, unbiased=v.shape[0] > 1)


def draw_mixstyle(generator: torch.Generator, batch_size: int, num_features: int,
                  cfg: MixStyleConfig) -> Dict[str, torch.Tensor]:
    """The random part of one MixStyle/DSU call: the gate's uniform
    ``gate_u``, then for mixing ``lmda`` [B,1,1,1] ~ Beta(alpha, alpha) and
    the batch permutation ``perm`` (crossdomain: the reversed batch shuffled
    within each half), for DSU the normals ``g_mu`` and ``g_sig`` [B,C,1,1]."""
    dev = generator.device
    b = batch_size
    draws = {"gate_u": torch.rand((), generator=generator, device=dev)}
    if cfg.mix == "gaussian":
        shape = (b, num_features, 1, 1)
        draws["g_mu"] = torch.randn(shape, generator=generator, device=dev)
        draws["g_sig"] = torch.randn(shape, generator=generator, device=dev)
        return draws
    if cfg.mix not in ("random", "crossdomain"):
        raise NotImplementedError(cfg.mix)
    draws["lmda"] = draw_beta(generator, cfg.alpha, (b, 1, 1, 1))
    if cfg.mix == "random":
        draws["perm"] = torch.randperm(b, generator=generator, device=dev)
    else:
        rev = torch.arange(b - 1, -1, -1, device=dev)
        half = b // 2
        top = rev[:half][torch.randperm(half, generator=generator, device=dev)]
        bot = rev[half:][torch.randperm(b - half, generator=generator, device=dev)]
        draws["perm"] = torch.cat([top, bot])
    return draws


def apply_mixstyle(x: torch.Tensor, cfg: MixStyleConfig,
                   draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One MixStyle/DSU application to x [B,C,H,W] with the draws of
    :func:`draw_mixstyle` (those of the global batch in a data group): a per-call Bernoulli gate (gate_u <= p), instance
    statistics mixed with a permuted batch's (mix "random" or
    "crossdomain"), or perturbed by N(0,1) times their spread over the batch
    (mix "gaussian", DSU). The gate is arithmetic, gate*out + (1-gate)*x.
    Half-precision activations are styled in float32 and cast back."""
    b = x.shape[0]
    if mesh.global_batch(b) <= 1:
        return x
    in_dtype = x.dtype
    x = _styling_float(x)
    gate = (draws["gate_u"] <= cfg.p).to(x.dtype)
    mu, sig = instance_stats(x, cfg.eps)
    x_normed = (x - mu) / sig
    mu_g, sig_g = mesh.gather_rows(mu), mesh.gather_rows(sig)
    if cfg.mix == "gaussian":
        mu_mix = mu + mesh.local_rows(draws["g_mu"]) * _batch_std(mu_g)
        sig_mix = sig + mesh.local_rows(draws["g_sig"]) * _batch_std(sig_g)
    else:
        lmda, perm = mesh.local_rows(draws["lmda"]), mesh.local_rows(draws["perm"])
        mu_mix = mu * (1 - lmda) + mu_g[perm] * lmda
        sig_mix = sig * (1 - lmda) + sig_g[perm] * lmda
    out = x_normed * sig_mix + mu_mix
    return (gate * out + (1.0 - gate) * x).to(in_dtype)
