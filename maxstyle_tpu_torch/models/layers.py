"""Building blocks of the model families as torch modules (NCHW).

Counterpart of ``maxstyle_tpu/models/layers.py``, with the JAX package's
initialisation (which is the reference's effective one):

* conv weights Kaiming-normal, fan in, gain sqrt(2); biases zero (torch's
  own default bias init differs);
* transposed-conv weights N(0, 0.02), bias zero;
* BatchNorm scale N(1, 0.02), bias 0, eps 1e-5, momentum 0.1.

Compute dtype. Every module that holds weights has a ``compute_dtype``
(None by default), set on a whole bundle by :func:`set_compute_dtype`, as
flax's ``dtype=`` is on the JAX package's modules. Parameters and running
statistics stay float32. With a dtype, a convolution or a linear map casts
its input, weight and bias to it first; a norm takes its statistics and
normalizes in float32 and returns the dtype. Without one, a convolution
computes in the promotion of its input's and weight's dtypes (flax's
``promote_dtype``) and a norm returns its input's dtype.

BatchNorm mode protocol. Every module's ``forward`` takes ``mode``:

* ``"train"`` — batch statistics (biased variance) normalize; the running
  mean and the running unbiased variance are updated with momentum 0.1;
* ``"frozen"`` — batch statistics normalize and nothing is written;
* ``"eval"`` — the running statistics normalize.

Module and parameter names follow the flax names of the JAX package, so
``convert.py`` maps one onto the other by path.
"""

from __future__ import annotations

import contextlib
import zlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maxstyle_tpu_torch.ops import batchnorm_kernels, linear_kernels
from maxstyle_tpu_torch.parallel import mesh

LRELU_SLOPE = 0.2
MODES = ("train", "frozen", "eval")

# The running-update experiment of ``scripts/exp_bn_residual`` (never set in
# training or tests of training). None, the default, is the shipped route:
# the batch norm (on a CUDA tensor the kernels of ``ops/batchnorm_kernels``)
# updates the running statistics itself, with the Bessel-corrected update.
# Set, every arm takes the same explicit route (the
# batch moments, then the update below, then a statistics-free batch norm),
# so the arms differ only in the update: "torch" is the shipped semantics;
# "biased" updates without the n/(n-1) factor; "off" does not update the
# running statistics. Read each time a BatchNorm runs in "train" mode; it
# never changes the output.
_BN_UPDATE_MODE = None


def _running_update(prev_mean: torch.Tensor, prev_var: torch.Tensor, mean: torch.Tensor,
                    var: torch.Tensor, n: int, m: float):
    """The running (mean, var) after a "train" pass with batch moments
    (mean, biased var) over n values a channel, by ``_BN_UPDATE_MODE``."""
    if _BN_UPDATE_MODE == "off":
        return prev_mean, prev_var
    bessel = 1.0 if _BN_UPDATE_MODE == "biased" else n / max(n - 1, 1)
    return (1.0 - m) * prev_mean + m * mean, (1.0 - m) * prev_var + m * var * bessel


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


def _kaiming_fan_in_(w: torch.Tensor) -> torch.Tensor:
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    with torch.no_grad():
        return w.normal_(0.0, (2.0 / fan_in) ** 0.5)


def _cast_dtype(module: nn.Module, x: torch.Tensor) -> torch.dtype:
    """The dtype a weighted module computes in: its compute dtype, or the
    promotion of its input's and its weight's."""
    return module.compute_dtype or torch.promote_types(x.dtype, module.weight.dtype)


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that casts its input, weight and bias to its compute dtype."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _cast_dtype(self, x)
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d that casts like :class:`Conv2d`."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _cast_dtype(self, x)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), _cast(self.bias, dt),
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


def kernel_route(dtype: torch.dtype, device: torch.device) -> bool:
    """Whether a linear map computed in ``dtype`` on ``device`` runs on the
    port's GEMM (float32 on CUDA) rather than ``F.linear``."""
    return dtype is torch.float32 and device.type == "cuda"


class Linear(nn.Linear):
    """nn.Linear that casts like :class:`Conv2d` (flax's Dense).

    Route by dtype and device: a float32 product of a CUDA tensor runs on the
    split-TF32 GEMM of ``ops/linear_kernels`` (forward, dx, dW and db);
    every other product (a CPU tensor, a bf16, fp16 or float64 compute
    dtype) is ``F.linear``."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _cast_dtype(self, x)
        if kernel_route(dt, x.device):
            return linear_kernels.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm that, with a compute dtype, normalizes in float32 and
    returns the dtype (flax's LayerNorm: statistics and the affine map in
    float32, then the cast)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        return super().forward(x.float()).to(self.compute_dtype)


def set_compute_dtype(modules: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Give every module of ``modules`` that has a ``compute_dtype`` this one
    (None for float32 compute); returns ``modules``."""
    for m in modules.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return modules


def conv3x3(in_ch: int, out_ch: int, bias: bool = True, stride: int = 1) -> Conv2d:
    conv = Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, bias=bias)
    _kaiming_fan_in_(conv.weight)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


def conv1x1(in_ch: int, out_ch: int, bias: bool = True) -> Conv2d:
    conv = Conv2d(in_ch, out_ch, 1, bias=bias)
    _kaiming_fan_in_(conv.weight)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


def _channel_dims(x: torch.Tensor) -> Tuple[int, ...]:
    """Every dim of [N, C, *spatial] but the channels'."""
    return (0,) + tuple(range(2, x.dim()))


def _bcast(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A [C] tensor shaped to broadcast over [N, C, ...] of ``ndim`` dims."""
    return t.reshape((1, -1) + (1,) * (ndim - 2))


class BatchNorm(nn.Module):
    """BatchNorm2d with torch running-stat semantics and an explicit mode.

    Inside :func:`live_running_stats` each "train" pass also keeps its
    updated running statistics as tensors with their autograd graph, and
    "eval" passes normalize with those: the JAX step threads its updated
    statistics through the loss function, so an eval-mode forward there
    (the AdvNoise/AdvBias consistency) differentiates through them into
    the weights that produced the batch statistics.

    With a compute dtype the input is cast to float32 first and the result
    to the dtype: the JAX package's BatchNorm reduces, normalizes and applies
    the affine map in float32 whatever the activations' dtype.

    Inside a data group (``parallel/mesh.sharded``) "train" and "frozen"
    take the global batch's statistics: every rank's count, mean and sum of
    squared deviations, in float32, gathered in one differentiable
    all-reduce and combined, so the backward pass carries the cross-rank
    terms; the running variance takes the Bessel factor of the global
    count. "eval" is per sample and stays local.

    Otherwise a "train" or "frozen" pass of a CUDA tensor runs on the
    hand-written kernels of ``ops/batchnorm_kernels`` (one launch a
    direction, NCHW or channels-last), and of a CPU tensor on
    ``F.batch_norm``; "eval" and the live route keep their PyTorch ops on
    both."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(1.0 + 0.02 * torch.randn(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.track_live = False
        # (running mean, running var, eval scale, eval shift), with graph
        self._live: Optional[Tuple[torch.Tensor, ...]] = None

    def _train_live(self, x: torch.Tensor) -> torch.Tensor:
        """A "train" pass that keeps its updated running statistics: one
        set of batch moments both normalizes x and, Bessel-corrected in the
        momentum update, becomes the running statistics, differentiable in
        x; the buffers take their values. The affine map of an "eval" pass
        with those statistics is kept beside them."""
        if mesh.active() is None:
            n = x.numel() // x.shape[1]
            var, mean = torch.var_mean(x, dim=_channel_dims(x), unbiased=False)
        else:
            mean, var, n = self._global_moments(x)
        prev_mean, prev_var = self._live[:2] if self._live else (self.running_mean,
                                                                 self.running_var)
        run_mean, run_var = _running_update(prev_mean, prev_var, mean, var, n, self.momentum)
        with torch.no_grad():
            self.running_mean.copy_(run_mean)
            self.running_var.copy_(run_var)
        self._live = (run_mean, run_var) + self._affine(run_mean, run_var)
        scale, shift = self._affine(mean, var)
        return torch.addcmul(_bcast(shift, x.dim()), x, _bcast(scale, x.dim()))

    def _global_moments(self, x: torch.Tensor):
        """(mean, biased var, count) of x over the data group's global batch:
        every rank's (count, mean, sum of squared deviations) gathered in one
        differentiable all-reduce and combined by Chan's parallel formula.
        Combining Σx and Σx² instead cancels catastrophically where a
        channel's mean is large against its spread. The count, for the
        Bessel factor, is the ranks' equal shards' total."""
        c = x.shape[1]
        var, mean = torch.var_mean(x, dim=_channel_dims(x), unbiased=False)
        n = x.numel() // c
        ranks = mesh.gather_rows(torch.stack([x.new_full((c,), float(n)), mean, var * n])[None])
        counts, means, m2 = ranks.unbind(1)
        total = counts.sum(0)
        mean = (counts * means).sum(0) / total
        var = (m2.sum(0) + (counts * (means - mean) ** 2).sum(0)) / total
        return mean, var, n * mesh.active().world

    def _global_normalize(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        """"train" or "frozen" with the global batch's statistics."""
        mean, var, n = self._global_moments(x)
        if mode == "train":
            self._write_running(mean, var, n)
        scale, shift = self._affine(mean, var)
        return torch.addcmul(_bcast(shift, x.dim()), x, _bcast(scale, x.dim()))

    @torch.no_grad()
    def _write_running(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        run_mean, run_var = _running_update(self.running_mean, self.running_var, mean, var, n,
                                            self.momentum)
        self.running_mean.copy_(run_mean)
        self.running_var.copy_(run_var)

    def _affine(self, mean: torch.Tensor, var: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scale, shift) [C] of normalizing with (mean, var), then the affine."""
        scale = self.weight * torch.rsqrt(var + self.eps)
        return scale, self.bias - mean * scale

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        if self.compute_dtype is None:
            return self._normalize(x, mode)
        return self._normalize(x.float(), mode).to(self.compute_dtype)

    def _normalize(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        if mode == "train":
            if self.track_live:
                return self._train_live(x)
            if mesh.active() is not None:
                return self._global_normalize(x, mode)
            if _BN_UPDATE_MODE is None:
                if x.is_cuda:
                    return batchnorm_kernels.batch_norm(x, self.weight, self.bias,
                                                        self.running_mean, self.running_var,
                                                        self.momentum, self.eps)
                return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                    self.bias, True, self.momentum, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=_channel_dims(x), unbiased=False)
            self._write_running(mean, var, x.numel() // x.shape[1])
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if mode == "frozen":
            if mesh.active() is not None:
                return self._global_normalize(x, mode)
            if x.is_cuda:
                return batchnorm_kernels.batch_norm(x, self.weight, self.bias, None, None, 0.0,
                                                    self.eps)
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if mode == "eval":
            if self._live is not None:
                scale, shift = self._live[2:]
                return torch.addcmul(_bcast(shift, x.dim()), x, _bcast(scale, x.dim()))
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        raise ValueError(f"BatchNorm mode must be one of {MODES}, got {mode!r}")


@contextlib.contextmanager
def live_running_stats(nets: nn.Module):
    """Inside, every BatchNorm of ``nets`` keeps its "train" passes' updated
    running statistics with their graph, and its "eval" passes normalize
    with them; on exit they are dropped (the buffers hold the same values)."""
    norms = [m for m in nets.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.track_live, m._live = True, None
    try:
        yield
    finally:
        for m in norms:
            m.track_live, m._live = False, None


class InstanceNorm(nn.Module):
    """Per-(sample, channel) normalization with the biased variance and eps
    1e-5 inside the sqrt, the same in every mode; with ``affine`` a learned
    scale (ones) and bias (zeros) follow. With a compute dtype, in float32
    and cast to the dtype after."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, features: int, affine: bool = False):
        super().__init__()
        self.features = features
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        if self.compute_dtype is not None:
            x = x.float()
        var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, unbiased=False)
        out = (x - mean) / torch.sqrt(var + 1e-5)
        if self.affine:
            out = out * self.weight[:, None, None] + self.bias[:, None, None]
        return out if self.compute_dtype is None else out.to(self.compute_dtype)


class Identity(nn.Module):
    """The "none" norm."""

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        return x


def Norm2d(kind: str, features: int) -> nn.Module:
    """Norm selector: "batch" (affine BatchNorm), "instance" (no affine),
    "instance_affine", "batch_instance" (:class:`BatchInstanceNorm` with
    affine and running statistics), "batch_instance_noaffine" (neither:
    batch statistics in every mode) or "none"."""
    if kind == "batch":
        return BatchNorm(features)
    if kind in ("instance", "instance_affine"):
        return InstanceNorm(features, affine=kind == "instance_affine")
    if kind == "none":
        return Identity()
    if kind in ("batch_instance", "batch_instance_noaffine"):
        affine = kind == "batch_instance"
        return BatchInstanceNorm(features, affine=affine, track_running_stats=affine)
    raise ValueError(kind)


class DomainSpecificNorm2d(nn.Module):
    """One BatchNorm a domain (children ``bn_domain{d}``); ``domain_id``, a
    Python int, picks the one that normalizes and, in "train" mode, updates
    its running statistics. The others are left as they are."""

    def __init__(self, num_domains: int, features: int):
        super().__init__()
        for d in range(num_domains):
            self.add_module(f"bn_domain{d}", BatchNorm(features))

    def forward(self, x: torch.Tensor, mode: str, domain_id: int = 0) -> torch.Tensor:
        return getattr(self, f"bn_domain{domain_id}")(x, mode)


def make_norm(kind: str, features: int, num_domains: int) -> nn.Module:
    return DomainSpecificNorm2d(num_domains, features) if num_domains > 1 else Norm2d(kind, features)


def apply_norm(norm: nn.Module, x: torch.Tensor, mode: str, domain_id: int) -> torch.Tensor:
    if isinstance(norm, DomainSpecificNorm2d):
        return norm(x, mode, domain_id)
    return norm(x, mode)


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(dim=0): v / max(||v||, eps)."""
    return v / torch.clamp(torch.linalg.vector_norm(v), min=eps)


class TorchSNConv3x3(nn.Module):
    """3x3 conv under torch-semantics spectral normalization with one power
    iteration, the conv1 of the domain-specific encoder's down blocks.

    ``u`` [O] and ``v`` [I*9] are buffers. "train" and "frozen" passes first
    run one power iteration on the weight matrix W (O, I*9), without
    gradient: v = normalize(W^T u), u = normalize(W v); "train" writes the
    new u and v back, "frozen" drops them; "eval" uses the stored ones.
    Then sigma = u . (W v) with u and v constants and W live, so the
    backward carries the quotient-rule term of W / sigma. Sigma and W / sigma
    are float32; the convolution casts like :class:`Conv2d`.
    ``torch.nn.utils.spectral_norm`` is not used: its hook writes u and v
    back in every training forward."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3))
        _kaiming_fan_in_(self.weight)
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.register_buffer("u", _l2_normalize(torch.randn(out_ch)))
        self.register_buffer("v", _l2_normalize(torch.randn(in_ch * 9)))

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        w_mat = self.weight.reshape(self.weight.shape[0], -1)
        u, v = self.u, self.v
        if mode in ("train", "frozen"):
            with torch.no_grad():
                w_sg = w_mat.detach()
                v = _l2_normalize(w_sg.t() @ u)
                u = _l2_normalize(w_sg @ v)
                if mode == "train":
                    self.u.copy_(u)
                    self.v.copy_(v)
        elif mode != "eval":
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        sigma = torch.dot(u, w_mat @ v)
        dt = _cast_dtype(self, x)
        return F.conv2d(x.to(dt), (self.weight / sigma).to(dt), self.bias.to(dt), padding=1)


def _flax_l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """flax's ``_l2_normalize``: v * rsqrt(sum(v * v) + eps)."""
    return v * torch.rsqrt((v * v).sum() + eps)


class SpectralNormConv2d(nn.Module):
    """A convolution under flax ``nn.SpectralNorm`` semantics (the JAX
    package's ``if_sn``): before every application one power iteration on
    the kernel as a matrix [kh*kw*I, O] (here the weight as [O, I*kh*kw],
    its transpose up to a row order that neither u nor sigma sees), from
    the stored ``u`` [1, O], eps 1e-12 inside the rsqrt, without gradient:
    v = normalize(u W^T), u' = normalize(v W); sigma = v W u'^T with W
    live, and the convolution takes W / sigma (sigma 0 counts as 1). Every
    mode computes so; "train" also stores u' and sigma (the buffers ``u``
    and ``sigma``, flax's batch stats), "frozen" and "eval" do not. The
    bias is not normalized. Takes over the weight, bias, stride and padding
    of ``conv``; casts like :class:`Conv2d`."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.weight = conv.weight
        self.bias = conv.bias
        self.stride, self.padding = conv.stride, conv.padding
        out = conv.weight.shape[0]
        self.register_buffer("u", torch.randn(1, out))
        self.register_buffer("sigma", torch.ones(()))

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        w_mat = self.weight.reshape(self.weight.shape[0], -1)  # [O, K]
        with torch.no_grad():
            v = _flax_l2_normalize(self.u @ w_mat)
            u = _flax_l2_normalize(v @ w_mat.t())
        sigma = (v @ w_mat.t() @ u.t())[0, 0]
        if mode == "train":
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        w = self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        dt = self.compute_dtype or torch.promote_types(x.dtype, w.dtype)
        return F.conv2d(x.to(dt), w.to(dt), _cast(self.bias, dt), self.stride, self.padding)


def conv_in_mode(conv: nn.Module, x: torch.Tensor, mode: str) -> torch.Tensor:
    """A convolution that may be spectral-normed (which takes the mode)."""
    if isinstance(conv, (TorchSNConv3x3, SpectralNormConv2d)):
        return conv(x, mode)
    return conv(x)


def upsample2x(x: torch.Tensor, method: str = "NN") -> torch.Tensor:
    """x2 by nearest neighbour, or bilinear with align_corners=True (output
    j samples the input at j*(H-1)/(2H-1)), which the JAX package computes
    as two constant-matrix contractions, in float32 for half-precision
    activations: the two agree to rounding."""
    if method in ("NN", "nearest"):
        return F.interpolate(x, scale_factor=2, mode="nearest")
    if method == "bilinear":
        xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
        return F.interpolate(xf, size=(2 * x.shape[2], 2 * x.shape[3]), mode="bilinear",
                             align_corners=True).to(x.dtype)
    raise ValueError(method)


def transposed_conv(features: int, kernel: int, padding: int,
                    in_features: Optional[int] = None) -> ConvTranspose2d:
    conv = ConvTranspose2d(in_features or features, features, kernel, stride=2,
                           padding=padding)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.02)
        conv.bias.zero_()
    return conv


class Upsampler(nn.Module):
    """Front of an up block: nearest-neighbour or bilinear (align_corners)
    x2, or a learned transposed conv with N(0, 0.02) weights: "Conv2" (2x2,
    stride 2) or "Conv4" (4x4, stride 2, padding 1, flax's "SAME" padding
    of that kernel: two rows and columns of the dilated input on each
    side)."""

    def __init__(self, up_type: str = "NN", features: Optional[int] = None):
        super().__init__()
        self.up_type = up_type
        if up_type == "Conv2":
            self.conv = transposed_conv(features, 2, 0)
        elif up_type == "Conv4":
            self.conv = transposed_conv(features, 4, 1)
        elif up_type not in ("NN", "bilinear"):
            raise NotImplementedError(f"Upsampler({up_type!r})")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up_type in ("Conv2", "Conv4"):
            return self.conv(x)
        return upsample2x(x, self.up_type)


class FixableDropout(nn.Module):
    """Channel-wise (2D) dropout with one keep-mask a layer a training step,
    on in "train" and "frozen" modes and off in "eval" (the JAX package
    passes no dropout rng in eval). The JAX step hands one "dropout" key to
    every pass, so each of its FixableDropout layers applies the same mask
    to the standard pass, the MaxStyle decodes and the hard-example pass:
    that is its replay of the reference's Fixable2DDropout. Here the step
    draws one seed from its generator and opens :func:`dropout_step`; each
    layer then draws its [N,C,1,1] mask once from a ``torch.Generator`` on
    the tensor's device, seeded from that seed and the layer's qualified
    module name (``name``, set by :func:`dropout_step`), and reuses it until
    the step closes. Outside a step,
    "train" and "frozen" raise, as flax's ``make_rng`` does without a
    dropout rng. Inside a data group (``parallel/mesh.sharded``) the mask
    is drawn, or given, at the global batch shape and the rank takes its
    rows, as the JAX step under GSPMD draws it."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.name = ""
        self._seed: Optional[int] = None
        self._given: Optional[torch.Tensor] = None
        self._masks: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        if self.rate == 0.0 or mode == "eval":
            return x
        keep = self.keep_mask(x.shape[0], x.shape[1], x.device)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))

    def keep_mask(self, n: int, c: int, device: torch.device) -> torch.Tensor:
        """The step's [n,c,1,1] boolean keep-mask on ``device``."""
        return self._step_mask((n, c, 1, 1), device)

    def _step_mask(self, shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
        key = (shape, device)
        full = mesh.global_shape(shape)
        if key not in self._masks and self._given is not None:
            if tuple(self._given.shape) != full:
                raise ValueError(f"{type(self).__name__} {self.name!r}: given mask of shape "
                                 f"{tuple(self._given.shape)}, expected {full}")
            self._masks[key] = mesh.local_rows(self._given.to(device=device, dtype=torch.bool))
        if key not in self._masks:
            if self._seed is None:
                raise RuntimeError(f"{type(self).__name__} {self.name!r}: train and frozen "
                                   "modes need a step's seed (dropout_step)")
            gen = torch.Generator(device=device)
            gen.manual_seed((self._seed + 1_000_003 * zlib.crc32(self.name.encode()))
                            % 2 ** 63)
            keep = torch.rand(full, generator=gen, device=device) < 1.0 - self.rate
            self._masks[key] = mesh.local_rows(keep)
        return self._masks[key]


class ElementDropout(FixableDropout):
    """Element-wise dropout (flax's ``nn.Dropout``) under
    :class:`FixableDropout`'s step protocol: one keep-mask of the input's
    whole shape a layer a step, drawn from the step's seed and the layer's
    name or injected by :func:`dropout_step`, replayed in every pass of the
    step; on in "train" and "frozen", off in "eval"."""

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        if self.rate == 0.0 or mode == "eval":
            return x
        keep = self._step_mask(tuple(x.shape), x.device)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


@contextlib.contextmanager
def dropout_step(nets: nn.Module, seed: Optional[int],
                 masks: Optional[Dict[str, torch.Tensor]] = None):
    """One training step's dropout: inside, every FixableDropout of ``nets``
    (and every ElementDropout) takes its qualified module name, draws its
    mask from ``seed`` once, or takes ``masks[name]`` (a boolean keep-mask,
    [N,C,1,1] or the input's shape, to inject a reference's masks), and
    applies it in every pass; on exit the masks are dropped."""
    layers = [(name, m) for name, m in nets.named_modules() if isinstance(m, FixableDropout)]
    for name, m in layers:
        m.name, m._seed, m._given, m._masks = name, seed, (masks or {}).get(name), {}
    try:
        yield
    finally:
        for _, m in layers:
            m._seed, m._given, m._masks = None, None, {}


class ResConvDown(nn.Module):
    """Strided-conv residual down block: down-conv(s2) ->
    [conv3-norm-lrelu-conv3-norm] + 1x1(skip) -> lrelu -> optional dropout.
    With ``if_sn`` every conv is a :class:`SpectralNormConv2d`. With
    ``num_domains`` > 1 every norm is domain-specific, and without
    ``if_sn`` conv1 is a :class:`TorchSNConv3x3`: the reference's
    domain-specific block spectral-norms conv1 in both of its branches."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch",
                 dropout: Optional[float] = None, num_domains: int = 1, if_sn: bool = False):
        super().__init__()

        def sn(conv):
            return SpectralNormConv2d(conv) if if_sn else conv

        self.down = sn(conv3x3(in_ch, in_ch, stride=2))
        if num_domains > 1 and not if_sn:
            self.conv1 = TorchSNConv3x3(in_ch, out_ch)
        else:
            self.conv1 = sn(conv3x3(in_ch, out_ch))
        self.norm1 = make_norm(norm, out_ch, num_domains)
        self.conv2 = sn(conv3x3(out_ch, out_ch))
        self.norm2 = make_norm(norm, out_ch, num_domains)
        self.conv_input = sn(conv1x1(in_ch, out_ch))
        self.dropout = FixableDropout(dropout) if dropout is not None else None

    def forward(self, x: torch.Tensor, mode: str, domain_id: int = 0) -> torch.Tensor:
        x = conv_in_mode(self.down, x, mode)
        h = lrelu(apply_norm(self.norm1, conv_in_mode(self.conv1, x, mode), mode, domain_id))
        h = apply_norm(self.norm2, conv_in_mode(self.conv2, h, mode), mode, domain_id)
        res = lrelu(conv_in_mode(self.conv_input, x, mode) + h)
        if self.dropout is not None:
            res = self.dropout(res, mode)
        return res


class ResUp(nn.Module):
    """Residual up block: upsample -> [conv3-norm-lrelu-conv3-norm] +
    1x1(skip) -> lrelu -> optional dropout."""

    def __init__(self, in_ch: int, out_ch: int, up_type: str = "NN", norm: str = "batch",
                 dropout: Optional[float] = None):
        super().__init__()
        self.up = Upsampler(up_type, features=in_ch)
        self.conv1 = conv3x3(in_ch, out_ch)
        self.norm1 = Norm2d(norm, out_ch)
        self.conv2 = conv3x3(out_ch, out_ch)
        self.norm2 = Norm2d(norm, out_ch)
        self.conv_input = conv1x1(in_ch, out_ch)
        self.dropout = FixableDropout(dropout) if dropout is not None else None

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        x = self.up(x)
        h = lrelu(self.norm1(self.conv1(x), mode))
        h = self.norm2(self.conv2(h), mode)
        res = lrelu(self.conv_input(x) + h)
        if self.dropout is not None:
            res = self.dropout(res, mode)
        return res


class InConv(nn.Module):
    """Encoder stem: conv3-norm-lrelu-conv3-norm (the caller applies the
    trailing lrelu); domain-specific norms with ``num_domains`` > 1."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch", num_domains: int = 1):
        super().__init__()
        self.conv1 = conv3x3(in_ch, out_ch)
        self.norm1 = make_norm(norm, out_ch, num_domains)
        self.conv2 = conv3x3(out_ch, out_ch)
        self.norm2 = make_norm(norm, out_ch, num_domains)

    def forward(self, x: torch.Tensor, mode: str, domain_id: int = 0) -> torch.Tensor:
        x = lrelu(apply_norm(self.norm1, self.conv1(x), mode, domain_id))
        return apply_norm(self.norm2, self.conv2(x), mode, domain_id)


class SelfAttention2d(nn.Module):
    """SAGAN-style self-attention over the pixels with 1x1 query, key (C/8
    channels) and value projections and a learned gate ``gamma`` (zero at
    init): gamma * attention(x) + x."""

    def __init__(self, ch: int):
        super().__init__()
        inner = max(ch // 8, 1)
        self.query = conv1x1(ch, inner)
        self.key = conv1x1(ch, inner)
        self.value = conv1x1(ch, ch)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        q = self.query(x).reshape(n, -1, h * w)
        k = self.key(x).reshape(n, -1, h * w)
        v = self.value(x).reshape(n, c, h * w)
        attn = torch.softmax(torch.einsum("ndq,ndk->nqk", q, k), dim=-1)
        out = torch.einsum("nqk,nck->ncq", attn, v).reshape(n, c, h, w)
        return self.gamma * out + x


# ---------------------------------------------------------------------------
# blocks no shipped config reaches (custom_layers.py of the reference)
# ---------------------------------------------------------------------------


def _linear(in_f: int, out_f: int) -> Linear:
    """A Dense layer: Kaiming-normal (fan in) weight, zero bias."""
    lin = Linear(in_f, out_f)
    with torch.no_grad():
        lin.weight.normal_(0.0, (2.0 / in_f) ** 0.5)
        lin.bias.zero_()
    return lin


def _straight_through_clamp(p: torch.Tensor) -> torch.Tensor:
    """p clamped to [0, 1] in value with the identity gradient: the
    reference clamps the parameter's data in place each forward, so the
    bound never stops its gradient."""
    return p - (p - p.clamp(0.0, 1.0)).detach()


class SqueezeExcite(nn.Module):
    """Channel SE (cSE): x * sigmoid(Dense(relu(Dense(mean_hw x)))), the
    hidden width C // reduction."""

    def __init__(self, channels: int, reduction: int = 2):
        super().__init__()
        self.Dense_0 = _linear(channels, channels // reduction)
        self.Dense_1 = _linear(channels // reduction, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.Dense_0(x.mean(dim=(2, 3))))
        return x * torch.sigmoid(self.Dense_1(s))[:, :, None, None]


class SpatialSqueezeExcite(nn.Module):
    """Spatial SE (sSE): x * sigmoid(conv1x1(x) to one channel)."""

    def __init__(self, channels: int):
        super().__init__()
        self.Conv_0 = conv1x1(channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.Conv_0(x))


class ChannelSpatialSqueezeExcite(nn.Module):
    """scSE: the elementwise max of cSE and sSE."""

    def __init__(self, channels: int, reduction: int = 2):
        super().__init__()
        self.SqueezeExcite_0 = SqueezeExcite(channels, reduction)
        self.SpatialSqueezeExcite_0 = SpatialSqueezeExcite(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.maximum(self.SqueezeExcite_0(x), self.SpatialSqueezeExcite_0(x))


class AdaptiveInstanceNorm2d(nn.Module):
    """AdaIN: instance-normalize (biased variance, ``eps`` inside the sqrt),
    then scale and shift by the given (gamma, beta), [N*C] or [N, C]."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, unbiased=False)
        normed = (x - mean) / torch.sqrt(var + self.eps)
        n = x.shape[0]
        return normed * gamma.reshape(n, -1, 1, 1) + beta.reshape(n, -1, 1, 1)


def spatial_pyramid_pool(x: torch.Tensor, levels=(1, 2, 4)) -> torch.Tensor:
    """SPP of x [N,C,H,W]: at each level lv, max pools of ceil(H/lv) x
    ceil(W/lv) windows at that stride with "SAME" padding (-inf), each
    flattened in (h, w, c) order as the JAX package flattens its NHWC
    pools, concatenated: [N, sum of the levels' cells * C]."""
    n, c, h, w = x.shape
    outs = []
    for lv in levels:
        kh, kw = -(-h // lv), -(-w // lv)
        oh, ow = -(-h // kh), -(-w // kw)
        ph, pw = max((oh - 1) * kh + kh - h, 0), max((ow - 1) * kw + kw - w, 0)
        padded = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
                       value=float("-inf"))
        pooled = F.max_pool2d(padded, (kh, kw), (kh, kw))
        outs.append(pooled.permute(0, 2, 3, 1).reshape(n, -1))
    return torch.cat(outs, dim=1)


def bilinear_additive_upsampling(x: torch.Tensor, out_ch: int) -> torch.Tensor:
    """x [N,C,H,W] resized 2x as ``jax.image.resize`` "linear" resizes, then
    each group of C // out_ch consecutive channels averaged."""
    from maxstyle_tpu_torch.ops.advchain import resize

    n, c, h, w = x.shape
    if c % out_ch:
        raise ValueError(f"{c} channels do not group into {out_ch}")
    up = resize(x, (2 * h, 2 * w), "bilinear")
    return up.reshape(n, out_ch, c // out_ch, 2 * h, 2 * w).mean(dim=2)


class AdaptiveBatchNorm2d(BatchNorm):
    """a * BN(x) + b * x with learnable scalars a (1) and b (0), the
    BatchNorm's protocol and initialisation."""

    def __init__(self, features: int):
        super().__init__(features)
        self.a = nn.Parameter(torch.ones(1))
        self.b = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        return self.a * super().forward(x, mode) + self.b * x


def _moments(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased var) over ``dims`` in one pass, the variance clamped at
    0, as the JAX package's norms compute them."""
    mean = x.mean(dim=dims)
    return mean, torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)


class _RunningStats(nn.Module):
    """Running mean and Bessel-corrected variance, momentum 0.1, updated by
    "train" passes; "eval" normalizes with them."""

    def __init__(self, features: int, momentum: float = 0.1):
        super().__init__()
        self.momentum = momentum
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def batch_moments(self, x: torch.Tensor, mode: str, track: bool = True):
        """(mean, var) [C] that normalize x in ``mode``."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode == "eval" and track:
            return self.running_mean, self.running_var
        mean, var = _moments(x, _channel_dims(x))
        if mode == "train" and track:
            n = x.numel() // x.shape[1]
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var * (n / max(n - 1, 1)))
        return mean, var


class AdaptiveBatchInstanceNorm(_RunningStats):
    """(rho * BN(x) + (1 - rho) * IN(x)) * gamma + beta, the BatchNorm
    without affine (running statistics as :class:`BatchNorm`'s), the
    instance norm with the biased variance and eps 1e-5, rho (init 1)
    clamped to [0, 1] straight through."""

    def __init__(self, features: int):
        super().__init__(features)
        self.rho = nn.Parameter(torch.ones(features))
        self.gamma = nn.Parameter(torch.ones(features))
        self.beta = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        x = x.float()
        mean, var = self.batch_moments(x, mode)
        bn = (x - _bcast(mean, 4)) * torch.rsqrt(_bcast(var, 4) + 1e-5)
        i_var, i_mean = torch.var_mean(x, dim=(2, 3), keepdim=True, unbiased=False)
        inorm = (x - i_mean) / torch.sqrt(i_var + 1e-5)
        rho = _bcast(_straight_through_clamp(self.rho), 4)
        return (rho * bn + (1.0 - rho) * inorm) * _bcast(self.gamma, 4) + _bcast(self.beta, 4)


class BatchInstanceNorm(_RunningStats):
    """Batch-Instance Normalization over [N, C, *spatial] (1 to 3 spatial
    dims): out = BN(x) * (w * g) + b + IN(x) * (w * (1 - g)), the gate g
    [C] (init 1: pure BN) clamped to [0, 1] straight through, both norms
    with eps 1e-5 inside the rsqrt and one-pass biased variances. With
    ``track_running_stats`` "train" updates the running statistics
    (momentum 0.1, Bessel-corrected) and "eval" normalizes with them;
    without, every mode takes the batch's. ``affine=False`` keeps w = 1,
    b = 0 and the gate a parameter (the reference crashes there). Computes
    in float32 and returns the input's dtype. ``expected_ndim`` checks the
    input's rank (the 1d/2d/3d classes)."""

    expected_ndim: Optional[int] = None

    def __init__(self, features: int, affine: bool = True, track_running_stats: bool = True):
        super().__init__(features)
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.gate = nn.Parameter(torch.ones(features))
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        if not track_running_stats:
            del self.running_mean, self.running_var

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        if self.expected_ndim is not None and x.dim() != self.expected_ndim:
            raise ValueError(f"expected a {self.expected_ndim}D input, got {x.dim()}D")
        if x.dim() < 3:
            raise ValueError(f"BatchInstanceNorm needs spatial dims, got a {x.dim()}D input")
        in_dtype, x = x.dtype, x.float()
        nd = x.dim()
        mean, var = self.batch_moments(x, mode, self.track_running_stats)
        bn = (x - _bcast(mean, nd)) * torch.rsqrt(_bcast(var, nd) + 1e-5)
        i_mean, i_var = _moments(x, tuple(range(2, nd)))
        i_mean, i_var = i_mean[(...,) + (None,) * (nd - 2)], i_var[(...,) + (None,) * (nd - 2)]
        inorm = (x - i_mean) * torch.rsqrt(i_var + 1e-5)
        gate = _straight_through_clamp(self.gate)
        if self.affine:
            w, b = self.weight, self.bias
        else:
            w, b = torch.ones_like(gate), torch.zeros_like(gate)
        out = bn * _bcast(w * gate, nd) + _bcast(b, nd) + inorm * _bcast(w * (1.0 - gate), nd)
        return out.to(in_dtype)


class BatchInstanceNorm1d(BatchInstanceNorm):
    """[N, C, L]."""

    expected_ndim = 3


class BatchInstanceNorm2d(BatchInstanceNorm):
    """[N, C, H, W]."""

    expected_ndim = 4


class BatchInstanceNorm3d(BatchInstanceNorm):
    """[N, C, D, H, W]."""

    expected_ndim = 5
