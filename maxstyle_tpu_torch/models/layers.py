"""Building blocks of the model families as torch modules (NCHW).

Counterpart of ``maxstyle_tpu/models/layers.py`` (all but the SE, AdaIN,
SPP and BatchInstanceNorm blocks), with the JAX package's initialisation
(which is the reference's effective one):

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

LRELU_SLOPE = 0.2
MODES = ("train", "frozen", "eval")


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


class Linear(nn.Linear):
    """nn.Linear that casts like :class:`Conv2d` (flax's Dense)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _cast_dtype(self, x)
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
    the affine map in float32 whatever the activations' dtype."""

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
        n = x.numel() // x.shape[1]
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        prev_mean, prev_var = self._live[:2] if self._live else (self.running_mean,
                                                                 self.running_var)
        m = self.momentum
        run_mean = (1.0 - m) * prev_mean + m * mean
        run_var = (1.0 - m) * prev_var + m * var * (n / max(n - 1, 1))
        with torch.no_grad():
            self.running_mean.copy_(run_mean)
            self.running_var.copy_(run_var)
        self._live = (run_mean, run_var) + self._affine(run_mean, run_var)
        scale, shift = self._affine(mean, var)
        return torch.addcmul(shift[:, None, None], x, scale[:, None, None])

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
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, True, self.momentum, self.eps)
        if mode == "frozen":
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if mode == "eval":
            if self._live is not None:
                scale, shift = self._live[2:]
                return torch.addcmul(shift[:, None, None], x, scale[:, None, None])
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


NORM_SWAP_ITEM = "ROADMAP Queue 1 item 7.2 (norm_swap and BatchInstanceNorm)"


def Norm2d(kind: str, features: int) -> nn.Module:
    """Norm selector: "batch" (affine BatchNorm), "instance" (no affine),
    "instance_affine" or "none"."""
    if kind == "batch":
        return BatchNorm(features)
    if kind in ("instance", "instance_affine"):
        return InstanceNorm(features, affine=kind == "instance_affine")
    if kind == "none":
        return Identity()
    if kind in ("batch_instance", "batch_instance_noaffine"):
        raise NotImplementedError(f"Norm2d({kind!r}) is not ported yet: it is {NORM_SWAP_ITEM}")
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
    dropout rng."""

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
        if key not in self._masks and self._given is not None:
            if tuple(self._given.shape) != shape:
                raise ValueError(f"{type(self).__name__} {self.name!r}: given mask of shape "
                                 f"{tuple(self._given.shape)}, expected {shape}")
            self._masks[key] = self._given.to(device=device, dtype=torch.bool)
        if key not in self._masks:
            if self._seed is None:
                raise RuntimeError(f"{type(self).__name__} {self.name!r}: train and frozen "
                                   "modes need a step's seed (dropout_step)")
            gen = torch.Generator(device=device)
            gen.manual_seed((self._seed + 1_000_003 * zlib.crc32(self.name.encode()))
                            % 2 ** 63)
            self._masks[key] = torch.rand(shape, generator=gen, device=device) < 1.0 - self.rate
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
    With ``num_domains`` > 1 every norm is domain-specific and conv1 is a
    :class:`TorchSNConv3x3`: the reference's domain-specific block
    spectral-norms conv1 in both of its branches."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch",
                 dropout: Optional[float] = None, num_domains: int = 1):
        super().__init__()
        self.down = conv3x3(in_ch, in_ch, stride=2)
        self.conv1 = TorchSNConv3x3(in_ch, out_ch) if num_domains > 1 else conv3x3(in_ch, out_ch)
        self.norm1 = make_norm(norm, out_ch, num_domains)
        self.conv2 = conv3x3(out_ch, out_ch)
        self.norm2 = make_norm(norm, out_ch, num_domains)
        self.conv_input = conv1x1(in_ch, out_ch)
        self.dropout = FixableDropout(dropout) if dropout is not None else None

    def forward(self, x: torch.Tensor, mode: str, domain_id: int = 0) -> torch.Tensor:
        x = self.down(x)
        h = self.conv1(x, mode) if isinstance(self.conv1, TorchSNConv3x3) else self.conv1(x)
        h = lrelu(apply_norm(self.norm1, h, mode, domain_id))
        h = apply_norm(self.norm2, self.conv2(h), mode, domain_id)
        res = lrelu(self.conv_input(x) + h)
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
