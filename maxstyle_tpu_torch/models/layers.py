"""Building blocks of the FCN model family as torch modules (NCHW).

Counterpart of the main-path part of ``maxstyle_tpu/models/layers.py``, with
the JAX package's initialisation (which is the reference's effective one):

* conv weights Kaiming-normal, fan in, gain sqrt(2); biases zero (torch's
  own default bias init differs);
* transposed-conv weights N(0, 0.02), bias zero;
* BatchNorm scale N(1, 0.02), bias 0, eps 1e-5, momentum 0.1.

BatchNorm mode protocol. Every module's ``forward`` takes ``mode``:

* ``"train"`` — batch statistics (biased variance) normalize; the running
  mean and the running unbiased variance are updated with momentum 0.1;
* ``"frozen"`` — batch statistics normalize and nothing is written;
* ``"eval"`` — the running statistics normalize.

Module and parameter names follow the flax names of the JAX package, so
``convert.py`` maps one onto the other by path.
"""

from __future__ import annotations

from typing import Optional

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


def conv3x3(in_ch: int, out_ch: int, bias: bool = True, stride: int = 1) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, bias=bias)
    _kaiming_fan_in_(conv.weight)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


def conv1x1(in_ch: int, out_ch: int, bias: bool = True) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, 1, bias=bias)
    _kaiming_fan_in_(conv.weight)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class BatchNorm(nn.Module):
    """BatchNorm2d with torch running-stat semantics and an explicit mode."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(1.0 + 0.02 * torch.randn(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        if mode == "train":
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, True, self.momentum, self.eps)
        if mode == "frozen":
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if mode == "eval":
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        raise ValueError(f"BatchNorm mode must be one of {MODES}, got {mode!r}")


def Norm2d(kind: str, features: int) -> BatchNorm:
    """Norm selector; the ported path uses only ``"batch"``."""
    if kind != "batch":
        raise NotImplementedError(f"Norm2d({kind!r}) is not ported yet")
    return BatchNorm(features)


def upsample2x(x: torch.Tensor, method: str = "NN") -> torch.Tensor:
    if method not in ("NN", "nearest"):
        raise NotImplementedError(f"upsample2x({method!r}) is not ported yet")
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsampler(nn.Module):
    """Front of an up block: nearest-neighbour x2, or a learned 2x2 stride-2
    transposed conv ("Conv2") with N(0, 0.02) weights."""

    def __init__(self, up_type: str = "NN", features: Optional[int] = None):
        super().__init__()
        self.up_type = up_type
        if up_type == "Conv2":
            self.conv = nn.ConvTranspose2d(features, features, 2, stride=2)
            with torch.no_grad():
                self.conv.weight.normal_(0.0, 0.02)
                self.conv.bias.zero_()
        elif up_type != "NN":
            raise NotImplementedError(f"Upsampler({up_type!r}) is not ported yet")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up_type == "Conv2":
            return self.conv(x)
        return upsample2x(x, "NN")


class FixableDropout(nn.Module):
    """Channel-wise (2D) dropout, on in "train" and "frozen" modes. No
    shipped config enables it. It draws from torch's global generator; the
    reference's replay of one mask across the standard and hard-example
    passes is not ported yet."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        if self.rate == 0.0 or mode == "eval":
            return x
        n, c = x.shape[:2]
        keep = torch.rand((n, c, 1, 1), device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class ResConvDown(nn.Module):
    """Strided-conv residual down block: down-conv(s2) ->
    [conv3-norm-lrelu-conv3-norm] + 1x1(skip) -> lrelu -> optional dropout."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch",
                 dropout: Optional[float] = None):
        super().__init__()
        self.down = conv3x3(in_ch, in_ch, stride=2)
        self.conv1 = conv3x3(in_ch, out_ch)
        self.norm1 = Norm2d(norm, out_ch)
        self.conv2 = conv3x3(out_ch, out_ch)
        self.norm2 = Norm2d(norm, out_ch)
        self.conv_input = conv1x1(in_ch, out_ch)
        self.dropout = FixableDropout(dropout) if dropout is not None else None

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        x = self.down(x)
        h = lrelu(self.norm1(self.conv1(x), mode))
        h = self.norm2(self.conv2(h), mode)
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
    trailing lrelu)."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch"):
        super().__init__()
        self.conv1 = conv3x3(in_ch, out_ch)
        self.norm1 = Norm2d(norm, out_ch)
        self.conv2 = conv3x3(out_ch, out_ch)
        self.norm2 = Norm2d(norm, out_ch)

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        x = lrelu(self.norm1(self.conv1(x), mode))
        return self.norm2(self.conv2(x), mode)
