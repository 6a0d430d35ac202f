"""Plain baseline segmentation networks as torch modules (NCHW).

Counterpart of ``maxstyle_tpu/models/baselines.py``, the networks of the
baseline ``SegmentationModel`` zoo besides :class:`models.unet.UNet`:

* :class:`FCN` — the Bai-style multi-scale FCN: a VGG-like trunk (64, 128,
  256, 512, 512 ÷ feature_scale), five lateral heads bilinearly upsampled
  x1..x16 (align_corners), concatenated, two 1x1 aggregations and a 1x1
  classifier ``outS``. Its conv-BN-ReLU units keep the flax auto-names
  ``ConvBNRelu_{i}`` ({``Conv_0``, ``Norm2d_0``}), numbered in flax's
  construction order: the first line builds the outer unit (0) before the
  inner one (1), so ``ConvBNRelu_1`` runs first.
* :class:`ResConvUNet` — a residual UNet with strided-conv downs
  (``layers.ResConvDown``), 2x2 transposed-conv ups (:class:`ResConvUp`) and
  an optional bottleneck self-attention.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from maxstyle_tpu_torch.models import layers


class ConvBNRelu(nn.Module):
    """conv (kernel 3 or 1, same padding, optional stride) -> BatchNorm ->
    ReLU."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, kernel: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2)
        layers._kaiming_fan_in_(self.Conv_0.weight)
        nn.init.zeros_(self.Conv_0.bias)
        self.Norm2d_0 = layers.BatchNorm(out_ch)

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        return torch.relu(self.Norm2d_0(self.Conv_0(x), mode))


def _upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Bilinear x``factor`` with align_corners=True; the JAX package's two
    interpolation matmuls agree to rounding."""
    return F.interpolate(x, size=(x.shape[2] * factor, x.shape[3] * factor), mode="bilinear",
                         align_corners=True)


# (in, out, stride, kernel) of ConvBNRelu_{i} as functions of the channel plan f
def _fcn_units(in_ch, f):
    return [(f[0], f[0], 1, 3), (in_ch, f[0], 1, 3),            # 0: conv1_2, 1: conv1_1
            (f[0], f[1], 2, 3), (f[1], f[1], 1, 3),             # conv2_1, conv2_2
            (f[1], f[2], 2, 3), (f[2], f[2], 1, 3), (f[2], f[2], 1, 3),
            (f[2], f[3], 2, 3), (f[3], f[3], 1, 3), (f[3], f[3], 1, 3),
            (f[3], f[4], 2, 3), (f[4], f[4], 1, 3), (f[4], f[4], 1, 3),
            (f[0], f[0], 1, 3), (f[1], f[0], 1, 3), (f[2], f[0], 1, 3),  # level heads 1-3
            (f[3], f[0], 1, 3), (f[4], f[0], 1, 3),                     # level heads 4-5
            (5 * f[0], 64, 1, 1), (64, 64, 1, 1)]                       # aggregation


class FCN(nn.Module):
    def __init__(self, num_classes: int = 4, feature_scale: int = 1,
                 dropout: Optional[float] = None, in_ch: int = 1):
        super().__init__()
        fs = feature_scale
        f = [64 // fs, 128 // fs, 256 // fs, 512 // fs, 512 // fs]
        for i, (cin, cout, stride, kernel) in enumerate(_fcn_units(in_ch, f)):
            self.add_module(f"ConvBNRelu_{i}", ConvBNRelu(cin, cout, stride, kernel))
        self.outS = layers.conv1x1(64, num_classes)
        self.dropout = dropout
        if dropout is not None:
            self.FixableDropout_0 = layers.FixableDropout(dropout)
            self.FixableDropout_1 = layers.FixableDropout(dropout)

    def _unit(self, i: int, x: torch.Tensor, mode: str) -> torch.Tensor:
        return getattr(self, f"ConvBNRelu_{i}")(x, mode)

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        u = self._unit
        l1 = u(0, u(1, x, mode), mode)
        l2 = u(3, u(2, l1, mode), mode)
        l3 = u(6, u(5, u(4, l2, mode), mode), mode)
        l4 = u(9, u(8, u(7, l3, mode), mode), mode)
        l5 = u(12, u(11, u(10, l4, mode), mode), mode)
        heads = [u(13, l1, mode)] + [_upsample(u(13 + i, lv, mode), 2 ** i)
                                     for i, lv in enumerate((l2, l3, l4, l5), 1)]
        agg = u(18, torch.cat(heads, dim=1), mode)
        if self.dropout is not None:
            agg = self.FixableDropout_0(agg, mode)
        agg = u(19, agg, mode)
        if self.dropout is not None:
            agg = self.FixableDropout_1(agg, mode)
        return self.outS(agg)


class ResConv(nn.Module):
    """Stride-1 residual double conv: [conv3-norm-lrelu-conv3-norm] +
    1x1(skip) -> lrelu -> optional dropout."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch",
                 dropout: Optional[float] = None):
        super().__init__()
        self.conv1 = layers.conv3x3(in_ch, out_ch)
        self.norm1 = layers.Norm2d(norm, out_ch)
        self.conv2 = layers.conv3x3(out_ch, out_ch)
        self.norm2 = layers.Norm2d(norm, out_ch)
        self.conv_input = layers.conv1x1(in_ch, out_ch)
        self.dropout = layers.FixableDropout(dropout) if dropout is not None else None

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        h = layers.lrelu(self.norm1(self.conv1(x), mode))
        h = self.norm2(self.conv2(h), mode)
        res = layers.lrelu(self.conv_input(x) + h)
        if self.dropout is not None:
            res = self.dropout(res, mode)
        return res


class ResConvUp(nn.Module):
    """2x2 stride-2 transposed conv ``up`` + concat [skip, up] + ResConv
    (``ResConv_0``, its flax auto-name)."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, norm: str = "batch",
                 dropout: Optional[float] = None):
        super().__init__()
        self.up = layers.transposed_conv(in_ch, 2, 0)
        self.ResConv_0 = ResConv(skip_ch + in_ch, out_ch, norm, dropout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, mode: str) -> torch.Tensor:
        return self.ResConv_0(torch.cat([skip, self.up(x)], dim=1), mode)


class ResConvUNet(nn.Module):
    def __init__(self, num_classes: int = 4, feature_scale: int = 1, norm: str = "batch",
                 encoder_dropout: Optional[float] = None,
                 decoder_dropout: Optional[float] = None, self_attention: bool = False,
                 in_ch: int = 1):
        super().__init__()
        fs = feature_scale
        c = [64 // fs, 128 // fs, 256 // fs, 512 // fs, 512 // fs]
        self.inc = ResConv(in_ch, c[0], norm, encoder_dropout)
        for i in range(1, 5):
            self.add_module(f"down{i}", layers.ResConvDown(c[i - 1], c[i], norm,
                                                           encoder_dropout))
        self.self_attn = layers.SelfAttention2d(c[4]) if self_attention else None
        outs = [256 // fs, 128 // fs, 64 // fs, 64 // fs]
        below = [c[4]] + outs[:3]
        for i in range(4):
            self.add_module(f"up{i + 1}", ResConvUp(below[i], c[3 - i], outs[i], norm,
                                                    decoder_dropout))
        self.outc = layers.conv1x1(outs[3], num_classes)

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        feats = [self.inc(x, mode)]
        for i in range(1, 5):
            feats.append(getattr(self, f"down{i}")(feats[-1], mode))
        h = feats[4]
        if self.self_attn is not None:
            h = self.self_attn(h)
        for i in range(4):
            h = getattr(self, f"up{i + 1}")(h, feats[3 - i], mode)
        return self.outc(h)
