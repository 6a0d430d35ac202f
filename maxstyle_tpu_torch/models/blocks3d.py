"""3D building blocks (NCDHW), a library surface no shipped config reaches.

Counterpart of ``maxstyle_tpu/models/blocks3d.py`` (unet_parts.UnetConv3 /
UnetUp3 :657-715 and custom_layers.Fixable3DDropout :39-67), with its
initialisation: 3x3x3 conv weights Kaiming-normal (fan in), biases zero;
the 2x2x2 transposed conv N(0, 0.02); BatchNorm as ``layers.BatchNorm``
(scale N(1, 0.02), the "train"/"frozen"/"eval" protocol). Module names are
the flax ones, so ``convert.py`` maps the JAX package's weights by path.
"""

from __future__ import annotations

import torch
from torch import nn

from maxstyle_tpu_torch.models import layers


class FixableDropout3d(layers.FixableDropout):
    """Channel-wise 3D dropout under ``layers.FixableDropout``'s step
    protocol: one keep-mask [N,C,1,1,1] a layer a step, drawn from the
    step's seed and the layer's name (or injected), replayed in every pass;
    off in "eval"."""

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        if self.rate == 0.0 or mode == "eval":
            return x
        keep = self._step_mask((x.shape[0], x.shape[1], 1, 1, 1), x.device)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def _conv3(in_ch: int, out_ch: int) -> nn.Conv3d:
    conv = nn.Conv3d(in_ch, out_ch, 3, padding=1)
    fan_in = in_ch * 27
    with torch.no_grad():
        conv.weight.normal_(0.0, (2.0 / fan_in) ** 0.5)
        conv.bias.zero_()
    return conv


class UnetConv3(nn.Module):
    """(conv3x3x3 -> norm -> relu) x2; ``norm`` "batch" or "none"."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch"):
        super().__init__()
        if norm not in ("batch", "none"):
            raise ValueError(norm)
        self.conv1 = _conv3(in_ch, out_ch)
        self.conv2 = _conv3(out_ch, out_ch)
        if norm == "batch":
            self.norm1, self.norm2 = layers.BatchNorm(out_ch), layers.BatchNorm(out_ch)
        else:
            self.norm1 = self.norm2 = None

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        for conv, norm in ((self.conv1, self.norm1), (self.conv2, self.norm2)):
            x = conv(x)
            if norm is not None:
                x = norm(x, mode)
            x = torch.relu(x)
        return x


class UnetUp3(nn.Module):
    """2x2x2 transposed conv (stride 2) of x, concatenated after the skip,
    then :class:`UnetConv3` to ``out_ch``."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, norm: str = "batch"):
        super().__init__()
        self.up = nn.ConvTranspose3d(in_ch, out_ch, 2, stride=2)
        with torch.no_grad():
            self.up.weight.normal_(0.0, 0.02)
            self.up.bias.zero_()
        self.UnetConv3_0 = UnetConv3(skip_ch + out_ch, out_ch, norm)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, mode: str) -> torch.Tensor:
        return self.UnetConv3_0(torch.cat([skip, self.up(x)], dim=1), mode)

