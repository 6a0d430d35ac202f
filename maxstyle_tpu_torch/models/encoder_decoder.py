"""Dual-branch encoder / decoder model family as torch modules (NCHW).

Counterpart of ``maxstyle_tpu/models/encoder_decoder.py``:

* :class:`Encoder` — five-stage strided-conv encoder, output stride 16;
* :class:`CodeDecoupler` — the z_i -> z_s filter;
* :class:`DualBranchEncoder` — encoder plus decoupler, with ``encode`` and
  ``filter_code``;
* :class:`Decoder` — four residual up stages with the MaxStyle hooks.

Style hook indices of the decoder: 0 = input code, 1..4 = after up1..up4,
5 = after the final 1x1 conv and its activation. For feature_reduce=4 the
hook channels are [128, 64, 32, 16, 16, out_ch].
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from maxstyle_tpu_torch.models import layers
from maxstyle_tpu_torch.ops.intensity import instance_norm

StyleFns = Optional[Dict[int, Callable[[torch.Tensor], torch.Tensor]]]


def _maybe_style(x: torch.Tensor, style_fns: StyleFns, idx: int) -> torch.Tensor:
    if style_fns is not None and idx in style_fns:
        return style_fns[idx](x)
    return x


class Encoder(nn.Module):
    """Channel plan 64,128,256,512,512 (÷ feature_reduce), then 1x1 to
    ``out_ch`` + norm + activation. With ``num_domains`` > 1 (DS_FCN) every
    norm, the final one included, is a :class:`layers.DomainSpecificNorm2d`
    picked by ``domain_id``. ``if_sn`` spectral-norms every conv of the down
    blocks (``layers.SpectralNormConv2d``)."""

    def __init__(self, in_ch: int, out_ch: int, feature_reduce: int = 1,
                 norm: str = "batch", dropout: Optional[float] = None,
                 act: Optional[str] = "relu", num_domains: int = 1, if_sn: bool = False):
        super().__init__()
        r = feature_reduce
        chans = [64 // r, 128 // r, 256 // r, 512 // r, 512 // r]
        self.inc = layers.InConv(in_ch, chans[0], norm, num_domains)
        for i in range(1, 5):
            self.add_module(f"down{i}", layers.ResConvDown(chans[i - 1], chans[i], norm,
                                                           dropout, num_domains, if_sn))
        self.final_conv = layers.conv1x1(chans[4], out_ch)
        self.final_norm = layers.make_norm(norm, out_ch, num_domains)
        if act not in ("relu", "sigmoid", None):
            raise NotImplementedError(act)
        self.act = act

    def forward(self, x: torch.Tensor, mode: str, style_fns: StyleFns = None,
                domain_id: int = 0) -> torch.Tensor:
        """``style_fns`` hooks: 1 = after the stem and its lrelu, 2..5 =
        after down1..4, 6 = after the final activation."""
        x = _maybe_style(layers.lrelu(self.inc(x, mode, domain_id)), style_fns, 1)
        for i, down in enumerate((self.down1, self.down2, self.down3, self.down4)):
            x = _maybe_style(down(x, mode, domain_id), style_fns, i + 2)
        z = layers.apply_norm(self.final_norm, self.final_conv(x), mode, domain_id)
        if self.act == "relu":
            z = torch.relu(z)
        elif self.act == "sigmoid":
            z = torch.sigmoid(z)
        return _maybe_style(z, style_fns, 6)


class CodeDecoupler(nn.Module):
    """conv3(no bias)-norm-lrelu-conv3(no bias)-norm-relu."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch"):
        super().__init__()
        self.conv1 = layers.conv3x3(in_ch, out_ch, bias=False)
        self.norm1 = layers.Norm2d(norm, out_ch)
        self.conv2 = layers.conv3x3(out_ch, out_ch, bias=False)
        self.norm2 = layers.Norm2d(norm, out_ch)

    def forward(self, z: torch.Tensor, mode: str) -> torch.Tensor:
        h = layers.lrelu(self.norm1(self.conv1(z), mode))
        return torch.relu(self.norm2(self.conv2(h), mode))


class DualBranchEncoder(nn.Module):
    """The general encoder (ReLU head) producing z, and the code decoupler
    producing z_s."""

    def __init__(self, in_ch: int, z_level_1_ch: int, z_level_2_ch: int,
                 feature_reduce: int = 1, norm: str = "batch",
                 dropout: Optional[float] = None, num_domains: int = 1, if_sn: bool = False):
        super().__init__()
        self.general_encoder = Encoder(in_ch, z_level_1_ch, feature_reduce, norm,
                                       dropout, act="relu", num_domains=num_domains,
                                       if_sn=if_sn)
        self.code_decoupler = CodeDecoupler(z_level_1_ch, z_level_2_ch, norm)

    def encode(self, x: torch.Tensor, mode: str, style_fns: StyleFns = None,
               domain_id: int = 0) -> torch.Tensor:
        return self.general_encoder(x, mode, style_fns, domain_id)

    def filter_code(self, z: torch.Tensor, mode: str) -> torch.Tensor:
        return self.code_decoupler(z, mode)

    def forward(self, x: torch.Tensor, mode: str, domain_id: int = 0):
        z = self.encode(x, mode, domain_id=domain_id)
        return z, self.filter_code(z, mode)


class Decoder(nn.Module):
    """Four residual up stages and a 1x1 head, with MaxStyle hook points.
    ``last_act``: "sigmoid", "instance_norm" or None."""

    def __init__(self, in_ch: int, out_ch: int, feature_reduce: int = 1,
                 up_type: str = "NN", norm: str = "batch",
                 dropout: Optional[float] = None, last_act: Optional[str] = None):
        super().__init__()
        r = feature_reduce
        chans = [in_ch, 256 // r, 128 // r, 64 // r, 64 // r]
        for i in range(1, 5):
            self.add_module(f"up{i}", layers.ResUp(chans[i - 1], chans[i], up_type,
                                                   norm, dropout))
        self.final_conv = layers.conv1x1(chans[4], out_ch)
        if last_act not in ("sigmoid", "instance_norm", None):
            raise NotImplementedError(last_act)
        self.last_act = last_act

    def _stage(self, i: int, v: torch.Tensor, mode: str) -> torch.Tensor:
        if i == 0:
            return v
        if i == 5:
            v = self.final_conv(v)
            if self.last_act == "sigmoid":
                v = torch.sigmoid(v)
            elif self.last_act == "instance_norm":
                v = instance_norm(v)
            return v
        return getattr(self, f"up{i}")(v, mode)

    def forward(self, x: torch.Tensor, mode: str, style_fns: StyleFns = None,
                start_at_hook: Optional[int] = None,
                stop_before_hook: Optional[int] = None) -> torch.Tensor:
        """Six (conv, hook) stages: stage 0 = (identity, hook 0), stages
        1-4 = (up_i, hook i), stage 5 = (final 1x1 + activation, hook 5).

        ``stop_before_hook=k`` runs stages 0..k-1 and stage k's conv and
        returns the activation before hook k; ``start_at_hook=k`` takes that
        activation, applies hook k and runs the rest. The MaxStyle inner
        loop uses the split to compute the style-free prefix once."""
        start = 0 if start_at_hook is None else start_at_hook
        for i in range(start, 6):
            if not (start_at_hook is not None and i == start):
                x = self._stage(i, x, mode)
            if stop_before_hook is not None and i == stop_before_hook:
                return x
            x = _maybe_style(x, style_fns, i)
        return x


def decoder_style_channels(feature_reduce: int, out_ch: int) -> list:
    """Per-hook channel counts of the decoder's MaxStyle hooks."""
    r = feature_reduce
    return [512 // r, 256 // r, 128 // r, 64 // r, 64 // r, out_ch]
