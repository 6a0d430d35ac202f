"""UNet model family as torch modules (NCHW).

Counterpart of ``maxstyle_tpu/models/unet.py``: the building blocks
(:class:`DoubleConv`, :class:`Down`, :class:`Up`, :class:`CodeFilter`), the
triplet solver's :class:`UnetEncoder` (the five-level skip pyramid
[x1..x5]) and :class:`UnetDecoder`, the monolithic :class:`UNet` of the
baseline solver, :class:`DeeplySupervisedUNet`, :class:`UNetv2`, and
:func:`build_unet_modules`, the Unet bundle of the network_type grammar
(UNETR's modules are in ``models/unetr.py``).

The decoder's style hooks follow the FCN decoder's protocol: 0 = the bottom
feature x5, 1..4 = after up1..up4, 5 = after the output conv and its
activation; the channels a hook coincide with
``encoder_decoder.decoder_style_channels``. Module names follow the flax
ones (the per-level code filters are ``code_filters_{i}``), so
``convert.py`` maps one onto the other by path.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from maxstyle_tpu_torch.models import layers
from maxstyle_tpu_torch.models.encoder_decoder import StyleFns, _maybe_style
from maxstyle_tpu_torch.ops.intensity import instance_norm

def _act(kind: str):
    return torch.relu if kind == "relu" else layers.lrelu


class DoubleConv(nn.Module):
    """(conv3 -> norm -> act) x2."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch", act: str = "relu"):
        super().__init__()
        self.conv1 = layers.conv3x3(in_ch, out_ch)
        self.norm1 = layers.Norm2d(norm, out_ch)
        self.conv2 = layers.conv3x3(out_ch, out_ch)
        self.norm2 = layers.Norm2d(norm, out_ch)
        self.act = _act(act)

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        x = self.act(self.norm1(self.conv1(x), mode))
        return self.act(self.norm2(self.conv2(x), mode))


class Down(nn.Module):
    """maxpool(2) + double conv + optional dropout."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch", act: str = "relu",
                 dropout: Optional[float] = None):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch, norm, act)
        self.dropout = layers.FixableDropout(dropout) if dropout is not None else None

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        x = self.conv(F.max_pool2d(x, 2), mode)
        if self.dropout is not None:
            x = self.dropout(x, mode)
        return x


class Up(nn.Module):
    """x2 upsample (bilinear with align_corners, nearest, or a 2x2 stride-2
    transposed conv ``up``), concat [skip, upsampled], optional dropout,
    double conv. ``in_ch`` counts the concatenated channels."""

    def __init__(self, in_ch: int, out_ch: int, up_ch: int, up_type: str = "bilinear",
                 norm: str = "batch", act: str = "relu", dropout: Optional[float] = None):
        super().__init__()
        if up_type == "Conv2":
            self.up = layers.transposed_conv(up_ch, 2, 0)
        elif up_type not in ("bilinear", "nearest", "NN"):
            raise ValueError(up_type)
        self.up_type = up_type
        self.dropout = layers.FixableDropout(dropout) if dropout is not None else None
        self.conv = DoubleConv(in_ch, out_ch, norm, act)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, mode: str) -> torch.Tensor:
        if self.up_type == "Conv2":
            x = self.up(x)
        else:
            x = layers.upsample2x(x, "bilinear" if self.up_type == "bilinear" else "NN")
        x = torch.cat([skip, x], dim=1)
        if self.dropout is not None:
            x = self.dropout(x, mode)
        return self.conv(x, mode)


class CodeFilter(nn.Module):
    """Per-level code decoupler: conv3(no bias)-norm-lrelu-conv3(no
    bias)-norm-relu, the dual-branch code decoupler's stack."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch"):
        super().__init__()
        self.conv1 = layers.conv3x3(in_ch, out_ch, bias=False)
        self.norm1 = layers.Norm2d(norm, out_ch)
        self.conv2 = layers.conv3x3(out_ch, out_ch, bias=False)
        self.norm2 = layers.Norm2d(norm, out_ch)

    def forward(self, z: torch.Tensor, mode: str) -> torch.Tensor:
        h = layers.lrelu(self.norm1(self.conv1(z), mode))
        return torch.relu(self.norm2(self.conv2(h), mode))


def _pyramid_channels(r: int) -> List[int]:
    return [64 // r, 128 // r, 256 // r, 512 // r, 512 // r]


class UnetEncoder(nn.Module):
    """The five-level skip pyramid [x1..x5] (x1 at full size, x5 at 1/16);
    ``filter_code`` applies the per-level code filters when
    ``enable_code_filter``, else returns the pyramid."""

    def __init__(self, in_ch: int, feature_reduce: int = 1, norm: str = "batch",
                 act: str = "relu", dropout: Optional[float] = None,
                 enable_code_filter: bool = False):
        super().__init__()
        chans = _pyramid_channels(feature_reduce)
        self.inc = DoubleConv(in_ch, chans[0], norm, act)
        for i in range(1, 5):
            self.add_module(f"down{i}", Down(chans[i - 1], chans[i], norm, act, dropout))
        self.enable_code_filter = enable_code_filter
        if enable_code_filter:
            for i, c in enumerate(chans):
                self.add_module(f"code_filters_{i}", CodeFilter(c, c, norm))

    def encode(self, x: torch.Tensor, mode: str, style_fns: StyleFns = None,
               domain_id: int = 0) -> List[torch.Tensor]:
        """Hooks for the MixStyle/DSU replay: 1 = after the stem, 2..5 =
        after down1..4 (6 is never reached)."""
        feats = [_maybe_style(self.inc(x, mode), style_fns, 1)]
        for i in range(1, 5):
            feats.append(_maybe_style(getattr(self, f"down{i}")(feats[-1], mode), style_fns,
                                      i + 1))
        return feats

    def filter_code(self, z: Sequence[torch.Tensor], mode: str) -> List[torch.Tensor]:
        if not self.enable_code_filter:
            return list(z)
        return [getattr(self, f"code_filters_{i}")(zi, mode) for i, zi in enumerate(z)]

    def forward(self, x: torch.Tensor, mode: str, domain_id: int = 0):
        z = self.encode(x, mode)
        return z, self.filter_code(z, mode)


class UnetDecoder(nn.Module):
    """Skip-connected decoder over the [x1..x5] pyramid with the MaxStyle
    hooks {0: bottom, 1..4: after the ups, 5: after the output conv}.
    ``last_act``: "sigmoid", "instance_norm" or None. ``pyramid`` gives the
    five levels' channels when they are not the UnetEncoder's (UNETR's)."""

    def __init__(self, out_ch: int, feature_reduce: int = 1, up_type: str = "bilinear",
                 norm: str = "batch", act: str = "relu", dropout: Optional[float] = None,
                 last_act: Optional[str] = None, pyramid: Optional[Sequence[int]] = None):
        super().__init__()
        p = list(pyramid) if pyramid is not None else _pyramid_channels(feature_reduce)
        outs = [256 // feature_reduce, 128 // feature_reduce, 64 // feature_reduce,
                64 // feature_reduce]
        below = [p[4]] + outs[:3]  # channels coming up into up1..up4
        for i in range(4):
            self.add_module(f"up{i + 1}", Up(p[3 - i] + below[i], outs[i], below[i], up_type,
                                             norm, act, dropout))
        self.outc = layers.conv1x1(outs[3], out_ch)
        if last_act not in ("sigmoid", "instance_norm", None):
            raise NotImplementedError(last_act)
        self.last_act = last_act

    def forward(self, features: Sequence[torch.Tensor], mode: str,
                style_fns: StyleFns = None) -> torch.Tensor:
        x1, x2, x3, x4, x5 = features
        x = _maybe_style(x5, style_fns, 0)
        for i, skip in enumerate((x4, x3, x2, x1)):
            x = _maybe_style(getattr(self, f"up{i + 1}")(x, skip, mode), style_fns, i + 1)
        x = self.outc(x)
        if self.last_act == "sigmoid":
            x = torch.sigmoid(x)
        elif self.last_act == "instance_norm":
            x = instance_norm(x)
        return _maybe_style(x, style_fns, 5)


class UNet(nn.Module):
    """Monolithic UNet, the baseline solver's network: ``encoder`` and
    ``decoder``."""

    def __init__(self, num_classes: int, feature_reduce: int = 1, norm: str = "batch",
                 dropout: Optional[float] = None, in_ch: int = 1):
        super().__init__()
        self.encoder = UnetEncoder(in_ch, feature_reduce, norm, dropout=dropout)
        self.decoder = UnetDecoder(num_classes, feature_reduce, norm=norm, dropout=dropout)

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        return self.decoder(self.encoder.encode(x, mode), mode)


class DeeplySupervisedUNet(nn.Module):
    """UNet with auxiliary 1x1 heads on up2 and up3, each resized to the
    input size; returns [aux_2, aux_3, final] logits."""

    def __init__(self, num_classes: int, feature_reduce: int = 1, norm: str = "batch",
                 in_ch: int = 1):
        super().__init__()
        r = feature_reduce
        p = _pyramid_channels(r)
        self.encoder = UnetEncoder(in_ch, r, norm)
        outs = [256 // r, 128 // r, 64 // r, 64 // r]
        below = [p[4]] + outs[:3]
        for i in range(4):
            self.add_module(f"up{i + 1}", Up(p[3 - i] + below[i], outs[i], below[i],
                                             "bilinear", norm))
        self.aux_head_2 = layers.conv1x1(outs[1], num_classes)
        self.aux_head_3 = layers.conv1x1(outs[2], num_classes)
        self.outc = layers.conv1x1(outs[3], num_classes)

    def forward(self, x: torch.Tensor, mode: str) -> List[torch.Tensor]:
        """The auxiliary logits are resized with half-pixel bilinear
        interpolation, jax.image.resize's "linear" (no antialiasing is
        needed: they are upsampled)."""
        x1, x2, x3, x4, x5 = self.encoder.encode(x, mode)
        u1 = self.up1(x5, x4, mode)
        u2 = self.up2(u1, x3, mode)
        u3 = self.up3(u2, x2, mode)
        u4 = self.up4(u3, x1, mode)

        def head(conv, feat):
            return F.interpolate(conv(feat), size=x.shape[2:], mode="bilinear",
                                 align_corners=False)

        return [head(self.aux_head_2, u2), head(self.aux_head_3, u3), self.outc(u4)]


class UNetv2(nn.Module):
    """UNet with 2x2 transposed-conv upsampling."""

    def __init__(self, num_classes: int, feature_reduce: int = 1, norm: str = "batch",
                 in_ch: int = 1):
        super().__init__()
        self.encoder = UnetEncoder(in_ch, feature_reduce, norm)
        self.decoder = UnetDecoder(num_classes, feature_reduce, up_type="Conv2", norm=norm)

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        return self.decoder(self.encoder.encode(x, mode), mode)


def build_unet_modules(spec, image_ch: int = 1, num_classes: int = 4,
                       encoder_dropout: Optional[float] = None,
                       decoder_dropout: Optional[float] = None,
                       image_size: int = 192) -> nn.ModuleDict:
    """The Unet bundle of a parsed spec: UnetEncoder and a UnetDecoder
    segmentation head, or for ``UnetTransformer`` types UNETR's encoder (a
    ViT-B/16 at hidden 768 over ``image_size``^2 crops, feature size 64 // r,
    ``encoder_dropout`` as the ViT's rate) and decoder. The image decoder is
    a UnetDecoder over the whole pyramid for ``Unet_im_recon`` types, else
    the FCN ``Decoder`` over the bottom level; both take the pyramid's
    channels (UNETR's bottom level has 768). ``registry.build_modules`` adds
    the STN's shape modules, as for the FCN family."""
    from maxstyle_tpu_torch.models.encoder_decoder import Decoder

    r = spec.feature_reduce
    act = "leaky_relu" if "leaky_relu" in spec.network_type else "relu"
    modules = nn.ModuleDict()
    if spec.is_transformer:
        from maxstyle_tpu_torch.models.unetr import (UNETRDecoder, UNETREncoder,
                                                     unetr_pyramid_channels)
        f, hidden = 64 // r, 768
        pyramid = unetr_pyramid_channels(f, hidden)
        modules["image_encoder"] = UNETREncoder(
            image_ch, img_size=image_size, feature_size=f, hidden_size=hidden,
            enable_code_filter=spec.unet_code_filter, dropout_rate=encoder_dropout or 0.0)
        modules["segmentation_decoder"] = UNETRDecoder(num_classes, f, hidden)
    else:
        pyramid = _pyramid_channels(r)
        modules["image_encoder"] = UnetEncoder(image_ch, r, act=act, dropout=encoder_dropout,
                                               enable_code_filter=spec.unet_code_filter)
        modules["segmentation_decoder"] = UnetDecoder(num_classes, r, act=act,
                                                      dropout=decoder_dropout, last_act=None)
    if spec.has_image_recon:
        if "Unet_im_recon" in spec.network_type:
            modules["image_decoder"] = UnetDecoder(
                image_ch, r, up_type="Conv2", act=act, dropout=decoder_dropout,
                last_act=spec.image_decoder_last_act, pyramid=pyramid)
        else:
            modules["image_decoder"] = Decoder(
                pyramid[-1], image_ch, r, up_type="Conv2", dropout=decoder_dropout,
                last_act=spec.image_decoder_last_act)
    return modules
