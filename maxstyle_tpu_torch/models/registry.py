"""network_type string grammar -> module bundle.

Counterpart of ``maxstyle_tpu/models/registry.py``. The whole grammar of the
reference solver's ``get_network``
(advanced_triplet_recon_segmentation_model.py:125-266) is parsed:

  FCN_{16|64}[_standard][_no_STN][_no_im_recon][_w_image|_w_recon_image|
      _w_dual_image][_w_o_filter][_share_code][_NN_decoder]
      [_z_score|_identity]
  DS_FCN_16_standard                      (dual-domain BN)
  Unet… / UnetTransformer…
  SwinUNETR_16_no_STN                     (the port's own family)

``16`` -> feature_reduce 4, ``64`` -> feature_reduce 1. :func:`build_modules`
builds every bundle of the grammar: the FCN family (with or without the
STN, DS_FCN's domain-specific encoder), the Unet family and UNETR
(``models/unet.py``, ``models/unetr.py``), and Swin-UNETR
(``models/swin_unetr.py``), which the JAX package does not have. A
``SwinUNETR`` type is recognised by its prefix, not by the "16" it holds:
its Swin widths are fixed by the name, "16" gives the FCN image decoder its
feature_reduce 4, and only the ``_no_STN`` form without code filters is
built (the others raise ``NotImplementedError``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from maxstyle_tpu_torch.models.encoder_decoder import Decoder, DualBranchEncoder, Encoder
from maxstyle_tpu_torch.models.layers import set_compute_dtype


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """Parsed network_type with everything the solver needs."""

    network_type: str
    feature_reduce: int
    has_stn: bool
    has_image_recon: bool
    share_code: bool
    no_filter: bool
    num_domains: int
    image_decoder_up: str
    image_decoder_last_act: Optional[str]
    shape_input_mode: Optional[str]  # None | 'seg_only' | 'w_image' | 'w_recon_image' | 'w_dual_image'
    is_unet: bool
    unet_code_filter: bool = False
    is_transformer: bool = False

    @property
    def latent_ch(self) -> int:
        return 512 // self.feature_reduce

    @property
    def is_swin_unetr(self) -> bool:
        """A Swin-UNETR type. A property of the name and not a field, so that
        the fields stay the JAX package's spec's."""
        return self.network_type.startswith(SWIN_UNETR_PREFIX)


SWIN_UNETR_PREFIX = "SwinUNETR"
# the parts of the grammar a Swin-UNETR type may not hold
_SWIN_UNSUPPORTED = ("enable_code_filter", "share_code", "w_o_filter", "Unet_im_recon")


def _check_swin_unetr(nt: str) -> None:
    if not nt.startswith(SWIN_UNETR_PREFIX + "_16"):
        raise NotImplementedError(f"{nt}: the SwinUNETR family is built as "
                                  f"SwinUNETR_16_no_STN (feature_reduce 4) only")
    if "no_STN" not in nt:
        raise NotImplementedError(f"{nt}: the SwinUNETR family has no STN variant; "
                                  "use SwinUNETR_16_no_STN")
    bad = [part for part in _SWIN_UNSUPPORTED if part in nt]
    if bad:
        raise NotImplementedError(f"{nt}: the SwinUNETR family has no {bad[0]} variant")


def parse_network_type(network_type: str, intensity_norm_type: str = "min_max") -> NetworkSpec:
    nt = network_type
    if nt.startswith(SWIN_UNETR_PREFIX):
        _check_swin_unetr(nt)
    if "16" in nt:
        reduce = 4
    elif "64" in nt:
        reduce = 1
    else:
        raise ValueError(f"network_type must contain 16 or 64: {nt}")

    if intensity_norm_type == "min_max":
        last_act: Optional[str] = "sigmoid"
    elif intensity_norm_type == "z_score":
        last_act = "instance_norm"
    else:
        raise NotImplementedError(intensity_norm_type)
    if "z_score" in nt:
        last_act = "instance_norm"
    elif "identity" in nt:
        last_act = None

    has_stn = "no_STN" not in nt
    shape_mode: Optional[str] = None
    if has_stn:
        if "w_dual_image" in nt:
            shape_mode = "w_dual_image"
        elif "w_recon_image" in nt:
            shape_mode = "w_recon_image"
        elif "w_image" in nt:
            shape_mode = "w_image"
        else:
            shape_mode = "seg_only"

    return NetworkSpec(
        network_type=nt,
        feature_reduce=reduce,
        has_stn=has_stn,
        has_image_recon="no_im_recon" not in nt,
        share_code="share_code" in nt,
        no_filter="w_o_filter" in nt,
        num_domains=2 if nt.startswith("DS_") else 1,
        image_decoder_up="NN" if "NN_decoder" in nt else "Conv2",
        image_decoder_last_act=last_act,
        shape_input_mode=shape_mode,
        is_unet=nt.startswith("Unet"),
        unet_code_filter="enable_code_filter" in nt,
        is_transformer="UnetTransformer" in nt,
    )


def shape_input_channels(spec: NetworkSpec, image_ch: int, num_classes: int) -> int:
    """Channels of the STN's input: the segmentation, plus one image
    ("w_image", "w_recon_image") or two ("w_dual_image")."""
    if spec.shape_input_mode in ("w_image", "w_recon_image"):
        return num_classes + image_ch
    if spec.shape_input_mode == "w_dual_image":
        return num_classes + 2 * image_ch
    return num_classes


def build_modules(spec: NetworkSpec, image_ch: int = 1, num_classes: int = 4,
                  encoder_dropout: Optional[float] = None,
                  decoder_dropout: Optional[float] = None,
                  image_size: int = 192, dtype: Optional[torch.dtype] = None
                  ) -> nn.ModuleDict:
    """The module bundle {image_encoder, segmentation_decoder,
    [image_decoder], [shape_encoder, shape_decoder]} of a spec;
    ``image_size`` is the side of the square crops UNETR's ViT and the Swin
    trunk's masks are built for.
    ``dtype`` is every module's compute dtype (``layers.set_compute_dtype``;
    None computes in float32); parameters and running statistics stay
    float32."""
    r = spec.feature_reduce
    latent = 512 // r
    if spec.is_swin_unetr:
        from maxstyle_tpu_torch.models.swin_unetr import build_swin_unetr_modules
        if encoder_dropout:
            raise NotImplementedError(f"{spec.network_type}: the Swin trunk runs MONAI's "
                                      "drop rates of 0; encoder_dropout is not built")
        modules = build_swin_unetr_modules(spec, image_ch=image_ch, num_classes=num_classes,
                                           decoder_dropout=decoder_dropout,
                                           image_size=image_size)
    elif spec.is_unet:
        from maxstyle_tpu_torch.models.unet import build_unet_modules
        modules = build_unet_modules(spec, image_ch=image_ch, num_classes=num_classes,
                                     encoder_dropout=encoder_dropout,
                                     decoder_dropout=decoder_dropout,
                                     image_size=image_size)
    else:
        modules = nn.ModuleDict()
        modules["image_encoder"] = DualBranchEncoder(
            image_ch, z_level_1_ch=latent, z_level_2_ch=latent, feature_reduce=r,
            norm="batch", dropout=encoder_dropout, num_domains=spec.num_domains)
        modules["segmentation_decoder"] = Decoder(
            latent, out_ch=num_classes, feature_reduce=r, up_type="NN", norm="batch",
            dropout=decoder_dropout, last_act=None)
        if spec.has_image_recon:
            modules["image_decoder"] = Decoder(
                latent, out_ch=image_ch, feature_reduce=r, up_type=spec.image_decoder_up,
                norm="batch", dropout=decoder_dropout,
                last_act=spec.image_decoder_last_act)
    if spec.has_stn:
        modules["shape_encoder"] = Encoder(
            shape_input_channels(spec, image_ch, num_classes), latent, feature_reduce=r,
            norm="batch", dropout=encoder_dropout, act="relu")
        modules["shape_decoder"] = Decoder(
            latent, out_ch=num_classes, feature_reduce=r, up_type="NN", norm="batch",
            dropout=decoder_dropout, last_act=None)
    return set_compute_dtype(modules, dtype)
