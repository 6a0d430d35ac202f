"""VGG16 perceptual loss (a library loss, NCHW).

Counterpart of ``maxstyle_tpu/ops/perceptual.py``, the reference's
custom_loss.VGGPerceptualLoss:692-738, which its trainer imports and never
uses. The VGG16 trunk's weights load from a local file: a ``.npz`` of the
JAX package's layout (:func:`load_vgg_params`) or a torchvision state dict
(:func:`convert_vgg16_torchvision`); nothing is fetched. Without weights
the trunk is initialised from a seeded ``torch.Generator`` (flax's default
init: truncated-normal LeCun kernels, zero biases); the JAX package inits
from ``jax.random.key(0)``, which torch cannot reproduce, so the two
random-feature losses differ. Callers that need ImageNet features pass
weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maxstyle_tpu_torch.ops import advchain

# VGG16 conv plan: (out_channels, n_convs) a block
_VGG16_PLAN = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
# ``layers`` uses the reference's 1-based block numbers; the reference builds
# blocks 1..4 only (features[:23], through conv4_3 and its relu)
_DEFAULT_LAYERS = (1, 2, 3, 4)
# torchvision vgg16().features indices of the Conv2d layers, a block
_TORCHVISION_CONV_IDX = [(0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28)]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
INPUT_HW = (224, 224)


def _trunc_lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init from ``generator``: a normal truncated at
    two standard deviations, scaled to variance 1 / fan_in (drawn by the
    inverse CDF)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))  # the CDF at +2, and 1 - hi at -2
    u = torch.rand(w.shape, generator=generator) * (2.0 * hi - 1.0) + (1.0 - hi)
    with torch.no_grad():
        w.copy_(torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0) * std)


class VGG16Features(nn.Module):
    """The conv trunk, blocks 1..``n_blocks``: 3x3 convs ``block{i}_conv{j}``
    (padding 1) with ReLUs, 2x2 max pooling between blocks; ``forward``
    returns each block's last activation, before its pooling. ``seed`` sets
    the weights a trunk has until a state dict is loaded."""

    def __init__(self, n_blocks: int = 4, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.plan = list(_VGG16_PLAN[:n_blocks])
        cin = 3
        for bi, (ch, n_convs) in enumerate(self.plan):
            for ci in range(n_convs):
                conv = nn.Conv2d(cin, ch, 3, padding=1)
                _trunc_lecun_normal_(conv.weight, cin * 9, gen)
                nn.init.zeros_(conv.bias)
                self.add_module(f"block{bi + 1}_conv{ci + 1}", conv)
                cin = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for bi, (_, n_convs) in enumerate(self.plan):
            if bi > 0:
                x = F.max_pool2d(x, 2, 2)
            for ci in range(n_convs):
                x = F.relu(getattr(self, f"block{bi + 1}_conv{ci + 1}")(x))
            feats.append(x)
        return feats


def load_vgg_params(weights_path: str) -> Dict[str, torch.Tensor]:
    """A :class:`VGG16Features` state dict from an ``.npz`` of
    ``block{i}_conv{j}/kernel`` (HWIO) and ``.../bias`` arrays, the JAX
    package's layout."""
    data = np.load(weights_path)
    sd = {}
    for key in data.files:
        name, leaf = key.rsplit("/", 1)
        a = np.asarray(data[key], np.float32)
        if leaf == "kernel":
            sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
        elif leaf == "bias":
            sd[f"{name}.bias"] = torch.from_numpy(a)
        else:
            raise ValueError(f"unexpected VGG parameter {key}")
    return sd


def convert_vgg16_torchvision(sd) -> Dict[str, torch.Tensor]:
    """A torchvision vgg16 state dict (``features.{i}.weight``, OIHW) -> a
    :class:`VGG16Features` state dict. Partial dicts that cover blocks 1..4
    (the reference never builds block 5) are accepted."""
    out = {}
    for bi, conv_ids in enumerate(_TORCHVISION_CONV_IDX):
        for ci, fi in enumerate(conv_ids):
            key = f"features.{fi}.weight"
            if key not in sd:
                continue
            name = f"block{bi + 1}_conv{ci + 1}"
            out[f"{name}.weight"] = torch.as_tensor(np.asarray(sd[key]), dtype=torch.float32)
            out[f"{name}.bias"] = torch.as_tensor(np.asarray(sd[f"features.{fi}.bias"]),
                                                  dtype=torch.float32)
    return out


def _prep(x: torch.Tensor, resize_input: bool) -> torch.Tensor:
    """Gray images replicated to 3 channels, ImageNet-normalized, and
    resized to 224^2 as ``jax.image.resize(..., "linear")`` does:
    half-pixel centres, antialiased when it shrinks."""
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)[:, None, None]
    std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)[:, None, None]
    x = (x - mean) / std
    return advchain.resize(x, INPUT_HW, "bilinear") if resize_input else x


def vgg_perceptual_loss(pred: torch.Tensor, target: torch.Tensor,
                        state_dict: Optional[Dict[str, torch.Tensor]] = None,
                        weights_path: Optional[str] = None,
                        layers: Sequence[int] = _DEFAULT_LAYERS,
                        resize: bool = True) -> torch.Tensor:
    """The sum over ``layers`` (1-based blocks) of the mean L1 distance
    between the VGG features of pred and target ([N,1,H,W] or [N,3,H,W] in
    [0, 1]); the target is detached. Weights: ``state_dict``, else the file
    ``weights_path``, else a trunk initialised from seed 0."""
    pred = pred.float()
    model = VGG16Features(n_blocks=max(layers))
    if state_dict is None and weights_path is not None:
        state_dict = load_vgg_params(weights_path)
    if state_dict is not None:
        # blocks past max(layers) are not built, and their weights not read
        model.load_state_dict({k: state_dict[k] for k in model.state_dict()})
    model = model.to(pred.device)
    f_pred = model(_prep(pred, resize))
    f_tgt = model(_prep(target.detach().float(), resize))
    loss = 0.0
    for li in layers:
        loss = loss + torch.mean(torch.abs(f_pred[li - 1] - f_tgt[li - 1]))
    return loss
