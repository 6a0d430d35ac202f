"""UNETR (2D), the transformer-encoder family, as torch modules (NCHW).

Counterpart of ``maxstyle_tpu/models/unetr.py``: a ViT over 16x16 patches
(at the solver's width hidden 768, 12 layers, 12 heads, MLP 3072) whose
hidden states after blocks 4, 7 and 10 and whose final tokens (after the
trailing LayerNorm) are projected by transposed-conv stacks into a
five-level skip pyramid [f@1x, 2f@1/2, 4f@1/4, 8f@1/8, hidden@1/16], and a
transposed-conv + residual-conv decoder over it.

* :class:`SelfAttention` keeps the JAX package's head-major fused qkv: the
  output features of ``qkv`` are ordered (head, q/k/v, head_dim), so an
  even split of them keeps whole heads together (``parallel/tp.py``). The
  number of heads a forward computes is read from ``qkv``'s output width,
  so the same module runs a tensor-parallel shard of the heads.
* LayerNorms are flax's: eps 1e-6 (torch's default is 1e-5). GELU is the
  exact erf form. Attention is two matrix products and a softmax. Under a
  bf16 compute dtype the products, the softmax and the residual adds run in
  bf16 and the LayerNorms in float32, as the JAX package writes them.
* Dropout: the ViT's five element-wise sites (position embedding,
  attention weights, attention output, GELU output, MLP output) are
  :class:`layers.ElementDropout`s, present only with a rate, on in "train"
  and "frozen" and off in "eval", replayed within a step
  (``layers.dropout_step``) as the JAX step replays its one dropout key.
* The pyramid blocks' BatchNorms follow the port's three modes.

The encoder has style hooks 1-5 (hook 5 on the bottom level), the decoder
0-5 (5 after the output conv and its activation). Module names follow the
flax ones; ``UpCatBlock``'s flax-auto-named children ``ConvTranspose_0``
and ``ResConvBlock_0`` are ``up`` and ``conv`` (``convert.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maxstyle_tpu_torch.models import layers
from maxstyle_tpu_torch.models.encoder_decoder import StyleFns, _maybe_style
from maxstyle_tpu_torch.models.unet import CodeFilter
from maxstyle_tpu_torch.ops.intensity import instance_norm

LAYERNORM_EPS = 1e-6  # flax nn.LayerNorm's epsilon
PYRAMID_STRIDE = 16  # the token grid is img_size // 16 on a side


def _lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std)


def dense(in_features: int, out_features: int, bias: bool = True) -> layers.Linear:
    """A linear map with flax Dense's init (lecun normal, zero bias)."""
    lin = layers.Linear(in_features, out_features, bias=bias)
    _lecun_normal_(lin.weight, in_features)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def layer_norm(features: int) -> layers.LayerNorm:
    return layers.LayerNorm(features, eps=LAYERNORM_EPS)


def _dropout(rate: float) -> Optional[layers.ElementDropout]:
    return layers.ElementDropout(rate) if rate > 0.0 else None


def _drop(module: Optional[layers.ElementDropout], x: torch.Tensor, mode: str) -> torch.Tensor:
    return x if module is None else module(x, mode)


class SelfAttention(nn.Module):
    """MONAI SABlock semantics: fused qkv without bias, scaled dot-product
    attention with dropout on the weights, ``out_proj`` with bias and
    output dropout. ``qkv``'s output features are head-major."""

    def __init__(self, hidden_size: int = 768, num_heads: int = 12, dropout_rate: float = 0.0):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple of num_heads "
                             f"{num_heads}")
        self.head_dim = hidden_size // num_heads
        self.qkv = dense(hidden_size, 3 * hidden_size, bias=False)
        self.out_proj = dense(hidden_size, hidden_size)
        self.drop_weights = _dropout(dropout_rate)
        self.drop_out = _dropout(dropout_rate)

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        b, n, _ = x.shape
        d = self.head_dim
        qkv = self.qkv(x)
        heads = qkv.shape[-1] // (3 * d)  # a tensor-parallel rank holds a share of them
        q, k, v = qkv.reshape(b, n, heads, 3, d).permute(3, 0, 2, 1, 4).unbind(0)
        att = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5, dim=-1)
        att = _drop(self.drop_weights, att, mode)
        out = torch.matmul(att, v).transpose(1, 2).reshape(b, n, heads * d)
        return _drop(self.drop_out, self.out_proj(out), mode)


class TransformerBlock(nn.Module):
    """Pre-norm ViT block: x + attn(norm1(x)), then x + mlp(norm2(x)), the
    MLP linear1 -> GELU (erf) -> dropout -> linear2 -> dropout."""

    def __init__(self, hidden_size: int = 768, mlp_dim: int = 3072, num_heads: int = 12,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.norm1 = layer_norm(hidden_size)
        self.attn = SelfAttention(hidden_size, num_heads, dropout_rate)
        self.norm2 = layer_norm(hidden_size)
        self.linear1 = dense(hidden_size, mlp_dim)
        self.linear2 = dense(mlp_dim, hidden_size)
        self.drop1 = _dropout(dropout_rate)
        self.drop2 = _dropout(dropout_rate)

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), mode)
        h = _drop(self.drop1, F.gelu(self.linear1(self.norm2(x))), mode)
        return x + _drop(self.drop2, self.linear2(h), mode)


def check_square_crop(img_size: int, hw: Tuple[int, int]) -> None:
    """UNETR's token grid is (img_size // 16)^2 and its pyramid doubles it
    four times: it takes square crops of ``img_size``, a multiple of 16."""
    if img_size % PYRAMID_STRIDE or tuple(hw) != (img_size, img_size):
        raise ValueError(f"UNETR takes square crops whose side is a multiple of "
                         f"{PYRAMID_STRIDE} and equals its img_size {img_size}; got "
                         f"{tuple(hw)}")


class ViT(nn.Module):
    """Patch-conv embedding, learned position embedding and ``num_layers``
    blocks; ``forward(x, mode)`` returns the final tokens (after the
    trailing LayerNorm) and every block's output (before it)."""

    def __init__(self, in_ch: int = 1, img_size: int = 192, patch_size: int = 16,
                 hidden_size: int = 768, mlp_dim: int = 3072, num_layers: int = 12,
                 num_heads: int = 12, dropout_rate: float = 0.0):
        super().__init__()
        self.img_size, self.patch_size = img_size, patch_size
        self.patch_embed = layers.Conv2d(in_ch, hidden_size, patch_size, stride=patch_size)
        _lecun_normal_(self.patch_embed.weight, in_ch * patch_size * patch_size)
        nn.init.zeros_(self.patch_embed.bias)
        n_patch = (img_size // patch_size) ** 2
        self.pos_embedding = nn.Parameter(0.02 * torch.randn(1, n_patch, hidden_size))
        self.pos_drop = _dropout(dropout_rate)
        for i in range(num_layers):
            self.add_module(f"block{i}", TransformerBlock(hidden_size, mlp_dim, num_heads,
                                                          dropout_rate))
        self.num_layers = num_layers
        self.norm = layer_norm(hidden_size)

    def forward(self, x: torch.Tensor, mode: str) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # [b, tokens, hidden], row-major
        if x.shape[1] != self.pos_embedding.shape[1]:
            raise ValueError(f"ViT built for {self.img_size}^2 inputs "
                             f"({self.pos_embedding.shape[1]} tokens) got "
                             f"{x.shape[1]} tokens")
        x = _drop(self.pos_drop, x + self.pos_embedding.to(x.dtype), mode)
        hidden = []
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x, mode)
            hidden.append(x)
        return self.norm(x), hidden


class ResConvBlock(nn.Module):
    """UnetrBasicBlock: (conv3-norm-lrelu, conv3-norm) plus the input, by a
    1x1 ``skip`` conv when the channel counts differ, then lrelu."""

    def __init__(self, in_ch: int, out_ch: int, norm: str = "batch"):
        super().__init__()
        self.conv1 = layers.conv3x3(in_ch, out_ch)
        self.norm1 = layers.Norm2d(norm, out_ch)
        self.conv2 = layers.conv3x3(out_ch, out_ch)
        self.norm2 = layers.Norm2d(norm, out_ch)
        self.skip = layers.conv1x1(in_ch, out_ch) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        h = layers.lrelu(self.norm1(self.conv1(x), mode))
        h = self.norm2(self.conv2(h), mode)
        skip = self.skip(x) if self.skip is not None else x
        return layers.lrelu(skip + h)


class PrUpBlock(nn.Module):
    """UnetrPrUpBlock: a 2x2 stride-2 transposed conv ``up0``, then
    ``num_layer`` x [transposed conv ``up{i}``, ResConvBlock ``conv{i}``]."""

    def __init__(self, in_ch: int, out_ch: int, num_layer: int, norm: str = "batch"):
        super().__init__()
        self.up0 = layers.transposed_conv(out_ch, 2, 0, in_features=in_ch)
        for i in range(1, num_layer + 1):
            self.add_module(f"up{i}", layers.transposed_conv(out_ch, 2, 0))
            self.add_module(f"conv{i}", ResConvBlock(out_ch, out_ch, norm))
        self.num_layer = num_layer

    def forward(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        x = self.up0(x)
        for i in range(1, self.num_layer + 1):
            x = getattr(self, f"conv{i}")(getattr(self, f"up{i}")(x), mode)
        return x


class UpCatBlock(nn.Module):
    """UnetrUpBlock: a 2x2 stride-2 transposed conv ``up``, concat [up,
    skip], ResConvBlock ``conv``."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, norm: str = "batch"):
        super().__init__()
        self.up = layers.transposed_conv(out_ch, 2, 0, in_features=in_ch)
        self.conv = ResConvBlock(out_ch + skip_ch, out_ch, norm)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, mode: str) -> torch.Tensor:
        return self.conv(torch.cat([self.up(x), skip], dim=1), mode)


def unetr_pyramid_channels(feature_size: int, hidden_size: int) -> List[int]:
    f = feature_size
    return [f, 2 * f, 4 * f, 8 * f, hidden_size]


class UNETREncoder(nn.Module):
    """ViT trunk and projections -> [enc1, enc2, enc3, enc4, dec4]; with
    ``enable_code_filter`` a ``CodeFilter`` a level (``code_filters_{i}``).
    The ViT is the solver's (MLP 3072, 12 layers, 12 heads) unless
    ``vit_kwargs`` says otherwise."""

    def __init__(self, in_ch: int = 1, img_size: int = 192, feature_size: int = 16,
                 hidden_size: int = 768, norm: str = "batch", enable_code_filter: bool = False,
                 dropout_rate: float = 0.0, **vit_kwargs):
        super().__init__()
        check_square_crop(img_size, (img_size, img_size))
        self.img_size = img_size
        self.vit = ViT(in_ch, img_size=img_size, hidden_size=hidden_size,
                       dropout_rate=dropout_rate, **vit_kwargs)
        f = feature_size
        self.encoder1 = ResConvBlock(in_ch, f, norm)
        self.encoder2 = PrUpBlock(hidden_size, 2 * f, 2, norm)
        self.encoder3 = PrUpBlock(hidden_size, 4 * f, 1, norm)
        self.encoder4 = PrUpBlock(hidden_size, 8 * f, 0, norm)
        self.enable_code_filter = enable_code_filter
        if enable_code_filter:
            for i, c in enumerate(unetr_pyramid_channels(f, hidden_size)):
                self.add_module(f"code_filters_{i}", CodeFilter(c, c, norm))

    def _proj(self, tokens: torch.Tensor) -> torch.Tensor:
        b, n, c = tokens.shape
        g = self.img_size // PYRAMID_STRIDE
        return tokens.transpose(1, 2).reshape(b, c, g, g)

    def encode(self, x: torch.Tensor, mode: str, style_fns: StyleFns = None,
               domain_id: int = 0) -> List[torch.Tensor]:
        """The pyramid, from the hidden states after blocks 4, 7, 10 and the
        final tokens; hooks 1..4 after enc1..enc4, 5 on dec4."""
        check_square_crop(self.img_size, x.shape[2:])
        final, hidden = self.vit(x, mode)
        feats = [self.encoder1(x, mode),
                 self.encoder2(self._proj(hidden[3]), mode),
                 self.encoder3(self._proj(hidden[6]), mode),
                 self.encoder4(self._proj(hidden[9]), mode),
                 self._proj(final)]
        return [_maybe_style(z, style_fns, i + 1) for i, z in enumerate(feats)]

    def filter_code(self, z: Sequence[torch.Tensor], mode: str) -> List[torch.Tensor]:
        if not self.enable_code_filter:
            return list(z)
        return [getattr(self, f"code_filters_{i}")(zi, mode) for i, zi in enumerate(z)]

    def forward(self, x: torch.Tensor, mode: str, domain_id: int = 0):
        z = self.encode(x, mode)
        return z, self.filter_code(z, mode)


class UNETRDecoder(nn.Module):
    """Transposed-conv + residual-conv decoder over the UNETR pyramid, with
    style hooks 0 (dec4), 1..4 (after decoder5..decoder2) and 5 (after the
    output conv ``out`` and ``last_act``)."""

    def __init__(self, out_ch: int, feature_size: int = 16, hidden_size: int = 768,
                 norm: str = "batch", last_act: Optional[str] = None):
        super().__init__()
        p = unetr_pyramid_channels(feature_size, hidden_size)
        for i, name in enumerate(("decoder5", "decoder4", "decoder3", "decoder2")):
            self.add_module(name, UpCatBlock(p[4 - i], p[3 - i], p[3 - i], norm))
        self.out = layers.conv1x1(p[0], out_ch)
        if last_act not in ("sigmoid", "instance_norm", None):
            raise NotImplementedError(last_act)
        self.last_act = last_act

    def forward(self, features: Sequence[torch.Tensor], mode: str,
                style_fns: StyleFns = None) -> torch.Tensor:
        enc1, enc2, enc3, enc4, dec4 = features
        x = _maybe_style(dec4, style_fns, 0)
        for i, (name, skip) in enumerate((("decoder5", enc4), ("decoder4", enc3),
                                          ("decoder3", enc2), ("decoder2", enc1))):
            x = _maybe_style(getattr(self, name)(x, skip, mode), style_fns, i + 1)
        x = self.out(x)
        if self.last_act == "sigmoid":
            x = torch.sigmoid(x)
        elif self.last_act == "instance_norm":
            x = instance_norm(x)
        return _maybe_style(x, style_fns, 5)
