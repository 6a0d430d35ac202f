"""Swin-UNETR (2-D), the windowed-attention transformer family, as torch
modules (NCHW at the module boundary).

Swin UNETR (Hatamizadeh et al. 2022, arXiv:2201.01266) over a Swin
Transformer (Liu et al. 2021, arXiv:2103.14030), in the 2-D form of MONAI's
``SwinUNETR(spatial_dims=2)`` v1 at the paper's widths: patch 2, feature 48,
depths (2, 2, 2, 2), heads (3, 6, 12, 24), window 7, MLP ratio 4, ``qkv``
with a bias, LayerNorm (eps 1e-5), ``normalize`` on, ``downsample=
"merging"``. The JAX package has no counterpart: this family exists in the
port only.

The trunk (:class:`SwinTransformer`) keeps its tokens channels-last,
[B, H, W, C], from the patch embedding to the last merge, as MONAI writes
it:

* patch embedding: a 2x2 stride-2 convolution 1 -> 48 with a bias, no
  patch norm;
* four :class:`BasicLayer` stages of two :class:`SwinTransformerBlock` and
  a :class:`PatchMerging` each (stage k at 1/2^k of the crop);
* a block: ``x + attn(norm1(x))``, then ``x + mlp(norm2(x))``; the
  attention pads the normed tokens with zeros to whole windows (padded
  tokens are keys that no mask removes in unshifted windows, as in MONAI
  and the original Swin), rolls them by ``-window // 2`` in odd blocks,
  attends within each window and undoes the roll and the padding;
* MONAI's ``get_window_size``: a grid no larger than the window takes the
  grid's size as its window, and no shift;
* :class:`WindowAttention`: ``qkv`` laid out (3, heads, head_dim), so a
  MONAI state dict maps one to one; ``q * head_dim ** -0.5 @ k^T``, plus
  the learned relative-position bias (a (2w - 1)^2 x heads table gathered
  by a fixed index), plus the shift mask (-100.0 between regions, MONAI's
  ``compute_mask``), softmax, ``@ v``, ``proj``. Where a window shrinks to
  a grid of n < w^2 tokens the bias is MONAI's too: the leading n x n block
  of the w x w window's index;
* MLP: Linear -> exact GELU -> Linear; drop, attention-drop and drop-path
  rates 0 (MONAI's defaults);
* :class:`PatchMerging`: the four 2x2 phases concatenated in the order
  [0::2, 0::2], [1::2, 0::2], [0::2, 1::2], [1::2, 1::2] (rows, columns),
  LayerNorm(4C), Linear 4C -> 2C without a bias;
* the five outputs (the patch embedding, each stage after its merge) pass
  the parameter-free LayerNorm ``proj_out``.

The relative-position index and each stage's shift mask are buffers, built
once for the crop the encoder is made for and moved with the module; they
are not in the state dict. Crops are square, their side a multiple of 32
(four merges after a stride-2 patch) and equal to that size; any other
raises.

:class:`SwinUNETREncoder` gives the skip pyramid [encoder1 (the input,
crop x 48), encoder2-4 (1/2 x 48, 1/4 x 96, 1/8 x 192), the trunk's 1/16
level (384 channels), encoder10 (1/32 x 768)]; :class:`SwinUNETRDecoder`
runs ``decoder5`` ... ``decoder1`` over it, the last at full resolution and
48 channels, and a 1x1 head.

Departures from MONAI, each for the MaxStyle solver:

* the conv blocks are the port's UNETR blocks (``unetr.ResConvBlock`` and
  ``unetr.UpCatBlock``): they normalise with ``layers.BatchNorm`` and its
  three modes (MONAI: InstanceNorm), because MaxStyle freezes BatchNorm in
  its inner loop; their convolutions have biases, their leaky ReLU slope is
  0.2 and the 1x1 skip of ``ResConvBlock`` has no norm;
* the triplet's image decoder (``registry.build_modules``) is MaxStyle's
  FCN decoder over the 1/16 level, not a part of Swin-UNETR.

Style hooks, placed as UNETR's: the encoder's 1-4 after encoder1-4, 5 on
the 1/16 level and 6 on the bottom (encoder10); the decoder's 0 on the
bottom, 1-4 after decoder4 ... decoder1 (1/8 to full resolution, as the
FCN and UNETR decoders' 1-4), none after decoder5, and 5 after the head.

Spans (``utils/profiling.span``, forward only): ``swin/stage{k}`` around
each stage, its merge included, and ``swin/window_attention`` around each
block's attention from the padding to the crop.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maxstyle_tpu_torch.models import layers
from maxstyle_tpu_torch.models.encoder_decoder import StyleFns, _maybe_style
from maxstyle_tpu_torch.models.unetr import ResConvBlock, UpCatBlock, dense
from maxstyle_tpu_torch.utils.profiling import span

LAYERNORM_EPS = 1e-5  # torch's and MONAI's nn.LayerNorm
PATCH = 2
CROP_MULTIPLE = 32  # a stride-2 patch, then four merges
MASK_VALUE = -100.0  # MONAI's compute_mask

FEATURE_SIZE = 48
DEPTHS = (2, 2, 2, 2)
HEADS = (3, 6, 12, 24)
WINDOW = 7
MLP_RATIO = 4


def check_square_crop(img_size: int, hw: Tuple[int, int]) -> None:
    """Swin-UNETR halves its grid five times: it takes square crops whose
    side is a multiple of 32 and equals the size it was built for."""
    if img_size % CROP_MULTIPLE or tuple(hw) != (img_size, img_size):
        raise ValueError(f"SwinUNETR takes square crops whose side is a multiple of "
                         f"{CROP_MULTIPLE} and equals its img_size {img_size}; got "
                         f"{tuple(hw)}")


def window_and_shift(grid: int, window: int, shift: int) -> Tuple[int, int]:
    """MONAI's ``get_window_size`` on a square grid: a grid no larger than
    the window is one window, unshifted."""
    return (grid, 0) if grid <= window else (window, shift)


def relative_position_index(window: int) -> torch.Tensor:
    """[w^2, w^2] indices into the (2w - 1)^2 bias table: the table's row of
    each (query, key) pair of a w x w window, by their offset."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * (H/ws) * (W/ws), ws * ws, C], windows row-major."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, b: int, h: int, w: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`."""
    x = windows.view(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def shift_mask(padded: int, ws: int, shift: int) -> torch.Tensor:
    """MONAI's ``compute_mask`` on a square padded grid: [windows, ws^2,
    ws^2], 0 between tokens of one region of the rolled grid, -100 else."""
    img = torch.zeros((1, padded, padded, 1))
    cuts = (slice(-ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in cuts:
        for wsl in cuts:
            img[:, hs, wsl, :] = cnt
            cnt += 1
    win = window_partition(img, ws).squeeze(-1)
    diff = win.unsqueeze(1) - win.unsqueeze(2)
    return torch.where(diff != 0, MASK_VALUE, 0.0)


def _layer_norm(features: int) -> layers.LayerNorm:
    return layers.LayerNorm(features, eps=LAYERNORM_EPS)


def proj_out(x: torch.Tensor) -> torch.Tensor:
    """MONAI's ``proj_out(normalize=True)``: a LayerNorm over the channels
    without parameters, of channels-last tokens, computed in float32 under a
    half-precision compute dtype."""
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    return F.layer_norm(xf, (x.shape[-1],), eps=LAYERNORM_EPS).to(x.dtype)


class WindowAttention(nn.Module):
    """Multi-head self-attention within windows of at most ``WINDOW`` x
    ``WINDOW`` tokens, with MONAI's relative-position bias."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * WINDOW - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("relative_position_index", relative_position_index(WINDOW),
                             persistent=False)
        self.qkv = dense(dim, 3 * dim)
        self.proj = dense(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x [B * nW, n, C] (nW windows a slice); mask [nW, n, n] or None."""
        bw, n, c = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(bw, n, 3, h, c // h).permute(2, 0, 3, 1, 4).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        idx = self.relative_position_index[:n, :n].reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(n, n, h).permute(2, 0, 1)
        bias = bias.to(attn.dtype)
        if mask is None:
            attn = attn + bias
        else:
            nw = mask.shape[0]
            # bias and mask summed first: one pass over the scores
            attn = (attn.view(bw // nw, nw, h, n, n)
                    + (bias.unsqueeze(0) + mask.to(attn.dtype).unsqueeze(1))).view(bw, h, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class Mlp(nn.Module):
    """MONAI's MLPBlock: linear1 -> GELU (erf) -> linear2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = dense(dim, hidden)
        self.linear2 = dense(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.gelu(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    """``x + attn(norm1(x))``, then ``x + mlp(norm2(x))`` on [B, H, W, C]
    tokens of a ``grid`` x ``grid`` stage. Its attention's bias table is
    built for ``WINDOW`` and it runs the window and shift that the grid
    takes (``window_and_shift``; a shifted block's shift is
    ``WINDOW // 2``)."""

    def __init__(self, dim: int, num_heads: int, grid: int, shifted: bool):
        super().__init__()
        self.window, self.shift = window_and_shift(grid, WINDOW, WINDOW // 2 if shifted else 0)
        self.norm1 = _layer_norm(dim)
        self.attn = WindowAttention(dim, num_heads)
        self.norm2 = _layer_norm(dim)
        self.mlp = Mlp(dim, dim * MLP_RATIO)

    def _attention(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, s = self.window, self.shift
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        if s:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
        out = self.attn(window_partition(x, ws), mask if s else None)
        x = window_reverse(out, ws, b, hp, wp)
        if s:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :h, :w, :].contiguous()
        return x

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        y = self.norm1(x)
        with span("swin/window_attention"):
            y = self._attention(y, mask)
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """MONAI's 2-D PatchMerging: the 2x2 phases concatenated, LayerNorm(4C),
    Linear 4C -> 2C without a bias; [B, H, W, C] -> [B, H/2, W/2, 2C]."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = _layer_norm(4 * dim)
        self.reduction = dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % 2 or x.shape[2] % 2:
            x = F.pad(x, (0, 0, 0, x.shape[2] % 2, 0, x.shape[1] % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """One stage on a ``grid`` x ``grid`` token grid: ``depth`` blocks,
    every second one shifted, then the merge. Its shift mask is a buffer
    built for that grid."""

    def __init__(self, dim: int, depth: int, num_heads: int, grid: int):
        super().__init__()
        ws, shift = window_and_shift(grid, WINDOW, WINDOW // 2)
        self.blocks = nn.ModuleList(SwinTransformerBlock(dim, num_heads, grid, i % 2 == 1)
                                    for i in range(depth))
        self.downsample = PatchMerging(dim)
        padded = -(-grid // ws) * ws
        self.register_buffer("attn_mask", shift_mask(padded, ws, shift) if shift else None,
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, self.attn_mask)
        return self.downsample(x)


class SwinTransformer(nn.Module):
    """MONAI's SwinTransformer v1 in 2-D (``swinViT``): the patch embedding
    and four stages; ``forward`` returns the five ``proj_out`` outputs,
    NCHW views of channels-last tensors."""

    def __init__(self, in_ch: int = 1, img_size: int = 192, embed_dim: int = FEATURE_SIZE):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = layers.Conv2d(in_ch, embed_dim, PATCH, stride=PATCH)
        grid = img_size // PATCH
        self.num_layers = len(DEPTHS)
        for i, (depth, heads) in enumerate(zip(DEPTHS, HEADS)):
            self.add_module(f"layers{i + 1}", nn.ModuleList(
                [BasicLayer(embed_dim * 2 ** i, depth, heads, grid >> i)]))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        t = self.patch_embed.proj(x).permute(0, 2, 3, 1).contiguous()
        outs = [proj_out(t)]
        for i in range(1, self.num_layers + 1):
            with span(f"swin/stage{i}"):
                t = getattr(self, f"layers{i}")[0](t)
            outs.append(proj_out(t))
        return [o.permute(0, 3, 1, 2) for o in outs]


def swin_pyramid_channels(feature_size: int) -> List[int]:
    """Channels of the pyramid levels, full resolution to 1/32."""
    f = feature_size
    return [f, f, 2 * f, 4 * f, 8 * f, 16 * f]


class SwinUNETREncoder(nn.Module):
    """The Swin trunk and the pyramid's conv blocks -> [encoder1, encoder2,
    encoder3, encoder4, the trunk's 1/16 level, encoder10]."""

    def __init__(self, in_ch: int = 1, img_size: int = 192, feature_size: int = FEATURE_SIZE):
        super().__init__()
        check_square_crop(img_size, (img_size, img_size))
        self.img_size = img_size
        f = feature_size
        self.swinViT = SwinTransformer(in_ch, img_size, f)
        self.encoder1 = ResConvBlock(in_ch, f)
        self.encoder2 = ResConvBlock(f, f)
        self.encoder3 = ResConvBlock(2 * f, 2 * f)
        self.encoder4 = ResConvBlock(4 * f, 4 * f)
        self.encoder10 = ResConvBlock(16 * f, 16 * f)

    def encode(self, x: torch.Tensor, mode: str, style_fns: StyleFns = None,
               domain_id: int = 0) -> List[torch.Tensor]:
        """The pyramid; hook i + 1 after level i."""
        check_square_crop(self.img_size, x.shape[2:])
        hidden = self.swinViT(x)
        feats = [self.encoder1(x, mode),
                 self.encoder2(hidden[0], mode),
                 self.encoder3(hidden[1], mode),
                 self.encoder4(hidden[2], mode),
                 hidden[3],
                 self.encoder10(hidden[4], mode)]
        return [_maybe_style(z, style_fns, i + 1) for i, z in enumerate(feats)]

    def forward(self, x: torch.Tensor, mode: str, domain_id: int = 0):
        z = self.encode(x, mode)
        return z, z


class SwinUNETRDecoder(nn.Module):
    """``decoder5`` ... ``decoder1`` (a 2x2 transposed conv, the skip
    concatenated, a ResConvBlock) over the pyramid and the 1x1 head ``out``;
    style hooks 0 (the bottom), 1-4 (after decoder4 ... decoder1) and 5
    (after the head)."""

    def __init__(self, out_ch: int, feature_size: int = FEATURE_SIZE):
        super().__init__()
        p = swin_pyramid_channels(feature_size)
        for i, name in enumerate(("decoder5", "decoder4", "decoder3", "decoder2", "decoder1")):
            self.add_module(name, UpCatBlock(p[5 - i], p[4 - i], p[4 - i]))
        self.out = layers.conv1x1(p[0], out_ch)

    def forward(self, features: Sequence[torch.Tensor], mode: str,
                style_fns: StyleFns = None) -> torch.Tensor:
        enc0, enc1, enc2, enc3, hid3, dec4 = features
        x = self.decoder5(_maybe_style(dec4, style_fns, 0), hid3, mode)
        for i, (name, skip) in enumerate((("decoder4", enc3), ("decoder3", enc2),
                                          ("decoder2", enc1), ("decoder1", enc0))):
            x = _maybe_style(getattr(self, name)(x, skip, mode), style_fns, i + 1)
        return _maybe_style(self.out(x), style_fns, 5)


def build_swin_unetr_modules(spec, image_ch: int = 1, num_classes: int = 4,
                             decoder_dropout: Optional[float] = None,
                             image_size: int = 192) -> nn.ModuleDict:
    """The ``SwinUNETR`` bundle: the encoder and decoder at the paper's
    widths over ``image_size``^2 crops, and the FCN image decoder over the
    1/16 level (384 channels)."""
    from maxstyle_tpu_torch.models.encoder_decoder import Decoder

    modules = nn.ModuleDict()
    modules["image_encoder"] = SwinUNETREncoder(image_ch, img_size=image_size)
    modules["segmentation_decoder"] = SwinUNETRDecoder(num_classes)
    if spec.has_image_recon:
        modules["image_decoder"] = Decoder(
            swin_pyramid_channels(FEATURE_SIZE)[4], image_ch, spec.feature_reduce,
            up_type="Conv2", dropout=decoder_dropout, last_act=spec.image_decoder_last_act)
    return modules
