"""A plain reference of the port's ``SwinUNETR_16_no_STN`` triplet: the
Swin-UNETR encoder and decoder (MONAI's ``SwinUNETR(spatial_dims=2)`` v1 with
the port's BatchNorm conv blocks) and the FCN image decoder over the 1/16
level, as functions of a flat table of tensors under the port's state-dict
names ("image_encoder.swinViT.layers1.0.blocks.0.attn.qkv.weight", ...).

Plain ``torch`` in whatever dtype the tensors have; it imports nothing of
either package. BatchNorm uses the batch's statistics (the "train" and
"frozen" modes).

The attention of a block is computed without partitioning the grid into
windows: one dense attention over the whole padded and rolled grid, in
which a query sees only the keys of its own window (a key of another window
has weight 0), a key of its window in another shift region has -100 added
to its score, as MONAI's mask does, and the relative-position bias is
gathered from the two tokens' coordinates. The bias table belongs to the
configured window W; where a stage's grid is smaller than W, its window
shrinks to the grid and MONAI takes the leading n x n block of the W x W
window's index, which reads a token's flat place in its window p as the
place (p // W, p % W) of a W-wide window: the same is done here.

Dense attention costs (grid^2)^2 a head: CPU sizes only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
BN_EPS = 1e-5
LRELU = 0.2
MASK = -100.0

Table = Dict[str, torch.Tensor]


def conv(P: Table, name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    w = P[f"{name}.weight"]
    k = w.shape[-1]
    return F.conv2d(x, w, P.get(f"{name}.bias"), stride=stride, padding=1 if k == 3 else 0)


def conv_t2(P: Table, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.conv_transpose2d(x, P[f"{name}.weight"], P[f"{name}.bias"], stride=2)


def batch_norm(P: Table, name: str, x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    return (x - mean) / torch.sqrt(var + BN_EPS) * w[:, None, None] + b[:, None, None]


def layer_norm(x: torch.Tensor, w=None, b=None) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + LN_EPS)
    return y if w is None else y * w + b


def ln(P: Table, name: str, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, P[f"{name}.weight"], P[f"{name}.bias"])


def linear(P: Table, name: str, x: torch.Tensor) -> torch.Tensor:
    out = x @ P[f"{name}.weight"].t()
    b = P.get(f"{name}.bias")
    return out if b is None else out + b


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, LRELU * x)


def res_block(P: Table, name: str, x: torch.Tensor) -> torch.Tensor:
    h = lrelu(batch_norm(P, f"{name}.norm1", conv(P, f"{name}.conv1", x)))
    h = batch_norm(P, f"{name}.norm2", conv(P, f"{name}.conv2", h))
    skip = conv(P, f"{name}.skip", x) if f"{name}.skip.weight" in P else x
    return lrelu(skip + h)


def up_cat(P: Table, name: str, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    return res_block(P, f"{name}.conv", torch.cat([conv_t2(P, f"{name}.up", x), skip], 1))


# ---------------------------------------------------------------------------
# the Swin trunk
# ---------------------------------------------------------------------------


def _regions(n: int, ws: int, shift: int) -> torch.Tensor:
    """Each row (or column) of a rolled padded side of ``n``: its shift
    region 0, 1 or 2, as MONAI's mask cuts the side at n - ws and n - shift."""
    i = torch.arange(n)
    return (i >= n - ws).long() + (i >= n - shift).long()


def dense_window_attention(P: Table, name: str, x: torch.Tensor, heads: int, window: int,
                           ws: int, shift: int) -> torch.Tensor:
    """One block's attention on normed [B, g, g, C] tokens, as one dense
    attention over the padded, rolled grid."""
    b, g, _, c = x.shape
    gp = -(-g // ws) * ws
    x = F.pad(x, (0, 0, 0, gp - g, 0, gp - g))
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    n = gp * gp
    d = c // heads
    qkv = linear(P, f"{name}.qkv", x.reshape(b, n, c)).reshape(b, n, 3, heads, d)
    q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
    scores = (q * d ** -0.5) @ k.transpose(-1, -2)  # [b, heads, n, n]

    r = torch.arange(gp).repeat_interleave(gp)  # a token's row and column in the grid
    col = torch.arange(gp).repeat(gp)
    same_window = ((r[:, None] // ws == r[None, :] // ws)
                   & (col[:, None] // ws == col[None, :] // ws))
    place = (r % ws) * ws + col % ws  # the token's flat place in its window
    pr, pc = place // window, place % window
    idx = ((pr[:, None] - pr[None, :] + window - 1) * (2 * window - 1)
           + pc[:, None] - pc[None, :] + window - 1)
    bias = P[f"{name}.relative_position_bias_table"][idx].permute(2, 0, 1)  # [heads, n, n]
    scores = scores + bias
    if shift:
        region = _regions(gp, ws, shift)[r] * 3 + _regions(gp, ws, shift)[col]
        scores = scores + torch.where(region[:, None] == region[None, :], 0.0, MASK).to(
            scores.dtype)
    scores = scores.masked_fill(~same_window, -math.inf)
    out = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, n, c)
    out = linear(P, f"{name}.proj", out).reshape(b, gp, gp, c)
    if shift:
        out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
    return out[:, :g, :g]


def swin_block(P: Table, name: str, x: torch.Tensor, heads: int, window: int,
               shifted: bool) -> torch.Tensor:
    g = x.shape[1]
    ws, shift = (g, 0) if g <= window else (window, window // 2 if shifted else 0)
    x = x + dense_window_attention(P, f"{name}.attn", ln(P, f"{name}.norm1", x), heads,
                                   window, ws, shift)
    h = F.gelu(linear(P, f"{name}.mlp.linear1", ln(P, f"{name}.norm2", x)))
    return x + linear(P, f"{name}.mlp.linear2", h)


def merge(P: Table, name: str, x: torch.Tensor) -> torch.Tensor:
    parts = [x[:, i::2, j::2] for j in (0, 1) for i in (0, 1)]  # rows fastest
    return linear(P, f"{name}.reduction", ln(P, f"{name}.norm", torch.cat(parts, -1)))


def swin(P: Table, x: torch.Tensor, depths: Sequence[int], heads: Sequence[int],
         window: int) -> List[torch.Tensor]:
    """The trunk's five normalised outputs, NCHW."""
    p = "image_encoder.swinViT"
    t = conv(P, f"{p}.patch_embed.proj", x, stride=2).permute(0, 2, 3, 1)
    outs = [layer_norm(t)]
    for i, (depth, h) in enumerate(zip(depths, heads)):
        q = f"{p}.layers{i + 1}.0"
        for j in range(depth):
            t = swin_block(P, f"{q}.blocks.{j}", t, h, window, j % 2 == 1)
        t = merge(P, f"{q}.downsample", t)
        outs.append(layer_norm(t))
    return [o.permute(0, 3, 1, 2) for o in outs]


# ---------------------------------------------------------------------------
# the triplet
# ---------------------------------------------------------------------------


def encode(P: Table, x: torch.Tensor, depths=(2, 2, 2, 2), heads=(3, 6, 12, 24),
           window: int = 7) -> List[torch.Tensor]:
    """The pyramid: encoder1-4, the trunk's 1/16 level, encoder10."""
    h = swin(P, x, depths, heads, window)
    p = "image_encoder"
    return [res_block(P, f"{p}.encoder1", x), res_block(P, f"{p}.encoder2", h[0]),
            res_block(P, f"{p}.encoder3", h[1]), res_block(P, f"{p}.encoder4", h[2]),
            h[3], res_block(P, f"{p}.encoder10", h[4])]


def segment(P: Table, z: Sequence[torch.Tensor]) -> torch.Tensor:
    enc0, enc1, enc2, enc3, hid3, dec4 = z
    p = "segmentation_decoder"
    x = up_cat(P, f"{p}.decoder5", dec4, hid3)
    for name, skip in (("decoder4", enc3), ("decoder3", enc2), ("decoder2", enc1),
                       ("decoder1", enc0)):
        x = up_cat(P, f"{p}.{name}", x, skip)
    return conv(P, f"{p}.out", x)


def decode_image(P: Table, z_i: torch.Tensor) -> torch.Tensor:
    """The FCN image decoder: four up blocks (a 2x2 transposed conv, two
    conv-BN stages, a 1x1 residual), a 1x1 head and a sigmoid."""
    p = "image_decoder"
    x = z_i
    for i in range(1, 5):
        q = f"{p}.up{i}"
        x = conv_t2(P, f"{q}.up.conv", x)
        h = lrelu(batch_norm(P, f"{q}.norm1", conv(P, f"{q}.conv1", x)))
        h = batch_norm(P, f"{q}.norm2", conv(P, f"{q}.conv2", h))
        x = lrelu(conv(P, f"{q}.conv_input", x) + h)
    return torch.sigmoid(conv(P, f"{p}.final_conv", x))


def forward(P: Table, x: torch.Tensor, **widths) -> Tuple[torch.Tensor, torch.Tensor]:
    """(segmentation logits, reconstruction) of the triplet's standard
    pass."""
    z = encode(P, x, **widths)
    return segment(P, z), decode_image(P, z[4])
