"""SwinUNETR_16_no_STN: Swin UNETR (Hatamizadeh et al. 2022,
arXiv:2201.01266) in the 2-D form of MONAI's ``SwinUNETR(spatial_dims=2)``
v1 at the paper's widths (patch 2, feature 48, depths 2-2-2-2, heads
3-6-12-24, window 7, MLP ratio 4, qkv with a bias, LayerNorm eps 1e-5,
exact GELU, ``proj_out`` normalisation on), with the program's BatchNorm
conv blocks (``nets.res_block``) for its encoders and up blocks, and the
FCN image decoder over the trunk's 1/16 level (384 channels).

A block's attention goes window by window, as MONAI computes it: pad the
normed tokens with zeros to whole windows, roll by -3 in every second
block, partition, attend with the relative-position bias (a 13^2 x heads
table gathered by the offsets of a 7 x 7 window; where a stage's grid is
no larger than 7 its window is the grid, unshifted, and the bias is the
leading block of the 7 x 7 window's index) and, in shifted windows,
MONAI's mask (-100 between the rolled grid's regions), reverse, roll back,
crop. The shapes are the program's state-dict names'."""

from typing import List

import torch
import torch.nn.functional as F

from perfbench.reference.nets import conv, conv_t2, fcn_decode, linear, res_block

FEAT, DEPTHS, HEADS, WINDOW, MLP_RATIO, PATCH = 48, (2, 2, 2, 2), (3, 6, 12, 24), 7, 4, 2
LN_EPS = 1e-5
MASK = -100.0


def layer_norm(P, name, x):
    c = x.shape[-1]
    return F.layer_norm(x, (c,), P.take(f"{name}.weight", (c,), "one"),
                        P.take(f"{name}.bias", (c,), "zero"), LN_EPS)


def partition(x, ws):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def reverse(win, ws, b, h, w):
    x = win.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def bias_index(n, device):
    """The leading n x n block of the 7 x 7 window's relative-position
    index."""
    r = torch.arange(WINDOW * WINDOW, device=device)
    ry, rx = r // WINDOW, r % WINDOW
    idx = (ry[:, None] - ry[None, :] + WINDOW - 1) * (2 * WINDOW - 1) + rx[:, None] - rx[None, :]
    return (idx + WINDOW - 1)[:n, :n]


def shift_mask(gp, ws, shift, device):
    """[windows, ws^2, ws^2]: 0 within a region of the rolled grid, -100
    across regions."""
    img = torch.zeros((1, gp, gp, 1), device=device)
    cuts = (slice(-ws), slice(-ws, -shift), slice(-shift, None))
    for i, hs in enumerate(cuts):
        for j, wsl in enumerate(cuts):
            img[:, hs, wsl, :] = 3 * i + j
    win = partition(img, ws).squeeze(-1)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, MASK, 0.0)


def attention(P, q, x, heads, ws, shift):
    """One block's window attention on normed [B, g, g, C] tokens."""
    b, g, _, c = x.shape
    gp = -(-g // ws) * ws
    x = F.pad(x, (0, 0, 0, gp - g, 0, gp - g))
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    win = partition(x, ws)
    bw, n, _ = win.shape
    d = c // heads
    qkv = linear(P, f"{q}.qkv", win, 3 * c).reshape(bw, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    att = (qkv[0] * d ** -0.5) @ qkv[1].transpose(-2, -1)
    table = P.take(f"{q}.relative_position_bias_table", ((2 * WINDOW - 1) ** 2, heads), "pos")
    att = att + table[bias_index(n, x.device).reshape(-1)].reshape(n, n, heads).permute(2, 0, 1)
    if shift:
        mask = shift_mask(gp, ws, shift, x.device).to(att.dtype)
        nw = mask.shape[0]
        att = (att.reshape(bw // nw, nw, heads, n, n) + mask[None, :, None]).reshape(bw, heads,
                                                                                  n, n)
    out = (torch.softmax(att, dim=-1) @ qkv[2]).transpose(1, 2).reshape(bw, n, c)
    x = reverse(linear(P, f"{q}.proj", out, c), ws, b, gp, gp)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    return x[:, :g, :g]


def block(P, q, x, heads, shifted):
    g, c = x.shape[1], x.shape[-1]
    ws, shift = (g, 0) if g <= WINDOW else (WINDOW, WINDOW // 2 if shifted else 0)
    x = x + attention(P, f"{q}.attn", layer_norm(P, f"{q}.norm1", x), heads, ws, shift)
    h = F.gelu(linear(P, f"{q}.mlp.linear1", layer_norm(P, f"{q}.norm2", x), MLP_RATIO * c))
    return x + linear(P, f"{q}.mlp.linear2", h, c)


def merge(P, q, x):
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    return linear(P, f"{q}.reduction", layer_norm(P, f"{q}.norm", x), x.shape[-1] // 2,
                  bias=False)


def normed(t):
    """``proj_out``: a LayerNorm over the channels without parameters, NCHW."""
    return F.layer_norm(t, (t.shape[-1],), eps=LN_EPS).permute(0, 3, 1, 2)


def trunk(P, x) -> List[torch.Tensor]:
    p = "image_encoder.swinViT"
    t = conv(P, f"{p}.patch_embed.proj", x, FEAT, PATCH, stride=PATCH).permute(0, 2, 3, 1)
    outs = [normed(t)]
    for i, (depth, heads) in enumerate(zip(DEPTHS, HEADS)):
        q = f"{p}.layers{i + 1}.0"
        for j in range(depth):
            t = block(P, f"{q}.blocks.{j}", t, heads, j % 2 == 1)
        t = merge(P, f"{q}.downsample", t)
        outs.append(normed(t))
    return outs


def encode(P, x):
    h = trunk(P, x)
    p = "image_encoder"
    levels = [res_block(P, f"{p}.encoder1", x, FEAT),
              res_block(P, f"{p}.encoder2", h[0], FEAT),
              res_block(P, f"{p}.encoder3", h[1], 2 * FEAT),
              res_block(P, f"{p}.encoder4", h[2], 4 * FEAT),
              h[3],
              res_block(P, f"{p}.encoder10", h[4], 16 * FEAT)]
    return levels[4], levels


def segment(P, feats, num_classes):
    enc0, enc1, enc2, enc3, hid3, x = feats
    p = "segmentation_decoder"
    for name, skip in (("decoder5", hid3), ("decoder4", enc3), ("decoder3", enc2),
                       ("decoder2", enc1), ("decoder1", enc0)):
        up = conv_t2(P, f"{p}.{name}.up", x, skip.shape[1])
        x = res_block(P, f"{p}.{name}.conv", torch.cat([up, skip], 1), skip.shape[1])
    return conv(P, f"{p}.out", x, num_classes, 1)


def decode_image(P, z_i, **kw):
    return fcn_decode(P, "image_decoder", z_i, 1, True, True, **kw)
