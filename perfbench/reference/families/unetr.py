"""UnetTransformer_16_no_STN: UNETR (Hatamizadeh et al., WACV 2022) over a
ViT-B/16 (hidden 768, 12 layers, 12 heads, MLP 3072, LayerNorm eps 1e-6,
exact GELU, fused qkv laid out head-major), its pyramid of skips from the
hidden states after blocks 4, 7 and 10 and the final tokens, the UNETR
decoder (feature size 16) for the segmentation and the FCN image decoder
over the bottom level."""

import math
from typing import List

import torch
import torch.nn.functional as F

from perfbench.reference.nets import (conv, conv_t2, fcn_decode, layer_norm, linear, pr_up,
                                      res_block)

HIDDEN, MLP, LAYERS, HEADS, PATCH = 768, 3072, 12, 12, 16
FEAT = 16


def vit_block(P, q: str, t: torch.Tensor) -> torch.Tensor:
    """One pre-norm block: t + attention(norm1(t)), then t + MLP(norm2(t))."""
    b, n, _ = t.shape
    d = HIDDEN // HEADS
    qkv = linear(P, f"{q}.attn.qkv", layer_norm(P, f"{q}.norm1", t), 3 * HIDDEN, bias=False)
    qkv = qkv.reshape(b, n, HEADS, 3, d)
    qh, kh, vh = (qkv[:, :, :, j].transpose(1, 2) for j in range(3))
    att = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(d), dim=-1)
    out = (att @ vh).transpose(1, 2).reshape(b, n, HIDDEN)
    t = t + linear(P, f"{q}.attn.out_proj", out, HIDDEN)
    h = F.gelu(linear(P, f"{q}.linear1", layer_norm(P, f"{q}.norm2", t), MLP))
    return t + linear(P, f"{q}.linear2", h, HIDDEN)


def vit(P, x):
    p = "image_encoder.vit"
    n_tok = (x.shape[2] // PATCH) * (x.shape[3] // PATCH)
    t = conv(P, f"{p}.patch_embed", x, HIDDEN, PATCH, stride=PATCH)
    t = t.flatten(2).transpose(1, 2)
    t = t + P.take(f"{p}.pos_embedding", (1, n_tok, HIDDEN), "pos")
    hidden = []
    for i in range(LAYERS):
        t = vit_block(P, f"{p}.block{i}", t)
        hidden.append(t)
    return layer_norm(P, f"{p}.norm", t), hidden


def pyramid(P, x) -> List[torch.Tensor]:
    final, hidden = vit(P, x)
    g = x.shape[2] // PATCH

    def grid(tokens):
        return tokens.transpose(1, 2).reshape(tokens.shape[0], HIDDEN, g, g)

    p = "image_encoder"
    return [res_block(P, f"{p}.encoder1", x, FEAT),
            pr_up(P, f"{p}.encoder2", grid(hidden[3]), 2 * FEAT, 2),
            pr_up(P, f"{p}.encoder3", grid(hidden[6]), 4 * FEAT, 1),
            pr_up(P, f"{p}.encoder4", grid(hidden[9]), 8 * FEAT, 0),
            grid(final)]


def encode(P, x):
    levels = pyramid(P, x)
    return levels[-1], levels


def segment(P, feats, num_classes):
    enc1, enc2, enc3, enc4, x = feats
    p = "segmentation_decoder"
    for name, skip in (("decoder5", enc4), ("decoder4", enc3), ("decoder3", enc2),
                       ("decoder2", enc1)):
        up = conv_t2(P, f"{p}.{name}.up", x, skip.shape[1])
        x = res_block(P, f"{p}.{name}.conv", torch.cat([up, skip], 1), skip.shape[1])
    return conv(P, f"{p}.out", x, num_classes, 1)


def decode_image(P, z_i, **kw):
    return fcn_decode(P, "image_decoder", z_i, 1, True, True, **kw)
