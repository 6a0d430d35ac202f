"""The two networks of the benchmark in plain PyTorch, as functions of a
flat parameter table.

Nothing here imports the program. A network is written once, as a forward
function over a :class:`Params` table keyed by the program's state-dict
names ("image_encoder.general_encoder.inc.conv1.weight", ...). Run on
``meta`` tensors with a recording table, the same function lists every
parameter and buffer with its shape and kind, which is how the benchmark
makes the weights it hands to both sides.

* FCN_16_standard_no_STN (Chen et al., MaxStyle, MICCAI 2022): a five-stage
  residual encoder (16-32-64-128-128 channels), a code decoupler, a
  nearest-neighbour segmentation decoder and a transposed-conv image
  decoder with a sigmoid head.
* UnetTransformer_16_no_STN: UNETR (Hatamizadeh et al., WACV 2022) over a
  ViT-B/16 (hidden 768, 12 layers, 12 heads, MLP 3072, LayerNorm eps 1e-6,
  exact GELU, fused qkv laid out head-major), its pyramid of skips from the
  hidden states after blocks 4, 7 and 10 and the final tokens, the UNETR
  decoder for the segmentation and the FCN image decoder over the bottom
  level.

BatchNorm normalizes with the batch's statistics (biased variance, eps
1e-5): in a training step every pass does ("train" and "frozen" differ
only in the running statistics they write, which no compared number
reads).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

LRELU = 0.2
BN_EPS = 1e-5
LN_EPS = 1e-6

StyleFns = Optional[Dict[int, Callable[[torch.Tensor], torch.Tensor]]]


class Params:
    """The parameter table. ``take(name, shape, kind)`` returns the tensor of
    ``name``; a recording table (``tensors`` None) makes a ``meta`` tensor of
    ``shape`` instead and notes (name, shape, kind)."""

    def __init__(self, tensors: Optional[Dict[str, torch.Tensor]] = None):
        self.tensors = tensors
        self.specs: Dict[str, tuple] = {}
        self._made: Dict[str, torch.Tensor] = {}

    def take(self, name: str, shape, kind: str) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if self.tensors is None:
            if name not in self._made:
                self.specs[name] = (shape, kind)
                self._made[name] = torch.empty(shape, device="meta")
            return self._made[name]
        t = self.tensors[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        return t


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def conv(P: Params, name: str, x: torch.Tensor, cout: int, k: int, stride: int = 1,
         bias: bool = True) -> torch.Tensor:
    w = P.take(f"{name}.weight", (cout, x.shape[1], k, k), "conv")
    b = P.take(f"{name}.bias", (cout,), "zero") if bias else None
    return F.conv2d(x, w, b, stride=stride, padding=(k - 1) // 2 if k == 3 else 0)


def conv_t2(P: Params, name: str, x: torch.Tensor, cout: int) -> torch.Tensor:
    """2x2 stride-2 transposed convolution (weight [in, out, 2, 2])."""
    w = P.take(f"{name}.weight", (x.shape[1], cout, 2, 2), "conv_t")
    b = P.take(f"{name}.bias", (cout,), "zero")
    return F.conv_transpose2d(x, w, b, stride=2)


def batch_norm(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    c = x.shape[1]
    w = P.take(f"{name}.weight", (c,), "bn_weight")
    b = P.take(f"{name}.bias", (c,), "zero")
    P.take(f"{name}.running_mean", (c,), "zero")
    P.take(f"{name}.running_var", (c,), "one")
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + BN_EPS) * w[None, :, None, None] + b[None, :, None, None]


def layer_norm(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    c = x.shape[-1]
    w = P.take(f"{name}.weight", (c,), "one")
    b = P.take(f"{name}.bias", (c,), "zero")
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * w + b


def linear(P: Params, name: str, x: torch.Tensor, cout: int, bias: bool = True) -> torch.Tensor:
    w = P.take(f"{name}.weight", (cout, x.shape[-1]), "dense")
    out = x @ w.t()
    if bias:
        out = out + P.take(f"{name}.bias", (cout,), "zero")
    return out


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, LRELU * x)


def _style(x: torch.Tensor, style_fns: StyleFns, idx: int) -> torch.Tensor:
    return style_fns[idx](x) if style_fns is not None and idx in style_fns else x


# ---------------------------------------------------------------------------
# FCN_16 (feature_reduce 4)
# ---------------------------------------------------------------------------

ENC_CH = (16, 32, 64, 128, 128)
LATENT = 128
DEC_CH = (64, 32, 16, 16)


def res_down(P, name, x, cout):
    x = conv(P, f"{name}.down", x, x.shape[1], 3, stride=2)
    h = lrelu(batch_norm(P, f"{name}.norm1", conv(P, f"{name}.conv1", x, cout, 3)))
    h = batch_norm(P, f"{name}.norm2", conv(P, f"{name}.conv2", h, cout, 3))
    return lrelu(conv(P, f"{name}.conv_input", x, cout, 1) + h)


def fcn_encode(P, x):
    p = "image_encoder.general_encoder"
    h = lrelu(batch_norm(P, f"{p}.inc.norm1", conv(P, f"{p}.inc.conv1", x, ENC_CH[0], 3)))
    h = lrelu(batch_norm(P, f"{p}.inc.norm2", conv(P, f"{p}.inc.conv2", h, ENC_CH[0], 3)))
    for i in range(1, 5):
        h = res_down(P, f"{p}.down{i}", h, ENC_CH[i])
    return torch.relu(batch_norm(P, f"{p}.final_norm", conv(P, f"{p}.final_conv", h, LATENT, 1)))


def fcn_decouple(P, z):
    p = "image_encoder.code_decoupler"
    h = lrelu(batch_norm(P, f"{p}.norm1", conv(P, f"{p}.conv1", z, LATENT, 3, bias=False)))
    return torch.relu(batch_norm(P, f"{p}.norm2", conv(P, f"{p}.conv2", h, LATENT, 3,
                                                       bias=False)))


def res_up(P, name, x, cout, learned_up):
    if learned_up:
        x = conv_t2(P, f"{name}.up.conv", x, x.shape[1])
    else:
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    h = lrelu(batch_norm(P, f"{name}.norm1", conv(P, f"{name}.conv1", x, cout, 3)))
    h = batch_norm(P, f"{name}.norm2", conv(P, f"{name}.conv2", h, cout, 3))
    return lrelu(conv(P, f"{name}.conv_input", x, cout, 1) + h)


def fcn_decode(P, name, x, out_ch, learned_up, sigmoid, style_fns: StyleFns = None,
               start: int = 0, stop_before: Optional[int] = None):
    """The FCN decoder's six (stage, hook) pairs: stage 0 the input, 1-4 the
    up blocks, 5 the 1x1 head and its activation, hook i after stage i.
    ``stop_before=k`` returns stage k's output before hook k; ``start=k``
    takes that output and goes on from hook k."""
    for i in range(start, 6):
        if not (start > 0 and i == start):
            if 1 <= i <= 4:
                x = res_up(P, f"{name}.up{i}", x, DEC_CH[i - 1], learned_up)
            elif i == 5:
                x = conv(P, f"{name}.final_conv", x, out_ch, 1)
                if sigmoid:
                    x = torch.sigmoid(x)
        if stop_before is not None and i == stop_before:
            return x
        x = _style(x, style_fns, i)
    return x


# ---------------------------------------------------------------------------
# UNETR over ViT-B/16 (feature size 16)
# ---------------------------------------------------------------------------

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


def res_block(P, name, x, cout):
    h = lrelu(batch_norm(P, f"{name}.norm1", conv(P, f"{name}.conv1", x, cout, 3)))
    h = batch_norm(P, f"{name}.norm2", conv(P, f"{name}.conv2", h, cout, 3))
    skip = conv(P, f"{name}.skip", x, cout, 1) if x.shape[1] != cout else x
    return lrelu(skip + h)


def pr_up(P, name, x, cout, n_layer):
    x = conv_t2(P, f"{name}.up0", x, cout)
    for i in range(1, n_layer + 1):
        x = res_block(P, f"{name}.conv{i}", conv_t2(P, f"{name}.up{i}", x, cout), cout)
    return x


def unetr_encode(P, x) -> List[torch.Tensor]:
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


def unetr_decode(P, feats, out_ch):
    enc1, enc2, enc3, enc4, x = feats
    p = "segmentation_decoder"
    for name, skip in (("decoder5", enc4), ("decoder4", enc3), ("decoder3", enc2),
                       ("decoder2", enc1)):
        up = conv_t2(P, f"{p}.{name}.up", x, skip.shape[1])
        x = res_block(P, f"{p}.{name}.conv", torch.cat([up, skip], 1), skip.shape[1])
    return conv(P, f"{p}.out", x, out_ch, 1)


# ---------------------------------------------------------------------------
# the network families as the solver uses them
# ---------------------------------------------------------------------------


class Net:
    """One family: ``encode`` gives (z_i, z_s), ``segment`` the logits of
    z_s, ``image_decoder`` the name of the FCN image decoder over z_i."""

    def __init__(self, family: str, num_classes: int):
        if family not in ("fcn16", "unetr"):
            raise ValueError(f"network family {family!r}")
        self.family = family
        self.num_classes = num_classes

    def encode(self, P, x):
        if self.family == "fcn16":
            z = fcn_encode(P, x)
            return z, fcn_decouple(P, z)
        pyramid = unetr_encode(P, x)
        return pyramid[-1], pyramid

    def segment(self, P, z_s):
        if self.family == "fcn16":
            return fcn_decode(P, "segmentation_decoder", z_s, self.num_classes, False, False)
        return unetr_decode(P, z_s, self.num_classes)

    def decode_image(self, P, z_i, **kw):
        return fcn_decode(P, "image_decoder", z_i, 1, True, True, **kw)


def param_specs(net: Net, crop: int) -> Dict[str, tuple]:
    """{name: (shape, kind)} of every parameter and buffer, in the order the
    forward meets them, by one recording pass on ``meta`` tensors."""
    P = Params()
    x = torch.empty((2, 1, crop, crop), device="meta")
    z_i, z_s = net.encode(P, x)
    net.segment(P, z_s)
    net.decode_image(P, z_i)
    return P.specs



def is_buffer(name: str) -> bool:
    return name.endswith(".running_mean") or name.endswith(".running_var")
