"""The benchmark's networks in plain PyTorch, as functions of a flat
parameter table, and the layers they share.

Nothing here imports the program. A network is written once, as a forward
function over a :class:`Params` table keyed by the program's state-dict
names ("image_encoder.general_encoder.inc.conv1.weight", ...). Run on
``meta`` tensors with a recording table, the same function lists every
parameter and buffer with its shape and kind, which is how the benchmark
makes the weights it hands to both sides.

A network family is a file ``reference/families/<family>.py``, which
:class:`Net` loads by path as ``manifest.reader`` loads a metric; a
configuration names it under ``"family"``. The file holds its own widths
and defines ``encode(P, x) -> (z_i, z_s)``, ``segment(P, z_s,
num_classes)`` (the logits) and ``decode_image(P, z_i, **kw)`` (the
reconstruction, taking ``fcn_decode``'s ``style_fns``, ``start`` and
``stop_before``). It may define ``hook_side(crop, hook)``, the side of the
image decoder's activations at a style hook, where that is not the FCN
decoder's ``crop >> (4 - min(hook, 4))``. Adding a network is adding its
file.

BatchNorm normalizes with the batch's statistics (biased variance, eps
1e-5): in a training step every pass does ("train" and "frozen" differ
only in the running statistics they write, which no compared number
reads).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

LRELU = 0.2
BN_EPS = 1e-5
LN_EPS = 1e-6

HERE = Path(__file__).resolve().parents[1]

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


# ---------------------------------------------------------------------------
# the FCN decoder (feature_reduce 4): FCN_16's two decoders, every family's
# image decoder
# ---------------------------------------------------------------------------

DEC_CH = (64, 32, 16, 16)


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
# the network families, loaded by file
# ---------------------------------------------------------------------------


def load_family(family: str, here: Path = HERE):
    """The module of ``<here>/reference/families/<family>.py``."""
    path = here / "reference" / "families" / f"{family}.py"
    if not path.is_file():
        raise ValueError(f"network family {family!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench_family_{family}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Net:
    """One family as the solver uses it: ``encode`` gives (z_i, z_s),
    ``segment`` the logits of z_s, ``decode_image`` the image decoder over
    z_i, ``hook_side`` the side of its activations at a style hook."""

    def __init__(self, family: str, num_classes: int, here: Path = HERE):
        self.family = family
        self.num_classes = num_classes
        self.module = load_family(family, here)

    def encode(self, P, x):
        return self.module.encode(P, x)

    def segment(self, P, z_s):
        return self.module.segment(P, z_s, self.num_classes)

    def decode_image(self, P, z_i, **kw):
        return self.module.decode_image(P, z_i, **kw)

    def hook_side(self, crop: int, hook: int) -> int:
        side = getattr(self.module, "hook_side", None)
        return side(crop, hook) if side else crop >> (4 - min(int(hook), 4))


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
