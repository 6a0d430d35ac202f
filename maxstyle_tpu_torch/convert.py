"""Convert the JAX package's flax weights into the port's state dicts.

The inverse of ``maxstyle_tpu/utils/torch_import.py``. The input is one
module's ``TrainState.params`` subtree and its ``batch_stats`` subtree as
nested dicts of numpy arrays (NHWC/HWIO layouts); the output is the state
dict of the port's module of the same name. The port names its modules
after the flax ones, so the mapping goes by path:

  conv kernel           (kh,kw,I,O)       -> weight (O,I,kh,kw) (3-D alike)
  transposed-conv kern. (kh,kw,I,O)       -> weight (I,O,kh,kw), spatially
                                             flipped (flax's ConvTranspose
                                             correlates with the kernel that
                                             torch's flips)
  Dense kernel          (in,out)          -> weight (out,in)
  BatchNorm             scale/bias + mean/var -> weight/bias +
                                             running_mean/running_var
  LayerNorm             scale/bias        -> weight/bias
  spectral-norm conv    kernel/bias + u/v     -> weight/bias + buffers u/v
  nn.SpectralNorm (if_sn) SpectralNorm_{k}/{conv}/kernel/{u,sigma}
                                          -> the conv's buffers u, sigma
  self-attention gate   gamma                 -> gamma
  ViT position embedding pos_embedding        -> pos_embedding (same layout)
  ``BatchNorm_0`` (the flax Norm2d child) and ``BatchInstanceNorm_0`` are
  dropped from the path; the batch-instance gate, the adaptive norms'
  rho/gamma/beta and a/b keep their names.
  ``ConvTranspose_0`` becomes ``conv`` inside an ``Upsampler`` (flax path
  ``.../up/ConvTranspose_0``: the FCN decoder's Conv2 and Conv4 blocks) and
  ``up`` elsewhere (the UNet's ``Up`` and ``ResConvUp``, where it sits
  beside a ``conv`` or ``ResConv_0`` child, and UNETR's ``UpCatBlock``);
  UNETR's ``ResConvBlock_0`` becomes ``conv``. Domain-specific norms
  (``bn_domain{d}``) and the code filters ``code_filters_{i}`` keep their
  names.

A 4-D kernel is a transposed conv when its flax module is ``up{i}`` (the
transposed convs of UNETR's ``PrUpBlock``; the ``up{i}`` of the other
families are parents of modules and hold no kernel) or ``ConvTranspose_{n}``.
Float64 leaves stay float64 (a gradient check's reference run); every other
leaf becomes float32.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"bias": "bias", "scale": "weight", "gamma": "gamma", "mean": "running_mean",
         "var": "running_var", "u": "u", "v": "v", "sigma": "sigma",
         "pos_embedding": "pos_embedding", "gate": "gate", "rho": "rho", "beta": "beta",
         "a": "a", "b": "b"}
# the flax children that the port's norm modules fold into themselves
_DROPPED = ("BatchNorm_0", "BatchInstanceNorm_0")
_RENAME = {"ResConvBlock_0": "conv"}
_TRANSPOSED = re.compile(r"up\d+|ConvTranspose_\d+")


def _walk(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, path + (str(key),))
        else:
            a = np.asarray(value)
            yield path + (str(key),), a if a.dtype == np.float64 else a.astype(np.float32)


def _torch_name(path: Tuple[str, ...]) -> str:
    segs = []
    for i, s in enumerate(path[:-1]):
        if s == "ConvTranspose_0":
            s = "conv" if i > 0 and path[i - 1] == "up" else "up"
        if s not in _DROPPED:
            segs.append(_RENAME.get(s, s))
    return ".".join(segs + [_LEAF.get(path[-1], "weight")])


def _kernel(path: Tuple[str, ...], a: np.ndarray) -> np.ndarray:
    if a.ndim == 2:  # Dense
        return a.T
    if a.ndim not in (4, 5):
        raise ValueError(f"{'/'.join(path)}: expected a 2-D Dense or a 4-D conv kernel "
                         "(5-D for a 3-D conv)")
    k = a.ndim - 2  # spatial dims, then (I, O)
    spatial = tuple(range(k))
    if len(path) > 1 and _TRANSPOSED.fullmatch(path[-2]):
        return a[(slice(None, None, -1),) * k].transpose((k, k + 1) + spatial)
    return a.transpose((k + 1, k) + spatial)


def flax_to_state_dict(params: Mapping, batch_stats: Mapping | None = None
                       ) -> Dict[str, torch.Tensor]:
    """One module's flax params (and batch stats) -> the port's state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, a in _walk(params):
        if path[-1] == "kernel":
            a = _kernel(path, a)
        elif path[-1] not in ("bias", "scale", "gamma", "pos_embedding", "gate", "rho",
                              "beta", "a", "b"):
            raise ValueError(f"unexpected flax parameter {'/'.join(path)}")
        out[_torch_name(path)] = torch.from_numpy(np.ascontiguousarray(a))
    for path, a in _walk(batch_stats or {}):
        if len(path) > 1 and path[-2].startswith("SpectralNorm_"):
            # nn.SpectralNorm's {conv}/kernel/{u,sigma}: the conv's buffers
            conv, kernel, leaf = path[-1].split("/")
            if kernel != "kernel" or leaf not in ("u", "sigma"):
                raise ValueError(f"unexpected flax batch stat {'/'.join(path)}")
            path = path[:-2] + (conv, leaf)
        elif path[-1] not in ("mean", "var", "u", "v"):
            raise ValueError(f"unexpected flax batch stat {'/'.join(path)}")
        out[_torch_name(path)] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def convert_train_state(params: Mapping, batch_stats: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX ``TrainState``'s params and batch stats (as numpy) ->
    {module name: state dict} for every module."""
    return {name: flax_to_state_dict(params[name], batch_stats.get(name, {}))
            for name in params}
