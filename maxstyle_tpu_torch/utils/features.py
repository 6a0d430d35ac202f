"""Intermediate-activation capture.

Counterpart of ``maxstyle_tpu/utils/features.py`` (the reference's
model_util.HookBasedFeatureExtractor:725-778, flax's
``capture_intermediates`` in the JAX package): forward hooks on every
submodule, keyed by the flax path of the JAX package's module — the port's
module path with ``/`` for ``.``, ``conv`` of an ``Upsampler`` as
``ConvTranspose_0`` (the inverse of ``convert.py``'s renaming), and
``/__call__`` appended — so the two packages' captures share their keys.
Activations stay in the port's layout (NCHW).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from torch import nn

from maxstyle_tpu_torch.models.layers import Upsampler


def flax_path(module: nn.Module, name: str) -> str:
    """The flax path (without ``/__call__``) of the submodule ``name``."""
    parts = name.split(".") if name else []
    out = []
    parent = module
    for part in parts:
        child = getattr(parent, part)
        out.append("ConvTranspose_0" if isinstance(parent, Upsampler) and part == "conv"
                   else part)
        parent = child
    return "/".join(out)


def extract_features(module: nn.Module, *args, filter_names: Optional[Sequence[str]] = None,
                     **kwargs) -> Dict[str, Any]:
    """Run ``module(*args, **kwargs)`` capturing every submodule's output
    (the last call's, when a submodule runs more than once); returns a flat
    {flax path + "/__call__": activation} dict, optionally filtered by
    substring."""
    flat: Dict[str, Any] = {}
    handles = []
    for name, sub in module.named_modules():
        key = "/".join(p for p in (flax_path(module, name), "__call__") if p)

        def hook(_mod, _inp, out, key=key):
            flat[key] = out
        handles.append(sub.register_forward_hook(hook))
    try:
        module(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    if filter_names:
        flat = {k: v for k, v in flat.items() if any(f in k for f in filter_names)}
    return flat
