"""Normalization-layer swapping (model_util.replace_bn_with_in:43-62,
recover_model_w_bn:66-71).

Counterpart of ``maxstyle_tpu/models/norm_swap.py``. The reference mutates
a torch module tree in place; the JAX package re-configures a flax module's
``norm`` field, re-initialises it and merges the variables. Here a module
tree owns its norms, so the rebuild is a deep copy of the module in which
every site of the ``norm`` field (every ``layers.BatchNorm``, except the
per-domain ones of ``layers.DomainSpecificNorm2d``, which the field does not
reach) gets a fresh norm of the target kind, with the JAX package's
carry-over rules (its ``_merge``):

* every other parameter and buffer keeps its trained value (convolutions,
  attention, domain-specific norms);
* ``replace_bn_with_in(affine=True)``: the new instance or batch-instance
  norm takes the old BatchNorm's weight and bias; its running statistics
  and the BIN gate start fresh (0, 1 and 1), as the reference recreates
  the buffers;
* ``recover_model_w_bn``: every instance or batch-instance norm becomes a
  fresh BatchNorm (the network's own init: scale N(1, 0.02), drawn from
  ``seed`` in the order of the sites; statistics 0 and 1), nothing of the
  old norm carried.

``replace_bn_with_in(bn_in=True, affine=False)`` works here (the gate stays
a parameter) where the reference crashes. The given module is not changed.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch
from torch import nn

from maxstyle_tpu_torch.models import layers


def _swap_kind(affine: bool, bn_in: bool) -> str:
    if bn_in:
        return "batch_instance" if affine else "batch_instance_noaffine"
    return "instance_affine" if affine else "instance"


def _rebuild(module: nn.Module, is_site: Callable[[nn.Module], bool],
             make: Callable[[nn.Module], nn.Module]) -> nn.Module:
    """A deep copy of ``module`` with every child that ``is_site`` picks
    (outside the domain-specific norms) replaced by ``make(child)``, in
    module order."""
    new = copy.deepcopy(module)

    def visit(parent: nn.Module):
        for name, child in list(parent.named_children()):
            if isinstance(child, layers.DomainSpecificNorm2d):
                continue
            if is_site(child):
                setattr(parent, name, make(child))
            else:
                visit(child)

    visit(new)
    return new


def replace_bn_with_in(module: nn.Module, affine: bool = False,
                       bn_in: bool = False) -> nn.Module:
    """``module`` rebuilt with every BatchNorm site an InstanceNorm
    (``bn_in=False``) or a BatchInstanceNorm (``bn_in=True``), the
    BatchNorm's affine carried over with ``affine`` (module docstring)."""
    kind = _swap_kind(affine, bn_in)

    def make(bn: layers.BatchNorm) -> nn.Module:
        norm = layers.Norm2d(kind, bn.weight.shape[0]).to(bn.weight.device)
        if affine:
            with torch.no_grad():
                norm.weight.copy_(bn.weight)
                norm.bias.copy_(bn.bias)
        if hasattr(norm, "compute_dtype"):
            norm.compute_dtype = bn.compute_dtype
        return norm

    return _rebuild(module, lambda m: type(m) is layers.BatchNorm, make)


def recover_model_w_bn(module: nn.Module, seed: int = 0) -> nn.Module:
    """``module`` rebuilt with every instance or batch-instance norm a fresh
    BatchNorm (module docstring)."""

    def features(norm: nn.Module) -> int:
        return norm.gate.shape[0] if isinstance(norm, layers.BatchInstanceNorm) \
            else norm.features

    def make(norm: nn.Module) -> nn.Module:
        dev = next(iter(module.parameters())).device
        bn = layers.BatchNorm(features(norm)).to(dev)
        bn.compute_dtype = getattr(norm, "compute_dtype", None)
        return bn

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return _rebuild(module, lambda m: isinstance(m, (layers.InstanceNorm,
                                                         layers.BatchInstanceNorm)), make)
