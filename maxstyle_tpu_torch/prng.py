"""Random-draw helpers shared by the port's modules.

Every random function of the port is split in two: a draw part that takes an
explicit ``torch.Generator`` and a deterministic part that takes the drawn
numbers. Tests feed the deterministic part with the numbers JAX drew, since
a JAX key and a torch generator never give the same draws.
"""

from __future__ import annotations

import torch


def non_identity_permutation(perm: torch.Tensor) -> torch.Tensor:
    """A drawn permutation of [0, n), replaced by the cyclic shift (a
    derangement) in the rare case that it is the identity — the JAX
    package's static-shape stand-in for re-rolling until non-identity."""
    identity = torch.arange(perm.shape[0], device=perm.device)
    is_identity = torch.all(perm == identity)
    return torch.where(is_identity, torch.roll(identity, 1), perm)
