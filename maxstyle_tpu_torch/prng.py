"""Random-draw helpers shared by the port's modules.

Every random function of the port is split in two: a draw part that takes an
explicit ``torch.Generator`` and a deterministic part that takes the drawn
numbers. Tests feed the deterministic part with the numbers JAX drew, since
a JAX key and a torch generator never give the same draws.

A run's streams are named, as the JAX package's ``prng.fold_name`` names
its keys: :func:`stream` seeds a generator from (run seed, name, indexes).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def name_hash(name: str) -> int:
    """The string hash of the JAX package's ``prng.fold_name``."""
    h = 0
    for ch in name:
        h = (h * 131 + ord(ch)) % (2**31 - 1)
    return h


def stream_seed(seed: Optional[int], name: str, *indexes: int) -> int:
    """A 64-bit seed for the stream ``name`` (and ``indexes``, e.g. an epoch)
    of a run seeded by ``seed`` (None means 0, as in ``prng.make_key``)."""
    entropy = [0 if seed is None else seed, name_hash(name), *indexes]
    lo, hi = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return int(lo) | int(hi) << 32


def stream(seed: Optional[int], name: str, *indexes: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` for the named stream of a run."""
    return torch.Generator(device=device).manual_seed(stream_seed(seed, name, *indexes))


def non_identity_permutation(perm: torch.Tensor) -> torch.Tensor:
    """A drawn permutation of [0, n), replaced by the cyclic shift (a
    derangement) in the rare case that it is the identity — the JAX
    package's static-shape stand-in for re-rolling until non-identity."""
    identity = torch.arange(perm.shape[0], device=perm.device)
    is_identity = torch.all(perm == identity)
    return torch.where(is_identity, torch.roll(identity, 1), perm)
