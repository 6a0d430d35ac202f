"""Everything a run is given, made from ``--seed``: the slice pool, the
weights, and the draws that the correctness steps hand to both sides.

Streams are named and derived from the seed by ``numpy.random.SeedSequence``
(any non-negative whole number, however large), so the same seed gives the
same pool, weights and draws, and the streams do not overlap.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Tuple

import numpy as np
import torch


def stream_seed(seed: int, name: str, *index: int) -> int:
    """A 63-bit seed for the stream ``name`` of a run."""
    words = np.random.SeedSequence([int(seed), zlib.crc32(name.encode()), *index]
                                   ).generate_state(2, np.uint32)
    return (int(words[0]) | int(words[1]) << 32) & (2 ** 63 - 1)


def generator(seed: int, name: str, *index: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, name, *index))


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


def phantom_batch(rng: np.random.RandomState, n: int, hw: int):
    """Disks of three radius classes (labels 1-3) on a noisy background:
    images [n,hw,hw] float32 in [0, 1], labels [n,hw,hw] int32. A copy of
    the port's ``scripts/ab_randconv_bn.phantom_batch``, without the
    trailing channel axis."""
    imgs = np.zeros((n, hw, hw), np.float32)
    labs = np.zeros((n, hw, hw), np.int32)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    for i in range(n):
        k = rng.randint(1, 4)
        r = hw * (0.08 + 0.07 * k)
        cy = rng.uniform(0.3, 0.7) * hw
        cx = rng.uniform(0.3, 0.7) * hw
        mask = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) < r
        imgs[i] = 0.2 + 0.15 * rng.randn(hw, hw).astype(np.float32)
        imgs[i][mask] += 0.25 * k
        labs[i][mask] = k
        imgs[i] = np.clip(imgs[i], 0, 1)
    return imgs, labs


class SlicePool:
    """Raw padded slices as the training set of ``HostBatchLoader``:
    ``get_raw_slice(i)`` gives (image [H,W] float32, label [H,W] int32,
    meta). ``index_of`` finds a slice by its bytes."""

    def __init__(self, seed: int, size: int, pad: int):
        rng = np.random.RandomState(stream_seed(seed, "pool") % 2 ** 32)
        self.images, self.labels = phantom_batch(rng, size, pad)
        self._index = {self.images[i].tobytes(): i for i in range(size)}

    def __len__(self) -> int:
        return len(self.images)

    def get_raw_slice(self, i: int):
        return self.images[i], self.labels[i], {"index": i}

    def index_of(self, image: np.ndarray) -> int:
        """The pool index of a slice, or -1."""
        return self._index.get(np.ascontiguousarray(image, np.float32).tobytes(), -1)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def make_weights(specs: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights on ``device`` from one normal draw: convolutions
    Kaiming-normal (fan in), transposed convolutions N(0, 0.02), dense
    layers N(0, 1/fan in), BatchNorm scales N(1, 0.02), position embeddings
    N(0, 0.02), LayerNorm scales and running variances 1, the rest 0."""
    total = sum(math.prod(shape) for shape, _ in specs.values())
    flat = torch.randn(total, generator=generator(seed, "weights", device=device),
                       device=device)
    out, at = {}, 0
    for name, (shape, kind) in specs.items():
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if kind == "conv":
            t = z * math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
        elif kind in ("conv_t", "pos"):
            t = z * 0.02
        elif kind == "dense":
            t = z * math.sqrt(1.0 / shape[1])
        elif kind == "bn_weight":
            t = 1.0 + 0.02 * z
        elif kind == "one":
            t = torch.ones_like(z)
        elif kind == "zero":
            t = torch.zeros_like(z)
        else:
            raise ValueError(f"{name}: weight kind {kind!r}")
        out[name] = t.contiguous()
    return out


def by_module(weights: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module: state dict} from names "module.rest"."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in weights.items():
        mod, rest = name.split(".", 1)
        out.setdefault(mod, {})[rest] = t.clone()
    return out


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------


def draw_aug(gen: torch.Generator, pol: dict, n: int, pad_hw: Tuple[int, int],
             crop_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """Every random number of ``n`` augmentations under the policy ``pol``,
    by the names the program's ``overrides["aug_draws"]`` takes."""
    dev = gen.device
    H, W = pad_hw
    h, w = crop_hw

    def uni(lo, hi, shape=(n,)):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def randint(hi):
        return torch.randint(0, hi, (n,), generator=gen, device=dev)

    return {
        "theta_deg": uni(-pol["rotate_deg"], pol["rotate_deg"]),
        "shear_deg": uni(-pol["shear_deg"], pol["shear_deg"]),
        "zy": uni(*pol["zoom_range"]), "zx": uni(*pol["zoom_range"]),
        "ty": uni(-pol["shift_frac"][0], pol["shift_frac"][0]),
        "tx": uni(-pol["shift_frac"][1], pol["shift_frac"][1]),
        "group": randint(max(len(pol["rotate_groups"]), 1)),
        "flip_h_u": uni(0.0, 1.0), "flip_v_u": uni(0.0, 1.0),
        "oy": randint(H - h + 1), "ox": randint(W - w + 1),
        "elastic_u": uni(0.0, 1.0),
        "alpha": H * uni(*pol["elastic_alpha_range"]),
        "sigma": H * uni(*pol["elastic_sigma_range"]),
        "elastic_noise": uni(-1.0, 1.0, (n, 2, H, W)),
        "intensity_u": uni(0.0, 1.0),
        "contrast": uni(*pol["contrast_range"]), "brightness": uni(*pol["brightness_range"]),
        "gamma_u": uni(0.0, 1.0), "gamma": uni(*pol["gamma_range"]),
    }


def draw_style(gen: torch.Generator, batch: int, ms: dict):
    """{hook: (params, state)} of the MaxStyle ops: lmda U(0, 1), the two
    noises N(0, 1), a permutation of the batch that moves some row, and
    the gate (U(0, 1) < p), as the configuration's ``max_style`` states."""
    dev = gen.device
    out = {}
    for h in ms["decoder_layers_indexes"]:
        c = ms["hook_channels"][str(h)]
        perm = torch.randperm(batch, generator=gen, device=dev)
        if bool((perm == torch.arange(batch, device=dev)).all()):
            perm = torch.roll(perm, 1)
        gate = (torch.rand((), generator=gen, device=dev) < ms["p"]).float()
        params = {"lmda": torch.rand((batch, 1, 1, 1), generator=gen, device=dev),
                  "gamma_noise": torch.randn((batch, c, 1, 1), generator=gen, device=dev),
                  "beta_noise": torch.randn((batch, c, 1, 1), generator=gen, device=dev)}
        out[int(h)] = (params, {"perm": perm, "gate": gate})
    return out
