"""MixUp / ManifoldMixup and random window masking (NCHW).

Counterpart of ``maxstyle_tpu/ops/mixup.py``: the reference's
advanced/mixup.py:9-127 (input- and feature-space mixup with one-hot label
interpolation; ManifoldMixup reuses one (lam, perm) draw across layers) and
advanced/random_window_masking.py:5-64 (Model-Genesis in- and outpainting).
A library, not wired into the training loop.

Every random number is drawn from a ``torch.Generator`` by a ``draw_*`` /
``sample_mixup`` function and handed to the op, so a caller (or a test)
can pin the draws.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from maxstyle_tpu_torch import losses
from maxstyle_tpu_torch.ops.maxstyle import draw_beta


class MixupDraw(NamedTuple):
    lam: torch.Tensor   # scalar
    perm: torch.Tensor  # [B] int64


def sample_mixup(generator: torch.Generator, batch_size: int, alpha: float = 0.2) -> MixupDraw:
    """One (lam ~ Beta(alpha, alpha), batch permutation) draw, shared across
    layers for ManifoldMixup (mixup.py:99-127)."""
    lam = draw_beta(generator, alpha, ())
    perm = torch.randperm(batch_size, generator=generator, device=generator.device)
    return MixupDraw(lam=lam, perm=perm)


def mixup_data(draw: MixupDraw, x: torch.Tensor, labels: torch.Tensor,
               num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Input or feature mixup (mixup.get_mixup_data:31-73) of x [B,...] and
    labels [B,H,W]: the mixed x and the mixed one-hot targets [B,C,H,W]."""
    x_mix = draw.lam * x + (1.0 - draw.lam) * x[draw.perm]
    y = losses.one_hot(labels, num_classes).float()
    y_mix = draw.lam * y + (1.0 - draw.lam) * y[draw.perm]
    return x_mix, y_mix


def mixup_loss(logits: torch.Tensor, labels: torch.Tensor, draw: MixupDraw,
               num_classes: int) -> torch.Tensor:
    """lam * CE(y) + (1 - lam) * CE(y[perm]) (mixup.get_mixup_loss:75-86)."""
    ce_a = losses.cross_entropy_2d(logits, labels)
    ce_b = losses.cross_entropy_2d(logits, labels[draw.perm])
    return draw.lam * ce_a + (1.0 - draw.lam) * ce_b


# ---------------------------------------------------------------------------
# random window masking (Model Genesis)
# ---------------------------------------------------------------------------


def draw_blocks(generator: torch.Generator, batch: int, h: int, w: int, cnt: int = 5,
                keep_prob: float = 0.95) -> Dict[str, torch.Tensor]:
    """The random part of :func:`_random_blocks_mask`, [batch, cnt] each:
    block sides ``bh`` in [h//6, h//3] and ``bw`` in [w//6, w//3], corners
    ``y0`` in [3, h - h//3 - 3) and ``x0`` in [3, w - w//3 - 3), and ``go``,
    each block kept with probability ``keep_prob``
    (random_window_masking.py:22-31)."""
    dev = generator.device
    shape = (batch, cnt)

    def randint(lo, hi):
        return torch.randint(lo, hi, shape, generator=generator, device=dev)

    return {"bh": randint(h // 6, h // 3 + 1), "bw": randint(w // 6, w // 3 + 1),
            "y0": randint(3, h - h // 3 - 3), "x0": randint(3, w - w // 3 - 3),
            "go": torch.rand(shape, generator=generator, device=dev) < keep_prob}


def _random_blocks_mask(blocks: Dict[str, torch.Tensor], h: int, w: int) -> torch.Tensor:
    """[B,1,H,W] float mask, 1 inside the kept blocks of ``blocks``
    (:func:`draw_blocks`)."""
    yy = torch.arange(h, device=blocks["y0"].device)[None, None, :, None]
    xx = torch.arange(w, device=blocks["y0"].device)[None, None, None, :]

    def col(key):
        return blocks[key][:, :, None, None]

    inside = ((yy >= col("y0")) & (yy < col("y0") + col("bh"))
              & (xx >= col("x0")) & (xx < col("x0") + col("bw")) & col("go"))
    return inside.any(dim=1, keepdim=True).float()


def draw_window_masking(generator: torch.Generator, shape, cnt: int = 5
                        ) -> Dict[str, torch.Tensor]:
    """The draws of one in- or outpainting of an image of ``shape``
    [B,C,H,W]: its ``blocks`` (:func:`draw_blocks`) and U[0, 1) ``noise``
    of the image's shape."""
    b, _, h, w = shape
    return {"blocks": draw_blocks(generator, b, h, w, cnt),
            "noise": torch.rand(tuple(shape), generator=generator, device=generator.device)}


def random_inpainting(image: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Replace the random window blocks of image [B,C,H,W] by the noise
    (random_window_masking.random_inpainting:5-32)."""
    mask = _random_blocks_mask(draws["blocks"], image.shape[2], image.shape[3])
    return image * (1.0 - mask) + draws["noise"] * mask


def random_outpainting(image: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A noise canvas that keeps the image only inside the random blocks
    (random_window_masking.random_outpainting:35-64)."""
    mask = _random_blocks_mask(draws["blocks"], image.shape[2], image.shape[3])
    return draws["noise"] * (1.0 - mask) + image * mask
