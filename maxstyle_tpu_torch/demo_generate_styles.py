"""Demo: generate MaxStyle-augmented images from a trained (or fresh) model.

Counterpart of ``maxstyle_tpu/demo_generate_styles.py`` (the reference's
vis_hard_example notebook path), with the same flags. Unlike the JAX
package's demo, ``--torch_ckpt_dir`` and ``--image`` have no default: the
reference's notebook fixtures
(notebooks/model/{image_decoder,segmentation_decoder}.pth and
notebooks/data/image.npy) are not part of this repository, so a user names
them; ``none`` is accepted for either, as in the JAX package.

Without an encoder (the fixtures hold none) the latent code is recovered by
decoder inversion — Adam(0.05) on z minimizing ||dec(z) - image||^2 with the
decoder frozen, in optax's order (:func:`fit_latent_code`) — and MaxStyle
draws independent styles for it. With an encoder (``--ckpt_dir``, a port
checkpoint, or an ``image_encoder.pth`` in ``--torch_ckpt_dir``) the code
comes from the encoder and each generation runs the adversarial loop
(``--n_iter``) against the segmentation prediction, through the MaxStyle
kernels on the GPU. Two generations, each from its own generator, make the
two styled columns of the grid (input, reconstruction, styled #1, styled
#2) written to ``--out``.

  python -m maxstyle_tpu_torch.demo_generate_styles [--device cpu] ...

It runs on the GPU unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch


def fit_latent_code(solver, nets, image: torch.Tensor, z_shape, *, iters: int = 200,
                    lr: float = 0.05):
    """Invert the frozen image decoder: argmin_z ||dec(z) - image||^2 by
    Adam from z = 0. ``image`` is [N,C,H,W]; returns (z, the loss before
    each update as a numpy array)."""
    from maxstyle_tpu_torch.solver import _inner_adam

    z = torch.zeros(z_shape, device=image.device)
    m, v = torch.zeros_like(z), torch.zeros_like(z)
    losses = []
    for t in range(1, iters + 1):
        live = z.detach().requires_grad_(True)
        with torch.enable_grad():
            recon = solver.decode(nets, "image_decoder", live, mode="frozen")
            loss = torch.mean((recon - image) ** 2)
            (grad,) = torch.autograd.grad(loss, live)
        losses.append(loss.detach())
        with torch.no_grad():
            _inner_adam([z], [grad], [m], [v], t, lr)
    return z, torch.stack(losses).cpu().numpy()


def main(argv=None):
    from maxstyle_tpu_torch import prng
    from maxstyle_tpu_torch.config import (DataConfig, ExperimentConfig, LearningConfig,
                                           MaxStyleConfig, SegmentationModelConfig)
    from maxstyle_tpu_torch.flagship import config_solver
    from maxstyle_tpu_torch.utils import checkpoint as ckpt
    from maxstyle_tpu_torch.utils.torch_import import import_module_checkpoints
    from maxstyle_tpu_torch.utils.visualize import save_image_grid

    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt_dir", type=str, default=None,
                        help="port checkpoint dir (full model incl. encoder)")
    parser.add_argument("--ckpt", type=str, default="best")
    parser.add_argument("--torch_ckpt_dir", type=str, default=None,
                        help="dir of reference per-module .pth files, such as the "
                             "reference's notebooks/model")
    parser.add_argument("--image", type=str, default=None,
                        help=".npy image [H,W] or [N,H,W] in [0,1], such as the "
                             "reference's notebooks/data/image.npy (default: a "
                             "synthetic phantom)")
    parser.add_argument("--network_type", type=str, default="FCN_16_standard_no_STN")
    parser.add_argument("--crop", type=int, default=192)
    parser.add_argument("--n_iter", type=int, default=5)
    parser.add_argument("--n_samples", type=int, default=8)
    parser.add_argument("--fit_iters", type=int, default=200,
                        help="decoder-inversion Adam iterations (used when no encoder "
                             "checkpoint is available)")
    parser.add_argument("--out", type=str, default="maxstyle_samples.png")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the GPU by default ('cpu' to run on the CPU)")
    opt = parser.parse_args(argv)
    # 'none' is the JAX package's opt-out of its fixture defaults
    if opt.image == "none":
        opt.image = None
    if opt.torch_ckpt_dir == "none":
        opt.torch_ckpt_dir = None

    hw = opt.crop
    cfg = ExperimentConfig(
        data=DataConfig(crop_size=(hw, hw, 1)),
        segmentation_model=SegmentationModelConfig(network_type=opt.network_type),
        learning=LearningConfig(batch_size=opt.n_samples, max_style=True),
        max_style=MaxStyleConfig(n_iter=opt.n_iter))
    solver = config_solver(cfg, opt.device)
    dev = solver.device
    state = solver.init_state(opt.seed)
    have_encoder = False
    if opt.ckpt_dir:
        state, _ = ckpt.load_checkpoint(opt.ckpt_dir, opt.ckpt, state)
        have_encoder = True
    elif opt.torch_ckpt_dir:
        for name in import_module_checkpoints(state.modules, opt.torch_ckpt_dir, solver.spec):
            print(f"imported reference torch weights for {name}")
            have_encoder |= name == "image_encoder"
    nets = state.modules

    if opt.image:
        img = np.load(opt.image).astype(np.float32)
        if img.ndim == 2:
            img = np.broadcast_to(img[None], (opt.n_samples,) + img.shape)
        img = img[:opt.n_samples, :hw, :hw].copy()
    else:
        # synthetic phantom: blobby circles
        yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
        img = np.stack([np.exp(-(((yy - hw / 2) / (hw / 5)) ** 2
                                 + ((xx - hw / 2) / (hw / 4)) ** 2))
                        for _ in range(opt.n_samples)])
    n = img.shape[0]
    image = torch.from_numpy(np.ascontiguousarray(img[:, None])).to(dev)
    label = (image[:, 0] > 0.5).long()

    if have_encoder:
        with torch.no_grad():
            z_i, _ = solver.encode_image(nets, image, mode="frozen")
        n_iter = opt.n_iter
    else:
        # decoder inversion: recover z for the image with the decoder alone;
        # the adversarial loop needs an encoder for its inner loss, so the
        # styles are drawn, not optimized
        z_shape = (n, solver.spec.latent_ch, hw // 16, hw // 16)
        z_i, fit_losses = fit_latent_code(solver, nets, image, z_shape, iters=opt.fit_iters)
        print(f"decoder inversion: recon mse {fit_losses[0]:.4f} -> "
              f"{fit_losses[-1]:.4f} in {opt.fit_iters} iters")
        n_iter = 0

    ms_cfg = dataclasses.replace(cfg.max_style, n_iter=n_iter)
    with torch.no_grad():
        recon = solver.decode(nets, "image_decoder", z_i, mode="frozen")
    styled = [solver.generate_max_style_image(
        nets, z_i, reference_segmentation=label, ms_cfg=ms_cfg,
        generator=prng.stream(opt.seed + 1, "styles", k, device=dev)) for k in range(2)]

    host = [t[:, 0].cpu().numpy() for t in (image, recon, styled[0], styled[1])]
    suffix = f"adv n_iter={n_iter}" if n_iter else "sampled"
    panels, titles = [], []
    for i in range(min(n, 4)):
        panels += [h[i] for h in host]
        titles += ["input", "recon", f"styled #1 ({suffix})", f"styled #2 ({suffix})"]
    path = save_image_grid(panels, opt.out, titles, cols=4)
    print(f"saved {path}")
    return path


if __name__ == "__main__":
    main()
