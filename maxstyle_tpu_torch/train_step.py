"""Training-step composition.

Counterpart of ``maxstyle_tpu/train_step.py``: one call runs one iteration
of the reference training loop (train_adv_supervised_segmentation_triplet.py
:158-541) — input noise, standard triplet training and, with ``max_style``,
adversarial style generation and hard-example training, and every other
method branch the config enables (latent_DA, RSC, mix_style, DSU,
rand_conv, adv_noise, adv_bias; ``train_step_branches.py``) — then one
optimizer step per module.

At the boundary the layouts are the JAX package's: ``batch["image"]`` is
[N,H,W,1] float and ``batch["label"]`` [N,H,W] int; raw batches are [N,H,W]
(one step) or [K,N,H,W] (K steps). The step updates the TrainState in place
and returns it with the metrics, as float32 tensors on the state's device.

Under ``parallel/mesh.shard_train_step`` a step runs on the rank's shard of
the batch with the global-batch semantics of ``parallel/mesh.py``: every
draw, and every injected override, is the global batch's (the rank takes
its rows), the losses and metrics are the rank's shares, the weight
gradients are summed over the data group in one bucket before the
optimizers step, and the metrics come back summed, so every rank holds the
global values. The fused step augments each rank's raw shard from a stream
of its own.

Each fused call is the span ``step`` of ``utils/profiling.span``, whose
children are the phases ``augment``, ``standard_pass``, ``inner_loop``,
``hard_pass``, ``branches``, ``backward`` and ``optimizer``, in that order;
they are opened here, at the call sites, and not inside the solver's
methods (``hard_example_training`` calls ``standard_training``). They
record only while a profiler does.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Tuple

import torch

from maxstyle_tpu_torch import train_step_branches as br
from maxstyle_tpu_torch.data import augment as A
from maxstyle_tpu_torch.models.layers import dropout_step, live_running_stats
from maxstyle_tpu_torch.parallel import mesh
from maxstyle_tpu_torch.solver import TrainState, TripletSegmentationSolver
from maxstyle_tpu_torch.utils.profiling import span

LOSS_KEYS = (
    "loss/standard/total", "loss/standard/seg", "loss/standard/image",
    "loss/standard/shape", "loss/standard/gt_shape",
    "loss/hard/total", "loss/hard/seg", "loss/hard/image", "loss/hard/shape",
    "loss/hard/rand_conv", "loss/hard/RSC", "loss/hard/mix_style",
    "loss/hard/DSU", "loss/hard/adv_noise", "loss/hard/adv_bias",
)


def add_input_noise(clean_image: torch.Tensor, noise: torch.Tensor,
                    intensity_norm_type: str) -> torch.Tensor:
    """Denoising-autoencoder input corruption (train_adv…:179-186) given the
    N(0,1) draw ``noise``: +0.05*noise, then clamp to the clean batch's
    global [min, max] (min_max; over the global batch in a data group) or
    re-instance-normalize (z_score)."""
    noisy = clean_image + 0.05 * noise
    if intensity_norm_type == "min_max":
        return torch.clamp(noisy, mesh.all_extreme(clean_image.min(), "min"),
                           mesh.all_extreme(clean_image.max(), "max"))
    if intensity_norm_type == "z_score":
        mean = noisy.mean(dim=(2, 3), keepdim=True)
        var = noisy.var(dim=(2, 3), keepdim=True, unbiased=False)
        return (noisy - mean) / torch.sqrt(var + 1e-5)
    raise ValueError(intensity_norm_type)


def draw_dropout_seed(generator: torch.Generator) -> int:
    """One step's dropout seed, drawn from the step's generator."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator, device=generator.device))


def make_train_step(solver: TripletSegmentationSolver):
    """The per-iteration update ``step(state, batch, generator,
    overrides=None) -> (state, metrics)``.

    ``overrides`` pins the step's random draws: {"image_n": the noisy input
    [N,H,W,1], "style_init": ({idx: MaxStyleParams}, {idx: MaxStyleState}),
    "dropout_masks": {layer name: boolean keep-mask [N,C,1,1]},
    "branch_draws": {flag: that method branch's draws} (see
    ``train_step_branches``)}.

    Dropout follows the JAX step, which splits one "dropout" key a step and
    hands it to every pass: when some layer has a dropout rate, the step
    draws one seed from ``generator`` (after the input noise; one host sync)
    and every FixableDropout applies one mask, derived from that seed and
    its name, to the standard pass, the MaxStyle decodes and the
    hard-example pass (``models/layers.dropout_step``). Without a dropout
    rate nothing is drawn, so the random stream is unchanged."""
    cfg = solver.config
    L = cfg.learning
    dropout = bool(L.encoder_dropout) or bool(L.decoder_dropout)  # some layer has a rate
    # the AdvNoise/AdvBias consistency forwards run in eval mode inside the step
    eval_in_step = bool(L.adv_noise) or bool(L.adv_bias)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: torch.Generator, overrides: Dict[str, Any] | None = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        image = batch["image"]
        if image.dim() != 4:
            raise ValueError(f"batch['image'] must be [N,H,W,C], got {tuple(image.shape)}")
        label = batch["label"]
        if label.dim() != 3:
            raise ValueError(f"batch['label'] must be [N,H,W], got {tuple(label.shape)}")
        with contextlib.ExitStack() as stack:
            with span("standard_pass"):
                clean = image.permute(0, 3, 1, 2).float().contiguous()
                label = label.long()
                ov = overrides or {}
                if "image_n" in ov:
                    image_n = (mesh.local_rows(ov["image_n"]).permute(0, 3, 1, 2)
                               .float().contiguous())
                else:
                    noise = torch.randn(mesh.global_shape(clean.shape), generator=generator,
                                        device=clean.device)
                    image_n = add_input_noise(clean, mesh.local_rows(noise),
                                              cfg.data.intensity_norm_type)
                nets = state.modules
                for opt in state.optimizers.values():
                    opt.zero_grad(set_to_none=True)
                seed = draw_dropout_seed(generator) if dropout else None

                zero = torch.zeros((), device=clean.device)
                m = {key: zero for key in LOSS_KEYS}
                if dropout:
                    stack.enter_context(dropout_step(nets, seed, ov.get("dropout_masks")))
                if eval_in_step:
                    stack.enter_context(live_running_stats(nets))
                (seg_l, img_l, gt_l, shape_l), aux = solver.standard_training(
                    nets, clean, label, image_n, mode="train")
                standard_loss = seg_l + img_l + shape_l + gt_l
                m["loss/standard/total"] = standard_loss
                m["loss/standard/seg"] = seg_l
                m["loss/standard/image"] = img_l
                m["loss/standard/shape"] = shape_l
                m["loss/standard/gt_shape"] = gt_l
                total = standard_loss

            if L.max_style:
                with span("inner_loop"):
                    stylized = solver.generate_max_style_image(
                        nets, aux.z_i, reference_segmentation=label, ms_cfg=cfg.max_style,
                        generator=generator, style_init=ov.get("style_init"))
                with span("hard_pass"):
                    h_seg, h_rec, h_shape1, h_shape2 = solver.hard_example_training(
                        nets, stylized, clean, label, standard_input_image=image_n.detach(),
                        standard_recon_image=aux.recon_image)
                    ms_loss = h_rec + h_seg + h_shape1 + h_shape2
                    m["loss/hard/total"] = ms_loss
                    m["loss/hard/seg"] = h_seg
                    m["loss/hard/image"] = h_rec
                    m["loss/hard/shape"] = h_shape1 + h_shape2
                    total = total + ms_loss

            with span("branches"):
                total = total + br.apply_enabled_branches(
                    solver, cfg, nets, aux, clean_image=clean, image_n=image_n, label=label,
                    generator=generator, metrics=m, draws=ov.get("branch_draws"))

        with span("backward"):
            total.backward()
        with span("optimizer"):
            params = [p for name in state.optimizers for p in nets[name].parameters()]
            for p in params:
                # every weight steps, as under optax, where each leaf has a gradient
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            mesh.reduce_gradients(params)
            for name, opt in state.optimizers.items():
                opt.step()
                if name in state.schedulers:
                    state.schedulers[name].step()
        m["loss/total"] = total
        state.step += 1
        return state, mesh.sum_metrics({k: v.detach() for k, v in m.items()})

    return step


def interleave_style_groups(aug: torch.Tensor, orig: torch.Tensor,
                            group_size: int) -> torch.Tensor:
    """Reorder the (aug, orig) pair into consecutive style groups of
    ``group_size``, each [G/2 aug | G/2 orig]."""
    half, hg = aug.shape[0], group_size // 2
    n = half // hg
    a = aug.reshape((n, hg) + tuple(aug.shape[1:]))
    o = orig.reshape((n, hg) + tuple(orig.shape[1:]))
    return torch.cat([a, o], dim=1).reshape((2 * half,) + tuple(aug.shape[1:]))


def make_fused_train_step(solver: TripletSegmentationSolver, aug_policy: A.AugPolicy,
                          keep_orig: bool):
    """Augmentation and training in one call: ``fused(state, raw,
    generator)`` takes RAW padded slices {"image": [N,H,W], "label":
    [N,H,W]}, augments them on their device, pairs them with the
    center-cropped originals when ``keep_orig``, and trains one step.
    ``overrides`` pins the draws: "aug_draws" those of the augmentation (see
    ``augment.draw_aug``; in a data group the rank's own), the rest those of
    ``make_train_step``'s step."""
    base_step = make_train_step(solver)
    crop_hw = aug_policy.crop_hw

    def augmented_batch(raw, generator, draws):
        augment = A.augment_batch_inner if mesh.active() is None else A.augment_batch_sharded
        img, lab = augment(generator, raw["image"], raw["label"], aug_policy, draws=draws)
        if not keep_orig:
            return {"image": img, "label": lab}
        oi, ol = A.norm_batch(raw["image"], raw["label"], crop_hw)
        half = img.shape[0]
        g = (solver.config.max_style.style_group_size
             if solver.config.learning.max_style else None)
        if g and 2 * half > g:
            if g % 2 or half % (g // 2):
                raise ValueError(
                    f"style_group_size={g} with keep_orig pairing needs an even "
                    f"group that divides both batch halves (half={half}); adjust "
                    f"batch_size or style_group_size")
            return {"image": interleave_style_groups(img, oi, g),
                    "label": interleave_style_groups(lab, ol, g)}
        return {"image": torch.cat([img, oi], 0), "label": torch.cat([lab, ol], 0)}

    def fused(state: TrainState, raw: Dict[str, torch.Tensor], generator: torch.Generator,
              overrides: Dict[str, Any] | None = None):
        ov = dict(overrides or {})
        with span("step"):
            with span("augment"):
                batch = augmented_batch(raw, generator, ov.pop("aug_draws", None))
            return base_step(state, batch, generator, overrides=ov)

    return fused


def make_multi_step(solver: TripletSegmentationSolver, aug_policy: A.AugPolicy,
                    keep_orig: bool, n_inner: int = 4):
    """``multi(state, raw_stack, generator)`` runs ``n_inner`` fused steps on
    raw batches stacked on a leading axis ({"image": [K,N,H,W], "label":
    [K,N,H,W]}) and reports the mean of each metric over the K steps."""
    fused = make_fused_train_step(solver, aug_policy, keep_orig)

    def multi(state: TrainState, raw_stack: Dict[str, torch.Tensor],
              generator: torch.Generator):
        if raw_stack["image"].shape[0] != n_inner:
            raise ValueError(f"expected {n_inner} stacked raw batches, got "
                             f"{raw_stack['image'].shape[0]}")
        history = []
        for k in range(n_inner):
            raw = {"image": raw_stack["image"][k], "label": raw_stack["label"][k]}
            state, metrics = fused(state, raw, generator)
            history.append(metrics)
        return state, {key: torch.stack([h[key] for h in history]).mean()
                       for key in history[0]}

    return multi
