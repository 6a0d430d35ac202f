"""The method branches composed into the training step.

Counterpart of ``maxstyle_tpu/train_step_branches.py``: each function is one
``if <flag>:`` block of the reference training loop
(train_adv_supervised_segmentation_triplet.py:201-530). A branch takes the
module dict, the standard pass's ``ForwardAux`` and the step's tensors, adds
its loss to its channels of ``metrics`` and returns the loss. Tensors are
NCHW.

Every random number comes from the step's generator, drawn by the ops'
``draw_*`` functions, unless ``draws`` (the step's
``overrides["branch_draws"][flag]``) gives them:

* ``mix_style`` / ``DSU``: {hook: ``ms.draw_mixstyle`` draws};
* ``latent_DA``: {"image": ..., "shape": ...}, ``lm.draw_masking`` draws
  ("shape" only with an STN);
* ``RSC``: {"image": ..., "shape": ...}, ``lm.draw_masking`` draws;
* ``rand_conv``: a list of three ``rc.draw_rand_conv`` draws, one a view;
* ``adv_noise``: {"d": ...}; ``adv_bias``: {"cp": ...}.

The branches run inside the step's dropout context, so their "train" and
"frozen" decodes see the step's one dropout mask a layer. With an STN each
branch adds its refinement terms as the JAX package does; a DS_FCN
hard-example pass of a branch does not write the statistics it computes
(the JAX step drops them).

In a data group (``parallel/mesh.sharded``) every draw is that of the
global batch (and so is every injected one), each op takes the rank's
rows, and every loss is the rank's share of the global mean.
"""

from __future__ import annotations

from typing import Dict

import torch

from maxstyle_tpu_torch import losses
from maxstyle_tpu_torch.ops import advchain
from maxstyle_tpu_torch.ops import latent_masking as lm
from maxstyle_tpu_torch.ops import randconv as rc
from maxstyle_tpu_torch.parallel import mesh

N_RANDCONV_VIEWS = 3


def latent_da_branch(solver, cfg, nets, aux, *, clean_image, image_n, label, generator,
                     draws, metrics):
    """LSM (MICCAI 2021): hard examples decoded from masked latent codes
    (train_adv…:201-246)."""
    perturbed_image, perturbed_seg = solver.hard_example_generation(
        nets, clean_image.detach(), label, aux.z_i, aux.z_s, lda_cfg=cfg.latent_DA,
        generator=generator, draws=draws)
    h_seg, h_rec, h_shape, h_pseg = solver.hard_example_training(
        nets, perturbed_image, clean_image, label, perturbed_seg=perturbed_seg,
        standard_input_image=image_n.detach(), standard_recon_image=aux.recon_image,
        commit_stats=False)
    loss = h_seg + h_rec + h_shape + h_pseg
    metrics["loss/hard/total"] = metrics["loss/hard/total"] + loss
    metrics["loss/hard/seg"] = metrics["loss/hard/seg"] + h_seg
    metrics["loss/hard/image"] = metrics["loss/hard/image"] + h_rec
    metrics["loss/hard/shape"] = metrics["loss/hard/shape"] + h_shape + h_pseg
    return loss


def rsc_branch(solver, cfg, nets, aux, *, clean_image, image_n, label, generator, draws,
               metrics):
    """RSC self-challenging regularization (train_adv…:330-383): hard masks
    of both codes at the top third of the gradient ("corr" probe); the
    losses of the masked codes' decodes keep their graph to the encoder."""
    threshold = 1.0 / 3

    def dec(name):
        return lambda code: solver.decode(nets, name, code, mode="frozen")

    masks = {}
    for key, code, name, target in (("image", aux.z_i, "image_decoder", clean_image.detach()),
                                    ("shape", aux.z_s, "segmentation_decoder", label)):
        d = (draws[key] if draws is not None
             else lm.draw_masking(generator, mesh.global_shape(code.shape), "RSC", threshold))
        _, masks[key] = lm.perturb_latent_code(
            code, dec(name), target, num_classes=solver.num_classes, draws=d,
            perturb_type="RSC", threshold=threshold, loss_type="corr",
            random_threshold=False, if_soft=False, if_detach=False)

    seg_logit = solver.decode(nets, "segmentation_decoder", aux.z_s * masks["shape"],
                              mode="frozen")
    l_seg_2 = losses.cross_entropy_2d(seg_logit, label, weight=solver.class_weights)
    z_i_masked = aux.z_i * masks["image"]
    recon = solver.decode(nets, "image_decoder", z_i_masked, mode="frozen")
    l_rec_reg = losses.image_recon_loss(recon, clean_image.detach(), solver.rec_loss_type)
    _, new_z_s = solver.filter_code(nets, z_i_masked, mode="frozen")
    seg_logit_1 = solver.decode(nets, "segmentation_decoder", new_z_s, mode="frozen")
    l_seg_reg = losses.cross_entropy_2d(seg_logit_1, label, weight=solver.class_weights)
    loss = l_rec_reg + l_seg_2 + l_seg_reg
    if solver.spec.has_stn:
        for logit, rec in ((seg_logit, aux.recon_image), (seg_logit_1, recon)):
            refined = solver.recon_shape(nets, logit, is_label_map=False, image=image_n,
                                         recon_image=rec, mode="frozen")
            loss = loss + losses.cross_entropy_2d(refined, label, weight=solver.class_weights)
    metrics["loss/hard/RSC"] = metrics["loss/hard/RSC"] + loss
    return loss


def mixstyle_dsu_branch(solver, cfg, nets, aux, *, clean_image, image_n, label, generator,
                        draws, metrics, use_dsu: bool):
    """MixStyle (hooks 1-3, mix "random") or DSU (hooks 1-6, mix "gaussian")
    feature-style regularization (train_adv…:388-427)."""
    layers, mix = ((1, 2, 3, 4, 5, 6), "gaussian") if use_dsu else ((1, 2, 3), "random")
    aug_z_i, aug_z_s = solver.generate_style_augmented_latent_code(
        nets, image_n, layers_indexes=layers, mix=mix, generator=generator, draws=draws)
    seg_logit = solver.decode(nets, "segmentation_decoder", aug_z_s, mode="frozen")
    loss = losses.cross_entropy_2d(seg_logit, label, weight=solver.class_weights)
    if solver.spec.has_image_recon:
        recon = solver.decode(nets, "image_decoder", aug_z_i, mode="frozen")
        loss = losses.image_recon_loss(recon, clean_image.detach(), solver.rec_loss_type) + loss
    if solver.spec.has_stn:
        refined = solver.recon_shape(nets, seg_logit, is_label_map=False, image=image_n,
                                     recon_image=aux.recon_image, mode="frozen")
        loss = loss + losses.cross_entropy_2d(refined, label, weight=solver.class_weights)
    key = "loss/hard/DSU" if use_dsu else "loss/hard/mix_style"
    metrics[key] = metrics[key] + loss
    return loss


def _kl_to_mean(probs_list, p: torch.Tensor) -> torch.Tensor:
    """F.kl_div(log(mean of the views' probabilities), p), averaged over the
    pixels (train_adv…:303-314); probabilities [N,C,H,W]."""
    mean_log = torch.log(torch.clamp(sum(probs_list) / len(probs_list), 1e-8, 1.0))
    n_pix = p.shape[0] * p.shape[2] * p.shape[3]
    return mesh.share(torch.sum(p * (torch.log(torch.clamp(p, 1e-30, 1.0)) - mean_log)) / n_pix)


def rand_conv_branch(solver, cfg, nets, aux, *, clean_image, image_n, label, generator,
                     draws, metrics):
    """RandConv consistency (train_adv…:289-326): three random-conv views of
    the noisy input, a KL to their mean prediction (weight 10) and their
    reconstruction losses, and with an STN a KL of the refined predictions
    (weight 10) too. ``learning.randconv_view_bn`` "frozen" (default)
    normalizes the views with batch statistics and writes nothing; "train"
    also updates the running statistics after each view, as the reference
    does. Both give the same loss and gradients."""
    lamda = 10.0
    mode = "train" if cfg.learning.randconv_view_bn == "train" else "frozen"
    recs, init_probs, final_probs = [], [], []
    for i in range(N_RANDCONV_VIEWS):
        d = draws[i] if draws is not None else rc.draw_rand_conv(generator, image_n.shape[1])
        aug = rc.rand_conv_augment(image_n, d)
        recon, y0, refined = solver.run(nets, aug, mode=mode, normalize_input=True)
        recs.append(recon)
        init_probs.append(torch.softmax(y0, dim=1))
        final_probs.append(torch.softmax(refined, dim=1))
    loss = torch.zeros((), device=image_n.device)
    for rec, p_init, p_final in zip(recs, init_probs, final_probs):
        l_seg = lamda * _kl_to_mean(init_probs, p_init)
        if solver.spec.has_stn:
            l_seg = l_seg + lamda * _kl_to_mean(final_probs, p_final)
        if rec is not None:
            l_seg = losses.image_recon_loss(rec, clean_image.detach(),
                                            solver.rec_loss_type) + l_seg
        loss = loss + l_seg
    loss = loss / N_RANDCONV_VIEWS
    metrics["loss/hard/rand_conv"] = metrics["loss/hard/rand_conv"] + loss
    return loss


def adv_branch(solver, cfg, nets, aux, *, clean_image, image_n, label, generator, draws,
               metrics, kind: str):
    """AdvNoise / AdvBias (train_adv…:434-530): attack the clean image
    through eval-mode forwards, train on the attacked image as a hard
    example and add the consistency divergence."""
    def forward_eval(x):
        _, z_s = solver.encode_image(nets, x, mode="eval")
        return solver.decode(nets, "segmentation_decoder", z_s, mode="eval")

    p0 = aux.y0.detach()
    if kind == "adv_noise":
        d = (draws if draws is not None
             else advchain.draw_adv_noise(generator, mesh.global_shape(clean_image.shape)))
        adv_image, consistency = advchain.adv_noise_attack(
            forward_eval, clean_image, p0, d, epsilon=0.1, xi=1e-6, n_iter=1,
            if_norm_image=True)
    else:
        downscale = 2 if "ACDC" in cfg.data.dataset_name else 4
        d = (draws if draws is not None
             else advchain.draw_adv_bias(generator, mesh.global_shape(clean_image.shape)))
        adv_image, consistency = advchain.adv_bias_attack(
            forward_eval, clean_image, p0, d, epsilon=0.4, downscale=downscale, n_iter=1,
            if_norm_image=False)
    h_seg, h_rec, h_shape, h_pseg = solver.hard_example_training(
        nets, adv_image, clean_image, label, standard_input_image=image_n.detach(),
        standard_recon_image=aux.recon_image, commit_stats=False)
    loss = h_seg + h_rec + h_shape + h_pseg + consistency
    metrics[f"loss/hard/{kind}"] = metrics[f"loss/hard/{kind}"] + loss
    return loss


def apply_enabled_branches(solver, cfg, nets, aux, *, clean_image, image_n, label,
                           generator, metrics: Dict, draws: Dict | None = None):
    """The sum of the enabled branches' losses (0 without any), in the JAX
    package's order. ``draws`` ({flag: that branch's draws}) pins them."""
    L = cfg.learning
    draws = draws or {}
    total = torch.zeros((), device=clean_image.device)
    kw = dict(clean_image=clean_image, image_n=image_n, label=label, generator=generator,
              metrics=metrics)
    if L.latent_DA:
        total = total + latent_da_branch(solver, cfg, nets, aux,
                                         draws=draws.get("latent_DA"), **kw)
    if L.RSC:
        total = total + rsc_branch(solver, cfg, nets, aux, draws=draws.get("RSC"), **kw)
    if L.mix_style or L.DSU:
        flag = "DSU" if L.DSU else "mix_style"
        total = total + mixstyle_dsu_branch(solver, cfg, nets, aux, draws=draws.get(flag),
                                            use_dsu=bool(L.DSU), **kw)
    if L.rand_conv:
        total = total + rand_conv_branch(solver, cfg, nets, aux,
                                         draws=draws.get("rand_conv"), **kw)
    for kind in ("adv_noise", "adv_bias"):
        if getattr(L, kind):
            total = total + adv_branch(solver, cfg, nets, aux, draws=draws.get(kind),
                                       kind=kind, **kw)
    return total
