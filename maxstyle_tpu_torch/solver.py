"""Triplet reconstruction/segmentation solver — the method layer.

Counterpart of the main-path part of ``maxstyle_tpu/solver.py``. The JAX
package threads (params, batch_stats) through pure functions; here the
modules own their weights and BatchNorm buffers, and the methods take the
module dict ``nets`` and a BatchNorm ``mode`` (see ``models/layers.py``):

  "train"  — batch stats used, running stats updated in place;
  "frozen" — batch stats used, nothing written;
  "eval"   — running stats used.

Tensors are NCHW inside the solver; the train step converts at its
boundary. The MaxStyle op is the fused one of ``ops/maxstyle_kernels.py``
(CUDA kernels on the GPU, their plain versions on the CPU); the plain
autograd op of ``ops/maxstyle.py`` is its reference in the tests. The
method branches' procedures are here too: the MixStyle/DSU encoder replay,
latent-space hard example generation (LSM) and the full forward ``run``.

Every network family of the grammar is served: the STN's shape refinement
(``recon_shape``, the shape losses, ``run`` and ``predict``), DS_FCN's
domain-specific encoder (domain 0 in the standard pass, domain 1, whose
statistics are trained, in the hard-example pass) and the Unet family and
UNETR, whose codes are skip pyramids: lists of five tensors, or the bottom
one of them as ``z_i`` unless the image decoder is a ``UnetDecoder``
(``Unet_im_recon``). UNETR's ViT is built for the config's square crop.
Swin-UNETR's pyramid has six levels; its ``z_i`` is the 1/16 one, and its
trunk's masks are built for the config's square crop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from maxstyle_tpu_torch import losses
from maxstyle_tpu_torch.config import ExperimentConfig, MaxStyleConfig
from maxstyle_tpu_torch.models.encoder_decoder import Decoder, decoder_style_channels
from maxstyle_tpu_torch.models.registry import NetworkSpec, build_modules, parse_network_type
from maxstyle_tpu_torch.ops import latent_masking as lm
from maxstyle_tpu_torch.ops import maxstyle as ms
from maxstyle_tpu_torch.ops.intensity import intensity_norm_fn
from maxstyle_tpu_torch.ops.maxstyle_kernels import apply_maxstyle_kernels
from maxstyle_tpu_torch.parallel import mesh
from maxstyle_tpu_torch.utils.ema import ScheduleLR, make_lr_schedule
from maxstyle_tpu_torch.utils.profiling import span


def resolve_compute_dtype(name: str) -> torch.dtype:
    """``learning.compute_dtype`` as the JAX solver reads it: "bfloat16" and
    "bf16" compute in bf16; "float32", "f32" and "auto" in float32 ("auto"
    picks bf16 only on a TPU)."""
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name in ("float32", "f32", "auto"):
        return torch.float32
    raise ValueError(f"compute_dtype {name}")


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: the GPU unless the caller names one.
    Without a GPU the caller has to ask for the CPU explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass
class TrainState:
    """The modules (weights and BatchNorm buffers), one optimizer per
    module, the learning-rate schedule of each module that has one, and the
    step count. The train step updates it in place."""

    modules: nn.ModuleDict
    optimizers: Dict[str, torch.optim.Optimizer]
    step: int = 0
    schedulers: Dict[str, ScheduleLR] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ForwardAux:
    """Tensors of the standard pass that later branches reuse (a Unet's
    codes are lists of tensors)."""

    z_i: object
    z_s: object
    recon_image: Optional[torch.Tensor]
    y0: torch.Tensor
    p_recon: Optional[torch.Tensor] = None


# the softmax temperature of the STN's input logits (advanced_triplet…:87)
STN_TEMPERATURE = 2.0
# the level of Swin-UNETR's pyramid that its FCN image decoder takes (1/16)
SWIN_IMAGE_LEVEL = 4


def _detach(code):
    """A code, or each tensor of a Unet's pyramid, detached."""
    if isinstance(code, (list, tuple)):
        return [c.detach() for c in code]
    return code.detach()


def _batch_size(code) -> int:
    return (code[0] if isinstance(code, (list, tuple)) else code).shape[0]


def construct_input(segmentation: torch.Tensor, image: Optional[torch.Tensor],
                    num_classes: int, apply_softmax: bool, is_labelmap: bool,
                    temperature: float = 2.0) -> torch.Tensor:
    """The STN's input (NCHW): a label map [N,H,W] one-hot encoded and
    detached, or logits softened by softmax(x / temperature), or the
    segmentation as given; with ``image`` its detached channels follow.
    (The JAX function's label smoothing has no caller in either package.)"""
    if is_labelmap:
        seg = losses.one_hot(segmentation.long(), num_classes).detach()
    elif apply_softmax:
        seg = torch.softmax(segmentation / temperature, dim=1)
    else:
        seg = segmentation
    if image is not None:
        return torch.cat([seg, image.detach()], dim=1)
    return seg


def make_optimizer(optimizer_type: str, params, lr: float,
                   steps_per_epoch: Optional[int] = None, n_epochs: int = 600
                   ) -> Tuple[torch.optim.Optimizer, Optional[ScheduleLR]]:
    """Per-module optimizer with torch-default hyperparameters, and its
    learning-rate schedule or None. AdamW's decay reaches every parameter,
    biases and BatchNorm scales included, as optax.adamw's does. SGD takes
    momentum 0.99 and, when ``steps_per_epoch`` is known, the reference's
    StepLR(5, 0.5) (set_schedulers :1070-1077) on the update count."""
    if optimizer_type == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8), None
    if optimizer_type == "AdamW":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.01), None
    if optimizer_type == "SGD":
        opt = torch.optim.SGD(params, lr=lr, momentum=0.99)
        if not steps_per_epoch:
            return opt, None
        return opt, ScheduleLR(opt, make_lr_schedule("step", lr, lr_decay_epochs=5,
                                                     steps_per_epoch=steps_per_epoch,
                                                     total_epochs=n_epochs))
    raise NotImplementedError(f"optimizer {optimizer_type!r}: Adam, AdamW or SGD, as in the "
                              "JAX package")


def _inner_adam(params, grads, m, v, t: int, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One step of optax.adam on lists of tensors, in place, in optax's
    order: bias-corrected moments, eps outside the sqrt."""
    for p, g, mi, vi in zip(params, grads, m, v):
        mi.mul_(b1).add_((1.0 - b1) * g)
        vi.mul_(b2).add_((1.0 - b2) * (g * g))
        m_hat = mi / (1.0 - b1 ** t)
        v_hat = vi / (1.0 - b2 ** t)
        p.add_(-lr * (m_hat / (torch.sqrt(v_hat) + eps)))


class TripletSegmentationSolver:
    """Static configuration and the training procedures over ``nets``."""

    def __init__(self, config: ExperimentConfig, image_ch: int = 1, device=None):
        self.compute_dtype = resolve_compute_dtype(config.learning.compute_dtype)
        self.config = config
        self.image_ch = image_ch
        self.device = resolve_device(device)
        self.num_classes = config.segmentation_model.num_classes
        self.spec: NetworkSpec = parse_network_type(
            config.segmentation_model.network_type, config.data.intensity_norm_type)
        self.class_weights = config.learning.class_weights
        self.rec_loss_type = config.learning.rec_loss_type

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def build_modules(self, seed: int = 0) -> nn.ModuleDict:
        """Fresh modules, initialised from ``seed`` without touching the
        global random state."""
        L = self.config.learning
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            nets = build_modules(self.spec, image_ch=self.image_ch,
                                 num_classes=self.num_classes,
                                 encoder_dropout=L.encoder_dropout,
                                 decoder_dropout=L.decoder_dropout,
                                 image_size=self.config.crop_hw[0],
                                 dtype=(None if self.compute_dtype == torch.float32
                                        else self.compute_dtype))
        return nets.to(self.device)

    def init_state(self, seed: int = 0, state_dicts: Optional[Dict] = None,
                   steps_per_epoch: Optional[int] = None) -> TrainState:
        """A TrainState with modules from ``seed``, or loaded from
        ``state_dicts`` ({module name: state dict}, e.g. from convert.py).
        ``steps_per_epoch`` gives SGD its StepLR schedule."""
        nets = self.build_modules(seed)
        if state_dicts is not None:
            for name, sd in state_dicts.items():
                nets[name].load_state_dict(sd, strict=True)
        L = self.config.learning
        optimizers, schedulers = {}, {}
        for name in nets:
            optimizers[name], sched = make_optimizer(L.optimizer_type, nets[name].parameters(),
                                                     L.lr, steps_per_epoch, L.n_epochs)
            if sched is not None:
                schedulers[name] = sched
        return TrainState(modules=nets, optimizers=optimizers, schedulers=schedulers)

    # ------------------------------------------------------------------
    # module application
    # ------------------------------------------------------------------

    def _route_codes(self, z, z_s):
        """(z, filtered) -> (z_i, z_s) per the network_type routing. A
        Unet's z_i is the bottom of the pyramid unless its image decoder
        takes the whole pyramid (``Unet_im_recon``); Swin-UNETR's is the
        pyramid's 1/16 level (``SWIN_IMAGE_LEVEL``), its z_s the whole
        pyramid."""
        if self.spec.is_swin_unetr:
            return z[SWIN_IMAGE_LEVEL], z_s
        if self.spec.is_unet:
            z_i = z if "Unet_im_recon" in self.spec.network_type else z[-1]
            return z_i, z_s
        if self.spec.no_filter:
            return z, z
        z_i = z_s if self.spec.share_code else z
        return z_i, z_s

    def encode_image(self, nets, x, *, mode: str, domain_id: int = 0):
        """(z_i, z_s) of image x; ``domain_id`` picks DS_FCN's norms."""
        with span("net/image_encoder"):
            z = nets["image_encoder"].encode(x, mode, domain_id=domain_id)
            return self.filter_code(nets, z, mode=mode)

    def filter_code(self, nets, z, *, mode: str):
        if self.spec.is_swin_unetr:
            return self._route_codes(z, z)
        if self.spec.is_unet:
            z_s = (nets["image_encoder"].filter_code(z, mode) if self.spec.unet_code_filter
                   else z)
            return self._route_codes(z, z_s)
        if self.spec.no_filter:
            return z, z
        z_s = nets["image_encoder"].filter_code(z, mode)
        return self._route_codes(z, z_s)

    def decode(self, nets, name: str, code, *, mode: str, style_fns=None, **extra):
        with span("net/" + name):
            return nets[name](code, mode, style_fns=style_fns, **extra)

    def recon_shape(self, nets, seg, *, is_label_map: bool, image=None, recon_image=None,
                    mode: str, separate_training: Optional[bool] = None):
        """The STN's refinement S' = shape_decoder(shape_encoder(input)) of a
        label map or logits ``seg``, with the image, the reconstruction or
        both beside it by the network type; without an STN, ``seg``. With
        ``separate_training`` logits are detached first."""
        if not self.spec.has_stn:
            return seg
        if separate_training is None:
            separate_training = self.config.learning.separate_training
        if separate_training and not is_label_map:
            seg = seg.detach()
        mode_in = self.spec.shape_input_mode
        if mode_in == "w_image":
            img = image
        elif mode_in == "w_recon_image":
            img = recon_image
        elif mode_in == "w_dual_image":
            img = torch.cat([image, recon_image], dim=1)
        else:
            img = None
        inp = construct_input(seg, img, self.num_classes, apply_softmax=not is_label_map,
                              is_labelmap=is_label_map, temperature=STN_TEMPERATURE)
        code = nets["shape_encoder"](inp, mode)
        return nets["shape_decoder"](code, mode)

    # ------------------------------------------------------------------
    # standard training (advanced_triplet…:731-786)
    # ------------------------------------------------------------------

    def standard_training(self, nets, clean_image, label, perturbed_image, *,
                          mode: str = "train", domain_id: int = 0,
                          compute_gt_recon: bool = True):
        """(seg, recon, gt shape, pred shape) losses of one pass on
        ``perturbed_image`` and the pass's ForwardAux. The STN's gt loss
        refines the label map (only with ``compute_gt_recon``), its pred
        loss the prediction; both are zero without an STN."""
        zero = torch.zeros((), device=clean_image.device)
        z_i, z_s = self.encode_image(nets, perturbed_image, mode=mode, domain_id=domain_id)
        y0 = self.decode(nets, "segmentation_decoder", z_s, mode=mode)
        seg_loss = losses.cross_entropy_2d(y0, label, weight=self.class_weights)
        if self.spec.has_image_recon:
            recon = self.decode(nets, "image_decoder", z_i, mode=mode)
            image_recon_loss = losses.image_recon_loss(recon, clean_image, self.rec_loss_type)
        else:
            recon = None
            image_recon_loss = zero
        gt_shape_loss = pred_shape_loss = zero
        p_recon = y0
        if self.spec.has_stn:
            if compute_gt_recon:
                gt_recon = self.recon_shape(nets, label, is_label_map=True,
                                            image=perturbed_image, recon_image=recon, mode=mode)
                gt_shape_loss = losses.cross_entropy_2d(gt_recon, label,
                                                        weight=self.class_weights)
            p_recon = self.recon_shape(nets, y0, is_label_map=False, image=perturbed_image,
                                       recon_image=recon, mode=mode)
            pred_shape_loss = losses.cross_entropy_2d(p_recon, label, weight=self.class_weights)
        aux = ForwardAux(z_i=z_i, z_s=z_s, recon_image=recon, y0=y0, p_recon=p_recon)
        return (seg_loss, image_recon_loss, gt_shape_loss, pred_shape_loss), aux

    # ------------------------------------------------------------------
    # hard-example training (advanced_triplet…:843-889)
    # ------------------------------------------------------------------

    def hard_example_training(self, nets, perturbed_image, clean_image, label,
                              perturbed_seg=None, standard_input_image=None,
                              standard_recon_image=None, commit_stats: bool = True):
        """Train on a hard example (a stylized, masked-code or attacked
        image); no image gives zero image losses. Returns (seg, recon,
        shape, perturbed-seg shape) losses. BatchNorm is frozen, except for
        DS_FCN, whose pass runs domain 1 in "train" mode, so its statistics
        (and those of every other norm the pass reaches) are updated; with
        ``commit_stats`` False they are not written, as when the JAX step
        drops the statistics a branch's pass returns. With an STN, a
        ``perturbed_seg`` (a masked-code segmentation) adds the refinement
        loss of that segmentation, beside ``standard_input_image`` and
        ``standard_recon_image`` as its images."""
        zero = torch.zeros((), device=clean_image.device)
        if self.spec.num_domains > 1:
            mode, domain_id = ("train" if commit_stats else "frozen"), 1
        else:
            mode, domain_id = "frozen", 0
        seg_loss = recon_loss = shape_loss = zero
        if perturbed_image is not None:
            norm = intensity_norm_fn(self.config.data.intensity_norm_type)
            perturbed_image = norm(perturbed_image).detach()
            (seg_loss, recon_loss, _, shape_loss), _ = self.standard_training(
                nets, clean_image, label, perturbed_image, mode=mode, domain_id=domain_id,
                compute_gt_recon=False)
        perturbed_recon_loss = zero
        if self.spec.has_stn and perturbed_seg is not None:
            p_recon = self.recon_shape(nets, perturbed_seg, is_label_map=False,
                                       image=standard_input_image,
                                       recon_image=standard_recon_image, mode=mode)
            perturbed_recon_loss = losses.basic_loss_fn(p_recon, label,
                                                        loss_type="cross entropy")
        return seg_loss, recon_loss, shape_loss, perturbed_recon_loss

    # ------------------------------------------------------------------
    # MaxStyle generation — the inner adversarial loop
    # (advanced_triplet…:458-571)
    # ------------------------------------------------------------------

    def generate_max_style_image(self, nets, image_code, *, reference_segmentation,
                                 ms_cfg: MaxStyleConfig, generator: torch.Generator,
                                 style_init=None, return_style: bool = False):
        """Stylized reconstruction by adversarial optimisation of the style
        tensors {lmda, gamma_noise, beta_noise} at the decoder hooks.

        Model weights and BatchNorm buffers are constants here: every decode
        is "frozen" and gradients are taken with ``torch.autograd.grad``
        with respect to the style tensors only, so no ``.grad`` accumulates
        on model parameters. The spreads are cached by the first decode and
        then frozen. Inner Adam(lr) follows optax.adam, on gradients
        multiplied by ``learnable_mask``. ``style_init`` = ({idx: params},
        {idx: state}) pins the draws. Returns the detached stylized image
        (and the final style params if ``return_style``). ``image_code`` is
        a Unet's pyramid when the image decoder is a ``UnetDecoder``.
        In a data group the draws, and ``style_init``, are those of the
        global batch; the returned style params are the rank's rows."""
        code = _detach(image_code)
        indexes = tuple(ms_cfg.decoder_layers_indexes)
        if not indexes:
            with torch.no_grad():
                recon = self.decode(nets, "image_decoder", code, mode="frozen")
            return (recon, None) if return_style else recon

        if style_init is not None:
            style_params = {idx: style_init[0][idx] for idx in indexes}
            style_state = {idx: style_init[1][idx] for idx in indexes}
        else:
            chans = decoder_style_channels(self.spec.feature_reduce, self.image_ch)
            style_params, style_state = {}, {}
            for idx in indexes:
                style_params[idx], style_state[idx] = ms.init_maxstyle(
                    generator, mesh.global_batch(_batch_size(code)), chans[idx], ms_cfg)
        # the draws are the global batch's; the rank optimizes its rows
        style_params = {idx: ms.local_params(p) for idx, p in style_params.items()}
        mask = ms.learnable_mask(ms_cfg)

        # the decoder prefix before the first hook sees no style op: compute
        # it once, outside the loop (the FCN Decoder can be split; a
        # UnetDecoder decodes in full)
        min_idx = min(indexes)
        split = min_idx > 0 and isinstance(nets["image_decoder"], Decoder)
        start = code
        if split:
            with torch.no_grad():
                start = self.decode(nets, "image_decoder", code, mode="frozen",
                                    stop_before_hook=min_idx)

        def decode_with_styles(sp, st):
            new_st = dict(st)

            def make_hook(idx):
                def hook(x):
                    out, new_st[idx] = apply_maxstyle_kernels(x, sp[idx], st[idx], ms_cfg)
                    return out
                return hook

            style_fns = {idx: make_hook(idx) for idx in indexes}
            extra = {"start_at_hook": min_idx} if split else {}
            recon = self.decode(nets, "image_decoder", start, mode="frozen",
                                style_fns=style_fns, **extra)
            return recon, new_st

        # the first decode caches the stat spreads
        with torch.no_grad():
            recon, style_state = decode_with_styles(style_params, style_state)

        optimize = any(mask)
        if ms_cfg.n_iter > 0 and optimize:
            leaves = [t.detach().clone() for idx in indexes
                      for t in style_params[idx].tensors()]
            masks = mask * len(indexes)
            m1 = [torch.zeros_like(t) for t in leaves]
            m2 = [torch.zeros_like(t) for t in leaves]

            def as_params(ts):
                return {idx: ms.MaxStyleParams(*ts[3 * i:3 * i + 3])
                        for i, idx in enumerate(indexes)}

            for t in range(1, ms_cfg.n_iter + 1):
                live = [x.detach().requires_grad_(True) for x in leaves]
                with torch.enable_grad():
                    recon_i, _ = decode_with_styles(as_params(live), style_state)
                    _, z_s2 = self.encode_image(nets, recon_i, mode="frozen")
                    pred = self.decode(nets, "segmentation_decoder", z_s2, mode="frozen")
                    total = 0.0
                    for l_w, ltype in zip(ms_cfg.loss_weights, ms_cfg.loss_types):
                        if ltype != "seg":
                            raise ValueError(f"maxstyle loss type {ltype}")
                        total = total + l_w * -losses.basic_loss_fn(
                            pred, reference_segmentation, loss_type="cross entropy",
                            class_weights=self.class_weights)
                    # lmda takes no part without mixing: its gradient is zero
                    with span("inner_grad"):
                        grads = torch.autograd.grad(total, live, allow_unused=True)
                with torch.no_grad(), span("inner_adam"):
                    grads = [torch.zeros_like(x) if g is None else g * k
                             for g, k, x in zip(grads, masks, leaves)]
                    _inner_adam(leaves, grads, m1, m2, t, ms_cfg.lr)
            style_params = as_params(leaves)
            with torch.no_grad():
                recon, _ = decode_with_styles(style_params, style_state)
        recon = recon.detach()
        return (recon, style_params) if return_style else recon

    # ------------------------------------------------------------------
    # MixStyle / DSU encoder replay (advanced_triplet…:632-670)
    # ------------------------------------------------------------------

    def generate_style_augmented_latent_code(self, nets, image, *, layers_indexes=(1, 2, 3),
                                             mix: str = "random",
                                             generator: torch.Generator, draws=None):
        """Replay the encoder on ``image`` with MixStyle/DSU after the chosen
        layers (1 = after the stem, 2..5 = after down1..4, 6 = after the
        final activation) and BatchNorm frozen; returns (z_i, z_s). Each
        hook draws its own numbers from ``generator`` when it runs, unless
        ``draws`` ({hook: draws of ``ms.draw_mixstyle``}) gives them."""
        cfg = ms.MixStyleConfig(mix=mix)

        def make_hook(idx):
            def hook(v):
                d = (draws[idx] if draws is not None
                     else ms.draw_mixstyle(generator, mesh.global_batch(v.shape[0]), v.shape[1],
                                           cfg))
                return ms.apply_mixstyle(v, cfg, d)
            return hook

        style_fns = {i: make_hook(i) for i in layers_indexes}
        z = nets["image_encoder"].encode(image.detach(), "frozen", style_fns)
        return self.filter_code(nets, z, mode="frozen")

    # ------------------------------------------------------------------
    # latent-space hard example generation (LSM; advanced_triplet…:788-841)
    # ------------------------------------------------------------------

    def hard_example_generation(self, nets, clean_image, label, z_i, z_s, *, lda_cfg,
                                generator: torch.Generator, draws=None):
        """Mask z_i by its gradient probe and decode a corrupted image, and
        with an STN mask z_s and decode a corrupted segmentation, with
        frozen BatchNorm. Returns (perturbed image, perturbed segmentation),
        each None when the config masks no such code; ``draws`` ({"image":
        ..., "shape": ...}, draws of ``lm.draw_masking``) pins the masking's
        draws.

        The segmentation's decode keeps its graph to the segmentation
        decoder's weights, as in the JAX package. It reaches a loss only
        through the STN's refinement (``hard_example_training``), so
        without an STN the port skips that probe and decode, which the JAX
        package computes and drops."""
        perturbed_image = perturbed_seg = None
        if lda_cfg.mask_image_code and self.spec.has_image_recon:
            c = lda_cfg.image_code
            code = z_i.detach()
            d = (draws["image"] if draws is not None else
                 lm.draw_masking(generator, mesh.global_shape(code.shape), c.mask_type,
                                 c.max_threshold))

            def dec_img(v):
                return self.decode(nets, "image_decoder", v, mode="frozen")

            masked, _ = lm.perturb_latent_code(
                code, dec_img, clean_image.detach(), num_classes=self.num_classes, draws=d,
                perturb_type=c.mask_type, threshold=c.max_threshold, if_soft=c.if_soft,
                random_threshold=c.random_threshold, loss_type=c.loss_name, if_detach=True)
            with torch.no_grad():
                perturbed_image = self.decode(nets, "image_decoder", masked, mode="frozen")
        if lda_cfg.mask_shape_code and self.spec.has_stn:
            c = lda_cfg.shape_code
            code = z_s.detach()
            d = (draws["shape"] if draws is not None else
                 lm.draw_masking(generator, mesh.global_shape(code.shape), c.mask_type,
                                 c.max_threshold))

            def dec_seg(v):
                return self.decode(nets, "segmentation_decoder", v, mode="frozen")

            masked, _ = lm.perturb_latent_code(
                code, dec_seg, label, num_classes=self.num_classes, draws=d,
                perturb_type=c.mask_type, threshold=c.max_threshold, if_soft=c.if_soft,
                random_threshold=c.random_threshold, loss_type=c.loss_name, if_detach=True)
            perturbed_seg = self.decode(nets, "segmentation_decoder", masked.detach(),
                                        mode="frozen")
        return perturbed_image, perturbed_seg

    # ------------------------------------------------------------------
    # full forward (advanced_triplet…run:310-328)
    # ------------------------------------------------------------------

    def run(self, nets, image, *, mode: str = "train", normalize_input: bool = False):
        """(recon_image or None, init_predict, refined_predict) of image
        [N,C,H,W]; the STN refines the prediction, and without one the
        refined prediction is the initial one."""
        if normalize_input:
            image = intensity_norm_fn(self.config.data.intensity_norm_type)(image)
        z_i, z_s = self.encode_image(nets, image, mode=mode)
        y0 = self.decode(nets, "segmentation_decoder", z_s, mode=mode)
        recon = None
        if self.spec.has_image_recon:
            recon = self.decode(nets, "image_decoder", z_i, mode=mode)
        refined = self.recon_shape(nets, y0, is_label_map=False, image=image,
                                   recon_image=recon, mode=mode)
        return recon, y0, refined

    # ------------------------------------------------------------------
    # inference (advanced_triplet…:673-691)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def predict(self, nets, image, *, softmax: bool = False, n_iter: int = 1,
                normalize_input: bool = True):
        """Eval-mode forward of image [N,H,W,C] -> logits (or probabilities)
        [N,H,W,num_classes] in the compute dtype: the segmentation decoder's,
        or with an STN and ``n_iter`` > 1 its refinement (logits not
        detached first)."""
        x = image.permute(0, 3, 1, 2).float()
        if normalize_input:
            x = intensity_norm_fn(self.config.data.intensity_norm_type)(x)
        z_i, z_s = self.encode_image(nets, x, mode="eval")
        pred = self.decode(nets, "segmentation_decoder", z_s, mode="eval")
        if self.spec.has_stn and n_iter > 1:
            recon = None
            if self.spec.has_image_recon:
                recon = self.decode(nets, "image_decoder", z_i, mode="eval")
            pred = self.recon_shape(nets, pred, is_label_map=False, image=x, recon_image=recon,
                                    mode="eval", separate_training=False)
        if softmax:
            pred = torch.softmax(pred, dim=1)
        return pred.permute(0, 2, 3, 1)
