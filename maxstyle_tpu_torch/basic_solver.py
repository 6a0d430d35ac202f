"""Plain single-network segmentation solver (the baseline family).

Counterpart of ``maxstyle_tpu/basic_solver.py`` (the reference's
``SegmentationModel``, base_segmentation_model.py:24-331): one network of
the {UNet, FCN, ResConvUNet} zoo, the cross-entropy loss, one optimizer
(Adam by default; SGD takes the reference's StepLR when the epoch's step
count is known), an optional EMA of the weights with the reference's
warm-up decay, and an eval-mode ``predict``. The supervised baseline the
triplet solver supersedes.

At the boundary the layouts are the JAX package's: ``batch["image"]`` is
[N,H,W,1] float, ``batch["label"]`` [N,H,W] int, and ``predict`` returns
[N,H,W,num_classes]. Every entry point runs on the GPU unless the caller
asks for the CPU (``solver.resolve_device``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from maxstyle_tpu_torch import losses
from maxstyle_tpu_torch.models.layers import FixableDropout, dropout_step
from maxstyle_tpu_torch.solver import make_optimizer, resolve_device
from maxstyle_tpu_torch.train_step import draw_dropout_seed
from maxstyle_tpu_torch.utils.ema import ScheduleLR, ema_init, ema_update


def build_network(network_type: str, num_classes: int, encoder_dropout=None,
                  decoder_dropout=None) -> nn.Module:
    """The zoo (base_segmentation_model.get_network:80-140): "UNet_16"/"UNet_64",
    "FCN_16"/"FCN_64", "ResUNet_16"/"ResUNet_64" ("ResConvUNet_..." too);
    ``16`` divides the channel plan by 4."""
    if "16" in network_type:
        scale = 4
    elif "64" in network_type:
        scale = 1
    else:
        raise ValueError(network_type)
    if network_type.startswith("UNet"):
        from maxstyle_tpu_torch.models.unet import UNet
        return UNet(num_classes, feature_reduce=scale, dropout=decoder_dropout)
    if network_type.startswith("FCN"):
        from maxstyle_tpu_torch.models.baselines import FCN
        return FCN(num_classes, feature_scale=scale, dropout=decoder_dropout)
    if network_type.startswith(("ResUNet", "ResConvUNet")):
        from maxstyle_tpu_torch.models.baselines import ResConvUNet
        return ResConvUNet(num_classes, feature_scale=scale, encoder_dropout=encoder_dropout,
                           decoder_dropout=decoder_dropout)
    raise NotImplementedError(network_type)


@dataclasses.dataclass
class BasicState:
    """The network (weights and BatchNorm buffers), its optimizer and
    schedule, the EMA weights ({parameter name: tensor}) when the model
    keeps them, and the step count. The train step updates it in place."""

    network: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[ScheduleLR] = None
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0


class SegmentationModel:
    """Single-network supervised solver."""

    def __init__(self, network_type: str = "UNet_16", num_classes: int = 4,
                 lr: float = 1e-4, optimizer_type: str = "Adam", use_ema: bool = False,
                 ema_decay: float = 0.999, encoder_dropout=None, decoder_dropout=None,
                 class_weights=None, device=None):
        self.network_type = network_type
        self.num_classes = num_classes
        self.lr = lr
        self.optimizer_type = optimizer_type
        self.use_ema = use_ema
        self.ema_decay = ema_decay
        self.encoder_dropout = encoder_dropout
        self.decoder_dropout = decoder_dropout
        self.class_weights = class_weights
        self.device = resolve_device(device)

    def init_state(self, seed: int = 0, state_dict=None,
                   steps_per_epoch: Optional[int] = None) -> BasicState:
        """A network initialised from ``seed`` without touching the global
        random state, or loaded from ``state_dict`` (e.g. from convert.py)."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = build_network(self.network_type, self.num_classes, self.encoder_dropout,
                                self.decoder_dropout)
        if state_dict is not None:
            net.load_state_dict(state_dict, strict=True)
        net = net.to(self.device)
        opt, sched = make_optimizer(self.optimizer_type, net.parameters(), self.lr,
                                    steps_per_epoch)
        ema = ema_init(dict(net.named_parameters())) if self.use_ema else None
        return BasicState(network=net, optimizer=opt, scheduler=sched, ema_params=ema)

    def make_train_step(self):
        """``step(state, batch, generator=None) -> (state, {"loss": loss})``:
        a "train"-mode forward, the cross-entropy loss, one optimizer step
        and the EMA update (decay min(decay, (1+n)/(10+n)) at update n).
        A network with a dropout rate draws one mask a layer from a seed of
        ``generator``."""
        def step(state: BasicState, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None):
            net = state.network
            x = batch["image"].permute(0, 3, 1, 2).float().contiguous()
            label = batch["label"].long()
            state.optimizer.zero_grad(set_to_none=True)
            with contextlib.ExitStack() as stack:
                if any(m.rate for m in net.modules() if isinstance(m, FixableDropout)):
                    stack.enter_context(dropout_step(net, draw_dropout_seed(generator)))
                logits = net(x, "train")
            loss = losses.cross_entropy_2d(logits, label, weight=self.class_weights)
            loss.backward()
            for p in net.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            state.optimizer.step()
            if state.scheduler is not None:
                state.scheduler.step()
            state.step += 1
            if state.ema_params is not None:
                state.ema_params = ema_update(state.ema_params, dict(net.named_parameters()),
                                              self.ema_decay, num_updates=state.step)
            return state, {"loss": loss.detach()}

        return step

    @torch.no_grad()
    def predict(self, state: BasicState, image: torch.Tensor, softmax: bool = False,
                use_ema: bool = False) -> torch.Tensor:
        """Eval-mode logits (or probabilities) [N,H,W,num_classes] of image
        [N,H,W,1], with the EMA weights when ``use_ema`` and the model keeps
        them (the BatchNorm buffers are the network's)."""
        x = image.permute(0, 3, 1, 2).float()
        net = state.network
        if use_ema and state.ema_params is not None:
            tensors = {**dict(net.named_buffers()), **state.ema_params}
            logits = torch.func.functional_call(net, tensors, (x, "eval"))
        else:
            logits = net(x, "eval")
        if softmax:
            logits = torch.softmax(logits, dim=1)
        return logits.permute(0, 2, 3, 1)
