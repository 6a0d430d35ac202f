"""One training step of the triplet solver in plain PyTorch.

The step of MaxStyle (Chen et al., MICCAI 2022) and of standard training,
as the configuration and the job state them, on a flat parameter table
(``nets.Params``), from the raw padded slices and the draws the benchmark
hands to both sides:

1. the batch: each raw slice augmented (``augment.py``) beside its
   centre-cropped original, [augmented | originals];
2. input noise: clean + 0.05 N(0, 1), clamped to the clean batch's range;
3. standard pass on the noisy input: cross entropy of the segmentation,
   half the mean squared error of the reconstruction against the clean
   batch;
4. with MaxStyle, style generation on the detached image code: the image
   decoder up to the first style hook once, then style at each hook
   (instance statistics mixed with a permuted partner's by lmda, noise on
   them scaled by the batch's spread of the statistics, gated), a first
   decode that fixes the spreads, ``n_iter`` steps of Adam (optax's form)
   on the style tensors that raise the cross entropy of the stylized
   image's segmentation, and a last decode; then the hard-example pass on
   the min-max of the stylized image;
5. the gradient of the summed losses and one AdamW step (torch's form,
   decay on every tensor) of every parameter.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench.reference import augment as A
from perfbench.reference import nets as N


def cross_entropy(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=1)
    return -torch.gather(logp, 1, label[:, None]).mean()


def recon_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return 0.5 * ((pred - target.detach()) ** 2).mean()


def rescale(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(dim=(2, 3), keepdim=True)
    hi = x.amax(dim=(2, 3), keepdim=True)
    return (x - lo) / (hi - lo + 1e-20)


# ---------------------------------------------------------------------------
# MaxStyle
# ---------------------------------------------------------------------------


def style_op(x, p: Dict[str, torch.Tensor], s: Dict[str, torch.Tensor], eps: float):
    """The style map at one hook. ``p``: lmda [B,1,1,1], gamma_noise and
    beta_noise [B,C,1,1]; ``s``: perm [B], gate [], and the spreads
    gamma_std / beta_std [1,C,1,1], filled (in place of the dict entry) by
    the first call from this batch's statistics."""
    xd = x.detach()
    hw = x.shape[2] * x.shape[3]
    mu = xd.mean(dim=(2, 3), keepdim=True)
    var = ((xd - mu) ** 2).sum(dim=(2, 3), keepdim=True) / (hw - 1)
    sig = torch.sqrt(var + eps)
    if "gamma_std" not in s:
        s["gamma_std"] = sig.std(dim=0, keepdim=True)
        s["beta_std"] = mu.std(dim=0, keepdim=True)
    lm = p["lmda"].clamp(0.0, 1.0)
    perm = s["perm"]
    sig_mix = sig * (1 - lm) + sig[perm] * lm
    mu_mix = mu * (1 - lm) + mu[perm] * lm
    out = ((sig_mix + p["gamma_noise"] * s["gamma_std"]) * (x - mu) / sig
           + mu_mix + p["beta_noise"] * s["beta_std"])
    return s["gate"] * out + (1 - s["gate"]) * x


def max_style_image(net: N.Net, P, z_i, label, init, ms: dict):
    """The stylized reconstruction (detached). ``init``: {hook: (params,
    state)} as the benchmark drew them."""
    hooks = sorted(int(k) for k in ms["decoder_layers_indexes"])
    eps = ms.get("eps", 1e-6)
    code = z_i.detach()
    with torch.no_grad():
        start = net.decode_image(P, code, stop_before=hooks[0])
    states = {h: dict(init[h][1]) for h in hooks}
    leaves = [init[h][0][k].clone() for h in hooks for k in ("lmda", "gamma_noise", "beta_noise")]

    def decode(ts):
        params = {h: dict(zip(("lmda", "gamma_noise", "beta_noise"), ts[3 * i:3 * i + 3]))
                  for i, h in enumerate(hooks)}
        fns = {h: (lambda x, h=h: style_op(x, params[h], states[h], eps)) for h in hooks}
        return net.decode_image(P, start, style_fns=fns, start=hooks[0])

    with torch.no_grad():
        decode(leaves)  # fixes the spreads
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    b1, b2, lr = 0.9, 0.999, ms["lr"]
    for t in range(1, ms["n_iter"] + 1):
        live = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            _, z_s = net.encode(P, decode(live))
            loss = sum(-w * cross_entropy(net.segment(P, z_s), label)
                       for w in ms["loss_weights"])
            grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            for x, g, mi, vi in zip(leaves, grads, m, v):
                mi.mul_(b1).add_((1 - b1) * g)
                vi.mul_(b2).add_((1 - b2) * g * g)
                x.add_(-lr * (mi / (1 - b1 ** t)) / (torch.sqrt(vi / (1 - b2 ** t)) + 1e-8))
    with torch.no_grad():
        return decode(leaves).detach()


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def make_batch(raw_images, raw_labels, aug_draws, pol, pad_hw, crop_hw, keep_orig=True):
    img, lab = A.augment(raw_images, raw_labels, aug_draws, pol, pad_hw, crop_hw)
    if keep_orig:
        oi, ol = A.center_crop(raw_images, raw_labels, crop_hw)
        img, lab = torch.cat([img, oi]), torch.cat([lab, ol])
    return img, lab


def noisy_input(clean: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    return torch.clamp(clean + 0.05 * noise, clean.min(), clean.max())


def losses(net: N.Net, P, clean, label, image_n, style_init, ms: Optional[dict]):
    """(total loss, its parts) of one step's passes."""
    z_i, z_s = net.encode(P, image_n)
    seg = cross_entropy(net.segment(P, z_s), label)
    rec_img = net.decode_image(P, z_i)
    rec = recon_loss(rec_img, clean)
    parts = {"standard/seg": seg, "standard/image": rec}
    total = seg + rec
    if ms is not None:
        stylized = max_style_image(net, P, z_i, label, style_init, ms)
        hard_in = rescale(stylized).detach()
        hz_i, hz_s = net.encode(P, hard_in)
        h_seg = cross_entropy(net.segment(P, hz_s), label)
        h_rec = recon_loss(net.decode_image(P, hz_i), clean)
        parts.update({"hard/seg": h_seg, "hard/image": h_rec})
        total = total + h_rec + h_seg
    return total, parts


class AdamW:
    """torch.optim.AdamW's update (decoupled decay, bias-corrected moments,
    eps outside the square root) over a dict of tensors."""

    def __init__(self, names: List[str], lr: float, wd: float = 0.01,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.names, self.lr, self.wd, self.b1, self.b2, self.eps = names, lr, wd, b1, b2, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        self.t += 1
        for k in self.names:
            p, g = params[k], grads[k]
            m = self.m.setdefault(k, torch.zeros_like(p))
            v = self.v.setdefault(k, torch.zeros_like(p))
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            denom = torch.sqrt(v) / (1 - self.b2 ** self.t) ** 0.5 + self.eps
            p.add_(-(self.lr / (1 - self.b1 ** self.t)) * m / denom)


def train_steps(net: N.Net, tensors: Dict[str, torch.Tensor], steps: List[dict], job: dict,
                pol: dict, pad_hw, crop_hw, dtype=torch.float32, half_batch: bool = False):
    """Run ``steps`` (each {"image", "label": raw [n,H,W], "aug_draws",
    "noise": [N,1,h,w], "style_init"}) from the weights ``tensors`` (updated
    in place). Returns each step's total loss, standard-pass loss and its
    segmentation and image parts, the first step's gradient norm by
    parameter, and the parameters after the last step.

    ``dtype`` runs the passes in that dtype: float64 for the check, one
    below float32 for a control (the augmentation and the input noise stay
    float32, as the program makes them); the update runs in the weights'
    dtype. ``half_batch`` leaves out the second half of each batch (a
    fault)."""
    names = [k for k in tensors if not N.is_buffer(k)]
    opt = AdamW(names, job["lr"])
    ms = job.get("max_style")
    out = {"loss": [], "std_loss": [], "std_parts": [], "grad_norm": None}
    for st in steps:
        img, lab = make_batch(st["image"], st["label"], st["aug_draws"], pol, pad_hw, crop_hw)
        image_n = noisy_input(img, st["noise"])
        init = st.get("style_init")
        if half_batch:
            n = img.shape[0] // 2
            img, lab, image_n = img[:n], lab[:n], image_n[:n]
            if init is not None:
                init = {h: ({k: t[:n] for k, t in p.items()},
                            {**s, "perm": torch.remainder(s["perm"][:n], n)})
                        for h, (p, s) in init.items()}
        live = {k: tensors[k].detach().to(dtype).requires_grad_(k in names) for k in tensors}
        P = N.Params(live)
        total, parts = losses(net, P, img.to(dtype), lab, image_n.to(dtype),
                              _cast_init(init, dtype), ms)
        out["std_loss"].append(float((parts["standard/seg"] + parts["standard/image"]).detach()))
        out["std_parts"].append([float(parts["standard/seg"].detach()),
                                 float(parts["standard/image"].detach())])
        grads = dict(zip(names, torch.autograd.grad(total, [live[k] for k in names])))
        grads = {k: g.to(tensors[k].dtype) for k, g in grads.items()}
        if out["grad_norm"] is None:
            out["grad_norm"] = {k: float(g.norm()) for k, g in grads.items()}
        opt.step(tensors, grads)
        out["loss"].append(float(total.detach()))
        del live, P, total, parts, grads
    out["params"] = {k: tensors[k] for k in names}
    return out


def _cast_init(init, dtype):
    if init is None:
        return None
    return {h: ({k: t.to(dtype) for k, t in p.items()},
                {k: (t.to(dtype) if t.is_floating_point() else t) for k, t in s.items()})
            for h, (p, s) in init.items()}


def flop_step(net: N.Net, specs: Dict[str, tuple], job: dict, batch: int, crop: int,
              device="meta"):
    """The passes of one step on ``device`` tensors of the cell's shapes,
    for counting their operations: forward, style generation and backward."""
    P = N.Params({k: torch.empty(shape, device=device).requires_grad_(not N.is_buffer(k))
                  for k, (shape, _) in specs.items()})
    img = torch.empty((batch, 1, crop, crop), device=device)
    lab = torch.zeros((batch, crop, crop), dtype=torch.long, device=device)
    init = None
    ms = job.get("max_style")
    if ms is not None:
        init = {}
        for h in ms["decoder_layers_indexes"]:
            c = ms["hook_channels"][str(h)]
            init[int(h)] = ({"lmda": torch.zeros((batch, 1, 1, 1), device=device),
                             "gamma_noise": torch.zeros((batch, c, 1, 1), device=device),
                             "beta_noise": torch.zeros((batch, c, 1, 1), device=device)},
                            {"perm": torch.zeros((batch,), dtype=torch.long, device=device),
                             "gate": torch.zeros((), device=device)})
    total, _ = losses(net, P, img, lab, img, init, ms)
    params = [t for k, t in P.tensors.items() if not N.is_buffer(k)]
    torch.autograd.grad(total, params)


