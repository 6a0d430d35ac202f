"""Import reference PyTorch checkpoints into the port's modules.

Counterpart of ``maxstyle_tpu/utils/torch_import.py``. The reference saves
one state dict a module ({image_encoder, image_decoder,
segmentation_decoder, ...}.pth — advanced_triplet…save_model:936-948). The
port's modules are torch modules named after the JAX package's flax
modules (``convert.py``'s naming: flax paths with ``BatchNorm_0`` dropped
and ``ConvTranspose_0`` as ``conv``), so a reference state dict maps onto a
port state dict by renaming alone:

  conv                 ``{name}.weight`` (O,I,kh,kw), ``.bias``   -> same layout
  transposed conv      ``{name}.weight`` (I,O,kh,kw), ``.bias``   -> same layout,
                       not flipped (torch -> torch; the JAX import flips
                       the taps for flax and ``convert.py`` flips them back)
  batchnorm            weight/bias/running_mean/running_var      -> same names;
                       ``num_batches_tracked`` is dropped (the port's
                       ``BatchNorm`` keeps no such buffer)

Every key of the file is either converted or a ``num_batches_tracked``;
anything else raises, and the caller loads the result with ``strict=True``,
so nothing is skipped on either side. The models the port has not ported yet
have no converter: ``convert_module_state_dict`` refuses a domain-specific
encoder, a UNet or UNETR module and the STN's shape modules with
``NotImplementedError``. Their converters arrive with their models.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Mapping, Tuple

import torch

StateDict = Dict[str, torch.Tensor]
NOT_PORTED = "ROADMAP Queue 1 item 7 (the rest of the network_type grammar)"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"importing {what} is not ported yet: its model is {NOT_PORTED}")


class _Reader:
    """A reference state dict that records which keys were read."""

    def __init__(self, sd: Mapping[str, torch.Tensor]):
        self.sd = sd
        self.used: set = set()

    def __contains__(self, key: str) -> bool:
        return key in self.sd

    def __getitem__(self, key: str) -> torch.Tensor:
        self.used.add(key)
        return self.sd[key]

    def unread(self) -> List[str]:
        return sorted(k for k in self.sd
                      if k not in self.used and not k.endswith(".num_batches_tracked"))


def _under(prefix: str, entries: StateDict) -> StateDict:
    return {f"{prefix}.{k}": v for k, v in entries.items()}


def _conv(sd: Mapping, name: str) -> StateDict:
    out = {"weight": sd[f"{name}.weight"]}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def _bn(sd: Mapping, name: str) -> StateDict:
    return {k: sd[f"{name}.{k}"] for k in ("weight", "bias", "running_mean", "running_var")}


def _conv_norm_pair(sd: Mapping, prefix: str) -> StateDict:
    """A Sequential conv(0)-norm(1)-act-conv(3)-norm(4) -> conv1/norm1/conv2/norm2."""
    return {**_under("conv1", _conv(sd, f"{prefix}.0")),
            **_under("norm1", _bn(sd, f"{prefix}.1")),
            **_under("conv2", _conv(sd, f"{prefix}.3")),
            **_under("norm2", _bn(sd, f"{prefix}.4"))}


def convert_res_up(sd: Mapping, prefix: str) -> StateDict:
    """res_up_family block (encoder_decoder.py:289-357): torch children
    up (.weight for Conv2), conv.0/1/3/4, conv_input -> ``layers.ResUp``."""
    out: StateDict = {}
    if f"{prefix}.up.weight" in sd:
        # a ConvTranspose2d: torch's (in, out, kh, kw) taps are the port's as they are
        out.update(_under("up.conv", _conv(sd, f"{prefix}.up")))
    out.update(_conv_norm_pair(sd, f"{prefix}.conv"))
    out.update(_under("conv_input", _conv(sd, f"{prefix}.conv_input")))
    return out


def convert_res_down(sd: Mapping, prefix: str) -> StateDict:
    """res_convdown block (encoder_decoder.py:22-74) -> ``layers.ResConvDown``."""
    return {**_under("down", _conv(sd, f"{prefix}.down")),
            **_conv_norm_pair(sd, f"{prefix}.conv"),
            **_under("conv_input", _conv(sd, f"{prefix}.conv_input"))}


def convert_decoder(sd: Mapping) -> StateDict:
    """MyDecoder (encoder_decoder.py:561-631) with NN or Conv2 up blocks ->
    ``Decoder``."""
    out: StateDict = {}
    for i in range(1, 5):
        out.update(_under(f"up{i}", convert_res_up(sd, f"up{i}")))
    out.update(_under("final_conv", _conv(sd, "final_conv")))
    return out


def convert_encoder(sd: Mapping, prefix: str = "") -> StateDict:
    """MyEncoder (encoder_decoder.py:423-482) -> ``Encoder``."""
    pre = f"{prefix}." if prefix else ""
    out = _under("inc", _conv_norm_pair(sd, f"{pre}inc"))
    for i in range(1, 5):
        out.update(_under(f"down{i}", convert_res_down(sd, f"{pre}down{i}")))
    out.update(_under("final_conv", _conv(sd, f"{pre}final_conv.0")))
    out.update(_under("final_norm", _bn(sd, f"{pre}final_conv.1")))
    return out


def convert_code_decoupler(sd: Mapping, prefix: str = "code_decoupler") -> StateDict:
    """The z_i -> z_s filter (a conv-norm-act-conv-norm Sequential) ->
    ``CodeDecoupler``."""
    return _conv_norm_pair(sd, prefix)


def convert_dual_branch_encoder(sd: Mapping) -> StateDict:
    """Dual_Branch_Encoder (encoder_decoder.py:634-680) -> ``DualBranchEncoder``.
    A domain-specific general encoder (DS_FCN) is recognised by its child
    naming and refused."""
    if "general_encoder.inc_conv_1.weight" in sd:
        raise _not_ported("a domain-specific encoder (DS_FCN)")
    return {**_under("general_encoder", convert_encoder(sd, "general_encoder")),
            **_under("code_decoupler", convert_code_decoupler(sd))}


def load_torch_state_dict(path: str) -> StateDict:
    """A reference ``.pth`` state dict (or the ``model_state`` of a
    checkpoint dict), read to the CPU with ``weights_only=True``: a file
    holding a pickled module rather than tensors is refused."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: not a plain state dict (torch.load(weights_only=True) refused a "
            f"pickled object); save the module's state_dict() instead") from e
    if isinstance(sd, dict) and "model_state" in sd:
        sd = sd["model_state"]
    if not isinstance(sd, dict) or not all(isinstance(v, torch.Tensor) for v in sd.values()):
        raise ValueError(f"{path}: expected a dict of tensors")
    return dict(sd)


def convert_module_state_dict(sd: Mapping[str, torch.Tensor], module_name: str,
                              spec=None) -> StateDict:
    """One module's reference state dict -> the port module's state dict."""
    if spec is not None and getattr(spec, "is_unet", False):
        raise _not_ported(f"the UNet/UNETR module {module_name!r}")
    if module_name in ("shape_encoder", "shape_decoder"):
        raise _not_ported(f"the STN's {module_name}")
    reader = _Reader(sd)
    if module_name == "image_encoder":
        out = convert_dual_branch_encoder(reader)
    elif module_name in ("image_decoder", "segmentation_decoder"):
        out = convert_decoder(reader)
    else:
        raise ValueError(module_name)
    unread = reader.unread()
    if unread:
        raise ValueError(f"{module_name}: the reference keys {unread} have no counterpart")
    return out


def import_module_checkpoint(path: str, module_name: str, spec=None) -> StateDict:
    """A reference ``{module_name}.pth`` -> the port module's state dict."""
    return convert_module_state_dict(load_torch_state_dict(path), module_name, spec)


def import_snapshot(path: str, spec=None) -> Tuple[Dict[str, StateDict], dict]:
    """A reference interrupt snapshot (advanced_triplet…save_snapshots:961-980:
    {network_type, epoch, model_state: {module: sd}, optimizer_state}) ->
    ({module: port state dict}, meta). The optimizer state is not carried
    over, as in the JAX package: training restarts its optimizers."""
    try:
        snap = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path}: not a plain snapshot of state dicts") from e
    state_dicts = {name: convert_module_state_dict(sd, name, spec)
                   for name, sd in snap["model_state"].items()}
    meta = {"epoch": int(snap.get("epoch", 0)),
            "network_type": snap.get("network_type", "")}
    return state_dicts, meta


def import_module_checkpoints(modules: Mapping[str, torch.nn.Module], ckpt_dir: str,
                              spec=None) -> List[str]:
    """Load ``{ckpt_dir}/{name}.pth`` into each module of ``modules`` that has
    one (strictly, on the module's device); a module without a file keeps
    its weights. Returns the names imported."""
    imported = []
    for name, module in modules.items():
        path = os.path.join(ckpt_dir, f"{name}.pth")
        if os.path.exists(path):
            module.load_state_dict(import_module_checkpoint(path, name, spec), strict=True)
            imported.append(name)
    return imported
