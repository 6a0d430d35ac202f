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

  spectral-norm conv   ``{name}.weight_orig``, ``.weight_u``,     -> ``weight``, ``u``, ``v``
                       ``.weight_v``, ``.bias``                      and ``bias``
  domain-specific BN   ``{name}.bns.{d}.*``                       -> ``bn_domain{d}.*``

Converters: the FCN family's encoder (plain or domain-specific, DS_FCN),
code decoupler and decoders, the STN's shape encoder and decoder (a plain
encoder and an NN decoder), the Unet family's encoder (with its per-level
code filters) and decoder, the baseline zoo's FCN (``convert_fcn``), and
UNETR's ViT trunk from a MONAI ViT state dict (``convert_unetr_vit``, with
the fused qkv's columns put in the port's head-major order).
Every key of the file is either converted or a ``num_batches_tracked``;
anything else raises, and the caller loads the result with ``strict=True``,
so nothing is skipped on either side. A whole reference UNETR module is
refused with ``ValueError``: the JAX package has no importer for one either
(its ``convert_module_state_dict`` sends a UNETR encoder to the Unet
encoder's converter, which cannot read it). A Swin-UNETR module is refused
too: the reference has no such network.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Mapping, Tuple

import torch

StateDict = Dict[str, torch.Tensor]


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

    def keys(self):
        return self.sd.keys()

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


def _ds_bn(sd: Mapping, name: str, num_domains: int) -> StateDict:
    """DomainSpecificBatchNorm2d (custom_layers.py:69-104): children
    ``bns.{d}`` -> ``layers.DomainSpecificNorm2d``'s ``bn_domain{d}``."""
    out: StateDict = {}
    for d in range(num_domains):
        out.update(_under(f"bn_domain{d}", _bn(sd, f"{name}.bns.{d}")))
    return out


def _sn_conv(sd: Mapping, name: str) -> StateDict:
    """A spectral_norm'd conv: weight_orig and the power iteration's
    weight_u / weight_v -> ``layers.TorchSNConv3x3``'s weight, u and v."""
    out = {"weight": sd[f"{name}.weight_orig"], "u": sd[f"{name}.weight_u"],
           "v": sd[f"{name}.weight_v"]}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def convert_ds_res_down(sd: Mapping, prefix: str, num_domains: int) -> StateDict:
    """ds_res_convdown (encoder_decoder.py:360-420): children down, conv_1
    (spectral-normed in both of the reference's branches), norm_1, conv_2,
    norm_2, conv_input -> ``layers.ResConvDown`` with domain-specific norms."""
    return {**_under("down", _conv(sd, f"{prefix}.down")),
            **_under("conv1", _sn_conv(sd, f"{prefix}.conv_1")),
            **_under("norm1", _ds_bn(sd, f"{prefix}.norm_1", num_domains)),
            **_under("conv2", _conv(sd, f"{prefix}.conv_2")),
            **_under("norm2", _ds_bn(sd, f"{prefix}.norm_2", num_domains)),
            **_under("conv_input", _conv(sd, f"{prefix}.conv_input"))}


def convert_ds_encoder(sd: Mapping, prefix: str, num_domains: int) -> StateDict:
    """DomainSpecificEncoder (encoder_decoder.py:485-558) -> ``Encoder`` with
    ``num_domains`` > 1: stem convs inc_conv_1/2 with norm_1/2, a bare
    final_conv and a domain-specific final_norm."""
    pre = f"{prefix}." if prefix else ""
    out = {**_under("inc.conv1", _conv(sd, f"{pre}inc_conv_1")),
           **_under("inc.norm1", _ds_bn(sd, f"{pre}norm_1", num_domains)),
           **_under("inc.conv2", _conv(sd, f"{pre}inc_conv_2")),
           **_under("inc.norm2", _ds_bn(sd, f"{pre}norm_2", num_domains))}
    for i in range(1, 5):
        out.update(_under(f"down{i}", convert_ds_res_down(sd, f"{pre}down{i}", num_domains)))
    out.update(_under("final_conv", _conv(sd, f"{pre}final_conv")))
    out.update(_under("final_norm", _ds_bn(sd, f"{pre}final_norm", num_domains)))
    return out


def convert_dual_branch_encoder(sd: Mapping) -> StateDict:
    """Dual_Branch_Encoder (encoder_decoder.py:634-680) -> ``DualBranchEncoder``.
    A domain-specific general encoder (DS_FCN) is recognised by its child
    naming, and its domain count by its ``bns.{d}`` keys."""
    if "general_encoder.inc_conv_1.weight" in sd:
        nd = 1 + max(int(k.split(".bns.")[1].split(".")[0]) for k in sd.keys() if ".bns." in k)
        encoder = convert_ds_encoder(sd, "general_encoder", nd)
    else:
        encoder = convert_encoder(sd, "general_encoder")
    return {**_under("general_encoder", encoder),
            **_under("code_decoupler", convert_code_decoupler(sd))}


def convert_unet_encoder(sd: Mapping) -> StateDict:
    """segmentation_models.UnetEncoder (unet.py:15-63): double convs
    inc.conv.conv and down{i}.mpconv.1.conv, and the optional per-level
    code_filter_{i}.code_decoupler -> ``UnetEncoder`` (``code_filters_{i-1}``)."""
    out = _under("inc", _conv_norm_pair(sd, "inc.conv.conv"))
    for i in range(1, 5):
        out.update(_under(f"down{i}.conv", _conv_norm_pair(sd, f"down{i}.mpconv.1.conv")))
    if "code_filter_1.code_decoupler.0.weight" in sd:
        for i in range(1, 6):
            out.update(_under(f"code_filters_{i - 1}",
                              _conv_norm_pair(sd, f"code_filter_{i}.code_decoupler")))
    return out


def convert_unet_decoder(sd: Mapping) -> StateDict:
    """segmentation_models.UnetDecoder (unet.py:65-136): double convs
    up{i}.conv.conv, the Conv2 ups up{i}.up (a ConvTranspose2d, taps as
    they are), outc.conv -> ``UnetDecoder``."""
    out: StateDict = {}
    for i in range(1, 5):
        if f"up{i}.up.weight" in sd:
            out.update(_under(f"up{i}.up", _conv(sd, f"up{i}.up")))
        out.update(_under(f"up{i}.conv", _conv_norm_pair(sd, f"up{i}.conv.conv")))
    out.update(_under("outc", _conv(sd, "outc.conv")))
    return out


# the reference FCN's conv2DBatchNormRelu units in the port's ConvBNRelu_{i}
# order (flax's construction order: conv1_2 is built before conv1_1)
FCN_UNITS = ("conv1_2", "conv1_1", "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv3_3",
             "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2", "conv5_3",
             "level_1_out", "level_2_out", "level_3_out", "level_4_out", "level_5_out",
             "aggregate_layers", "conv_final")


def _convert_fcn(sd: Mapping) -> StateDict:
    out: StateDict = {}
    for i, name in enumerate(FCN_UNITS):
        out.update(_under(f"ConvBNRelu_{i}.Conv_0", _conv(sd, f"{name}.cbr_unit.0")))
        out.update(_under(f"ConvBNRelu_{i}.Norm2d_0", _bn(sd, f"{name}.cbr_unit.1")))
    out.update(_under("outS", _conv(sd, "outS")))
    return out


def _linear(sd: Mapping, name: str) -> StateDict:
    """nn.Linear -> the port's nn.Linear: the same layout."""
    return _conv(sd, name)


def _layernorm(sd: Mapping, name: str) -> StateDict:
    return {k: sd[f"{name}.{k}"] for k in ("weight", "bias")}


def _qkv_to_head_major(weight: torch.Tensor, num_heads: int) -> torch.Tensor:
    """A fused qkv Linear's weight [3*H, H] with MONAI's (qkv, head, dim)
    output rows (its ``b h (qkv l d)`` rearrange) -> the port's head-major
    (head, qkv, dim) rows (``models/unetr.SelfAttention``)."""
    d = weight.shape[0] // (3 * num_heads)
    w = weight.reshape((3, num_heads, d) + tuple(weight.shape[1:]))
    return w.transpose(0, 1).reshape(weight.shape).contiguous()


def _convert_unetr_vit(sd: Mapping, num_layers: int, num_heads: int) -> StateDict:
    out: StateDict = {
        **_under("patch_embed", _conv(sd, "patch_embedding.patch_embeddings")),
        "pos_embedding": sd["patch_embedding.position_embeddings"],
        **_under("norm", _layernorm(sd, "norm")),
    }
    for i in range(num_layers):
        p = f"blocks.{i}"
        out.update(_under(f"block{i}", {
            **_under("norm1", _layernorm(sd, f"{p}.norm1")),
            **_under("norm2", _layernorm(sd, f"{p}.norm2")),
            "attn.qkv.weight": _qkv_to_head_major(sd[f"{p}.attn.qkv.weight"], num_heads),
            **_under("attn.out_proj", _linear(sd, f"{p}.attn.out_proj")),
            **_under("linear1", _linear(sd, f"{p}.mlp.linear1")),
            **_under("linear2", _linear(sd, f"{p}.mlp.linear2")),
        }))
    return out


def convert_unetr_vit(sd: Mapping[str, torch.Tensor], num_layers: int = 12,
                      num_heads: int = 12) -> StateDict:
    """A MONAI ViT state dict (monai/networks/nets/vit.py with its blocks:
    ``patch_embedding.patch_embeddings`` (conv), ``patch_embedding.
    position_embeddings``, ``blocks.{i}.{norm1, attn.qkv, attn.out_proj,
    norm2, mlp.linear1, mlp.linear2}``, the trailing ``norm``) -> the state
    dict of ``models/unetr.ViT``. The qkv Linear has no bias (MONAI's
    default); a key the ViT has no counterpart for raises."""
    return _strict(lambda r: _convert_unetr_vit(r, num_layers, num_heads), sd, "UNETR ViT")


def _strict(convert, sd: Mapping[str, torch.Tensor], what: str) -> StateDict:
    """``convert(sd)``, refusing a key of ``sd`` that it did not read."""
    reader = _Reader(sd)
    out = convert(reader)
    unread = reader.unread()
    if unread:
        raise ValueError(f"{what}: the reference keys {unread} have no counterpart")
    return out


def convert_fcn(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """The baseline zoo's Bai-style FCN (segmentation_models/fcn.py:13-113;
    'FCN_16'/'FCN_64' of ``basic_solver.build_network``) -> ``baselines.FCN``."""
    return _strict(_convert_fcn, sd, "FCN")


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
    """One module's reference state dict -> the port module's state dict,
    by the module's name and the network's spec (a Unet's encoder and
    decoders, and the image decoder of ``Unet_im_recon`` types, are the
    UNet's). A UNETR or Swin-UNETR network's modules raise ``ValueError``."""
    is_unet = spec is not None and getattr(spec, "is_unet", False)
    if spec is not None and getattr(spec, "is_swin_unetr", False):
        raise ValueError(
            f"{module_name!r} of {spec.network_type}: the reference has no Swin-UNETR "
            "network, so there is no .pth checkpoint of it to import")
    if spec is not None and getattr(spec, "is_transformer", False):
        raise ValueError(
            f"{module_name!r} of {spec.network_type}: the JAX package has no importer for a "
            "reference UNETR checkpoint, and neither has the port; convert_unetr_vit "
            "imports a MONAI ViT state dict into the UNETR encoder's ViT (image_encoder.vit)")
    if module_name == "image_encoder":
        convert = convert_unet_encoder if is_unet else convert_dual_branch_encoder
    elif module_name == "segmentation_decoder":
        convert = convert_unet_decoder if is_unet else convert_decoder
    elif module_name == "image_decoder":
        unet_recon = is_unet and "Unet_im_recon" in getattr(spec, "network_type", "")
        convert = convert_unet_decoder if unet_recon else convert_decoder
    elif module_name == "shape_encoder":
        convert = convert_encoder
    elif module_name == "shape_decoder":
        convert = convert_decoder
    else:
        raise ValueError(module_name)
    return _strict(convert, sd, module_name)


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
