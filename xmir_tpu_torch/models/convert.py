"""Weights into the port's DenseNet, ConvNeXtV2, SwinV2 and ViT embedders, the
distillation models and the NIH dual-head models: from the JAX package's
variable tree, and from a reference CheXNet / torchvision or timm ``.pt``.

Conventions (the inverse of xmir_tpu/models/convert.py):
  conv   flax (kh, kw, I, O)  -> torch (O, I, kh, kw)
  dense  flax (I, O)          -> torch (O, I)
  batchnorm params scale/bias -> weight/bias; batch_stats mean/var ->
  running_mean/running_var
  layernorm scale/bias        -> weight/bias
  ViT qkv   flax (C, 3C), columns q | k | v with the heads inside each ->
  torch (3C, C), rows in the same order (timm's ``qkv.weight``)
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

BACKBONE_PREFIX = "densenet121.0."
CONVNEXT_PREFIX = "convnext."
VIT_PREFIX = "backbone."
SWIN_PREFIX = "backbone."
# timm's SwinV2 buffers: recomputed by the port from the map's size
_SWIN_BUFFERS = ("relative_coords_table", "relative_position_index", "attn_mask")
# wrappers the reference's checkpoints put around the torchvision features
# (xmir_tpu/models/convert.py::convert_densenet121)
_TORCH_PREFIXES = ("densenet121.0.", "densenet121.features.", "features.")
# wrappers around a timm backbone in checkpoints (xmir_tpu/cli/common.py:154-165)
_TIMM_PREFIXES = ("convnext.", "swinv2.", "backbone.", "model.")


def _conv(k):
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _dense(sd, name, p):
    sd[f"{name}.weight"] = np.transpose(np.asarray(p["kernel"]))
    if "bias" in p:
        sd[f"{name}.bias"] = np.asarray(p["bias"])


def _bn(sd, name, p, s):
    sd[f"{name}.weight"] = np.asarray(p["scale"])
    sd[f"{name}.bias"] = np.asarray(p["bias"])
    sd[f"{name}.running_mean"] = np.asarray(s["mean"])
    sd[f"{name}.running_var"] = np.asarray(s["var"])


def _numbered(tree, stem):
    """Sorted indices i of the keys f"{stem}{i}" in a variable tree."""
    return sorted(int(m.group(1)) for key in tree
                  if (m := re.fullmatch(rf"{stem}(\d+)", key)))


def _backbone_state_dict(params, stats, prefix: str) -> Dict[str, np.ndarray]:
    sd = {f"{prefix}conv0.weight": _conv(params["conv0"]["kernel"])}
    _bn(sd, f"{prefix}norm0", params["norm0"], stats["norm0"])
    for b in _numbered(params, "denseblock"):
        block, bstats = params[f"denseblock{b}"], stats[f"denseblock{b}"]
        for li in _numbered(block, "denselayer"):
            lname = f"denseblock{b}.denselayer{li}"
            lp, ls = block[f"denselayer{li}"], bstats[f"denselayer{li}"]
            for norm, conv in (("norm1", "conv1"), ("norm2", "conv2")):
                _bn(sd, f"{prefix}{lname}.{norm}", lp[norm], ls[norm])
                sd[f"{prefix}{lname}.{conv}.weight"] = _conv(lp[conv]["kernel"])
        tname = f"transition{b}"
        if tname in params:
            _bn(sd, f"{prefix}{tname}.norm", params[tname]["norm"], stats[tname]["norm"])
            sd[f"{prefix}{tname}.conv.weight"] = _conv(params[tname]["conv"]["kernel"])
    _bn(sd, f"{prefix}norm5", params["norm5"], stats["norm5"])
    return sd


def densenet_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's {"params", "batch_stats"} tree (numpy leaves) ->
    the port's state dict, for any ``block_config``.

    A DenseNet121Embedder tree (params["backbone"], optional "fc" and
    "classification_head") gives DenseNet121Embedder keys; a bare
    DenseNetBackbone tree gives DenseNetBackbone keys."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if "backbone" not in params:
        sd = _backbone_state_dict(params, stats, "")
    else:
        sd = _backbone_state_dict(params["backbone"], stats["backbone"], BACKBONE_PREFIX)
        for head in ("fc", "classification_head"):
            if head in params:
                _dense(sd, head, params[head])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def embedder_state_dict_from_torch(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference CheXNet / torchvision DenseNet121 state dict ->
    DenseNet121Embedder keys.

    Accepts the ``features.*``, ``densenet121.features.*`` and
    ``densenet121.0.*`` layouts and a ``module.`` DataParallel prefix, and
    drops torchvision's ``num_batches_tracked`` counters (training state,
    unused in eval) and its ``classifier``, which the reference strips too
    (model.py:53-63)."""
    out = {}
    for key, value in sd.items():
        key = key.replace("module.", "")
        if key.endswith("num_batches_tracked") or key.startswith(
                ("classifier.", "densenet121.classifier.")):
            continue
        if key.startswith(("fc.", "classification_head.")):
            out[key] = value
            continue
        for prefix in _TORCH_PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        out[BACKBONE_PREFIX + key] = value
    return out


def _ln(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["scale"])
    sd[f"{name}.bias"] = np.asarray(p["bias"])


def _convnext_backbone_state_dict(params) -> Dict[str, np.ndarray]:
    """A ConvNeXtV2Backbone tree -> timm keys (the layout of
    xmir_tpu/models/export.py::export_convnextv2_timm), for any depths."""
    sd = {"stem.0.weight": _conv(params["stem_conv"]["kernel"]),
          "stem.0.bias": np.asarray(params["stem_conv"]["bias"])}
    _ln(sd, "stem.1", params["stem_norm"])
    stages = sorted({int(m.group(1)) for key in params
                     if (m := re.fullmatch(r"stage(\d+)_block\d+", key))})
    for si in stages:
        if si > 0:
            _ln(sd, f"stages.{si}.downsample.0", params[f"downsample{si}_norm"])
            conv = params[f"downsample{si}_conv"]
            sd[f"stages.{si}.downsample.1.weight"] = _conv(conv["kernel"])
            sd[f"stages.{si}.downsample.1.bias"] = np.asarray(conv["bias"])
        for bi in _numbered(params, f"stage{si}_block"):
            pre, blk = f"stages.{si}.blocks.{bi}", params[f"stage{si}_block{bi}"]
            sd[f"{pre}.conv_dw.weight"] = _conv(blk["dwconv"]["kernel"])
            sd[f"{pre}.conv_dw.bias"] = np.asarray(blk["dwconv"]["bias"])
            _ln(sd, f"{pre}.norm", blk["norm"])
            _dense(sd, f"{pre}.mlp.fc1", blk["pwconv1"])
            _dense(sd, f"{pre}.mlp.fc2", blk["pwconv2"])
            sd[f"{pre}.mlp.grn.weight"] = np.asarray(blk["grn"]["gamma"]).reshape(-1)
            sd[f"{pre}.mlp.grn.bias"] = np.asarray(blk["grn"]["beta"]).reshape(-1)
    _ln(sd, "head.norm", params["head_norm"])
    return sd


def convnextv2_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's ConvNeXtV2 embedder tree (numpy leaves:
    params["backbone"] and any of "fc", "sra", "pcam") -> the port's
    ConvNeXtV2{,SRA,PCAM}Embedder state dict."""
    params = variables["params"]
    sd = {CONVNEXT_PREFIX + k: v
          for k, v in _convnext_backbone_state_dict(params["backbone"]).items()}
    if "fc" in params:
        _dense(sd, "fc", params["fc"])
    if "sra" in params:
        sd["sra.conv_att.weight"] = _conv(params["sra"]["conv_att"]["kernel"])
    if "pcam" in params:
        pcam = params["pcam"]
        kernel = np.asarray(pcam["classifier_kernel"])  # (C, K)
        sd["pcam.classifier.weight"] = kernel.T[:, :, None, None]
        sd["pcam.classifier.bias"] = np.asarray(pcam["classifier_bias"])
        if "fc" in pcam:
            _dense(sd, "pcam.fc", pcam["fc"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def convnextv2_backbone_state_dict_from_torch(
        sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A timm ConvNeXtV2 state dict -> ConvNeXtV2Backbone keys.

    Strips a ``module.`` DataParallel prefix and the wrappers
    ``convnext.``/``swinv2.``/``backbone.``/``model.``; takes GRN as
    ``mlp.grn.weight/bias`` or ``grn.gamma/beta`` of shape (1, 1, 1, C)
    (xmir_tpu/models/convert.py::convert_convnextv2_timm). Keeps the
    backbone's keys (``stem.``, ``stages.``, ``head.norm.``) and, like the
    reference, ignores every other key: timm's classifier and any head."""
    out = {}
    for key, value in sd.items():
        key = key.replace("module.", "")
        for prefix in _TIMM_PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        if not key.startswith(("stem.", "stages.", "head.norm.")):
            continue
        key = re.sub(r"\.blocks\.(\d+)\.grn\.gamma$", r".blocks.\1.mlp.grn.weight", key)
        key = re.sub(r"\.blocks\.(\d+)\.grn\.beta$", r".blocks.\1.mlp.grn.bias", key)
        out[key] = value.reshape(-1) if ".mlp.grn." in key else value
    return out


def _vit_backbone_state_dict(params) -> Dict[str, np.ndarray]:
    """A ViTBackbone tree -> timm keys (the inverse of
    xmir_tpu/models/convert.py::convert_vit_timm), for any depth, with or
    without LayerScale."""
    sd = {"cls_token": np.asarray(params["cls_token"]).reshape(1, 1, -1),
          "pos_embed": np.asarray(params["pos_embed"]),
          "patch_embed.proj.weight": _conv(params["patch_embed"]["kernel"]),
          "patch_embed.proj.bias": np.asarray(params["patch_embed"]["bias"])}
    _ln(sd, "norm", params["norm"])
    for i in _numbered(params, "block"):
        pre, blk = f"blocks.{i}", params[f"block{i}"]
        _ln(sd, f"{pre}.norm1", blk["norm1"])
        _ln(sd, f"{pre}.norm2", blk["norm2"])
        _dense(sd, f"{pre}.attn.qkv", blk["attn"]["qkv"])
        _dense(sd, f"{pre}.attn.proj", blk["attn"]["proj"])
        _dense(sd, f"{pre}.mlp.fc1", blk["mlp"]["fc1"])
        _dense(sd, f"{pre}.mlp.fc2", blk["mlp"]["fc2"])
        for ls in ("ls1", "ls2"):
            if ls in blk:
                sd[f"{pre}.{ls}.gamma"] = np.asarray(blk[ls]["gamma"])
    return sd


def vit_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's ViT tree (numpy leaves) -> the port's state dict: a
    DinoV2Embedder tree (params["backbone"], optional "fc") gives
    DinoV2Embedder keys; a bare ViTBackbone tree gives ViTBackbone keys."""
    params = variables["params"]
    if "backbone" not in params:
        sd = _vit_backbone_state_dict(params)
    else:
        sd = {VIT_PREFIX + k: v for k, v in _vit_backbone_state_dict(params["backbone"]).items()}
        if "fc" in params:
            _dense(sd, "fc", params["fc"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def vit_backbone_state_dict_from_torch(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A timm ViT (``vit_base_patch14_dinov2``) state dict -> ViTBackbone
    keys. Strips a ``module.`` DataParallel prefix and the wrappers
    ``convnext.``/``swinv2.``/``backbone.``/``model.``
    (xmir_tpu/cli/common.py:157-162); keeps the backbone's keys and, like the
    reference, ignores every other key: timm's classifier and any head."""
    out = {}
    for key, value in sd.items():
        key = key.replace("module.", "")
        for prefix in _TIMM_PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        if key in ("cls_token", "pos_embed") or key.startswith(
                ("patch_embed.", "blocks.", "norm.")):
            out[key] = value.reshape(1, 1, -1) if key == "cls_token" else value
    return out


def _swin_backbone_state_dict(params) -> Dict[str, np.ndarray]:
    """A SwinV2Backbone tree -> timm keys (the inverse of
    xmir_tpu/models/convert.py::convert_swinv2_timm), for any depths."""
    sd = {"patch_embed.proj.weight": _conv(params["patch_proj"]["kernel"]),
          "patch_embed.proj.bias": np.asarray(params["patch_proj"]["bias"])}
    _ln(sd, "patch_embed.norm", params["patch_norm"])
    _ln(sd, "norm", params["norm"])
    stages = sorted({int(m.group(1)) for key in params
                     if (m := re.fullmatch(r"stage(\d+)_block\d+", key))})
    for si in stages:
        if si > 0:
            _dense(sd, f"layers.{si}.downsample.reduction", params[f"merge{si}"]["reduction"])
            _ln(sd, f"layers.{si}.downsample.norm", params[f"merge{si}"]["norm"])
        for bi in _numbered(params, f"stage{si}_block"):
            pre, blk = f"layers.{si}.blocks.{bi}", params[f"stage{si}_block{bi}"]
            attn = blk["attn"]
            sd[f"{pre}.attn.qkv.weight"] = np.transpose(np.asarray(attn["qkv_kernel"]))
            for name in ("q_bias", "v_bias", "logit_scale"):
                sd[f"{pre}.attn.{name}"] = np.asarray(attn[name])
            _dense(sd, f"{pre}.attn.cpb_mlp.0", attn["cpb_fc1"])
            _dense(sd, f"{pre}.attn.cpb_mlp.2", attn["cpb_fc2"])
            _dense(sd, f"{pre}.attn.proj", attn["proj"])
            _ln(sd, f"{pre}.norm1", blk["norm1"])
            _ln(sd, f"{pre}.norm2", blk["norm2"])
            _dense(sd, f"{pre}.mlp.fc1", blk["mlp_fc1"])
            _dense(sd, f"{pre}.mlp.fc2", blk["mlp_fc2"])
    return sd


def swinv2_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's SwinV2 tree (numpy leaves) -> the port's state dict:
    a SwinV2Embedder tree (params["backbone"], optional "fc") gives
    SwinV2Embedder keys; a bare SwinV2Backbone tree gives SwinV2Backbone
    keys."""
    params = variables["params"]
    if "backbone" not in params:
        sd = _swin_backbone_state_dict(params)
    else:
        sd = {SWIN_PREFIX + k: v
              for k, v in _swin_backbone_state_dict(params["backbone"]).items()}
        if "fc" in params:
            _dense(sd, "fc", params["fc"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def swinv2_backbone_state_dict_from_torch(
        sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A timm SwinV2 (``swinv2_base_window12to24_192to384``) state dict ->
    SwinV2Backbone keys. Strips a ``module.`` DataParallel prefix and the
    wrappers ``convnext.``/``swinv2.``/``backbone.``/``model.``
    (xmir_tpu/cli/common.py:157-162); keeps the backbone's parameters
    (``patch_embed.``, ``layers.``, ``norm.``), drops timm's buffers
    (``relative_coords_table``, ``relative_position_index``, ``attn_mask``)
    and, like the reference, ignores every other key: timm's classifier and
    any head."""
    out = {}
    for key, value in sd.items():
        key = key.replace("module.", "")
        for prefix in _TIMM_PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        if key.startswith(("patch_embed.", "layers.", "norm.")) and not key.endswith(
                _SWIN_BUFFERS):
            out[key] = value
    return out


def nih_dual_head_state_dict_from_jax(variables, backbone: str) -> Dict[str, torch.Tensor]:
    """The JAX package's NIHDualHeadModel tree (numpy leaves: params
    ["backbone"], a ViTBackbone or ConvNeXtV2Backbone by ``backbone``, and
    params["head"]) -> the port's NIHDualHeadModel state dict."""
    params = variables["params"]
    to_timm = {"dinov2": _vit_backbone_state_dict,
               "convnextv2": _convnext_backbone_state_dict}[backbone]
    sd = {f"backbone.{k}": v for k, v in to_timm(params["backbone"]).items()}
    for name in ("proj_fc1", "proj_fc2", "classifier"):
        _dense(sd, f"head.{name}", params["head"][name])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def distill_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's DistillEmbedder tree (numpy leaves: params
    ["student"], a ConvNeXtV2Embedder tree, and params["teacher"], a bare
    ViTBackbone tree) -> the port's DistillEmbedder state dict."""
    params = variables["params"]
    sd = {f"student.{k}": v
          for k, v in convnextv2_state_dict_from_jax({"params": params["student"]}).items()}
    sd.update({f"teacher.{k}": torch.from_numpy(np.array(v, dtype=np.float32))
               for k, v in _vit_backbone_state_dict(params["teacher"]).items()})
    return sd


def load_torch_checkpoint(model: torch.nn.Module, path: str):
    """Load a ``.pt``/``.pth`` into ``model``, dispatched by its type (as
    xmir_tpu/cli/common.py::_convert_torch_checkpoint does by name). A
    checkpoint that the train CLI wrote (a state dict beside its
    optimiser's) loads whole, strictly, into any model. Otherwise: a
    DenseNet121Embedder takes the whole state dict with strict=True; a
    ConvNeXtV2, SwinV2 or DINOv2 embedder and a DINOv2 NIH dual-head model
    take a timm backbone with strict=True and keep their head (fc, SRA, PCAM,
    projection) as initialised. No timm layout is wired for a ConvNeXtV2 NIH
    dual-head model (the JAX package raises too) or for a distillation model:
    the JAX package merges a timm backbone into params["backbone"], a key
    that model lacks (it has "student" and "teacher"), so it loads nothing;
    this loader raises instead."""
    from .embedders import (
        ConvNeXtV2Embedder,
        ConvNeXtV2PCAMEmbedder,
        ConvNeXtV2SRAEmbedder,
        DenseNet121Embedder,
        DinoV2Embedder,
        DistillEmbedder,
        NIHDualHeadModel,
        SwinV2Embedder,
    )

    from ..utils.checkpoint import is_train_checkpoint, load_checkpoint, unwrap_state_dict

    tree = load_checkpoint(path, unwrap=False)
    sd = unwrap_state_dict(tree)
    if is_train_checkpoint(tree):
        model.load_state_dict(sd, strict=True)
        print(f">> loaded the whole model ({len(sd)} tensors, strict)")
    elif isinstance(model, DenseNet121Embedder):
        model.load_state_dict(embedder_state_dict_from_torch(sd), strict=True)
    elif isinstance(model, (ConvNeXtV2Embedder, ConvNeXtV2SRAEmbedder, ConvNeXtV2PCAMEmbedder)):
        backbone = convnextv2_backbone_state_dict_from_torch(sd)
        model.convnext.load_state_dict(backbone, strict=True)
        print(f">> loaded the ConvNeXtV2 backbone ({len(backbone)} tensors, strict); "
              "the head keeps its init")
    elif isinstance(model, DinoV2Embedder) or (
            isinstance(model, NIHDualHeadModel) and model.kind == "dinov2"):
        backbone = vit_backbone_state_dict_from_torch(sd)
        model.backbone.load_state_dict(backbone, strict=True)
        print(f">> loaded the ViT backbone ({len(backbone)} tensors, strict); "
              "the head keeps its init")
    elif isinstance(model, SwinV2Embedder):
        backbone = swinv2_backbone_state_dict_from_torch(sd)
        model.backbone.load_state_dict(backbone, strict=True)
        print(f">> loaded the SwinV2 backbone ({len(backbone)} tensors, strict); "
              "the head keeps its init")
    elif isinstance(model, DistillEmbedder):
        raise ValueError(
            f"{path} is not a checkpoint of the train CLI, and no timm layout is wired for a "
            "distillation model: its tensors are student.convnext.*, student.fc.* and "
            "teacher.* (the JAX package merges a timm backbone into params['backbone'], "
            "which this model lacks, and so loads nothing)")
    else:
        raise ValueError(f"no torch-checkpoint loader for {type(model).__name__}"
                         + (f" with backbone {model.kind!r}"
                            if isinstance(model, NIHDualHeadModel) else ""))
    return model
