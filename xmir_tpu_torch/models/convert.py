"""Weights into the port's DenseNet, ResNet50, ConvNeXtV2, SwinV2 and ViT
embedders, the distillation models, the NIH dual-head models, the
CLIP-family models (SigLIP / MedSigLIP, ConceptCLIP, BiomedCLIP and their
text towers), the ATH hashing model, the tiny debug model and the YOLOv5
lesion detector: from the JAX package's variable tree, and from a reference
CheXNet / torchvision, timm, HF, open_clip or ultralytics ``.pt``.

Conventions (the inverse of xmir_tpu/models/convert.py):
  conv   flax (kh, kw, I, O)  -> torch (O, I, kh, kw)
  dense  flax (I, O)          -> torch (O, I)
  batchnorm params scale/bias -> weight/bias; batch_stats mean/var ->
  running_mean/running_var
  layernorm scale/bias        -> weight/bias
  ViT qkv   flax (C, 3C), columns q | k | v with the heads inside each ->
  torch (3C, C), rows in the same order (timm's ``qkv.weight``)
  embed     flax {"embedding": (V, D)} -> torch ``weight`` (V, D)
  SigLIP pooling head  flax attn_q / attn_k / attn_v -> torch
  ``attention.in_proj_weight`` (3D, D) rows q | k | v (nn.MultiheadAttention)
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


def _to_torch(sd) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


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
    return _to_torch(sd)


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


def _resnet_backbone_state_dict(params, stats, prefix: str) -> Dict[str, np.ndarray]:
    sd = {f"{prefix}conv1.weight": _conv(params["conv1"]["kernel"])}
    _bn(sd, f"{prefix}bn1", params["bn1"], stats["bn1"])
    for stage in range(1, 5):
        for b in _numbered(params, f"layer{stage}_"):
            pre, bp, bs = f"{prefix}layer{stage}.{b}", params[f"layer{stage}_{b}"], stats[
                f"layer{stage}_{b}"]
            for ci in (1, 2, 3):
                sd[f"{pre}.conv{ci}.weight"] = _conv(bp[f"conv{ci}"]["kernel"])
                _bn(sd, f"{pre}.bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
            if "downsample_conv" in bp:
                sd[f"{pre}.downsample.0.weight"] = _conv(bp["downsample_conv"]["kernel"])
                _bn(sd, f"{pre}.downsample.1", bp["downsample_bn"], bs["downsample_bn"])
    return sd


def resnet50_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's ResNet50Embedder tree (numpy leaves: params
    ["backbone"], optional "fc" and "classification_head") -> the port's
    ResNet50Embedder state dict; a bare ResNetBackbone tree gives
    ResNetBackbone keys. Any number of bottlenecks a stage."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    if "backbone" not in params:
        return _to_torch(_resnet_backbone_state_dict(params, stats, ""))
    sd = _resnet_backbone_state_dict(params["backbone"], stats["backbone"], "backbone.")
    for head in ("fc", "classification_head"):
        if head in params:
            _dense(sd, head, params[head])
    return _to_torch(sd)


# the reference's Sequential(*children()[:-1]) index -> torchvision name
# (model.py:13-15; xmir_tpu/models/convert.py::_SEQ_MAP): 2 ReLU, 3 max
# pool and 8 the average pool hold no tensor
_RESNET_SEQ = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3",
               "7": "layer4"}


def resnet50_backbone_state_dict_from_torch(
        sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision resnet50 state dict, or the reference's ResNet50 module
    (``resnet50.N.*``: the torchvision children in a Sequential), ->
    ResNetBackbone keys. A ``module.`` DataParallel prefix is stripped;
    torchvision's ``num_batches_tracked`` counters and ``fc`` classifier and
    the reference's ``fc`` / ``classification_head`` go: the JAX package
    reads the backbone alone from such a file (cli/common.py
    ::_convert_torch_checkpoint), and the head keeps its init."""
    out = {}
    for key, value in sd.items():
        key = key.replace("module.", "")
        if key.endswith("num_batches_tracked"):
            continue
        m = re.fullmatch(r"resnet50\.(\d+)\.(.*)", key)
        if m:
            if m.group(1) not in _RESNET_SEQ:
                raise ValueError(f"unexpected tensor {key!r} in a reference ResNet50 checkpoint")
            key = f"{_RESNET_SEQ[m.group(1)]}.{m.group(2)}"
        elif key.startswith(("fc.", "classification_head.")):
            continue
        out[key] = value
    return out


def tiny_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's TinyEmbedder tree -> the port's TinyEmbedder state
    dict (``backbone_conv{0,1,2}``, ``fc``, ``classification_head``)."""
    params = variables["params"]
    sd = {}
    for i in _numbered(params, "backbone_conv"):
        sd[f"backbone_conv{i}.weight"] = _conv(params[f"backbone_conv{i}"]["kernel"])
        sd[f"backbone_conv{i}.bias"] = np.asarray(params[f"backbone_conv{i}"]["bias"])
    for head in ("fc", "classification_head"):
        if head in params:
            _dense(sd, head, params[head])
    return _to_torch(sd)


def ath_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's ATHEmbedder tree (params["ath"], batch_stats["ath"])
    -> the port's ATHEmbedder state dict (``ath.*``)."""
    params, stats = variables["params"]["ath"], variables["batch_stats"]["ath"]
    sd = {"ath.sa.conv.weight": _conv(params["sa"]["conv"]["kernel"])}
    for block in ("block1", "block2", "dense"):
        bp, bs = params[block], stats[block]
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"), ("down_conv", "down_bn")):
            if conv in bp:
                sd[f"ath.{block}.{conv}.weight"] = _conv(bp[conv]["kernel"])
                _bn(sd, f"ath.{block}.{bn}", bp[bn], bs[bn])
    for head in ("hashlayer", "typelayer"):
        _dense(sd, f"ath.{head}", params[head])
    return _to_torch(sd)


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
    return _to_torch(sd)


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
    return _to_torch(sd)


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
    return _to_torch(sd)


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
    return _to_torch(sd)


def distill_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's DistillEmbedder tree (numpy leaves: params
    ["student"], a ConvNeXtV2Embedder tree, and params["teacher"], a bare
    ViTBackbone tree) -> the port's DistillEmbedder state dict."""
    params = variables["params"]
    sd = {f"student.{k}": v
          for k, v in convnextv2_state_dict_from_jax({"params": params["student"]}).items()}
    sd.update(_to_torch({f"teacher.{k}": v
                         for k, v in _vit_backbone_state_dict(params["teacher"]).items()}))
    return sd


def _siglip_layers(sd, prefix, params):
    for i in _numbered(params, "layer"):
        pre, lp = f"{prefix}encoder.layers.{i}", params[f"layer{i}"]
        _ln(sd, f"{pre}.layer_norm1", lp["layer_norm1"])
        _ln(sd, f"{pre}.layer_norm2", lp["layer_norm2"])
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(sd, f"{pre}.self_attn.{proj}", lp["self_attn"][proj])
        _dense(sd, f"{pre}.mlp.fc1", lp["mlp"]["fc1"])
        _dense(sd, f"{pre}.mlp.fc2", lp["mlp"]["fc2"])


def _siglip_vision_state_dict(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """A SiglipVisionBackbone tree -> HF SiglipVisionTransformer keys (the
    inverse of xmir_tpu/models/convert.py::convert_siglip_vision), any depth."""
    sd = {f"{prefix}embeddings.patch_embedding.weight": _conv(params["patch_embedding"]["kernel"]),
          f"{prefix}embeddings.patch_embedding.bias": np.asarray(params["patch_embedding"]["bias"]),
          f"{prefix}embeddings.position_embedding.weight": np.asarray(
              params["position_embedding"])}
    _siglip_layers(sd, prefix, params)
    _ln(sd, f"{prefix}post_layernorm", params["post_layernorm"])
    if "head" in params:
        head = params["head"]
        sd[f"{prefix}head.probe"] = np.asarray(head["probe"])
        qkv = [head[f"attn_{t}"] for t in "qkv"]
        sd[f"{prefix}head.attention.in_proj_weight"] = np.concatenate(
            [np.transpose(np.asarray(p["kernel"])) for p in qkv])
        sd[f"{prefix}head.attention.in_proj_bias"] = np.concatenate(
            [np.asarray(p["bias"]) for p in qkv])
        _dense(sd, f"{prefix}head.attention.out_proj", head["attn_out"])
        _ln(sd, f"{prefix}head.layernorm", head["layernorm"])
        _dense(sd, f"{prefix}head.mlp.fc1", head["mlp"]["fc1"])
        _dense(sd, f"{prefix}head.mlp.fc2", head["mlp"]["fc2"])
    return sd


def _siglip_text_state_dict(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """A SiglipTextBackbone tree -> HF SiglipTextTransformer keys."""
    sd = {f"{prefix}embeddings.token_embedding.weight": np.asarray(
              params["token_embedding"]["embedding"]),
          f"{prefix}embeddings.position_embedding.weight": np.asarray(
              params["position_embedding"])}
    _siglip_layers(sd, prefix, params)
    _ln(sd, f"{prefix}final_layer_norm", params["final_layer_norm"])
    _dense(sd, f"{prefix}head", params["head"])
    return sd


def _bert_state_dict(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """A BertTextBackbone tree -> HF BertModel keys (the inverse of
    xmir_tpu/models/convert.py::convert_bert), any depth."""
    sd = {f"{prefix}embeddings.{name}.weight": np.asarray(params[name]["embedding"])
          for name in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    _ln(sd, f"{prefix}embeddings.LayerNorm", params["embeddings_norm"])
    for i in _numbered(params, "layer"):
        pre, lp = f"{prefix}encoder.layer.{i}", params[f"layer{i}"]
        for name in ("query", "key", "value"):
            _dense(sd, f"{pre}.attention.self.{name}", lp["attention"][name])
        _dense(sd, f"{pre}.attention.output.dense", lp["attention_output"])
        _ln(sd, f"{pre}.attention.output.LayerNorm", lp["attention_norm"])
        _dense(sd, f"{pre}.intermediate.dense", lp["intermediate"])
        _dense(sd, f"{pre}.output.dense", lp["output"])
        _ln(sd, f"{pre}.output.LayerNorm", lp["output_norm"])
    return sd


def siglip_vision_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's SiglipVisionBackbone tree (numpy leaves) -> the
    port's SiglipVisionBackbone state dict (HF layout)."""
    return _to_torch(_siglip_vision_state_dict(variables["params"]))


def medsiglip_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's MedSigLIPEmbedder tree (params["backbone"],
    params["projection"]) -> the port's MedSigLIPEmbedder state dict."""
    params = variables["params"]
    sd = _siglip_vision_state_dict(params["backbone"], "backbone.")
    proj = params["projection"]
    _dense(sd, "projection.fc1", proj["fc1"])
    _ln(sd, "projection.ln", proj["ln"])
    _dense(sd, "projection.fc2", proj["fc2"])
    return _to_torch(sd)


def medsiglip_dual_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's MedSigLIPDualEncoder tree (params["vision"],
    params["text"], logit_scale, logit_bias) -> the port's
    MedSigLIPDualEncoder state dict (HF SiglipModel layout)."""
    params = variables["params"]
    sd = _siglip_vision_state_dict(params["vision"], "vision_model.")
    sd.update(_siglip_text_state_dict(params["text"], "text_model."))
    for name in ("logit_scale", "logit_bias"):
        sd[name] = np.asarray(params[name]).reshape(1)
    return _to_torch(sd)


def bert_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's BertTextBackbone tree -> the port's
    BertTextBackbone state dict (HF BertModel layout)."""
    return _to_torch(_bert_state_dict(variables["params"]))


def conceptclip_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's ConceptCLIPModel tree (params["visual"],
    params["text"], text_projection, logit_scale, logit_bias, optional fc) ->
    the port's ConceptCLIPModel state dict."""
    params = variables["params"]
    sd = _siglip_vision_state_dict(params["visual"], "visual.")
    sd.update(_bert_state_dict(params["text"], "text."))
    _dense(sd, "text_projection", params["text_projection"])
    for name in ("logit_scale", "logit_bias"):
        sd[name] = np.asarray(params[name]).reshape(())
    if "fc" in params:
        _dense(sd, "fc", params["fc"])
    return _to_torch(sd)


def biomedclip_state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's BiomedCLIPModel tree (params["visual"], visual_proj,
    params["text"], text_proj1, text_proj2, logit_scale) -> the port's
    BiomedCLIPModel state dict (open_clip's layout)."""
    params = variables["params"]
    sd = {f"visual.trunk.{k}": v for k, v in _vit_backbone_state_dict(params["visual"]).items()}
    _dense(sd, "visual.head.proj", params["visual_proj"])
    sd.update(_bert_state_dict(params["text"], "text.transformer."))
    _dense(sd, "text.proj.0", params["text_proj1"])
    _dense(sd, "text.proj.2", params["text_proj2"])
    sd["logit_scale"] = np.asarray(params["logit_scale"]).reshape(())
    return _to_torch(sd)


def siglip_vision_state_dict_from_torch(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An HF ``SiglipVisionModel`` state dict -> SiglipVisionBackbone keys.
    Strips a ``module.`` DataParallel prefix, one of the wrappers
    ``convnext.``/``swinv2.``/``backbone.``/``model.`` and ``vision_model.``
    (xmir_tpu/cli/common.py:157-174), drops the ``embeddings.position_ids``
    buffer some HF versions save (the port counts positions itself) and
    keeps the tower's keys."""
    out = {}
    for key, value in sd.items():
        key = key.replace("module.", "")
        for prefix in _TIMM_PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        key = key.removeprefix("vision_model.")
        if key.startswith(("embeddings.", "encoder.", "post_layernorm.", "head.")) and (
                key != "embeddings.position_ids"):
            out[key] = value
    return out


def biomedclip_state_dict_from_open_clip(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An open_clip BiomedCLIP state dict -> BiomedCLIPModel keys: the same
    names, a ``module.`` DataParallel prefix stripped and the HF text
    tower's ``embeddings.position_ids`` buffer dropped (older transformers
    save it; the port counts positions itself)."""
    return {k.replace("module.", ""): v for k, v in sd.items()
            if not k.endswith("text.transformer.embeddings.position_ids")}


# ultralytics wraps a YOLOv5 state dict's keys in these (as the JAX
# converter strips them, xmir_tpu/models/convert.py::convert_yolov5)
_YOLO_PREFIXES = ("model.model.", "model.")


def _yolo_tree(sd, prefix, params, stats):
    """A ConvBnSiLU / C3 / Bottleneck / SPPF subtree of the JAX YOLOv5 into
    ultralytics' names (Bottleneck ``m{j}`` -> ``m.{j}``)."""
    for key, sub in params.items():
        if key == "conv":
            sd[f"{prefix}.conv.weight"] = _conv(sub["kernel"])
        elif key == "bn":
            _bn(sd, f"{prefix}.bn", sub, stats["bn"])
        else:
            name = f"m.{key[1:]}" if re.fullmatch(r"m\d+", key) else key
            _yolo_tree(sd, f"{prefix}.{name}", sub, stats[key])


def yolov5_state_dict_from_jax(variables, anchors) -> Dict[str, torch.Tensor]:
    """The JAX package's YOLOv5 tree (numpy leaves: params and batch_stats
    of ``layer{i}``, ``detect{k}``) and its anchors in pixels -> the port's
    YOLOv5 state dict, in ultralytics' layout: the anchors go back to the
    ``model.24.anchors`` buffer in units of each scale's stride; every
    BatchNorm's ``num_batches_tracked`` is 0 (inference does not read it)."""
    from .yolo import DETECT, STRIDES

    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for i in _numbered(params, "layer"):
        _yolo_tree(sd, f"model.{i}", params[f"layer{i}"], stats[f"layer{i}"])
    for k in _numbered(params, "detect"):
        sd[f"model.{DETECT}.m.{k}.weight"] = _conv(params[f"detect{k}"]["kernel"])
        sd[f"model.{DETECT}.m.{k}.bias"] = np.asarray(params[f"detect{k}"]["bias"])
    strides = np.asarray(STRIDES, np.float32).reshape(-1, 1, 1)
    sd[f"model.{DETECT}.anchors"] = np.asarray(anchors, np.float32) / strides
    out = _to_torch(sd)
    for key in [k for k in out if k.endswith(".bn.running_var")]:
        out[key.replace("running_var", "num_batches_tracked")] = torch.zeros((), dtype=torch.long)
    return out


def yolov5_state_dict_from_ultralytics(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An ultralytics YOLOv5 (v6.0 graph) state dict -> the port's: the
    ``module.``, ``model.model.`` / ``model.`` wrappers stripped and
    ``model.`` put back (the port's layers are ``model.{i}``), floating
    tensors as f32 (ultralytics saves half precision)."""
    out = {}
    for key, value in sd.items():
        key = key.replace("module.", "")
        for prefix in _YOLO_PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        out[f"model.{key}"] = value.float() if value.is_floating_point() else value
    return out


def load_yolov5_checkpoint(model: torch.nn.Module, path: str) -> np.ndarray:
    """Load an ultralytics-layout YOLOv5 state-dict ``.pt`` into ``model`` (a
    models/yolo.py YOLOv5 of the checkpoint's class count and multiples)
    with strict=True; its ``anchors`` buffer comes from the file. Returns
    the anchors in pixels, (nl, na, 2), as convert_yolov5 does. A whole
    pickled ultralytics model is not read (nor is it by the JAX loader,
    which reads tensors only)."""
    from ..utils.checkpoint import load_checkpoint

    sd = yolov5_state_dict_from_ultralytics(load_checkpoint(path))
    model.load_state_dict(sd, strict=True)
    return model.anchors_px.cpu().numpy()


def load_torch_checkpoint(model: torch.nn.Module, path: str):
    """Load a ``.pt``/``.pth`` into ``model``, dispatched by its type (as
    xmir_tpu/cli/common.py::_convert_torch_checkpoint does by name). A
    checkpoint that the train CLI wrote (a state dict beside its
    optimiser's) loads whole, strictly, into any model. Otherwise: a
    DenseNet121Embedder takes the whole state dict with strict=True; a
    ConvNeXtV2, SwinV2 or DINOv2 embedder and a DINOv2 NIH dual-head model
    take a timm backbone with strict=True, and a MedSigLIP embedder an HF
    ``SiglipVisionModel``, each keeping its head (fc, SRA, PCAM, projection)
    as initialised; a BiomedCLIP model takes an open_clip state dict whole
    with strict=True (the counterpart of the JAX CLI's merge of a BiomedCLIP
    checkpoint). A ResNet50 embedder takes a torchvision or reference
    (``resnet50.N.*``) backbone with strict=True, its fc and classification
    head kept as initialised (as the JAX CLI's merge of the converted
    backbone); an ATH or tiny model takes a state dict in its own keys whole
    with strict=True (the JAX package has no torch layout for either). No
    layout is wired for a ConvNeXtV2 NIH dual-head model or
    a ConceptCLIP model (the JAX package raises too) or for a distillation
    model: the JAX package merges a timm backbone into params["backbone"], a
    key that model lacks (it has "student" and "teacher"), so it loads
    nothing; this loader raises instead."""
    from .biomedclip import BiomedCLIPModel
    from .embedders import (
        ATHEmbedder,
        ConceptCLIPModel,
        ConvNeXtV2Embedder,
        ConvNeXtV2PCAMEmbedder,
        ConvNeXtV2SRAEmbedder,
        DenseNet121Embedder,
        DinoV2Embedder,
        DistillEmbedder,
        MedSigLIPEmbedder,
        NIHDualHeadModel,
        ResNet50Embedder,
        SwinV2Embedder,
        TinyEmbedder,
    )

    from ..utils.checkpoint import is_train_checkpoint, load_checkpoint, unwrap_state_dict

    tree = load_checkpoint(path, unwrap=False)
    sd = unwrap_state_dict(tree)
    if is_train_checkpoint(tree):
        model.load_state_dict(sd, strict=True)
        print(f">> loaded the whole model ({len(sd)} tensors, strict)")
    elif isinstance(model, DenseNet121Embedder):
        model.load_state_dict(embedder_state_dict_from_torch(sd), strict=True)
    elif isinstance(model, ResNet50Embedder):
        backbone = resnet50_backbone_state_dict_from_torch(sd)
        model.backbone.load_state_dict(backbone, strict=True)
        print(f">> loaded the ResNet50 backbone ({len(backbone)} tensors, strict); "
              "the head keeps its init")
    elif isinstance(model, (ATHEmbedder, TinyEmbedder)):
        whole = {k.replace("module.", ""): v for k, v in sd.items()}
        model.load_state_dict(whole, strict=True)
        print(f">> loaded the whole model ({len(whole)} tensors, strict)")
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
    elif isinstance(model, MedSigLIPEmbedder):
        backbone = siglip_vision_state_dict_from_torch(sd)
        model.backbone.load_state_dict(backbone, strict=True)
        print(f">> loaded the SigLIP vision tower ({len(backbone)} tensors, strict); "
              "the projection keeps its init")
    elif isinstance(model, BiomedCLIPModel):
        whole = biomedclip_state_dict_from_open_clip(sd)
        model.load_state_dict(whole, strict=True)
        print(f">> loaded the open_clip BiomedCLIP model ({len(whole)} tensors, strict)")
    elif isinstance(model, ConceptCLIPModel):
        raise ValueError(
            f"{path} is not a checkpoint of the train CLI, and no torch-checkpoint converter is "
            "wired for a ConceptCLIP model (the JAX package raises too)")
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
