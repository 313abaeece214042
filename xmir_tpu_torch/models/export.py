"""Model export (port of xmir_tpu/models/export.py): a trained model back in
its source framework's state-dict layout, or as a serialised program for
other PyTorch tooling.

``export_backbone(name, model)`` writes the tensors of a registry model's
backbone under the names the reference's own tooling loads: torchvision
DenseNet121 as the reference's module (``densenet121.0.*`` with its ``fc``
and ``classification_head``), torchvision ResNet50, timm ConvNeXtV2 (also
the SRA and PCAM models' backbone), SwinV2 and DINOv2 ViT, an HF
``SiglipVisionModel`` for MedSigLIP and ConceptCLIP's ``visual.`` + ``text.``
(HF BertModel) towers. It gives the dict the JAX package's
``export_backbone`` gives on the same weights, key for key: the port's
modules already hold those names (models/convert.py carries JAX trees and
the reference's files into them), so an export takes the backbone's
tensors out of the model's own state dict, without the module prefix the
port's embedders put ahead of them (``backbone.``, ``convnext.``) and without
the ``num_batches_tracked`` counters of ``nn.BatchNorm2d``, which the JAX
export does not write. Heads beside the backbone stay behind, as they do in
the JAX export. ``export_siglip_text`` and ``export_bert`` write a text
tower as HF's SiglipTextModel / BertModel.

``export_program`` is the counterpart of ``export_savedmodel`` (jax2tf -> a
TF SavedModel), whose place the PyTorch ecosystem's own serialised program
takes: ``torch.export`` of the map from an input batch to the embedding,
saved as a ``.pt2``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

# name -> (the module prefix the backbone's tensors sit under, taken off; the
# prefixes of the tensors the export keeps, after that)
_LAYOUTS = {
    "densenet121": ("", ("densenet121.0.", "fc.", "classification_head.")),
    "resnet50": ("backbone.", ("",)),
    "convnextv2": ("convnext.", ("",)),
    "convnextv2_sra": ("convnext.", ("",)),
    "convnextv2_pcam": ("convnext.", ("",)),
    "swinv2": ("backbone.", ("",)),
    "dinov2": ("backbone.", ("",)),
    "medsiglip": ("backbone.", ("",)),
    "conceptclip": ("", ("visual.", "text.")),
}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device as a numpy array; bfloat16 goes out as float32
    (numpy has no bfloat16; every bf16 value is exact in f32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def export_names(name: str, model: nn.Module) -> Dict[str, str]:
    """{exported key: the model's state-dict key} of ``export_backbone(name,
    model)``, for a model on any device (``meta`` included). Raises
    ValueError for a name without an exporter, as the JAX package does."""
    if name not in _LAYOUTS:
        raise ValueError(f"no exporter for {name!r}")
    strip, keep = _LAYOUTS[name]
    out = {}
    for key in model.state_dict():
        if not key.startswith(strip) or key.endswith("num_batches_tracked"):
            continue
        short = key[len(strip):]
        if short.startswith(keep):
            out[short] = key
    return out


def export_backbone(name: str, model: nn.Module) -> Dict[str, np.ndarray]:
    """Any registry backbone's tensors in its source framework's state-dict
    layout (the inverse of models/convert.py's loaders), as numpy arrays,
    read from ``model`` wherever it lives. ``name`` is the registry name the
    model was built as: densenet121, resnet50, convnextv2, convnextv2_sra,
    convnextv2_pcam, swinv2, dinov2, medsiglip or conceptclip; any other
    raises ValueError."""
    sd = model.state_dict()
    return {key: _to_numpy(sd[src]) for key, src in export_names(name, model).items()}


def export_siglip_text(model: nn.Module) -> Dict[str, np.ndarray]:
    """A SiglipTextBackbone (models/siglip_text.py) -> HF SiglipTextModel's
    state dict (``embeddings.*``, ``encoder.layers.*``,
    ``final_layer_norm.*``, ``head.*``): the tower's own keys."""
    return {key: _to_numpy(t) for key, t in model.state_dict().items()}


def export_bert(model: nn.Module) -> Dict[str, np.ndarray]:
    """A BertTextBackbone (models/bert.py) -> HF BertModel's state dict
    (``embeddings.*``, ``encoder.layer.*``): the tower's own keys."""
    return {key: _to_numpy(t) for key, t in model.state_dict().items()}


def save_torch_state_dict(sd: Dict[str, np.ndarray], path: str) -> str:
    """Write ``sd`` with ``torch.save`` (a ``.pt`` / ``.pth`` path: tensors,
    as the reference's tooling loads them) or ``np.savez`` (any other
    path). Returns the path."""
    if path.endswith((".pt", ".pth")):
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    else:
        np.savez(path, **sd)
    return path


class EmbeddingProgram(nn.Module):
    """The exported function: an input batch in the port's layout (B, H, W,
    3) -> the model's L2-normalised ``embedding`` (the JAX export's
    ``out["embedding"]``)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x):
        out = self.model(x)
        return out["embedding"] if isinstance(out, dict) else out


def export_program(model: nn.Module, path: str, input_shape,
                   dynamic_batch: bool = False) -> torch.export.ExportedProgram:
    """``torch.export`` of ``model``'s input batch -> embedding map, saved to
    ``path`` (a ``.pt2``) with ``torch.export.save``; returns the program.

    The model is traced in eval mode under ``torch.no_grad`` at its own
    device and dtype, on an input of ``input_shape`` (B, H, W, 3). With
    ``dynamic_batch`` the batch axis is a ``torch.export.Dim`` (the JAX CLI's
    ``--batch 0``) and the example batch is at least 2. The port's forward
    kernels on the model's path (K2, K4, K6, K7, K8, K9, by the switches in
    force while tracing) are recorded as their custom ops (``xmir::*``):
    ``torch.export.load`` of the file needs ``xmir_tpu_torch.ops`` imported
    first, which registers them, and on the card the loaded program builds
    the kernels at its first call, as the eager model does."""
    param = next(model.parameters())
    shape = tuple(int(s) for s in input_shape)
    if dynamic_batch:
        shape = (max(shape[0], 2),) + shape[1:]
    x = torch.zeros(shape, dtype=param.dtype, device=param.device)
    program = EmbeddingProgram(model).eval()
    dynamic = ({0: torch.export.Dim("batch")},) if dynamic_batch else None
    with torch.no_grad():
        ep = torch.export.export(program, (x,), dynamic_shapes=dynamic)
    torch.export.save(ep, path)
    return ep


def xmir_op_counts(ep: torch.export.ExportedProgram) -> Dict[str, int]:
    """{op name: calls} of the ``xmir::`` custom ops in an exported
    program's graph (``vit_attention``, ``ln_qkv``, ...)."""
    counts: Dict[str, int] = {}
    for node in ep.graph.nodes:
        target = getattr(node.target, "_schema", None) if node.op == "call_function" else None
        if target is not None and target.name.startswith("xmir::"):
            name = target.name.split("::", 1)[1]
            counts[name] = counts.get(name, 0) + 1
    return counts
