"""ChestMIR lesion vocabulary + canonicalization
(reference ChestMIR/chestmir_eval.py:45-121, utils/inference.py:67-82; a copy
of xmir_tpu/chestmir/lesions.py), and the detector callable built from an
ultralytics-layout YOLOv5 checkpoint."""
from __future__ import annotations

import contextlib
from typing import Dict, List

VINDR_DETECTOR_CLASSES = [
    "Aortic enlargement", "Atelectasis", "Calcification", "Cardiomegaly",
    "Consolidation", "ILD", "Infiltration", "Lung Opacity", "Nodule/Mass",
    "Other lesion", "Pleural effusion", "Pleural thickening", "Pneumothorax",
    "Pulmonary fibrosis",
]

LESION_ALIAS_GROUPS = {
    "consolidation": ["consolidation"],
    "lung opacity": ["lung opacity", "lung_opacity", "opacity", "opacities"],
    "infiltration": ["infiltration", "infiltrate", "infiltrates"],
    "atelectasis": ["atelectasis", "atelectatic"],
    "pleural effusion": [
        "pleural effusion", "pleural_effusion", "effusion", "plural effusion",
    ],
    "nodule mass": ["nodule mass", "nodule/mass", "nodule_mass", "mass", "nodule"],
    "cardiomegaly": ["cardiomegaly"],
    "edema": ["edema"],
    "pneumothorax": ["pneumothorax"],
    "pleural thickening": ["pleural thickening", "pleural_thickening"],
    "pulmonary fibrosis": ["pulmonary fibrosis", "pulmonary_fibrosis", "fibrosis"],
    "enlarged pa": ["enlarged pa", "enlarged_pa"],
    "ild": ["ild", "interstitial lung disease"],
    "calcification": ["calcification"],
    "lung cavity": ["lung cavity", "lung_cavity", "cavity"],
    "lung cyst": ["lung cyst", "lung_cyst", "cyst"],
    "aortic enlargement": ["aortic enlargement", "aortic_enlargement"],
    "other lesion": ["other lesion", "other_lesion"],
}

LESION_ALIAS_TO_CANON: Dict[str, str] = {}
for _canon, _aliases in LESION_ALIAS_GROUPS.items():
    for _alias in _aliases:
        LESION_ALIAS_TO_CANON[_alias] = _canon


def canonical_lesion_name(name: str) -> str:
    key = str(name).strip().lower().replace("-", " ")
    return LESION_ALIAS_TO_CANON.get(key, key)


@contextlib.contextmanager
def tf32_off():
    """PyTorch's two TF32 switches off for the duration (cuDNN's is on by
    default), put back as they were after."""
    import torch

    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def detector_fn_from_checkpoint(
    path: str,
    num_classes: int = 14,
    depth_multiple: float = 0.33,
    width_multiple: float = 0.50,
    device: str = "cuda",
):
    """Build a ``detector_fn`` (letterboxed (1, 3, S, S) float32 numpy ->
    raw (1, N, 5+nc) numpy predictions) from an ultralytics-layout YOLOv5
    ``.pt`` state dict through the port's YOLOv5 on ``device`` — the
    real-checkpoint replacement for the reference's ONNX sessions
    (ChestMIR/utils/inference.py:290-340). The forward runs in f32 with
    TF32 off, as the JAX package's jitted apply does. Asking for CUDA
    without a usable card raises: there is no silent CPU run.

    One fn per fold; pass the list to ``inference.predict_image``.
    """
    import numpy as np
    import torch

    from ..models.convert import load_yolov5_checkpoint
    from ..models.yolo import YOLOv5

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"detector device {device} asked for CUDA, but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    model = YOLOv5(num_classes=num_classes, depth_multiple=depth_multiple,
                   width_multiple=width_multiple)
    load_yolov5_checkpoint(model, path)
    model = model.to(dev, memory_format=torch.channels_last).eval()

    def detector_fn(input_tensor: "np.ndarray") -> "np.ndarray":
        x = torch.from_numpy(np.ascontiguousarray(input_tensor, np.float32)).to(dev)
        with torch.inference_mode(), tf32_off():
            out = model(x.contiguous(memory_format=torch.channels_last))["prediction"]
        return out.cpu().numpy()

    return detector_fn
