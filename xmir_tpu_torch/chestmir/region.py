"""Region embedding: crop detected lesion boxes and embed each crop
(reference ChestMIR/utils/region_embed.py:166-380). Crops are clamped to the
image, resized to the embedder's input size, embedded, L2-normalized, and
serialized as {label, box, vector} records (port of xmir_tpu/chestmir/region.py:
the crops and the unit normalisation in numpy on the host as there; the
preprocessing and the embedder on the device).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def crop_box(image: np.ndarray, box: Sequence[float]) -> np.ndarray:
    """Clamped crop (reference region_embed.py:226)."""
    h, w = image.shape[:2]
    x1 = int(max(0, min(w - 1, np.floor(box[0]))))
    y1 = int(max(0, min(h - 1, np.floor(box[1]))))
    x2 = int(max(x1 + 1, min(w, np.ceil(box[2]))))
    y2 = int(max(y1 + 1, min(h, np.ceil(box[3]))))
    return image[y1:y2, x1:x2]


def embed_regions(
    image: np.ndarray,
    detections: Sequence[dict],
    embed_fn,
    spec,
    device,
    batch_size: int = 16,
) -> List[Dict]:
    """detections: [{"class_name": str, "x1": .., "y1": .., "x2": .., "y2": ..}]
    -> [{"label", "box", "vector"}] with unit vectors. ``embed_fn`` maps a
    preprocessed (B, S, S, 3) float batch on ``device`` to (B, D)
    embeddings (train/steps.py::make_embed_fn). Each crop is squashed to a
    square (resize_size, resize_size) with PIL's BILINEAR whatever
    ``spec.interpolation`` says, and preprocessed with the bilinear default,
    as the JAX package does (xmir_tpu/chestmir/region.py:43-52)."""
    from PIL import Image

    from ..data.transforms import eval_preprocess

    if not detections:
        return []
    crops = []
    for det in detections:
        crop = crop_box(image, (det["x1"], det["y1"], det["x2"], det["y2"]))
        crop = np.asarray(
            Image.fromarray(crop).resize(
                (spec.resize_size, spec.resize_size), Image.BILINEAR
            ),
            np.uint8,
        )
        crops.append(crop)
    records = []
    for start in range(0, len(crops), batch_size):
        batch = np.stack(crops[start : start + batch_size])
        x = eval_preprocess(
            torch.from_numpy(batch).to(device), spec.resize_size, spec.input_size, spec.mean,
            spec.std,
        )
        embs = embed_fn(x).cpu().numpy()
        embs = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
        for j, emb in enumerate(embs):
            det = detections[start + j]
            records.append(
                {
                    "label": det["class_name"],
                    "box": [det["x1"], det["y1"], det["x2"], det["y2"]],
                    "vector": emb.astype(np.float32),
                }
            )
    return records


def detections_with_tta_folds(
    image: np.ndarray,
    detector_fns: Sequence,
    img_size: int = 640,
    wbf_iou: float = 0.25,
    score_thres: float = 0.1,
    class_names: Sequence[str] | None = None,
    raw_outputs: bool = False,
    tta: Sequence[int] = (0, 4),
):
    """Fold x TTA detection fused by WBF (reference inference.py:437-492).

    raw_outputs=True: each detector_fn maps a letterboxed (1, 3, S, S)
    float32 RGB tensor to raw YOLO head output (1, N, 5+C); the full decode
    (conf gate, class-offset NMS, coordinate unscaling) plus any of the 8
    rot/flip TTA variants run through chestmir.inference — this is the path
    a converted detector checkpoint drives.

    raw_outputs=False (legacy): each detector_fn maps a letterboxed
    (S, S, 3) uint8 image to pre-decoded (boxes xyxy in letterbox coords,
    scores, labels); only identity+hflip TTA.

    Returns detection dicts in ORIGINAL image coordinates either way.
    """
    if raw_outputs:
        from .inference import predict_image

        return predict_image(
            image, detector_fns, tta=tta, img_size=img_size,
            wbf_iou=wbf_iou, score_thres=score_thres, class_names=class_names,
        )["detections"]
    from .lesions import VINDR_DETECTOR_CLASSES
    from .wbf import hflip_boxes, letterbox_image, scale_boxes_back, weighted_boxes_fusion

    class_names = list(class_names or VINDR_DETECTOR_CLASSES)
    h, w = image.shape[:2]
    lb, (ratio, pad_x, pad_y) = letterbox_image(image, img_size)
    lb_flip = lb[:, ::-1].copy()

    boxes_list, scores_list, labels_list = [], [], []
    for det in detector_fns:
        for aug, img in (("id", lb), ("hflip", lb_flip)):
            boxes, scores, labels = det(img)
            boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
            if aug == "hflip" and len(boxes):
                boxes = hflip_boxes(boxes, img_size)
            boxes_list.append(boxes / img_size)  # normalize for WBF
            scores_list.append(np.asarray(scores, np.float64).reshape(-1))
            labels_list.append(np.asarray(labels).reshape(-1))

    fb, fs, fl = weighted_boxes_fusion(boxes_list, scores_list, labels_list, wbf_iou)
    keep = fs >= score_thres
    fb, fs, fl = fb[keep] * img_size, fs[keep], fl[keep]
    fb = scale_boxes_back(fb, ratio, pad_x, pad_y, h, w)
    out = []
    for box, score, label in zip(fb, fs, fl):
        out.append(
            {
                "class_id": int(label),
                "class_name": class_names[int(label)]
                if 0 <= int(label) < len(class_names)
                else str(int(label)),
                "confidence": float(score),
                "x1": float(box[0]), "y1": float(box[1]),
                "x2": float(box[2]), "y2": float(box[3]),
            }
        )
    return out
