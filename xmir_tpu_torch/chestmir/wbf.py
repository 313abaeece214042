"""Weighted Boxes Fusion + detection-pipeline geometry, numpy-native (a copy
of xmir_tpu/chestmir/wbf.py; the port imports nothing of the JAX package).

Replaces the reference's `ensemble_boxes` dependency and OpenCV letterbox
(ChestMIR/utils/inference.py:149-171 letterbox, 361-385 merge_predictions,
 226-273 NMS): fuses 5-fold x TTA detector outputs into consensus boxes.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def letterbox_params(h: int, w: int, new_shape: int = 640):
    """Scale + padding used to letterbox an (h, w) image into a square
    new_shape canvas (reference inference.py:149-171). Returns
    (ratio, pad_x, pad_y, out_h, out_w)."""
    r = min(new_shape / h, new_shape / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    pad_x = (new_shape - nw) / 2
    pad_y = (new_shape - nh) / 2
    return r, pad_x, pad_y, nh, nw


def letterbox_image(image: np.ndarray, new_shape: int = 640, color=(114, 114, 114)):
    """HWC uint8 -> (new_shape, new_shape, C) letterboxed image + (ratio, pads)."""
    from PIL import Image

    h, w = image.shape[:2]
    r, pad_x, pad_y, nh, nw = letterbox_params(h, w, new_shape)
    resized = np.asarray(
        Image.fromarray(image).resize((nw, nh), Image.BILINEAR), np.uint8
    )
    out = np.full((new_shape, new_shape, image.shape[2]), color, np.uint8)
    top, left = int(round(pad_y - 0.1)), int(round(pad_x - 0.1))
    out[top : top + nh, left : left + nw] = resized
    return out, (r, pad_x, pad_y)


def scale_boxes_back(boxes: np.ndarray, ratio: float, pad_x: float, pad_y: float,
                     orig_h: int, orig_w: int) -> np.ndarray:
    """Undo letterboxing on xyxy boxes and clip to the original image."""
    b = boxes.astype(np.float64).copy()
    b[:, [0, 2]] = (b[:, [0, 2]] - pad_x) / ratio
    b[:, [1, 3]] = (b[:, [1, 3]] - pad_y) / ratio
    b[:, [0, 2]] = np.clip(b[:, [0, 2]], 0, orig_w)
    b[:, [1, 3]] = np.clip(b[:, [1, 3]], 0, orig_h)
    return b


def xywh2xyxy(boxes: np.ndarray) -> np.ndarray:
    out = boxes.copy().astype(np.float64)
    out[:, 0] = boxes[:, 0] - boxes[:, 2] / 2
    out[:, 1] = boxes[:, 1] - boxes[:, 3] / 2
    out[:, 2] = boxes[:, 0] + boxes[:, 2] / 2
    out[:, 3] = boxes[:, 1] + boxes[:, 3] / 2
    return out


def hflip_boxes(boxes: np.ndarray, width: float) -> np.ndarray:
    out = boxes.copy()
    out[:, 0] = width - boxes[:, 2]
    out[:, 2] = width - boxes[:, 0]
    return out


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None] - inter + 1e-9)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thres: float = 0.4) -> np.ndarray:
    """Greedy NMS, returns kept indices."""
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        ious = _iou_matrix(boxes[i : i + 1], boxes[order[1:]])[0]
        order = order[1:][ious <= iou_thres]
    return np.asarray(keep, np.int64)


def weighted_boxes_fusion(
    boxes_list: List[np.ndarray],
    scores_list: List[np.ndarray],
    labels_list: List[np.ndarray],
    iou_thr: float = 0.25,
    skip_box_thr: float = 0.0,
    conf_type: str = "avg",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Weighted boxes fusion (Solovyev et al.) over per-model normalized
    xyxy boxes. Each output box is the confidence-weighted average of its
    cluster; the fused score is the cluster-average score scaled by
    min(n_cluster, n_models)/n_models."""
    n_models = len(boxes_list)
    all_boxes, all_scores, all_labels = [], [], []
    for b, s, l in zip(boxes_list, scores_list, labels_list):
        if len(b) == 0:
            continue
        m = s > skip_box_thr
        all_boxes.append(np.asarray(b, np.float64)[m])
        all_scores.append(np.asarray(s, np.float64)[m])
        all_labels.append(np.asarray(l)[m])
    if not all_boxes:
        return np.zeros((0, 4)), np.zeros((0,)), np.zeros((0,), np.int64)
    boxes = np.concatenate(all_boxes)
    scores = np.concatenate(all_scores)
    labels = np.concatenate(all_labels)

    fused_boxes, fused_scores, fused_labels = [], [], []
    for cls in np.unique(labels):
        sel = labels == cls
        b, s = boxes[sel], scores[sel]
        order = np.argsort(-s)
        b, s = b[order], s[order]
        clusters: List[dict] = []
        for box, score in zip(b, s):
            matched = None
            for c in clusters:
                if _iou_matrix(box[None], c["fused"][None])[0, 0] > iou_thr:
                    matched = c
                    break
            if matched is None:
                clusters.append(
                    {"boxes": [box], "scores": [score], "fused": box.copy()}
                )
            else:
                matched["boxes"].append(box)
                matched["scores"].append(score)
                w = np.asarray(matched["scores"])
                bb = np.asarray(matched["boxes"])
                matched["fused"] = (bb * w[:, None]).sum(0) / w.sum()
        for c in clusters:
            w = np.asarray(c["scores"])
            bb = np.asarray(c["boxes"])
            fused = (bb * w[:, None]).sum(0) / w.sum()
            if conf_type == "avg":
                score = w.mean()
            else:
                score = w.max()
            score *= min(len(w), n_models) / n_models
            fused_boxes.append(fused)
            fused_scores.append(score)
            fused_labels.append(cls)
    if not fused_boxes:
        return np.zeros((0, 4)), np.zeros((0,)), np.zeros((0,), np.int64)
    fb = np.stack(fused_boxes)
    fs = np.asarray(fused_scores)
    fl = np.asarray(fused_labels)
    order = np.argsort(-fs)
    return fb[order], fs[order], fl[order]
