"""YOLO raw-output decoding + 8-variant TTA detection pipeline (a copy of
xmir_tpu/chestmir/inference.py: numpy on the host, as in the JAX package;
no package of finished kernels such as torchvision.ops.nms).

Equivalent of the reference detector pipeline
(ChestMIR/utils/inference.py): the ONNX Runtime session is replaced by any
`detector_fn` mapping a letterboxed (1, 3, S, S) float32 RGB tensor in
[0, 1] to raw YOLO head output (1, N, 5 + C) — e.g. the port's YOLOv5 from an
ultralytics-layout checkpoint (lesions.detector_fn_from_checkpoint), or a
fixture tensor in tests. Everything downstream
(xywh2xyxy, confidence gating, per-class-offset NMS, letterbox coordinate
unscaling, rot90/flip TTA with box back-transforms, WBF fusion) reproduces
the reference semantics exactly:

  xywh2xyxy / clip / scale_coords   inference.py:173-193
  class-offset NMS                  inference.py:208-273
  run_session conf/iou gates        inference.py:318-340
  8 TTA variants + box reversal     inference.py:89-147,361-385
  fold x TTA -> WBF merge           inference.py:437-492

Attribution: the decode/NMS/coordinate block below is a deliberate NumPy
port of the reference's ultralytics-lineage YOLO decode
(ChestMIR/utils/inference.py:100-273, itself standard YOLOv5 boilerplate) —
bit-exact decode semantics are the parity contract here, so the algorithm
is reproduced rather than re-designed.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Sequence, Tuple

import numpy as np

from .wbf import letterbox_image, weighted_boxes_fusion, xywh2xyxy


# ---------------------------------------------------------------- geometry

def clip_boxes(boxes: np.ndarray, image_shape: Tuple[int, int]) -> np.ndarray:
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, image_shape[1])
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, image_shape[0])
    return boxes


def scale_coords(boxes: np.ndarray, image_shape: Tuple[int, int],
                 ratio: float, pad: Tuple[float, float]) -> np.ndarray:
    """Undo letterboxing: subtract padding, divide by scale, clip
    (reference inference.py:188-193)."""
    boxes[:, [0, 2]] -= pad[0]
    boxes[:, [1, 3]] -= pad[1]
    boxes[:, :4] /= ratio
    return clip_boxes(boxes, image_shape)


def _box_iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(0.0, x2 - x1) * np.maximum(0.0, y2 - y1)
    area1 = np.maximum(0.0, box[2] - box[0]) * np.maximum(0.0, box[3] - box[1])
    area2 = np.maximum(0.0, boxes[:, 2] - boxes[:, 0]) * np.maximum(
        0.0, boxes[:, 3] - boxes[:, 1]
    )
    return inter / (area1 + area2 - inter + 1e-9)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thres: float) -> np.ndarray:
    """Greedy NMS returning kept indices, highest score first."""
    if len(boxes) == 0:
        return np.empty((0,), np.int64)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        ious = _box_iou(boxes[i], boxes[order[1:]])
        order = order[1:][ious <= iou_thres]
    return np.asarray(keep, np.int64)


def non_max_suppression(
    prediction: np.ndarray,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    agnostic: bool = False,
    max_det: int = 300,
    max_wh: float = 4096.0,
) -> List[np.ndarray]:
    """Decode raw YOLO head output (B, N, 5 + C) -> per-image (M, 6)
    [x1, y1, x2, y2, conf, cls] detections (reference inference.py:226-273):
    objectness gate, cls-prob x objectness, argmax class, second confidence
    gate, then greedy NMS with per-class coordinate offsets so different
    classes never suppress each other (unless agnostic)."""
    outputs = []
    for pred in np.asarray(prediction, np.float32):
        pred = pred[pred[:, 4] > conf_thres]
        if pred.shape[0] == 0:
            outputs.append(np.zeros((0, 6), np.float32))
            continue
        pred = pred.copy()
        pred[:, 5:] *= pred[:, 4:5]
        boxes = xywh2xyxy(pred[:, :4]).astype(np.float32)
        class_scores = pred[:, 5:]
        class_ids = class_scores.argmax(axis=1)
        confidences = class_scores[np.arange(class_scores.shape[0]), class_ids]

        keep_mask = confidences > conf_thres
        boxes, confidences, class_ids = (
            boxes[keep_mask], confidences[keep_mask], class_ids[keep_mask]
        )
        if boxes.shape[0] == 0:
            outputs.append(np.zeros((0, 6), np.float32))
            continue

        offsets = (
            np.zeros(len(class_ids), np.float32)
            if agnostic
            else class_ids.astype(np.float32) * max_wh
        )
        nms_boxes = boxes.copy()
        nms_boxes[:, [0, 2]] += offsets[:, None]
        keep = nms(nms_boxes, confidences, iou_thres)[:max_det]
        outputs.append(
            np.concatenate(
                [
                    boxes[keep],
                    confidences[keep, None].astype(np.float32),
                    class_ids[keep, None].astype(np.float32),
                ],
                axis=1,
            )
        )
    return outputs


# -------------------------------------------------------------------- TTA

def image_rot(image: np.ndarray, factor: int) -> np.ndarray:
    return np.rot90(image, factor)


def flip_hor(image: np.ndarray) -> np.ndarray:
    return np.fliplr(image)


def bbox_rot90(bbox, factor: int, height: float, width: float):
    """Rotate an xyxy box by `factor` x 90 degrees CCW on an image whose
    POST-rotation size is (height, width) (reference inference.py:100-111)."""
    if factor not in {0, 1, 2, 3}:
        raise ValueError("factor must be in {0, 1, 2, 3}")
    x_min, y_min, x_max, y_max = bbox[:4]
    if factor == 1:
        return y_min, width - x_max, y_max, width - x_min
    if factor == 2:
        return width - x_max, height - y_max, width - x_min, height - y_min
    if factor == 3:
        return height - y_max, x_min, height - y_min, x_max
    return x_min, y_min, x_max, y_max


def flip_hor_boxes(bbox, width: float):
    x_min, y_min, x_max, y_max = bbox[:4]
    return width - x_max, y_min, width - x_min, y_max


def get_tta_pair(ind: int):
    """(image transform, box back-transform) for TTA variant `ind` in 0..7:
    4 rotations x {no flip, horizontal flip} (reference inference.py:118-147).
    The box back-transform takes (box, h, w) of the TRANSFORMED image."""
    if ind == 0:
        return (lambda image: image), (lambda box, h, w: box)
    if ind == 1:
        return (lambda image: image_rot(image, 1),
                lambda box, h, w: bbox_rot90(box, 3, h, w))
    if ind == 2:
        return (lambda image: image_rot(image, 2),
                lambda box, h, w: bbox_rot90(box, 2, h, w))
    if ind == 3:
        return (lambda image: image_rot(image, 3),
                lambda box, h, w: bbox_rot90(box, 1, h, w))
    if ind == 4:
        return flip_hor, (lambda box, h, w: flip_hor_boxes(box, w))
    if ind == 5:
        return (lambda image: image_rot(flip_hor(image), 1),
                lambda box, h, w: flip_hor_boxes(bbox_rot90(box, 3, h, w), h))
    if ind == 6:
        return (lambda image: image_rot(flip_hor(image), 2),
                lambda box, h, w: flip_hor_boxes(bbox_rot90(box, 2, h, w), w))
    if ind == 7:
        return (lambda image: image_rot(flip_hor(image), 3),
                lambda box, h, w: flip_hor_boxes(bbox_rot90(box, 1, h, w), h))
    raise ValueError(f"Unsupported TTA id: {ind}")


# ---------------------------------------------------------------- pipeline

def prepare_input(image: np.ndarray, img_size: int):
    """Letterbox (HWC uint8 RGB) -> (1, 3, S, S) float32 in [0, 1] +
    (ratio, (pad_x, pad_y)) (reference inference.py:310-316; the BGR->RGB
    step disappears because images here are RGB already)."""
    processed, (ratio, pad_x, pad_y) = letterbox_image(image, img_size)
    processed = processed.transpose(2, 0, 1).astype(np.float32) / 255.0
    return processed[None], ratio, (pad_x, pad_y)


def run_detector(
    detector_fn: Callable[[np.ndarray], np.ndarray],
    image: np.ndarray,
    img_size: int,
    conf_thres: float = 0.01,
    iou_thres: float = 0.4,
):
    """ORT run_session equivalent (inference.py:318-340): letterbox, run the
    detector on the tensor, NMS-decode, unscale to image coords, round."""
    input_tensor, ratio, pad = prepare_input(image, img_size)
    output = np.asarray(detector_fn(input_tensor))
    detections = non_max_suppression(
        output, conf_thres=conf_thres, iou_thres=iou_thres
    )[0]
    if len(detections):
        detections[:, :4] = scale_coords(
            detections[:, :4], image.shape[:2], ratio, pad
        ).round()
    if len(detections) == 0:
        return (
            np.empty((0, 4), np.int32),
            np.empty((0,), np.float32),
            np.empty((0,), np.int32),
        )
    return (
        detections[:, :4].astype(np.int32),
        detections[:, 4].astype(np.float32),
        detections[:, 5].astype(np.int32),
    )


def run_single_tta(detector_fn, image: np.ndarray, img_size: int, aug_ind: int,
                   conf_thres: float = 0.01, iou_thres: float = 0.4):
    """Detect on one augmented view and map boxes back to the original
    orientation (reference inference.py:343-359)."""
    image_tta, box_reverse_tta = get_tta_pair(aug_ind)
    transformed = np.ascontiguousarray(image_tta(image))
    h, w = transformed.shape[:2]
    boxes, scores, labels = run_detector(
        detector_fn, transformed, img_size, conf_thres, iou_thres
    )
    if len(boxes) > 0:
        boxes[:, 0] = np.clip(boxes[:, 0], 0, w)
        boxes[:, 1] = np.clip(boxes[:, 1], 0, h)
        boxes[:, 2] = np.clip(boxes[:, 2], 0, w)
        boxes[:, 3] = np.clip(boxes[:, 3], 0, h)
        for idx in range(boxes.shape[0]):
            boxes[idx, :] = box_reverse_tta(boxes[idx, :], h, w)
    return boxes, scores, labels


def merge_predictions(predictions: Sequence[Tuple], iou_thr: float):
    """WBF-fuse per-(fold, TTA) detections in original-image pixel coords
    (reference inference.py:361-385, max_value normalization included)."""
    max_value = 10000.0
    boxes_list, scores_list, labels_list = [], [], []
    for boxes, scores, labels in predictions:
        boxes_list.append(np.asarray(boxes, np.float64).reshape(-1, 4) / max_value)
        scores_list.append(np.asarray(scores, np.float64).reshape(-1))
        labels_list.append(np.asarray(labels).reshape(-1))
    boxes, scores, labels = weighted_boxes_fusion(
        boxes_list, scores_list, labels_list, iou_thr=iou_thr, skip_box_thr=0.0
    )
    boxes = np.round(boxes * max_value).astype(np.int32)
    return boxes, scores, labels.astype(np.int32)


def predict_image(
    image: np.ndarray,
    detector_fns: Sequence[Callable[[np.ndarray], np.ndarray]],
    tta: Iterable[int] = (0, 4),
    img_size: int = 640,
    wbf_iou: float = 0.25,
    score_thres: float = 0.1,
    class_names: Sequence[str] | None = None,
):
    """Full fold x TTA detection (reference predict_image,
    inference.py:437-492): one detector_fn per fold, each run over every TTA
    variant, fused by WBF, then score-thresholded. Returns the reference's
    result dict (minus the rendered overlay — see detection_service)."""
    from .lesions import VINDR_DETECTOR_CLASSES

    class_names = list(class_names or VINDR_DETECTOR_CLASSES)
    tta = list(tta)
    all_predictions = []
    for detector_fn in detector_fns:
        for aug_ind in tta:
            all_predictions.append(
                run_single_tta(detector_fn, image, img_size, aug_ind)
            )
    boxes, scores, labels = merge_predictions(all_predictions, wbf_iou)
    keep = scores >= score_thres
    boxes, scores, labels = boxes[keep], scores[keep], labels[keep]

    detections = []
    for box, score, label in zip(boxes, scores, labels):
        detections.append({
            "class_id": int(label),
            "class_name": class_names[label]
            if 0 <= label < len(class_names) else str(label),
            "confidence": float(score),
            "x1": int(box[0]), "y1": int(box[1]),
            "x2": int(box[2]), "y2": int(box[3]),
        })
    return {
        "folds": list(range(len(detector_fns))),
        "tta": tta,
        "img_size": img_size,
        "wbf_iou": wbf_iou,
        "score_thres": score_thres,
        "detections": detections,
    }
