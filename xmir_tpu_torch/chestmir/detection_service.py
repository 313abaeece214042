"""Disease-detection service wrapper (reference
ChestMIR/utils/lesion_detection.py; a copy of
xmir_tpu/chestmir/detection_service.py): runs 5-fold x TTA WBF detection on raw
image bytes, normalizes detections (English + Vietnamese class names), and
renders a detection-overlay JPEG — PIL-based, no OpenCV."""
from __future__ import annotations

import io
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np

from .lesions import VINDR_DETECTOR_CLASSES
from .region import detections_with_tta_folds

CLASS_ID_TO_VI = {
    0: "Gian rong dong mach chu",
    1: "Xep phoi",
    2: "Voi hoa",
    3: "Tim to",
    4: "Dong dac phoi",
    5: "Benh phoi ke",
    6: "Tham nhiem",
    7: "Dam mo phoi",
    8: "Not/Khoi",
    9: "Ton thuong khac",
    10: "Tran dich mang phoi",
    11: "Day mang phoi",
    12: "Tran khi mang phoi",
    13: "Xo phoi",
}

_PALETTE = [
    (220, 20, 60), (0, 128, 255), (60, 179, 113), (255, 165, 0),
    (148, 0, 211), (0, 206, 209), (255, 105, 180), (154, 205, 50),
    (178, 34, 34), (30, 144, 255), (255, 215, 0), (186, 85, 211),
    (46, 139, 87), (244, 164, 96),
]


def draw_detections(image: np.ndarray, detections: Sequence[dict]) -> np.ndarray:
    """Render boxes + labels onto an HWC uint8 image (reference
    utils/inference.py:387-434 draw_detections)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(image.copy())
    draw = ImageDraw.Draw(img)
    for det in detections:
        cid = int(det.get("class_id", 0))
        color = _PALETTE[cid % len(_PALETTE)]
        box = [det["x1"], det["y1"], det["x2"], det["y2"]]
        draw.rectangle(box, outline=color, width=3)
        label = f"{det.get('class_name', cid)} {det.get('confidence', 0):.2f}"
        draw.text((box[0] + 2, max(0, box[1] - 12)), label, fill=color)
    return np.asarray(img)


class DiseaseDetectionService:
    """analyze_image(bytes) -> (normalized detections, overlay JPEG bytes)."""

    def __init__(self, detector_fns: Sequence[Callable],
                 raw_outputs: bool = False, tta: Sequence[int] = (0, 4)):
        self.detector_fns = list(detector_fns)
        self.raw_outputs = raw_outputs
        self.tta = tuple(tta)

    def analyze_image(
        self,
        image_bytes: bytes,
        *,
        img_size: int = 640,
        wbf_iou: float = 0.4,
        score_thres: float = 0.25,
    ) -> Tuple[List[dict], bytes]:
        from PIL import Image

        image = np.asarray(
            Image.open(io.BytesIO(image_bytes)).convert("RGB"), np.uint8
        )
        detections = detections_with_tta_folds(
            image, self.detector_fns, img_size=img_size, wbf_iou=wbf_iou,
            score_thres=score_thres, raw_outputs=self.raw_outputs,
            tta=self.tta,
        )
        normalized = [self._normalize(d) for d in detections]
        rendered = draw_detections(image, detections)
        buf = io.BytesIO()
        Image.fromarray(rendered).save(buf, format="JPEG")
        return normalized, buf.getvalue()

    @staticmethod
    def _normalize(det: dict) -> dict:
        cid = int(det["class_id"])
        return {
            "class_id": cid,
            "class_name_en": str(det["class_name"]),
            "class_name_vi": CLASS_ID_TO_VI.get(cid, str(det["class_name"])),
            "confidence": float(det["confidence"]),
            "x1": int(det["x1"]), "y1": int(det["y1"]),
            "x2": int(det["x2"]), "y2": int(det["y2"]),
        }
