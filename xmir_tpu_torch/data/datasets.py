"""On-disk datasets (port of xmir_tpu/data/datasets.py, whose package init
imports jax): the COVIDx manifest, the ISIC-2017 and TBX11K CSVs, the
multi-label VinDr-CXR CSV with its ConceptCLIP captions, the NIH ChestX-ray14
``.npy`` retrieval set, and the manifest / CSV splitters. Copies, not
imports.

A dataset exposes __len__, load_image(i) -> uint8 HWC RGB array, labels and
image_names. PIL is imported where an image is opened, not at import time.

One departure from the JAX module, which changes no result:
``VinDrDataset`` reads its CSV with the ``csv`` module (no pandas), with
pandas' ``groupby("image_id").max()`` semantics: one row per image id in
sorted order, each label the largest non-missing value of its rows.

``NIHChestXrayRetrievalDataset`` loads through the native C++ reader
(data/native_loader.py) by default, as the JAX module does.
"""
from __future__ import annotations

import csv
import math
import os
from pathlib import Path
from typing import List, Optional, Sequence
from urllib.parse import unquote

import numpy as np

COVIDX_LABEL_MAP = {"normal": 0, "pneumonia": 1, "COVID-19": 2}
ISIC_CLASSES = ("nevus", "seborrheic_keratosis", "melanoma")
TBX11K_TYPE_MAP = {"tb": 0, "healthy": 1, "sick_but_no_tb": 2}

NIH_RETRIEVAL_PATHOLOGIES = [
    "Atelectasis", "Cardiomegaly", "Effusion", "Infiltration", "Mass",
    "Nodule", "Pneumonia", "Pneumothorax", "Consolidation", "Edema",
    "Emphysema", "Fibrosis", "Pleural Thickening", "Hernia",
]

NIH_PATHOLOGY_ALIASES = {
    "pleural_thickening": "Pleural Thickening",
    "pleural thickening": "Pleural Thickening",
    "pleuralthickening": "Pleural Thickening",
}

VINDR_CONCEPT_COLUMNS = [
    "Aortic enlargement", "Atelectasis", "Calcification", "Cardiomegaly",
    "Clavicle fracture", "Consolidation", "Edema", "Emphysema", "Enlarged PA",
    "ILD", "Infiltration", "Lung Opacity", "Lung cavity", "Lung cyst",
    "Mediastinal shift", "Nodule/Mass", "Pleural effusion",
    "Pleural thickening", "Pneumothorax", "Pulmonary fibrosis", "Rib fracture",
    "Other lesion",
]
VINDR_DISEASE_COLUMNS = [
    "COPD", "Lung tumor", "Pneumonia", "Tuberculosis", "Other diseases",
    "No finding",
]
VINDR_ALL_COLUMNS = VINDR_CONCEPT_COLUMNS + VINDR_DISEASE_COLUMNS

CONCEPT_DESCRIPTIONS = {
    "Aortic enlargement": "aortic enlargement with widened mediastinum and dilated aortic contour",
    "Atelectasis": "atelectasis with lung volume loss and collapsed alveolar tissue",
    "Calcification": "calcification with calcified deposits visible as dense opacities",
    "Cardiomegaly": "cardiomegaly with enlarged cardiac silhouette exceeding normal cardiothoracic ratio",
    "Clavicle fracture": "clavicle fracture with disrupted cortical bone continuity",
    "Consolidation": "consolidation with airspace opacification replacing normal lung aeration",
    "Edema": "pulmonary edema with bilateral perihilar haziness and interstitial fluid",
    "Emphysema": "emphysema with hyperinflated lungs and flattened diaphragm",
    "Enlarged PA": "enlarged pulmonary artery suggesting pulmonary hypertension",
    "ILD": "interstitial lung disease with reticular or ground-glass opacities",
    "Infiltration": "pulmonary infiltration with ill-defined opacity in lung parenchyma",
    "Lung Opacity": "lung opacity with abnormal density in the pulmonary field",
    "Lung cavity": "lung cavity with air-filled space surrounded by consolidation or wall",
    "Lung cyst": "lung cyst with thin-walled air-filled space in the lung parenchyma",
    "Mediastinal shift": "mediastinal shift with displacement of central structures",
    "Nodule/Mass": "pulmonary nodule or mass with focal rounded density in the lung",
    "Pleural effusion": "pleural effusion with fluid accumulation in the pleural space",
    "Pleural thickening": "pleural thickening with increased density along the pleural surface",
    "Pneumothorax": "pneumothorax with visible visceral pleural line and absent lung markings",
    "Pulmonary fibrosis": "pulmonary fibrosis with reticular opacities and honeycombing pattern",
    "Rib fracture": "rib fracture with cortical disruption or callus formation",
    "Other lesion": "other lesion with abnormal radiographic finding",
}
DISEASE_DESCRIPTIONS = {
    "COPD": "chronic obstructive pulmonary disease",
    "Lung tumor": "lung tumor or pulmonary malignancy",
    "Pneumonia": "pneumonia with infectious consolidation",
    "Tuberculosis": "tuberculosis with characteristic upper lobe involvement",
    "Other diseases": "other thoracic disease",
    "No finding": "normal chest radiograph without significant pathology",
}



def _open_rgb(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)


class _BaseDataset:
    image_names: List[str]
    labels: list

    def __len__(self):
        return len(self.image_names)

    def load_image(self, index: int) -> np.ndarray:
        return _open_rgb(self.image_names[index])


class CovidxDataset(_BaseDataset):
    """COVIDx txt manifest `idx filename label` (read_data.py:268-331).
    `use_covid=False` drops COVID-19 rows (anomaly mode); mask_dir composites
    lung masks over black backgrounds (`*_xslor.png`)."""

    def __init__(self, data_dir, image_list_file, use_covid=True, mask_dir=None):
        self.image_names, self.labels, self.mask_names = [], [], []
        self.data_dir = data_dir
        with open(image_list_file) as f:
            for line in f:
                items = line.split()
                if len(items) < 3:
                    continue
                image_name, label_name = items[1], items[2]
                label = COVIDX_LABEL_MAP[label_name]
                if label == 2 and not use_covid:
                    continue
                if mask_dir is not None:
                    self.mask_names.append(os.path.join(
                        mask_dir, os.path.splitext(image_name)[0] + "_xslor.png"))
                self.image_names.append(os.path.join(data_dir, image_name))
                self.labels.append(label)

    def load_image(self, index):
        from PIL import Image

        img = Image.open(self.image_names[index]).convert("RGB")
        if self.mask_names:
            mask = Image.open(self.mask_names[index]).resize(img.size)
            img = Image.composite(img, Image.new("RGB", img.size), mask)
        return np.asarray(img, dtype=np.uint8)


class ISICDataset(_BaseDataset):
    """ISIC-2017 CSV GT `image_id, melanoma, seborrheic_keratosis`
    (read_data.py:200-265): melanoma=2, SK=1, nevus=0."""

    def __init__(self, data_dir, csv_file, use_melanoma=True):
        self.image_names, self.labels = [], []
        with open(csv_file, newline="") as f:
            reader = csv.reader(f)
            next(reader, None)
            for line in reader:
                if float(line[1]) == 1:
                    label = 2
                elif float(line[2]) == 1:
                    label = 1
                else:
                    label = 0
                if label == 2 and not use_melanoma:
                    continue
                self.image_names.append(os.path.join(data_dir, line[0] + ".jpg"))
                self.labels.append(label)


class TBX11kDataset(_BaseDataset):
    """TBX11K CSV `fname,image_type` with BOM/header normalization
    (read_data.py:335-394)."""

    def __init__(self, data_dir, csv_file):
        self.image_names, self.labels = [], []
        with open(csv_file, newline="", encoding="utf-8-sig") as f:
            reader = csv.DictReader(f)
            if reader.fieldnames is None:
                raise ValueError(f"CSV has no header row: {csv_file}")
            fields = {name.strip().lstrip("\ufeff").lower(): name
                      for name in reader.fieldnames if name is not None}
            fname_key, type_key = fields.get("fname"), fields.get("image_type")
            if fname_key is None or type_key is None:
                raise ValueError(
                    "TBX11k CSV must contain 'fname' and 'image_type' columns. "
                    f"Found columns: {reader.fieldnames}")
            for row in reader:
                fname = (row.get(fname_key) or "").strip()
                image_type = (row.get(type_key) or "").strip()
                if not fname or image_type not in TBX11K_TYPE_MAP:
                    continue
                self.image_names.append(os.path.join(data_dir, fname))
                self.labels.append(TBX11K_TYPE_MAP[image_type])


def _csv_number(text: str) -> float:
    """A CSV cell as pandas reads a numeric column: empty is missing (NaN)."""
    text = text.strip()
    return float(text) if text else math.nan


class VinDrDataset(_BaseDataset):
    """VinDr-CXR multi-label CSV with the multi-annotator
    ``groupby(image_id).max()`` aggregation (read_data.py:397-435; the
    undefined ``label_columns`` of the reference defaults to the 28-column
    VinDr vocabulary). Columns keep ``label_columns``' order, filtered by
    presence; with a ``rad_id`` column the rows are one per image id, in
    sorted order, each label the largest non-missing value of that id's
    rows (NaN when all are missing); without it the rows stay as read."""

    def __init__(self, data_dir, csv_file, label_columns: Optional[Sequence[str]] = None):
        self.data_dir = data_dir
        with open(csv_file, newline="") as f:
            reader = csv.reader(f)
            header = next(reader)
            rows = [row for row in reader if row]
        header = ["Other diseases" if h == "Other disease" and "Other diseases" not in header
                  else h for h in header]
        self.label_columns = [c for c in (label_columns or VINDR_ALL_COLUMNS) if c in header]
        if not self.label_columns:
            raise ValueError(f"No known VinDr label columns in {csv_file}")
        id_col = header.index("image_id")
        cols = [header.index(c) for c in self.label_columns]
        values = np.asarray([[_csv_number(row[c]) for c in cols] for row in rows],
                            np.float64).reshape(len(rows), len(cols))
        ids = [row[id_col] for row in rows]
        if "rad_id" in header:
            self.image_ids = sorted(set(ids))
            slot = {image_id: i for i, image_id in enumerate(self.image_ids)}
            grouped = np.full((len(self.image_ids), len(cols)), np.nan)
            for image_id, v in zip(ids, values):
                grouped[slot[image_id]] = np.fmax(grouped[slot[image_id]], v)
            values = grouped
        else:
            self.image_ids = ids
        self.image_names = [os.path.join(data_dir, f"{i}.png") for i in self.image_ids]
        self.labels = values.astype(np.float32)


class VinDrConceptCLIPDataset(VinDrDataset):
    """VinDr with concept-rich text generation for ConceptCLIP training
    (read_data.py:477-637): 22 visual concepts + 6 disease labels."""

    def __init__(self, data_dir, csv_file):
        super().__init__(data_dir, csv_file, label_columns=VINDR_ALL_COLUMNS)
        present = self.label_columns
        # column order follows VINDR_ALL_COLUMNS filtered by presence
        self.concept_idx = [i for i, c in enumerate(present) if c in VINDR_CONCEPT_COLUMNS]
        self.disease_idx = [i for i, c in enumerate(present) if c in VINDR_DISEASE_COLUMNS]
        self.concept_labels = self.labels[:, self.concept_idx]
        self.disease_labels = self.labels[:, self.disease_idx]
        self.all_labels = self.labels

    def build_text(self, concept_vec, disease_vec):
        """Concept-rich caption (read_data.py:556-609). Returns (text,
        active concept names for RC-Align)."""
        concept_cols = [self.label_columns[i] for i in self.concept_idx]
        disease_cols = [self.label_columns[i] for i in self.disease_idx]
        active_concepts = [concept_cols[i] for i, v in enumerate(concept_vec) if v == 1]
        active_diseases = [disease_cols[i] for i, v in enumerate(disease_vec) if v == 1]
        is_normal = ("No finding" in active_diseases) and not active_concepts
        if is_normal:
            return "A normal chest X-ray without significant pathological findings.", []
        if active_diseases and "No finding" not in active_diseases:
            disease_part = ", ".join(
                DISEASE_DESCRIPTIONS.get(d, d) for d in active_diseases
            )
        else:
            disease_part = "unspecified condition"
        if active_concepts:
            concept_part = ", ".join(
                CONCEPT_DESCRIPTIONS.get(c, c) for c in active_concepts
            )
            text = (
                f"A chest X-ray showing {disease_part} "
                f"with findings of {concept_part}."
            )
        else:
            text = f"A chest X-ray showing {disease_part}."
        return text, active_concepts

    def get_text(self, index):
        return self.build_text(self.concept_labels[index], self.disease_labels[index])


def _resolve_file_list(data_dir=None, image_list_file=None, suffix=".npy"):
    paths = []
    if image_list_file:
        manifest = Path(image_list_file)
        if manifest.is_file():
            for raw in manifest.read_text(encoding="utf-8").splitlines():
                line = raw.strip()
                if not line:
                    continue
                candidate = Path(line.split(",")[0].strip())
                if not candidate.is_absolute() and data_dir is not None:
                    candidate = Path(data_dir) / candidate
                paths.append(str(candidate))
    if not paths and data_dir:
        paths = sorted(str(p) for p in Path(data_dir).rglob(f"*{suffix}"))
    if not paths:
        raise ValueError("No input files found. Provide a valid data_dir or image_list_file.")
    return paths


def _to_uint8_image(array: np.ndarray) -> np.ndarray:
    array = np.asarray(array)
    if array.ndim == 3 and array.shape[0] in (1, 3):
        array = np.transpose(array, (1, 2, 0))
    if array.ndim == 3 and array.shape[-1] == 1:
        array = array[..., 0]
    if array.dtype == np.uint8:
        return array
    array = array.astype(np.float32)
    lo, hi = float(array.min()), float(array.max())
    if hi <= lo:
        return np.zeros_like(array, dtype=np.uint8)
    array = (array - lo) / (hi - lo)
    return np.clip(array * 255.0, 0.0, 255.0).astype(np.uint8)


class NIHChestXrayRetrievalDataset(_BaseDataset):
    """NIH .npy retrieval set with URL-encoded multi-label file names
    `Chest_X-ray_A%7CB_123.npy` (read_data.py:93-197): ``labels`` is the
    (N, 14) multi-hot float32 matrix, ``label_sets`` the canonical names of
    each file. ``load_image`` goes through PIL (grey, then RGB).

    With ``use_native`` (the default, as in the JAX module) the resized and
    cropped loads, and the pipeline's batch path (``load_batch_cropped``),
    parse, normalise and resize in the native C++ reader
    (data/native_loader.py), built at first use; a build that fails raises.
    A batch the reader refuses (a ValueError: a layout it does not parse)
    takes the PIL path instead, as in the JAX module, and
    ``native_loader.LOADS`` counts the images of each path."""

    def __init__(self, data_dir=None, image_list_file=None, pathology_names=None,
                 use_native: bool = True):
        self.use_native = use_native
        self.image_names = _resolve_file_list(data_dir, image_list_file, ".npy")
        self.pathology_names = list(pathology_names or NIH_RETRIEVAL_PATHOLOGIES)
        self.pathology_to_index = {n: i for i, n in enumerate(self.pathology_names)}
        self.aliases = dict(NIH_PATHOLOGY_ALIASES)
        for name in self.pathology_names:
            self.aliases[self._normalize(name)] = name
        self.labels, self.label_sets = [], []
        for path in self.image_names:
            names, multi_hot = self._parse_labels_from_path(path)
            self.label_sets.append(names)
            self.labels.append(multi_hot)
        self.labels = np.asarray(self.labels, dtype=np.float32)

    @staticmethod
    def _normalize(label: str) -> str:
        return label.strip().replace("%20", " ").replace("_", " ").replace("-", " ").lower()

    def _parse_labels_from_path(self, image_path):
        stem = Path(image_path).stem
        prefix = "Chest_X-ray_"
        idx = stem.find(prefix)
        if idx < 0:
            raise ValueError(f"Unsupported NIH file name '{Path(image_path).name}'. "
                             f"Expected token '{prefix}'.")
        rest = stem[idx + len(prefix):]
        try:
            encoded, _ = rest.rsplit("_", 1)
        except ValueError as exc:
            raise ValueError(f"Unsupported NIH file name '{Path(image_path).name}'.") from exc
        multi_hot = np.zeros(len(self.pathology_names), dtype=np.float32)
        names, unknown = [], []
        for raw in unquote(encoded).split("|"):
            canonical = self.aliases.get(self._normalize(raw))
            if canonical is None or canonical not in self.pathology_to_index:
                unknown.append(raw.strip())
                continue
            multi_hot[self.pathology_to_index[canonical]] = 1.0
            names.append(canonical)
        if unknown:
            raise ValueError(f"Unknown pathologies in '{Path(image_path).name}': {unknown}. "
                             f"Known labels: {self.pathology_names}")
        return names, multi_hot

    def load_image(self, index):
        from PIL import Image

        arr = _to_uint8_image(np.load(self.image_names[index]))
        img = Image.fromarray(arr).convert("L").convert("RGB")
        return np.asarray(img, dtype=np.uint8)

    def _native(self, load, pil, n: int = 1):
        """``load()`` through the native reader, else ``pil()`` where it is
        off or refuses the files. A refused batch (n > 1) falls back to the
        per-image loads, which count their own path."""
        from . import native_loader

        if self.use_native:
            try:
                out = load(native_loader)
            except ValueError:
                if n == 1:
                    native_loader.count("fallback", 1)
            else:
                native_loader.count("native", n)
                return out
        return pil()

    def load_image_resized(self, index, out_h: int, out_w: int):
        """Load + squash to (out_h, out_w) (bilinear)."""
        from PIL import Image

        return self._native(
            lambda nl: nl.load_npy_image(self.image_names[index], out_h, out_w),
            lambda: np.asarray(Image.fromarray(self.load_image(index)).resize(
                (out_w, out_h), Image.BILINEAR), np.uint8))

    def load_batch_resized(self, indices, out_h: int, out_w: int, n_threads: int = 0):
        """A batch of load_image_resized on the C++ worker pool."""
        return self._native(
            lambda nl: nl.load_npy_batch([self.image_names[i] for i in indices], out_h, out_w,
                                         n_threads),
            lambda: np.stack([self.load_image_resized(i, out_h, out_w) for i in indices]),
            len(indices))

    def load_image_cropped(self, index, size: int):
        """Aspect-preserving Resize(short=size) + CenterCrop(size), the
        reference NIH val transform (nih_multilabel_retrieval.py:48-61)."""
        from .transforms import pil_resize_center_crop

        return self._native(
            lambda nl: nl.load_npy_image_crop(self.image_names[index], size),
            lambda: pil_resize_center_crop(self.load_image(index), size))

    def load_batch_cropped(self, indices, size: int, n_threads: int = 0):
        """A batch of load_image_cropped on the C++ worker pool (the
        pipeline's batch path)."""
        return self._native(
            lambda nl: nl.load_npy_batch_crop([self.image_names[i] for i in indices], size,
                                              n_threads),
            lambda: np.stack([self.load_image_cropped(i, size) for i in indices]),
            len(indices))


# ---------------------------------------------------------------------------
# split utilities (reference split_dataset.py:1-81)


def split_txt(input_file, train_file, val_file, val_fraction=0.1, seed=42):
    """A manifest's non-empty lines split into train and validation files:
    ``int(n val_fraction)`` lines, drawn by numpy's default_rng(seed)
    permutation, go to ``val_file``; both keep the manifest's order. Returns
    (train count, validation count)."""
    with open(input_file) as f:
        lines = [line for line in f.read().splitlines() if line.strip()]
    order = np.random.default_rng(seed).permutation(len(lines))
    n_val = int(len(lines) * val_fraction)
    val_idx = set(order[:n_val].tolist())
    with open(train_file, "w") as ftr, open(val_file, "w") as fv:
        for i, line in enumerate(lines):
            (fv if i in val_idx else ftr).write(line + "\n")
    return len(lines) - n_val, n_val


def split_csv(input_file, train_file, val_file, val_fraction=0.1, seed=42):
    """split_txt for a CSV: the header goes to both files, the non-empty rows
    below it are split as split_txt splits lines."""
    with open(input_file) as f:
        lines = f.read().splitlines()
    header, rows = lines[0], [line for line in lines[1:] if line.strip()]
    order = np.random.default_rng(seed).permutation(len(rows))
    n_val = int(len(rows) * val_fraction)
    val_idx = set(order[:n_val].tolist())
    with open(train_file, "w") as ftr, open(val_file, "w") as fv:
        ftr.write(header + "\n")
        fv.write(header + "\n")
        for i, row in enumerate(rows):
            (fv if i in val_idx else ftr).write(row + "\n")
    return len(rows) - n_val, n_val
