"""On-disk datasets of the ported slice: the COVIDx manifest (a copy of
CovidxDataset in xmir_tpu/data/datasets.py, whose package init imports jax),
and ``split_txt``, a copy of its manifest splitter.

A dataset exposes __len__, load_image(i) -> uint8 HWC RGB array, labels and
image_names. PIL is imported where an image is opened, not at import time.
"""
from __future__ import annotations

import os

import numpy as np

COVIDX_LABEL_MAP = {"normal": 0, "pneumonia": 1, "COVID-19": 2}


class CovidxDataset:
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

    def __len__(self):
        return len(self.image_names)

    def load_image(self, index):
        from PIL import Image

        img = Image.open(self.image_names[index]).convert("RGB")
        if self.mask_names:
            mask = Image.open(self.mask_names[index]).resize(img.size)
            img = Image.composite(img, Image.new("RGB", img.size), mask)
        return np.asarray(img, dtype=np.uint8)


def split_txt(input_file, train_file, val_file, val_fraction=0.1, seed=42):
    """A manifest's non-empty lines split into train and validation files
    (reference split_dataset.py:1-81): ``int(n val_fraction)`` lines, drawn by
    numpy's default_rng(seed) permutation, go to ``val_file``; both keep the
    manifest's order. Returns (train count, validation count)."""
    with open(input_file) as f:
        lines = [line for line in f.read().splitlines() if line.strip()]
    order = np.random.default_rng(seed).permutation(len(lines))
    n_val = int(len(lines) * val_fraction)
    val_idx = set(order[:n_val].tolist())
    with open(train_file, "w") as ftr, open(val_file, "w") as fv:
        for i, line in enumerate(lines):
            (fv if i in val_idx else ftr).write(line + "\n")
    return len(lines) - n_val, n_val
