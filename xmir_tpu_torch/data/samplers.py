"""Batch samplers for metric-learning training (the port's own copy of
xmir_tpu/data/samplers.py, which it may not import; tests hold the two to the
same index streams).

Framework-free (numpy RNG) equivalents of the reference's torch samplers:
  PKSampler                      reference sampler.py:32-76
  HardMiningSampler              reference sampler.py:78-113
  MultiLabelBalancedBatchSampler reference nih_multilabel_retrieval.py:351-411

All samplers are deterministic given a seed, which makes train steps
reproducible and lets the host-side index stream be precomputed while the
device works on the previous batch.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence

import numpy as np


def create_groups(groups: Sequence[int], k: int) -> Dict[int, List[int]]:
    """Bin sample indices by group id, dropping groups with < k samples
    (reference sampler.py:7-29)."""
    group_samples: Dict[int, List[int]] = defaultdict(list)
    for sample_idx, group_idx in enumerate(groups):
        group_samples[int(group_idx)].append(sample_idx)
    return {key: v for key, v in group_samples.items() if len(v) >= k}


class PKSampler:
    """Yields index streams where each consecutive block of p*k indices holds
    exactly p labels with k samples each (reference sampler.py:32-76)."""

    def __init__(self, groups: Sequence[int], p: int, k: int, seed: int | None = None):
        self.p = p
        self.k = k
        self.groups = create_groups(groups, k)
        if len(self.groups) < p:
            raise ValueError(
                f"PKSampler needs >= p={p} groups with >= k={k} samples, "
                f"got {len(self.groups)}"
            )
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterable[int]:
        rng = self._rng
        shuffled = {key: rng.permutation(v).tolist() for key, v in self.groups.items()}
        remaining = {key: len(v) for key, v in shuffled.items()}
        while len(remaining) >= self.p:
            group_ids = list(remaining.keys())
            chosen = rng.choice(len(group_ids), size=self.p, replace=False)
            for gi in chosen:
                gid = group_ids[gi]
                group = shuffled[gid]
                for _ in range(self.k):
                    yield group[len(group) - remaining[gid]]
                    remaining[gid] -= 1
                if remaining[gid] < self.k:
                    remaining.pop(gid)

    def epoch_length(self) -> int:
        """Lower bound on indices produced per epoch (full batches only)."""
        total = sum(len(v) for v in self.groups.values())
        return (total // (self.p * self.k)) * (self.p * self.k)


class HardMiningSampler:
    """Front-loads the hardest samples by externally supplied scores
    (reference sampler.py:78-113)."""

    def __init__(
        self,
        n_samples: int,
        hardness_scores: Sequence[float],
        num_hard: int,
        base_order: Sequence[int] | None = None,
        batch_size: int = 32,
        seed: int | None = None,
    ):
        if len(hardness_scores) != n_samples:
            raise ValueError("hardness_scores length must equal n_samples")
        self.n_samples = n_samples
        self.hardness_scores = list(hardness_scores)
        self.num_hard = num_hard
        self.base_order = base_order
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        hard = sorted(
            range(self.n_samples), key=lambda i: self.hardness_scores[i], reverse=True
        )[: self.num_hard]
        hard_set = set(hard)
        if self.base_order is not None:
            base = [i for i in self.base_order if i not in hard_set]
        else:
            base = [i for i in range(self.n_samples) if i not in hard_set]
            self._rng.shuffle(base)
        total = hard + base
        for i in range(0, len(total), self.batch_size):
            yield from total[i : i + self.batch_size]

    def __len__(self):
        return self.n_samples


class MultiLabelBalancedBatchSampler:
    """Per batch: pick `labels_per_batch` pathologies, `samples_per_label`
    samples of each, dedupe, top up with random indices, truncate to
    batch_size (reference nih_multilabel_retrieval.py:351-411)."""

    def __init__(
        self,
        multi_hot_labels: np.ndarray,
        batch_size: int = 32,
        labels_per_batch: int = 8,
        samples_per_label: int = 4,
        drop_last: bool = True,
        seed: int | None = None,
    ):
        self.labels = np.asarray(multi_hot_labels, dtype=np.float32)
        self.batch_size = batch_size
        self.labels_per_batch = labels_per_batch
        self.samples_per_label = samples_per_label
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self.label_to_indices: Dict[int, List[int]] = {}
        for label_idx in range(self.labels.shape[1]):
            idx = np.nonzero(self.labels[:, label_idx] > 0)[0]
            if idx.size > 0:
                self.label_to_indices[label_idx] = idx.tolist()
        if not self.label_to_indices:
            raise ValueError("Label-aware sampling requires at least one positive label.")

    def __len__(self) -> int:
        n = len(self.labels)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterable[List[int]]:
        rng = self._rng
        label_ids = list(self.label_to_indices.keys())
        n = len(self.labels)
        for _ in range(len(self)):
            batch: List[int] = []
            k = min(self.labels_per_batch, len(label_ids))
            chosen = rng.choice(len(label_ids), size=k, replace=False)
            for li in chosen:
                candidates = self.label_to_indices[label_ids[li]]
                if len(candidates) >= self.samples_per_label:
                    sel = rng.choice(
                        len(candidates), size=self.samples_per_label, replace=False
                    )
                else:
                    sel = rng.integers(0, len(candidates), size=self.samples_per_label)
                batch.extend(candidates[s] for s in sel)
            batch = list(dict.fromkeys(batch))
            if len(batch) < self.batch_size:
                in_batch = set(batch)
                remaining = [i for i in range(n) if i not in in_batch]
                needed = self.batch_size - len(batch)
                if len(remaining) >= needed:
                    sel = rng.choice(len(remaining), size=needed, replace=False)
                    batch.extend(remaining[s] for s in sel)
                else:
                    batch.extend(rng.integers(0, n, size=needed).tolist())
            rng.shuffle(batch)
            yield batch[: self.batch_size]
