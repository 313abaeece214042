"""ShardedGalleryIndex: the device-resident exact vector index (port of
xmir_tpu/index/gallery.py).

The gallery lives as one tensor on the device, or, under a mesh
(parallel/mesh.py), as one 128-aligned shard of rows on each rank's device;
search is the exact fused similarity + top-k kernel (ops/topk_kernels.py)
through the metric wrappers of ops/topk_fused.py, once per shard, and the
shards' candidates merge by a stable sort in which equal scores go to the
lower gallery id. Labels and image paths stay on the host, like the Milvus
scalar fields of the reference (id | image_path | label | embedding).

The ``.npz`` artifact is the JAX package's format, byte for byte: a gallery
saved by either package loads in the other.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.distance import l2_normalize, sign_codes
from ..ops.distance import scores as score_fn
from ..ops.topk import exclude_self_topk, full_ranking
from ..ops.topk_fused import fused_topk, fused_topk_masked

_DISTANCE_CONVERSIONS = {
    # score -> (distance, similarity) per metric, matching
    # milvus/milvus_retrieval.py:94-109
    "cosine": lambda s: (1.0 - s, s),
    "ip": lambda s: (-s, s),
    "l2": lambda s: (-s, 1.0 / (1.0 + (-s))),
    "hamming": lambda s: (-s, 1.0 - (-s)),
}


def shard_layout(n: int, world: int):
    """(rows a shard, pad rows): each of ``world`` shards holds ceil(n /
    world) rows rounded up to a multiple of 128, the last padded with zero
    rows that the search masks out."""
    shard = -(-n // world)
    shard = -(-shard // 128) * 128
    return shard, shard * world - n


def make_local_shard_search(k: int, shard_rows: int, n_real: int, metric: str, compute_dtype):
    """The per-shard top-k body: local_search(q, g_shard, shard_id) ->
    (values (Q, k), global ids (Q, k) int32) of shard ``shard_id``'s rows.
    Rows at or past the real count are padding (the last shards' valid count
    is clip(n_real - base, 0, shard_rows), possibly 0); where k exceeds the
    shard's rows the result is padded to k with (-inf, 0) slots, and the
    shard's base is added to every id."""
    def local_search(q, g_shard, shard_id: int):
        base = shard_id * shard_rows
        valid = min(max(n_real - base, 0), shard_rows)
        kk = min(k, shard_rows)
        vals, idxs = fused_topk_masked(q, g_shard, kk, valid, metric, compute_dtype)
        if kk < k:
            vals = torch.cat([vals, vals.new_full((vals.shape[0], k - kk), float("-inf"))], 1)
            idxs = torch.cat([idxs, idxs.new_zeros((idxs.shape[0], k - kk))], 1)
        return vals, idxs + base

    return local_search


def merge_shard_candidates(vals, idxs, k: int):
    """(n_shards, Q, k) per-shard top-k blocks -> the global (Q, k). The
    candidates are laid out block-major, so that an earlier block holds lower
    ids, and a stable descending sort keeps equal scores in that order: ties
    go to the lower gallery id (the reference's stable argsort,
    test.py:1081). ``torch.topk`` is not used: its tie order is unspecified
    on CUDA."""
    n, q = vals.shape[0], vals.shape[1]
    vals = vals.permute(1, 0, 2).reshape(q, n * k)
    idxs = idxs.permute(1, 0, 2).reshape(q, n * k)
    v, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return v[:, :k], torch.gather(idxs, 1, pos[:, :k])


def make_sharded_search_step(mesh, k: int, shard_rows: int, n_real: int, metric: str,
                             compute_dtype):
    """The sharded search as one function of (queries, this rank's shard):
    the local shard body, the (world, Q, k) candidates gathered from every
    rank, and the merge, which every rank runs alike."""
    local_search = make_local_shard_search(k, shard_rows, n_real, metric, compute_dtype)

    def search_fn(queries, g_shard):
        vals, idxs = local_search(queries, g_shard, mesh.data_rank)
        return merge_shard_candidates(mesh.all_gather(vals), mesh.all_gather(idxs), k)

    return search_fn


class ShardedGalleryIndex:
    """Exact vector index on one device, or sharded by rows over a mesh.

    Usage:
      idx = ShardedGalleryIndex(dim=1024, metric="cosine")
      idx.add(embeddings, labels=..., paths=...)   # host-side staging
      idx.build(device="cuda")                      # device placement
      idx.build(mesh=mesh)                          # or one shard a rank
      vals, ids = idx.search(queries, k=10)
      hits = idx.search_with_metadata(queries, k=10)
    """

    def __init__(self, dim: int, metric: str = "cosine", dtype=torch.float32):
        if metric not in _DISTANCE_CONVERSIONS:
            raise ValueError(f"unknown metric {metric!r}")
        self.dim = dim
        self.metric = metric
        self.dtype = dtype
        self.device = None  # set by the first build(device)
        self._staged: List[np.ndarray] = []
        self._labels: List = []
        self._paths: List[str] = []
        self._device_embeds = None
        self._mesh = None
        self._shard_rows = 0
        self._n = 0

    # ------------------------------------------------------------- ingest
    def add(self, embeddings, labels: Optional[Sequence] = None,
            paths: Optional[Sequence[str]] = None):
        embeddings = np.asarray(embeddings, dtype=np.float32)
        if embeddings.ndim != 2 or embeddings.shape[1] != self.dim:
            raise ValueError(f"expected (N, {self.dim}) embeddings, got {embeddings.shape}")
        n = embeddings.shape[0]
        self._staged.append(embeddings)
        self._labels.extend(labels if labels is not None else [None] * n)
        self._paths.extend(paths if paths is not None else [""] * n)
        self._device_embeds = None  # invalidate built state

    @property
    def ntotal(self) -> int:
        return sum(a.shape[0] for a in self._staged)

    @property
    def labels(self) -> np.ndarray:
        return np.asarray(self._labels)

    @property
    def paths(self) -> List[str]:
        return list(self._paths)

    # ------------------------------------------------------------- build
    def build(self, device=None, mesh=None):
        """Concatenate the staged rows and place them on ``device``; a later
        build may leave it out to keep the last build's device. There is no
        default device: the search runs the CUDA kernel only on ``"cuda"``,
        and the plain version on ``"cpu"``, so the first build must say which.
        With a ``mesh`` the rows are split into its world's 128-aligned
        shards (shard_layout) and this rank keeps only its own, on the mesh's
        device. The metric's row-local gallery transform (cosine
        normalisation, hamming sign codes) is folded in here once, so each
        search runs the kernel on a plain inner product. The raw staged rows
        are kept for save()."""
        if not self._staged:
            raise ValueError("index is empty")
        if mesh is not None:
            self._mesh = mesh
            device = mesh.device
        if device is not None:
            self.device = torch.device(device)
        elif self.device is None:
            raise ValueError("the first build() needs a device: 'cuda' for the top-k "
                             "kernel, or 'cpu' for its plain version")
        host = torch.from_numpy(np.concatenate(self._staged, axis=0))
        if self.metric == "cosine":
            host = l2_normalize(host, dim=1)
        elif self.metric == "hamming":
            host = sign_codes(host)
        self._n = host.shape[0]
        if self._mesh is not None:
            self._shard_rows, pad = shard_layout(self._n, self._mesh.n_data)
            if pad:
                host = torch.cat([host, host.new_zeros((pad, self.dim))])
            lo = self._mesh.data_rank * self._shard_rows
            host = host[lo:lo + self._shard_rows]
        self._device_embeds = host.to(device=self.device, dtype=self.dtype).contiguous()
        return self

    def _require_built(self):
        if self._device_embeds is None:
            self.build()

    # ------------------------------------------------------------- search
    def search(self, queries, k: int, exclude_ids=None):
        """Exact top-k -> (values (Q, k) f32, indices (Q, k) i32) on the
        index's device.

        exclude_ids: optional (Q,) gallery ids to drop per query (self-match
        exclusion for in-gallery queries); k + 1 rows are fetched for it.
        """
        self._require_built()
        if k > self._n:
            raise ValueError(f"k={k} > index size {self._n}")
        queries, kmetric = self._query_side(queries)
        fetch = min(k + 1 if exclude_ids is not None else k, self._n)
        if self._mesh is not None:
            vals, idxs = make_sharded_search_step(
                self._mesh, fetch, self._shard_rows, self._n, kmetric,
                self.dtype)(queries, self._device_embeds)
        else:
            vals, idxs = fused_topk(queries, self._device_embeds, fetch, kmetric,
                                    compute_dtype=self.dtype)
        vals = self._value_side(vals)
        if exclude_ids is not None:
            vals, idxs = exclude_self_topk(vals, idxs, exclude_ids, k)
        return vals, idxs

    def _query_side(self, queries):
        """(queries on the device, the kernel's metric): build() applied the
        gallery-side transform, this applies the query side, and the kernel
        searches on the plain inner product."""
        queries = torch.as_tensor(queries, dtype=self.dtype, device=self.device)
        if self.metric == "cosine":
            return l2_normalize(queries), "ip"
        if self.metric == "hamming":
            return sign_codes(queries).to(self.dtype), "ip"
        return queries, self.metric

    def _value_side(self, vals):
        """The kernel's values as the metric's scores (hamming: -distance;
        a padding slot's -inf kept)."""
        if self.metric == "hamming":
            return torch.where(torch.isneginf(vals), vals, -(self.dim - vals) / 2.0)
        return vals

    def full_ranking(self, queries):
        """(Q, N) scores + ranks against the built device copy: the
        reference's top_k=0 full-gallery mode. Materialises O(Q * N). Under a
        mesh each rank scores its own shard; the shards' scores are joined by
        columns, the padding dropped, then ranked by a stable sort."""
        self._require_built()
        q = torch.as_tensor(queries, dtype=self.dtype, device=self.device)
        if self._mesh is None:
            return full_ranking(q, self._device_embeds, self.metric)
        s = self._mesh.all_gather(score_fn(q, self._device_embeds, self.metric))
        s = s.permute(1, 0, 2).reshape(q.shape[0], -1)[:, :self._n]
        return s, torch.sort(s, dim=1, descending=True, stable=True).indices

    def search_with_metadata(self, queries, k: int):
        """MilvusRetriever.search-compatible results: per query, a list of
        {id, image_path, label, distance, similarity} hits."""
        vals, idxs = self.search(queries, k)
        vals = vals.cpu().numpy()
        idxs = idxs.cpu().numpy()
        convert = _DISTANCE_CONVERSIONS[self.metric]
        labels = self.labels
        results = []
        for qi in range(vals.shape[0]):
            hits = []
            for v, i in zip(vals[qi], idxs[qi]):
                dist, sim = convert(float(v))
                label = labels[int(i)]
                hits.append({
                    "id": int(i),
                    "image_path": self._paths[int(i)],
                    # a multi-hot row (NIH, VinDr) as a list: the JAX package's
                    # .item() raises on it
                    "label": label.tolist() if hasattr(label, "tolist") else label,
                    "distance": dist,
                    "similarity": sim,
                })
            results.append(hits)
        return results

    def info(self) -> dict:
        """Index diagnostics: size, dim, metric, dtype, device layout."""
        built = self._device_embeds is not None
        out = {
            "ntotal": self.ntotal,
            "dim": self.dim,
            "metric": self.metric,
            "dtype": str(self.dtype).replace("torch.", ""),
            "built": built,
            "index_type": "FLAT_EXACT",
        }
        if built:
            e = self._device_embeds
            out["sharding"] = ({"devices": 1, "rows_per_shard": self._n}
                               if self._mesh is None else
                               {"devices": self._mesh.n_data, "rows_per_shard": self._shard_rows})
            out["device"] = str(e.device)
            out["hbm_bytes"] = int(e.numel() * e.element_size())
        return out

    # ------------------------------------------------------------- persist
    def save(self, path: str):
        """npz artifact (embeddings/labels/paths + metadata json), the JAX
        package's format. Written from the staged host rows: an index need
        not be built to be saved."""
        if not self._staged:
            raise ValueError("index is empty")
        np.savez(
            path,
            embeds=np.concatenate(self._staged, axis=0),
            labels=np.asarray(self._labels),
            paths=np.asarray(self._paths),
            meta=json.dumps({"dim": self.dim, "metric": self.metric}),
        )

    def remap_paths(self, old_prefix: str, new_prefix: str) -> int:
        """Rewrite stored gallery path prefixes (the reference's
        milvus/path_mapper.py role). Returns the number rewritten."""
        changed = 0
        out = []
        for p in self._paths:
            if p.startswith(old_prefix):
                out.append(new_prefix + p[len(old_prefix):])
                changed += 1
            else:
                out.append(p)
        self._paths = out
        return changed

    @classmethod
    def load(cls, path: str, device, mesh=None):
        """Load a saved gallery and build it on ``device`` ('cuda' or 'cpu'),
        or sharded over ``mesh`` (on the mesh's device)."""
        # pickle is allowed for the object-typed label arrays that the save()
        # of either package writes; load only artifacts this program wrote
        data = np.load(path, allow_pickle=True)
        meta = json.loads(str(data["meta"]))
        idx = cls(dim=meta["dim"], metric=meta["metric"])
        idx.add(data["embeds"], labels=list(data["labels"]),
                paths=[str(p) for p in data["paths"]])
        idx.build(device, mesh=mesh)
        return idx
