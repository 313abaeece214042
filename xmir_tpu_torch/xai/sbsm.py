"""SBSM similarity-based saliency by occlusion (port of
xmir_tpu/xai/sbsm.py; reference explanations.py:15-152, SBSM / SBSMBatch).

Sliding-window binary masks occlude an image; the saliency of a pixel is the
distance increase its occlusion causes, accumulated over the masks that
cover it and divided by how many do. The masked copies of an image are
embedded in chunks of a fixed size on the image's device (the reference fans
mask batches across GPUs with DataParallel; the JAX package maps chunks of a
jitted embed function). ``embed_fn`` maps a (N, H, W, C) tensor to (N, D)
embeddings, as ``train.make_embed_fn``'s function does. The ``_mesh`` forms
split the mask axis over a data-parallel world (parallel/mesh.py): each rank
embeds its own masks and the per-pixel sums are all-reduced.
"""
from __future__ import annotations

import numpy as np
import torch


def generate_masks(input_size, window_size: int = 24, stride: int = 5) -> np.ndarray:
    """Sliding-window binary masks (N, H, W) uint8, 0 inside the window
    (reference explanations.py:22-68; the same grid: starts at
    stride - window)."""
    h, w = (input_size, input_size) if np.isscalar(input_size) else input_size
    rows = np.arange(0 + stride - window_size, h, stride)
    cols = np.arange(0 + stride - window_size, w, stride)
    masks = np.ones((len(rows) * len(cols), h, w), dtype=np.uint8)
    i = 0
    for r in rows:
        for c in cols:
            r1, r2 = max(r, 0), min(r + window_size, h)
            c1, c2 = max(c, 0), min(c + window_size, w)
            masks[i, r1:r2, c1:c2] = 0
            i += 1
    return masks


def _masked_embeds(embed_fn, image, masks, chunk: int):
    """Embed image * mask for every mask, ``chunk`` masks a forward: image
    (H, W, C), masks (N, H, W) float -> (N, D). The last chunk is padded with
    all-ones masks to the full size, as the JAX package pads, so every
    forward has the same batch."""
    out = []
    for i in range(0, masks.shape[0], chunk):
        mc = masks[i:i + chunk]
        if mc.shape[0] < chunk:
            mc = torch.cat([mc, mc.new_ones((chunk - mc.shape[0],) + mc.shape[1:])])
        out.append(embed_fn(mc[..., None].to(image.dtype) * image[None]))
    return torch.cat(out)[:masks.shape[0]]


def _cdist(a, b):
    """Euclidean distances (A, B) by the expanded formula of the JAX
    package, with its clamp at 0 before the root (not torch.cdist, whose
    algorithm differs)."""
    sq_a = torch.sum(a * a, dim=1)
    sq_b = torch.sum(b * b, dim=1)
    d2 = torch.clamp(sq_a[:, None] + sq_b[None, :] - 2.0 * (a @ b.T), min=0.0)
    return torch.sqrt(d2)


def _coverage(masks):
    """(1 - masks) and the per-pixel count of masks that occlude it."""
    occluded = 1.0 - masks
    return occluded, occluded.sum(dim=0).clamp_min(1.0)


def sbsm_self_saliency(embed_fn, x, masks, chunk: int = 128):
    """Self-similarity SBSM (reference SBSMBatch with x=None,
    explanations.py:107-112, 131-137): the saliency of each image against its
    own embedding. x (B, H, W, C), masks (N, H, W) -> (B, H, W) float32."""
    masks = torch.as_tensor(masks, device=x.device).float()
    occluded, count = _coverage(masks)
    q = embed_fn(x)
    out = []
    for img, q_emb in zip(x, q):
        me = _masked_embeds(embed_fn, img, masks, chunk)
        m_dist = torch.linalg.norm(q_emb[None] - me, dim=1)  # (N,)
        out.append(torch.tensordot(m_dist, occluded, dims=1) / count)
    return torch.stack(out)


def sbsm_pair_saliency(embed_fn, x_q, x, masks, chunk: int = 128):
    """Query-retrieval SBSM (reference SBSM.forward / SBSMBatch pair mode):
    for each (query q, retrieved r) pair the distance increase
    (||e_q - e_masked_r|| - ||e_q - e_r||)+ accumulated at the occluded
    pixels of r. x_q (Bq, H, W, C), x (B, H, W, C) -> (Bq, B, H, W)."""
    masks = torch.as_tensor(masks, device=x.device).float()
    occluded, count = _coverage(masks)
    q = embed_fn(x_q)
    o_dist = _cdist(q, embed_fn(x))  # (Bq, B)
    out = []
    for j, img in enumerate(x):
        m_dist = _cdist(q, _masked_embeds(embed_fn, img, masks, chunk))  # (Bq, N)
        excess = torch.clamp(m_dist - o_dist[:, j:j + 1], min=0.0)
        out.append(torch.tensordot(excess, occluded, dims=1) / count)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# the mask fan-out over a data-parallel world (the reference's one
# multi-GPU method: DataParallel over mask batches, compute_saliency.py:67,
# explanations.py:105-152). The mask stack is padded with all-ones masks
# (nothing occluded: their (1 - mask) factor is 0) to a multiple of the
# world, rank r embeds the r-th slice in chunks of min(chunk, its masks), the
# per-pixel numerators are summed across ranks, and the coverage count comes
# from the real masks.
# ---------------------------------------------------------------------------


def _pad_mask_axis(masks, world: int):
    pad = (-masks.shape[0]) % world
    if pad:
        masks = torch.cat([masks, masks.new_ones((pad,) + tuple(masks.shape[1:]))])
    return masks


def _local_masks(masks, mesh, chunk: int):
    """(this rank's slice of the padded mask stack, its chunk size)."""
    masks_p = _pad_mask_axis(masks, mesh.n_data)
    rows = masks_p.shape[0] // mesh.n_data
    return masks_p[mesh.data_rank * rows:(mesh.data_rank + 1) * rows], min(chunk, rows)


def sbsm_self_saliency_mesh(embed_fn, x, masks, mesh, chunk: int = 128):
    """``sbsm_self_saliency`` with the mask axis split over ``mesh``'s
    world. Equal to the one-device path up to the order of the sum over
    masks; every rank returns the same (B, H, W) maps."""
    masks = torch.as_tensor(masks, device=x.device).float()
    _, count = _coverage(masks)
    local, local_chunk = _local_masks(masks, mesh, chunk)
    occluded = 1.0 - local
    q = embed_fn(x)
    numer = []
    for img, q_emb in zip(x, q):
        me = _masked_embeds(embed_fn, img, local, local_chunk)
        m_dist = torch.linalg.norm(q_emb[None] - me, dim=1)
        numer.append(torch.tensordot(m_dist, occluded, dims=1))
    return mesh.all_reduce_(torch.stack(numer)) / count


def sbsm_pair_saliency_mesh(embed_fn, x_q, x, masks, mesh, chunk: int = 128):
    """``sbsm_pair_saliency`` with the mask axis split over ``mesh``'s
    world: x_q (Bq, H, W, C), x (B, H, W, C) -> (Bq, B, H, W) on every rank."""
    masks = torch.as_tensor(masks, device=x.device).float()
    _, count = _coverage(masks)
    local, local_chunk = _local_masks(masks, mesh, chunk)
    occluded = 1.0 - local
    q = embed_fn(x_q)
    o_dist = _cdist(q, embed_fn(x))
    numer = []
    for j, img in enumerate(x):
        m_dist = _cdist(q, _masked_embeds(embed_fn, img, local, local_chunk))
        excess = torch.clamp(m_dist - o_dist[:, j:j + 1], min=0.0)
        numer.append(torch.tensordot(excess, occluded, dims=1))
    return mesh.all_reduce_(torch.stack(numer, dim=1)) / count
