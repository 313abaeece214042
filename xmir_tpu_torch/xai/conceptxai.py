"""Patch-concept XAI for ConceptCLIP retrieval (a copy of
xmir_tpu/xai/conceptxai.py, numpy only; reference xai_conceptclip.py:151-353):
cosine attention between normalised ViT patch tokens and concept text
embeddings, the top-k concepts by their largest attention over the patches,
heatmaps from the patch grid, a retrieval-explanation record (the findings a
query shares with each retrieved image), a text report, and a matplotlib
figure (matplotlib is imported where the figure is drawn, PIL where a heatmap
is resized).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _normalize(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), 1e-12)


def patch_concept_attention(
    patch_embeds: np.ndarray,
    concept_embeds: np.ndarray,
    top_k: int = 5,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cosine attention between patches and concepts
    (reference xai_conceptclip.py:151-172).

    patch_embeds: (P, D) or (B, P, D); concept_embeds: (C, D).
    Returns (attention (..., P, C), top_idx (..., k), top_scores (..., k))
    where top concepts are ranked by max attention over patches."""
    p = _normalize(patch_embeds)
    c = _normalize(concept_embeds)
    attention = p @ c.T  # (..., P, C)
    max_per_concept = attention.max(axis=-2)  # (..., C)
    order = np.argsort(-max_per_concept, axis=-1)
    top_idx = order[..., :top_k]
    top_scores = np.take_along_axis(max_per_concept, top_idx, axis=-1)
    return attention, top_idx, top_scores


def detect_patch_grid(num_patches: int) -> Tuple[int, int]:
    """Squarest (h, w) factorization with h <= w
    (reference xai_conceptclip.py:189-199)."""
    grid_h = int(np.sqrt(num_patches))
    while num_patches % grid_h != 0 and grid_h > 1:
        grid_h -= 1
    grid_w = num_patches // grid_h
    if grid_h > grid_w:
        grid_h, grid_w = grid_w, grid_h
    return grid_h, grid_w


def attention_heatmap(
    attention_vector: np.ndarray,
    patch_grid: Optional[Tuple[int, int]] = None,
    image_size: int = 384,
) -> np.ndarray:
    """(P,) patch attention -> (image_size, image_size) float heatmap in
    [0, 1] (reference xai_conceptclip.py:174-210: uint8 quantize + bilinear
    upsample)."""
    from PIL import Image

    v = np.asarray(attention_vector, np.float32).reshape(-1)
    gh, gw = patch_grid or detect_patch_grid(v.size)
    grid = v.reshape(gh, gw)
    u8 = (np.clip(grid, 0.0, 1.0) * 255).astype(np.uint8)
    img = Image.fromarray(u8).resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def explain_retrieval(
    query_patch_embeds: np.ndarray,
    retrieved_patch_embeds: np.ndarray,
    concept_embeds: np.ndarray,
    concept_names: Sequence[str],
    similarity_scores: Sequence[float],
    retrieved_ids: Optional[Sequence[str]] = None,
    query_id: str = "query",
    top_k_concepts: int = 5,
) -> dict:
    """Structured retrieval explanation (reference
    xai_conceptclip.py:212-352 content as data instead of a figure):
    per-image top concepts and scores, shared findings between the query
    and each retrieved image, full patch-concept attention maps."""
    concept_names = list(concept_names)
    q_att, q_top, q_scores = patch_concept_attention(
        query_patch_embeds, concept_embeds, top_k_concepts
    )
    r_att, r_top, r_scores = patch_concept_attention(
        retrieved_patch_embeds, concept_embeds, top_k_concepts
    )
    retrieved_ids = list(
        retrieved_ids or (f"retrieved_{k}" for k in range(len(r_top)))
    )
    q_set = set(int(i) for i in q_top)
    retrieved = []
    for k in range(len(retrieved_ids)):
        idxs = [int(i) for i in r_top[k]]
        shared = [concept_names[i] for i in idxs if i in q_set]
        retrieved.append({
            "id": retrieved_ids[k],
            "similarity": float(similarity_scores[k]),
            "top_concepts": [
                {"name": concept_names[i], "score": float(s), "index": i}
                for i, s in zip(idxs, r_scores[k])
            ],
            "shared_findings": shared,
        })
    return {
        "query_id": query_id,
        "query_top_concepts": [
            {"name": concept_names[int(i)], "score": float(s), "index": int(i)}
            for i, s in zip(q_top, q_scores)
        ],
        "retrieved": retrieved,
        "query_attention": q_att,
        "retrieved_attention": r_att,
    }


def text_explanation(explanation: dict) -> str:
    """Human-readable report from an explain_retrieval record
    (reference generate_text_explanation, xai_conceptclip.py:313-352)."""
    lines = [
        f"Retrieval explanation for query {explanation['query_id']}",
        "=" * 70,
        "",
        "Query image key findings:",
    ]
    for i, c in enumerate(explanation["query_top_concepts"]):
        lines.append(f"  {i + 1}. {c['name']} (score {c['score']:.3f})")
    lines += ["", "Why these images were retrieved:", "-" * 70]
    for k, r in enumerate(explanation["retrieved"]):
        lines.append(f"\n#{k + 1} (similarity {r['similarity']:.4f}) - {r['id']}")
        if r["shared_findings"]:
            lines.append("  shared findings: " + ", ".join(r["shared_findings"]))
        else:
            lines.append(
                "  similar visual features with different concept distribution"
            )
        top3 = ", ".join(c["name"] for c in r["top_concepts"][:3])
        lines.append(f"  top findings: {top3}")
    lines += ["", "=" * 70]
    return "\n".join(lines)


def render_retrieval_explanation(
    explanation: dict,
    query_image: np.ndarray,
    retrieved_images: Sequence[np.ndarray],
    output_path: str,
    heatmaps_per_image: int = 2,
):
    """Composite figure: each row = image, detected concepts, top-concept
    heatmap overlays (reference visualize_retrieval_explanation,
    xai_conceptclip.py:212-311). Requires matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = 1 + len(retrieved_images)
    cols = 2 + heatmaps_per_image
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows))
    axes = np.atleast_2d(axes)

    def _row(r, image, title, concepts, attention):
        axes[r, 0].imshow(image, cmap="gray")
        axes[r, 0].set_title(title, fontsize=10)
        axes[r, 0].axis("off")
        txt = "\n".join(
            f"{i + 1}. {c['name']} ({c['score']:.3f})"
            + (" *" if c.get("shared") else "")
            for i, c in enumerate(concepts)
        )
        axes[r, 1].axis("off")
        axes[r, 1].text(0.02, 0.95, txt, fontsize=9, va="top",
                        family="monospace")
        size = image.shape[0]
        for j in range(heatmaps_per_image):
            ax = axes[r, 2 + j]
            ax.axis("off")
            if j >= len(concepts):
                continue
            hm = attention_heatmap(
                attention[:, concepts[j]["index"]], image_size=size
            )
            ax.imshow(image, cmap="gray", alpha=0.7)
            ax.imshow(hm, cmap="jet", alpha=0.5)
            ax.set_title(concepts[j]["name"], fontsize=9)

    _row(0, np.asarray(query_image),
         f"Query: {explanation['query_id']}",
         explanation["query_top_concepts"], explanation["query_attention"])
    for k, r in enumerate(explanation["retrieved"]):
        concepts = [
            dict(c, shared=c["name"] in {
                q["name"] for q in explanation["query_top_concepts"]
            })
            for c in r["top_concepts"]
        ]
        _row(k + 1, np.asarray(retrieved_images[k]),
             f"#{k + 1}: {r['id']} (sim {r['similarity']:.3f})",
             concepts, explanation["retrieved_attention"][k])
    fig.tight_layout()
    fig.savefig(output_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return output_path
