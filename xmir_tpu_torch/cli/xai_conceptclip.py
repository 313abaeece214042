"""ConceptCLIP patch-concept XAI CLI (port of xmir_tpu/cli/xai_conceptclip.py;
reference xai_conceptclip.py): the gallery's pooled and patch embeddings, each
query's top-k by cosine, and why each result is relevant by patch-concept
attention: the top concepts, the findings shared with the query, heatmaps and
a text report.

    python -m xmir_tpu_torch.cli.xai_conceptclip --dataset vindr --dataset-dir PNGS \\
        --test-image-list test.csv --checkpoint conceptclip.pt --vocab vocab.txt \\
        --device cuda --out-dir xai/

Per query: <out-dir>/<image>_explanation.json and .txt, and with --render a
matplotlib figure <image>_explanation.png. The concepts are VinDr's 22
findings as "a finding of <name>" through the text tower. The model runs in
f32 (its vision tower takes K2 only under ``XMIR_FLASH_ATTN=1``); the ranking
is numpy's, as in the JAX CLI. ``--checkpoint`` is a torch .pt of the port's
ConceptCLIPModel (what ``cli.train_conceptclip --save`` writes), loaded
strictly; the JAX CLI merges a .msgpack and keeps missing leaves from init.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .common import add_dataset_args, build_dataset, resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch ConceptCLIP patch-concept XAI")
    add_dataset_args(p)
    p.add_argument("--checkpoint", default="", help="ConceptCLIP .pt checkpoint (strict)")
    p.add_argument("--vocab", default="", help="vocab.txt for WordPiece")
    p.add_argument("--vocab-size", default=30000, type=int)
    p.add_argument("--seq-len", default=64, type=int)
    p.add_argument("--image-size", default=384, type=int)
    p.add_argument("--dim", default=1152, type=int)
    p.add_argument("--depth", default=27, type=int)
    p.add_argument("--text-depth", default=12, type=int)
    p.add_argument("--batch-size", default=16, type=int)
    p.add_argument("--top-k", default=5, type=int)
    p.add_argument("--top-k-concepts", default=5, type=int)
    p.add_argument("--num-images", default=0, type=int, help="Limit gallery size (0 = all)")
    p.add_argument("--num-query-samples", default=3, type=int)
    p.add_argument("--query-index", default=-1, type=int,
                   help="Explain one specific gallery index")
    p.add_argument("--render", action="store_true", help="Save matplotlib composite figures")
    p.add_argument("--out-dir", default="./xai_conceptclip")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda",
                   help="Torch device to run on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args)
    from ..data.datasets import VINDR_CONCEPT_COLUMNS
    from ..data.pipeline import batch_iterator
    from ..data.transforms import eval_preprocess
    from ..data.wordpiece import build_text_tokenizer
    from ..models.embedders import ConceptCLIPModel
    from ..models.registry import SIGLIP_MEAN, SIGLIP_STD
    from ..utils.checkpoint import load_checkpoint
    from ..xai.conceptxai import explain_retrieval, render_retrieval_explanation, text_explanation

    ds = build_dataset(args, "test")
    concept_names = list(getattr(ds, "concept_names", VINDR_CONCEPT_COLUMNS))
    concept_texts = [f"a finding of {c.lower()}" for c in concept_names]

    tok = build_text_tokenizer(args.vocab or None, args.vocab_size, args.seq_len)
    model = ConceptCLIPModel(img_size=args.image_size, dim=args.dim, depth=args.depth,
                             text_depth=args.text_depth,
                             text_vocab=max(args.vocab_size, getattr(tok, "vocab_size", 0)),
                             generator=torch.Generator().manual_seed(args.seed))
    if args.checkpoint:
        model.load_state_dict(load_checkpoint(args.checkpoint), strict=True)
        print(f">> loaded {args.checkpoint} (strict)")
    model = model.to(device).eval()

    with torch.inference_mode():
        # concept text embeddings (reference encode_concepts)
        ids, mask = tok.encode_padded(concept_texts, args.seq_len)
        concept_embeds = model.encode_text(torch.from_numpy(ids).long().to(device),
                                           torch.from_numpy(mask).to(device))
        concept_embeds = concept_embeds.float().cpu().numpy()

        # gallery: pooled + patch embeddings (reference encode_all_images)
        n = len(ds) if not args.num_images else min(args.num_images, len(ds))
        resize = int(args.image_size * 432 / 384)
        cls_list, tok_list, raw_images = [], [], []
        for imgs, _, _ in batch_iterator(ds, args.batch_size, indices=range(n),
                                         image_size=resize):
            x = eval_preprocess(torch.tensor(imgs, device=device), resize, args.image_size,
                                SIGLIP_MEAN, SIGLIP_STD)
            pooled, tokens = model.encode_image(x)
            cls_list.append(pooled.float().cpu().numpy())
            tok_list.append(tokens.float().cpu().numpy())
            raw_images.extend(np.asarray(imgs))
    cls_embeds = np.concatenate(cls_list)
    cls_embeds /= np.maximum(np.linalg.norm(cls_embeds, axis=1, keepdims=True), 1e-12)
    patch_embeds = np.concatenate(tok_list)
    image_ids = [str(getattr(ds, "image_names", range(n))[i]) for i in range(n)]
    print(f">> encoded {n} images: cls {cls_embeds.shape}, patches {patch_embeds.shape}")

    if args.query_index >= 0:
        queries = [args.query_index]
    else:
        rng = np.random.default_rng(args.seed)
        queries = rng.choice(n, size=min(args.num_query_samples, n), replace=False).tolist()

    os.makedirs(args.out_dir, exist_ok=True)
    results = []
    for q in queries:
        sims = cls_embeds @ cls_embeds[q]
        sims[q] = -np.inf
        order = np.argsort(-sims)[:args.top_k]
        exp = explain_retrieval(patch_embeds[q], patch_embeds[order], concept_embeds,
                                concept_names, sims[order], [image_ids[i] for i in order],
                                query_id=image_ids[q], top_k_concepts=args.top_k_concepts)
        report = text_explanation(exp)
        stem = os.path.join(args.out_dir, os.path.splitext(os.path.basename(image_ids[q]))[0])
        serializable = {k: v for k, v in exp.items()
                        if k not in ("query_attention", "retrieved_attention")}
        with open(stem + "_explanation.json", "w") as f:
            json.dump(serializable, f, indent=2)
        with open(stem + "_explanation.txt", "w") as f:
            f.write(report)
        if args.render:
            render_retrieval_explanation(exp, raw_images[q], [raw_images[i] for i in order],
                                         stem + "_explanation.png")
        print(report)
        results.append(serializable)
    return results


if __name__ == "__main__":
    main()
