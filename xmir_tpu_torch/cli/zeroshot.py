"""Zero-shot classification CLI (port of xmir_tpu/cli/zeroshot.py; reference
test_conceptclip.py / evaluate_medsiglip.py zero-shot paths): class-prompt
text embeddings against image embeddings -> accuracy, macro P/R/F1 and the
confusion matrix.

    python -m xmir_tpu_torch.cli.zeroshot --dataset covid --model medsiglip \\
        --device cuda --dual-checkpoint medsiglip_dual.pt --vocab vocab.txt

The image embeddings come from the registry model (--model, --resume). The
class text embeddings come from a precomputed npz (--class-embeds: text_embeds
(C, D), optional class_names), or from the text tower of a
MedSigLIPDualEncoder (--dual-checkpoint, a torch .pt in the port's HF
SiglipModel layout, whose ``text_model.`` tensors load strictly; the vision
tower's are not read) over WordPiece-tokenised prompts (--vocab; --prompts,
else the COVIDx templates). The JAX CLI reads a .msgpack; the port reads a
.pt, as every port CLI does.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .common import add_dataset_args, add_model_args, build_dataset, build_model, resolve_device


def _prompt_text_embeds(args, device):
    """(L2-normalised class-prompt text features (C, D) on ``device``, class
    names) through the dual encoder's text tower (reference
    evaluate_medsiglip.py: processor(text=prompts) -> get_text_features)."""
    from ..data.wordpiece import BertWordPieceTokenizer
    from ..models.siglip_text import COVIDX_LABEL_TO_TEXT, SiglipTextBackbone
    from ..ops.distance import l2_normalize
    from ..utils.checkpoint import load_checkpoint

    if args.prompts:
        with open(args.prompts) as f:
            prompt_map = json.load(f)
        class_names = list(prompt_map)
        prompts = [prompt_map[c] for c in class_names]
    else:
        class_names = [str(c) for c in sorted(COVIDX_LABEL_TO_TEXT)]
        prompts = [COVIDX_LABEL_TO_TEXT[int(c)] for c in class_names]

    tok = BertWordPieceTokenizer(args.vocab, max_len=args.seq_len)
    ids, mask = tok.encode_padded(prompts, args.seq_len)
    text = SiglipTextBackbone(vocab_size=max(args.text_vocab_size, tok.vocab_size),
                              dim=args.text_dim, depth=args.text_depth)
    sd = load_checkpoint(args.dual_checkpoint)
    text_sd = {k[len("text_model."):]: v for k, v in sd.items() if k.startswith("text_model.")}
    text.load_state_dict(text_sd, strict=True)
    print(f">> [text tower] loaded {len(text_sd)} tensors (strict) from {args.dual_checkpoint}")
    text = text.to(device).eval()
    with torch.inference_mode():
        feats = text(torch.from_numpy(ids).long().to(device),
                     torch.from_numpy(mask).to(device))["pooled"]
    return l2_normalize(feats.float(), dim=1), class_names


def main(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch zero-shot classification")
    add_dataset_args(p)
    add_model_args(p)
    p.add_argument("--class-embeds", default="",
                   help="npz with text_embeds (C, D) and optional class_names")
    p.add_argument("--dual-checkpoint", default="",
                   help="MedSigLIP dual-encoder .pt (HF SiglipModel layout): class text "
                        "embeds from prompts via its text tower")
    p.add_argument("--vocab", default="",
                   help="Vocab file for WordPiece tokenization of --prompts")
    p.add_argument("--prompts", default="",
                   help="JSON {class_name: prompt}; default COVIDx templates")
    p.add_argument("--seq-len", default=64, type=int)
    p.add_argument("--text-dim", default=1152, type=int)
    p.add_argument("--text-depth", default=27, type=int)
    p.add_argument("--text-vocab-size", default=256000, type=int)
    p.add_argument("--logit-scale", default=np.log(10.0), type=float)
    p.add_argument("--logit-bias", default=0.0, type=float)
    p.add_argument("--eval-batch-size", default=32, type=int)
    p.add_argument("--output", default="")
    args = p.parse_args(argv)

    from ..analysis import zero_shot_classify
    from ..data.pipeline import embed_dataset
    from ..metrics.retrieval import _prf
    from ..train import make_embed_fn

    device = resolve_device(args)
    dataset = build_dataset(args, "test")
    model, spec = build_model(args, device)
    img_embeds, labels = embed_dataset(dataset, make_embed_fn(model), spec, device=device,
                                       batch_size=args.eval_batch_size)
    if args.class_embeds:
        data = np.load(args.class_embeds, allow_pickle=True)
        text_embeds = np.asarray(data["text_embeds"], np.float32)
        class_names = ([str(c) for c in data["class_names"]] if "class_names" in data
                       else [str(i) for i in range(text_embeds.shape[0])])
    elif args.dual_checkpoint and args.vocab:
        text_embeds, class_names = _prompt_text_embeds(args, device)
    else:
        raise SystemExit(
            "provide --class-embeds, or --dual-checkpoint with --vocab to "
            "compute class embeddings from prompts"
        )

    preds, _ = zero_shot_classify(img_embeds, text_embeds, args.logit_scale, args.logit_bias)
    labels = np.asarray(labels).astype(int)
    acc = float((preds == labels).mean())
    pm, rm, fm = _prf(labels, preds, "macro")
    n_cls = text_embeds.shape[0]
    confusion = np.zeros((n_cls, n_cls), int)
    for t, pr in zip(labels, preds):
        confusion[t, pr] += 1

    print(f">> zero-shot accuracy: {acc * 100:.2f}%")
    print(f">> macro P/R/F1: {pm * 100:.2f} / {rm * 100:.2f} / {fm * 100:.2f}")
    print(">> confusion matrix (rows=true):")
    print("          " + " ".join(f"{c[:8]:>9}" for c in class_names))
    for i, row in enumerate(confusion):
        print(f"{class_names[i][:9]:<9} " + " ".join(f"{v:>9}" for v in row))
    print(f">> predictions: {preds.tolist()}")
    result = {
        "accuracy": acc, "precision_macro": pm, "recall_macro": rm,
        "f1_macro": fm, "confusion": confusion.tolist(),
        "class_names": class_names,
    }
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
