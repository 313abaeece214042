"""ConceptCLIP fine-tuning CLI (port of xmir_tpu/cli/train_conceptclip.py;
reference train.py --model conceptclip, train.py:221-397): VinDr's
concept-rich captions train the dual encoder with IT-Align + alpha RC-Align,
each sample's concept names padded to ``--max-concepts`` slots for the RC
loss, and ``logit_scale`` clamped after every step.

    python -m xmir_tpu_torch.cli.train_conceptclip --dataset vindr --dataset-dir PNGS \\
        --train-image-list train.csv --vocab vocab.txt --bf16 --device cuda \\
        --save conceptclip.pt

Text goes through WordPiece with ``--vocab``, else the deterministic hash
tokenizer (data/tokenizer.py; ``--token-table`` maps words to ids). Another
dataset than vindr trains on class-name captions with the class name as its
one concept (the JAX CLI's smoke shim). ``--bf16`` casts every floating
parameter to bf16 inside the step (train/steps.py::_train_call), so the
vision tower's attention takes K2 and, in its unfrozen layers, K3 in bf16.
By default the concepts of a batch are deduped on the host
(train/steps.py::dedupe_concept_batch: each distinct concept through the
text tower once); ``--no-dedupe-concepts`` encodes every slot, as the
reference does. Adam's first moment is kept in bf16 by default
(``--adam-mu-dtype``). ``--save`` writes {"state_dict": the model's state
dict}, which ``cli.xai_conceptclip --checkpoint`` reads.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .common import add_dataset_args, build_dataset, resolve_device, set_tf32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch ConceptCLIP fine-tuning")
    add_dataset_args(p)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--epochs", default=3, type=int)
    p.add_argument("--batch-size", default=8, type=int)
    p.add_argument("--lr", default=1e-5, type=float)
    p.add_argument("--weight-decay", default=0.01, type=float)
    p.add_argument("--rc-alpha", default=0.5, type=float)
    p.add_argument("--unfreeze-vision-layers", default=4, type=int)
    p.add_argument("--unfreeze-text-layers", default=2, type=int)
    p.add_argument("--max-concepts", default=8, type=int)
    p.add_argument("--seq-len", default=64, type=int)
    p.add_argument("--concept-len", default=16, type=int)
    p.add_argument("--token-table", default="")
    p.add_argument("--vocab", default="",
                   help="BERT vocab.txt: real WordPiece tokenization (matches "
                        "transformers.BertTokenizer)")
    p.add_argument("--image-size", default=384, type=int)
    p.add_argument("--dim", default=1152, type=int)
    p.add_argument("--depth", default=27, type=int)
    p.add_argument("--text-depth", default=12, type=int)
    p.add_argument("--vocab-size", default=30000, type=int)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--adam-mu-dtype", default="bfloat16", choices=["float32", "bfloat16"],
                   help="Adam first-moment dtype: bfloat16 (default) halves the first "
                        "moment's memory; float32 restores the reference's torch Adam "
                        "numerics")
    p.add_argument("--no-dedupe-concepts", action="store_true",
                   help="encode every (b, w) concept slot per step like the reference "
                        "instead of unique concepts + gather")
    p.add_argument("--print-freq", default=5, type=int)
    p.add_argument("--device", default="cuda",
                   help="Torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--save", default="./checkpoints/conceptclip.pt")
    return p.parse_args(argv)


def frozen_predicate(depth: int, text_depth: int, unfreeze_vision: int, unfreeze_text: int):
    """The JAX CLI's policy (reference model.py:648-703) on the port's names:
    in ``visual.`` the last ``unfreeze_vision`` encoder layers and every
    tensor whose name holds ``post_layernorm`` or ``head`` train; in
    ``text.`` the last ``unfreeze_text`` BERT layers; the projection and the
    logit scale and bias always train."""
    vision_layers = tuple(f"visual.encoder.layers.{i}."
                          for i in range(depth - unfreeze_vision, depth))
    text_layers = tuple(f"text.encoder.layer.{i}."
                        for i in range(text_depth - unfreeze_text, text_depth))

    def frozen(name: str) -> bool:
        if name.startswith("visual."):
            if name.startswith(vision_layers):
                return False
            return "post_layernorm" not in name and "head" not in name
        if name.startswith("text."):
            return not name.startswith(text_layers)
        return False
    return frozen


def concept_dataset(args):
    """VinDrConceptCLIPDataset for vindr; another dataset gets the JAX CLI's
    shim: a class-name caption and the class name as its one concept."""
    if args.dataset == "vindr":
        from ..data.datasets import VinDrConceptCLIPDataset

        return VinDrConceptCLIPDataset(args.dataset_dir, args.train_image_list)
    ds = build_dataset(args, "train")
    if not hasattr(ds, "get_text"):
        from ..data.synthetic import COVIDX_CLASS_NAMES

        def _get_text(i, _ds=ds):
            name = COVIDX_CLASS_NAMES[int(_ds.labels[i]) % 3]
            return f"A chest X-ray consistent with {name}.", [name]

        ds.get_text = _get_text
    return ds


def encode_batch(tok, ds, idxs, seq_len: int, max_concepts: int, concept_len: int):
    """(caption ids, caption mask, concept ids (B, W, Lc), concept mask
    (B, W), concept token mask (B, W, Lc)) as numpy arrays, as the JAX CLI
    builds them."""
    texts, concept_lists = [], []
    for gi in np.asarray(idxs):
        text, concepts = ds.get_text(int(gi))
        texts.append(text)
        concept_lists.append(concepts[:max_concepts])
    ids, mask = tok.encode_padded(texts, seq_len)
    cids = np.zeros((len(texts), max_concepts, concept_len), np.int32)
    cmask = np.zeros((len(texts), max_concepts), bool)
    ctok_mask = np.zeros((len(texts), max_concepts, concept_len), bool)
    for i, cl in enumerate(concept_lists):
        for j, cname in enumerate(cl):
            e, m = tok.encode_padded([cname], concept_len)
            cids[i, j] = e[0]
            ctok_mask[i, j] = m[0]
            cmask[i, j] = True
    return ids, mask, cids, cmask, ctok_mask


def epoch_batches(ds, tok, args, epoch: int, device, dedupe: bool):
    """The JAX CLI's batches of one epoch, as the step's arguments: a
    permutation seeded with seed + epoch, batches of ``--batch-size`` (the
    last partial one dropped) decoded at image_size 432 / 384 and
    center-cropped, the captions and padded concepts tokenised, the concepts
    deduped where ``dedupe``. Yields tuples for
    ``make_conceptclip_train_step``'s step, on ``device``."""
    from ..data.pipeline import batch_iterator
    from ..data.transforms import eval_preprocess
    from ..models.registry import SIGLIP_MEAN, SIGLIP_STD
    from ..train import dedupe_concept_batch

    def dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    s = args.image_size
    resize = int(s * 432 / 384)
    order = np.random.default_rng(args.seed + epoch).permutation(len(ds))
    for imgs, _, idxs in batch_iterator(ds, args.batch_size, indices=order.tolist(),
                                        image_size=resize, drop_last=True):
        ids, mask, cids, cmask, ctok_mask = encode_batch(
            tok, ds, idxs, args.seq_len, args.max_concepts, args.concept_len)
        x = eval_preprocess(torch.tensor(imgs, device=device), resize, s, SIGLIP_MEAN,
                            SIGLIP_STD)
        if dedupe:
            u_ids, u_mask, inverse = dedupe_concept_batch(cids, ctok_mask)
            yield (x, dev(ids).long(), dev(mask), dev(u_ids).long(), dev(cmask), dev(u_mask),
                   dev(inverse))
        else:
            yield x, dev(ids).long(), dev(mask), dev(cids).long(), dev(cmask), dev(ctok_mask)


def text_tokenizer(args):
    """WordPiece over ``--vocab`` (raising ``args.vocab_size`` to its size),
    else the hash tokenizer with ``--token-table``."""
    if args.vocab:
        from ..data.wordpiece import BertWordPieceTokenizer

        tok = BertWordPieceTokenizer(args.vocab, max_len=args.seq_len)
        args.vocab_size = max(args.vocab_size, tok.vocab_size)
        return tok
    from ..data.tokenizer import HashWordTokenizer

    table = None
    if args.token_table:
        with open(args.token_table) as f:
            table = {w: int(i) for w, i in json.load(f).items()}
    return HashWordTokenizer(args.vocab_size, args.seq_len, table)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args)
    # as cli.train: deterministic cuDNN and no TF32, so two runs agree bit for bit
    torch.backends.cudnn.deterministic = True
    set_tf32(False)

    from ..models.embedders import ConceptCLIPModel
    from ..train import TrainState, build_optimizer, make_conceptclip_train_step
    from ..utils.checkpoint import save_checkpoint

    ds = concept_dataset(args)
    tok = text_tokenizer(args)

    model = ConceptCLIPModel(img_size=args.image_size, dim=args.dim, depth=args.depth,
                             text_depth=args.text_depth, text_vocab=args.vocab_size,
                             generator=torch.Generator().manual_seed(args.seed))
    model = model.to(device).train()
    optimizer = build_optimizer(
        model, lr=args.lr, backbone_lr_scale=1.0, weight_decay=args.weight_decay,
        frozen_predicate=frozen_predicate(args.depth, args.text_depth,
                                          args.unfreeze_vision_layers,
                                          args.unfreeze_text_layers),
        mu_dtype=torch.bfloat16 if args.adam_mu_dtype == "bfloat16" else None)
    state = TrainState(model, optimizer)
    dedupe = not args.no_dedupe_concepts
    step = make_conceptclip_train_step(
        model, alpha=args.rc_alpha, compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        dedupe_concepts=dedupe)

    history = []
    for epoch in range(1, args.epochs + 1):
        t0 = time.time()
        for bi, batch in enumerate(epoch_batches(ds, tok, args, epoch, device, dedupe)):
            last = step(state, *batch)
            history.append(last)
            if bi % args.print_freq == 0:
                print(f"epoch {epoch} step {bi}: loss {float(last['loss']):.4f} "
                      f"(it {float(last['it_loss']):.4f}, rc {float(last['rc_loss']):.4f})")
        print(f">> epoch {epoch} in {time.time() - t0:.1f}s")

    save_checkpoint(args.save, {"state_dict": model.state_dict()})
    print(f">> saved {args.save}")
    return {"history": [{k: float(v) for k, v in m.items()} for m in history],
            "save": args.save}


if __name__ == "__main__":
    main()
