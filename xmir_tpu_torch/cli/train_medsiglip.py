"""MedSigLIP image-text contrastive fine-tuning CLI (port of
xmir_tpu/cli/train_medsiglip.py; reference train_medsiglip.py): class-label
prompts make (image, text) pairs, PK-sampled batches train a
``MedSigLIPDualEncoder`` with the SigLIP sigmoid loss (IT-Align), and the
last ``--unfreeze-layers`` layers of each tower train with its final norm
and head, the logit scale and bias; the rest is frozen.

    python -m xmir_tpu_torch.cli.train_medsiglip --dataset covid --dataset-dir DATA \\
        --vocab vocab.txt --bf16 --device cuda --save medsiglip_dual.pt

Text: the class prompts (models/siglip_text.py::COVIDX_LABEL_TO_TEXT)
through WordPiece with ``--vocab``, a JSON table of token ids per label with
``--token-table``, or else seeded synthetic ids per class (the JAX CLI's).
``--bf16`` casts the pixels only, as the JAX CLI does: the f32 parameters
promote every layer back to f32, so the attention takes K2 / K3 in f32 under
``XMIR_FLASH_ATTN=1`` and the eager path otherwise. The weights are drawn
from a torch.Generator seeded with ``--seed``. ``--save`` writes
{"state_dict": the dual encoder's state dict} (HF SiglipModel's layout), which
``cli.zeroshot --dual-checkpoint`` reads. The JAX CLI parses ``--resume`` and
never reads it; here a non-empty value raises.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .common import add_dataset_args, build_dataset, resolve_device, set_tf32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch MedSigLIP fine-tuning")
    add_dataset_args(p)
    p.add_argument("--resume", default="",
                   help="Not supported: the JAX CLI parses it and never reads it")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--epochs", default=3, type=int)
    p.add_argument("--batch-size", default=16, type=int)
    p.add_argument("--eval-batch-size", default=32, type=int)
    p.add_argument("--lr", default=1e-5, type=float)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--freeze-vision", action="store_true")
    p.add_argument("--freeze-text", action="store_true")
    p.add_argument("--unfreeze-layers", default=2, type=int)
    p.add_argument("--token-table", default="", help="JSON {label: [ids]}")
    p.add_argument("--vocab", default="",
                   help="Vocab file: tokenize class prompt templates with real WordPiece "
                        "instead of synthetic ids")
    p.add_argument("--seq-len", default=64, type=int)
    p.add_argument("--vocab-size", default=256000, type=int)
    p.add_argument("--dim", default=1152, type=int)
    p.add_argument("--depth", default=27, type=int)
    p.add_argument("--image-size", default=448, type=int)
    p.add_argument("--device", default="cuda",
                   help="Torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--save", default="./checkpoints/medsiglip.pt")
    return p.parse_args(argv)


def frozen_predicate(depth: int, unfreeze_layers: int, freeze_vision: bool = False,
                     freeze_text: bool = False):
    """The JAX CLI's freeze-all-but-last-N policy per tower (reference
    model.py:575-583) on the port's names: in ``vision_model.`` and
    ``text_model.`` only the last ``unfreeze_layers`` encoder layers, the
    final norm (``post_layernorm`` / ``final_layer_norm``) and the tower's
    ``head`` train, none with ``--freeze-vision`` / ``--freeze-text``;
    the logit scale and bias always train."""
    def frozen(name: str) -> bool:
        for tower, freeze_all in (("vision_model.", freeze_vision),
                                  ("text_model.", freeze_text)):
            if name.startswith(tower):
                if freeze_all:
                    return True
                layers = tuple(f"{tower}encoder.layers.{i}."
                               for i in range(depth - unfreeze_layers, depth))
                if name.startswith(layers):
                    return False
                return not ("post_layernorm" in name or "final_layer_norm" in name
                            or name.startswith(f"{tower}head."))
        return False
    return frozen


def class_token_table(args, classes):
    """{class: token ids} of each class's text, as the JAX CLI builds it;
    raises ``args.vocab_size`` to the WordPiece vocabulary's size."""
    if args.vocab:
        from ..data.wordpiece import BertWordPieceTokenizer
        from ..models.siglip_text import COVIDX_LABEL_TO_TEXT

        tok = BertWordPieceTokenizer(args.vocab, max_len=args.seq_len)
        args.vocab_size = max(args.vocab_size, tok.vocab_size)
        return {int(c): tok.encode_padded(
                    [COVIDX_LABEL_TO_TEXT.get(int(c), f"A medical image of class {int(c)}.")],
                    args.seq_len)[0][0].tolist() for c in classes}
    if args.token_table:
        with open(args.token_table) as f:
            return {int(k): v for k, v in json.load(f).items()}
    # deterministic synthetic per-class token ids (class-separable texts)
    rng = np.random.default_rng(42)
    return {c: rng.integers(1, min(args.vocab_size, 30000), args.seq_len).tolist()
            for c in classes}


def class_token_ids(table, labs, seq_len: int):
    """(B, seq_len) int64 token ids of each label's text, zero-padded."""
    ids = np.zeros((len(labs), seq_len), np.int64)
    for i, lab in enumerate(labs):
        tok = table[int(lab)][:seq_len]
        ids[i, :len(tok)] = tok
    return torch.from_numpy(ids)


def epoch_batches(train_ds, labels, batch_size: int, image_size: int, epoch: int, device):
    """The JAX CLI's batches of one epoch: a PK sampler seeded with the
    epoch (p = min(3, classes), k = max(2, batch_size // 3)), batches of
    ``batch_size`` (the last partial one dropped) decoded at image_size
    512 / 448 and center-cropped. Yields (pixels (B, S, S, 3) f32 on
    ``device``, labels)."""
    from ..data.pipeline import batch_iterator
    from ..data.samplers import PKSampler
    from ..data.transforms import eval_preprocess
    from ..models.registry import SIGLIP_MEAN, SIGLIP_STD

    classes = sorted(set(np.asarray(labels).tolist()))
    sampler = PKSampler(list(labels), min(3, len(classes)), max(2, batch_size // 3), seed=epoch)
    resize = int(image_size * 512 / 448)
    for imgs, labs, _ in batch_iterator(train_ds, batch_size, indices=list(sampler),
                                        image_size=resize, drop_last=True):
        yield eval_preprocess(torch.tensor(imgs, device=device), resize, image_size,
                              SIGLIP_MEAN, SIGLIP_STD), labs


def main(argv=None):
    args = parse_args(argv)
    if args.resume:
        raise ValueError(
            f"--resume {args.resume!r}: the JAX CLI parses --resume and never reads it, so "
            "there is no checkpoint layout to continue from; start without it")
    device = resolve_device(args)
    # as cli.train: deterministic cuDNN and no TF32, so two runs agree bit for bit
    torch.backends.cudnn.deterministic = True
    set_tf32(False)

    from ..models.siglip_text import MedSigLIPDualEncoder
    from ..train import TrainState, build_optimizer, make_it_align_train_step
    from ..utils.checkpoint import save_checkpoint

    train_ds = build_dataset(args, "train")
    labels = np.asarray(train_ds.labels)
    classes = sorted(set(labels.tolist()))
    table = class_token_table(args, classes)

    def texts_for(labs):
        return class_token_ids(table, labs, args.seq_len).to(device)

    model = MedSigLIPDualEncoder(img_size=args.image_size, text_vocab=args.vocab_size,
                                 dim=args.dim, depth=args.depth,
                                 generator=torch.Generator().manual_seed(args.seed))
    model = model.to(device).train()
    optimizer = build_optimizer(model, lr=args.lr, backbone_lr_scale=1.0,
                                frozen_predicate=frozen_predicate(
                                    args.depth, args.unfreeze_layers, args.freeze_vision,
                                    args.freeze_text))
    state = TrainState(model, optimizer)
    step = make_it_align_train_step(model, torch.bfloat16 if args.bf16 else torch.float32)

    losses = []
    for epoch in range(1, args.epochs + 1):
        t0, last = time.time(), None
        for x, labs in epoch_batches(train_ds, labels, args.batch_size, args.image_size, epoch,
                                     device):
            last = step(state, x, texts_for(labs))["loss"]
            losses.append(last)
        loss = float(last) if last is not None else 0.0
        print(f"epoch {epoch}: it_align loss {loss:.4f} ({time.time() - t0:.1f}s)")

    save_checkpoint(args.save, {"state_dict": model.state_dict()})
    print(f">> saved {args.save}")
    return {"losses": [float(v) for v in losses], "save": args.save}


if __name__ == "__main__":
    main()
