"""Model export CLI (port of xmir_tpu/cli/export.py; the reference's
convert_to_onnx.py role): write a trained checkpoint either as a state dict
in its source framework's layout (``--format torch``: loadable by the
reference's own torchvision / timm / HF tooling, and by this package's
``--resume``) or as a ``torch.export`` program (``--format exported``: a
``.pt2`` mapping an input batch to the embedding; load it with
``torch.export.load`` after importing ``xmir_tpu_torch.ops``).

    python -m xmir_tpu_torch.cli.export --model dinov2 --resume ckpt.pt \\
        --format torch --output dinov2_timm.pt
    python -m xmir_tpu_torch.cli.export --model dinov2 --resume ckpt.pt \\
        --format exported --batch 0 --output dinov2.pt2
"""
from __future__ import annotations

import argparse

from .common import add_model_args, build_model, resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch model export")
    add_model_args(p)
    p.add_argument("--format", default="torch", choices=["torch", "exported"])
    p.add_argument("--output", required=True,
                   help="torch: .pt/.pth (torch.save) or any other file (np.savez); "
                        "exported: a .pt2 file")
    p.add_argument("--batch", default=1, type=int,
                   help="exported: the program's batch (0 for a dynamic batch)")
    args = p.parse_args(argv)

    device = resolve_device(args)
    model, spec = build_model(args, device)
    size = args.image_size or spec.input_size

    from ..models import export as export_mod

    if args.format == "torch":
        sd = export_mod.export_backbone(args.model, model)
        out = export_mod.save_torch_state_dict(sd, args.output)
        print(f">> exported {len(sd)} tensors ({args.model}, torch layout) -> {out}")
        return out
    ep = export_mod.export_program(model, args.output, (max(args.batch, 1), size, size, 3),
                                   dynamic_batch=args.batch <= 0)
    ops = export_mod.xmir_op_counts(ep)
    print(f">> exported a torch.export program ({args.model}, "
          f"{'dynamic' if args.batch <= 0 else args.batch} x {size} x {size} x 3 on {device}; "
          f"kernel ops {ops or 'none'}) -> {args.output}")
    return args.output


if __name__ == "__main__":
    main()
