"""End-to-end demo on synthetic data through the port's CLIs (port of
examples/demo_end_to_end.py): train -> checkpoint -> evaluation -> ingest ->
query -> saliency -> insertion / deletion, on DenseNet121 (the main path).

    python -m xmir_tpu_torch.demo_end_to_end --workdir /tmp/xmir_demo --device cuda

``--device cpu`` runs it on the CPU. It writes ``summary.json`` with the JAX
demo's keys (``platform`` is the torch device type) beside the CLIs'
artifacts in ``--workdir``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="/tmp/xmir_demo")
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    p.add_argument("--epochs", type=int, default=2,
                   help="more epochs make the metrics log show a longer learning curve")
    p.add_argument("--use-mesh", action="store_true",
                   help="the saliency stage in the deployment shape: the sharded gallery "
                        "index and the XAI fan-out over a data-parallel world (a world of 1 "
                        "on one card)")
    args = p.parse_args(argv)

    from .cli import evaluate_saliency, ingest, query
    from .cli import test as test_cli
    from .cli import train as train_cli
    from .data.datasets import split_txt
    from .data.synthetic import write_synthetic_covidx

    os.makedirs(args.workdir, exist_ok=True)
    # the train CLI appends to its metrics log: start each run clean
    metrics_log = f"{args.workdir}/metrics.jsonl"
    if os.path.exists(metrics_log):
        os.remove(metrics_log)
    # hard mode: the classes share a mean colour and differ only by a subtle
    # frequency pattern under noise, so the untrained model scores near chance
    img_dir, manifest = write_synthetic_covidx(args.workdir, n=36, size=48, hard=True)
    split_txt(manifest, f"{args.workdir}/train.txt", f"{args.workdir}/val.txt", 0.25)
    common = ["--dataset", "covid", "--dataset-dir", img_dir, "--model", "densenet121",
              "--embedding-dim", "32", "--device", args.device]

    print("\n=== 1. train ===")
    train_cli.main(common + [
        "--train-image-list", f"{args.workdir}/train.txt",
        "--val-image-list", f"{args.workdir}/val.txt", "--val-dataset-dir", img_dir,
        "-p", "3", "-k", "4", "--epochs", str(args.epochs), "--eval-freq", "1",
        "--eval-initial", "--lr", "1e-3", "--loss-name", "triplet_hard",
        "--save-dir", f"{args.workdir}/ckpt", "--metrics-log", metrics_log])
    ckpt = sorted(glob.glob(f"{args.workdir}/ckpt/*best*.pt"))[0]

    print("\n=== 2. eval (reference test.py flow) ===")
    test_cli.main(common + ["--test-image-list", f"{args.workdir}/val.txt", "--resume", ckpt,
                            "--save-dir", args.workdir, "--eval-batch-size", "8"])

    print("\n=== 3. ingest + query ===")
    ingest.main(common + ["--split", "train", "--train-image-list", f"{args.workdir}/train.txt",
                          "--resume", ckpt, "--output", f"{args.workdir}/gallery.npz",
                          "--batch-size", "8"])
    query.main(common + ["--split", "test", "--test-image-list", f"{args.workdir}/val.txt",
                         "--resume", ckpt, "--index", f"{args.workdir}/gallery.npz",
                         "--top-k", "3", "--output", f"{args.workdir}/hits.json",
                         "--batch-size", "8"])
    with open(f"{args.workdir}/hits.json") as f:
        hits = json.load(f)
    correct = sum(1 for h in hits if h["results"][0]["label"] == h["query_label"])
    print(f">> top-1 label accuracy over {len(hits)} queries: {100 * correct / len(hits):.1f}%")

    print("\n=== 4. saliency + insertion/deletion ===")
    evaluate_saliency.main(common + [
        "--split", "test", "--test-image-list", f"{args.workdir}/val.txt", "--resume", ckpt,
        "--window-size", "48", "--stride", "24", "--top-k", "2", "--step", "6272",
        "--limit", "2", "--output", f"{args.workdir}/insdel.json"]
        + (["--use-mesh"] if args.use_mesh else []))

    with open(metrics_log) as f:
        records = [json.loads(line) for line in f]
    with open(f"{args.workdir}/insdel.json") as f:
        insdel = json.load(f)
    import torch

    summary = {
        "platform": torch.device(args.device).type,
        "time": time.time(),
        "epochs": args.epochs,
        "use_mesh": args.use_mesh,
        "eval_mAP_by_epoch": [r["mAP"] for r in records if r.get("kind") == "eval"],
        "top1_label_accuracy_pct": 100 * correct / len(hits),
        "n_queries": len(hits),
        "insdel": insdel,
    }
    with open(f"{args.workdir}/summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    print("\nDemo artifacts in", args.workdir)
    for name in sorted(os.listdir(args.workdir)):
        print("  ", name)
    return summary


if __name__ == "__main__":
    main()
