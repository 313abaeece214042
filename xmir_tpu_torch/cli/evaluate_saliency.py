"""Insertion / deletion saliency evaluation CLI (port of
xmir_tpu/cli/evaluate_saliency.py, the reference evaluate_saliency.py /
evaluate_test_dataset_milvus.py equivalent).

    python -m xmir_tpu_torch.cli.evaluate_saliency --dataset covid --device cuda \
        --saliency-dir saliency/ --top-k 5 --output insdel.json

Per query: the top-k of the gallery (the split's own embeddings, self-match
excluded) through ``ShardedGalleryIndex`` and the top-k kernel, the SBSM map
of each pair (loaded from ``--saliency-dir`` as ``cli.compute_saliency``
writes them, or computed inline), then the deletion (zeros substrate) and
insertion (gaussian blur) curves of all pairs in one batched computation;
per-class averages; the JSON saved every ``--save-every`` queries and
resumable with ``--skip-existing`` (reference evaluate_test_dataset_milvus.py:
428-437 substrates, 577-584 incremental save, 688-700 quality heuristics).
The blur and the model run in IEEE f32 unless ``--score-precision default``.
Without ``--saliency-dir`` the maps come from ``--explainer`` inline: sbsm,
simatt (conv backbones with a feature head), simcam, rollout (a ViT) or
gradcam_sim (a ViT with the ``token_delta`` tap: medsiglip).

``--use-mesh`` runs the gallery embedding, the sharded index, SBSM's mask
fan-out and the curves' pair fan-out over a data-parallel world
(parallel/mesh.py); rank 0 writes the JSON, whose summary records
``use_mesh`` and ``mesh_devices``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .common import (
    add_dataset_args,
    add_mesh_arg,
    add_model_args,
    add_precision_args,
    apply_score_precision,
    build_dataset,
    build_model,
    data_mesh,
    is_writer,
    resolve_device,
)
from .compute_saliency import image_preprocessor, pair_explainer


def main(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch insertion/deletion eval")
    add_dataset_args(p)
    add_model_args(p)
    add_precision_args(p)
    p.add_argument("--split", default="test", choices=["train", "val", "test"])
    p.add_argument("--saliency-dir", default="",
                   help="Precomputed maps (sal_q{q}_r{r}.npy); computed on the fly when empty")
    p.add_argument("--explainer", default="sbsm",
                   choices=["sbsm", "simatt", "simcam", "rollout", "gradcam_sim"],
                   help="Inline saliency (reference evaluate_test_dataset_milvus.py:368-426). "
                        "simatt / simcam need a conv backbone exposing 'features'; rollout / "
                        "gradcam_sim a ViT")
    p.add_argument("--window-size", default=24, type=int)
    p.add_argument("--stride", default=5, type=int)
    p.add_argument("--gpu-batch", default=128, type=int)
    p.add_argument("--top-k", default=5, type=int)
    p.add_argument("--step", default=1000, type=int,
                   help="Pixels per ins/del step (reference milvus driver uses 1000)")
    p.add_argument("--limit", default=0, type=int)
    p.add_argument("--save-every", default=10, type=int)
    p.add_argument("--skip-existing", action="store_true",
                   help="Resume: skip queries already present in --output "
                        "(reference evaluate_test_dataset_milvus.py:252-299)")
    p.add_argument("-j", "--workers", default=8, type=int)
    p.add_argument("--output", default="insertion_deletion_results.json")
    add_mesh_arg(p)
    args = p.parse_args(argv)
    apply_score_precision(args)
    device = resolve_device(args)
    with data_mesh(args, device) as mesh:
        return _run(args, mesh.device if mesh else device, mesh)


def _run(args, device, mesh):
    from ..data.pipeline import embed_dataset
    from ..index import ShardedGalleryIndex
    from ..metrics.saliency import saliency_quality
    from ..train import make_embed_fn
    from ..xai import blur_substrate, run_causal_metric_pairs_both, zeros_substrate

    dataset = build_dataset(args, args.split)
    model, spec = build_model(args, device)
    embed = make_embed_fn(model)
    prep = image_preprocessor(spec, device)

    print(f">> embedding {len(dataset)} gallery images ...")
    embeds, labels = embed_dataset(dataset, embed, spec, device=device,
                                   num_workers=args.workers, mesh=mesh)
    idx = ShardedGalleryIndex(embeds.shape[1])
    idx.add(embeds.cpu().numpy(), labels, [str(n) for n in dataset.image_names])
    idx.build(device, mesh=mesh)
    _, topk_ids = idx.search(embeds, k=args.top_k, exclude_ids=np.arange(len(dataset)))
    topk_ids = topk_ids.cpu().numpy()

    blur = blur_substrate()
    n_q = min(args.limit or len(dataset), len(dataset))
    pair_saliency = (None if args.saliency_dir
                     else pair_explainer(args, model, embed, spec.input_size, device, mesh))
    write = is_writer(mesh)

    results, done = [], set()
    if args.skip_existing and os.path.exists(args.output):
        with open(args.output) as f:
            prior = json.load(f)
        results = prior.get("results", prior if isinstance(prior, list) else [])
        done = {r["query_index"] for r in results}
        print(f">> resuming: {len(done)} queries already evaluated")
    for qi in range(n_q):
        if qi in done:
            continue
        q_img = prep(dataset.load_image(qi)[None])
        r_imgs = prep(np.stack([dataset.load_image(int(r)) for r in topk_ids[qi]]))
        if args.saliency_dir:
            sals = [np.load(os.path.join(args.saliency_dir, f"sal_q{qi:05d}_r{int(r):05d}.npy"))
                    for r in topk_ids[qi]]
        else:
            sals = pair_saliency(q_img, r_imgs)
        # deletion + insertion batched together across the top-k pairs: one
        # forward embeds a chunk of both curves' reveal images (2 x top_k
        # pairs; auto_batch_steps sizes the chunks)
        del_res, ins_res = run_causal_metric_pairs_both(
            embed, q_img[0], r_imgs, sals, zeros_substrate, blur, step=args.step, mesh=mesh)
        del_aucs = [a for a, _ in del_res]
        ins_aucs = [a for a, _ in ins_res]
        rec = {
            "query_index": qi,
            "query_label": np.asarray(dataset.labels[qi]).tolist(),
            "retrieved": topk_ids[qi].tolist(),
            "deletion_auc": float(np.mean(del_aucs)),
            "insertion_auc": float(np.mean(ins_aucs)),
            "per_pair_del": [float(a) for a in del_aucs],
            "per_pair_ins": [float(a) for a in ins_aucs],
        }
        rec["good_saliency"] = saliency_quality(rec["deletion_auc"], rec["insertion_auc"])
        results.append(rec)
        if write and ((qi + 1) % args.save_every == 0 or qi == n_q - 1):
            _save(args.output, results)
            print(f">> [{qi + 1}/{n_q}] del={rec['deletion_auc']:.3f} "
                  f"ins={rec['insertion_auc']:.3f}")

    mean_del = float(np.mean([r["deletion_auc"] for r in results]))
    mean_ins = float(np.mean([r["insertion_auc"] for r in results]))
    print(f">> mean deletion AUC {mean_del:.4f} (good < 0.6), "
          f"mean insertion AUC {mean_ins:.4f} (good > 0.7)")
    # per-class averages (reference AverageCounter, evaluate_saliency.py:95-116)
    per_class: dict = {}
    for r in results:
        entry = per_class.setdefault(str(r["query_label"]), {"del": [], "ins": []})
        entry["del"].append(r["deletion_auc"])
        entry["ins"].append(r["insertion_auc"])
    per_class_avg = {k: {"deletion_auc": float(np.mean(v["del"])),
                         "insertion_auc": float(np.mean(v["ins"])), "n": len(v["del"])}
                     for k, v in per_class.items()}
    for k, v in sorted(per_class_avg.items()):
        print(f">> class {k}: del {v['deletion_auc']:.4f} ins {v['insertion_auc']:.4f} "
              f"(n={v['n']})")
    summary = {"mean_deletion_auc": mean_del, "mean_insertion_auc": mean_ins,
               "n_queries": len(results), "per_class": per_class_avg,
               "use_mesh": mesh is not None,
               "mesh_devices": None if mesh is None else mesh.world, "index": idx.info()}
    if write:
        _save(args.output, results, summary=summary)
    return {"results": results, "summary": summary}


def _save(path, results, summary=None):
    payload = {"results": results}
    if summary:
        payload["summary"] = summary
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


if __name__ == "__main__":
    main()
