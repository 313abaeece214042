"""Spawned worlds of torch.distributed ranks for the port's mesh tests.

``run_world(fn, world, tmp_path, *args)`` starts ``world`` processes with the
spawn method; each runs ``torch.set_num_threads(1)``, joins a gloo process
group on a ``FileStore`` under ``tmp_path`` (no port, so parallel test
workers never collide), calls ``fn(rank, world, *args)`` and hands its result
back through a file. ``fn`` must be importable by name (a module-level
function). This module imports no JAX, so the children start quickly.
"""
from __future__ import annotations

import os
import pickle
import traceback

import torch
import torch.multiprocessing as mp

WORLD_TIMEOUT = 240  # seconds a spawned world may take


def _entry(rank, world, store_path, out_dir, fn, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        payload = ("ok", result)
    except BaseException:  # reported to the parent, which raises it
        payload = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(payload, f)


def run_world(fn, world: int, tmp_path, *args):
    """[fn's result on rank 0, ..., rank world - 1]."""
    tmp_path = str(tmp_path)
    store = os.path.join(tmp_path, f"store_{fn.__name__}_{world}")
    out_dir = os.path.join(tmp_path, f"out_{fn.__name__}_{world}")
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, store, out_dir, fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=WORLD_TIMEOUT)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{len(alive)} ranks of {fn.__name__} did not finish in {WORLD_TIMEOUT} s"
    results, errors = [], []
    for r in range(world):
        # the children's own files: pickles this test wrote
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            errors.append(f"rank {r} of {fn.__name__} failed:\n{value}")
        results.append(value)
    assert not errors, "\n".join(errors)
    return results


def narrow_registry(specs, env=None):
    """Swap registry specs for narrow ones: {name: (model kwargs, size)};
    the fused-path switches unset, then ``env`` set."""
    import dataclasses

    from xmir_tpu_torch.models import registry

    for name, (kwargs, size) in specs.items():
        registry._SPECS[name] = dataclasses.replace(
            registry.get_spec(name), kwargs=tuple(sorted(kwargs.items())),
            input_size=size, resize_size=size)
    for flag in ("XMIR_FLASH_ATTN", "XMIR_FUSED_LN", "XMIR_FUSED_LN_QKV", "XMIR_FUSED_LN_MLP"):
        os.environ.pop(flag, None)
    os.environ.update(env or {})


def train_worker(rank, world, runs, specs, env=None):
    """cli.train.main(argv) for each argv of ``runs`` on narrow registry
    models; returns this rank's record of each run: the parameters and
    buffers before the first step (``start``), the group norms of every
    optimiser call before the clip (``norms``), the last whole state the CLI
    checkpointed (``state``), the sharded state's bytes after each step
    (``bytes``) and the model's buffers at the end (``buffers``)."""
    from xmir_tpu_torch.cli import train as train_cli
    from xmir_tpu_torch.parallel import data_parallel
    from xmir_tpu_torch.train import optim, state

    narrow_registry(specs, env)
    rec = {}
    norm = optim.GroupedAdam._global_norm

    def global_norm(self, params, grads):
        out = norm(self, params, grads)
        rec["norms"].append(float(out))
        return out

    def cpu(tree):
        return {k: v.detach().cpu().clone() for k, v in tree.items()}

    def wrap(cls):
        real_state_dict, real_gather = cls.state_dict, cls.gather_params

        def state_dict(self):
            out = real_state_dict(self)
            rec["state"] = {"state_dict": cpu(out["state_dict"]), "optimizer": out["optimizer"],
                            "step": out["step"]}
            rec["buffers"] = cpu(dict(self.model.named_buffers()))
            return out

        def gather_params(self):
            real_gather(self)
            if rec["start"] is None:
                rec["start"] = cpu(self.model.state_dict())

        cls.state_dict, cls.gather_params = state_dict, gather_params

    real_apply = data_parallel.MeshTrainState.apply_gradients

    def apply_gradients(self):
        real_apply(self)
        rec["bytes"].append(self.sharded_state_bytes())

    optim.GroupedAdam._global_norm = global_norm
    wrap(state.TrainState)
    wrap(data_parallel.MeshTrainState)
    data_parallel.MeshTrainState.apply_gradients = apply_gradients
    out = []
    for argv in runs:
        rec = {"norms": [], "bytes": [], "state": None, "buffers": None, "start": None}
        train_cli.main(list(argv))
        out.append(rec)
    return out


def gather_worker(rank, world):
    """The mesh's collectives on rank-dependent tensors: all_gather,
    gather_rows and all_reduce_with_grad with their gradients, shard_batch,
    replicate_tree."""
    from xmir_tpu_torch.parallel import make_mesh, replicate_tree, shard_batch

    mesh = make_mesh("cpu")
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 100 * rank
    x.requires_grad_(True)
    rows = mesh.gather_rows(x)
    (rows * torch.arange(rows.numel(), dtype=torch.float32).reshape(rows.shape)).sum().backward()
    y = torch.full((2,), float(rank + 1), requires_grad=True)
    total = mesh.all_reduce_with_grad(y * (rank + 1))
    (total * torch.tensor([1.0, 2.0])).sum().backward()
    local, real = shard_batch(torch.arange(7.0)[:, None], mesh)
    state = {"w": torch.full((3,), float(rank))}
    replicate_tree(state, mesh)
    return {"world": mesh.world, "rank": mesh.rank, "owns": mesh.owns_group,
            "gathered": mesh.all_gather(torch.tensor([rank, 10 * rank])),
            "rows": rows.detach(), "rows_grad": x.grad, "total": total.detach(),
            "total_grad": y.grad, "shard": local, "real": real, "replicated": state["w"]}


def index_worker(rank, world, cases):
    """ShardedGalleryIndex over the world: for each case (metric, gallery,
    queries, k, exclude), this rank's search result, its full ranking for
    the first case, and info()."""
    from xmir_tpu_torch.index.gallery import ShardedGalleryIndex
    from xmir_tpu_torch.parallel import make_mesh

    mesh = make_mesh("cpu")
    out = []
    for metric, gallery, queries, k, exclude in cases:
        idx = ShardedGalleryIndex(gallery.shape[1], metric=metric)
        idx.add(gallery)
        idx.build(mesh=mesh)
        out.append((idx.search(queries, k, exclude_ids=exclude), idx.full_ranking(queries),
                    idx.info(), idx._device_embeds.shape[0]))
    return out


def xai_worker(rank, world, state_dict, model_kwargs, x, xq, masks, q_feat, starts, finishes,
               ranks, step, batch_steps, q_img, r_imgs, expl):
    """SBSM self / pair maps, causal curves and both-curves AUCs of a
    DenseNet121Embedder(**model_kwargs) holding ``state_dict``, with the
    mask and pair axes split over the world."""
    from xmir_tpu_torch.models.embedders import DenseNet121Embedder
    from xmir_tpu_torch.parallel import make_mesh
    from xmir_tpu_torch.train import make_embed_fn
    from xmir_tpu_torch.xai import causal, sbsm

    mesh = make_mesh("cpu")
    model = DenseNet121Embedder(**model_kwargs)
    model.load_state_dict(state_dict, strict=True)
    embed = make_embed_fn(model.eval())
    t = torch.from_numpy
    self_maps = sbsm.sbsm_self_saliency_mesh(embed, t(x), t(masks), mesh, chunk=32)
    pair_maps = sbsm.sbsm_pair_saliency_mesh(embed, t(xq), t(x), t(masks), mesh, chunk=32)
    curves = causal.causal_scores_batch_mesh(embed, t(q_feat), t(starts), t(finishes), t(ranks),
                                             step, mesh, batch_steps)
    both = causal.run_causal_metric_pairs_both(
        embed, t(q_img), t(r_imgs), list(expl), causal.zeros_substrate,
        causal.blur_substrate(), step=step, mesh=mesh)
    return self_maps, pair_maps, curves, both


def cli_worker(rank, world, root, common, saliency):
    """The serving and XAI CLIs with --use-mesh at this world, into
    ``root/w{world}``: ingest (with --upload-originals) -> query, cli.test,
    compute_saliency (pair maps of a cli.test artifact), evaluate_saliency
    (its maps inline),
    and cli.train with --cache-dir twice beside a run without it. Returns
    what each CLI returned on this rank."""
    from xmir_tpu_torch.cli import compute_saliency, evaluate_saliency, ingest, query
    from xmir_tpu_torch.cli import test as test_cli
    from xmir_tpu_torch.cli import train as train_cli

    out_dir = os.path.join(root, f"w{world}")
    os.makedirs(out_dir, exist_ok=True)
    mesh = ["--use-mesh"]
    gal = os.path.join(out_dir, "g.npz")
    idx = ingest.main(common + mesh + ["--split", "train", "--output", gal,
                                       "--upload-originals", os.path.join(out_dir, "store")])
    hits = query.main(common + mesh + ["--index", gal, "--top-k", "3",
                                       "--output", os.path.join(out_dir, "h.json")])
    metrics = test_cli.main(common + mesh + ["--save-dir", os.path.join(out_dir, "res")])
    maps = os.path.join(out_dir, "maps")
    compute_saliency.main(common + mesh + saliency + [
        "--results", os.path.join(root, "w1_ref", "res", "evaluation_results.npz"),
        "--save-dir", maps])
    insdel = evaluate_saliency.main(common + mesh + saliency + [
        "--step", "1024", "--output", os.path.join(out_dir, "i.json")])
    train = ["--dataset", "synthetic", "--device", "cpu", "--model", "tiny", "--embedding-dim",
             "16", "-p", "2", "-k", "8", "--epochs", "1", "--eval-freq", "100",
             "--ckpt-every", "1", "-j", "2", "--lr", "0.01", "--seed", "3",
             "--use-random-sampler"] + mesh
    cache = os.path.join(out_dir, "cache")
    for name, extra in (("plain", []), ("cached1", ["--cache-dir", cache]),
                        ("cached2", ["--cache-dir", cache])):
        train_cli.main(train + extra + ["--save-dir", os.path.join(out_dir, name)])
        if name == "cached1":
            complete = os.path.exists(os.path.join(cache, "meta.json"))
    return {"info": idx.info(), "hits": hits, "metrics": metrics, "insdel": insdel,
            "cache_complete_after_epoch_1": complete}


class TwoDense(torch.nn.Module):
    """The JAX TP test's model (tests/test_train.py ``TestTensorParallel``):
    Dense(512) -> ReLU -> Dense(512), torch's layout."""

    def __init__(self, d_in: int = 64, width: int = 512):
        super().__init__()
        self.wide1 = torch.nn.Linear(d_in, width)
        self.wide2 = torch.nn.Linear(width, width)

    def forward(self, x):
        return {"out": self.wide2(torch.relu(self.wide1(x)))}


class Narrowing(torch.nn.Module):
    """Convolutions that narrow (the rule splits them by their input
    channels, as it splits DenseNet121's transitions) and a head that widens
    (split by its outputs): 3 -> 32 (3x3, stride 2) -> 16 (1x1) -> 8 (3x3,
    padding 1), ReLUs, GAP -> Linear(8, 32)."""

    def __init__(self):
        super().__init__()
        self.conv0 = torch.nn.Conv2d(3, 32, 3, stride=2)
        self.conv1 = torch.nn.Conv2d(32, 16, 1)
        self.conv2 = torch.nn.Conv2d(16, 8, 3, padding=1)
        self.fc = torch.nn.Linear(8, 32)

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        for conv in (self.conv0, self.conv1, self.conv2):
            h = torch.relu(conv(h))
        return {"embedding": self.fc(h.mean(dim=(2, 3)))}


def tp_model(kind, kwargs):
    """(module, the output key) of a TP case's model."""
    from xmir_tpu_torch.models import vit
    from xmir_tpu_torch.models.embedders import TinyEmbedder

    if kind == "vit":
        return vit.ViTBackbone(**kwargs), "cls"
    if kind == "tiny":
        return TinyEmbedder(**kwargs), "embedding"
    if kind == "narrowing":
        return Narrowing(**kwargs), "embedding"
    return TwoDense(**kwargs), "out"


def tp_piece_leaves(model):
    """parameter name -> (leaf name, split axis, indices along the axis of
    the whole leaf) of every piece ``tensor_parallel`` left in
    ``model``: a split layer's weight pieces and a gathered-at-use leaf's
    stacked pieces (the ranks' indices in rank order)."""
    from torch.nn.utils import parametrize

    from xmir_tpu_torch.parallel import tensor_parallel as tpm

    leaves = {}
    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(module, tpm.ShardedLeaf):
            leaves.update({f"{prefix}pieces.{r}": (module.name, module.dim, module.rows(int(r)))
                           for r in module.pieces})
        if parametrize.is_parametrized(module):
            for leaf, chain in module.parametrizations.items():
                (gathered,) = chain
                size = chain.original.shape[gathered.dim + 1]
                leaves[f"{prefix}parametrizations.{leaf}.original"] = (
                    gathered.name, gathered.dim,
                    torch.cat([torch.arange(r * size, (r + 1) * size)
                               for r in gathered.axis.ranks]))
    return leaves


def tp_piece_grad(name, grad, dim):
    """A piece's gradient laid out along ``dim`` as ``tp_piece_leaves``'s
    indices: a gathered-at-use leaf's stacked pieces joined."""
    return torch.cat(list(grad.unbind(0)), dim) if "parametrizations." in name else grad


def tp_worker(rank, world, shape, cases):
    """Each case's model split by ``tensor_parallel`` over a (data, model)
    mesh of ``shape``: the batch split over the data axis, the output
    gathered over it, the loss sum(out * cotangent) of the rank's rows
    differentiated and every gradient summed over the data axis. Returns
    the mesh's layout (coordinates, the ranks of this rank's row and
    column) and per case the output, the replicated leaves' gradients, the
    sharded leaves' piece gradients {name: (dim, indices along dim, grad)}
    and the gathers at use."""
    from xmir_tpu_torch.parallel import make_mesh, shard_batch
    from xmir_tpu_torch.parallel import tensor_parallel as tpm

    flags = ("XMIR_FLASH_ATTN", "XMIR_FUSED_LN", "XMIR_FUSED_LN_QKV", "XMIR_FUSED_LN_MLP")
    with make_mesh("cpu", shape) as mesh:
        me = torch.tensor([rank])
        out = {"coords": (mesh.data_rank, mesh.model_rank),
               "row": mesh.model_all_gather(me).flatten().tolist(),
               "column": mesh.all_gather(me).flatten().tolist(), "cases": []}
        for case in cases:
            for flag in flags:
                os.environ.pop(flag, None)
            os.environ.update(case.get("env", {}))
            model, key = tp_model(*case["model"])
            model.load_state_dict(case["state_dict"])
            tpm.tensor_parallel(model, mesh, min_dim=case.get("min_dim", 256))
            tpm.GATHERS.clear()
            x, _ = shard_batch(case["x"], mesh)
            cot, _ = shard_batch(case["cotangent"], mesh)
            y = model(x)[key]
            (y * cot).sum().backward()
            rec = {"out": mesh.all_gather(y.detach()).reshape((-1,) + tuple(y.shape[1:])),
                   "gathers": dict(tpm.GATHERS), "grads": {}, "pieces": {}}
            leaves = tp_piece_leaves(model)
            for name, p in model.named_parameters():
                g = mesh.all_reduce_(p.grad.clone())
                if name in leaves:
                    leaf, dim, rows = leaves[name]
                    rec["pieces"][leaf] = (dim, rows, tp_piece_grad(name, g, dim))
                else:
                    rec["grads"][name] = g
            out["cases"].append(rec)
    return out
