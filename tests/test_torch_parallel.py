"""The port's mesh (xmir_tpu_torch/parallel/mesh.py) against the JAX
package's: the FSDP rule against ``fsdp_state_shardings`` on the same shapes
at the JAX conftest's 8 devices (a pure function, no spawn), ``shard_batch``'s
padding, and the collectives at worlds 2 and 3 (gloo, spawned ranks on a
FileStore: tests/torch_mesh_workers.py): gather order, the gradients of
``gather_rows`` and ``all_reduce_with_grad``, ``replicate_tree``. Equality is
exact."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch

from torch_mesh_workers import gather_worker, run_world
from xmir_tpu.parallel import mesh as jax_mesh
from xmir_tpu_torch.parallel import (
    Mesh,
    fsdp_shard_axis,
    fsdp_state_shardings,
    shard_batch,
)

# (shape, dtype) leaves across the rule's edges: sizes about 65,536, axes the
# world divides or not, ties between equal axes, integer and scalar leaves
LEAVES = [((256, 256), "float32"), ((65536,), "float32"), ((65535,), "float32"),
          ((1000, 72), "float32"), ((7, 9363), "float32"), ((3, 3, 768, 64), "float32"),
          ((512, 128), "bfloat16"), ((512, 128), "int32"), ((2, 32768), "float32"),
          ((), "float32"), ((768,), "float32"), ((2304, 768), "float32"),
          ((12, 8, 683), "float32"), ((9, 65536), "float16")]


def _jax_axis(sharding):
    spec = tuple(sharding.spec)
    return spec.index("data") if "data" in spec else None


@pytest.mark.parametrize("world", [8, 2, 1])
def test_fsdp_rule_equals_jax(world):
    devices = jax.devices()[:world]
    mesh = jax_mesh.make_mesh((world,), axis_names=(jax_mesh.DATA_AXIS,), devices=devices)
    tree = {f"leaf{i}": jnp.zeros(shape, dtype) for i, (shape, dtype) in enumerate(LEAVES)}
    want = {k: _jax_axis(s) for k, s in jax_mesh.fsdp_state_shardings(tree, mesh).items()}
    ours = fsdp_state_shardings(
        {f"leaf{i}": torch.zeros(shape, dtype=getattr(torch, dtype))
         for i, (shape, dtype) in enumerate(LEAVES)}, world)
    assert ours == want
    if world == 8:
        assert sum(v is not None for v in ours.values()) >= 6  # the rule shards here
    assert fsdp_shard_axis((65536,), torch.float32, world, min_size=65537) is None


@pytest.mark.parametrize("b,world", [(7, 2), (7, 3), (6, 3), (1, 4), (8, 1)])
def test_shard_batch_pads_to_the_world(b, world):
    x = torch.arange(b, dtype=torch.float32)[:, None] + 1
    rows = -(-b // world)
    parts = []
    for rank in range(world):
        local, real = shard_batch(x, Mesh(world=world, rank=rank, device=torch.device("cpu")))
        assert real == b and local.shape == (rows, 1)
        parts.append(local)
    joined = torch.cat(parts)
    assert torch.equal(joined[:b], x) and not joined[b:].any()  # zero rows after the real ones


@pytest.mark.parametrize("world", [2, 3])
def test_collectives_in_rank_order(tmp_path, world):
    out = run_world(gather_worker, world, tmp_path)
    for rank, r in enumerate(out):
        assert (r["world"], r["rank"], r["owns"]) == (world, rank, False)
        assert torch.equal(r["gathered"], torch.tensor([[q, 10 * q] for q in range(world)]))
        want_rows = torch.cat([torch.arange(6.0).reshape(3, 2) + 100 * q for q in range(world)])
        assert torch.equal(r["rows"], want_rows)
        # the gradient of rank r's rows only: the coefficient block at its offset
        coef = torch.arange(6.0 * world).reshape(-1, 2)
        assert torch.equal(r["rows_grad"], coef[3 * rank:3 * rank + 3])
        assert torch.equal(r["total"], torch.full((2,), float(sum((q + 1) ** 2
                                                                  for q in range(world)))))
        # every rank's loss uses the sum, so its gradient is summed over ranks
        assert torch.equal(r["total_grad"], torch.tensor([1.0, 2.0]) * world * (rank + 1))
        rows = -(-7 // world)
        padded = torch.cat([torch.arange(7.0), torch.zeros(rows * world - 7)])[:, None]
        assert r["real"] == 7 and torch.equal(r["shard"], padded[rank * rows:(rank + 1) * rows])
        assert torch.equal(r["replicated"], torch.zeros(3))  # rank 0's tensor


def test_make_mesh_world_of_one_and_its_teardown():
    import torch.distributed as dist

    from xmir_tpu_torch.parallel import make_mesh

    assert not dist.is_initialized()
    for _ in range(2):  # a CLI tears down what it set up: a second world of 1 starts clean
        with make_mesh("cpu") as mesh:
            assert (mesh.world, mesh.rank, mesh.owns_group) == (1, 0, True)
            assert dist.is_initialized() and dist.get_backend() == "gloo"
            assert torch.equal(mesh.all_gather(torch.ones(2)), torch.ones(1, 2))
        assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 2 cards; 0 are visible"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("WORLD_SIZE", "2")
            mp.setattr(torch.cuda, "device_count", lambda: 0)
            make_mesh("cuda")
    assert not dist.is_initialized()
