"""The XAI fan-out over a data-parallel world (xmir_tpu_torch/xai/sbsm.py
``*_mesh``, xai/causal.py ``causal_scores_batch_mesh`` and the pair runs'
``mesh=``) at a world of 2 ranks (gloo, spawned: tests/torch_mesh_workers.py)
against the JAX ``_mesh`` forms on the JAX conftest's 8 devices, on a narrow
DenseNet121 whose weights go from the JAX model to the port by
models/convert.py. Within 1e-5, the JAX tests' own bound
(tests/test_xai.py:515-600). The mask count (81) and the pair count (3, and 6
stacked on the both-curves path) divide neither world, so both pad."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from torch_mesh_workers import run_world, xai_worker
from torch_parity_models import NARROW, JaxNarrowEmbedder, randomized
from xmir_tpu.ops import blur as jax_blur
from xmir_tpu.parallel import mesh as jax_mesh
from xmir_tpu.xai import causal as jax_causal
from xmir_tpu.xai import sbsm as jax_sbsm
from xmir_tpu_torch.models import convert

TOL, SIZE, STEP, BATCH_STEPS = 1e-5, 64, 256, 3


def _images(b, seed):
    return np.random.default_rng(seed).standard_normal((b, SIZE, SIZE, 3)).astype(np.float32)


def test_fan_out_at_two_ranks_equals_the_jax_mesh(tmp_path):
    model = JaxNarrowEmbedder()
    variables = randomized(model.init(jax.random.PRNGKey(2), jnp.zeros((1, SIZE, SIZE, 3))), 5)

    def jembed(v, x):
        return model.apply(v, x)["embedding"]

    mesh = jax_mesh.make_mesh((8,), axis_names=(jax_mesh.DATA_AXIS,))
    x, xq, r = _images(2, 7), _images(1, 8), _images(3, 10)
    q = _images(1, 11)[0]
    masks = np.asarray(jax_sbsm.generate_masks(SIZE, 16, 8))
    expl = np.random.default_rng(9).random((3, SIZE, SIZE)).astype(np.float32)
    sub = np.asarray(jax_blur.gaussian_blur(jnp.asarray(r)))
    ranks = np.stack([np.asarray(jax_causal.saliency_rank(jnp.asarray(e))) for e in expl])
    q_feat = np.asarray(jembed(variables, jnp.asarray(q[None]))[0])

    want_self = np.asarray(jax_sbsm.sbsm_self_saliency_mesh(
        jembed, variables, jnp.asarray(x), jnp.asarray(masks), mesh, chunk=32))
    want_pair = np.asarray(jax_sbsm.sbsm_pair_saliency_mesh(
        jembed, variables, jnp.asarray(xq), jnp.asarray(x), jnp.asarray(masks), mesh, chunk=32))
    want_curves = np.asarray(jax_causal.causal_scores_batch_mesh(
        jembed, variables, jnp.asarray(q_feat), jnp.asarray(sub), jnp.asarray(r),
        jnp.asarray(ranks), STEP, mesh, BATCH_STEPS))
    jd, ji = jax_causal.run_causal_metric_pairs_both(
        jembed, variables, jnp.asarray(q), jnp.asarray(r), list(expl),
        jax_causal.zeros_substrate, jax_causal.blur_substrate(), step=STEP, mesh=mesh)

    state = convert.densenet_state_dict_from_jax(variables)
    kwargs = dict(embedding_dim=12, num_labels=3, **NARROW)
    out = run_world(xai_worker, 2, tmp_path, state, kwargs, x, xq, masks, q_feat, sub, r,
                    ranks, STEP, BATCH_STEPS, q, r, expl)
    for self_maps, pair_maps, curves, (td, ti) in out:
        assert self_maps.shape == (2, SIZE, SIZE) and pair_maps.shape == (1, 2, SIZE, SIZE)
        np.testing.assert_allclose(self_maps.numpy(), want_self, atol=TOL, rtol=0)
        np.testing.assert_allclose(pair_maps.numpy(), want_pair, atol=TOL, rtol=0)
        assert curves.shape == (3, 17)
        np.testing.assert_allclose(curves.numpy(), want_curves, atol=TOL, rtol=0)
        for (a, za), (b, zb) in zip(td + ti, jd + ji):
            assert abs(a - b) <= TOL and za == zb and 0.0 <= a <= 1.0
    # every rank holds the same reduced maps and gathered curves
    for a, b in zip(out[0][:3], out[1][:3]):
        assert (a == b).all()
