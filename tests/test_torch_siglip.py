"""The port's SigLIP towers (models/siglip.py, models/siglip_text.py,
MedSigLIPEmbedder, their converters, K7's head-width-72 rule) against the
JAX package on the same numpy inputs and weights. Tier 1: CPU only.

Narrow towers at SO400M's head width of 72 (dim 288, 4 heads, depth 2,
intermediate 576), images at multiples of the patch (14). Tolerances: f32,
within 1e-5 (1 + |jax|) (the stacks sum in other orders); 1e-4 where the
positions are resized (PyTorch's antialiased bilinear against
``jax.image.resize``). The fused branches run the kernels' plain versions
here (a CPU tensor takes them) and the JAX package's LN -> qkv kernel in
interpret mode, with its reference attention (tests/test_ln_dense.py's
setup)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmir_tpu.models import convert as jax_convert
from xmir_tpu.models import embedders as jax_embedders
from xmir_tpu.models import siglip as jax_siglip
from xmir_tpu.models import siglip_text as jax_siglip_text
from xmir_tpu.ops import ln_dense_pallas as jln
from xmir_tpu.ops import plain_attn as jpa
from xmir_tpu_torch.models import convert, siglip, siglip_text
from xmir_tpu_torch.models.embedders import MedSigLIPEmbedder
from xmir_tpu_torch.ops import ln_dense as ld

TOL, RESIZE_TOL = 1e-5, 1e-4
NARROW = dict(patch_size=14, dim=288, depth=2, num_heads=4, intermediate=576)
IMG = 56  # a 4 x 4 grid of patches
FLAGS = ("XMIR_FLASH_ATTN", "XMIR_FUSED_LN", "XMIR_FUSED_LN_QKV", "XMIR_FUSED_LN_QKV72")


def close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) - tol * (1 + np.abs(ref))
    assert err.max() <= 0, f"max excess {err.max()}"


def _randomized(variables, seed, scale=0.1):
    """Every leaf redrawn: matrices scale N(0, 1) (0.1 at width 288: a gain
    of 1.7 a product), vectors (LN scales, biases) 0.5 + 0.3 N(0, 1), so that
    each takes part."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(variables)
    out = []
    for leaf in leaves:
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        out.append(0.5 + 0.3 * a if leaf.ndim == 1 else scale * a)
    return jax.tree_util.tree_unflatten(tree, [jnp.asarray(a) for a in out])


def _np(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _images(b, size, seed):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


@pytest.fixture
def clean_flags(monkeypatch):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _vision_pair(seed, use_head=True, widths=NARROW, img=IMG):
    model = jax_siglip.SiglipVisionBackbone(img_size=img, use_head=use_head, **widths)
    # the narrow towers' gain at every width: 0.1 sqrt(288 / dim)
    variables = _randomized(model.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3))),
                            seed, 0.1 * (288 / widths["dim"]) ** 0.5)
    port = siglip.SiglipVisionBackbone(img_size=img, use_head=use_head, **widths)
    port.load_state_dict(convert.siglip_vision_state_dict_from_jax(_np(variables)), strict=True)
    return model, variables, port.eval()


@pytest.mark.parametrize("size", [IMG, 42, 70], ids=["grid", "smaller", "larger"])
def test_vision_backbone_eager_matches_jax(clean_flags, size):
    """pooled, tokens, encoder_tokens and every layer's attention weights: at
    the grid the positions were made for, and at 3 x 3 and 5 x 5 (the
    positions resized down, antialiased, and up)."""
    model, variables, port = _vision_pair(seed=1)
    x = _images(2, size, seed=2)
    ref = model.apply(variables, jnp.asarray(x), output_attentions=True)
    with torch.inference_mode():
        out = port(torch.from_numpy(x), output_attentions=True)
    n = (size // 14) ** 2
    tol = TOL if size == IMG else RESIZE_TOL
    assert out["tokens"].shape == (2, n, 288) and len(out["attentions"]) == 2
    for key in ("pooled", "tokens", "encoder_tokens"):
        close(out[key].numpy(), ref[key], tol)
    for a, r in zip(out["attentions"], ref["attentions"]):
        assert a.shape == (2, 4, n, n) and a.dtype == torch.float32
        close(a.numpy(), r, tol)
    with torch.inference_mode():
        assert port(torch.from_numpy(x))["attentions"] is None


def test_resize_positions_matches_jax():
    pos = np.random.default_rng(3).standard_normal((36, 8)).astype(np.float32)
    for g in (3, 4, 6, 9):
        ref = jax.image.resize(jnp.asarray(pos).reshape(1, 6, 6, 8), (1, g, g, 8), "bilinear")
        out = siglip.resize_positions(torch.from_numpy(pos), g, g)
        close(out.numpy(), np.asarray(ref).reshape(g * g, 8), 1e-6)


def test_without_head_and_token_delta(clean_flags):
    """use_head=False leaves pooled None; token_delta moves encoder_tokens
    and tokens by exactly the JAX module's amount."""
    model, variables, port = _vision_pair(seed=4, use_head=False)
    x = _images(2, IMG, seed=5)
    delta = np.random.default_rng(6).standard_normal((2, 16, 288)).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(x), token_delta=jnp.asarray(delta))
    with torch.inference_mode():
        out = port(torch.from_numpy(x), token_delta=torch.from_numpy(delta))
    assert out["pooled"] is None and ref["pooled"] is None
    close(out["encoder_tokens"].numpy(), ref["encoder_tokens"])
    close(out["tokens"].numpy(), ref["tokens"])


@pytest.fixture
def jax_fused_branch(monkeypatch):
    """The JAX SigLIP layer's fused branches on the CPU, wired as
    tests/test_ln_dense.py::TestSiglipFusedBranch wires them: the gates
    opened, the LN -> qkv kernel in interpret mode, the reference attention."""
    def attn_ref(q, k, v, scale):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32) * scale
        p = jax.nn.softmax(s, axis=-1)
        return jnp.einsum("bhqk,bhkd->bhqd", p.astype(v.dtype), v)

    real_fused = jln.ln_qkv_fused
    monkeypatch.setattr(jln, "fused_ln_enabled", lambda dtype: True)
    monkeypatch.setattr(jpa, "plain_flash_enabled", lambda dtype, n: True)
    monkeypatch.setattr(jpa, "flash_attention_plain", attn_ref)
    monkeypatch.setattr(jln, "ln_qkv_fused", lambda x, s, bb, w, bias, h: real_fused(
        x, s, bb, w, bias, h, 1e-6, 32, True))


def _counted(monkeypatch, mod, name):
    calls, fn = [], getattr(mod, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(mod, name, counted)
    return calls


# K7 takes head width 72 only where C is a multiple of 128, so at 16 heads or
# a multiple: SO400M's width with two layers, a narrow MLP and a 2 x 2 grid
WIDE = dict(patch_size=14, dim=1152, depth=2, num_heads=16, intermediate=256)


@pytest.mark.parametrize("qkv72", ["1", None], ids=["fused-ln-qkv", "batched-projection"])
def test_fused_branches_match_default_and_jax(clean_flags, jax_fused_branch, qkv72):
    """XMIR_FUSED_LN=1 XMIR_FLASH_ATTN=1 at head width 72 (C = 1152, 16
    heads): with XMIR_FUSED_LN_QKV72=1 every layer folds layer_norm1 into the
    packed projection (K7's plain version) before K2's; without it the layers
    take the batched head-major projection into K2's. Either equals the
    port's default (eager) branch and the JAX package's branch of the same
    name."""
    model, variables, port = _vision_pair(seed=7, widths=WIDE, img=28)
    x = _images(2, 28, seed=8)
    with torch.inference_mode():
        default = port(torch.from_numpy(x))
    clean_flags.setenv("XMIR_FUSED_LN", "1")
    clean_flags.setenv("XMIR_FLASH_ATTN", "1")
    if qkv72:
        clean_flags.setenv("XMIR_FUSED_LN_QKV72", "1")
    k7 = _counted(clean_flags, siglip, "ln_qkv_fused")
    k2 = _counted(clean_flags, siglip, "flash_attention_plain")
    jk7 = _counted(clean_flags, jln, "ln_qkv_fused")
    ref = model.apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert (len(k7), len(k2), len(jk7)) == ((2, 2, 2) if qkv72 else (0, 2, 0))
    for key in ("pooled", "tokens"):
        close(out[key].numpy(), ref[key])
        close(out[key].numpy(), default[key].numpy())


@pytest.mark.parametrize("c,hd", [(1152, 72), (1150, 72), (768, 64), (384, 128), (128, 16)])
@pytest.mark.parametrize("switch", ["1", None])
def test_ln_qkv_eligible_matches_jax(clean_flags, c, hd, switch):
    if switch:
        clean_flags.setenv("XMIR_FUSED_LN_QKV72", switch)
    assert ld.ln_qkv_eligible(c, hd) == jln.ln_qkv_eligible(c, hd)
    assert ld.ln_qkv_eligible(c, hd) == (c % 128 == 0 and (hd in (32, 64, 128) or (
        hd == 72 and switch == "1")))


def test_output_attentions_never_takes_a_kernel(clean_flags):
    _, _, port = _vision_pair(seed=9)
    for name in FLAGS[:2]:
        clean_flags.setenv(name, "1")
    clean_flags.setenv("XMIR_FUSED_LN_QKV72", "1")
    for name in ("ln_qkv_fused", "flash_attention_plain"):
        clean_flags.setattr(siglip, name, lambda *a, **k: pytest.fail("a kernel wrapper ran"))
    with torch.inference_mode():
        out = port(torch.from_numpy(_images(1, IMG, seed=0)), output_attentions=True)
    np.testing.assert_allclose(out["attentions"][1].sum(-1).numpy(), 1.0, atol=1e-5)


DUAL = dict(img_size=IMG, text_vocab=100, dim=288, depth=2, num_heads=4, intermediate=576)


def _dual_pair(seed):
    model = jax_siglip_text.MedSigLIPDualEncoder(**DUAL)
    variables = _randomized(model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
                                       jnp.zeros((1, 8), jnp.int32)), seed)
    port = siglip_text.MedSigLIPDualEncoder(**DUAL)
    port.load_state_dict(convert.medsiglip_dual_state_dict_from_jax(_np(variables)), strict=True)
    return model, variables, port.eval()


@pytest.mark.parametrize("flash", [None, "1"], ids=["eager", "fused-attention"])
def test_dual_encoder_features_match_jax(clean_flags, jax_fused_branch, flash):
    """get_text_features (SiglipTextBackbone: full attention, the last token
    pooled through head) and get_image_features; with XMIR_FLASH_ATTN=1 the
    text tower's layers take K2's plain version."""
    model, variables, port = _dual_pair(seed=10)
    ids = np.random.default_rng(11).integers(0, 100, (3, 16)).astype(np.int32)
    x = _images(2, IMG, seed=12)
    if flash:
        clean_flags.setenv("XMIR_FLASH_ATTN", "1")
    k2 = _counted(clean_flags, siglip, "flash_attention_plain")
    ref_t = model.apply(variables, jnp.asarray(ids),
                        method=jax_siglip_text.MedSigLIPDualEncoder.get_text_features)
    ref_i = model.apply(variables, jnp.asarray(x),
                        method=jax_siglip_text.MedSigLIPDualEncoder.get_image_features)
    with torch.inference_mode():
        txt = port.get_text_features(torch.from_numpy(ids).long())
        img = port.get_image_features(torch.from_numpy(x))
        full = port(torch.from_numpy(x), torch.from_numpy(ids).long())
    assert len(k2) == (8 if flash else 0)  # text 2 + image 2, both again in forward
    close(txt.numpy(), ref_t)
    close(img.numpy(), ref_i)
    assert torch.equal(full["text_features"], txt)
    close(full["logit_scale"].item(), variables["params"]["logit_scale"])
    close(full["logit_bias"].item(), variables["params"]["logit_bias"])
    text = siglip_text.SiglipTextBackbone(vocab_size=100, **{
        k: DUAL[k] for k in ("dim", "depth", "num_heads", "intermediate")})
    text.load_state_dict({k[len("text_model."):]: v for k, v in port.state_dict().items()
                          if k.startswith("text_model.")}, strict=True)
    with torch.inference_mode():
        out = text.eval()(torch.from_numpy(ids).long())
    assert out["tokens"].shape == (3, 16, 288) and torch.equal(out["pooled"], txt)


@pytest.fixture
def narrow_jax_medsiglip(monkeypatch):
    """The JAX MedSigLIPEmbedder builds its tower at SO400M's widths; its
    SiglipVisionBackbone is swapped for the narrow one."""
    def narrow(**kwargs):
        return jax_siglip.SiglipVisionBackbone(img_size=IMG, name=kwargs["name"], **NARROW)

    monkeypatch.setattr(jax_embedders, "SiglipVisionBackbone", narrow)


@pytest.mark.parametrize("embed_dim", [512, 24])
def test_medsiglip_embedder_matches_jax(clean_flags, narrow_jax_medsiglip, embed_dim):
    model = jax_embedders.MedSigLIPEmbedder(embed_dim=embed_dim)
    x = _images(3, IMG, seed=13)
    variables = _randomized(model.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=14)
    port = MedSigLIPEmbedder(embed_dim, img_size=IMG, **NARROW)
    port.load_state_dict(convert.medsiglip_state_dict_from_jax(_np(variables)), strict=True)
    ref = model.apply(variables, jnp.asarray(x), output_attentions=True)
    with torch.inference_mode():
        out = port.eval()(torch.from_numpy(x), output_attentions=True)
    assert out["embedding"].shape == (3, embed_dim)
    np.testing.assert_allclose(out["embedding"].norm(dim=1).numpy(), 1.0, atol=1e-5)
    for key in ("embedding", "tokens", "encoder_tokens"):
        close(out[key].numpy(), ref[key])
    close(out["attentions"][-1].numpy(), ref["attentions"][-1])


def _hf_siglip_vision_state_dict(seed):
    """An HF SiglipVisionModel state dict (``vision_model.`` keys, the
    position_ids buffer some versions save) of random numpy tensors."""
    rng = np.random.default_rng(seed)
    d, m = NARROW["dim"], NARROW["intermediate"]

    def r(*shape, base=0.0, sc=0.1):
        return (base + sc * rng.standard_normal(shape)).astype(np.float32)

    sd = {"embeddings.patch_embedding.weight": r(d, 3, 14, 14),
          "embeddings.patch_embedding.bias": r(d),
          "embeddings.position_embedding.weight": r(16, d),
          "embeddings.position_ids": np.arange(16)[None],
          "post_layernorm.weight": r(d, base=1.0), "post_layernorm.bias": r(d),
          "head.probe": r(1, 1, d), "head.attention.in_proj_weight": r(3 * d, d),
          "head.attention.in_proj_bias": r(3 * d), "head.attention.out_proj.weight": r(d, d),
          "head.attention.out_proj.bias": r(d), "head.layernorm.weight": r(d, base=1.0),
          "head.layernorm.bias": r(d), "head.mlp.fc1.weight": r(m, d),
          "head.mlp.fc1.bias": r(m), "head.mlp.fc2.weight": r(d, m), "head.mlp.fc2.bias": r(d)}
    for i in range(NARROW["depth"]):
        pre = f"encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{pre}.{ln}.weight"], sd[f"{pre}.{ln}.bias"] = r(d, base=1.0), r(d)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{pre}.self_attn.{proj}.weight"] = r(d, d)
            sd[f"{pre}.self_attn.{proj}.bias"] = r(d)
        sd.update({f"{pre}.mlp.fc1.weight": r(m, d), f"{pre}.mlp.fc1.bias": r(m),
                   f"{pre}.mlp.fc2.weight": r(d, m), f"{pre}.mlp.fc2.bias": r(d)})
    return {f"vision_model.{k}": v for k, v in sd.items()}


def test_hf_siglip_layout_loads_strictly_and_matches_jax(clean_flags, tmp_path):
    """An HF SiglipVisionModel state dict through the JAX converter
    (convert_siglip_vision) and, unchanged, into the port: a strict load of
    the backbone, and --resume's loader into a MedSigLIPEmbedder."""
    sd = _hf_siglip_vision_state_dict(seed=15)
    model = jax_siglip.SiglipVisionBackbone(img_size=IMG, **NARROW)
    variables = jax_convert.convert_siglip_vision(
        {k: v for k, v in sd.items() if not k.endswith("position_ids")}, depth=2)
    tsd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    port = siglip.SiglipVisionBackbone(img_size=IMG, **NARROW)
    port.load_state_dict(convert.siglip_vision_state_dict_from_torch(tsd), strict=True)
    x = _images(2, IMG, seed=16)
    ref = model.apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        out = port.eval()(torch.from_numpy(x))
    close(out["pooled"].numpy(), ref["pooled"])
    close(out["tokens"].numpy(), ref["tokens"])
    emb = MedSigLIPEmbedder(img_size=IMG, generator=torch.Generator().manual_seed(0), **NARROW)
    proj = {k: v.clone() for k, v in emb.projection.state_dict().items()}
    pt = str(tmp_path / "siglip_hf.pt")
    torch.save(tsd, pt)
    convert.load_torch_checkpoint(emb, pt)
    assert all(torch.equal(emb.backbone.state_dict()[k], v)
               for k, v in port.state_dict().items())
    assert all(torch.equal(emb.projection.state_dict()[k], v) for k, v in proj.items())


def test_init_is_deterministic_and_kernel_wrappers_are_what_the_model_calls():
    a = MedSigLIPEmbedder(img_size=IMG, generator=torch.Generator().manual_seed(0), **NARROW)
    b = MedSigLIPEmbedder(img_size=IMG, generator=torch.Generator().manual_seed(0), **NARROW)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    assert a.backbone.head.probe.abs().max() > 0
    assert siglip.ln_qkv_fused is ld.ln_qkv_fused
    from xmir_tpu_torch.ops import plain_attn
    assert siglip.flash_attention_plain is plain_attn.flash_attention_plain
