"""The port's ChestMIR slice (xmir_tpu_torch/chestmir, cli/chestmir_ingest.py,
cli/chestmir_eval.py) against the JAX package.

The numpy modules are copies: each is held to its original on the same
seeded inputs, bit for bit (NMS with class offsets, agnostic and max_det,
the 8 TTA pairs, WBF, the letterbox and its inverse, crops, the two-stage
ranks, reports and stats, the detection service). embed_regions runs the
tiny model with the JAX package's weights in both stacks (vectors within
1e-5). Both CLIs run end to end on the synthetic dataset with
examples/detector_plugin_example.py, and each package's chestmir_eval reads
the other's artifact.
"""
import ast
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import xmir_tpu.chestmir as jc
import xmir_tpu_torch.chestmir as pc
from test_torch_resnet import _tiny_pt
from xmir_tpu.chestmir import inference as jax_inference
from xmir_tpu.chestmir import wbf as jax_wbf
from xmir_tpu.cli.common import jitted_embed
from xmir_tpu.models import registry as jax_registry
from xmir_tpu_torch.chestmir import inference, wbf
from xmir_tpu_torch.models import registry
from xmir_tpu_torch.models.convert import tiny_state_dict_from_jax
from xmir_tpu_torch.models.embedders import TinyEmbedder
from xmir_tpu_torch.train import make_embed_fn

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
EMBED_TOL = dict(rtol=1e-5, atol=1e-5)


def _raw_predictions(rng, b=2, n=300, nc=3):
    """Raw YOLO rows (b, n, 5 + nc): centres and sizes in a 256 canvas,
    overlapping boxes of every class, scores spread over the gates."""
    xy = rng.uniform(20, 236, (b, n, 2))
    wh = rng.uniform(8, 60, (b, n, 2))
    obj = rng.uniform(0, 1, (b, n, 1))
    cls = rng.uniform(0, 1, (b, n, nc))
    return np.concatenate([xy, wh, obj, cls], axis=-1).astype(np.float32)


def _boxes(rng, n, scale=1.0):
    lt = rng.uniform(0, 0.8, (n, 2))
    return (np.concatenate([lt, lt + rng.uniform(0.02, 0.2, (n, 2))], 1) * scale)


def _equal(got, want):
    """Equal trees of arrays / numbers / strings, exactly."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("kw", [dict(conf_thres=0.25, iou_thres=0.45),
                                dict(conf_thres=0.1, iou_thres=0.3, agnostic=True),
                                dict(conf_thres=0.05, iou_thres=0.6, max_det=7)],
                         ids=["class-offsets", "agnostic", "max_det"])
def test_non_max_suppression_matches_jax(kw):
    pred = _raw_predictions(np.random.default_rng(0))
    got = inference.non_max_suppression(pred, **kw)
    want = jax_inference.non_max_suppression(pred, **kw)
    assert sum(len(w) for w in want) > 2
    _equal(got, want)


def test_greedy_nms_copies_match_jax():
    rng = np.random.default_rng(1)
    boxes, scores = _boxes(rng, 80, 100), rng.random(80)
    for iou in (0.2, 0.5):
        _equal(wbf.nms(boxes, scores, iou), jax_wbf.nms(boxes, scores, iou))
        _equal(inference.nms(boxes, scores, iou), jax_inference.nms(boxes, scores, iou))


@pytest.mark.parametrize("ind", range(8))
def test_tta_pair_matches_jax(ind):
    """Each of the 8 rotation / flip pairs: the image transform and the box
    back-transform (on the transformed image's size)."""
    rng = np.random.default_rng(ind)
    image = rng.integers(0, 255, (50, 70, 3)).astype(np.uint8)
    fn, back = inference.get_tta_pair(ind)
    jfn, jback = jax_inference.get_tta_pair(ind)
    t = fn(image)
    _equal(t, jfn(image))
    h, w = t.shape[:2]
    for box in _boxes(rng, 5, min(h, w)):
        _equal(back(box, h, w), jback(box, h, w))


def test_weighted_boxes_fusion_matches_jax():
    rng = np.random.default_rng(2)
    boxes = [_boxes(rng, n) for n in (12, 0, 9, 15)]
    scores = [rng.random(len(b)) for b in boxes]
    labels = [rng.integers(0, 3, len(b)) for b in boxes]
    for iou, conf_type in ((0.25, "avg"), (0.55, "max")):
        _equal(wbf.weighted_boxes_fusion(boxes, scores, labels, iou, 0.1, conf_type),
               jax_wbf.weighted_boxes_fusion(boxes, scores, labels, iou, 0.1, conf_type))


@pytest.mark.parametrize("hw", [(480, 320), (200, 300), (97, 97)])
def test_letterbox_round_trip_matches_jax(hw):
    """letterbox_image and prepare_input bit-equal; boxes mapped into the
    letterbox and back by scale_boxes_back and scale_coords."""
    rng = np.random.default_rng(3)
    image = rng.integers(0, 255, hw + (3,)).astype(np.uint8)
    _equal(wbf.letterbox_image(image, 128), jax_wbf.letterbox_image(image, 128))
    _equal(inference.prepare_input(image, 128), jax_inference.prepare_input(image, 128))
    r, px, py, _, _ = wbf.letterbox_params(*hw, 128)
    assert (r, px, py) == jax_wbf.letterbox_params(*hw, 128)[:3]
    lb = _boxes(rng, 6, 128)
    _equal(wbf.scale_boxes_back(lb, r, px, py, *hw),
           jax_wbf.scale_boxes_back(lb, r, px, py, *hw))
    _equal(inference.scale_coords(lb.copy(), hw, r, (px, py)),
           jax_inference.scale_coords(lb.copy(), hw, r, (px, py)))
    orig = _boxes(rng, 4, min(hw))
    into = orig.copy()
    into[:, [0, 2]] = into[:, [0, 2]] * r + px
    into[:, [1, 3]] = into[:, [1, 3]] * r + py
    np.testing.assert_allclose(inference.scale_coords(into, hw, r, (px, py)), orig, atol=1e-9)
    _equal(wbf.xywh2xyxy(lb), jax_wbf.xywh2xyxy(lb))
    _equal(wbf.hflip_boxes(lb, 128), jax_wbf.hflip_boxes(lb, 128))


def test_crop_box_matches_jax():
    image = np.random.default_rng(4).integers(0, 255, (40, 60, 3)).astype(np.uint8)
    for box in ((-5, -5, 20, 4), (10.2, 3.7, 10.4, 3.9), (55, 35, 90, 90), (0, 0, 60, 40),
                (59.5, 39.5, 61, 41)):
        _equal(pc.crop_box(image, box), jc.crop_box(image, box))


def test_lesion_names_match_jax():
    assert pc.LESION_ALIAS_TO_CANON == jc.LESION_ALIAS_TO_CANON
    assert pc.VINDR_DETECTOR_CLASSES == jc.VINDR_DETECTOR_CLASSES
    for name in list(jc.LESION_ALIAS_TO_CANON) + ["Nodule/Mass", "Pleural_Thickening",
                                                  "Lung-Opacity", " unknown thing "]:
        assert pc.canonical_lesion_name(name) == jc.canonical_lesion_name(name)


def _bright_detector(n_cls=3):
    """A raw detector: one row around the bright pixels it sees."""
    def detector(input_tensor):
        img = input_tensor[0].transpose(1, 2, 0) * 255.0
        ys, xs = np.nonzero(img[..., 0] > 200)
        if len(xs) == 0:
            return np.zeros((1, 1, 5 + n_cls), np.float32)
        x1, x2, y1, y2 = xs.min(), xs.max() + 1, ys.min(), ys.max() + 1
        row = [(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1, 0.9] + [0.05] * n_cls
        row[5 + int(x1) % n_cls] = 0.95
        return np.asarray([[row]], np.float32)
    return detector


def _legacy_detector(lb):
    """A pre-decoded detector: boxes in letterbox coordinates."""
    s = lb.shape[0]
    return (np.array([[0.3 * s, 0.3 * s, 0.55 * s, 0.6 * s], [0.6 * s, 0.2 * s, 0.8 * s, 0.5 * s]]),
            np.array([0.9, 0.6]), np.array([3, 7]))


def _rect_image(h=200, w=300, rect=(60, 50, 140, 120)):
    image = np.zeros((h, w, 3), np.uint8)
    image[rect[1]:rect[3], rect[0]:rect[2]] = 255
    return image


@pytest.mark.parametrize("raw", [True, False], ids=["raw", "legacy"])
def test_detections_with_tta_folds_matches_jax(raw):
    """Both routes: raw head rows through predict_image (every TTA pair,
    merge_predictions' WBF), and the legacy pre-decoded identity + hflip
    route."""
    image = _rect_image()
    fns = [_bright_detector(), _bright_detector()] if raw else [_legacy_detector]
    kw = dict(img_size=128, raw_outputs=raw, tta=tuple(range(8)), score_thres=0.05,
              class_names=["a", "b", "c"] if raw else None)
    want = jc.detections_with_tta_folds(image, fns, **kw)
    assert len(want) >= 1
    _equal(pc.detections_with_tta_folds(image, fns, **kw), want)
    if raw:
        kw = dict(tta=(0, 3, 6), img_size=96, wbf_iou=0.4, score_thres=0.0)
        _equal(pc.predict_image(image, fns, **kw), jc.predict_image(image, fns, **kw))
        preds = [pc.run_single_tta(fns[0], image, 96, t) for t in range(8)]
        _equal(preds, [jc.run_single_tta(fns[0], image, 96, t) for t in range(8)])
        _equal(pc.merge_predictions(preds, 0.3), jc.merge_predictions(preds, 0.3))


@pytest.mark.parametrize("raw", [True, False], ids=["raw", "legacy"])
def test_detection_service_matches_jax(raw):
    """analyze_image at its defaults (WBF IoU 0.4, score 0.25): equal
    normalised detections and the same rendered JPEG."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_rect_image(120, 160, (30, 20, 90, 70))).save(buf, format="PNG")
    fns = [_bright_detector(14)] if raw else [_legacy_detector]
    got = pc.DiseaseDetectionService(fns, raw_outputs=raw).analyze_image(buf.getvalue())
    want = jc.DiseaseDetectionService(fns, raw_outputs=raw).analyze_image(buf.getvalue())
    assert len(want[0]) >= 1
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert pc.CLASS_ID_TO_VI == jc.CLASS_ID_TO_VI


def _lesion_maps(rng, n, d=8, lesions=("consolidation", "lung opacity", "Nodule/Mass")):
    regions = []
    for _ in range(n):
        regions.append([{"label": name, "vector": rng.standard_normal(d)}
                        for name in lesions for _ in range(int(rng.integers(0, 3)))])
    return regions


def test_two_stage_matches_jax():
    """Stage 1 and both reranks: ranks equal exactly, reports and stats
    equal, on seeded global vectors and region maps of three lesions."""
    rng = np.random.default_rng(5)
    n = 40
    g = rng.standard_normal((n, 8))
    labels = rng.integers(0, 3, n)
    regions = _lesion_maps(rng, n)
    maps = [pc.build_lesion_map(r) for r in regions]
    jmaps = [jc.build_lesion_map(r) for r in regions]
    _equal(maps, jmaps)
    target = ["consolidation", "lung opacity", "infiltration"]
    got = pc.two_stage_eval(g, labels, maps, target, ["nodule", "consolidation"],
                            rerank_topk=9, global_weight=0.6)
    want = jc.two_stage_eval(g, labels, jmaps, target, ["nodule", "consolidation"],
                             rerank_topk=9, global_weight=0.6)
    assert got == want
    assert want["stage2_adaptive"]["stats"]["queries_reranked"] > 0
    gn = g / np.linalg.norm(g, axis=1, keepdims=True)
    sim = gn @ gn.T
    _equal(pc.similarity_to_ranks(sim), jc.similarity_to_ranks(sim))
    _equal(pc.rerank_with_adaptive_lesion(sim, maps, target, 9, 0.6),
           jc.rerank_with_adaptive_lesion(sim, jmaps, target, 9, 0.6))
    _equal(pc.rerank_with_specific_lesion(sim, maps, "nodule", 9, 0.6),
           jc.rerank_with_specific_lesion(sim, jmaps, "nodule", 9, 0.6))
    ranks = pc.similarity_to_ranks(sim)
    assert pc.evaluate_rankings(ranks, labels) == jc.evaluate_rankings(ranks, labels)


def test_draw_detections_matches_jax():
    image = np.random.default_rng(6).integers(0, 255, (64, 80, 3)).astype(np.uint8)
    dets = [{"class_id": 3, "class_name": "Cardiomegaly", "confidence": 0.5,
             "x1": 10, "y1": 10, "x2": 40, "y2": 50}]
    _equal(pc.draw_detections(image, dets), jc.draw_detections(image, dets))


def test_embed_regions_matches_jax():
    """The tiny model with the JAX package's weights in both stacks: unit
    region vectors within 1e-5, labels and boxes equal; every crop is
    squashed to the spec's resize size with PIL's BILINEAR."""
    from xmir_tpu.models.embedders import TinyEmbedder as JaxTiny

    model = JaxTiny(embedding_dim=16)
    variables = jax.device_get(jax.jit(lambda r, x: model.init(r, x, train=False))(
        jax.random.PRNGKey(0), np.zeros((2, 64, 64, 3), np.float32)))
    port = TinyEmbedder(16)
    port.load_state_dict(tiny_state_dict_from_jax(variables), strict=True)
    image = np.random.default_rng(7).integers(0, 255, (150, 210, 3)).astype(np.uint8)
    dets = [{"class_name": name, "x1": x1, "y1": y1, "x2": x2, "y2": y2}
            for name, (x1, y1, x2, y2) in zip(
                ["Lung Opacity", "Nodule/Mass", "Cardiomegaly", "Other lesion", "ILD"],
                [(10, 20, 80, 90), (100, 5, 130, 140), (-4, -4, 300, 300), (50, 60, 51, 61),
                 (150.5, 30.2, 209.9, 149.7)])]
    got = pc.embed_regions(image, dets, make_embed_fn(port.eval()), registry.get_spec("tiny"),
                           "cpu", batch_size=2)
    want = jc.embed_regions(image, dets, jitted_embed(model), variables,
                            jax_registry.get_spec("tiny"), batch_size=2)
    assert [(r["label"], r["box"]) for r in got] == [(r["label"], r["box"]) for r in want]
    np.testing.assert_allclose(np.stack([r["vector"] for r in got]),
                               np.stack([r["vector"] for r in want]), **EMBED_TOL)
    assert pc.embed_regions(image, [], None, registry.get_spec("tiny"), "cpu") == []


@pytest.fixture
def plugin_on_path():
    sys.path.insert(0, str(REPO))
    yield "examples.detector_plugin_example"
    sys.path.remove(str(REPO))


def test_chestmir_clis_match_jax(tmp_path, plugin_on_path):
    """cli.chestmir_ingest with the example plugin (raw outputs, TTA 0 / 4)
    on the synthetic set, the tiny model of the JAX CLI's own init: the
    port's artifact against the JAX CLI's (global and region vectors within
    1e-5, names, labels, region labels and boxes equal); then each
    package's cli.chestmir_eval on each artifact: equal JSON."""
    from xmir_tpu.cli import chestmir_eval as jax_eval
    from xmir_tpu.cli import chestmir_ingest as jax_ingest
    from xmir_tpu_torch.cli import chestmir_eval, chestmir_ingest

    common = ["--dataset", "synthetic", "--model", "tiny", "--embedding-dim", "16",
              "--split", "train", "--detector-plugin", plugin_on_path,
              "--raw-detector-outputs", "--tta", "0,4", "--batch-size", "16"]
    paths = {"jax": str(tmp_path / "jax.npz"), "port": str(tmp_path / "port.npz")}
    jax_ingest.main(common + ["--output", paths["jax"]])
    summary = chestmir_ingest.main(common + ["--device", "cpu", "--resume", _tiny_pt(tmp_path),
                                             "--output", paths["port"]])
    art = {k: np.load(v, allow_pickle=True) for k, v in paths.items()}
    _equal(art["port"]["image_names"], art["jax"]["image_names"])
    _equal(art["port"]["labels"], art["jax"]["labels"])
    np.testing.assert_allclose(art["port"]["global_vectors"], art["jax"]["global_vectors"],
                               **EMBED_TOL)
    regions = {k: json.loads(str(v["regions_json"])) for k, v in art.items()}
    assert summary["regions"] == sum(len(r) for r in regions["jax"]) > 0
    assert summary["images"] == 64
    for got, want in zip(regions["port"], regions["jax"]):
        assert [(r["label"], r["box"]) for r in got] == [(r["label"], r["box"]) for r in want]
        if want:
            np.testing.assert_allclose([r["vector"] for r in got], [r["vector"] for r in want],
                                       **EMBED_TOL)
    for name, gallery in paths.items():
        outs = {}
        for pkg, cli in (("jax", jax_eval), ("port", chestmir_eval)):
            outs[pkg] = str(tmp_path / f"{pkg}_on_{name}.json")
            cli.main(["--gallery", gallery, "--target-lesions", "lung opacity",
                      "--specific-lesions", "lung opacity", "--rerank-topk", "10",
                      "--output", outs[pkg]])
        with open(outs["port"]) as f, open(outs["jax"]) as g:
            got, want = json.load(f), json.load(g)
        assert got == want
        assert want["stage2_adaptive"]["stats"]["queries_reranked"] > 0


def test_chestmir_ingest_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from xmir_tpu_torch.cli import chestmir_ingest

    with pytest.raises(RuntimeError, match="is_available"):
        chestmir_ingest.main(["--dataset", "synthetic", "--model", "tiny", "--device", "cuda"])


def test_plugin_that_fails_to_import_raises(tmp_path):
    from xmir_tpu_torch.cli import chestmir_ingest

    with pytest.raises(ModuleNotFoundError):
        chestmir_ingest.main(["--dataset", "synthetic", "--model", "tiny", "--device", "cpu",
                              "--embedding-dim", "16", "--detector-plugin",
                              "no_such_detector_plugin", "--output",
                              str(tmp_path / "x.npz")])


def test_chestmir_slice_imports_neither_jax_nor_the_jax_package():
    """No import statement of the slice's modules (at module level or
    inside a function) names jax, flax or xmir_tpu."""
    files = sorted((REPO / "xmir_tpu_torch" / "chestmir").glob("*.py")) + [
        REPO / "xmir_tpu_torch" / "models" / "yolo.py",
        REPO / "xmir_tpu_torch" / "cli" / "chestmir_ingest.py",
        REPO / "xmir_tpu_torch" / "cli" / "chestmir_eval.py"]
    assert len(files) == 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad = [n for n in names if n.split(".")[0] in ("jax", "flax", "optax", "xmir_tpu")]
            assert not bad, (path.name, bad)
