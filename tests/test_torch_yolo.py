"""The port's YOLOv5 lesion detector (models/yolo.py), its converters and the
detector callable against the JAX package.

The JAX YOLOv5's weights, with random BatchNorm statistics and biases
(torch_parity_models.randomized), go through yolov5_state_dict_from_jax into
the port; both forwards see the same numpy images: the raw maps and the
decoded predictions within atol 2e-4, rtol 1e-4 (tests/test_yolo.py's
tolerance). The ultralytics-layout loader reads the state dict of
tests/test_yolo.py's torch oracle (ultralytics v6.0 module semantics) with
strict=True and agrees with convert_yolov5 on the same file.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_yolo import TYOLO
from test_yolo import DM as ORACLE_DM
from test_yolo import NC as ORACLE_NC
from test_yolo import WM as ORACLE_WM
from torch_parity_models import randomized
from xmir_tpu.chestmir.inference import predict_image as jax_predict_image
from xmir_tpu.chestmir.inference import run_detector as jax_run_detector
from xmir_tpu.chestmir.lesions import detector_fn_from_checkpoint as jax_detector_fn
from xmir_tpu.models.convert import convert_yolov5, load_torch_state_dict
from xmir_tpu.models.yolo import YOLOv5 as JaxYOLOv5
from xmir_tpu_torch.chestmir.inference import predict_image, run_detector
from xmir_tpu_torch.chestmir.lesions import detector_fn_from_checkpoint
from xmir_tpu_torch.models.convert import (
    load_yolov5_checkpoint,
    yolov5_state_dict_from_jax,
    yolov5_state_dict_from_ultralytics,
)
from xmir_tpu_torch.models.yolo import DEFAULT_ANCHORS, STRIDES, YOLOv5

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=1e-4)  # tests/test_yolo.py's
NC = 14
# anchors that are not the defaults, so that the buffer's round trip matters
OTHER_ANCHORS = (((12, 14), (20, 36), (40, 28)), ((36, 72), (70, 52), (64, 128)),
                 ((120, 96), (160, 208), (384, 320)))


def _images(n=1, size=128, seed=0):
    return np.random.default_rng(seed).random((n, 3, size, size)).astype(np.float32)


def _jax_pair(width, size, anchors, seed):
    """(JAX model, randomized variables, port model with them, input)."""
    model = JaxYOLOv5(num_classes=NC, depth_multiple=0.33, width_multiple=width,
                      anchors=anchors)
    x = _images(size=size, seed=seed)
    init = jax.jit(lambda r, v: model.init(r, v, train=False))
    variables = randomized(init(jax.random.PRNGKey(seed), jnp.asarray(x.transpose(0, 2, 3, 1))),
                           seed=seed + 1)
    port = YOLOv5(NC, 0.33, width)
    port.load_state_dict(yolov5_state_dict_from_jax(variables, anchors), strict=True)
    return model, variables, port.eval(), x


@pytest.mark.parametrize("width,size,anchors", [(0.25, 96, OTHER_ANCHORS),
                                                (0.50, 64, DEFAULT_ANCHORS)],
                         ids=["w0.25-96px-anchors", "w0.50-64px"])
def test_yolov5_matches_jax(width, size, anchors):
    """maps (NHWC in JAX, NCHW here) and the (1, N, 5 + nc) prediction; N =
    3 anchors x the cells of the three scales, anchor-major."""
    model, variables, port, x = _jax_pair(width, size, anchors, seed=0)
    want = jax.jit(lambda v, t: model.apply(v, t, train=False))(
        variables, jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    n = 3 * sum((size // s) ** 2 for s in STRIDES)
    assert got["prediction"].shape == (1, n, 5 + NC)
    for g, w in zip(got["maps"], want["maps"]):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(w), **TOL)
    np.testing.assert_allclose(got["prediction"].numpy(), np.asarray(want["prediction"]), **TOL)
    np.testing.assert_allclose(port.anchors_px.numpy(), np.asarray(anchors, np.float32))


def test_decode_maps_in_f32_from_bf16_maps():
    """The decode casts the maps to f32 (xmir_tpu/models/yolo.py:191)."""
    port = YOLOv5(NC, 0.33, 0.25, generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        maps = [m.bfloat16() for m in port(torch.from_numpy(_images(size=64)))["maps"]]
        out = port.decode_maps(maps)
        ref = port.decode_maps([m.float() for m in maps])
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.fixture(scope="module")
def oracle_pt(tmp_path_factory):
    """tests/test_yolo.py's torch oracle (ultralytics v6.0 modules, random
    BatchNorm statistics) saved as an ultralytics state-dict .pt."""
    torch.manual_seed(0)
    oracle = TYOLO().eval()
    with torch.no_grad():
        for mod in oracle.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.5, 0.5)
                mod.running_var.uniform_(0.5, 1.5)
    path = str(tmp_path_factory.mktemp("yolo") / "fold0.pt")
    torch.save(oracle.state_dict(), path)
    return oracle, path


def _port_from(path):
    port = YOLOv5(ORACLE_NC, ORACLE_DM, ORACLE_WM)
    return port, load_yolov5_checkpoint(port, path)


def test_ultralytics_loader_matches_convert_yolov5(oracle_pt, tmp_path):
    """A strict load with no rename table; the anchors come back in pixels
    as convert_yolov5 gives them; the wrappers (``module.``,
    ``model.model.``, ``{"model": ...}``) and half-precision tensors read
    the same; the port's tensors equal the JAX conversion's taken back by
    yolov5_state_dict_from_jax."""
    oracle, path = oracle_pt
    port, anchors = _port_from(path)
    variables, jax_anchors = convert_yolov5(load_torch_state_dict(path), depth_multiple=ORACLE_DM)
    np.testing.assert_array_equal(anchors, np.asarray(jax_anchors, np.float32))
    np.testing.assert_allclose(anchors, np.asarray(DEFAULT_ANCHORS), rtol=1e-6)
    back = yolov5_state_dict_from_jax(jax.device_get(variables), jax_anchors)
    assert back.keys() == port.state_dict().keys()
    for key, value in port.state_dict().items():
        torch.testing.assert_close(back[key], value, rtol=0, atol=0, check_dtype=False, msg=key)
    sd = oracle.state_dict()
    for i, tree in enumerate(({f"module.{k}": v for k, v in sd.items()},
                              {f"model.{k}": v for k, v in sd.items()},
                              {"model": {k: v.half() if v.is_floating_point() else v
                                         for k, v in sd.items()}})):
        wrapped = str(tmp_path / f"wrapped{i}.pt")
        torch.save(tree, wrapped)
        other, other_anchors = _port_from(wrapped)
        np.testing.assert_array_equal(other_anchors, anchors)
        for key, value in other.state_dict().items():
            want = port.state_dict()[key]
            if i == 2 and value.is_floating_point():
                want = want.half().float()
            torch.testing.assert_close(value, want, rtol=0, atol=0, msg=key)
    assert yolov5_state_dict_from_ultralytics(sd).keys() == port.state_dict().keys()


def test_loaded_checkpoint_matches_oracle_and_jax(oracle_pt):
    """The same .pt through the port, the torch oracle and the JAX model."""
    oracle, path = oracle_pt
    port, _ = _port_from(path)
    variables, anchors = convert_yolov5(load_torch_state_dict(path), depth_multiple=ORACLE_DM)
    model = JaxYOLOv5(num_classes=ORACLE_NC, depth_multiple=ORACLE_DM,
                      width_multiple=ORACLE_WM, anchors=anchors)
    x = _images(size=128, seed=3)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))["prediction"].numpy()
        np.testing.assert_allclose(got, oracle(torch.from_numpy(x)).numpy(), **TOL)
    want = jax.jit(lambda v, t: model.apply(v, t, train=False)["prediction"])(
        variables, jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def chest_like(size, seed):
    """A grayscale (as RGB) chest-film-like image: a bright mediastinum,
    two darker lungs, bright blobs, noise; no flat region, so no two cells
    of the detector's maps see the same pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    img = 60 + 80 * np.exp(-((xx - 0.5) ** 2) / 0.08)
    for cx in (0.3, 0.7):
        img -= 50 * np.exp(-(((xx - cx) / 0.15) ** 2 + ((yy - 0.5) / 0.3) ** 2))
    for _ in range(6):
        cx, cy, r = rng.random(), rng.random(), 0.02 + 0.06 * rng.random()
        img += 90 * rng.random() * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / r ** 2)
    img = np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    return np.repeat(img[..., None], 3, axis=2)


@pytest.fixture(scope="module")
def detector_pt(tmp_path_factory):
    """A seeded detector whose kept rows' confidences lie far apart (well
    above the two stacks' f32 difference, so that NMS orders them alike):
    Kaiming-normal convolutions, random BatchNorm statistics, ultralytics'
    Detect priors, and the head's weights x 32 so its logits spread as a
    trained head's do (a random head's lie within a logit of its prior)."""
    gen = torch.Generator().manual_seed(0)
    model = YOLOv5(NC, 0.33, 0.25, generator=gen)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.5, 0.5, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
            elif isinstance(mod, torch.nn.Conv2d) and not name.startswith("model.24."):
                mod.weight.normal_(0.0, (2.0 / mod.weight[0].numel()) ** 0.5, generator=gen)
        for conv in model.detect.m:
            conv.weight.mul_(32.0)
    path = str(tmp_path_factory.mktemp("yolo") / "seeded.pt")
    torch.save(model.state_dict(), path)
    return path


def _detections_equal(got, want, score_tol=1e-5):
    """run_detector's (boxes, scores, labels): boxes and labels equal,
    scores within score_tol (the two forwards' f32 roundings differ)."""
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=score_tol)


def test_detector_fn_from_checkpoint_matches_jax(detector_pt):
    """The port's detector callable on the CPU and the JAX one on the same
    .pt: raw predictions within the tolerance; run_detector and
    predict_image (two folds, TTA 0 / 4 / 5) give equal detections."""
    kw = dict(num_classes=NC, depth_multiple=0.33, width_multiple=0.25)
    port_fn = detector_fn_from_checkpoint(detector_pt, device="cpu", **kw)
    jax_fn = jax_detector_fn(detector_pt, **kw)
    img = chest_like(160, 0)[:, :150]  # letterboxed with a pad
    lb = np.random.default_rng(2).random((1, 3, 128, 128)).astype(np.float32)
    np.testing.assert_allclose(port_fn(lb), jax_fn(lb), **TOL)
    got = run_detector(port_fn, img, 128, conf_thres=0.05, iou_thres=0.5)
    want = jax_run_detector(jax_fn, img, 128, conf_thres=0.05, iou_thres=0.5)
    assert len(want[0]) >= 10
    _detections_equal(got, want)
    kw = dict(tta=(0, 4, 5), img_size=128, score_thres=0.0)
    got = predict_image(img, [port_fn, port_fn], **kw)
    want = jax_predict_image(img, [jax_fn, jax_fn], **kw)
    assert len(want["detections"]) >= 10
    assert [{k: v for k, v in d.items() if k != "confidence"} for d in got["detections"]] == [
        {k: v for k, v in d.items() if k != "confidence"} for d in want["detections"]]
    np.testing.assert_allclose([d["confidence"] for d in got["detections"]],
                               [d["confidence"] for d in want["detections"]], rtol=0, atol=1e-5)


def test_detector_fn_cuda_without_card_raises(oracle_pt):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        detector_fn_from_checkpoint(oracle_pt[1], num_classes=ORACLE_NC,
                                    depth_multiple=ORACLE_DM, width_multiple=ORACLE_WM)


def test_generator_init_is_deterministic():
    a = YOLOv5(NC, 0.33, 0.25, generator=torch.Generator().manual_seed(5))
    b = YOLOv5(NC, 0.33, 0.25, generator=torch.Generator().manual_seed(5))
    for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=key)
    # ultralytics' _initialize_biases: the objectness and class priors
    bias = a.detect.m[0].bias.view(3, 5 + NC)
    assert bias[:, 4].mean().item() == pytest.approx(np.log(8 / (640 / 8) ** 2), abs=0.05)
    assert bias[:, 5:].mean().item() == pytest.approx(np.log(0.6 / (NC - 0.99)), abs=0.05)
