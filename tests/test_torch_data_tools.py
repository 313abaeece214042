"""The port's data and host tools against the JAX package's: the decoded-image
cache (data/cache.py) byte for byte, the native NIH reader
(data/native_loader.py, built from its copy of the C++ source under build/)
byte for byte against the JAX package's reader built from the original here,
the NIH dataset's native path, its per-file fallback and counter,
``prefetch_to_device`` on the CPU, ``cli.parity`` on the three parity
goldens, and the spans of utils/profiling.py."""
from __future__ import annotations

import filecmp
import json
import os
import time

import numpy as np
import pytest
import torch

from test_torch_datasets import write_nih_tree
from xmir_tpu.cli import parity as jax_parity
from xmir_tpu.data import cache as jax_cache
from xmir_tpu.data import datasets as jax_ds
from xmir_tpu.data import native_loader as jax_native
from xmir_tpu_torch.cli import parity
from xmir_tpu_torch.data import cache, native_loader
from xmir_tpu_torch.data import datasets as ds
from xmir_tpu_torch.data.pipeline import batch_iterator, prefetch_to_device
from xmir_tpu_torch.data.synthetic import write_synthetic_covidx
from xmir_tpu_torch.utils import profiling

FIXTURES = "tests/fixtures"


def _covidx(tmp_path):
    img_dir, manifest = write_synthetic_covidx(str(tmp_path / "tree"), n=20, size=48)
    return (ds.CovidxDataset(img_dir, manifest),
            jax_ds.CovidxDataset(img_dir, manifest))


def _same_artifact(a, b):
    for name in ("images.npy", "labels.npy", "meta.json"):
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


def test_decoded_cache_equals_jax(tmp_path):
    port, ref = _covidx(tmp_path)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    cache.build_decoded_cache(port, a, 40, batch_size=6, num_workers=2)
    jax_cache.build_decoded_cache(ref, b, 40, batch_size=6, num_workers=2)
    _same_artifact(a, b)
    served = cache.DecodedCache(a)
    assert len(served) == 20
    np.testing.assert_array_equal(served.load_batch_cropped([3, 1], 40),
                                  jax_cache.DecodedCache(b).load_batch_cropped([3, 1], 40))
    with pytest.raises(ValueError, match="cache built at 40px"):
        served.load_batch_cropped([0], 32)


def test_write_through_cache_equals_jax(tmp_path):
    port, ref = _covidx(tmp_path)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    wa = cache.WriteThroughCache(port, a, 40)
    wb = jax_cache.WriteThroughCache(ref, b, 40)
    # repeated indices (a PK batch) must not stamp the artifact early
    for batch in ([0, 0, 1, 2], [2, 3, 4]):
        np.testing.assert_array_equal(wa.load_batch_cropped(batch, 40),
                                      wb.load_batch_cropped(batch, 40))
    assert not wa.complete and not os.path.exists(os.path.join(a, "meta.json"))
    got = [imgs for imgs, _, _ in batch_iterator(wa, 7, image_size=40, num_workers=2)]
    want = [imgs for imgs, _, _ in batch_iterator(ref, 7, image_size=40, num_workers=2)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert wa.complete  # every index decoded once: stamped in the pass
    wb.finalize()
    _same_artifact(a, b)
    again = cache.WriteThroughCache(port, a, 40)  # a complete artifact reads back
    assert again.complete
    np.testing.assert_array_equal(again.load_batch_cropped([5, 6], 40), got[0][5:7])


@pytest.fixture(scope="module")
def jax_reader(tmp_path_factory):
    """The JAX package's reader, built by its own build step from
    native/xmir_loader.cpp into a temporary directory (not native/)."""
    so = str(tmp_path_factory.mktemp("jax_native") / "libxmir_loader.so")
    saved = jax_native._SO, jax_native._LIB
    jax_native._SO, jax_native._LIB = so, None
    try:
        assert jax_native.available() and os.path.isfile(so)
        yield jax_native
    finally:
        jax_native._SO, jax_native._LIB = saved


def test_native_reader_is_byte_equal_to_jax(tmp_path, jax_reader):
    paths = [str(p) for p in write_nih_tree(tmp_path / "nih")]
    lib = native_loader.build()
    assert lib.is_file() and lib.parent.parent.name == "xmir_tpu_torch"
    assert "build" in lib.parts and "native" not in lib.parts
    assert native_loader.load().xmir_loader_version() == 2
    for p in paths[:6]:
        np.testing.assert_array_equal(native_loader.load_npy_image(p, 30, 22),
                                      jax_reader.load_npy_image(p, 30, 22))
        np.testing.assert_array_equal(native_loader.load_npy_image_crop(p, 24),
                                      jax_reader.load_npy_image_crop(p, 24))
    np.testing.assert_array_equal(native_loader.load_npy_batch(paths, 17, 25, 3),
                                  jax_reader.load_npy_batch(paths, 17, 25, 3))
    np.testing.assert_array_equal(native_loader.load_npy_batch_crop(paths, 32, 2),
                                  jax_reader.load_npy_batch_crop(paths, 32, 2))


def test_nih_dataset_native_path_and_fallback(tmp_path, jax_reader):
    root = tmp_path / "nih"
    write_nih_tree(root)
    # a layout the C++ reader refuses (int64): the PIL path, for that file alone
    np.save(root / "Chest_X-ray_Mass_999.npy",
            np.arange(20 * 24, dtype=np.int64).reshape(20, 24))
    port = ds.NIHChestXrayRetrievalDataset(data_dir=str(root))
    ref = jax_ds.NIHChestXrayRetrievalDataset(data_dir=str(root))
    pil = ds.NIHChestXrayRetrievalDataset(data_dir=str(root), use_native=False)
    assert port.use_native and ref.use_native
    bad = port.image_names.index(str(root / "Chest_X-ray_Mass_999.npy"))
    good = [i for i in range(len(port)) if i != bad]
    before = dict(native_loader.LOADS)
    batches = list(batch_iterator(port, 5, indices=good, image_size=32, num_workers=2))
    assert native_loader.LOADS["native"] - before.get("native", 0) == len(good)
    for imgs, _, idxs in batches:
        np.testing.assert_array_equal(imgs, ref.load_batch_cropped(list(idxs), 32))
        diff = np.abs(imgs.astype(int) - pil.load_batch_cropped(list(idxs), 32).astype(int))
        # the JAX tests' bound of the native path against PIL
        # (tests/test_preprocess_parity.py:114-129)
        assert np.median(diff) <= 1 and diff.mean() < 3
    before = dict(native_loader.LOADS)
    mixed = port.load_batch_cropped([bad, good[0]], 32)
    assert native_loader.LOADS["fallback"] - before.get("fallback", 0) == 1
    np.testing.assert_array_equal(mixed, ref.load_batch_cropped([bad, good[0]], 32))
    np.testing.assert_array_equal(mixed[0], pil.load_image_cropped(bad, 32))
    np.testing.assert_array_equal(port.load_batch_resized(good[:3], 20, 28),
                                  ref.load_batch_resized(good[:3], 20, 28))


def test_native_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native_loader, "BUILD_ROOT", tmp_path / "b")
    monkeypatch.setattr(native_loader, "GXX_FLAGS", ("-O3", "--no-such-flag"))
    with pytest.raises(native_loader.NativeCompileError, match="g\\+\\+ failed"):
        native_loader.build()


def test_native_first_load_from_many_threads(monkeypatch, tmp_path):
    """The decode threads' first calls come together: one builds, every
    thread gets the one library (a fresh build under tmp_path)."""
    import sys
    import threading

    monkeypatch.setattr(native_loader, "BUILD_ROOT", tmp_path / "b")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    native_loader._load.cache_clear()
    got, errors = [], []

    def first_load():
        try:
            got.append(native_loader.load())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=first_load) for _ in range(4 * (os.cpu_count() or 4))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
        native_loader._load.cache_clear()  # later calls build under the real root again
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(got) == len(threads) and all(lib is got[0] for lib in got)
    assert len(list((tmp_path / "b").glob("loader-*/libxmir_loader.so"))) == 1


def _slow_batches(n):
    for i in range(n):
        if i % 3 == 0:
            time.sleep(0.01)  # the consumer waits on a slow producer
        yield np.full((2, 3), i, np.float32), {"ids": np.arange(i, i + 2)}, f"batch {i}"


def test_prefetch_to_device_keeps_order_on_the_cpu():
    got = list(prefetch_to_device(_slow_batches(12), "cpu", size=2))
    assert len(got) == 12
    for i, (x, d, name) in enumerate(got):
        assert torch.is_tensor(x) and torch.equal(x, torch.full((2, 3), float(i)))
        assert torch.equal(d["ids"], torch.arange(i, i + 2)) and name == f"batch {i}"
    # a consumer that stops early ends the producer
    it = prefetch_to_device(_slow_batches(100), "cpu", size=2)
    assert torch.equal(next(it)[0], torch.zeros(2, 3))
    it.close()

    def failing():
        yield np.zeros(1)
        raise OSError("unreadable")

    with pytest.raises(OSError, match="unreadable"):
        list(prefetch_to_device(failing(), "cpu"))


@pytest.mark.parametrize("name,flags", [
    ("parity_golden", []), ("reference_single_label_golden", []),
    ("reference_multilabel_golden", []), ("parity_golden", ["--use-stored-dists"])])
def test_parity_cli_equals_jax(tmp_path, name, flags):
    """The same JSON, and the same exit: the multi-label golden stores
    P@K rounded to 2 decimals, which both CLIs refuse (exit 1)."""
    argv = ["--results", os.path.join(FIXTURES, f"{name}.npz"), *flags]
    outs, codes = [], []
    for main, out in ((parity.main, tmp_path / "port.json"), (jax_parity.main,
                                                              tmp_path / "jax.json")):
        try:
            main(argv + ["--output", str(out)])
            codes.append(0)
        except SystemExit as e:
            codes.append(e.code)
        with open(out) as f:
            outs.append(json.load(f))
    assert outs[0] == outs[1] and codes[0] == codes[1]
    assert codes[0] == (1 if name == "reference_multilabel_golden" else 0)


def test_spans_and_trace(tmp_path):
    profiling.reset_spans()
    for _ in range(3):
        with profiling.span("decode"):
            time.sleep(0.002)
    with profiling.span("embed"):
        with profiling.trace(str(tmp_path / "trace")) as prof:
            torch.ones(64, 64) @ torch.ones(64, 64)
    report = profiling.span_report()
    assert list(report) == ["decode", "embed"] and report["decode"]["count"] == 3
    assert report["decode"]["total_s"] >= 0.006 and report["embed"]["count"] == 1
    profiling.dump_spans(str(tmp_path / "spans.json"))
    with open(tmp_path / "spans.json") as f:
        assert json.load(f) == report
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert prof.key_averages()
    profiling.reset_spans()
    assert profiling.span_report() == {}
