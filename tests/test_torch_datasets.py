"""The port's datasets (xmir_tpu_torch/data/datasets.py) against the JAX
package's on generated files: NIH ``.npy`` trees with URL-encoded multi-label
names and aliases, an ISIC-2017 CSV, a TBX11K CSV with a BOM, VinDr-CXR CSVs
with and without ``rad_id`` rows; ``build_dataset`` for the four names in
both packages; ``split_csv``. Both NIH sets run with ``use_native=False``
(the PIL path; tests/test_torch_data_tools.py holds the native readers to
each other). Equality is exact: names, labels and image bytes."""
from __future__ import annotations

import argparse
from urllib.parse import quote

import numpy as np
import pytest

from xmir_tpu.cli import common as jax_common
from xmir_tpu.data import datasets as jax_ds
from xmir_tpu_torch.cli import common
from xmir_tpu_torch.data import datasets as ds

PATHOLOGIES = jax_ds.NIH_RETRIEVAL_PATHOLOGIES


def _nih_name(labels, n):
    return f"Chest_X-ray_{quote('|'.join(labels))}_{n}.npy"


def write_nih_tree(root, seed=0):
    """.npy files covering all 14 pathologies, an alias, float and uint8
    arrays, channel-first, single-channel-last and flat (constant) images,
    two in a subdirectory."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "sub").mkdir(exist_ok=True)
    sets = [[p] for p in PATHOLOGIES] + [
        ["Atelectasis", "Effusion"], ["pleural_thickening", "Mass"],
        ["Pleural-Thickening"], ["hernia", "Nodule", "Edema"]]
    arrays = [
        lambda: rng.standard_normal((40, 52)).astype(np.float32),
        lambda: rng.integers(0, 256, (48, 36), dtype=np.uint8),
        lambda: rng.uniform(0, 4096, (1, 30, 44)).astype(np.float32),
        lambda: rng.integers(0, 256, (33, 41, 1), dtype=np.uint8),
        lambda: np.full((20, 20), 7.0, np.float32),
    ]
    paths = []
    for i, labels in enumerate(sets):
        path = (root / "sub" if i % 9 == 4 else root) / _nih_name(labels, 100 + i)
        np.save(path, arrays[i % len(arrays)]())
        paths.append(path)
    return paths


def _same(port, ref):
    assert list(port.image_names) == list(ref.image_names)
    np.testing.assert_array_equal(np.asarray(port.labels), np.asarray(ref.labels))
    assert len(port) == len(ref)
    for i in range(len(ref)):
        np.testing.assert_array_equal(port.load_image(i), ref.load_image(i))


def test_nih_dataset_matches_jax(tmp_path):
    write_nih_tree(tmp_path / "nih")
    port = ds.NIHChestXrayRetrievalDataset(data_dir=str(tmp_path / "nih"), use_native=False)
    ref = jax_ds.NIHChestXrayRetrievalDataset(data_dir=str(tmp_path / "nih"), use_native=False)
    _same(port, ref)
    assert port.label_sets == ref.label_sets
    assert port.labels.dtype == np.float32 and port.labels.shape == (len(port), 14)
    assert (port.labels.sum(axis=0) > 0).all()  # every pathology present
    assert port.label_sets[len(PATHOLOGIES) + 1] == ["Pleural Thickening", "Mass"]
    for i in range(len(ref)):
        np.testing.assert_array_equal(port.load_image_cropped(i, 24),
                                      ref.load_image_cropped(i, 24))


def test_nih_manifest_and_custom_pathologies_match_jax(tmp_path):
    paths = write_nih_tree(tmp_path / "nih", seed=1)
    manifest = tmp_path / "list.txt"
    rel = [str(p.relative_to(tmp_path / "nih")) for p in paths[::3]]
    manifest.write_text("\n".join(f"{r},extra" for r in rel) + "\n\n" + str(paths[1]) + "\n")
    kw = dict(data_dir=str(tmp_path / "nih"), image_list_file=str(manifest))
    _same(ds.NIHChestXrayRetrievalDataset(**kw),
          jax_ds.NIHChestXrayRetrievalDataset(**kw, use_native=False))
    # a missing manifest falls back to the directory, in both
    kw["image_list_file"] = str(tmp_path / "missing.txt")
    _same(ds.NIHChestXrayRetrievalDataset(**kw),
          jax_ds.NIHChestXrayRetrievalDataset(**kw, use_native=False))
    only = tmp_path / "only"
    only.mkdir()
    np.save(only / _nih_name(["Mass"], 1), np.ones((4, 4), np.float32))
    np.save(only / _nih_name(["Hernia", "Mass"], 2), np.ones((4, 4), np.float32))
    kw = dict(data_dir=str(only), pathology_names=["Mass", "Hernia"])
    port = ds.NIHChestXrayRetrievalDataset(**kw)
    _same(port, jax_ds.NIHChestXrayRetrievalDataset(**kw, use_native=False))
    np.testing.assert_array_equal(port.labels, [[1, 1], [1, 0]])  # sorted: Hernia%7CMass first


@pytest.mark.parametrize("name,match", [
    (_nih_name(["Mass", "Cancer"], 1), "Unknown pathologies"),
    ("Chest_X-ray_Mass.npy", "Unsupported NIH file name"),
    ("xray_Mass_1.npy", "Expected token"),
])
def test_nih_bad_names_raise_in_both(tmp_path, name, match):
    np.save(tmp_path / name, np.zeros((4, 4), np.float32))
    for make in (lambda: ds.NIHChestXrayRetrievalDataset(data_dir=str(tmp_path)),
                 lambda: jax_ds.NIHChestXrayRetrievalDataset(data_dir=str(tmp_path),
                                                             use_native=False)):
        with pytest.raises(ValueError, match=match):
            make()
    with pytest.raises(ValueError, match="No input files"):
        ds.NIHChestXrayRetrievalDataset(data_dir=str(tmp_path / "empty"))


def _write_jpegs(root, names, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for name in names:
        Image.fromarray(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)).save(root / name)


@pytest.mark.parametrize("use_melanoma", [True, False])
def test_isic_dataset_matches_jax(tmp_path, use_melanoma):
    rows = [("ISIC_0001", "1.0", "0.0"), ("ISIC_0002", "0.0", "1.0"), ("ISIC_0003", "0", "0"),
            ("ISIC_0004", "1", "1"), ("ISIC_0005", "0.0", "0.0")]
    csv_path = tmp_path / "gt.csv"
    csv_path.write_text("image_id,melanoma,seborrheic_keratosis\n"
                        + "".join(",".join(r) + "\n" for r in rows))
    _write_jpegs(tmp_path / "img", [f"{r[0]}.jpg" for r in rows], seed=2)
    port = ds.ISICDataset(str(tmp_path / "img"), str(csv_path), use_melanoma=use_melanoma)
    _same(port, jax_ds.ISICDataset(str(tmp_path / "img"), str(csv_path),
                                   use_melanoma=use_melanoma))
    assert port.labels == ([2, 1, 0, 2, 0] if use_melanoma else [1, 0, 0])


def test_tbx11k_dataset_matches_jax(tmp_path):
    csv_path = tmp_path / "tbx.csv"
    text = (" FName , Image_Type ,other\n"
            "a.png,tb,x\n b.png , healthy ,y\n,tb,z\nc.png,unknown,w\nd.png,sick_but_no_tb,v\n")
    csv_path.write_bytes(b"\xef\xbb\xbf" + text.encode())
    _write_jpegs(tmp_path / "img", ["a.png", "b.png", "d.png"], seed=3)
    port = ds.TBX11kDataset(str(tmp_path / "img"), str(csv_path))
    _same(port, jax_ds.TBX11kDataset(str(tmp_path / "img"), str(csv_path)))
    assert port.labels == [0, 1, 2]
    bad = tmp_path / "bad.csv"
    bad.write_text("name,type\na.png,tb\n")
    for cls in (ds.TBX11kDataset, jax_ds.TBX11kDataset):
        with pytest.raises(ValueError, match="'fname' and 'image_type'"):
            cls(str(tmp_path), str(bad))


def _vindr_csv(path, rad_id: bool, seed: int):
    rng = np.random.default_rng(seed)
    cols = ["Pneumonia", "Aortic enlargement", "Nodule/Mass", "Other disease", "No finding",
            "Not a VinDr column"]
    ids = ["f3a9", "0b2c", "9e1d", "0b2c", "f3a9", "77aa", "0b2c", "c001"]
    head = ["image_id"] + (["rad_id"] if rad_id else []) + cols
    lines = [",".join(head)]
    for i, image_id in enumerate(ids):
        cells = [str(int(v)) for v in rng.integers(0, 2, len(cols))]
        if i == 2:
            cells[0] = ""  # a missing value
        if i in (5,):
            cells[1] = ""  # 77aa's only row: missing, stays NaN after the max
        lines.append(",".join([image_id] + ([f"R{i % 3}"] if rad_id else []) + cells))
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("rad_id", [True, False])
def test_vindr_dataset_matches_jax(tmp_path, rad_id):
    """The csv-module reader against the JAX package's pandas one: the ids,
    their order, the column order and rename, and the labels, NaN included."""
    csv_path = tmp_path / "vindr.csv"
    _vindr_csv(csv_path, rad_id, seed=4 + rad_id)
    port = ds.VinDrDataset(str(tmp_path), str(csv_path))
    ref = jax_ds.VinDrDataset(str(tmp_path), str(csv_path))
    assert port.label_columns == ref.label_columns
    assert port.label_columns == ["Aortic enlargement", "Nodule/Mass", "Pneumonia",
                                  "Other diseases", "No finding"]
    assert list(port.image_ids) == list(ref.image_ids) and port.image_names == ref.image_names
    assert port.labels.dtype == ref.labels.dtype == np.float32
    np.testing.assert_array_equal(port.labels, ref.labels)  # NaN == NaN here
    assert np.isnan(port.labels).any()
    if rad_id:
        assert port.image_ids == sorted(set(port.image_ids)) and len(port) == 5
    sub = ds.VinDrDataset(str(tmp_path), str(csv_path), label_columns=["No finding", "COPD"])
    assert sub.label_columns == ["No finding"]
    none = tmp_path / "none.csv"
    none.write_text("image_id,foo\na,1\n")
    with pytest.raises(ValueError, match="No known VinDr label columns"):
        ds.VinDrDataset(str(tmp_path), str(none))


def _args(**kw):
    base = dict(dataset_dir=".", val_dataset_dir=None, train_image_list=None,
                val_image_list=None, test_image_list=None, anomaly=False, mask_dir=None)
    return argparse.Namespace(**{**base, **kw})


def test_build_dataset_accepts_the_four_names_as_jax_does(tmp_path):
    write_nih_tree(tmp_path / "nih", seed=5)
    rows = [("ISIC_1", "1", "0"), ("ISIC_2", "0", "1")]
    (tmp_path / "isic.csv").write_text(
        "image_id,melanoma,seborrheic_keratosis\n" + "".join(",".join(r) + "\n" for r in rows))
    (tmp_path / "tbx.csv").write_text("fname,image_type\na.png,tb\nb.png,healthy\n")
    _vindr_csv(tmp_path / "vindr.csv", True, seed=6)
    cases = {
        "nih": dict(dataset_dir=str(tmp_path / "nih"), train_image_list="./missing.txt"),
        "isic": dict(dataset_dir=str(tmp_path), train_image_list=str(tmp_path / "isic.csv"),
                     anomaly=True),
        "tbx11k": dict(dataset_dir=str(tmp_path), train_image_list=str(tmp_path / "tbx.csv")),
        "vindr": dict(dataset_dir=str(tmp_path), train_image_list=str(tmp_path / "vindr.csv")),
    }
    for name, kw in cases.items():
        port = common.build_dataset(_args(dataset=name, **kw), "train")
        ref = jax_common.build_dataset(_args(dataset=name, **kw), "train")
        assert type(port).__name__ == type(ref).__name__
        assert list(port.image_names) == list(ref.image_names), name
        np.testing.assert_array_equal(np.asarray(port.labels), np.asarray(ref.labels))
        assert common.is_multilabel(name) == jax_common.is_multilabel(name)
    assert common.build_dataset(_args(dataset="isic", **cases["isic"]), "train").labels == [1]


def test_split_csv_matches_jax(tmp_path):
    src = tmp_path / "all.csv"
    src.write_text("a,b\n" + "".join(f"{i},{i * i}\n" for i in range(37)) + "\n")
    got = ds.split_csv(str(src), str(tmp_path / "t1"), str(tmp_path / "v1"), 0.2, seed=3)
    want = jax_ds.split_csv(str(src), str(tmp_path / "t2"), str(tmp_path / "v2"), 0.2, seed=3)
    assert got == want == (30, 7)
    for a, b in (("t1", "t2"), ("v1", "v2")):
        assert (tmp_path / a).read_text() == (tmp_path / b).read_text()
