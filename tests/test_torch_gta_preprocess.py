"""The port's GTA/Cityscapes preprocessing and splits (values_tpu_torch.
data.gta_preprocess, its CLI) against the JAX package's (cv2 and
scikit-learn): on a raw tree of 2 GTA images at 1914x1052 (colour label
PNGs) and 2 Cityscapes images at 2048x1024 (grey labelIds, one train
city, one val city), written by cv2 with its own filters, the ``.npy``
outputs are byte-equal and the vis PNGs decode to the same arrays; the
splits of a larger file tree are equal; ``kfold_indices`` equals
scikit-learn's shuffled KFold; an unknown colour still asserts."""
import os
import pickle

import cv2
import numpy as np
import pytest
from sklearn.model_selection import KFold

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.data import cityscapes_labels as JL
from values_tpu.data import gta_preprocess as J
from values_tpu_torch.data import gta_preprocess as P
from values_tpu_torch.data.preprocess3d import kfold_indices

GTA_SIZE = (1052, 1914)
CS_SIZE = (1024, 2048)


def _raw_tree(root):
    rng = np.random.RandomState(0)
    colours = sorted(JL.color2trainId)
    gta = root / "gta"
    for sub in ("images", "labels"):
        (gta / sub).mkdir(parents=True)
    for i in range(2):
        img = rng.randint(0, 256, GTA_SIZE + (3,)).astype(np.uint8)
        img[:, : GTA_SIZE[1] // 2] //= 7  # smoother: other PNG filters
        cv2.imwrite(str(gta / "images" / f"{i:05d}.png"), img)
        ids = rng.randint(0, len(colours), (GTA_SIZE[0] // 8 + 1,
                                            GTA_SIZE[1] // 8 + 1))
        ids = np.repeat(np.repeat(ids, 8, 0), 8, 1)[: GTA_SIZE[0],
                                                    : GTA_SIZE[1]]
        rgb = np.array(colours, dtype=np.uint8)[ids]
        cv2.imwrite(str(gta / "labels" / f"{i:05d}.png"), rgb[..., ::-1])
    # a corrupt file of the published set is skipped, as in the reference
    cv2.imwrite(str(gta / "images" / "15188.png"),
                np.zeros((8, 8, 3), np.uint8))
    cs = root / "cs"
    for split, city in (("train", "aachen"), ("val", "lindau")):
        img_dir = cs / "images" / "leftImg8bit" / split / city
        lbl_dir = cs / "labels" / "gtFine" / split / city
        img_dir.mkdir(parents=True)
        lbl_dir.mkdir(parents=True)
        name = f"{city}_000000_000019"
        cv2.imwrite(str(img_dir / f"{name}_leftImg8bit.png"),
                    rng.randint(0, 256, CS_SIZE + (3,)).astype(np.uint8))
        cv2.imwrite(str(lbl_dir / f"{name}_gtFine_labelIds.png"),
                    rng.randint(0, 34, CS_SIZE).astype(np.uint8))
    return gta, cs


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    root = tmp_path_factory.mktemp("gta_raw")
    gta, cs = _raw_tree(root)
    out = {}
    for pkg in ("jax", "port"):
        base = root / pkg
        for dataset, raw, sub in (("gta", gta, "OriginalData"),
                                  ("cityscapes", cs,
                                   "CityScapesOriginalData")):
            if pkg == "jax":
                J.preprocess_dataset(str(raw), str(base / sub), dataset)
            else:
                P.main(["preprocess", "--dataset_path", str(raw),
                        "--save_path", str(base / sub), "--dataset",
                        dataset])
        out[pkg] = base
    return out


def _files(base):
    return sorted(str(p.relative_to(base)) for p in base.rglob("*")
                  if p.is_file())


def test_preprocessed_arrays_are_byte_equal(preprocessed):
    jax_base, port_base = preprocessed["jax"], preprocessed["port"]
    files = _files(jax_base)
    assert files == _files(port_base)
    npys = [f for f in files if f.endswith(".npy")]
    assert len(npys) == 8 and not any("15188" in f for f in files)
    for f in npys:
        want, got = np.load(jax_base / f), np.load(port_base / f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert got.tobytes() == want.tobytes(), f
    for f in files:
        if f.endswith(".png"):
            np.testing.assert_array_equal(
                cv2.imread(str(port_base / f), -1),
                cv2.imread(str(jax_base / f), -1), err_msg=f)
    image = np.load(port_base / "OriginalData" / "preprocessed" / "images"
                    / "00000.npy")
    assert image.shape == (256, 478, 3) and image.dtype == np.uint8


def test_resizes_follow_cv2():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (64, 120, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        P.quarter_linear(img),
        cv2.resize(img, (0, 0), fx=0.25, fy=0.25,
                   interpolation=cv2.INTER_LINEAR))
    mask = rng.randint(0, 34, (64, 120)).astype(np.uint8)
    np.testing.assert_array_equal(
        P.quarter_nearest(mask),
        cv2.resize(mask, (0, 0), fx=0.25, fy=0.25,
                   interpolation=cv2.INTER_NEAREST))
    with pytest.raises(ValueError, match="multiples of 4"):
        P.quarter_linear(img[:63])


def test_label_conversions_equal_jax():
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 34, (20, 30)).astype(np.uint8)
    np.testing.assert_array_equal(P.label_ids_to_train_ids(ids),
                                  J.label_ids_to_train_ids(ids))
    train = P.label_ids_to_train_ids(ids)
    colour = P.train_ids_to_color(train)
    np.testing.assert_array_equal(colour, J.train_ids_to_color(train))
    np.testing.assert_array_equal(P.color_mask_to_train_ids(colour),
                                  J.color_mask_to_train_ids(colour))


def test_unknown_colour_asserts(tmp_path):
    raw = tmp_path / "gta"
    for sub in ("images", "labels"):
        (raw / sub).mkdir(parents=True)
    cv2.imwrite(str(raw / "images" / "00001.png"),
                np.zeros((16, 16, 3), np.uint8))
    cv2.imwrite(str(raw / "labels" / "00001.png"),
                np.full((16, 16, 3), 3, np.uint8))
    with pytest.raises(AssertionError, match="Unknown color"):
        P.preprocess_dataset(str(raw), str(tmp_path / "out"), "gta")


@pytest.mark.parametrize("n", [5, 7, 23, 48])
def test_kfold_indices_equal_sklearn(n):
    want = list(KFold(n_splits=5, shuffle=True, random_state=123).split(
        np.arange(n)))
    got = list(kfold_indices(n, 5, 123))
    assert len(got) == len(want)
    for (gt, gv), (wt, wv) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)


def test_splits_equal_jax(tmp_path):
    """Splits of 41 GTA and 9 Cityscapes files (3 train cities, 2 val
    cities) through both CLIs."""
    base, orig = tmp_path / "pre", tmp_path / "raw"
    gta = base / "OriginalData" / "preprocessed" / "images"
    cs = base / "CityScapesOriginalData" / "preprocessed" / "images"
    gta.mkdir(parents=True)
    cs.mkdir(parents=True)
    for i in range(41):
        (gta / f"{i:05d}.npy").write_bytes(b"")
    cities = {"train": ["aachen", "bochum", "zurich"],
              "val": ["lindau", "munster"]}
    k = 0
    for split, names in cities.items():
        for city in names:
            (orig / "CityScapesOriginalData" / "images" / "leftImg8bit"
             / split / city).mkdir(parents=True)
            for _ in range(2 if city != "munster" else 1):
                (cs / f"{city}_{k:06d}_000019.npy").write_bytes(b"")
                k += 1
    (gta / "._hidden.npy").write_bytes(b"")
    paths = {}
    for pkg in ("jax", "port"):
        paths[pkg] = tmp_path / pkg / "splits.pkl"
        args = ["splits", "--dataset_path", str(base),
                "--original_dataset_path", str(orig), "--splits_path",
                str(paths[pkg]), "--seed", "124"]
        (J if pkg == "jax" else P).main(args)
    with open(paths["jax"], "rb") as f:
        want = pickle.load(f)
    with open(paths["port"], "rb") as f:
        got = pickle.load(f)
    assert got == want
    assert len(got) == 5 and len(got[0]["ood_unlabeled_pool"]) == 6
    assert os.path.getsize(paths["port"]) > 0
