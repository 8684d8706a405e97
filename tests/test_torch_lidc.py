"""The port's LIDC data layer and native augmentation against the JAX
package's, on a synthetic cropped-nodule set of 16^3 volumes: the ID/OoD
labeling (``id_ood.csv`` byte for byte, written without pandas), the
first-cycle splits (without scikit-learn), the LIDC datamodule's
preprocessing, splits and batches (byte-equal, with and without
``augment``), the native mirror and noise against their numpy versions
and the JAX package's build, and ``softmax_config_lidc`` through the
training CLI."""
import os
import pickle
import shutil

import numpy as np
import pandas as pd
import pytest

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu import native as jax_native
from values_tpu.core import nifti
from values_tpu.data import lidc as JL
from values_tpu.data.lidc_datamodule import \
    LidcIdriDataModule3D as JaxLidcDataModule
from values_tpu_torch.config.instantiate import locate
from values_tpu_torch.data import lidc as PL
from values_tpu_torch.data import native
from values_tpu_torch.data.lidc_datamodule import LidcIdriDataModule3D
from values_tpu_torch.training.main import main

P, PATIENTS, NODULES = 16, 24, 3


def _ratings(rng, lo, hi):
    return [int(v) for v in rng.randint(lo, hi, size=4)]


@pytest.fixture(scope="module", autouse=True)
def jax_native_lib():
    """The JAX package's native library, built once from this thread
    before any JAX datamodule exists. Its loader is not thread-safe on a
    first build (ROADMAP.md fault R9): a loader thread that asks while
    another builds gets None and takes the numpy fallback, whose noise
    stream is not the native one. Loaded here, every comparison is native
    against native."""
    lib = jax_native.get_lib()
    assert lib is not None, "the JAX package's native library did not load"
    return lib


@pytest.fixture(scope="module")
def lidc_root(tmp_path_factory):
    """24 patients of 3 nodules, 4 rater masks each, and a metadata.csv
    written by pandas (as the extraction stage writes it): the first 16
    patients' textures lean ID, the rest OoD (3 counts as ID, so some
    nodules tie), and one nodule lacks a malignancy rating."""
    rng = np.random.RandomState(0)
    root = tmp_path_factory.mktemp("LIDC")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rows = []
    for scan_id in range(PATIENTS):
        for nod_idx in range(NODULES):
            image_id = f"{scan_id:04d}_{nod_idx:02d}"
            nifti.save(rng.rand(P, P, P), root / "images"
                       / f"{image_id}.nii.gz")
            seg_paths = []
            for r in range(4):
                path = root / "labels" / f"{image_id}_{r:02d}_mask.nii.gz"
                nifti.save((rng.rand(P, P, P) > 0.8).astype(np.intc), path)
                seg_paths.append(str(path))
            malignancy = _ratings(rng, 1, 6)
            if (scan_id, nod_idx) == (3, 1):
                malignancy[2] = None
            rows.append({
                "Patient ID": f"LIDC-IDRI-{scan_id:04d}",
                "Scan ID": f"{scan_id:04d}", "Nodule Index": f"{nod_idx:02d}",
                "Image Save Path": str(root / "images"
                                       / f"{image_id}.nii.gz"),
                "Segmentation Save Paths": str(seg_paths),
                "subtlety": str([3, 3, 3, 3]),
                "internal Structure": str([1, 1, 2, 1]),
                "calcification": str([6, 6, 6, 6]),
                "sphericity": str(_ratings(rng, 1, 6)),
                "margin": str([3, 3, 3, 3]),
                "lobulation": str(_ratings(rng, 1, 6)),
                "spiculation": str([1, 1, 1, 1]),
                "texture": str(_ratings(rng, 3, 6) if scan_id < 16
                               else _ratings(rng, 1, 4)),
                "malignancy": str(malignancy),
            })
    pd.DataFrame(rows).to_csv(root / "metadata.csv", index=False)
    JL.calculate_rater_agreement(root, save_df=True)
    return root


def test_feature_dict_matches_jax():
    assert PL.get_feature_dict() == JL.get_feature_dict()


def test_rater_agreement_matches_jax(lidc_root, tmp_path):
    """The CLI's ``id_ood`` writes the JAX package's id_ood.csv byte for
    byte (pandas' types and quoting, the metadata's row indices, the
    nodule without a full rating dropped), and the rows it returns carry
    the same labels (True, False, or None for a tie)."""
    shutil.copy(lidc_root / "metadata.csv", tmp_path)
    PL.main(["id_ood", "-d", str(tmp_path)])
    assert (tmp_path / "id_ood.csv").read_bytes() == (
        lidc_root / "id_ood.csv").read_bytes()
    rows = PL.calculate_rater_agreement(str(tmp_path), save_df=False)
    want = JL.calculate_rater_agreement(str(lidc_root), save_df=False)
    assert len(rows) == len(want) == PATIENTS * NODULES - 1
    for feature in PL.get_feature_dict():
        got = [row[f"{feature}_id"] for row in rows]
        assert got == [None if v is None else bool(v)
                       for v in want[f"{feature}_id"]], feature
    assert None in [row["texture_id"] for row in rows]


def _assert_splits_equal(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            assert type(g[key]) is type(w[key]), key
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(w[key]), err_msg=key)


@pytest.mark.parametrize("via", ["function", "cli"])
def test_first_cycle_splits_match_jax(lidc_root, tmp_path, via):
    """The patient-disjoint splits of the JAX package (its pandas and
    scikit-learn KFold) from the same id_ood.csv."""
    want_path, got_path = tmp_path / "jax.pkl", tmp_path / "port.pkl"
    JL.create_first_cycle_splits(str(want_path), "texture",
                                 str(lidc_root / "id_ood.csv"))
    if via == "cli":
        PL.main(["splits", "--id_ood_csv", str(lidc_root / "id_ood.csv"),
                 "--splits_path", str(got_path)])
    else:
        PL.create_first_cycle_splits(str(got_path), "texture",
                                     str(lidc_root / "id_ood.csv"))
    with open(got_path, "rb") as f, open(want_path, "rb") as g:
        _assert_splits_equal(pickle.load(f), pickle.load(g))


def _datamodules(lidc_root, tmp_path, augment, patch=P // 2):
    """The port's and the JAX datamodule, each preparing (preprocessing,
    splitting) its own copy of the tree. Patches of half the volume: the
    JAX loader mirrors a whole-volume crop in the memory-mapped file
    (fault R7, test_augment_copies_a_whole_volume_crop)."""
    out = []
    for name, cls in (("port", LidcIdriDataModule3D),
                      ("jax", JaxLidcDataModule)):
        root = tmp_path / name
        shutil.copytree(lidc_root, root)
        dm = cls(data_input_dir=str(root), patch_size=patch, batch_size=4,
                 augment=augment, num_workers=2, seed=123)
        dm.prepare_data()
        dm.setup()
        out.append(dm)
    return out


def _assert_batches_equal(port_loader, jax_loader):
    n = 0
    for a, b in zip(port_loader, jax_loader, strict=True):
        assert a.keys() == b.keys()
        for key in a:
            if isinstance(a[key], np.ndarray):
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes(), key
            else:
                assert [os.path.basename(str(v)) for v in a[key]] == [
                    os.path.basename(str(v)) for v in b[key]], key
        n += 1
    assert n


@pytest.mark.parametrize("augment", [False, True],
                         ids=["plain", "augment"])
def test_datamodule_batches_byte_equal_to_jax(lidc_root, tmp_path,
                                              augment):
    """Preprocessed volumes and masks, the splits made from id_ood.csv
    and the split keys as the JAX datamodule has them; two training
    epochs (random crops, raters and, with ``augment``, mirrors and noise
    through each package's native build) and the validation windows
    byte-equal."""
    port, ref = _datamodules(lidc_root, tmp_path, augment)
    for sub in ("images", "labels"):
        names = sorted(os.listdir(os.path.join(ref.preprocessed_dir, sub)))
        assert sorted(os.listdir(os.path.join(port.preprocessed_dir,
                                              sub))) == names
        for name in names[:6]:
            a = np.load(os.path.join(port.preprocessed_dir, sub, name))
            b = np.load(os.path.join(ref.preprocessed_dir, sub, name))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    with open(port._splits_file(), "rb") as f, \
            open(ref._splits_file(), "rb") as g:
        _assert_splits_equal(pickle.load(f), pickle.load(g))
    assert (port.tr_keys, port.val_keys, port.test_keys) == (
        ref.tr_keys, ref.val_keys, ref.test_keys)
    port_train, ref_train = port.train_dataloader(), ref.train_dataloader()
    for _ in range(2):
        _assert_batches_equal(port_train, ref_train)
    _assert_batches_equal(port.val_dataloader(), ref.val_dataloader())


def test_augment_copies_a_whole_volume_crop(lidc_root, tmp_path):
    """Where the training crop is the whole volume (LIDC's and Case_1's
    64^3 at patch 64), a crop of an int32 mask is a read-only view of the
    memory-mapped file; the port mirrors a copy (the JAX loader mirrors
    the view in place and faults, R7): the batches come, and every file
    stays as it was."""
    root = tmp_path / "LIDC"
    shutil.copytree(lidc_root, root)
    dm = LidcIdriDataModule3D(data_input_dir=str(root), patch_size=P,
                              batch_size=4, augment=True, num_workers=2,
                              seed=123)
    dm.prepare_data()
    dm.setup()
    labels = os.path.join(dm.preprocessed_dir, "labels")
    before = {n: np.load(os.path.join(labels, n)).tobytes()
              for n in os.listdir(labels)}
    assert np.load(os.path.join(labels, sorted(before)[0])).dtype == np.int32
    batches = list(dm.train_dataloader())
    assert sum(len(b["data"]) for b in batches) == len(dm.tr_keys)
    assert all(b["data"].shape[1:] == (P, P, P, 1) for b in batches)
    assert {n: np.load(os.path.join(labels, n)).tobytes()
            for n in os.listdir(labels)} == before


def test_native_ops_match_numpy_and_jax():
    """The mirror, for every flip set and both dtypes, equals its numpy
    version and the JAX package's build; the noise equals the JAX build
    bit for bit and its numpy version (the xoshiro256++ stream,
    Box-Muller, one rounding) within one float32 ulp. Arrays the ops do
    not take raise."""
    rs = np.random.RandomState(3)
    vol = rs.randn(P, P, P).astype(np.float32)
    labels = rs.randint(0, 3, (P, P, P)).astype(np.int32)
    for arr in (vol, labels):
        for flips in range(8):
            got = native.mirror3d(arr.copy(), flips)
            np.testing.assert_array_equal(
                got, native.mirror3d_plain(arr, flips))
            np.testing.assert_array_equal(
                got, jax_native.mirror3d(arr.copy(), flips))
    got = native.add_gaussian_noise(vol.copy(), 0.07, 123456789)
    np.testing.assert_array_equal(
        got, jax_native.add_gaussian_noise(vol.copy(), 0.07, 123456789))
    np.testing.assert_array_max_ulp(
        got, native.add_gaussian_noise_plain(vol, 0.07, 123456789), 1)
    assert np.std(got - vol) == pytest.approx(0.07, rel=0.05)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.mirror3d(np.asfortranarray(vol), 1)
    read_only = vol.copy()
    read_only.flags.writeable = False
    with pytest.raises(ValueError, match="writeable"):
        native.add_gaussian_noise(read_only, 0.1, 0)
    with pytest.raises(ValueError, match="cube"):
        native.mirror3d(np.zeros((4, 4, 2), np.float32), 1)


def test_lidc_config_trains_on_the_cpu(lidc_root, tmp_path):
    """Both LIDC targets resolve to the port's datamodule, and the
    training CLI trains softmax_config_lidc (tiny) on the tree, making
    its own splits: a finite checkpoint."""
    for target in ("values_tpu.data.lidc_datamodule.LidcIdriDataModule3D",
                   "uncertainty_modeling.lidc_idri_datamodule_3D."
                   "LidcIdriDataModule3D"):
        assert locate(target) is LidcIdriDataModule3D
    root = tmp_path / "LIDC"
    shutil.copytree(lidc_root, root)
    ckpt = main(["--device", "cpu", "--config-name", "softmax_config_lidc",
                 f"data_input_dir={root}", f"save_dir={tmp_path / 'exp'}",
                 "max_epochs=1", "batch_size=4", "datamodule.patch_size=16",
                 "datamodule.batch_size=4", "datamodule.num_workers=2",
                 "model.initial_filter_size=2", "version=0"])
    assert os.path.exists(root / "splits_texture.pkl")
    with open(ckpt, "rb") as f:
        payload = pickle.load(f)
    assert payload["hyper_parameters"]["exp_name"] == "Softmax-LIDC"
    leaves = payload["state_dict"]["params"]["final"]
    assert all(np.isfinite(v).all() for v in leaves.values())
