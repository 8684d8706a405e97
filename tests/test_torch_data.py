"""The port's own copies of the JAX package's numpy-only helpers (window
enumeration, sample listing, pickle reading, split resolution, seeding)
against the originals, on the same inputs."""
import argparse
import os
import pickle
import random

import numpy as np
import pytest
import torch

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.core import io as jio
from values_tpu.data import samples as jsamples
from values_tpu.inference import test_3d as jtest_3d
from values_tpu.ops import window as jwindow
from values_tpu_torch.core import io
from values_tpu_torch.core.seed import make_generator, set_seed
from values_tpu_torch.data import samples
from values_tpu_torch.inference import test_3d
from values_tpu_torch.ops import window


@pytest.mark.parametrize("shape,patch,overlap", [
    ((64, 64, 64), 64, 1.0), ((128, 96, 64), 64, 1.0),
    ((130, 70, 64), 64, 0.5), ((32, 16, 40), 64, 1.0)])
def test_window_enumeration_matches_jax(shape, patch, overlap):
    want = jwindow.enumerate_window_starts(shape, patch, overlap)
    got = window.enumerate_window_starts(shape, patch, overlap)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert (window.window_crop_tuples(got, patch)
            == jwindow.window_crop_tuples(want, patch))
    with pytest.raises(ValueError):
        window.enumerate_window_starts(shape, patch, 0.0)


def _dataset(root, flat):
    """Three images (one of two windows) with two raters' labels under
    both directory layouts; the LIDC one with the ``_mask`` suffix."""
    suffix = "_mask" if flat else ""
    for split in ("", ) if flat else ("Tr", "Ts"):
        images = root / ("images" if flat else f"images{split}")
        labels = root / ("labels" if flat else f"labels{split}")
        images.mkdir(parents=True)
        labels.mkdir(parents=True)
        for k, shape in enumerate([(16, 16, 16), (32, 16, 16), (16,) * 3]):
            np.save(images / f"s{k}.npy", np.zeros(shape, np.float32))
            for rater in range(2 if k != 2 else 0):
                np.save(labels / f"s{k}_{rater:02d}{suffix}.npy",
                        np.zeros(shape, np.uint8))
    return suffix


@pytest.mark.parametrize("flat", [False, True], ids=["toy", "lidc"])
def test_sample_listing_matches_jax(tmp_path, flat):
    """Train and val/test samples: the same dicts in the same order,
    with and without a subject filter (an image without labels gets
    ``label_paths`` None)."""
    suffix = _dataset(tmp_path, flat)
    kw = dict(num_raters=3, label_suffix=suffix, flat_dirs=flat)
    for subjects in (None, ["s1.npy", "s2.npy"]):
        assert (samples.get_train_data_samples(str(tmp_path),
                                               subject_ids=subjects, **kw)
                == jsamples.get_train_data_samples(str(tmp_path),
                                                   subject_ids=subjects, **kw))
        for test in (False, True):
            vkw = dict(kw, subject_ids=subjects, test=test, patch_size=16)
            assert (samples.get_val_test_data_samples(str(tmp_path), **vkw)
                    == jsamples.get_val_test_data_samples(str(tmp_path),
                                                          **vkw))


def test_file_helpers_match_jax(tmp_path):
    """load_pickle reads what the JAX package's save_pickle writes, as
    the JAX load_pickle does, from a str or a Path."""
    obj = {"a": np.arange(3), "b": [1, "two"], "c": None}
    path = tmp_path / "p" / "y.pkl"
    jio.save_pickle(obj, path)
    for where in (path, str(path)):
        got, want = io.load_pickle(where), jio.load_pickle(where)
        assert got.keys() == want.keys() == obj.keys()
        np.testing.assert_array_equal(got["a"], want["a"])
        assert got["b"] == want["b"] and got["c"] is want["c"] is None


@pytest.mark.parametrize("split", ["id", "ood", "val", "train",
                                   "unlabeled"])
def test_lidc_split_resolution_matches_jax(tmp_path, split):
    """Shift-feature splits from ``splits_path``, rebased onto ``-i``."""
    fold = {f"{s}_test": [f"{s}{k}.npy" for k in range(2)]
            for s in ("id", "ood")}
    fold.update(val=["v.npy"], train=["t.npy"], id_unlabeled_pool=["u.npy"],
                ood_unlabeled_pool=["w.npy"])
    (tmp_path / "new").mkdir()
    with open(tmp_path / "new" / "splits_texture.pkl", "wb") as f:
        pickle.dump([{}, fold], f)
    hp = {"data_input_dir": str(tmp_path / "old"),
          "datamodule": {"shift_feature": "texture", "data_fold_id": 1,
                         "splits_path": str(tmp_path / "old" /
                                            "splits_texture.pkl")}}
    args = argparse.Namespace(data_input_dir=str(tmp_path / "new"),
                              test_split=split)
    got = test_3d.dir_and_subjects_from_train_lidc(hp, args, split)
    assert got == jtest_3d.dir_and_subjects_from_train_lidc(hp, args, split)
    assert got[0] == os.path.join(str(tmp_path / "new"), "preprocessed")


def test_toy_split_resolution_matches_jax(tmp_path):
    (tmp_path / "Case_1").mkdir()
    with open(tmp_path / "Case_1" / "splits.pkl", "wb") as f:
        pickle.dump([{"val": ["a.npy"], "train": ["b.npy"]}], f)
    hp = {"data_input_dir": str(tmp_path),
          "datamodule": {"dataset_name": "Case_1", "data_fold_id": 0}}
    args = argparse.Namespace(data_input_dir=None, test_split="val")
    assert (test_3d.dir_and_subjects_from_train(hp, args)
            == jtest_3d.dir_and_subjects_from_train(hp, args))


def test_seeding(monkeypatch):
    """set_seed seeds python, numpy and torch; make_generator gives the
    same stream for the same seed."""
    monkeypatch.setenv("PYTHONHASHSEED", "0")   # restored afterwards
    set_seed(5)
    first = (random.random(), np.random.rand(), torch.rand(()))
    set_seed(5)
    assert first == (random.random(), np.random.rand(), torch.rand(()))
    assert os.environ["PYTHONHASHSEED"] == "5"
    a = torch.randint(0, 2 ** 31 - 1, (4,), generator=make_generator(123))
    b = torch.randint(0, 2 ** 31 - 1, (4,), generator=make_generator(123))
    assert torch.equal(a, b)
