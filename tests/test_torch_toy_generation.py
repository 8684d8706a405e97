"""The port's toy-data generator (values_tpu_torch.data.toy_generation)
against the JAX package's: the same seed gives the same arrays, file for
file, for every option of ``ToyGenConfig`` and through the benchmark-case
CLI (at cut sizes), read back by the JAX package's NIfTI reader."""
import os
import random

import numpy as np
import pytest

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.core import nifti as jax_nifti
from values_tpu.data import toy_generation as J
from values_tpu_torch.data import toy_generation as T

CONFIGS = {
    "blur_raters": dict(n_samples=3, image_size=(16, 16, 16), gauss_sigma=2,
                        blur=True, n_raters=3, seed=16),
    "noise_gray": dict(n_samples=3, image_size=(16, 16, 16), gauss_sigma=8,
                       object_gray=True, noise=True, n_raters=1, seed=14),
    "over_border": dict(n_samples=4, image_size=(16, 16, 16), noise=True,
                        object_over_border=True, sample_offset=21, seed=17),
    "cube_same_raters": dict(input_files=["Cube.stl"], n_samples=2,
                             image_size=(16,), all_raters_same=True,
                             n_raters=2, seed=3),
}


def _tree(root):
    """{relative path: (array, affine)} of every .nii.gz under root."""
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            data, header = jax_nifti.load(path)
            out[os.path.relpath(path, root)] = (data, header)
    return out


def _assert_same_tree(got_root, want_root):
    got, want = _tree(got_root), _tree(want_root)
    assert sorted(got) == sorted(want) and want
    for name, (data, _) in want.items():
        assert got[name][0].dtype == data.dtype, name
        np.testing.assert_array_equal(got[name][0], data, err_msg=name)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generate_samples_matches_jax(tmp_path, name):
    """Each option set, seeded as the benchmark driver seeds it (Python's
    random and numpy's global RNG), writes the same volumes and rater
    masks as the JAX generator."""
    for pkg, out in ((J, "jax"), (T, "port")):
        cfg = pkg.ToyGenConfig(save_path=str(tmp_path / out),
                               **CONFIGS[name])
        random.seed(cfg.seed)
        np.random.seed(cfg.seed)
        pkg.generate_samples(cfg)
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")


def test_benchmark_cases_equal_jax():
    assert T.BENCHMARK_CASES == J.BENCHMARK_CASES


def test_cli_matches_jax_at_a_cut_size(tmp_path, monkeypatch):
    """``main --dataset_name Case_1`` (its published options, 2 training
    and 1 test volume of 16^3) writes the images{Tr,Ts}/labels{Tr,Ts}
    tree of the JAX CLI."""
    case = {split: [dict(cfg, n_samples=n, image_size=(16, 16, 16))
                    for cfg in J.BENCHMARK_CASES["Case_1"][split]]
            for split, n in (("train", 2), ("test", 1))}
    monkeypatch.setitem(J.BENCHMARK_CASES, "Case_1", case)
    monkeypatch.setitem(T.BENCHMARK_CASES, "Case_1", case)
    J.main(["--base_save_path", str(tmp_path / "jax")])
    T.main(["--base_save_path", str(tmp_path / "port"),
            "--dataset_name", "Case_1"])
    assert sorted(os.listdir(tmp_path / "port" / "Case_1")) == [
        "imagesTr", "imagesTs", "labelsTr", "labelsTs"]
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
