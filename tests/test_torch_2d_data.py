"""The port's 2D data modules (values_tpu_torch.data.cityscapes_labels,
augment2d, cityscapes_dataset, base_datamodule) against the JAX
package's: the same tables, every transform the test and validation
pipelines and TTA use giving the same arrays under the same host seeds,
and the test loader's batches byte-equal, in plain and TTA mode."""
import copy
import random

import numpy as np
import pytest

from tests.test_2d_path import AUG_CONFIG, _hrnet_hparams, make_gta_tree
from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.config import instantiate as jax_instantiate
from values_tpu.config import make_config as jax_make_config
from values_tpu.data import augment2d as JA
from values_tpu.data import cityscapes_labels as JL
from values_tpu.inference.test_2d import Tester2D as JaxTester2D
from values_tpu_torch.config import instantiate, make_config
from values_tpu_torch.data import augment2d as PA
from values_tpu_torch.data import cityscapes_labels as PL
from values_tpu_torch.data.base_datamodule import (BaseDataModule,
                                                   get_max_steps)


@pytest.fixture(scope="module")
def gta_tree(tmp_path_factory):
    return make_gta_tree(tmp_path_factory.mktemp("GTA"))


def test_label_tables_are_equal():
    assert PL.labels == JL.labels
    for name in ("name2label", "id2label", "trainId2label", "id2trainId",
                 "color2trainId", "name2trainId", "trainId2color",
                 "LABEL_SWITCHES"):
        assert getattr(PL, name) == getattr(JL, name), name


def _seeded(seed):
    random.seed(seed)
    np.random.seed(seed)


TRANSFORMS = {
    "HorizontalFlip": {"p": 0.5},
    "PadIfNeeded": {"min_height": 40, "min_width": 60, "mask_value": 255},
    "RandomCrop": {"height": 20, "width": 30},
    "GaussNoise": {},
    "Normalize": {"mean": [0.485, 0.456, 0.406],
                  "std": [0.229, 0.224, 0.225]},
    "StochasticLabelSwitches": {"always_apply": True, "p": 1.0,
                                "n_reference_samples": 4},
    "ToTensorV2": {},
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax_under_the_same_seed(name):
    """Five draws of each transform from the same python/numpy seeds give
    byte-equal images and masks."""
    rng = np.random.RandomState(0)
    img = (rng.rand(32, 48, 3) * 255).astype(np.uint8)
    mask = rng.randint(0, 19, size=(32, 48)).astype(np.int64)
    outs = []
    for mod in (JA, PA):
        _seeded(7)
        t = mod.get_augmentations_from_config([{name: TRANSFORMS[name]}])[0]
        outs.append([t(image=img, mask=mask) for _ in range(5)])
    for want, got in zip(*outs):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


TRAIN_ONLY = {
    "Rotate": {"limit": 22.5, "border_mode": 0, "mask_value": 255,
               "p": 1.0},
    "RandomScale": {"scale_limit": [-0.3, 0.3], "p": 1.0},
}


@pytest.mark.parametrize("name", ["Rotate", "RandomScale"])
def test_training_transforms_raise_naming_2d(name):
    """The TRAIN pipeline's cv2 transforms, redone in numpy, against the
    JAX ones (cv2) under the same seeds on 12 shapes: masks equal, images
    within 1e-2 on 0-255 values (cv2 rounds its warp's source point to
    1/32 pixel; 1.5e-3 measured), same shapes and types."""
    rng = np.random.RandomState(1)
    worst = 0.0
    for trial in range(12):
        h, w = rng.randint(20, 70), rng.randint(20, 110)
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        mask = rng.randint(0, 19, size=(h, w)).astype(np.int64)
        outs = []
        for mod in (JA, PA):
            _seeded(trial)
            t = mod.get_augmentations_from_config(
                [{name: TRAIN_ONLY[name]}])[0]
            outs.append(t(image=img, mask=mask))
        want, got = outs
        for key in ("image", "mask"):
            assert got[key].shape == want[key].shape, (trial, key)
            assert got[key].dtype == want[key].dtype, (trial, key)
        np.testing.assert_array_equal(got["mask"], want["mask"])
        worst = max(worst, float(np.abs(got["image"] - want["image"]).max()))
    assert worst < 1e-2


def _train_batches(pkg, hparams, epochs=2):
    node, inst = ((jax_make_config, jax_instantiate) if pkg == "jax"
                  else (make_config, instantiate))
    _seeded(hparams["seed"])
    dm = inst(node(dict(hparams["datamodule"], _recursive_=False)),
              data_input_dir=hparams["data_input_dir"],
              augmentations=hparams["AUGMENTATIONS"], seed=hparams["seed"],
              max_epochs=epochs)
    dm.setup("fit")
    loader = dm.train_dataloader()
    return dm, [list(loader) for _ in range(epochs)]


def test_setup_fit_reaches_the_training_refusal(gta_tree, tmp_path):
    """``setup("fit")`` builds the TRAIN pipeline, and two epochs of the
    train loader (shuffled by ``RandomState(seed + epoch)``, the last
    batch dropped) equal the JAX loader's under the same host seeds:
    ``seg`` exactly, ``data`` within 1e-4 (the Rotate images' 1.5e-3 on
    0-255, divided by Normalize's 255 std)."""
    hp = _hrnet_hparams(gta_tree, tmp_path)
    hp["datamodule"]["batch_size"] = 1
    _, want = _train_batches("jax", hp)
    dm, got = _train_batches("torch", hp)
    assert isinstance(dm, BaseDataModule)
    assert [len(e) for e in got] == [len(e) for e in want] == [2, 2]
    for g_epoch, w_epoch in zip(got, want):
        for g, w in zip(g_epoch, w_epoch):
            assert sorted(g) == sorted(w)
            assert g["seg"].dtype == w["seg"].dtype
            np.testing.assert_array_equal(g["seg"], w["seg"])
            assert g["data"].dtype == w["data"].dtype == np.float32
            np.testing.assert_allclose(g["data"], w["data"], rtol=0,
                                       atol=1e-4)
    assert (got[0][0]["seg"] == 255).any()  # the rotation's border
    dm.setup("validate")
    assert len(dm.DS_val) == 1 and len(dm.val_dataloader()) == 1
    assert dm.max_steps() == 4
    assert get_max_steps(10, 3, 2, 1, 4) == (8, 2)


def _batches(pkg, hparams, split, tta, n_ref):
    """The test loader's batches from ``pkg``'s datamodule, built as the
    testers build it (n_reference_samples patched, host seeds set)."""
    hparams = JaxTester2D.set_n_reference_samples(copy.deepcopy(hparams),
                                                  n_ref)
    node, inst = ((jax_make_config, jax_instantiate) if pkg == "jax"
                  else (make_config, instantiate))
    _seeded(hparams["seed"])
    dm = inst(node(dict(hparams["datamodule"], _recursive_=False)),
              data_input_dir=hparams["data_input_dir"],
              augmentations=hparams["AUGMENTATIONS"], seed=hparams["seed"],
              test_split=split, tta=tta)
    dm.setup("test")
    if pkg == "torch":
        assert isinstance(dm, BaseDataModule)
    return list(dm.test_dataloader())


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
@pytest.mark.parametrize("split", ["id", "ood", "val", "unlabeled"])
def test_test_batches_byte_equal_to_jax(gta_tree, tmp_path, split, tta):
    hp = _hrnet_hparams(gta_tree, tmp_path)
    hp["datamodule"]["val_batch_size"] = 2
    want = _batches("jax", hp, split, tta, 3)
    got = _batches("torch", hp, split, tta, 3)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            if isinstance(w[key], np.ndarray):
                assert g[key].dtype == w[key].dtype
                assert g[key].tobytes() == w[key].tobytes(), key
            elif key == "data":  # TTA: per item, 4 variants
                for gi, wi in zip(g[key], w[key]):
                    assert [v.tobytes() for v in gi] == \
                        [v.tobytes() for v in wi]
            else:
                assert g[key] == w[key], key
    if tta:
        assert got[0]["transforms"][0] == [
            [], ["HorizontalFlip"], ["GaussNoise"],
            ["HorizontalFlip", "GaussNoise"]]
    assert got[0]["seg"].shape[1] == 3  # the switched reference masks


def test_aug_config_test_pipeline_is_the_validation_pipeline():
    assert AUG_CONFIG["TEST"] is AUG_CONFIG["VALIDATION"]
    pipeline = PA.get_augmentations_from_config(AUG_CONFIG["TEST"])[0]
    assert [type(t).__name__ for t in pipeline.transforms] == [
        "Normalize", "StochasticLabelSwitches", "ToTensorV2"]
