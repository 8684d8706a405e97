"""The port's 2D tester (``python -m values_tpu_torch.inference.test_2d``,
``--device cpu``) against the JAX package's (``values_tpu.inference.
test_2d``) on the same checkpoints and the same tiny GTA/Cityscapes tree
(tests/test_2d_path.py::make_gta_tree): the same result tree, file for
file, for every C1 family.

Limits: ``metrics.json`` within 1e-6; PNGs (decoded with cv2) equal; TIFs
within 1e-6 of log 25, the largest entropy over 25 channels: PE and EE
(up to 3.2) differ in their last float32 ulps with the order of the class
sum, and MI = PE - EE inherits those ulps however small MI is.
Float64 runs agree within 1e-10 (metrics) and one float32 rounding (TIFs).
The stochastic families replay the JAX tester's draws (R2): its four
DROPOUT_FINAL keep masks per pass (flax's ``nn.Dropout`` recorded) through
``values_tpu_torch.models.hrnet.dropout_final``, and the SSN normals of
each batch's key through ``ssn_unet3d.draw_ssn_normals``, so they are held
to the deterministic limits; the port's own draws are checked for range.
"""
import collections
import json
import math

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_2d_path import H, NUM_CLASSES, W, _hrnet_hparams, make_gta_tree
from tests.test_hrnet import small_cfg
from test_torch_unet3d import flax_init
from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.inference import test_2d as J
from values_tpu.models.hrnet import HighResolutionNet as JaxHRNet
from values_tpu.training.checkpoint import save_checkpoint
from values_tpu_torch.inference import test_2d as P
from values_tpu_torch.models import hrnet as PH
from values_tpu_torch.models import ssn_unet3d as PS

GOLDEN = __import__("pathlib").Path(__file__).parent / "golden" / \
    "gta_2d.json"


def _checkpoint(work, gta, name, **cfg_kw):
    """An HRNet saved by the JAX package: the plain model with the golden
    test's init (flax's own draw, the program tests/test_golden_2d.py
    compiles), the others drawn by ``flax_init``, which compiles
    nothing."""
    cfg = small_cfg(num_classes=NUM_CLASSES, **cfg_kw)
    hp = _hrnet_hparams(gta, work)
    hp["model"]["cfg"] = cfg
    hp["MODEL"] = cfg["MODEL"]
    model = JaxHRNet(cfg=cfg)
    x = jnp.zeros((1, H, W, 3))
    if name == "plain":
        v = jax.jit(model.init)(jax.random.PRNGKey(0), x)
    else:
        v = flax_init(model, {"member": 1, "dropout": 2, "ssn": 3}[name], x)
    path = work / f"{name}.ckpt"
    save_checkpoint(str(path), v, hp)
    return str(path)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    work = tmp_path_factory.mktemp("t2d")
    gta = make_gta_tree(work / "GTA")
    ckpts = {"plain": _checkpoint(work, gta, "plain"),
             "member": _checkpoint(work, gta, "member"),
             "dropout": _checkpoint(work, gta, "dropout", dropout_final=True),
             "ssn": _checkpoint(work, gta, "ssn", ssn=True)}
    return work, ckpts


def _result_dir(root, split, exp="Softmax-GTA"):
    return root / exp / "test_results" / "0" / split


def _read(base):
    out = {"metrics.json": json.loads((base / "metrics.json").read_text())}
    for f in sorted(base.rglob("*")):
        if f.suffix in (".png", ".tif"):
            out[str(f.relative_to(base))] = cv2.imread(
                str(f), cv2.IMREAD_UNCHANGED)
    return out


def _compare(got, want, metric_atol=1e-6, map_atol=1e-6 * math.log(25)):
    assert sorted(got) == sorted(want)
    gm, wm = got["metrics.json"], want["metrics.json"]
    assert sorted(gm) == sorted(wm)
    for image in wm:
        assert gm[image].get("dataset") == wm[image].get("dataset")
        assert sorted(gm[image]["metrics"]) == sorted(wm[image]["metrics"])
        for k, v in wm[image]["metrics"].items():
            assert gm[image]["metrics"][k] == pytest.approx(
                v, abs=metric_atol), (image, k)
    for name, w in want.items():
        if name == "metrics.json":
            continue
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.endswith(".png"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=map_atol,
                                       err_msg=name)


class _JaxDropoutMasks:
    """Record the keep masks flax's ``nn.Dropout`` draws in the JAX
    tester's (eager) forwards, drawn as flax draws them."""

    def __init__(self):
        import flax.linen as nn
        self.nn, self.orig, self.masks = nn, nn.Dropout.__call__, []

    def __enter__(self):
        def call(module, inputs, deterministic=None, rng=None):
            if self.nn.merge_param("deterministic", module.deterministic,
                                   deterministic):
                return inputs
            keep = 1.0 - module.rate
            mask = jax.random.bernoulli(module.make_rng("dropout"), keep,
                                        inputs.shape)
            self.masks.append(torch.from_numpy(np.asarray(mask)).permute(
                0, 3, 1, 2))
            return jax.lax.select(mask, inputs / keep,
                                  jnp.zeros_like(inputs))
        self.nn.Dropout.__call__ = call
        return self

    def __exit__(self, *exc):
        self.nn.Dropout.__call__ = self.orig


def _ssn_normals(seed, batches, n, rank, dim):
    """The JAX tester's SSN normals: per batch ``rng, key = split(rng)``,
    then ``LowRankMVN.rsample``'s ``k1, k2 = split(key)``."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for b in batches:
        rng, key = jax.random.split(rng)
        k1, k2 = jax.random.split(key)
        out.append((torch.from_numpy(np.array(jax.random.normal(
            k1, (n, b, rank)))), torch.from_numpy(np.array(
                jax.random.normal(k2, (n, b, dim))))))
    return out


MODES = {
    # name: (checkpoints, split, extra flags)
    "softmax": (["plain"], "unlabeled", ["--test_batch_size", "2",
                                         "--n_reference_samples", "2"]),
    "ensemble": (["plain", "member"], "ood", ["--n_reference_samples", "3"]),
    "tta": (["plain"], "id", ["-tta", "--n_reference_samples", "2"]),
    "sliding": (["plain"], "id", ["--n_pred", "2", "--n_reference_samples",
                                  "2", "--sliding_window", "16", "24"]),
    "dropout": (["dropout"], "ood", ["--n_pred", "3",
                                     "--n_reference_samples", "2"]),
    "ssn": (["ssn"], "unlabeled", ["--n_pred", "3", "--test_batch_size",
                                   "2", "--n_reference_samples", "2"]),
}


def _run_both(tree, mode, monkeypatch, extra=()):
    work, ckpts = tree
    names, split, flags = MODES[mode]
    common = (["--checkpoint_paths"] + [ckpts[n] for n in names]
              + ["--test_split", split] + flags + list(extra))
    jdir, pdir = work / f"jax_{mode}", work / f"port_{mode}"
    if mode == "dropout":
        with _JaxDropoutMasks() as rec:
            J.run_test(J.test_cli(common + ["--save_dir", str(jdir)]))
        masks = collections.deque(rec.masks)

        def replayed(t, generator):
            keep = masks.popleft()
            assert keep.shape == t.shape
            return torch.where(keep, t / 0.5, torch.zeros_like(t))
        monkeypatch.setattr(PH, "dropout_final", replayed)
    else:
        J.run_test(J.test_cli(common + ["--save_dir", str(jdir)]))
    if mode == "ssn":
        draws = collections.deque(_ssn_normals(123, [2, 1], 3, 3,
                                               NUM_CLASSES * H * W))

        def replayed(generator, n, batch, rank, dim, dtype, device):
            eps_r, eps_d = draws.popleft()
            assert eps_r.shape == (n, batch, rank)
            assert eps_d.shape == (n, batch, dim)
            return eps_r.to(dtype), eps_d.to(dtype)
        monkeypatch.setattr(PS, "draw_ssn_normals", replayed)
    tester = P.main(common + ["--save_dir", str(pdir), "--device", "cpu"])
    if mode == "dropout":
        assert not masks  # every recorded mask was used, in order
    return (_read(_result_dir(pdir, split)), _read(_result_dir(jdir, split)),
            tester)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_matches_jax(tree, mode, monkeypatch):
    got, want, tester = _run_both(tree, mode, monkeypatch)
    _compare(got, want)
    n_images = len(want["metrics.json"]) - 1
    assert len(tester.results_dict) == n_images + 1
    if mode in ("softmax",):
        assert all(k.startswith("pred_seg/") or k.startswith("pred_entropy/")
                   or k == "metrics.json" for k in got)


def test_cli_bfloat16_against_jax_bfloat16(tree, monkeypatch):
    """--dtype bfloat16: bf16 compute, float32 softmax. The two packages
    round at different places (tests/test_torch_hrnet.py), so metrics are
    held within 0.05, the maps within 0.05 of log 25, and at most 2% of
    the PNG pixels may differ."""
    work, ckpts = tree
    common = ["--checkpoint_paths", ckpts["plain"], "--test_split", "id",
              "--n_pred", "2", "--n_reference_samples", "2", "--dtype",
              "bfloat16"]
    J.run_test(J.test_cli(common + ["--save_dir", str(work / "jax_bf16")]))
    P.main(common + ["--save_dir", str(work / "port_bf16"), "--device",
                     "cpu"])
    got = _read(_result_dir(work / "port_bf16", "id"))
    want = _read(_result_dir(work / "jax_bf16", "id"))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if name == "metrics.json":
            for image, entry in w.items():
                for k, v in entry["metrics"].items():
                    assert got[name][image]["metrics"][k] == pytest.approx(
                        v, abs=0.05)
        elif name.endswith(".png"):
            assert np.mean(np.any(got[name] != w, axis=-1)) <= 0.02, name
        else:
            np.testing.assert_allclose(got[name], w,
                                       atol=0.05 * math.log(25))


def test_cli_float64_against_jax_float64(tree):
    """--dtype float64 on float64 checkpoints (x64 set process-wide for the
    JAX tester): metrics within 1e-10, TIFs (float32 files) within one
    float32 rounding at log 25. The checkpoints hold float64 leaves because
    flax keeps a float32 running variance's rsqrt in float32 (BatchNorm's
    ``_normalize``), so the JAX tester's float64 mode on float32 weights
    is float64 only to float32's accuracy (ROADMAP.md R11)."""
    import pickle
    work, ckpts = tree
    paths = []
    for name in ("plain", "member"):
        with open(ckpts[name], "rb") as f:
            payload = pickle.load(f)
        payload["state_dict"] = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), payload["state_dict"])
        paths.append(str(work / f"{name}64.ckpt"))
        with open(paths[-1], "wb") as f:
            pickle.dump(payload, f)
    common = (["--checkpoint_paths"] + paths
              + ["--test_split", "ood", "--n_reference_samples", "3",
                 "--dtype", "float64"])
    jax.config.update("jax_enable_x64", True)
    try:
        J.run_test(J.test_cli(common + ["--save_dir", str(work / "jax64")]))
    finally:
        jax.config.update("jax_enable_x64", False)
    P.main(common + ["--save_dir", str(work / "port64"), "--device", "cpu"])
    _compare(_read(_result_dir(work / "port64", "ood")),
             _read(_result_dir(work / "jax64", "ood")), metric_atol=1e-10,
             map_atol=2.4e-7)


def test_cli_reproduces_the_golden_2d_run(tree):
    """tests/test_golden_2d.py's run through the port's CLI (the plain
    checkpoint is the one it writes, on the same tree; the same flags)
    reproduces tests/golden/gta_2d.json within that test's
    tolerances."""
    work, ckpts = tree
    P.main(["--checkpoint_paths", ckpts["plain"], "--test_split", "ood",
            "--n_pred", "2", "--n_reference_samples", "3", "--device", "cpu",
            "--save_dir", str(work / "golden")])
    base = _result_dir(work / "golden", "ood")
    metrics = json.loads((base / "metrics.json").read_text())
    image_id = [k for k in metrics if k != "mean"][0]
    pe = cv2.imread(str(base / "pred_entropy" / f"{image_id}.tif"),
                    cv2.IMREAD_UNCHANGED)
    au = cv2.imread(str(base / "aleatoric_uncertainty" / f"{image_id}.tif"),
                    cv2.IMREAD_UNCHANGED)
    got = {"mean": metrics["mean"]["metrics"],
           "image": metrics[image_id]["metrics"],
           "pred_entropy_sum": float(np.sum(pe)),
           "pred_entropy_max": float(np.max(pe)),
           "aleatoric_sum": float(np.sum(au))}
    want = json.loads(GOLDEN.read_text())
    assert sorted(got) == sorted(want)
    for key in ("mean", "image"):
        assert sorted(got[key]) == sorted(want[key])
        for k in want[key]:
            np.testing.assert_allclose(got[key][k], want[key][k], rtol=2e-4,
                                       atol=1e-6, err_msg=f"{key}.{k}")
    for key in ("pred_entropy_sum", "pred_entropy_max", "aleatoric_sum"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("mode", ["dropout", "ssn"])
def test_own_draws_are_in_range(tree, mode):
    """The port's own generator: finite maps, PE in [0, log 25], MI >=
    -1e-6, Dice in [0, 1]; the same command writes the same maps."""
    work, ckpts = tree
    _, split, flags = MODES[mode]
    common = (["--checkpoint_paths", ckpts[mode], "--test_split", split]
              + flags + ["--device", "cpu"])
    maps = []
    for run in range(2):
        P.main(common + ["--save_dir", str(work / f"own_{mode}{run}")])
        maps.append(_read(_result_dir(work / f"own_{mode}{run}", split)))
    for name, arr in maps[0].items():
        if name == "metrics.json":
            for entry in arr.values():
                assert 0 <= entry["metrics"]["dice"] <= 1
            continue
        np.testing.assert_array_equal(arr, maps[1][name])
        if name.endswith(".tif"):
            assert np.isfinite(arr).all()
            if name.startswith("pred_entropy/"):
                assert arr.min() >= 0 and arr.max() <= math.log(25) + 1e-6
            if name.startswith("epistemic_uncertainty/" if mode == "dropout"
                               else "aleatoric_uncertainty/"):
                assert arr.min() >= -1e-6  # MI


@pytest.mark.parametrize("case", ["bf16 ssn", "sliding ssn", "unet3d",
                                  "score hrnet", "test_3d sliding",
                                  "test_3d hrnet"])
def test_refusals(tree, case, tmp_path):
    """As the JAX tester: an SSN refuses bfloat16 and --sliding_window
    (ValueError). A UNet3D checkpoint in test_2d, an HRNet checkpoint in
    the score CLI or test_3d, and --sliding_window in test_3d raise
    ValueError naming the other tester, before any forward."""
    from values_tpu_torch.inference import score, test_3d
    work, ckpts = tree
    if case in ("bf16 ssn", "sliding ssn"):
        flag = (["--dtype", "bfloat16"] if case == "bf16 ssn"
                else ["--sliding_window", "16", "24"])
        with pytest.raises(ValueError, match="SSN"):
            P.main(["--checkpoint_paths", ckpts["ssn"], "--device", "cpu",
                    "--save_dir", str(tmp_path)] + flag)
    elif case == "unet3d":
        from values_tpu_torch.models.torch_import import \
            unet3d_params_from_torch
        from values_tpu_torch.models.unet3d import UNet3D
        from values_tpu_torch.training.checkpoint import \
            save_checkpoint as port_save
        path = tmp_path / "unet.ckpt"
        hp = _hrnet_hparams(work / "GTA", work)
        hp["model"] = {"_target_": "values_tpu.models.unet3d.UNet3D",
                       "num_classes": 2, "initial_filter_size": 2}
        port_save(str(path), unet3d_params_from_torch(
            UNet3D(2, initial_filter_size=2).state_dict()), hp)
        with pytest.raises(ValueError, match="test_3d"):
            P.main(["--checkpoint_paths", str(path), "--device", "cpu",
                    "--save_dir", str(tmp_path)])
    elif case == "score hrnet":
        args = score.score_cli(["--checkpoint_paths", ckpts["plain"],
                                "--out", str(tmp_path / "s.json"),
                                "--device", "cpu"])
        with pytest.raises(ValueError, match="test_2d"):
            score.run_score(args)
    else:
        extra = (["--sliding_window", "16", "16"]
                 if case == "test_3d sliding" else [])
        args = test_3d.test_cli(["--checkpoint_paths", ckpts["plain"],
                                 "--device", "cpu"] + extra)
        with pytest.raises(ValueError, match="test_2d"):
            test_3d.run_test(args)


def test_cli_needs_cuda_unless_cpu_is_asked_for(tree):
    work, ckpts = tree
    args = P.test_cli(["--checkpoint_paths", ckpts["plain"]])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.run_test(args)


def test_help_states_the_tf32_default():
    for text in (P.__doc__, __import__(
            "values_tpu_torch.training.main", fromlist=["x"]).__doc__,
            __import__("values_tpu_torch.inference.test_3d",
                       fromlist=["x"]).__doc__):
        assert "allow_tf32" in text
