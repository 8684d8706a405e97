"""``Tester2D.process_output``'s batch-wide pass on the CPU, held against
the per-image computation it replaced (kept here as the reference): the
JAX tester's zero "extra class" channel, then for each image the mean
Dice over the raters, the GED, the uncertainty maps and the colour maps,
each read back on its own.

Compared: ``results_dict`` exactly (float64 from integer counts), the
arrays handed to the two file writers (paths and order, shapes and
types, colour maps equal, uncertainty maps within 1e-6 of float32 and
1e-12 of float64 stacks), over S = 1 and S > 1, SSN or not, one rater
or three, masks with no ignored pixel and masks with some and with all
ignored, and stacks that are not contiguous. Also: a kept writer's
arrays survive later batches, and two of ``benchmark/faults.py``'s
faults still change the tester's output."""
import os

import numpy as np
import pytest
import torch

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu_torch.core import tracing
from values_tpu_torch.data import cityscapes_labels as cs_labels
from values_tpu_torch.inference import test_2d
from values_tpu_torch.ops import metrics as ops_metrics
from values_tpu_torch.ops import uncertainty as ops_uncertainty

C, H, W, B = 5, 8, 12, 3
IGNORE = 255


class _Bare(test_2d.Tester2D):
    """Only what ``process_output`` and the writers read."""

    def __init__(self, save_dir):
        self.device = torch.device("cpu")
        self.ignore_index = IGNORE
        self.results_dict = {}
        self._colors = torch.from_numpy(test_2d._color_table())
        self.save_dir = str(save_dir)
        self.save_pred_dir = os.path.join(self.save_dir, "pred_seg")


def _per_image_reference(softmax, gt, image_ids, datasets, is_ssn):
    """The loop that ``process_output`` ran before: its results_dict and
    the (kind, path relative to the save dir, array) of each write."""
    s, b, c, h, w = softmax.shape
    softmax = torch.cat([softmax, softmax.new_zeros((s, b, 1, h, w))],
                        dim=2)
    gt = torch.from_numpy(gt)
    if gt.ndim == 3:
        gt = gt[:, None]
    ignore_index_map = gt == IGNORE
    gt = torch.where(ignore_index_map, torch.full_like(gt, c), gt)
    colors_table = torch.from_numpy(test_2d._color_table())
    results, writes = {}, []
    for i in range(b):
        image_preds = softmax[:, i]
        mean_softmax = torch.mean(image_preds, dim=0)
        metrics = test_2d.Tester2D.calculate_test_metrics(mean_softmax,
                                                          gt[i])
        metrics.update(ops_metrics.generalized_energy_distance(
            image_preds, gt[i], ignore_index=c, ged_only=True))
        results[image_ids[i]] = {"dataset": datasets[i], "metrics": {
            k: v.item() for k, v in metrics.items()}}
        if s > 1:
            unc = ops_uncertainty.uncertainty_measures(image_preds,
                                                       ssn=is_ssn)
        else:
            unc = ops_uncertainty.one_minus_msr(image_preds[0])
        multiple = s > 1
        stack = (torch.cat([mean_softmax[None], image_preds]) if multiple
                 else image_preds)
        labels = torch.argmax(stack, dim=1)
        labels[:, ignore_index_map[i][0]] = cs_labels.name2trainId[
            "unlabeled"]
        for k, color in enumerate(colors_table[labels].numpy()):
            idx = k if multiple else k + 1
            name = (f"{image_ids[i]}_mean" if idx == 0 and multiple
                    else f"{image_ids[i]}_{idx:02d}")
            writes.append(("png", os.path.join("pred_seg", f"{name}.png"),
                           color))
        for kind, m in unc.items():
            writes.append(("tif", os.path.join(kind, f"{image_ids[i]}.tif"),
                           m.to(torch.float32).numpy()))
    return results, writes


@pytest.fixture
def recorded(monkeypatch):
    """Stand-in writers that keep every array they are handed, as the
    benchmark's do."""
    writes = []
    monkeypatch.setattr(test_2d, "write_png_rgb",
                        lambda path, rgb: writes.append(("png", path, rgb)))
    monkeypatch.setattr(test_2d, "write_tiff_float32",
                        lambda path, v: writes.append(("tif", path, v)))
    return writes


def _inputs(seed, s, raters, ignored, dtype, b=B):
    """A softmax stack with some probabilities that round to 0 (the
    guarded 0 log 0) and few classes (labels that agree across
    predictions and raters), and its masks: ``ignored`` "none", or
    "mixed" (the first image partly ignored, the second not at all, the
    third wholly)."""
    g = torch.Generator().manual_seed(seed)
    scale = torch.where(torch.rand((s, b, 1, H, W), generator=g) < 0.3,
                        300.0, 1.0)
    logits = torch.randn((s, b, C, H, W), generator=g,
                         dtype=torch.float64) * scale
    softmax = torch.softmax(logits, dim=2).to(dtype)
    rs = np.random.RandomState(seed)
    gt = rs.randint(0, C, (b, raters, H, W)).astype(np.int64)
    if ignored == "mixed":
        gt[0, :, :3] = IGNORE
        gt[0, -1, 5, :4] = IGNORE  # a pixel only the last rater ignores
        if b > 2:
            gt[2] = IGNORE
    if raters == 1:
        gt = gt[:, 0]
    return softmax, gt


def _compare(tester, writes, want_results, want_writes, dtype):
    assert list(tester.results_dict) == list(want_results)
    assert tester.results_dict == want_results
    assert len(writes) == len(want_writes)
    for (kind, path, got), (want_kind, rel, want) in zip(writes,
                                                         want_writes):
        assert (kind, os.path.relpath(path, tester.save_dir)) == (
            want_kind, rel)
        assert got.shape == want.shape and got.dtype == want.dtype
        if kind == "png":
            np.testing.assert_array_equal(got, want)
        else:
            atol = 1e-12 if dtype == torch.float64 else 1e-6
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ignored", ["none", "mixed"])
@pytest.mark.parametrize("raters", [1, 3])
@pytest.mark.parametrize("is_ssn", [False, True])
@pytest.mark.parametrize("s", [1, 4])
def test_batch_pass_matches_the_per_image_loop(s, is_ssn, raters, ignored,
                                               dtype, recorded, tmp_path):
    softmax, gt = _inputs(s * 10 + raters, s, raters, ignored, dtype)
    ids = [f"img{i}" for i in range(B)]
    datasets = [f"set{i}" for i in range(B)]
    tester = _Bare(tmp_path)
    tester.process_output({"softmax_pred": softmax, "image_id": ids,
                           "gt": gt, "dataset": datasets}, is_ssn=is_ssn)
    want_results, want_writes = _per_image_reference(softmax, gt, ids,
                                                     datasets, is_ssn)
    _compare(tester, recorded, want_results, want_writes, dtype)
    if ignored == "mixed":  # a wholly ignored image: nothing agrees
        assert tester.results_dict["img2"]["metrics"]["dice"] == 0.0


@pytest.mark.parametrize("layout", ["half_batch", "channels_last"])
def test_a_non_contiguous_stack(layout, recorded, tmp_path):
    """``softmax_pred[:, :n]`` of a larger batch, as the half-batch fault
    hands it over; a stack of one channels-last prediction."""
    if layout == "half_batch":
        s, b = 3, 2 * B
    else:
        s, b = 1, B
    softmax, gt = _inputs(7, s, 3, "mixed", torch.float32, b=b)
    if layout == "half_batch":
        view = softmax[:, :B]
    else:
        view = softmax[0].contiguous(
            memory_format=torch.channels_last)[None]
    assert not view.is_contiguous()
    ids = [f"img{i}" for i in range(B)]
    tester = _Bare(tmp_path)
    tester.process_output({"softmax_pred": view, "image_id": ids,
                           "gt": gt[:B], "dataset": ["gta"] * B},
                          is_ssn=False)
    want = _per_image_reference(view, gt[:B], ids, ["gta"] * B, False)
    _compare(tester, recorded, *want, torch.float32)


def test_one_read_a_batch(recorded, tmp_path):
    """One blocking read a batch, of the packed colour maps, maps and
    metrics."""
    from torch.profiler import ProfilerActivity, profile
    tracing.reset()
    s = 3
    softmax, gt = _inputs(3, s, 1, "mixed", torch.float32)
    tester = _Bare(tmp_path)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for k in range(2):
                tester.process_output({
                    "softmax_pred": softmax,
                    "image_id": [f"{k}_{i}" for i in range(B)],
                    "gt": gt, "dataset": ["gta"] * B}, is_ssn=False)
        totals = tracing.totals()
    finally:
        tracing.reset()
    assert totals["readbacks"] == 2
    parts = [B * (s + 1) * H * W * 3, 3 * B * H * W * 4, B * 2 * 8]
    packed = 0
    for n in parts:
        packed = -(-packed // tracing.PACK_ALIGN) * tracing.PACK_ALIGN + n
    assert totals["d2h_bytes"] == 2 * packed


def test_kept_arrays_survive_later_batches(recorded, tmp_path):
    """A writer that keeps batch k's arrays still holds them, unchanged,
    after batches k + 1 and k + 2 have been read back."""
    tester = _Bare(tmp_path)
    snapshots = []
    for k in range(3):
        softmax, gt = _inputs(20 + k, 3, 1, "mixed", torch.float32)
        tester.process_output({
            "softmax_pred": softmax,
            "image_id": [f"{k}_{i}" for i in range(B)],
            "gt": gt, "dataset": ["gta"] * B}, is_ssn=False)
        if k == 0:
            snapshots = [(path, arr.copy()) for _, path, arr in recorded]
            first = len(recorded)
    assert len(recorded) == 3 * first
    for (path, want), (_, got_path, got) in zip(snapshots, recorded):
        assert got_path == path
        np.testing.assert_array_equal(got, want)


def _run(tester, softmax, gt, ids):
    tester.process_output({"softmax_pred": softmax, "image_id": ids,
                           "gt": gt, "dataset": ["gta"] * len(ids)},
                          is_ssn=False)


def test_the_benchmark_faults_still_plant(recorded, tmp_path):
    """``tester_altered`` swaps the aleatoric and epistemic maps;
    ``tester_half_batch`` leaves the second half of the images out."""
    from benchmark import faults
    softmax, gt = _inputs(11, 3, 1, "mixed", torch.float32, b=4)
    ids = [f"img{i}" for i in range(4)]

    def maps_of(writes):
        return {os.path.relpath(path, str(tmp_path)): arr
                for kind, path, arr in writes if kind == "tif"}

    clean = _Bare(tmp_path)
    _run(clean, softmax, gt, ids)
    clean_maps = maps_of(recorded)
    recorded.clear()
    altered = _Bare(tmp_path)
    with faults.tester_altered():
        _run(altered, softmax, gt, ids)
    swapped = maps_of(recorded)
    for i in ids:
        alea = os.path.join("aleatoric_uncertainty", f"{i}.tif")
        epi = os.path.join("epistemic_uncertainty", f"{i}.tif")
        np.testing.assert_array_equal(swapped[alea], clean_maps[epi])
        np.testing.assert_array_equal(swapped[epi], clean_maps[alea])
        assert not np.array_equal(swapped[alea], clean_maps[alea])
    assert altered.results_dict == clean.results_dict
    recorded.clear()
    half = _Bare(tmp_path)
    with faults.tester_half_batch():
        _run(half, softmax, gt, ids)
    assert set(half.results_dict) == set(ids[:2])
    assert {os.path.basename(p).split("_")[0].split(".")[0]
            for _, p, _ in recorded} == set(ids[:2])
