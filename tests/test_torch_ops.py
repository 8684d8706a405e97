"""The port's C2 measures, Dice and C3 aggregations against their JAX
counterparts, in float64 (atol 1e-10)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from values_tpu.inference.scoring import _packed_mean_rater_dice
from values_tpu.ops import aggregation as jagg
from values_tpu.ops import metrics as jmet
from values_tpu.ops import uncertainty as junc
from values_tpu.ops.packed_stats import pack_labels
from values_tpu_torch.ops import aggregation as tagg
from values_tpu_torch.ops import metrics as tmet
from values_tpu_torch.ops import uncertainty as tunc

ATOL = 1e-10


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64(True):
        yield


def _softmax_stack(rs, s=4, c=3, spatial=(6, 5, 4), hard_frac=0.3):
    """(S, C, *spatial) float64 softmax with exact zeros at one-hot
    voxels."""
    logits = rs.randn(s, c, *spatial) * 2
    p = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    hard = rs.rand(*spatial) < hard_frac
    p[:, :, hard] = 0.0
    p[:, 1, hard] = 1.0
    return p


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=0)


# -- C2 -----------------------------------------------------------------------

def test_entropy_and_fused_statistics(rng):
    p = _softmax_stack(rng)
    _close(tunc.entropy(torch.from_numpy(p[0]), class_axis=0),
           junc.entropy(jnp.asarray(p[0]), class_axis=0))
    for axis, arr in ((1, p), (-1, np.moveaxis(p, 1, -1))):
        got = tunc.fused_sample_statistics(torch.from_numpy(arr), axis)
        want = junc.fused_sample_statistics(jnp.asarray(arr), axis)
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key])


@pytest.mark.parametrize("ssn", [False, True])
def test_uncertainty_measures_with_ssn_swap(rng, ssn):
    p = _softmax_stack(rng)
    got = tunc.uncertainty_measures(torch.from_numpy(p), ssn=ssn)
    want = junc.uncertainty_measures(jnp.asarray(p), ssn=ssn)
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])


# -- Dice ---------------------------------------------------------------------

@pytest.mark.parametrize("ignore_index", [None, 0, 2])
def test_dice_stats_and_score(rng, ignore_index):
    pred = rng.randint(0, 3, size=(4, 5, 6))
    tgt = rng.randint(0, 3, size=(4, 5, 6))
    got = tmet.dice_stats(torch.from_numpy(pred), torch.from_numpy(tgt),
                          ignore_index)
    want = jmet.dice_stats(jnp.asarray(pred), jnp.asarray(tgt),
                           ignore_index)
    for g, w in zip(got, want):
        assert int(g) == int(w)
    _close(tmet.dice_from_stats(*got), jmet.dice_from_stats(*want))


def test_dice_from_stats_zero_denominator():
    zero = torch.zeros(3, dtype=torch.long)
    assert torch.equal(tmet.dice_from_stats(zero, zero, zero),
                       torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("raters", [0, 3])
def test_mean_rater_dice_matches_packed_scorer(rng, raters):
    """Per-item micro Dice (ignore_index 0), or its mean over raters, as
    the JAX scorer computes it (scoring.py:94-107), in float32."""
    b, p = 8, 16
    bp = 128 // p
    seg = rng.randint(0, 2, size=(b, p, p, p))
    gt_shape = (b, raters, p, p, p) if raters else (b, p, p, p)
    gt = (rng.rand(*gt_shape) > 0.7).astype(np.int32)
    seg[1] = 0      # an item whose prediction is all background
    got = tmet.mean_rater_dice(torch.from_numpy(seg), torch.from_numpy(gt),
                               ignore_index=0)
    want = _packed_mean_rater_dice(pack_labels(jnp.asarray(seg), bp),
                                   jnp.asarray(gt), bp, 0)
    assert got.shape == (b,) and got.dtype == torch.float32
    # the JAX scorer divides and averages in float32: one f32 ulp of 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1.2e-7,
                               rtol=0)


# -- C3 -----------------------------------------------------------------------

def _maps(rng, b=3, shape=(12, 10, 11)):
    pe = rng.rand(b, *shape) * 0.7
    ee = pe * rng.rand(b, *shape)
    ee[1] = 0.0                         # no voxel passes any threshold
    pe[1] = 0.0
    return {"pred_entropy": pe, "expected_entropy": ee,
            "mutual_information": pe - ee}


def test_box_filter_and_single_aggregations(rng):
    unc = _maps(rng)["pred_entropy"]
    t, j = torch.from_numpy(unc), jnp.asarray(unc)
    for window in ((4, 3, 5), (1, 1, 1), (12, 10, 11)):
        _close(tagg.box_filter_sum(t, window, (1, 2, 3)),
               jagg.box_filter_sum(j, window, (1, 2, 3)))
    _close(tagg.patch_level_max(t, 4), jagg.patch_level_max(j, 4))
    _close(tagg.image_level_sum(t), jagg.image_level_sum(j))
    for thr in (0.3, 0.9):
        _close(tagg.threshold_mean(t, thr), jagg.threshold_mean(j, thr))


def test_threshold_mean_count_zero_falls_back_to_sum():
    unc = np.zeros((2, 4, 4, 4))
    unc[0, 0, 0, 0] = 0.1               # below the threshold: count 0
    got = tagg.threshold_mean(torch.from_numpy(unc), 0.3)
    want = jagg.threshold_mean(jnp.asarray(unc), 0.3)
    _close(got, want)
    _close(got, [0.0, 0.0])


@pytest.mark.parametrize("threshold", [0.3, (0.2, 0.3, 0.05)])
def test_aggregate_all_maps_per_map(rng, threshold):
    """Against JAX's per-map path (linear=False, fault R1)."""
    maps = _maps(rng)
    got = tagg.aggregate_all_maps({k: torch.from_numpy(v)
                                   for k, v in maps.items()},
                                  patch=4, threshold=threshold)
    want = jagg.aggregate_all_maps({k: jnp.asarray(v)
                                    for k, v in maps.items()},
                                   patch=4, threshold=threshold,
                                   linear=False)
    assert set(got) == set(want)
    for key in want:
        assert set(got[key]) == set(want[key])
        for agg in want[key]:
            _close(got[key][agg], want[key][agg])
    single = tagg.aggregate_all(torch.from_numpy(maps["pred_entropy"]),
                                patch=4, threshold=0.3)
    for agg, value in jagg.aggregate_all(jnp.asarray(maps["pred_entropy"]),
                                         patch=4, threshold=0.3).items():
        _close(single[agg], value)


def test_per_key_thresholds_reject_bad_length():
    maps = {k: torch.zeros(1, 4, 4, 4) for k in tagg.UNC_KEYS}
    with pytest.raises(ValueError):
        tagg.aggregate_all_maps(maps, patch=2, threshold=(0.1, 0.2))
