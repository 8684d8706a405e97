"""The score CLI's path: ``make_scorer``'s function over batches copied
from host memory, its (10, B) scores copied back.

As ``inference/score.py::run_score`` calls it: the members' state_dicts
grouped (``group_member_state_dicts``) and cast once to the forward's type
on the device (``cast_weights``), then per batch the float32 volumes and
the integer rater masks copied to the card and the scores to the host.
One caller, closed loop; batches cycle through a pool made from the seed.

The output check takes a sample of the window's batches, drawn from the
seed, and scores them with the plain reference: every member's plain
float32 forward, then the softmax, the statistics, Dice and the three
aggregations in float64. A row's gap is its absolute gap summed over the
sample over the reference row's summed magnitude. With random weights
that gap swings from seed to seed by an order of magnitude (how near the
members' predictions lie to each other sets how far rounding moves the
statistics), so each number is taken in units of the gap of the same
reference computed in bfloat16 (every conv's input, weight and output
rounded), on the same weights and inputs: the patch-level, image-level
and threshold rows of PE and EE (``stat_gap``), the patch-level and
image-level rows of MI (``mi_gap``) and the Dice row (``dice_gap``).
MI's threshold row, whose count jumps where a voxel crosses the
threshold, is logged beside them. The control: the
reference computed in float8 (e4m3), one step below the forward's
bfloat16, every conv's input, weight and output, the logits included,
rounded to it.
"""
from __future__ import annotations

import json
import time
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from benchmark import flops, inputs
from benchmark.harness import Step, loop
from benchmark import reference
from benchmark.reference import measures
from benchmark.reference import unet3d as ref_unet3d

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def setup(ctx) -> SimpleNamespace:
    from values_tpu_torch.inference.scoring import make_scorer
    from values_tpu_torch.models.ensemble_unet3d import cast_weights
    from values_tpu_torch.models.torch_import import group_member_state_dicts
    model, sc, trf = ctx.config["model"], ctx.config["scoring"], ctx.traffic
    dev = ctx.device
    gen = inputs.generator(ctx.seed, dev)
    states = inputs.unet3d_states(model, sc["members"], gen, dev)
    batch, patch = trf["batch"], ctx.config["data"]["patch_size"]
    vols, masks = inputs.volume_pool(gen, trf["pool_batches"] * batch, patch,
                                     ctx.config["data"]["num_raters"],
                                     ctx.config["data"]["foreground"], dev)
    st = SimpleNamespace(ctx=ctx, states=states, vols=vols, masks=masks,
                         batch=batch, patch=patch, outputs=[], steps=0)
    if not ctx.control:
        dtype = DTYPES[sc["dtype"]]
        st.weights = cast_weights(group_member_state_dicts(states), dtype,
                                  dev)
        st.score, _ = make_scorer(sc["members"], patch,
                                  agg_patch=sc["agg_patch"],
                                  threshold=sc["threshold"],
                                  ignore_index=sc["ignore_index"],
                                  dtype=dtype, device=dev)
        window(st, lambda n, _: n >= trf["warmup_batches"])
        st.outputs.clear()
    return st


def window(st, stop):
    dev = st.ctx.device

    def step(i: int) -> Step:
        t0 = time.perf_counter()
        j = st.steps % (st.vols.shape[0] // st.batch)
        rows = slice(j * st.batch, (j + 1) * st.batch)
        if st.ctx.control:     # the check computes the control's scores
            out = None
        else:
            out = st.score(st.weights, st.vols[rows].to(dev),
                           st.masks[rows].to(dev)).cpu().numpy()
        st.outputs.append((j, out))
        st.steps += 1
        return Step(t0, time.perf_counter(), st.batch,
                    0 if out is None
                    else int((~np.isfinite(out)).any(axis=0).sum()))

    return loop(step, stop)


def work(st) -> Dict:
    m, sc = st.ctx.config["model"], st.ctx.config["scoring"]
    convs = flops.unet3d_convs(st.patch, m["initial_filter_size"],
                               m["in_channels"], sc["members"])
    return {"flops_per_unit": flops.unet3d_flops(
                st.patch, m["initial_filter_size"], m["in_channels"],
                m["num_classes"], sc["members"]),
            "peak_flops": flops.PEAK_FLOPS[sc["dtype"]],
            "k1_least_s_per_step": flops.k1_least_seconds(
                convs, st.batch, sc["dtype"])}


def reference_scores(st, j: int, quantize=None) -> torch.Tensor:
    """The plain reference's (10, B) float64 scores of pool batch j."""
    sc, trf = st.ctx.config["scoring"], st.ctx.traffic
    dev = st.ctx.device
    rows = slice(j * st.batch, (j + 1) * st.batch)
    x = st.vols[rows].to(dev).permute(0, 4, 1, 2, 3)
    block = trf["reference_block"]
    probs = []
    with torch.no_grad():
        for sd in st.states:
            logits = torch.cat([ref_unet3d.forward(sd, x[k:k + block],
                                                   quantize)
                                for k in range(0, x.shape[0], block)])
            probs.append(torch.softmax(logits.double(), dim=1))
        return measures.volume_scores(
            torch.stack(probs), st.masks[rows].to(dev),
            agg_patch=sc["agg_patch"], threshold=sc["threshold"],
            ignore_index=sc["ignore_index"])


# score_rows() order: dice, then (patch, image, threshold) of PE, EE, MI
ROWS = ["dice"] + [f"{u}/{a}" for u in ("pe", "ee", "mi")
                   for a in ("patch", "image", "threshold")]
# the rows compared, by number. MI's threshold mean is only logged: few
# voxels of MI reach the threshold, so the count behind it jumps, and in
# some samples no voxel does and the bfloat16 reference's gap, the unit,
# is 0
NUMBERS = {"stat_gap": [f"{u}/{a}" for u in ("pe", "ee")
                        for a in ("patch", "image", "threshold")],
           "mi_gap": ["mi/patch", "mi/image"],
           "dice_gap": ["dice"]}


def row_gaps(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """Each row's absolute gap summed over the sample, over the reference
    row's summed magnitude (the summed gap where that row is all 0)."""
    out = {}
    for r, name in enumerate(ROWS):
        gap = float(np.abs(got[r] - want[r]).sum())
        scale = float(np.abs(want[r]).sum())
        out[name] = gap / scale if scale > 0 else gap
    return out


def compare(got: np.ndarray, want: np.ndarray, rounded: np.ndarray,
            log=None) -> Dict[str, float]:
    """(10, V) scores against the float32 reference's ``want``, in units of
    the gap that the reference computed in bfloat16 (``rounded``) makes:
    for each number, its rows' gaps summed over the same sum of the
    bfloat16 reference's gaps."""
    gaps, unit = row_gaps(got, want), row_gaps(rounded, want)
    if log is not None:
        log("row gaps: " + json.dumps(gaps))
        log("bfloat16 reference's row gaps: " + json.dumps(unit))
    return {number: sum(gaps[r] for r in rows) / sum(unit[r] for r in rows)
            for number, rows in NUMBERS.items()}


def check(st) -> Dict[str, float]:
    trf = st.ctx.traffic
    st.__dict__.pop("weights", None)
    st.__dict__.pop("score", None)
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    pick = inputs.rng(st.ctx.seed).choice(
        len(st.outputs), size=min(trf["check_batches"], len(st.outputs)),
        replace=False)
    got, want, rounded = [], [], []
    with reference.exact():
        for i in sorted(pick):
            j, out = st.outputs[i]
            want.append(reference_scores(st, j).cpu().numpy())
            rounded.append(reference_scores(st, j, ref_unet3d.bf16_round)
                           .cpu().numpy())
            if st.ctx.control:
                out = reference_scores(st, j, ref_unet3d.fp8_quantize) \
                    .cpu().numpy()
            got.append(out)
    return compare(*(np.concatenate(x, axis=1) for x in (got, want, rounded)),
                   log=st.ctx.log)
