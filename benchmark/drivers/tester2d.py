"""The 2D test bed's path: ``Tester2D.predict_cases`` over an ensemble of
HRNets, each batch's per-image metrics and maps brought to host memory.

A subclass replaces only ``__init__`` (no checkpoint or dataset loading:
the members' state_dicts are made from the seed and go through the
tester's own ``_load_model``; the batches come from a pool in host
memory). The writers are the tester's own; only the two file writers
they call, ``write_png_rgb`` and ``write_tiff_float32``, are replaced by
stand-ins that encode and write nothing and keep the sampled images'
label maps and uncertainty maps for the check. Everything else is the
tester's: ``_to_device``, each member's ``_forward``, ``process_output``
(mean softmax, Dice, GED, the uncertainty measures), ``save_prediction``
(the argmax label maps of the mean and of each member, the ignored
pixels set to unlabeled, coloured) and ``save_uncertainty``.

The output check keeps a reservoir of the window's batches, drawn from
the seed, and computes them again with the plain reference: every
member's plain float32 forward, then the softmax and the measures in
float64. Every image of the sample has to have come. Compared:

- ``pe_gap``, ``ee_gap``: the predictive and expected entropy maps, each
  by its mean absolute gap over its mean magnitude;
- ``label_gap``: the widest gap by which a written label's reference
  probability lies below the reference's best at that pixel, over the
  mean's and every member's label map (infinite where a colour is no
  class's, or where the unlabeled colour is not exactly on the ignored
  pixels);
- ``dice_gap``, ``ged_gap``: the widest gap of the tester's per-image
  Dice and GED from the reference's, computed from the tester's written
  label maps: exact comparisons. Where the mask is ignored the tester
  writes no label: the mean's label there does not change its Dice, and
  the members' labels there enter the GED's distance between the
  members, so the GED is held to the range that any labels there give
  (its gap is how far it lies outside).

The MI map's gap is logged beside them. The control: the tester's own
bfloat16 path, one step below float32 under TF32.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from benchmark import inputs
from benchmark.harness import Step, Window
from benchmark import reference
from benchmark.reference import hrnet as ref_hrnet
from benchmark.reference import measures

MAPS = ("pred_entropy", "aleatoric_uncertainty", "epistemic_uncertainty")
MEASURES = dict(zip(MAPS, measures.MAPS))
SHORT = dict(zip(MAPS, ("pe", "ee", "mi")))
NUMBERS = ("pe_gap", "ee_gap", "mi_gap", "label_gap", "dice_gap", "ged_gap")
# float64 rounding of a distance between label maps, on either side
ROUNDING = 1e-12


def _tester_class():
    from values_tpu_torch.inference.test_2d import Tester2D, _color_table

    class BenchTester(Tester2D):
        def __init__(self, ctx, states, hparams, save_dir):
            dtype = torch.bfloat16 if ctx.control else torch.float32
            self.device = ctx.device
            self.hparams = hparams
            self.ignore_index = hparams["datamodule"]["ignore_index"]
            self.tta, self.n_pred, self.test_split = False, 1, "id"
            self.test_dataloader = []
            self.dtype = dtype
            self.models = [self._load_model(
                hparams, {k: v.clone() for k, v in s.items()})
                for s in states]
            self.is_ssn = False
            self.results_dict = {}
            self.generator = torch.Generator(self.device).manual_seed(
                int(hparams["seed"]))
            self.sliding_window, self.sliding_overlap = None, 0.0
            self._sliding = {}
            self._colors = torch.from_numpy(_color_table()).to(self.device)
            self.write_seconds = 0.0
            self.save_dir = save_dir
            self.save_pred_dir = os.path.join(save_dir, "pred_seg")
            os.makedirs(self.save_pred_dir, exist_ok=True)
            self.kept = None          # the current batch's reservoir slot

    return BenchTester


def _install_writers(st) -> None:
    """The tester's file writers replaced by stand-ins that keep the
    reservoir's label maps (by image id, then ``mean`` or the member's
    number) and uncertainty maps (by image id, then the map's name)."""
    from values_tpu_torch.inference import test_2d

    def png(path, rgb):
        slot = st.tester.kept
        if slot is not None:
            image_id, which = os.path.basename(path)[:-4].rsplit("_", 1)
            slot["labels"].setdefault(image_id, {})[which] = rgb

    def tif(path, values):
        slot = st.tester.kept
        if slot is not None:
            image_id = os.path.basename(path)[:-4]
            kind = os.path.basename(os.path.dirname(path))
            slot["maps"].setdefault(image_id, {})[kind] = values

    test_2d.write_png_rgb, test_2d.write_tiff_float32 = png, tif


def setup(ctx) -> SimpleNamespace:
    cfg, trf, dev = ctx.config, ctx.traffic, ctx.device
    data, testing = cfg["data"], cfg["testing"]
    gen = inputs.generator(ctx.seed, dev)
    h, w, batch = data["height"], data["width"], trf["batch"]
    calib = torch.randn((trf["calibration_images"], 3, h, w), generator=gen,
                        device=dev)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        states, flops = inputs.hrnet_states(cfg["model"]["cfg"],
                                            testing["members"], calib, gen)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    images, masks = inputs.image_pool(gen, trf["pool_batches"] * batch, h, w,
                                      data["label_classes"],
                                      data["ignore_index"], dev)
    hparams = {"model": cfg["model"], "seed": testing["seed"],
               "datamodule": {"ignore_index": data["ignore_index"]}}
    save_dir = tempfile.mkdtemp(prefix="bench-test2d-")
    st = SimpleNamespace(ctx=ctx, states=states, images=images, masks=masks,
                         batch=batch, flops_per_image=flops,
                         reservoir=[], seen=0, steps=0, save_dir=save_dir,
                         rng=inputs.rng(ctx.seed))
    st.tester = _tester_class()(ctx, states, hparams, save_dir)
    _install_writers(st)
    window(st, lambda n, _: n >= trf["warmup_batches"])
    st.reservoir, st.seen = [], 0
    return st


def _batch(st, j: int, step: int) -> Dict:
    rows = slice(j * st.batch, (j + 1) * st.batch)
    return {"data": st.images[rows], "seg": st.masks[rows],
            "image_id": [f"{step:06d}_{k}" for k in range(st.batch)],
            "dataset": ["gta"] * st.batch}


def window(st, stop) -> Window:
    """Runs ``predict_cases`` over a stream of pool batches that ends when
    ``stop`` says so; a batch's time runs from its hand-over to the
    tester to the tester's request for the next."""
    steps = []
    n_pool = st.images.shape[0] // st.batch
    cap = st.ctx.traffic["check_batches"]
    start = time.perf_counter()

    def stream():
        while not stop(len(steps), start):
            j = st.steps % n_pool
            batch = _batch(st, j, st.steps)
            st.tester.kept = _reserve(st, j, batch["image_id"], cap)
            t0 = time.perf_counter()
            yield batch
            steps.append((t0, time.perf_counter(), batch["image_id"]))
            st.steps += 1

    st.tester.test_dataloader = stream()
    st.tester.predict_cases()
    results = st.tester.results_dict
    out = [Step(t0, t1, len(ids),
                sum(1 for i in ids if i not in results or not all(
                    np.isfinite(v) for v in
                    results[i]["metrics"].values())))
           for t0, t1, ids in steps]
    end = steps[-1][1] if steps else time.perf_counter()
    return Window(start, end, out)


def _reserve(st, j: int, ids, cap: int):
    """Reservoir sampling of ``cap`` batches, drawn from the seed: the
    slot this batch fills, or None."""
    slot = {"pool": j, "ids": ids, "labels": {}, "maps": {}}
    st.seen += 1
    if len(st.reservoir) < cap:
        st.reservoir.append(slot)
        return slot
    k = int(st.rng.integers(0, st.seen))
    if k < cap:
        st.reservoir[k] = slot
        return slot
    return None


def work(st) -> Dict:
    from benchmark.flops import PEAK_FLOPS
    return {"flops_per_unit": st.flops_per_image
            * st.ctx.config["testing"]["members"],
            "peak_flops": PEAK_FLOPS["tf32"]}


def reference_batch(st, j: int):
    """Pool batch j in the reference: (S, B, C, H, W) float64 member
    softmaxes and (B, H, W) masks with the ignored pixels set to C."""
    cfg, dev = st.ctx.config, st.ctx.device
    rows = slice(j * st.batch, (j + 1) * st.batch)
    x = torch.from_numpy(st.images[rows]).to(dev).permute(0, 3, 1, 2)
    probs = []
    for sd in st.states:
        with torch.device("meta"):
            net = ref_hrnet.HRNet(cfg["model"]["cfg"])
        net.load_state_dict(sd, assign=True)
        with torch.no_grad():
            probs.append(torch.softmax(net.eval()(x).double(), dim=1))
    probs = torch.stack(probs)
    gt = torch.from_numpy(st.masks[rows]).to(dev)
    gt = torch.where(gt == cfg["data"]["ignore_index"],
                     torch.full_like(gt, probs.shape[2]), gt)
    return probs, gt


def label_table(colors: np.ndarray, unlabeled: int, device):
    """The sorted RGB codes of a (256, 3) colour table's classes, and the
    class of each; ``unlabeled``'s colour maps to -2."""
    codes = colors.astype(np.int64) @ np.array([1 << 16, 1 << 8, 1])
    keys = {int(codes[i]): i for i in reversed(range(len(codes)))}
    keys[int(codes[unlabeled])] = -2
    order = sorted(keys)
    return (torch.tensor(order, device=device),
            torch.tensor([keys[k] for k in order], device=device))


def labels_of(rgb: np.ndarray, table, classes: int) -> torch.Tensor:
    """(H, W, 3) written colours -> (H, W) classes: ``classes`` for the
    unlabeled colour, -1 for a colour that is no class's."""
    keys, ids = table
    c = torch.from_numpy(rgb.astype(np.int64)).to(keys.device)
    code = (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]
    pos = torch.searchsorted(keys, code).clamp(max=keys.numel() - 1)
    out = torch.where(keys[pos] == code, ids[pos], torch.full_like(code, -1))
    out = torch.where(out == -2, torch.full_like(out, classes), out)
    return torch.where(out <= classes, out, torch.full_like(out, -1))


def judge_image(probs: torch.Tensor, gt: torch.Tensor, written: Dict,
                table) -> Dict[str, float]:
    """One image: probs (S, C, H, W) float64, gt (H, W) with C where
    ignored, ``written`` its label maps by ``mean`` / member number.
    Returns the label gap, the reference's Dice of the written mean
    labels, and the least and largest GED that the written member labels
    allow; the gap is infinite where a label map is missing, holds a
    colour that is no class's, or is unlabeled elsewhere than on the
    ignored pixels."""
    s, c = probs.shape[:2]
    ignored = gt == c
    maps = {"mean": probs.mean(0),
            **{f"{k + 1:02d}": probs[k] for k in range(s)}}
    if set(written) != set(maps):
        return {"label_gap": float("inf")}
    labels, gap = {}, 0.0
    for which, p in maps.items():
        lab = labels_of(written[which], table, c)
        if bool(((lab == c) != ignored).any()) or bool((lab < 0).any()):
            return {"label_gap": float("inf")}
        keep = ~ignored
        if bool(keep.any()):
            chosen = p.gather(0, lab.clamp(max=c - 1)[None])[0]
            gap = max(gap, float((p.amax(0) - chosen)[keep].max()))
        labels[which] = lab
    # where the mask is ignored the tester writes no label: any class
    # gives the mean's Dice, and the members' labels there enter only
    # the GED's distance between the members, least where they all agree
    # and largest where they all differ
    dice = measures.dice_from_counts(measures.dice_counts(
        torch.where(ignored, 0, labels["mean"]), gt, c, (0, 1)))
    members = torch.stack([labels[f"{k + 1:02d}"] for k in range(s)])
    raters = gt[None].flatten(1)
    geds = [float(measures.ged_of_labels(
        torch.where(ignored, fill, members).flatten(1), raters, c))
        for fill in (torch.zeros((s, 1, 1), dtype=members.dtype,
                                 device=members.device),
                     torch.arange(s, device=members.device)[:, None, None])]
    return {"label_gap": gap, "dice": float(dice), "ged": sorted(geds)}


def check(st) -> Dict[str, float]:
    from values_tpu_torch.data import cityscapes_labels as cs_labels
    from values_tpu_torch.inference.test_2d import _color_table
    results = dict(st.tester.results_dict)
    del st.tester
    shutil.rmtree(st.save_dir, ignore_errors=True)
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    table = label_table(_color_table(), cs_labels.name2trainId["unlabeled"],
                        st.ctx.device)
    num = dict.fromkeys(MAPS, 0.0)
    den = dict.fromkeys(MAPS, 0.0)
    out = dict.fromkeys(("label_gap", "dice_gap", "ged_gap"), 0.0)
    with reference.exact():
        for slot in st.reservoir:
            probs, gt = reference_batch(st, slot["pool"])
            for k, image_id in enumerate(slot["ids"]):
                got = slot["maps"].get(image_id)
                judged = judge_image(probs[:, k], gt[k],
                                     slot["labels"].get(image_id, {}), table)
                if (got is None or image_id not in results
                        or not np.isfinite(judged["label_gap"])):
                    return dict.fromkeys(NUMBERS, float("inf"))
                stats = measures.sample_statistics(probs[:, k],
                                                   class_axis=1)
                for m in MAPS:
                    want = stats[MEASURES[m]].cpu().numpy()
                    num[m] += float(np.abs(got[m] - want).sum())
                    den[m] += float(np.abs(want).sum())
                metrics = results[image_id]["metrics"]
                out["label_gap"] = max(out["label_gap"], judged["label_gap"])
                out["dice_gap"] = max(out["dice_gap"], abs(
                    metrics["dice"] - judged["dice"]))
                lo, hi = judged["ged"]
                out["ged_gap"] = max(out["ged_gap"], lo - ROUNDING
                                     - metrics["ged"],
                                     metrics["ged"] - hi - ROUNDING)
    return dict({f"{SHORT[m]}_gap": num[m] / den[m] if den[m] > 0 else num[m]
                 for m in MAPS}, **out)
