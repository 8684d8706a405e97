"""The 2D test bed's SSN path: ``Tester2D.predict_cases`` over one
HRNet-W48 with the Stochastic Segmentation Network head, ``n_pred``
samples of its low-rank normal a batch, each batch's per-image metrics
and maps brought to host memory.

It runs as ``tester2d.py`` runs the softmax ensemble, with that driver's
tester subclass, stand-in writers, window and reservoir; the tester takes
its SSN branch: ``_to_device``, the trunk and the two heads (span
``test2d.forward``), the degenerate check, the draws from the tester's
generator, the low-rank product and the softmax (span
``test2d.ssn_sample``), then ``process_output`` with the SSN's swap of
the aleatoric and epistemic maps, and the writers. The subclass also
keeps, for each batch of the reservoir, the state of the tester's
generator before the batch's draws.

Weights, from the seed: the trunk and ``last_layer`` as
``inputs.hrnet_states`` draws and calibrates them, then every BatchNorm
uncentred (running mean 0, running variance the calibration's second
moment): the trunk is then positively homogeneous, and an image of twice
the contrast gives about twice the logits, where the centred calibration
of a random HRNet-W48 gives some forty times (the shifts compound
through the unnormalized residual sums), and the diagonal D =
exp(logits) overflows. ``cov_factor_conv``'s convs are drawn from the
same family, its BatchNorm calibrated (as is) on a batch of images drawn
as the traffic's are. On those images, ``last_layer``'s classifier is
rescaled, each class's logits centred and all scaled to a root mean
square of ``LOGIT_RMS``, and the factor head's last conv scaled by one
gain so that the factor's per-logit variance, sum_r W^2, has the
geometric mean of D. The low-rank term and the diagonal then weigh alike
in each sample.

The output check recomputes the reservoir's batches with the plain
reference (``reference/hrnet_ssn.py``: float32 trunk and heads, the
samples in float64 from the tester's own normals, the softmax and maps in
float64). Every image of the sample has to have come. Compared:

- ``pe_gap``, ``alea_gap``, ``epi_gap``: the predictive entropy map and
  the aleatoric and epistemic maps as the tester writes them for an SSN
  (MI and EE), each by its mean absolute gap over its mean magnitude;
- ``label_mean_gap``: over the mean's label map and every sample's, the
  mean over the pixels outside the ignored mask of the gap by which the
  written label's reference probability lies below the reference's best
  there. Not the largest gap, as ``tester2d.py`` holds it: the diagonal
  is the exp of the logits, so where it is large a sample's logits carry
  noise of hundreds, a rounding of the logit moves that noise by whole
  units, and a few pixels flip outright under TF32 as under bfloat16;
- ``dice_gap``, ``ged_gap``: as ``tester2d.py`` judges them, from the
  written label maps, exactly.

Logged beside them: ``label_max_gap``, that largest gap; ``degenerate``,
the kept distributions whose capacitance's Cholesky fails (where it is
not 0, the tester drew from the fallback); and ``factor_to_diag_min``,
``_max``: the least and largest of the kept batches' ratio of the
geometric means of sum_r W^2 and D. The control: the
tester's trunk and heads in bfloat16, one step below float32 under TF32;
the tester refuses bfloat16 for the SSN, so the control hands the
distribution over in float32, and draws the same normals.
"""
from __future__ import annotations

import math
import shutil
import tempfile
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from benchmark import counts, inputs
from benchmark import reference
from benchmark.drivers import tester2d
from benchmark.flops import PEAK_FLOPS, conv2d_flops_hook
from benchmark.reference import hrnet_ssn

MAPS = ("pred_entropy", "aleatoric_uncertainty", "epistemic_uncertainty")
SHORT = dict(zip(MAPS, ("pe", "alea", "epi")))
NUMBERS = ("pe_gap", "alea_gap", "epi_gap", "label_mean_gap", "dice_gap",
           "ged_gap")
HEAD = "cov_factor_conv"
LOGIT_RMS = 2.0


def _float32_distribution(model) -> None:
    """The control's model hands its low-rank normal over in float32."""
    from values_tpu_torch.models.ssn_unet3d import LowRankMVN
    forward = model.forward

    def cast(*args, **kw):
        d = forward(*args, **kw)
        return LowRankMVN(d.mean.float(), d.cov_diag.float(),
                          d.cov_factor.float())
    model.forward = cast


def _tester_class():
    base = tester2d._tester_class()

    class SSNTester(base):
        def __init__(self, ctx, states, hparams, save_dir, n_pred):
            super().__init__(ctx, states, hparams, save_dir)
            self.is_ssn, self.n_pred = True, n_pred
            if ctx.control:
                for model in self.models:
                    _float32_distribution(model)

        def _to_device(self, images):
            # before a member's pass: the generator's state ahead of the
            # batch's first draws, for the reference
            if self.kept is not None and "generator" not in self.kept:
                self.kept["generator"] = self.generator.get_state()
            return super()._to_device(images)

    return SSNTester


def factor_to_diag(cov_diag: torch.Tensor, factor: torch.Tensor) -> float:
    """The geometric mean over the logits of the low-rank term's
    variance, sum_r W^2, over that of the diagonal D (geometric, since D
    is the exp of the logits and its arithmetic mean follows its
    largest values)."""
    return math.exp(float(factor.double().square().sum(-1).log().mean()
                          - cov_diag.double().log().mean()))


def ssn_state(cfg: Dict, calib: torch.Tensor, images: torch.Tensor, gen):
    """One SSN HRNet's state_dict and the forward FLOPs of one image of
    ``calib``'s shape (the trunk and both heads, counted from the convs'
    output shapes). The trunk's BatchNorms are calibrated on ``calib``;
    the factor head's BatchNorm, the mean head's scale and the factor
    head's gain on ``images``, drawn as the traffic's images are."""
    (state,), _ = inputs.hrnet_states(cfg, 1, calib, gen)
    # every BatchNorm uncentred: its second moment as its variance
    for key in [k for k in state if k.endswith("running_mean")]:
        var = key[:-len("running_mean")] + "running_var"
        state[var] = state[var] + state[key].square()
        state[key] = torch.zeros_like(state[key])
    dev = calib.device
    with torch.device("meta"):
        net = hrnet_ssn.HRNetSSN(cfg)
    head = getattr(net, HEAD)
    for k in (0, 3):
        conv = head[k]
        bound = 1 / math.sqrt(math.prod(conv.weight.shape[1:]))
        for leaf in ("weight", "bias"):
            shape = getattr(conv, leaf).shape
            state[f"{HEAD}.{k}.{leaf}"] = (torch.rand(
                shape, generator=gen, device=dev) * 2 - 1) * bound
    width = head[1].num_features
    state.update({f"{HEAD}.1.weight": torch.ones(width, device=dev),
                  f"{HEAD}.1.bias": torch.zeros(width, device=dev),
                  f"{HEAD}.1.running_mean": torch.zeros(width, device=dev),
                  f"{HEAD}.1.running_var": torch.ones(width, device=dev),
                  f"{HEAD}.1.num_batches_tracked": torch.zeros(
                      (), dtype=torch.long, device=dev)})
    net.load_state_dict(state, assign=True)
    net.eval()
    head[1].momentum = None         # the average over the calibration
    head[1].train()
    counter = {"flops": 0.0}
    hooks = [m.register_forward_hook(conv2d_flops_hook(counter))
             for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        net.distribution(images)
        for h in hooks:
            h.remove()
        # the mean head's classifier: each class's logits centred, and
        # all of them scaled to LOGIT_RMS, so that D = exp(logits) stays
        # of a trained head's order
        last = net.last_layer[3]
        mean, _, _ = net.eval().distribution(images)
        logits = mean.double().reshape(mean.shape[0], last.out_channels, -1)
        centre = logits.mean(dim=(0, 2))
        scale = LOGIT_RMS / float((logits - centre[:, None]).square()
                                  .mean().sqrt())
        last.weight.mul_(scale)
        last.bias.sub_(centre.to(last.bias.dtype)).mul_(scale)
        _, diag, factor = net.distribution(images)
        gain = math.sqrt(1.0 / factor_to_diag(diag, factor))
        head[3].weight.mul_(gain)
        head[3].bias.mul_(gain)
    state = {k: v.detach().clone() for k, v in net.state_dict().items()}
    return state, counter["flops"] / images.shape[0]


def setup(ctx) -> SimpleNamespace:
    cfg, trf, dev = ctx.config, ctx.traffic, ctx.device
    data, testing = cfg["data"], cfg["testing"]
    model_cfg = cfg["model"]["cfg"]
    gen = inputs.generator(ctx.seed, dev)
    h, w, batch = data["height"], data["width"], trf["batch"]
    calib = torch.randn((trf["calibration_images"], 3, h, w), generator=gen,
                        device=dev)
    head_calib = torch.from_numpy(inputs.image_pool(
        gen, trf["calibration_images"], h, w, data["label_classes"],
        data["ignore_index"], dev)[0]).to(dev).permute(0, 3, 1, 2)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        states, flops = [], 0.0
        for _ in range(testing["members"]):
            state, flops = ssn_state(model_cfg, calib, head_calib, gen)
            states.append(state)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    del calib, head_calib
    images, masks = inputs.image_pool(gen, trf["pool_batches"] * batch, h, w,
                                      data["label_classes"],
                                      data["ignore_index"], dev)
    hparams = {"model": cfg["model"], "seed": testing["seed"],
               "datamodule": {"ignore_index": data["ignore_index"]}}
    save_dir = tempfile.mkdtemp(prefix="bench-test2d-ssn-")
    st = SimpleNamespace(ctx=ctx, states=states, images=images, masks=masks,
                         batch=batch, flops_per_image=flops,
                         reservoir=[], seen=0, steps=0, save_dir=save_dir,
                         rng=inputs.rng(ctx.seed))
    st.tester = _tester_class()(ctx, states, hparams, save_dir,
                                testing["n_pred"])
    tester2d._install_writers(st)
    window(st, lambda n, _: n >= trf["warmup_batches"])
    st.reservoir, st.seen = [], 0
    return st


window = tester2d.window


def work(st) -> Dict:
    cfg, testing = st.ctx.config, st.ctx.config["testing"]
    model, data = cfg["model"]["cfg"], cfg["data"]
    least = counts.ssn_sample_least_seconds(
        st.batch, model["DATASET"]["NUM_CLASSES"], data["height"],
        data["width"], model["MODEL"]["SSN_RANK"], testing["n_pred"])
    return {"flops_per_unit": st.flops_per_image * testing["members"],
            "peak_flops": PEAK_FLOPS["tf32"],
            "ssn_sample_least_s_per_batch": least * testing["members"]}


def reference_batch(st, slot):
    """The kept batch in the reference: (S x members, B, C, H, W) float64
    softmax samples, (B, H, W) masks with the ignored pixels set to C,
    and the logged readings of its distributions."""
    cfg, dev = st.ctx.config, st.ctx.device
    model_cfg, n_pred = cfg["model"]["cfg"], cfg["testing"]["n_pred"]
    rows = slice(slot["pool"] * st.batch, (slot["pool"] + 1) * st.batch)
    x = torch.from_numpy(st.images[rows]).to(dev).permute(0, 3, 1, 2)
    b, _, h, w = x.shape
    dists = []
    for sd in st.states:
        with torch.device("meta"):
            net = hrnet_ssn.HRNetSSN(model_cfg)
        net.load_state_dict(sd, assign=True)
        with torch.no_grad():
            dists.append(net.eval().distribution(x))
    mean = dists[0][0]
    normals = hrnet_ssn.draw_normals(slot["generator"], len(dists), n_pred,
                                     b, net.rank, mean.shape[1], mean.dtype,
                                     dev)
    probs, degenerate, ratios = [], 0, []
    for (mean, cov_diag, factor), (eps_r, eps_d) in zip(dists, normals):
        degenerate += int(hrnet_ssn.degenerate(cov_diag, factor).sum())
        ratios.append(factor_to_diag(cov_diag, factor))
        for k in range(b):
            logits = hrnet_ssn.samples(mean[k:k + 1], cov_diag[k:k + 1],
                                       factor[k:k + 1], eps_r[:, k:k + 1],
                                       eps_d[:, k:k + 1])[:, 0]
            probs.append(torch.softmax(logits.reshape(n_pred, -1, h, w),
                                       dim=1))
    probs = torch.stack(probs).reshape(len(dists), b, n_pred, -1, h, w)
    probs = probs.transpose(1, 2).reshape(len(dists) * n_pred, b, -1, h, w)
    gt = torch.from_numpy(st.masks[rows]).to(dev)
    gt = torch.where(gt == cfg["data"]["ignore_index"],
                     torch.full_like(gt, probs.shape[2]), gt)
    return probs, gt, {"degenerate": degenerate, "factor_to_diag": ratios}


def label_gap_sum(probs: torch.Tensor, gt: torch.Tensor, written: Dict,
                  table):
    """One image, judged valid by ``tester2d.judge_image``: the sum over
    its label maps (the mean's and every sample's) and their pixels
    outside the ignored mask of the gap by which the written label's
    reference probability lies below the reference's best there, and
    the number of those pixels."""
    s, c = probs.shape[:2]
    keep = gt != c
    maps = {"mean": probs.mean(0),
            **{f"{k + 1:02d}": probs[k] for k in range(s)}}
    gap = 0.0
    for which, p in maps.items():
        lab = tester2d.labels_of(written[which], table, c).clamp(max=c - 1)
        chosen = p.gather(0, lab[None])[0]
        gap += float((p.amax(0) - chosen)[keep].sum())
    return gap, len(maps) * int(keep.sum())


def check(st) -> Dict[str, float]:
    from values_tpu_torch.data import cityscapes_labels as cs_labels
    from values_tpu_torch.inference.test_2d import _color_table
    results = dict(st.tester.results_dict)
    del st.tester
    shutil.rmtree(st.save_dir, ignore_errors=True)
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    table = tester2d.label_table(_color_table(),
                                 cs_labels.name2trainId["unlabeled"],
                                 st.ctx.device)
    num = dict.fromkeys(MAPS, 0.0)
    den = dict.fromkeys(MAPS, 0.0)
    out = dict.fromkeys(("dice_gap", "ged_gap"), 0.0)
    logged = {"degenerate": 0, "factor_to_diag": [], "label_max_gap": 0.0}
    label_gap, label_pixels = 0.0, 0
    failed = dict.fromkeys(NUMBERS, float("inf"))
    with reference.exact():
        for slot in st.reservoir:
            if "generator" not in slot:
                return failed
            probs, gt, read = reference_batch(st, slot)
            logged["degenerate"] += read["degenerate"]
            logged["factor_to_diag"] += read["factor_to_diag"]
            for k, image_id in enumerate(slot["ids"]):
                got = slot["maps"].get(image_id)
                judged = tester2d.judge_image(
                    probs[:, k], gt[k], slot["labels"].get(image_id, {}),
                    table)
                if (got is None or image_id not in results
                        or not np.isfinite(judged["label_gap"])):
                    return failed
                gap, pixels = label_gap_sum(probs[:, k], gt[k], slot[
                    "labels"][image_id], table)
                label_gap += gap
                label_pixels += pixels
                want = hrnet_ssn.uncertainty_maps(probs[:, k])
                for m in MAPS:
                    ref = want[m].cpu().numpy()
                    num[m] += float(np.abs(got[m] - ref).sum())
                    den[m] += float(np.abs(ref).sum())
                metrics = results[image_id]["metrics"]
                logged["label_max_gap"] = max(logged["label_max_gap"],
                                              judged["label_gap"])
                out["dice_gap"] = max(out["dice_gap"], abs(
                    metrics["dice"] - judged["dice"]))
                lo, hi = judged["ged"]
                out["ged_gap"] = max(out["ged_gap"],
                                     lo - tester2d.ROUNDING - metrics["ged"],
                                     metrics["ged"] - hi - tester2d.ROUNDING)
    ratios = logged["factor_to_diag"]
    return dict({f"{SHORT[m]}_gap": num[m] / den[m] if den[m] > 0 else num[m]
                 for m in MAPS},
                label_mean_gap=label_gap / max(1, label_pixels), **out,
                label_max_gap=logged["label_max_gap"],
                degenerate=logged["degenerate"],
                factor_to_diag_min=min(ratios, default=math.nan),
                factor_to_diag_max=max(ratios, default=math.nan))
