"""The score CLI's path for an aleatoric-head ensemble: the function
``make_aleatoric_scorer`` builds, over batches copied from host memory,
its (10, B) scores copied back.

As ``inference/score.py::run_score`` calls it for a checkpoint with
``aleatoric_loss``: the members' state_dicts grouped and cast once to
the forward's type on the device, then per batch the float32 volumes and
the integer rater masks copied to the card, a batch seed, the grouped
forward with the ``final_aleatoric`` head (K1), ``aleatoric_samples``
logit samples a member drawn and accumulated by K3 from that seed (its
default Philox bits), C3, and the scores copied to the host. One caller,
closed loop; batches cycle through a pool made from the seed, and each
batch's seed is drawn from it.

Weights as ``scorer.py`` draws them, with each member's
``final_aleatoric`` head (2C outputs: mu, then the log-variance s) drawn
by the same rule: every weight normal with std sqrt(2 / (1 + 0.01^2) /
fan_in), every bias 0, so that mu has the scale of the logits and
sigma = exp(s / 2) lies around 1: the noise moves the samples' classes
without drowning the mean.

The output check takes a sample of the window's batches, drawn from the
seed, and scores them with the plain reference
(``reference/aleatoric.py``: every member's float32 forward, the samples
from the bits K3 draws for the batch's seed, the softmax, the statistics,
Dice and the three aggregations in float64), and compares the rows as
``scorer.py`` does, in units of the gap of the same reference with its
convolutions computed in bfloat16, on the same draws. The control: the
reference with its convolutions in float8 (e4m3).
"""
from __future__ import annotations

import math
import time
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from benchmark import counts, flops, inputs
from benchmark import reference
from benchmark.drivers import scorer
from benchmark.harness import Step, loop
from benchmark.reference import aleatoric as ref_alea
from benchmark.reference import unet3d as ref_unet3d

HEAD = "final_aleatoric"
SEEDS = 2 ** 31 - 1          # batch seeds as run_score draws them


def aleatoric_heads(states, model: Dict, gen, device) -> None:
    """Add each member's ``final_aleatoric`` head (2C x f 1x1x1 convs)
    to its state_dict, from one draw."""
    f, c = model["initial_filter_size"], model["num_classes"]
    gain = math.sqrt(2.0 / (1.0 + inputs.LEAKY_SLOPE ** 2)) / math.sqrt(f)
    kernels = torch.randn((len(states), 2 * c, f, 1, 1, 1), generator=gen,
                          device=device) * gain
    for state, kernel in zip(states, kernels):
        state[f"{HEAD}.weight"] = kernel
        state[f"{HEAD}.bias"] = torch.zeros(2 * c, device=device)


def setup(ctx) -> SimpleNamespace:
    from values_tpu_torch.inference.scoring import make_aleatoric_scorer
    from values_tpu_torch.models.ensemble_unet3d import cast_weights
    from values_tpu_torch.models.torch_import import group_member_state_dicts
    model, sc, trf = ctx.config["model"], ctx.config["scoring"], ctx.traffic
    dev = ctx.device
    gen = inputs.generator(ctx.seed, dev)
    states = inputs.unet3d_states(model, sc["members"], gen, dev)
    aleatoric_heads(states, model, gen, dev)
    batch, patch = trf["batch"], ctx.config["data"]["patch_size"]
    vols, masks = inputs.volume_pool(gen, trf["pool_batches"] * batch, patch,
                                     ctx.config["data"]["num_raters"],
                                     ctx.config["data"]["foreground"], dev)
    st = SimpleNamespace(ctx=ctx, states=states, vols=vols, masks=masks,
                         batch=batch, patch=patch, outputs=[], steps=0,
                         seeds=np.random.default_rng([int(ctx.seed), 1]))
    if not ctx.control:
        dtype = scorer.DTYPES[sc["dtype"]]
        st.weights = cast_weights(group_member_state_dicts(states), dtype,
                                  dev)
        st.score, _ = make_aleatoric_scorer(
            sc["members"], patch, n_aleatoric_samples=trf["aleatoric_samples"],
            agg_patch=sc["agg_patch"], threshold=sc["threshold"],
            ignore_index=sc["ignore_index"], dtype=dtype, device=dev)
        window(st, lambda n, _: n >= trf["warmup_batches"])
        st.outputs.clear()
    return st


def window(st, stop):
    dev = st.ctx.device

    def step(i: int) -> Step:
        t0 = time.perf_counter()
        j = st.steps % (st.vols.shape[0] // st.batch)
        rows = slice(j * st.batch, (j + 1) * st.batch)
        seed = int(st.seeds.integers(0, SEEDS))
        if st.ctx.control:     # the check computes the control's scores
            out = None
        else:
            out = st.score(st.weights, st.vols[rows].to(dev),
                           st.masks[rows].to(dev), seed).cpu().numpy()
        st.outputs.append((j, seed, out))
        st.steps += 1
        return Step(t0, time.perf_counter(), st.batch,
                    0 if out is None
                    else int((~np.isfinite(out)).any(axis=0).sum()))

    return loop(step, stop)


def work(st) -> Dict:
    m, sc = st.ctx.config["model"], st.ctx.config["scoring"]
    n = st.batch * st.patch ** 3
    return {"flops_per_unit": flops.unet3d_flops(
                st.patch, m["initial_filter_size"], m["in_channels"],
                2 * m["num_classes"], sc["members"]),
            "peak_flops": flops.PEAK_FLOPS[sc["dtype"]],
            "k3_least_s_per_step": counts.k3_least_seconds(
                n, sc["members"], m["num_classes"],
                st.ctx.traffic["aleatoric_samples"])}


def reference_scores(st, j: int, seed: int, quantizers):
    """The plain reference's (10, B) float64 scores of pool batch j for
    each of ``quantizers`` (None: float32 convolutions), all on the draws
    of ``seed``."""
    sc, trf = st.ctx.config["scoring"], st.ctx.traffic
    dev = st.ctx.device
    rows = slice(j * st.batch, (j + 1) * st.batch)
    x = st.vols[rows].to(dev).permute(0, 4, 1, 2, 3)
    block = trf["reference_block"]
    variants = []
    with torch.no_grad():
        for quantize in quantizers:
            mus, ss = [], []
            for sd in st.states:
                parts = [ref_alea.heads(sd, x[k:k + block], quantize)
                         for k in range(0, x.shape[0], block)]
                for out, t in zip((mus, ss), zip(*parts)):
                    # (B, C, D, H, W) -> (N, C), voxels in NDHWC order
                    out.append(torch.cat(t).movedim(1, -1)
                               .reshape(-1, t[0].shape[1]).double())
            variants.append((torch.stack(mus), torch.stack(ss)))
        stats = ref_alea.sampled_statistics(variants, seed,
                                            trf["aleatoric_samples"])
        raters = st.masks[rows].to(dev)
        return [ref_alea.volume_scores(
            s, raters, agg_patch=sc["agg_patch"], threshold=sc["threshold"],
            ignore_index=sc["ignore_index"]) for s in stats]


def check(st) -> Dict[str, float]:
    trf = st.ctx.traffic
    st.__dict__.pop("weights", None)
    st.__dict__.pop("score", None)
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    pick = inputs.rng(st.ctx.seed).choice(
        len(st.outputs), size=min(trf["check_batches"], len(st.outputs)),
        replace=False)
    quantizers = [None, ref_unet3d.bf16_round]
    if st.ctx.control:
        quantizers.append(ref_unet3d.fp8_quantize)
    got, want, rounded = [], [], []
    with reference.exact():
        for i in sorted(pick):
            j, seed, out = st.outputs[i]
            scores = [s.cpu().numpy()
                      for s in reference_scores(st, j, seed, quantizers)]
            want.append(scores[0])
            rounded.append(scores[1])
            got.append(scores[2] if st.ctx.control else out)
    return scorer.compare(*(np.concatenate(x, axis=1)
                            for x in (got, want, rounded)), log=st.ctx.log)
