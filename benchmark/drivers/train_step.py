"""The training step: ``Experiment.train_step`` of the configuration's
objective, each batch copied from host memory as ``fit`` hands it
(``training/loops.py::_device_batch``), each step ending on the host with
its loss.

Set-up builds one Experiment and one state from a state_dict made from
the seed (through the program's own ``unet3d_params_from_torch`` and
``state_from_variables``), and drives it through its first steps with
the window's own step on pool batches whose rows all differ; the window
then goes on with that same state. The output check holds two stages
against the reference:

- the start: the first three steps, from the seed's state_dict, on the
  same batches (the parameters before step 1, Adam's first moment after
  step 1, which is the first gradient as the optimizer got it, over
  1 - beta1, the parameters after step 3, and each step's loss);
- one step inside the measured window, drawn from the seed: just before
  it the window keeps the parameters and Adam's moments, and just after
  it the parameters, the first moment and the loss. The reference can
  only follow the program from the program's own state there: it takes
  that step once, from the kept parameters and moments, on the same
  batch.

Compared, for each stage: the loss by its gap over the reference's (the
worst of the three at the start); the gradient as Adam got it by the
worst leaf's gap of norms over the larger of that leaf's reference norm
and the median leaf's; the parameters' change likewise, leaving out the
leaves whose reference gradient is under a thousandth of the median
leaf's (a conv bias before an instance norm: Adam moves it by round-off
alone). The reference runs in plain float32. The control: the
Experiment's own bfloat16 precision.
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from benchmark import flops, inputs
from benchmark.harness import Step, loop
from benchmark import reference
from benchmark.reference import train as ref_train

CHECKED_STEPS = 3
# the state_dict keys of transposed convs, whose flax kernels are DHWIO
# of torch's (I, O, D, H, W) rather than of (O, I, D, H, W)
_TRANSPOSED = ("upscale", "center.4")
# flax-layout module -> reference state_dict prefix
_CENTER = {"center_conv1": "center.0", "center_conv2": "center.2",
           "center_up": "center.4"}


def _torch_key(path: List[str]) -> str:
    """A flax-layout leaf path -> the reference state_dict key."""
    module, leaf = path[0], path[-1]
    prefix = _CENTER.get(module, module)
    if len(path) == 3:                       # {"conv": {kernel, bias}}
        prefix += ".0"
    return f"{prefix}.{'weight' if leaf == 'kernel' else 'bias'}"


def _named_leaves(tree, path=()):
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _named_leaves(value, path + (key,))
        else:
            yield _torch_key(list(path + (key,))), value


def _torch_layout(key: str, leaf: torch.Tensor) -> torch.Tensor:
    """A flax-layout leaf in the reference state_dict's layout."""
    if leaf.ndim != 5:
        return leaf
    return leaf.permute((3, 4, 0, 1, 2) if key.startswith(_TRANSPOSED)
                        else (4, 3, 0, 1, 2))


def _kept(st, moment: str) -> Dict[str, torch.Tensor]:
    """Adam's ``moment`` of each leaf (zeros before its first step)."""
    opt = st.state.optimizer.state
    return {k: (opt[v][moment] if v in opt else torch.zeros_like(v))
            .detach().clone() for k, v in st.leaves.items()}


def setup(ctx) -> SimpleNamespace:
    from values_tpu_torch.config import make_config
    from values_tpu_torch.models.torch_import import unet3d_params_from_torch
    from values_tpu_torch.training.experiment import Experiment
    cfg, trf, dev = ctx.config, ctx.traffic, ctx.device
    tr, patch = cfg["training"], cfg["data"]["patch_size"]
    gen = inputs.generator(ctx.seed, dev)
    state_dict = inputs.unet3d_states(cfg["model"], 1, gen, dev)[0]
    batch = trf["batch"]
    vols, masks = inputs.volume_pool(gen, trf["pool_batches"] * batch, patch,
                                     1, cfg["data"]["foreground"], dev)
    exp = Experiment(make_config({
        "model": dict(cfg["model"]), "seed": tr["seed"],
        "learning_rate": tr["learning_rate"],
        "weight_decay": tr["weight_decay"],
        "precision": "bf16" if ctx.control else tr["precision"]}), dev)
    host = {k: v.cpu() for k, v in state_dict.items()}
    state = exp.state_from_variables(unet3d_params_from_torch(host))
    st = SimpleNamespace(ctx=ctx, exp=exp, state=state, reference=host,
                         data=vols.numpy(), seg=masks[:, 0].long().numpy(),
                         batch=batch, patch=patch, losses=[], steps=0,
                         generator=torch.Generator(dev).manual_seed(
                             int(tr["seed"])),
                         at=None, check_at=trf["warmup_steps"] + int(
                             inputs.rng(ctx.seed).integers(
                                 *trf["check_step"])))
    st.leaves = dict(_named_leaves(state.params))
    st.before = {k: v.detach().clone() for k, v in st.leaves.items()}
    window(st, lambda n, _: n >= 1)
    beta1 = state.optimizer.defaults["betas"][0]
    moments = state.optimizer.state
    st.first = {k: (moments[v]["exp_avg"] / (1 - beta1) if v in moments
                    else torch.zeros_like(v)).detach().clone()
                for k, v in st.leaves.items()}
    window(st, lambda n, _: n >= CHECKED_STEPS - 1)
    st.after = {k: v.detach().clone() for k, v in st.leaves.items()}
    window(st, lambda n, _: n >= trf["warmup_steps"] - CHECKED_STEPS)
    return st


def window(st, stop):
    dev = st.ctx.device
    n_pool = st.data.shape[0] // st.batch

    def step(i: int) -> Step:
        t0 = time.perf_counter()
        j = st.steps % n_pool
        rows = slice(j * st.batch, (j + 1) * st.batch)
        batch = {"data": torch.from_numpy(st.data[rows]).to(dev),
                 "seg": torch.from_numpy(st.seg[rows]).to(dev)}
        checked = st.steps == st.check_at
        if checked:
            opt = st.state.optimizer.state
            st.at = {"j": j, "m": _kept(st, "exp_avg"),
                     "v": _kept(st, "exp_avg_sq"),
                     "t": int(opt.get(next(iter(st.leaves.values())),
                                      {}).get("step", 0)),
                     "before": {k: v.detach().clone()
                                for k, v in st.leaves.items()}}
        st.state, loss = st.exp.train_step(st.state, batch, st.generator)
        value = float(loss)
        if checked:
            st.at.update(loss=value, m_after=_kept(st, "exp_avg"),
                         after={k: v.detach().clone()
                                for k, v in st.leaves.items()})
        if len(st.losses) < CHECKED_STEPS:
            st.losses.append(value)
        st.steps += 1
        return Step(t0, time.perf_counter(), st.batch,
                    0 if np.isfinite(value) else st.batch)

    return loop(step, stop)


def work(st) -> Dict:
    m = st.ctx.config["model"]
    convs = flops.unet3d_convs(st.patch, m["initial_filter_size"],
                               m["in_channels"], 1)
    return {"flops_per_unit": 3 * flops.unet3d_flops(
                st.patch, m["initial_filter_size"], m["in_channels"],
                m["num_classes"], 1),
            "peak_flops": flops.PEAK_FLOPS["tf32"],
            "dx_least_s_per_step": flops.dx_least_seconds(
                convs, st.batch, "float32")}


def _gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
         keys) -> float:
    """The worst leaf's gap of norms over the larger of its reference
    norm and the median leaf's."""
    norms = {k: float(want[k].norm()) for k in keys}
    median = float(np.median(list(norms.values())))
    return max(abs(float(got[k].norm()) - norms[k]) / max(norms[k], median)
               for k in keys)


def _batch(st, j: int, dev):
    rows = slice(j * st.batch, (j + 1) * st.batch)
    return (torch.from_numpy(st.data[rows]).to(dev).permute(0, 4, 1, 2, 3),
            torch.from_numpy(st.seg[rows]).to(dev))


def _stage(got_loss, got_grad, got_change, ref_losses, ref_grad, ref_change
           ) -> Dict[str, float]:
    """The loss, gradient and change numbers of one stage."""
    keys = sorted(ref_grad)
    grad_norms = {k: float(ref_grad[k].norm()) for k in keys}
    median = float(np.median(list(grad_norms.values())))
    moved = [k for k in keys if grad_norms[k] >= 1e-3 * median]
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(got_loss, ref_losses)),
            "grad_gap": _gap(got_grad, ref_grad, keys),
            "change_gap": _gap(got_change, ref_change, moved)}


def check(st) -> Dict[str, float]:
    tr, dev = st.ctx.config["training"], st.ctx.device
    lr, wd = tr["learning_rate"], tr["weight_decay"]
    beta1 = st.state.optimizer.defaults["betas"][0]
    before, first, after, losses, at = (st.before, st.first, st.after,
                                        st.losses, st.at)
    del st.exp, st.state, st.leaves
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    start = {k: v.to(dev) for k, v in st.reference.items()}
    with reference.exact():
        ref_losses, ref_first, ref_after = ref_train.train_steps(
            start, [_batch(st, j, dev) for j in range(CHECKED_STEPS)],
            lr, wd)
    out = _stage(losses, first, {k: after[k] - before[k] for k in ref_first},
                 ref_losses, ref_first,
                 {k: ref_after[k] - start[k] for k in ref_first})
    if at is None:                 # the window ended before its step
        return dict(out, **{f"step_{k}": float("inf") for k in out})
    kept = {name: {k: _torch_layout(k, v) for k, v in at[name].items()}
            for name in ("before", "after", "m", "v", "m_after")}
    with reference.exact():
        ref_loss, ref_grad, ref_next = ref_train.train_steps(
            kept["before"], [_batch(st, at["j"], dev)], lr, wd,
            moments=(kept["m"], kept["v"], at["t"]))
    grad = {k: (kept["m_after"][k] - beta1 * kept["m"][k]) / (1 - beta1)
            for k in ref_grad}
    step = _stage([at["loss"]], grad,
                  {k: kept["after"][k] - kept["before"][k] for k in ref_grad},
                  ref_loss, ref_grad,
                  {k: ref_next[k] - kept["before"][k] for k in ref_grad})
    st.ctx.log(f"checked window step {st.check_at} (Adam's step "
               f"{at['t'] + 1}), loss {at['loss']!r}")
    return dict(out, **{f"step_{k}": v for k, v in step.items()})
