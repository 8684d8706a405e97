#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (values_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. describe the card (name and power limit from nvidia-smi);
2. build the kernels: K1 (CUDA C++, nvcc), K2 and K3 (Triton JIT);
3. hold K1 against its plain PyTorch version on the card, in float32
   and bfloat16, over every fusion the main path uses;
4. hold K2 against its plain version, on a stack with exact zeros;
5. hold K3 against its plain version in both bit modes (the bits
   exactly, the sums within tolerance, sigma = 0 exactly softmax);
5b. hold K1b (K1's autograd Function) against autograd through K1's
   plain version: dx, dW and db, f32 and bf16, with statistics and with
   the leaky and ReLU epilogues;
6. run the deterministic path at full width -- the 5-member UNet3D
   ensemble (2 classes, initial filter size 8) scoring batches of 32
   64^3 volumes through ``make_scorer`` -- count each kernel's launches
   in that run, time it, and hold a 2-volume float32 run against the
   plain path (per-member UNet3D modules, plain statistics) on the card;
7. the same for the aleatoric path: 5 aleatoric members, 10 logit
   samples each, through ``make_aleatoric_scorer`` (K1 + K3);
8. the ``score`` CLI over 64 LIDC-style volumes for a deterministic and
   an aleatoric set of 5 reference-format checkpoints;
8b. the training CLI on ``softmax_config`` at its published widths
   (UNet3D, 64^3 patches, batch 8) over a synthetic toy ``Case_1``, one
   epoch at f32 and one at bf16, each with validation and a checkpoint
   that the score CLI then scores, launches counted; the f32 run's first
   step held against the plain path (K1b's plain version in every conv);
9. time each kernel at its path's shape beside its bound, its plain
   version and a library yardstick (K3: the stock-torch sampling loop;
   K1b: cuDNN's input gradient), time and profile a training step, and
   break one batch of each scoring path down by device kernel with
   torch.profiler.

Prints a ``{"kernels": [...]}`` JSON line and ends with
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or outside the repository.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_MEMBERS, PATCH, CLASSES, FILTERS = 5, 64, 2, 8
BATCH, N_BATCHES, SEED = 32, 3, 0
AGG_PATCH, THRESHOLD = 10, 0.3
N_ALEATORIC = 10          # logit samples per member (the reference's default)
ALEATORIC_BATCHES = 2
CLI_VOLUMES = 64
CLI_SEED = 123            # the checkpoints' hparams["seed"]
# the LIDC datamodule of configs/datamodule/lidc_idri_config.yaml
LIDC_DATAMODULE = {"dataset_name": "LIDC-IDRI", "shift_feature": "texture",
                   "num_raters": 4, "data_num_folds": 5, "data_fold_id": 0,
                   "batch_size": 8, "patch_size": PATCH, "patch_overlap": 1,
                   "seed": 123}

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core and
# float32 CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# the per-conv table and the profiler's table, too long for the log
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "build", "chip_smoke")


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str, card: str):
    t0 = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s; card {card}")


def _wrappers() -> dict:
    """Each kernel's wrapper, which counts its launches."""
    from values_tpu_torch.ops.kernels.conv3d import (conv3d_fused,
                                                     conv3d_fused_train)
    from values_tpu_torch.ops.kernels.entropy import fused_entropy
    from values_tpu_torch.ops.kernels.sampling import sampled_softmax_stats
    return {"conv3d_fused": conv3d_fused,
            "conv3d_fused_train": conv3d_fused_train,
            "fused_entropy": fused_entropy,
            "sampled_softmax_stats": sampled_softmax_stats}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def read_launches() -> dict:
    """K1's count holds every K1 launch, K1b's dx launches included;
    conv3d_fused_train's holds those dx launches alone."""
    return {name: w.launches for name, w in _wrappers().items()}


def expect_launches(launches: dict, want: dict, what: str) -> None:
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


# -- K1 against its plain version ---------------------------------------------

def k1_inputs(gen, dtype, b, d, h, w, groups, cin1, cin2, cout, prologue):
    import torch
    dev = "cuda"

    def rand(*shape, lo=-1.0, hi=1.0):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo)
                + lo)

    cin = cin1 + cin2
    x = rand(b, d, h, w, groups * cin1).to(dtype)
    x2 = rand(b, d, h, w, groups * cin2).to(dtype) if cin2 else None
    weight = (rand(3, 3, 3, cin, groups * cout) / (27 * cin) ** 0.5
              ).to(dtype)
    bias = rand(groups * cout, lo=-0.1, hi=0.1)
    maps = None
    if prologue:
        slopes = torch.tensor([1.0, 0.01, 0.0], device=dev)
        pick = torch.randint(0, 3, (b, groups * cin), generator=gen,
                             device=dev)
        maps = (rand(b, groups * cin, lo=0.5, hi=2.0),
                rand(b, groups * cin, lo=-0.5, hi=0.5), slopes[pick])
    return x, weight, bias, x2, maps


# (name, B, D, H, W, G, Cin1, Cin2, Cout, prologue, activation, stats)
K1_CASES = [
    ("plain", 2, 16, 16, 16, 5, 8, 0, 8, False, "none", False),
    ("ragged tiles", 2, 20, 12, 28, 5, 8, 0, 8, False, "none", False),
    ("x2 concat", 2, 16, 16, 16, 5, 8, 8, 8, False, "none", False),
    ("prologue slopes 1/0.01/0", 2, 16, 16, 16, 5, 8, 0, 16, True,
     "none", False),
    ("relu epilogue", 2, 16, 16, 16, 5, 8, 0, 8, False, "relu", False),
    ("leaky epilogue, x2 + prologue", 2, 16, 16, 16, 5, 8, 8, 8, True,
     "leaky", False),
    ("emit_stats + prologue", 2, 16, 16, 16, 5, 16, 0, 32, True, "none",
     True),
    ("Cin=1, G=5, stats", 2, 16, 16, 16, 5, 1, 0, 8, False, "none", True),
    ("center 4^3, 64->128, relu", 2, 4, 4, 4, 5, 64, 0, 128, True,
     "relu", False),
    ("expand_4_1 8^3, 64+64->64", 2, 8, 8, 8, 5, 64, 64, 64, True,
     "leaky", False),
    ("full width 64^3, G=5, 8->8, stats", 2, 64, 64, 64, 5, 8, 0, 8, True,
     "none", True),
]

# Tolerances, stated with their reasons:
# - float32 out: atol 1e-4 -- both sides accumulate <= 27*Cin products in
#   float32, in different orders (the plain side through cuDNN with TF32
#   off); inputs are O(1) and weights scaled to O(1) outputs.
# - bfloat16 out: |err| <= 2**-7 |ref| + 2e-3 max|ref| -- the kernel and
#   the plain version round the same float32 value to bfloat16, and an
#   ulp-level difference in float32 order can flip that rounding (one
#   bf16 ulp is <= 2**-7 relative); the absolute term covers prologue
#   results that round to the other neighbouring bf16 value.
# - stats: |err| <= rtol * sum|y| (sum) and rtol * sum y^2 (sumsq), with
#   rtol 1e-5 in float32 and 1e-3 in bfloat16 -- the kernel adds its
#   per-block partial sums with atomics, in an order that changes from
#   run to run.
K1_TOL = {"float32": (0.0, 1e-4, 1e-5), "bfloat16": (2 ** -7, 2e-3, 1e-3)}


def check_k1():
    import torch
    from values_tpu_torch.ops.kernels.conv3d import (conv3d_fused,
                                                     conv3d_fused_reference)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol_rel, stats_rtol = K1_TOL[str(dtype).split(".")[1]]
        for (name, b, d, h, w, g, cin1, cin2, cout, pro, act,
             stats) in K1_CASES:
            x, weight, bias, x2, maps = k1_inputs(
                gen, dtype, b, d, h, w, g, cin1, cin2, cout, pro)
            kw = dict(x2=x2, prologue=maps, activation=act,
                      emit_stats=stats)
            got = conv3d_fused(x, weight, bias, g, **kw)
            want = conv3d_fused_reference(x, weight, bias, g, **kw)
            torch.cuda.synchronize()
            if stats:
                (got, (gs, gq)), (want, (ws, wq)) = got, want
            err = (got.float() - want.float()).abs()
            ref = want.float().abs()
            atol = (1e-4 if dtype == torch.float32
                    else atol_rel * float(ref.max()))
            bad = int((err > atol + rtol * ref).sum())
            msg = (f"K1 {str(dtype)[6:]:8s} {name:34s} max_abs_err "
                   f"{float(err.max()):.3e} (max|ref| {float(ref.max()):.3f})")
            if stats:
                # scale each sum by the magnitude of what it adds up
                s_err = float((gs - ws).abs().max())
                q_err = float((gq - wq).abs().max())
                s_scale = float(want.float().abs().sum(dim=(1, 2, 3)).max())
                bad += int(s_err > stats_rtol * s_scale)
                bad += int(q_err > stats_rtol * float(wq.abs().max()))
                msg += f"; stats err sum {s_err:.3e} sumsq {q_err:.3e}"
            log(msg)
            if bad:
                raise AssertionError(f"K1 {dtype} case {name!r}: {bad} "
                                     "values outside tolerance")


# -- K2 against its plain version ---------------------------------------------

def entropy_stack(gen, s, c, n):
    """A softmax stack (S, C, N) float32 with exact zeros and ones at a
    quarter of the voxels."""
    import torch
    logits = torch.randn((s, c, n), generator=gen, device="cuda") * 3
    p = torch.softmax(logits, dim=1)
    hard = torch.rand((n,), generator=gen, device="cuda") < 0.25
    onehot = torch.zeros_like(p)
    onehot[:, 0] = 1.0
    return torch.where(hard, onehot, p)


def check_k2():
    import torch
    from values_tpu_torch.ops.kernels.entropy import (
        fused_entropy, fused_entropy_reference)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # atol 1e-5: the kernel's and PyTorch's float32 log differ in the
    # last ulps, and each map sums S*C terms of magnitude <= 1/e
    worst = 0.0
    for s, c, n in ((5, 2, 1 << 20), (3, 4, 100_003)):
        stack = entropy_stack(gen, s, c, n)
        if not bool((stack == 0).any()):
            raise AssertionError("the K2 check needs exact zeros")
        got, want = fused_entropy(stack), fused_entropy_reference(stack)
        # a permuted (channels-last) view, as the scorer hands it over
        cl = stack.permute(2, 0, 1).contiguous().permute(1, 2, 0)
        got_cl = fused_entropy(cl)
        torch.cuda.synchronize()
        for key in want:
            for g in (got[key], got_cl[key]):
                err = float((g - want[key]).abs().max())
                worst = max(worst, err)
                if not err <= 1e-5:
                    raise AssertionError(f"K2 {key} at S={s} C={c}: "
                                         f"max_abs_err {err:.3e}")
        log(f"K2 S={s} C={c} N={n}: max_abs_err {worst:.3e} (contiguous "
            "and channels-last view)")
    return worst


# -- K3 against its plain version ---------------------------------------------

def k3_head(gen, n, m, c):
    """An (N, M, 2C) float32 head and its (mu, sigma) views, as the
    aleatoric scorer slices them: mu = head[..., :C] ~ 2 N(0, 1), and
    sigma = exp(s / 2) of a unit-scale log-variance s ~ N(0, 1), written
    back into head[..., C:]."""
    import torch
    head = torch.randn((n, m, 2 * c), generator=gen, device="cuda")
    head[..., :c] *= 2
    head[..., c:] = torch.exp(head[..., c:] / 2)
    return head[..., :c], head[..., c:]


def check_k3():
    """Both bit modes at M=5, C=2, n=3: the bits exactly, then the sums
    and the sigma = 0 case. Tolerances: sums atol 1e-4, rtol 1e-5 (the
    kernel's float32 exp, log, sqrt and divisions and its FMAs differ
    from PyTorch's by ulps; each sum adds M*n = 15 terms of magnitude at
    most 1, or log C); sigma = 0: atol 1e-5 against n * sum_m
    softmax(mu). Returns the worst sum error."""
    import torch
    from values_tpu_torch.ops.kernels import sampling
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    m, c, n_s, seed = N_MEMBERS, CLASSES, 3, 2 ** 33 + 12345
    # (bits, N, spatial, counter_rows): ragged N for the 256-voxel blocks
    cases = (("philox", 100_003, None, None),
             ("counter", 5 * 8 * 7 * 16, (8, 7, 16), 4))
    worst = 0.0
    for bits, n, spatial, rows in cases:
        kw = dict(n_samples=n_s, bits=bits, spatial=spatial,
                  counter_rows=rows)
        got_bits = sampling.sample_bits(n, m, c, seed, device="cuda", **kw)
        want_bits = sampling.sample_bits_reference(n, m, c, seed,
                                                   device="cuda", **kw)
        if not torch.equal(got_bits, want_bits):
            bad = int((got_bits != want_bits).sum())
            raise AssertionError(f"K3 {bits} bits: {bad} of "
                                 f"{got_bits.numel()} words differ")
        mu, sigma = k3_head(gen, n, m, c)
        got = sampling.sampled_softmax_stats(mu, sigma, seed, **kw)
        want = sampling.sampled_softmax_stats_reference(mu, sigma, seed,
                                                        **kw)
        errs = []
        for name, g, w in zip(("sum_p", "sum_ent"), got, want):
            err = (g - w).abs()
            errs.append(float(err.max()))
            if bool((err > 1e-4 + 1e-5 * w.abs()).any()):
                raise AssertionError(f"K3 {bits} {name}: max_abs_err "
                                     f"{errs[-1]:.3e}")
        worst = max(worst, *errs)
        zero_p, _ = sampling.sampled_softmax_stats(
            mu, torch.zeros_like(sigma), seed, **kw)
        soft = n_s * torch.softmax(mu, dim=-1).sum(dim=1).t()
        err0 = float((zero_p - soft).abs().max())
        if not err0 <= 1e-5:
            raise AssertionError(f"K3 {bits} sigma=0: max_abs_err {err0:.3e}")
        log(f"K3 {bits:7s} M={m} C={c} n={n_s} N={n}: bits equal "
            f"({got_bits.numel()} words); max_abs_err sum_p {errs[0]:.3e} "
            f"sum_ent {errs[1]:.3e}; sigma=0 {err0:.3e} (strided views)")
    return worst


# -- K1b against autograd through K1's plain version --------------------------

def plain_train_conv(x, weight, bias=None, groups=1, activation="none",
                     emit_stats=False):
    """K1b's plain version: autograd through conv3d_fused_reference."""
    from values_tpu_torch.ops.kernels.conv3d import conv3d_fused_reference
    return conv3d_fused_reference(x, weight, bias, groups,
                                  activation=activation,
                                  emit_stats=emit_stats)


def k1b_grads(fn, x, weight, bias, groups, case, gy, g1, g2):
    """(dx, dW, db) of sum(out * gy) (+ sum(s1 * g1) + sum(s2 * g2) for
    the statistics case) through ``fn``."""
    import torch
    x, weight, bias = (t.detach().requires_grad_(True)
                       for t in (x, weight, bias))
    if case == "stats":
        y, (s1, s2) = fn(x, weight, bias, groups, emit_stats=True)
        total = (y.float() * gy).sum() + (s1 * g1).sum() + (s2 * g2).sum()
    else:
        y = fn(x, weight, bias, groups, activation=case)
        total = (y.float() * gy).sum()
    return torch.autograd.grad(total, (x, weight, bias))


# (name, dtype, B, volume, G, Cin, Cout)
K1B_CASES = [("B 2, 32^3, G 2, 16 -> 8", "float32", 2, 32, 2, 16, 8),
             ("expand_1_1: B 8, 64^3, G 1, 16 -> 8", "bfloat16", 8, 64, 1,
              16, 8)]
# Tolerances: float32 atol 1e-4 max|g| -- dx, dW and db each add up to
# 27 Cout (dx) or B D H W (dW, db) products in another order than cuDNN
# does on the plain side (TF32 off); bfloat16 K1's rule, 2**-7 |ref| +
# 2e-3 max|g|: both sides round the same float32 sums to bfloat16 and an
# ulp of order can flip a rounding.
K1B_TOL = {"float32": (0.0, 1e-4), "bfloat16": (2 ** -7, 2e-3)}


def check_k1b():
    """K1b's dx, dW and db on the card against autograd through K1's
    plain version, for the statistics case (activation none) and the
    leaky and ReLU epilogues; each backward's dx launches K1 once."""
    import torch
    from values_tpu_torch.ops.kernels.conv3d import conv3d_fused_train
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    worst = 0.0
    for name, dt, b, p, g, cin, cout in K1B_CASES:
        dtype = getattr(torch, dt)
        rtol, atol_rel = K1B_TOL[dt]
        x, weight, bias, _, _ = k1_inputs(gen, dtype, b, p, p, p, g, cin, 0,
                                          cout, False)
        gy = torch.randn((b, p, p, p, g * cout), generator=gen,
                         device="cuda")
        # no cotangent within 1e-3 of the activations' kink, where the
        # kernel and the plain forward, rounding apart, may take
        # different branches
        pre = plain_train_conv(x, weight, bias, g).float()
        gy = torch.where(pre.abs() < 1e-3 * pre.abs().max(), 0.0, gy)
        # statistics cotangents large enough to survive K1b's bf16 fold
        # (fault R5: a shift below half an ulp of dy is rounded away)
        g1, g2 = torch.randn((2, b, g * cout), generator=gen,
                             device="cuda") * 0.1
        for case in ("stats", "leaky", "relu"):
            reset_launches()
            got = k1b_grads(conv3d_fused_train, x, weight, bias, g, case, gy,
                            g1, g2)
            torch.cuda.synchronize()
            launches = read_launches()
            expect_launches(launches, {"conv3d_fused": 2,
                                       "conv3d_fused_train": 1,
                                       "fused_entropy": 0,
                                       "sampled_softmax_stats": 0},
                            f"K1b {name} {case} (forward + dx)")
            want = k1b_grads(plain_train_conv, x, weight, bias, g, case, gy,
                             g1, g2)
            errs = []
            for what, a, w in zip(("dx", "dW", "db"), got, want):
                a, w = a.float(), w.float()
                err = (a - w).abs()
                scale = float(w.abs().max())
                errs.append(float(err.max()) / scale)
                if bool((err > atol_rel * scale + rtol * w.abs()).any()):
                    raise AssertionError(
                        f"K1b {name} {case} {what}: max_abs_err "
                        f"{float(err.max()):.3e} (max|g| {scale:.3e})")
            worst = max(worst, *errs)
            log(f"K1b {dt:8s} {name:36s} {case:5s}: max_abs_err / max|g| "
                f"dx {errs[0]:.2e} dW {errs[1]:.2e} db {errs[2]:.2e}; "
                f"K1 launched for dx")
    return worst


# -- the main path ------------------------------------------------------------

def member_state_dicts(seed: int, aleatoric: bool = False):
    """Per-member UNet3D state_dicts (with the ``final_aleatoric`` head
    when ``aleatoric``), drawn with numpy from ``seed`` at each
    parameter's fan-in scale (torch's default init range)."""
    import torch
    from values_tpu_torch.models.unet3d import UNet3D
    rs = np.random.RandomState(seed)
    states = []
    for _ in range(N_MEMBERS):
        ref = UNet3D(CLASSES, initial_filter_size=FILTERS,
                     aleatoric_loss=aleatoric).state_dict()
        state = {}
        for key, t in ref.items():
            # torch's default init range: the weight's dim-0 slice size
            fan_in = ref[key.rsplit(".", 1)[0] + ".weight"][0].numel()
            lim = 1.0 / np.sqrt(fan_in)
            state[key] = torch.from_numpy(
                rs.uniform(-lim, lim, tuple(t.shape)).astype(np.float32))
        states.append(state)
    return states


def plain_path_scores(states, vols, gt):
    """The scorer's function composed from plain parts on the card:
    per-member UNet3D modules (unfused, cuDNN with TF32 off), float32
    softmax, K2's plain version, then the port's Dice and C3."""
    import torch
    from values_tpu_torch.inference.scoring import score_from_statistics
    from values_tpu_torch.models.unet3d import UNet3D
    from values_tpu_torch.ops.kernels.entropy import fused_entropy_reference
    logits = []
    with torch.no_grad():
        for state in states:
            net = UNet3D(CLASSES, initial_filter_size=FILTERS)
            net.load_state_dict(state, strict=True)
            logits.append(net.cuda().eval()(vols))
    probs = torch.softmax(torch.stack(logits), dim=-1)   # (M, B, ..., C)
    stack = probs.reshape(N_MEMBERS, -1, CLASSES).permute(0, 2, 1)
    return score_from_statistics(
        fused_entropy_reference(stack), gt, agg_patch=AGG_PATCH,
        threshold=THRESHOLD, ignore_index=0)


def main_path(card: str):
    import torch
    from values_tpu_torch.inference.scoring import make_scorer, score_rows
    from values_tpu_torch.models.torch_import import group_member_state_dicts

    states = member_state_dicts(SEED)
    grouped = group_member_state_dicts(states)
    rs = np.random.RandomState(3)

    def batch(n):  # drawn as bench.py draws its workload
        vols = rs.rand(n, PATCH, PATCH, PATCH, 1).astype(np.float32)
        gt = (rs.rand(n, PATCH, PATCH, PATCH) > 0.7).astype(np.uint8)
        return (torch.from_numpy(vols).cuda(), torch.from_numpy(gt).cuda())

    score, rows = make_scorer(N_MEMBERS, PATCH, agg_patch=AGG_PATCH,
                              threshold=THRESHOLD, dtype=torch.bfloat16)
    assert rows == score_rows() and len(rows) == 10
    batches = [batch(BATCH) for _ in range(N_BATCHES + 1)]
    warm = score(grouped, *batches[0])
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    outs = [score(grouped, *b) for b in batches[1:]]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    # K1 18 times per forward, K2 once per batch, K3 never
    expect_launches(launches, {"conv3d_fused": 18 * N_BATCHES,
                               "conv3d_fused_train": 0,
                               "fused_entropy": N_BATCHES,
                               "sampled_softmax_stats": 0},
                    "deterministic path")
    for out in [warm] + outs:
        if tuple(out.shape) != (10, BATCH) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"scores of shape {tuple(out.shape)} "
                                 "are not a finite (10, B) matrix")
    vps = N_BATCHES * BATCH / elapsed
    log(f"main path: {N_BATCHES} batches of {BATCH} x {PATCH}^3, "
        f"{N_MEMBERS} members, bf16: {elapsed * 1e3:.1f} ms, "
        f"{vps:.2f} volumes/s; launches {json.dumps(launches)}; "
        f"card {card}")
    log("dice row (first 4): " + " ".join(f"{v:.4f}" for v in
                                          outs[0][0, :4].tolist()))

    # correctness: 2 volumes in float32 against the plain path
    score32, _ = make_scorer(N_MEMBERS, PATCH, agg_patch=AGG_PATCH,
                             threshold=THRESHOLD, dtype=torch.float32)
    vols, gt = batch(2)
    got = score32(grouped, vols, gt)
    want = plain_path_scores(states, vols, gt)
    err = (got - want).abs()
    # rtol/atol 1e-3: float32 rounding differs between the fused and the
    # unfused forward (deferred norm, other summation orders); the image
    # sums add 64^3 entropies; Dice moves ~1e-5 per voxel whose argmax
    # ties within rounding
    tol = 1e-3 + 1e-3 * want.abs()
    for i, name in enumerate(rows):
        log(f"  f32 vs plain path {name:34s} max_abs_err "
            f"{float(err[i].max()):.3e}")
    if not bool((err <= tol).all()):
        raise AssertionError("float32 scorer disagrees with the plain path")
    return launches, vps, batches[1], grouped


def throughput(grouped, card: str, batch: int, repeats: int = 2):
    """Scored volumes/s at another batch size (one warm-up call)."""
    import torch
    from values_tpu_torch.inference.scoring import make_scorer
    score, _ = make_scorer(N_MEMBERS, PATCH, agg_patch=AGG_PATCH,
                           threshold=THRESHOLD, dtype=torch.bfloat16)
    rs = np.random.RandomState(batch)
    vols = torch.from_numpy(rs.rand(batch, PATCH, PATCH, PATCH, 1)
                            .astype(np.float32)).cuda()
    gt = torch.from_numpy((rs.rand(batch, PATCH, PATCH, PATCH) > 0.7)
                          .astype(np.uint8)).cuda()
    score(grouped, vols, gt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = score(grouped, vols, gt)
    torch.cuda.synchronize()
    vps = repeats * batch / (time.perf_counter() - t0)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"non-finite scores at batch {batch}")
    log(f"batch {batch}: {vps:.2f} volumes/s; card {card}")


# -- the aleatoric path -------------------------------------------------------

def plain_aleatoric_scores(states, vols, gt, seed):
    """The aleatoric scorer's function composed from plain parts on the
    card: per-member aleatoric UNet3D modules (unfused, cuDNN with TF32
    off) giving (mu, s), sigma = exp(s / 2), K3's plain version with the
    same seed and bits, then the port's C2 finalize, Dice and C3."""
    import torch
    from values_tpu_torch.inference.scoring import (score_from_statistics,
                                                    streaming_finalize)
    from values_tpu_torch.models.unet3d import UNet3D
    from values_tpu_torch.ops.kernels.sampling import \
        sampled_softmax_stats_reference
    mus, sigmas = [], []
    with torch.no_grad():
        for state in states:
            net = UNet3D(CLASSES, initial_filter_size=FILTERS,
                         aleatoric_loss=True)
            net.load_state_dict(state, strict=True)
            mu, s = net.cuda().eval()(vols)
            mus.append(mu)
            sigmas.append(torch.exp(s / 2.0))
    mu = torch.stack(mus, dim=-2).reshape(-1, N_MEMBERS, CLASSES)
    sigma = torch.stack(sigmas, dim=-2).reshape(-1, N_MEMBERS, CLASSES)
    carry = sampled_softmax_stats_reference(mu, sigma, seed,
                                            n_samples=N_ALEATORIC)
    return score_from_statistics(
        streaming_finalize(carry, N_MEMBERS * N_ALEATORIC), gt,
        agg_patch=AGG_PATCH, threshold=THRESHOLD, ignore_index=0)


def aleatoric_path(card: str):
    """``make_aleatoric_scorer`` at full width: a warm-up batch, then
    ALEATORIC_BATCHES batches of BATCH counted and timed; a 2-volume
    float32 run against the plain path."""
    import torch
    from values_tpu_torch.inference.scoring import make_aleatoric_scorer
    from values_tpu_torch.models.torch_import import group_member_state_dicts

    states = member_state_dicts(SEED + 10, aleatoric=True)
    grouped = group_member_state_dicts(states)
    rs = np.random.RandomState(4)

    def batch(n):  # drawn as the deterministic path draws its batches
        vols = rs.rand(n, PATCH, PATCH, PATCH, 1).astype(np.float32)
        gt = (rs.rand(n, PATCH, PATCH, PATCH) > 0.7).astype(np.uint8)
        return (torch.from_numpy(vols).cuda(), torch.from_numpy(gt).cuda())

    score, _ = make_aleatoric_scorer(N_MEMBERS, PATCH,
                                     n_aleatoric_samples=N_ALEATORIC,
                                     agg_patch=AGG_PATCH,
                                     threshold=THRESHOLD,
                                     dtype=torch.bfloat16)
    batches = [batch(BATCH) for _ in range(ALEATORIC_BATCHES + 1)]
    warm = score(grouped, *batches[0], 100)
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    outs = [score(grouped, *b, 101 + i) for i, b in enumerate(batches[1:])]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    # K1 18 times per forward, K3 once per batch, K2 never
    expect_launches(launches, {"conv3d_fused": 18 * ALEATORIC_BATCHES,
                               "conv3d_fused_train": 0,
                               "fused_entropy": 0,
                               "sampled_softmax_stats": ALEATORIC_BATCHES},
                    "aleatoric path")
    for out in [warm] + outs:
        if tuple(out.shape) != (10, BATCH) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"aleatoric scores of shape "
                                 f"{tuple(out.shape)} are not a finite "
                                 "(10, B) matrix")
    vps = ALEATORIC_BATCHES * BATCH / elapsed
    log(f"aleatoric path: {ALEATORIC_BATCHES} batches of {BATCH} x "
        f"{PATCH}^3, {N_MEMBERS} members x {N_ALEATORIC} samples, bf16: "
        f"{elapsed * 1e3:.1f} ms, {vps:.2f} volumes/s; launches "
        f"{json.dumps(launches)}; card {card}")

    # correctness: 2 volumes in float32 against the plain path
    score32, rows = make_aleatoric_scorer(N_MEMBERS, PATCH,
                                          n_aleatoric_samples=N_ALEATORIC,
                                          agg_patch=AGG_PATCH,
                                          threshold=THRESHOLD,
                                          dtype=torch.float32)
    vols, gt = batch(2)
    got = score32(grouped, vols, gt, 7)
    want = plain_aleatoric_scores(states, vols, gt, 7)
    err = (got - want).abs()
    # rtol/atol 1e-3, as the deterministic path's check: float32 rounding
    # of the fused and the unfused forward, and K3's kernel against its
    # plain version (1e-4 on sums of 50 terms), on image-level sums of
    # 64^3 voxels; Dice moves ~1e-5 per voxel whose argmax ties
    for i, name in enumerate(rows):
        log(f"  aleatoric f32 vs plain path {name:34s} max_abs_err "
            f"{float(err[i].max()):.3e}")
    if not bool((err <= 1e-3 + 1e-3 * want.abs()).all()):
        raise AssertionError("aleatoric float32 scorer disagrees with the "
                             "plain path")
    return launches, vps, batches[1], grouped


# -- the score CLI ------------------------------------------------------------

def write_cli_data(root: str, rs) -> dict:
    """CLI_VOLUMES LIDC-style 64^3 volumes (``preprocessed/images``) with
    their rater masks (``preprocessed/labels/<id>_<rater>_mask.npy``) and
    a ``splits_texture.pkl`` whose fold 0 ``id_test`` lists them all.
    Returns {subject: (volume, masks)}."""
    images = os.path.join(root, "preprocessed", "images")
    labels = os.path.join(root, "preprocessed", "labels")
    os.makedirs(images)
    os.makedirs(labels)
    data = {}
    raters = LIDC_DATAMODULE["num_raters"]
    for k in range(CLI_VOLUMES):
        subject = f"LIDC-{k:04d}"
        vol = rs.rand(PATCH, PATCH, PATCH).astype(np.float32)
        masks = (rs.rand(raters, PATCH, PATCH, PATCH) > 0.7).astype(np.uint8)
        np.save(os.path.join(images, subject + ".npy"), vol)
        for r in range(raters):
            np.save(os.path.join(labels, f"{subject}_{r:02d}_mask.npy"),
                    masks[r])
        data[subject] = (vol, masks)
    with open(os.path.join(root, "splits_texture.pkl"), "wb") as f:
        pickle.dump([{"id_test": [s + ".npy" for s in data],
                      "ood_test": [], "val": [], "train": []}], f)
    return data


def write_checkpoints(root: str, name: str, states, aleatoric: bool):
    """One reference-format ``.ckpt`` per member state_dict."""
    import torch
    hparams = {
        "seed": CLI_SEED, "data_input_dir": root,
        "model": {"_target_": "values_tpu.models.unet3d.UNet3D",
                  "num_classes": CLASSES, "in_channels": 1,
                  "initial_filter_size": FILTERS, "kernel_size": 3,
                  "do_instancenorm": True},
        "datamodule": dict(LIDC_DATAMODULE, splits_path=os.path.join(
            root, "splits_texture.pkl"))}
    if aleatoric:
        hparams.update(aleatoric_loss=True, n_aleatoric_samples=N_ALEATORIC)
    paths = []
    for i, state in enumerate(states):
        path = os.path.join(root, f"{name}_{i}.ckpt")
        torch.save({"state_dict": {"model." + k: v for k, v in state.items()},
                    "hyper_parameters": hparams}, path)
        paths.append(path)
    return paths


def cli_path(card: str):
    """``values_tpu_torch.inference.score.run_score`` on the card over
    CLI_VOLUMES volumes at batch 32, for a deterministic and an aleatoric
    set of N_MEMBERS checkpoints, each run's launches counted; each JSON
    against its scorer (``make_scorer``, ``make_aleatoric_scorer`` with
    the CLI's batch seeds) on the same batches."""
    import torch
    from values_tpu_torch.core.seed import make_generator
    from values_tpu_torch.inference.score import run_score, score_cli
    from values_tpu_torch.inference.scoring import (make_aleatoric_scorer,
                                                    make_scorer, score_rows)
    from values_tpu_torch.models.torch_import import group_member_state_dicts
    rows = score_rows()
    n_batches = -(-CLI_VOLUMES // BATCH)
    # K1 18 times per forward; K2 once per deterministic batch, K3 once
    # per aleatoric one
    want_launches = {
        "deterministic": {"conv3d_fused": 18 * n_batches,
                          "conv3d_fused_train": 0,
                          "fused_entropy": n_batches,
                          "sampled_softmax_stats": 0},
        "aleatoric": {"conv3d_fused": 18 * n_batches,
                      "conv3d_fused_train": 0, "fused_entropy": 0,
                      "sampled_softmax_stats": n_batches}}
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as root:
        data = write_cli_data(root, np.random.RandomState(5))
        sets = {"deterministic": member_state_dicts(SEED + 20),
                "aleatoric": member_state_dicts(SEED + 30, aleatoric=True)}
        results = {}
        for name, states in sets.items():
            ckpts = write_checkpoints(root, name, states,
                                      name == "aleatoric")
            out = os.path.join(root, f"{name}.json")
            reset_launches()
            t0 = time.perf_counter()
            results[name] = run_score(score_cli([
                "--checkpoint_paths", *ckpts, "-i", root, "--out", out,
                "--test_split", "id", "--batch_size", str(BATCH),
                "--agg_patch", str(AGG_PATCH), "--threshold",
                str(THRESHOLD)]))
            seconds = time.perf_counter() - t0
            launches = read_launches()
            expect_launches(launches, want_launches[name], f"CLI {name}")
            with open(out) as f:
                on_disk = json.load(f)
            if on_disk != results[name] or sorted(on_disk) != sorted(data):
                raise AssertionError(f"CLI {name}: the JSON does not hold "
                                     f"the {CLI_VOLUMES} subjects")
            for subject, scores in on_disk.items():
                if list(scores) != rows or not all(
                        np.isfinite(v) for v in scores.values()):
                    raise AssertionError(f"CLI {name} {subject}: scores "
                                         f"{scores}")
            log(f"CLI {name}: {CLI_VOLUMES} volumes x {len(rows)} scores, "
                f"{N_MEMBERS} checkpoints, batch {BATCH}: {seconds:.2f} s "
                f"(checkpoint reading and volume loading included); "
                f"launches {json.dumps(launches)}; card {card}")
        # each CLI's JSON against its scorer on the same batches, the
        # aleatoric one with the seeds run_score draws (a generator
        # seeded with the checkpoints' seed); tolerance: K1's
        # bfloat16 one (|err| <= 2**-7 |ref| + 2e-3), as the two runs may
        # round differently after K1's atomics order
        common = dict(agg_patch=AGG_PATCH, threshold=THRESHOLD,
                      dtype=torch.bfloat16)
        scorers = {"deterministic": make_scorer(N_MEMBERS, PATCH,
                                                **common)[0],
                   "aleatoric": make_aleatoric_scorer(
                       N_MEMBERS, PATCH, n_aleatoric_samples=N_ALEATORIC,
                       **common)[0]}
        subjects = sorted(data)
        for name, score in scorers.items():
            grouped = group_member_state_dicts(sets[name])
            gen = make_generator(CLI_SEED)
            worst = 0.0
            for i in range(0, len(subjects), BATCH):
                chunk = subjects[i:i + BATCH]
                vols = torch.from_numpy(np.stack([data[s][0]
                                                  for s in chunk]))
                gt = torch.from_numpy(np.stack([data[s][1] for s in chunk]))
                seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
                args = (grouped, vols.cuda(), gt.cuda())
                if name == "aleatoric":
                    args += (seed,)
                want = score(*args).cpu().numpy()
                got = np.array([[results[name][s][r] for s in chunk]
                                for r in rows])
                err = np.abs(got - want)
                worst = max(worst, float(err.max()))
                if (err > 2 ** -7 * np.abs(want) + 2e-3).any():
                    raise AssertionError(f"the {name} CLI disagrees with "
                                         "its scorer on the same batches")
            log(f"CLI {name} vs its scorer: max_abs_err {worst:.3e}")


# -- the training CLI ---------------------------------------------------------

TRAIN_IMAGES, TRAIN_TEST_IMAGES, RATERS = 32, 2, 3
TRAIN_BATCH, TIMED_STEPS = 8, 5
# K1 per training step: 18 forward convs, and dx for all but the first
# (the input needs no gradient); K1 per validation forward: 18
K1_FORWARD, K1_DX = 18, 17


def write_case1(root: str) -> None:
    """A synthetic toy ``Case_1`` (configs/datamodule/case1_config.yaml)
    under ``root``: TRAIN_IMAGES + TRAIN_TEST_IMAGES 64^3 ``.nii.gz``
    volumes, a noisy ball each, with RATERS rater masks (the ball at
    radius r - 1, r, r + 1)."""
    from values_tpu_torch.core import nifti
    grid = np.indices((PATCH,) * 3).astype(np.float32)
    case = os.path.join(root, "Case_1")
    for split, n, first in (("Tr", TRAIN_IMAGES, 0),
                            ("Ts", TRAIN_TEST_IMAGES, TRAIN_IMAGES)):
        for i in range(first, first + n):
            rs = np.random.RandomState(i)
            center = rs.uniform(20, 44, 3)[:, None, None, None]
            dist = np.sqrt(((grid - center) ** 2).sum(0))
            radius = rs.uniform(8, 16)
            image = ((dist < radius) + 0.3 * rs.randn(*dist.shape)
                     ).astype(np.float32)
            nifti.save(image, os.path.join(case, f"images{split}",
                                           f"{i:04d}.nii.gz"))
            for r in range(RATERS):
                nifti.save((dist < radius + r - 1).astype(np.uint8),
                           os.path.join(case, f"labels{split}",
                                        f"{i:04d}_{r:02d}.nii.gz"))


def training_overrides(root: str, version: str) -> list:
    """softmax_config at its published widths; one epoch on the toy set."""
    return [f"data_input_dir={root}", f"save_dir={root}/exp",
            f"version={version}", "max_epochs=1"]


def run_training_cli(root: str, version: str, extra: list, card: str):
    """The training CLI's ``main`` once, its launches counted and its
    epoch line parsed; returns (checkpoint, seconds, launches, losses)."""
    import io
    from values_tpu_torch.training.main import main as train_main
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        ckpt = train_main(["--device", "cuda"]
                          + training_overrides(root, version) + extra)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    text = out.getvalue()
    epoch_line = [line for line in text.splitlines()
                  if line.startswith("epoch 0:")][0]
    losses = {k: float(v) for k, v in
              (item.split("=") for item in epoch_line.split()[2:5])}
    log(f"training CLI {version}: {epoch_line}; {seconds:.2f} s "
        f"(data preparation on the first run included); launches "
        f"{json.dumps(launches)}; card {card}")
    if not os.path.exists(ckpt) or not all(np.isfinite(v)
                                           for v in losses.values()):
        raise AssertionError(f"training CLI {version}: checkpoint {ckpt} "
                             f"or losses {losses} missing or not finite")
    return ckpt, seconds, launches, losses


def first_step_against_plain(root: str, card: str):
    """The f32 CLI run's first step -- the same config, seeded weights
    and first batch -- through the kernels and through the plain
    versions (K1b's plain version for every conv): loss and every
    parameter gradient. Returns the experiment, its state and that
    batch on the card."""
    import torch
    from values_tpu_torch.config import compose, instantiate
    from values_tpu_torch.models import ensemble_unet3d as ens
    from values_tpu_torch.training.experiment import Experiment, tree_leaves
    from values_tpu_torch.training.loops import _device_batch
    from values_tpu_torch.training.main import DEFAULT_CONFIG_DIR
    cfg = compose(DEFAULT_CONFIG_DIR, "softmax_config",
                  training_overrides(root, "check"))
    dm = instantiate(cfg.datamodule, data_input_dir=root,
                     batch_size=cfg.batch_size)
    dm.setup()
    batch = _device_batch(next(iter(dm.train_dataloader())), "cuda")
    exp = Experiment(cfg, "cuda")
    state = exp.init_state(cfg.seed, cfg.datamodule.patch_size)
    leaves = tree_leaves(state.params)
    names = [f"{m}/{k}" for m in sorted(state.params)
             for k in sorted(state.params[m].get("conv", state.params[m]))]

    def loss_and_grads():
        loss = exp.loss(state.params, batch)
        return loss.item(), torch.autograd.grad(loss, leaves)

    got_loss, got = loss_and_grads()
    real = ens.conv3d_fused_train
    ens.conv3d_fused_train = plain_train_conv
    try:
        want_loss, want = loss_and_grads()
    finally:
        ens.conv3d_fused_train = real
    # loss: rtol 1e-5. Gradients, the biases of the convs feeding an
    # instance norm aside (their true gradient is 0; both sides give
    # roundoff): all leaves together within 1e-3 of their norm, each leaf
    # within 1e-2 of its own -- one voxel whose normalized value lies
    # within rounding of 0 takes the other leaky branch on one side and
    # moves a deep leaf's gradient by ~1e-3 of its norm
    pairs = [(n, a, w) for n, a, w in zip(names, got, want)
             if not (n.startswith("contr_") and n.endswith("bias"))]
    rel = {n: float((a - w).norm() / w.norm()) for n, a, w in pairs}
    total = float(torch.sqrt(sum(((a - w) ** 2).sum() for _, a, w in pairs))
                  / torch.sqrt(sum((w ** 2).sum() for _, _, w in pairs)))
    worst_name = max(rel, key=rel.get)
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    log(f"first f32 step against the plain path: loss {got_loss:.7f} vs "
        f"{want_loss:.7f} (rel {loss_rel:.2e}); gradient error {total:.2e} "
        f"of the norm over {len(pairs)} leaves, largest {rel[worst_name]:.2e}"
        f" ({worst_name}), {sum(v > 1e-4 for v in rel.values())} leaves "
        f"above 1e-4; card {card}")
    if loss_rel > 1e-5 or total > 1e-3 or rel[worst_name] > 1e-2:
        raise AssertionError("the first training step disagrees with the "
                             "plain path")
    return exp, state, batch


def training_path(card: str):
    """The training CLI on softmax_config at its published widths (UNet3D
    f 8, 64^3 patches, batch 8), f32 and bf16, one epoch each with
    validation and a checkpoint; each checkpoint scored by the score CLI;
    each run's launches counted."""
    import pickle as pkl
    from values_tpu_torch.inference.score import run_score, score_cli
    from values_tpu_torch.inference.scoring import score_rows
    os.makedirs(OUT_DIR, exist_ok=True)
    root = tempfile.mkdtemp(dir=OUT_DIR, prefix="train_")
    write_case1(root)
    runs = {}
    for version, extra in (("f32", []), ("bf16", ["+precision=bf16"])):
        runs[version] = run_training_cli(root, version, extra, card)
    with open(os.path.join(root, "Case_1", "splits.pkl"), "rb") as f:
        fold = pkl.load(f)[0]
    steps = -(-len(fold["train"]) // TRAIN_BATCH)
    n_val = len(fold["val"])
    want = {"conv3d_fused": (K1_FORWARD + K1_DX) * steps
            + K1_FORWARD * (n_val + 1),   # + the validation panel
            "conv3d_fused_train": K1_DX * steps,
            "fused_entropy": 0, "sampled_softmax_stats": 0}
    score_batches = -(-n_val // TRAIN_BATCH)
    for version, (ckpt, _, launches, _) in runs.items():
        expect_launches(launches, want, f"training CLI {version} ({steps} "
                        f"steps of 35 K1 launches, 17 of them K1b's dx; "
                        f"{n_val} validation forwards and 1 panel of 18)")
        reset_launches()
        out = os.path.join(root, f"scores_{version}.json")
        scores = run_score(score_cli([
            "--checkpoint_paths", ckpt, "-i", root, "--out", out,
            "--test_split", "val", "--batch_size", str(TRAIN_BATCH),
            "--device", "cuda"]))
        expect_launches(read_launches(), {
            "conv3d_fused": 18 * score_batches, "conv3d_fused_train": 0,
            "fused_entropy": score_batches, "sampled_softmax_stats": 0},
            f"score CLI on the {version} checkpoint")
        if len(scores) != n_val or not all(
                list(s) == score_rows() and all(np.isfinite(list(s.values())))
                for s in scores.values()):
            raise AssertionError(f"scores of the {version} checkpoint: "
                                 f"{scores}")
        dice = np.mean([s["dice"] for s in scores.values()])
        log(f"score CLI on the {version} checkpoint: {len(scores)} val "
            f"volumes, mean dice {dice:.4f}, all rows finite")
    return root, runs, steps


# -- timings ------------------------------------------------------------------

def time_k1(launches, b):
    """K1 at the path's largest conv, expand_1_1 (64^3, x 8 + x2 8 -> 8
    channels per member, prologue, leaky), at the path's batch."""
    import torch
    import torch.nn.functional as F
    from values_tpu_torch.ops.kernels.conv3d import (concat_groups,
                                                     conv3d_fused,
                                                     conv3d_fused_reference)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    g, c = N_MEMBERS, FILTERS
    x, weight, bias, x2, maps = k1_inputs(gen, torch.bfloat16, b, PATCH,
                                          PATCH, PATCH, g, c, c, c, True)
    kw = dict(x2=x2, prologue=maps, activation="leaky")
    out = conv3d_fused(x, weight, bias, g, **kw)
    ref = conv3d_fused_reference(x, weight, bias, g, **kw)
    diff = (out.float() - ref.float()).abs()
    rtol, atol_rel, _ = K1_TOL["bfloat16"]
    atol = atol_rel * float(ref.float().abs().max())
    if bool((diff > atol + rtol * ref.float().abs()).any()):
        raise AssertionError("K1 disagrees with its plain version at the "
                             "path's largest conv")
    err = float(diff.max())
    del out, ref, diff
    ms = cuda_ms(lambda: conv3d_fused(x, weight, bias, g, **kw))
    plain_ms = cuda_ms(lambda: conv3d_fused_reference(x, weight, bias, g,
                                                      **kw), reps=3)
    w_lib = weight.permute(4, 3, 0, 1, 2).contiguous()   # (G*Cout, Cin,..)
    sc, sh, sl = (m[:, None, None, None, :] for m in maps)

    def library():  # prologue + concat + cuDNN conv + activation
        v = concat_groups(x, x2, g).float() * sc - sh
        v = torch.maximum(v, v * sl).to(torch.bfloat16)
        y = F.conv3d(v.permute(0, 4, 1, 2, 3), w_lib, bias.bfloat16(),
                     padding=1, groups=g)
        return F.leaky_relu(y, 0.01)

    library_ms = cuda_ms(library, reps=5)
    vox = b * PATCH ** 3
    bytes_moved = 2 * vox * g * (2 * c + c) + weight.numel() * 2 + 3 * 4 * \
        maps[0].numel() + 4 * bias.numel()
    flops = 2 * vox * g * 27 * (2 * c) * c
    bound_ms, bound_by = bound(bytes_moved, flops, "bfloat16")
    return {"name": "conv3d_fused", "route": "cuda",
            "source": "values_tpu_torch/csrc/conv3d_fused.cu",
            "replaces": "values_tpu/ops/pallas/conv3d.py:332",
            "launches": launches["conv3d_fused"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": f"expand_1_1 B={b} {PATCH}^3 G={g} Cin={2 * c} "
                     f"Cout={c} bf16"}


def time_k2(launches, grouped, vols):
    """K2 at the path's shape: the (M, C, N) float32 softmax view of one
    batch's logits."""
    import torch
    from values_tpu_torch.models.ensemble_unet3d import (
        cast_weights, grouped_forward_fused)
    from values_tpu_torch.ops.kernels.entropy import (
        fused_entropy, fused_entropy_reference)
    with torch.no_grad():
        logits = grouped_forward_fused(
            cast_weights(grouped, torch.bfloat16, vols.device),
            vols.to(torch.bfloat16), N_MEMBERS)
    m, c = logits.shape[-2:]
    probs = torch.softmax(logits.float(), dim=-1)
    stack = probs.reshape(-1, m, c).permute(1, 2, 0)
    got, want = fused_entropy(stack), fused_entropy_reference(stack)
    err = max(float((got[k] - want[k]).abs().max()) for k in want)
    if not err <= 1e-5:
        raise AssertionError(f"K2 at the path's shape: max_abs_err {err}")
    ms = cuda_ms(lambda: fused_entropy(stack))
    plain_ms = cuda_ms(lambda: fused_entropy_reference(stack), reps=5)
    n = stack.shape[-1]
    bytes_moved = 4 * n * (m * c + c + 3)
    flops = n * (4 * m * c + 4 * c + 3)   # mean, p log p, sums, MI
    bound_ms, bound_by = bound(bytes_moved, flops, "float32")
    return {"name": "fused_entropy", "route": "triton",
            "source": "values_tpu_torch/ops/kernels/entropy.py",
            "replaces": "values_tpu/ops/pallas/entropy.py:28",
            "launches": launches["fused_entropy"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "shape": f"S={m} C={c} N={n} f32 channels-last view"}


ACKLAM_CENTRAL, ACKLAM_TAIL = 24, 27   # operations of each branch
ACKLAM_TAIL_SHARE = 2 * 0.02425       # P(u < PLOW or u > 1 - PLOW)


def k3_operations(n: int, m: int, c: int, n_samples: int, bits: str, *,
                  as_written: bool = False) -> float:
    """Operations of K3's function at (N, M, C, n_samples), counting an
    FMA as 2 and each compare, select, integer op, exp, log, sqrt and
    division as 1, per (voxel, member, sample) draw group of C classes.

    What the function needs (the default):

    - bits: Philox4x32-10 gives 4 words for 80 operations (10 rounds x
      2 umulhi, 2 mul, 4 xor), so 20 per class plus 1 to place the word;
      the counter hash 10 per class (xor, add, 3 shift-xors, 2 muls) + 2
      for the group's salt;
    - per class: uniform 4; the inverse CDF's branch test 2, then only
      the branch that applies: the central one (24) with probability
      1 - 2 PLOW, a tail (27) with 2 PLOW, the share of the uniform draws
      that land in a tail (in expectation; at 8.4e8 draws this run's
      share is within 1e-4 of it); logits 2 (one FMA);
    - softmax and entropy 9 C - 1 (max, shift, exp, sum, divide, log,
      log p, p log p, sum, two accumulates).

    ``as_written``: the work the kernel does as written instead -- a
    whole Philox call per 4 classes and 4 selects per class, both Acklam
    branches and a 4-operation select on every draw, a class mask on the
    logits and on p log p.
    """
    if as_written:
        groups = (c + 3) // 4
        draw = (80 * groups + 4 * c * groups if bits == "philox"
                else 10 * c + 2)
        per_class = 4 + ACKLAM_CENTRAL + ACKLAM_TAIL + 4 + 3
        per_group = draw + c * per_class + 10 * c - 1
    else:
        draw = 21 * c if bits == "philox" else 10 * c + 2
        normal = 2 + (1 - ACKLAM_TAIL_SHARE) * ACKLAM_CENTRAL \
            + ACKLAM_TAIL_SHARE * ACKLAM_TAIL
        per_group = draw + c * (4 + normal + 2) + 9 * c - 1
    return n * m * n_samples * per_group


def time_k3(launches, grouped, vols):
    """K3 at the aleatoric path's shape: the (N, M, C) float32 mu and
    sigma views of one bf16 batch's (mu, s) head, 10 samples per member,
    Philox bits; beside its plain version and the stock-torch streaming
    loop (torch.randn draws, softmax, accumulate per sample), the port's
    counterpart of the JAX package's ``sampler="xla"``."""
    import torch
    from values_tpu_torch.models.ensemble_unet3d import (
        cast_weights, grouped_forward_fused)
    from values_tpu_torch.ops.kernels.sampling import (
        sampled_softmax_stats, sampled_softmax_stats_reference)
    from values_tpu_torch.ops.uncertainty import entropy
    with torch.no_grad():
        out = grouped_forward_fused(
            cast_weights(grouped, torch.bfloat16, vols.device),
            vols.to(torch.bfloat16), N_MEMBERS).to(torch.float32)
    c = out.shape[-1] // 2
    mu = out[..., :c].reshape(-1, N_MEMBERS, c)
    sigma = torch.exp(out[..., c:] / 2.0).reshape(-1, N_MEMBERS, c)
    n = mu.shape[0]
    kw = dict(n_samples=N_ALEATORIC)
    got = sampled_softmax_stats(mu, sigma, 3, **kw)
    want = sampled_softmax_stats_reference(mu, sigma, 3, **kw)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    # the check phase's tolerance, on sums of M*n = 50 terms
    if not all(bool(((g - w).abs() <= 1e-4 + 1e-5 * w.abs()).all())
               for g, w in zip(got, want)):
        raise AssertionError(f"K3 at the path's shape: max_abs_err {err}")
    del got, want
    ms = cuda_ms(lambda: sampled_softmax_stats(mu, sigma, 3, **kw))
    plain_ms = cuda_ms(lambda: sampled_softmax_stats_reference(
        mu, sigma, 3, **kw), reps=2, warmup=1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def loop():
        sum_p = torch.zeros((n, c), device="cuda")
        sum_ent = torch.zeros((n,), device="cuda")
        for j in range(N_MEMBERS * N_ALEATORIC):
            im = j // N_ALEATORIC
            eps = torch.randn((n, c), generator=gen, device="cuda")
            probs = torch.softmax(mu[:, im] + sigma[:, im] * eps, dim=-1)
            sum_p = sum_p + probs
            sum_ent = sum_ent + entropy(probs, class_axis=-1)
        return sum_p, sum_ent

    loop_ms = cuda_ms(loop, reps=3)
    bytes_moved = 4 * (2 * n * N_MEMBERS * c) + 4 * (c * n + n)
    flops = k3_operations(n, N_MEMBERS, c, N_ALEATORIC, "philox")
    bound_ms, bound_by = bound(bytes_moved, flops, "float32")
    # the kernel's own work, beside the bound (not the bound)
    written = k3_operations(n, N_MEMBERS, c, N_ALEATORIC, "philox",
                            as_written=True)
    return {"name": "sampled_softmax_stats", "route": "triton",
            "source": "values_tpu_torch/ops/kernels/sampling.py",
            "replaces": "values_tpu/ops/pallas/sampling.py:135",
            "launches": launches["sampled_softmax_stats"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "loop_ms": loop_ms, "operations": flops,
            "operations_as_written": written,
            "as_written_ms": written / PEAK_FLOPS["float32"] * 1e3,
            "shape": f"N={n} M={N_MEMBERS} C={c} n={N_ALEATORIC} f32 "
                     "strided views, philox"}


def time_k1b(launches):
    """K1b's dx at the training path's largest conv, expand_1_1 (B 8,
    64^3, G 1, 16 -> 8 channels, leaky epilogue, bf16): the activation
    fold and K1 on the flipped weight, through the autograd Function
    with only x needing a gradient; beside its plain version (autograd
    through conv3d_fused_reference), cuDNN's input gradient
    (aten.convolution_backward) after the same fold, and, for the
    record, cuDNN's weight gradient at the same conv (the dW that K1b
    leaves to the library)."""
    import torch
    from values_tpu_torch.ops.kernels.conv3d import conv3d_fused_train
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    b, cin, cout = TRAIN_BATCH, 2 * FILTERS, FILTERS
    x, weight, bias, _, _ = k1_inputs(gen, torch.bfloat16, b, PATCH, PATCH,
                                      PATCH, 1, cin, 0, cout, False)
    dy = torch.randn((b, PATCH, PATCH, PATCH, cout), generator=gen,
                     device="cuda").to(torch.bfloat16)
    x = x.requires_grad_(True)
    graphs = {name: fn(x, weight, bias, 1, activation="leaky")
              for name, fn in (("kernel", conv3d_fused_train),
                               ("plain", plain_train_conv))}

    def dx(name):
        return torch.autograd.grad(graphs[name], x, dy, retain_graph=True)[0]

    got, want = dx("kernel").float(), dx("plain").float()
    err = float((got - want).abs().max())
    rtol, atol_rel = K1B_TOL["bfloat16"]
    if bool(((got - want).abs() > atol_rel * float(want.abs().max())
             + rtol * want.abs()).any()):
        raise AssertionError(f"K1b dx at expand_1_1: max_abs_err {err}")
    y = graphs["kernel"].detach()
    views = dict(x=x.detach().permute(0, 4, 1, 2, 3),
                 w=weight.permute(4, 3, 0, 1, 2))

    def library(mask):
        g = torch.where(y > 0, dy, 0.01 * dy).permute(0, 4, 1, 2, 3)
        return torch.ops.aten.convolution_backward(
            g, views["x"], views["w"], None, [1, 1, 1], [1, 1, 1], [1, 1, 1],
            False, [0, 0, 0], 1, mask)

    ms = cuda_ms(lambda: dx("kernel"))
    plain_ms = cuda_ms(lambda: dx("plain"), reps=5)
    library_ms = cuda_ms(lambda: library([True, False, False]))
    dw_library_ms = cuda_ms(lambda: library([False, True, False]))
    vox = b * PATCH ** 3
    # read dy and the saved output, write dx; the weight once
    bytes_moved = 2 * vox * (cout + cout + cin) + 2 * weight.numel()
    flops = 2 * vox * 27 * cin * cout
    bound_ms, bound_by = bound(bytes_moved, flops, "bfloat16")
    return {"name": "conv3d_fused_train", "route": "cuda",
            "source": "values_tpu_torch/ops/kernels/conv3d.py",
            "replaces": "values_tpu/ops/pallas/conv3d.py:906",
            "launches": launches["conv3d_fused_train"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "dw_library_ms": dw_library_ms,
            "shape": f"dx of expand_1_1 B={b} {PATCH}^3 G=1 Cin={cin} "
                     f"Cout={cout} bf16, leaky fold + K1 on the flipped "
                     "weight"}


def time_training(exp32, state32, batch, root: str, card: str):
    """Milliseconds per training step and volumes trained per second at
    batch 8, f32 (with TF32 off and on) and bf16: host clock around
    TIMED_STEPS steps ending in a synchronize, after 2 warm-up steps, the
    batch already on the card; peak device memory of a step; and a
    profile of one step of each, split into K1 forward (from a profile of
    the forward alone), K1 dx, the dW library call
    (aten::convolution_backward), the rest (norms, losses, optimizer,
    casts) and idle."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from values_tpu_torch.config import compose
    from values_tpu_torch.training.experiment import Experiment
    from values_tpu_torch.training.main import DEFAULT_CONFIG_DIR
    cfg16 = compose(DEFAULT_CONFIG_DIR, "softmax_config",
                    training_overrides(root, "timing") + ["+precision=bf16"])
    exp16 = Experiment(cfg16, "cuda")
    # f32 with TF32 off (this script's setting, exact float32) and on
    # (PyTorch's default for cuDNN convolutions, so the dW library call's)
    runs = {"f32": (exp32, state32, False),
            "f32, TF32 dW": (exp32, state32, True),
            "bf16": (exp16, exp16.init_state(cfg16.seed, PATCH), False)}
    result = {}
    for name, (exp, state, tf32) in runs.items():
        torch.backends.cudnn.allow_tf32 = tf32
        for _ in range(2):
            exp.train_step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            _, loss = exp.train_step(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if not bool(torch.isfinite(loss)):
            raise AssertionError(f"{name} training loss {loss}")

        def device_times(fn):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            table = prof.key_averages()
            kernels = [e for e in table if "CUDA" in str(e.device_type)
                       and e.self_device_time_total > 0]
            k1 = sum(e.self_device_time_total for e in kernels
                     if "conv3d_fused" in e.key) / 1e3
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            dw = sum(e.device_time_total for e in table
                     if e.key == "aten::convolution_backward") / 1e3
            return table, wall, busy, k1, dw

        def forward():
            with torch.no_grad():
                exp.loss(state.params, batch)

        _, _, _, k1_fwd, _ = device_times(forward)
        table, wall, busy, k1, dw = device_times(
            lambda: exp.train_step(state, batch))
        torch.backends.cudnn.allow_tf32 = False
        tag = name.replace(", TF32 dW", "_tf32")
        with open(os.path.join(OUT_DIR, f"profile_train_step_{tag}.txt"),
                  "w") as fh:
            fh.write(table.table(sort_by="self_device_time_total",
                                 row_limit=40))
        result[name] = {"step_ms": step_ms,
                        "volumes_per_s": TRAIN_BATCH / step_ms * 1e3,
                        "peak_gb": peak_gb, "wall_ms": wall,
                        "busy_ms": busy, "k1_forward_ms": k1_fwd,
                        "k1_dx_ms": k1 - k1_fwd, "dw_ms": dw,
                        "other_ms": busy - k1 - dw}
        r = result[name]
        if not busy:
            log(f"training step {name}: no device time recorded (profile "
                "not measured)")
        log(f"training step {name}, batch {TRAIN_BATCH} x {PATCH}^3: "
            f"{step_ms:.2f} ms, {r['volumes_per_s']:.2f} volumes/s, peak "
            f"{peak_gb:.2f} GB; profile of one step (profiler on): device "
            f"{busy:.2f} of {wall:.2f} ms wall, idle share "
            f"{1 - busy / wall:.3f}; K1 forward {k1_fwd:.2f} ms, K1 dx "
            f"{k1 - k1_fwd:.2f} ms, dW (cuDNN) {dw:.2f} ms, the rest "
            f"{busy - k1 - dw:.2f} ms; card {card}")
    return result


def time_k1_layers(grouped, vols):
    """K1 at each of the path's 18 convs, in one bf16 forward at the
    path's batch: CUDA events around each call, beside each conv's bound.
    Written to build/chip_smoke/k1_layers.json."""
    import torch
    from values_tpu_torch.models import ensemble_unet3d as ens
    real, calls = ens.conv3d_fused, []

    def timed(x, weight, bias, groups, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(x, weight, bias, groups, **kw)
        end.record()
        x2 = kw.get("x2")
        calls.append((tuple(x.shape), 0 if x2 is None else x2.shape[-1],
                      tuple(weight.shape), kw.get("prologue") is not None,
                      kw.get("activation", "none"),
                      kw.get("emit_stats", False), start, end))
        return out

    weights = ens.cast_weights(grouped, torch.bfloat16, vols.device)
    ens.conv3d_fused = timed
    try:
        with torch.no_grad():
            for _ in range(2):   # the first forward warms up
                calls.clear()
                ens.grouped_forward_fused(weights, vols.to(torch.bfloat16),
                                          N_MEMBERS)
                torch.cuda.synchronize()
    finally:
        ens.conv3d_fused = real
    rows = []
    for xs, c2, ws, pro, act, stats, start, end in calls:
        b, d, h, w, c1 = xs
        vox, cin, gcout = b * d * h * w, ws[3], ws[4]
        bytes_moved = 2 * vox * (c1 + c2 + gcout) + 2 * 27 * cin * gcout
        flops = 2 * vox * 27 * cin * gcout
        bound_ms, bound_by = bound(bytes_moved, flops, "bfloat16")
        rows.append({"x": list(xs), "cin_per_group": cin,
                     "cout_per_group": gcout // N_MEMBERS, "x2": c2 > 0,
                     "prologue": pro, "activation": act, "stats": stats,
                     "ms": start.elapsed_time(end), "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "tflops": flops / start.elapsed_time(end) / 1e9})
    total = sum(r["ms"] for r in rows)
    log(f"K1 per conv (bf16, batch {vols.shape[0]}): {len(rows)} convs, "
        f"{total:.2f} ms, bound {sum(r['bound_ms'] for r in rows):.3f} ms")
    for r in rows:
        log(f"  {'x'.join(map(str, r['x'][1:4])):>8s} cin {r['cin_per_group']:3d}"
            f" cout {r['cout_per_group']:3d}: {r['ms']:8.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}), "
            f"{r['tflops']:.1f} TFLOP/s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "k1_layers.json"), "w") as fh:
        json.dump(rows, fh, indent=1)


def profile_batch(score, args, label: str, filename: str):
    """Device time of one batch, ``score(*args)``, by kernel, from
    torch.profiler; the table is written to build/chip_smoke/<filename>."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    score(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        score(*args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    table = prof.key_averages()
    kernels = [e for e in table if "CUDA" in str(e.device_type)
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, filename), "w") as fh:
        fh.write(table.table(sort_by="self_device_time_total",
                             row_limit=40))
    if not busy:
        log(f"profile {label}: no device time recorded (not measured)")
        return
    log(f"profile of one {label} batch ({BATCH} volumes): device kernels "
        f"{busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall, idle share "
        f"{1 - busy / wall_us:.3f} (profiler on)")
    for e in kernels[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
            f"{100 * e.self_device_time_total / busy:5.1f}%  "
            f"x{e.count:<4d} {e.key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from values_tpu_torch.inference.scoring import (make_aleatoric_scorer,
                                                    make_scorer)
    from values_tpu_torch.ops.kernels import conv3d, entropy, sampling

    # float32 references run in full float32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; cards visible {torch.cuda.device_count()}, "
        "this run uses 1")
    log(smi)

    with phase("build", smi):
        t0 = time.perf_counter()
        conv3d.load_kernel()
        t1 = time.perf_counter()
        entropy.fused_entropy(torch.full((2, 2, 256), 0.5, device="cuda"))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        half = torch.full((256, 2, 2), 0.5, device="cuda")
        sampling.sampled_softmax_stats(half, half, 0, n_samples=1)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        log(f"build: K1 nvcc {t1 - t0:.1f} s, K2 triton JIT {t2 - t1:.1f} s, "
            f"K3 triton JIT {t3 - t2:.1f} s; card {smi}")

    with phase("K1 check", smi):
        check_k1()
    with phase("K2 check", smi):
        check_k2()
    with phase("K3 check", smi):
        check_k3()
    with phase("K1b check", smi):
        check_k1b()
    with phase("deterministic path", smi):
        launches, vps, (vols, gt), grouped = main_path(smi)
    with phase("aleatoric path", smi):
        a_launches, a_vps, (a_vols, a_gt), a_grouped = aleatoric_path(smi)
    with phase("score CLI", smi):
        cli_path(smi)
    with phase("training CLI", smi):
        train_root, train_runs, _ = training_path(smi)
        exp32, state32, train_batch = first_step_against_plain(train_root,
                                                               smi)
    with phase("kernel timings", smi):
        kernels = [time_k1(launches, vols.shape[0]),
                   time_k1b(train_runs["f32"][2]),
                   time_k2(launches, grouped, vols),
                   time_k3(a_launches, a_grouped, a_vols)]
        for k in kernels:
            extra = (f", stock-torch loop {k['loop_ms']:.3f} ms; "
                     f"{k['operations'] / 1e9:.2f} G operations needed, "
                     f"{k['operations_as_written'] / 1e9:.2f} G as the "
                     f"kernel is written ({k['as_written_ms']:.3f} ms at "
                     "the f32 peak)" if "loop_ms" in k else "")
            if "dw_library_ms" in k:
                extra = (f"; dW at the same conv (cuDNN weight gradient) "
                         f"{k['dw_library_ms']:.3f} ms")
            log(f"{k['name']} [{k['shape']}]: {k['ms']:.3f} ms, bound "
                f"{k['bound_ms']:.3f} ms ({k['bound_by']}), plain "
                f"{k['plain_ms']:.3f} ms, library {k['library_ms']} ms"
                f"{extra}; launches {k['launches']}; card {smi}")
    with phase("training timings and profiles", smi):
        training = time_training(exp32, state32, train_batch, train_root,
                                 smi)
        shutil.rmtree(train_root)
    with phase("throughput and profiles", smi):
        for b in (16, 128):
            throughput(grouped, smi, b)
        time_k1_layers(grouped, vols)
        score, _ = make_scorer(N_MEMBERS, PATCH, agg_patch=AGG_PATCH,
                               threshold=THRESHOLD, dtype=torch.bfloat16)
        profile_batch(score, (grouped, vols, gt), "deterministic",
                      "profile_main_path.txt")
        a_score, _ = make_aleatoric_scorer(
            N_MEMBERS, PATCH, n_aleatoric_samples=N_ALEATORIC,
            agg_patch=AGG_PATCH, threshold=THRESHOLD, dtype=torch.bfloat16)
        profile_batch(a_score, (a_grouped, a_vols, a_gt, 9), "aleatoric",
                      "profile_aleatoric_path.txt")
    log(f"headline: {vps:.2f} volumes/s deterministic, {a_vps:.2f} "
        f"volumes/s aleatoric ({N_ALEATORIC} samples) (ensemble-{N_MEMBERS},"
        f" {PATCH}^3, bf16, batch {BATCH}); training "
        f"{training['f32']['volumes_per_s']:.2f} volumes/s f32, "
        f"{training['bf16']['volumes_per_s']:.2f} bf16 (UNet3D, "
        f"{PATCH}^3, batch {TRAIN_BATCH}); card {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    # the run drives one card, whatever else the machine shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
