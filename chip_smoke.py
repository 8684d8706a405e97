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
6. run the deterministic path at full width -- the 5-member UNet3D
   ensemble (2 classes, initial filter size 8) scoring batches of 32
   64^3 volumes through ``make_scorer`` -- count each kernel's launches
   in that run, time it, and hold a 2-volume float32 run against the
   plain path (per-member UNet3D modules, plain statistics) on the card;
7. the same for the aleatoric path: 5 aleatoric members, 10 logit
   samples each, through ``make_aleatoric_scorer`` (K1 + K3);
8. the ``score`` CLI over 64 LIDC-style volumes for a deterministic and
   an aleatoric set of 5 reference-format checkpoints;
9. time each kernel at its path's shape beside its bound, its plain
   version and a library yardstick (K3: the stock-torch sampling loop),
   and break one batch of each path down by device kernel with
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


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from values_tpu_torch.ops.kernels.conv3d import conv3d_fused
    from values_tpu_torch.ops.kernels.entropy import fused_entropy
    from values_tpu_torch.ops.kernels.sampling import sampled_softmax_stats
    for wrapper in (conv3d_fused, fused_entropy, sampled_softmax_stats):
        wrapper.launches = 0


def read_launches() -> dict:
    from values_tpu_torch.ops.kernels.conv3d import conv3d_fused
    from values_tpu_torch.ops.kernels.entropy import fused_entropy
    from values_tpu_torch.ops.kernels.sampling import sampled_softmax_stats
    return {"conv3d_fused": conv3d_fused.launches,
            "fused_entropy": fused_entropy.launches,
            "sampled_softmax_stats": sampled_softmax_stats.launches}


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
                          "fused_entropy": n_batches,
                          "sampled_softmax_stats": 0},
        "aleatoric": {"conv3d_fused": 18 * n_batches, "fused_entropy": 0,
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
    with phase("deterministic path", smi):
        launches, vps, (vols, gt), grouped = main_path(smi)
    with phase("aleatoric path", smi):
        a_launches, a_vps, (a_vols, a_gt), a_grouped = aleatoric_path(smi)
    with phase("score CLI", smi):
        cli_path(smi)
    with phase("kernel timings", smi):
        kernels = [time_k1(launches, vols.shape[0]),
                   time_k2(launches, grouped, vols),
                   time_k3(a_launches, a_grouped, a_vols)]
        for k in kernels:
            extra = (f", stock-torch loop {k['loop_ms']:.3f} ms; "
                     f"{k['operations'] / 1e9:.2f} G operations needed, "
                     f"{k['operations_as_written'] / 1e9:.2f} G as the "
                     f"kernel is written ({k['as_written_ms']:.3f} ms at "
                     "the f32 peak)" if "loop_ms" in k else "")
            log(f"{k['name']} [{k['shape']}]: {k['ms']:.3f} ms, bound "
                f"{k['bound_ms']:.3f} ms ({k['bound_by']}), plain "
                f"{k['plain_ms']:.3f} ms, library {k['library_ms']} ms"
                f"{extra}; launches {k['launches']}; card {smi}")
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
        f" {PATCH}^3, bf16, batch {BATCH}); card {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    # the run drives one card, whatever else the machine shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
