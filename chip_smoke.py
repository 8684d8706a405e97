#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (values_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. describe the card (name and power limit from nvidia-smi);
2. build the kernels: K1 (CUDA C++, nvcc) and K2 (Triton JIT);
3. hold K1 against its plain PyTorch version on the card, in float32
   and bfloat16, over every fusion the main path uses;
4. hold K2 against its plain version, on a stack with exact zeros;
5. run the main path at full width -- the 5-member UNet3D ensemble
   (2 classes, initial filter size 8) scoring batches of 32 64^3 volumes
   through ``make_scorer`` -- count each kernel's launches in that run,
   time it, and hold a 2-volume float32 run against the plain path
   (per-member UNet3D modules, plain statistics) on the card;
6. time each kernel at its main-path shape beside its bound, its plain
   version and a library yardstick, and break one batch down by device
   kernel with torch.profiler.

Prints a ``{"kernels": [...]}`` JSON line and ends with
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or outside the repository.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N_MEMBERS, PATCH, CLASSES, FILTERS = 5, 64, 2, 8
BATCH, N_BATCHES, SEED = 32, 3, 0
AGG_PATCH, THRESHOLD = 10, 0.3

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core and
# float32 CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# the per-conv table and the profiler's table, too long for the log
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "build", "chip_smoke")


def log(msg: str) -> None:
    print(msg, flush=True)


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


# -- the main path ------------------------------------------------------------

def member_state_dicts(seed: int):
    """Per-member UNet3D state_dicts, drawn with numpy from ``seed`` at
    each parameter's fan-in scale (torch's default init range)."""
    import torch
    from values_tpu_torch.models.unet3d import UNet3D
    rs = np.random.RandomState(seed)
    states = []
    for _ in range(N_MEMBERS):
        ref = UNet3D(CLASSES, initial_filter_size=FILTERS).state_dict()
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
    from values_tpu_torch.ops.kernels.conv3d import conv3d_fused
    from values_tpu_torch.ops.kernels.entropy import fused_entropy

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

    conv3d_fused.launches = 0
    fused_entropy.launches = 0
    t0 = time.perf_counter()
    outs = [score(grouped, *b) for b in batches[1:]]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"conv3d_fused": conv3d_fused.launches,
                "fused_entropy": fused_entropy.launches}

    if launches["conv3d_fused"] != 18 * N_BATCHES:
        raise AssertionError(f"K1 launched {launches['conv3d_fused']} "
                             f"times in {N_BATCHES} forwards, not 18 each")
    if launches["fused_entropy"] != N_BATCHES:
        raise AssertionError(f"K2 launched {launches['fused_entropy']} "
                             f"times in {N_BATCHES} batches, not 1 each")
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


def profile_batch(grouped, vols, gt):
    """Device time of one main-path batch by kernel, from torch.profiler,
    written to build/chip_smoke/profile_main_path.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from values_tpu_torch.inference.scoring import make_scorer
    score, _ = make_scorer(N_MEMBERS, PATCH, agg_patch=AGG_PATCH,
                           threshold=THRESHOLD, dtype=torch.bfloat16)
    score(grouped, vols, gt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        score(grouped, vols, gt)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    table = prof.key_averages()
    kernels = [e for e in table if "CUDA" in str(e.device_type)
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_main_path.txt"), "w") as fh:
        fh.write(table.table(sort_by="self_device_time_total",
                             row_limit=40))
    if not busy:
        log("profile: no device time recorded (not measured)")
        return
    log(f"profile of one batch ({BATCH} volumes): device kernels "
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
    from values_tpu_torch.ops.kernels import conv3d, entropy

    # float32 references run in full float32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    log(smi)

    t0 = time.perf_counter()
    conv3d.load_kernel()
    t1 = time.perf_counter()
    entropy.fused_entropy(torch.full((2, 2, 256), 0.5, device="cuda"))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"build: K1 nvcc {t1 - t0:.1f} s, K2 triton JIT {t2 - t1:.1f} s")

    check_k1()
    check_k2()
    launches, vps, (vols, gt), grouped = main_path(smi)
    kernels = [time_k1(launches, vols.shape[0]),
               time_k2(launches, grouped, vols)]
    for k in kernels:
        log(f"{k['name']} [{k['shape']}]: {k['ms']:.3f} ms, bound "
            f"{k['bound_ms']:.3f} ms ({k['bound_by']}), plain "
            f"{k['plain_ms']:.3f} ms, library {k['library_ms']} ms; "
            f"card {smi}")
    for b in (16, 128):
        throughput(grouped, smi, b)
    time_k1_layers(grouped, vols)
    profile_batch(grouped, vols, gt)
    log(f"headline: {vps:.2f} volumes/s (ensemble-{N_MEMBERS}, "
        f"{PATCH}^3, bf16, batch {BATCH}); card {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
