#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (values_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. describe the card (name and power limit from nvidia-smi);
2. build the kernels, all CUDA C++ with nvcc, the two libraries in
   parallel: K1, and K2 with K3; read each nvcc log (no register
   spills), and where the toolkit has cuobjdump count the tensor-core
   instructions (HMMA) in each of K1's tensor-core kernels (bf16 and
   tf32x3, forward and dx) and the
   SFU (MUFU) and integer multiply-add (IMAD) instructions of K3's
   kernel on the aleatoric path;
3. hold K1 against its plain PyTorch version on the card, in float32
   and bfloat16, over every fusion the main path uses and every regime
   of ``conv3d.plan`` (each case checks that its regime launched), and
   over all 18 convs of the AL loop's test_3d (B = 1, G = 2 and 1), and
   over bfloat16 channel counts it runs zero-padded (Cin 4, 12, 6+6, 1,
   96+96; Cout 6, 12, 96);
4. hold K2 against its plain version: the probability form on a stack
   with exact zeros (contiguous and channels-last), the logits form in
   float32 and bfloat16; and its streaming regime (more than 16 classes,
   or more than 454 bytes of samples a voxel) at S 5, C 24 (bf16
   logits) and S 80, C 2 (f32 probabilities);
5. hold K3 against its plain version in both bit modes (the bits
   exactly; the sums within tolerance in the sigma form, the log_var
   form and in bfloat16; sigma = 0 exactly softmax) at 2, 3 and 12
   classes (the last its shared-memory kernel), and that kernel at 5
   members, 12 classes, 10 samples over 32 volumes of 64^3;
5b. hold K1b (K1's autograd Function, its dx one launch of the dx
   entry) against autograd through K1's plain version: dx, dW and db,
   f32 and bf16, with statistics and with the leaky and ReLU epilogues,
   at G = 1, 2 and 5 (the joint ensemble step's groups), and at bf16
   shapes it runs zero-padded (forward Cin 4, 6, 12; Cout 6, 12); then
   one bf16 ``softmax_config`` training step at ``initial_filter_size``
   12 (every conv padded) against the f32 step;
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
8c. joint deep-ensemble training (``EnsembleTrainer``, 5 members as
   channel groups, each with its own seeded stream) on ``softmax_config``
   at its published widths over the same ``Case_1``, 3 steps at f32 and
   3 at bf16, with 18 K1 and 17 K1b-dx launches at G = 5 counted per
   step; the first f32 step held against 5 independent ``Experiment``
   steps; the 5 members written as checkpoints;
8d. the sliding-window ``test_3d`` CLI on those checkpoints at f32 and
   bf16: the ``Case_1`` validation split (64^3, one window a volume) and
   2 volumes of 128^3 (8 windows each) at ``--test_batch_size 3``; each
   output tree checked file by file, 18 K1 launches counted per chunk,
   the 128^3 f32 run held against the plain path (per-member UNet3D
   modules through the same windowing and carrier);
8e. ``SlidingWindowEngine`` with the aleatoric members of phase 7 over 2
   of the 128^3 volumes at f32, held against the plain path given the same
   normals; the engine's windows and volumes per second at f32 and bf16
   over all 4,
   and a profile of one 12-window chunk;
8f. the MC-dropout path: 5 dropout members (random weights) through
   ``make_dropout_scorer`` with 10 passes a batch of 32 (18 K1 launches a
   pass, K1's unfused form: statistics without prologue at the norm
   convs), timed over 5 batches (median, min, max), peak memory, one
   batch profiled, a 2-volume float32 run held against per-member plain
   UNet3D modules given the same masks; one dropout pass timed beside
   one fused forward (the cost of breaking the fusion at 17 sites);
8g. the TTA path: the deterministic path's members through
   ``make_tta_scorer`` (16 fused forwards a batch, 16 x 18 K1 launches),
   as 8f, the plain path on the same flipped and noisy inputs;
8h. the SSN path: 5 SSN members (rank 10) through ``make_ssn_scorer``
   with 10 samples each (one trunk forward, 18 K1 launches a batch), as
   8f, the plain path per-member SsnUNet3D modules given the same
   normals; and the degenerate fallback on the card (cov_diag ~0 with a
   huge factor: every member flagged, finite scores);
8i. the score CLI over the 64 LIDC-style volumes: the dropout set with
   ``--n_pred 10``, ``-tta`` on the deterministic set and on the dropout
   set, and the SSN set; launches counted, each JSON against its scorer;
8j. the test_3d CLI on the Case_1 validation split at f32: ``-tta`` on
   the members of 8c over 2 of its volumes, ``--n_pred 4`` on a dropout
   checkpoint and on one SSN checkpoint, each tree checked file by file
   and its launches
   counted; the engine's windows/s under ``-tta``;
8k. dropout and SSN training at the published widths of
   ``dropout_config`` and ``ssn_config`` over a Case_1 made by the
   port's toy generator (24 + 2 volumes of 64^3): the training CLI on
   each at f32 and bf16 (the SSN 2 epochs, the first pretraining), 35 K1
   launches a step (17 of them K1b's dx) and 18 a validation forward
   counted; the f32 first dropout step and the first SSN pretraining and
   sampling steps against the plain path given the same masks and
   normals; the unused SSN factor head moved by Adam as optax moves it;
   joint MC-dropout training at G = 5 (3 steps at f32 and bf16, the
   first f32 step against 5 Experiment steps given the same masks); the
   trained dropout and SSN checkpoints through the score CLI;
   ``softmax_config_lidc`` for one epoch on a synthetic LIDC tree (the
   datamodule makes its own splits from id_ood.csv) and ``augment=True``
   for one epoch on Case_1; each step timed (median and spread), its
   peak memory and one profiled step (device time, idle share, top
   device ops); its launches join the kernels line;
8l. the evaluation test beds and the active-learning loop at the widths
   of ``softmax_config_lidc`` and ``eval_config_lidc`` (bf16): a
   synthetic 60-nodule LIDC tree; the first cycle (2 seeds, one epoch
   each, through the training CLI; test_3d on their Ensemble and on
   Softmax over val, id, ood and unlabeled; the same runs over val in
   float32 held against the plain path); the 8 evaluation tasks
   (threshold, aggregation, OoD detection, failure detection,
   calibration, ambiguity modeling, both split generators), each timed
   with its patch aggregations and Platt fits, their JSONs and split
   files checked, the aggregation once more with the box filter on the
   card held against the host's float64 path; the
   second cycle (``al_driver``'s dry run, then the 5 runs that
   al_improvement reads through ``al_driver``, each with its test_3d over
   ood moved into al_improvement's layout) and al_improvement; every
   run's launches counted, the steps timed; its launches join the
   kernels line;
8m. then the 2D path (HRNet-W48 through ``test_2d``) and
   GTA's training half (``gta_training_path``): raw GTA5 (1914x1052)
   and Cityscapes (2048x1024) PNGs written by the script with every PNG
   filter and one palette file, preprocessed and split through the
   port's CLI and held against the script's own crop and resize; the
   training CLI on ``gta_softmax_config`` (2 epochs, 2 seeds),
   ``gta_ssn_config`` (the first epoch mean-only), DROPOUT_FINAL and
   bf16 at HRNet-W48's published widths; training steps timed and
   profiled (f32 under the default and with TF32 off, bf16); the first
   step on the card against the CPU's in float64 and float32, and TF32
   against off; ``test_2d`` on the trained checkpoints (5 families, 4
   splits) and ``eval_config_gta``'s six tasks, each timed; no launch
   of K1-K3, and the SSN's runs launch SSN-C and SSN-S
   (``ops/kernels/ssn_sample.py``) once a batch, counted; between the
   two, SSN-C and SSN-S at the 2D SSN's shape (B 6, C 24, 256x478, R
   10, S 10) against a float64 composition, timed against their bytes
   (``time_ssn_sample``), join the kernels line;
8n. "reporting" (host only, ``evaluation/visualization``): the table CLI
   on ``table_config_lidc`` over the first cycle that 8l evaluated and on
   ``table_config_gta`` over the tree that 8m evaluated, each cut to its
   shift, seed and models and to the tasks its phase wrote, every mean
   cell held against the task JSONs it reads (1e-12); ``run_plots`` on
   ``plot_config`` cut the same way, every SVG parsed with one bar per
   (group, dataset); no pandas, matplotlib or seaborn imported and no
   launch of K1-K3;
8o. last, "data parallel": 2 ranks spawned on card 0 over gloo (NCCL
   refuses two ranks on one card), each running a data-parallel
   ``softmax_config`` step at f32 and bf16 (published widths, a global
   batch of 8, 4 rows a rank), the sharded deterministic and aleatoric
   scorers (5 members, 32 volumes, 16 a rank) and the engine's window
   (5 members) and TTA sample (one member's 16 variants) strategies on
   a 128^3 volume; each rank's K1, K1b, K2 and K3 launches counted (each
   must launch); each result held against rank 0's single-rank run of
   the same inputs (the step: loss and every averaged gradient); then a
   1-rank NCCL world in the script's process: the data-parallel step,
   whose bucket and loss go through NCCL's all-reduce, against the plain
   one, and that all-reduce call alone (one card: no bytes between
   cards);
9. time each kernel at its path's shape beside its bound, its plain
   version and a library yardstick (K3: the stock-torch sampling loop,
   and its SFU floor, computed at the card's maximum SM clock, and its
   shared-memory kernel at 12 classes; K2: both forms, and its streaming
   regime at the two shapes of phase 4; K1b: the dx entry in bf16 and f32 against cuDNN's input
   gradient after the same fold, device time under the profiler and
   host clock), time and profile a training step (17 launches of the dx
   entry, no weight flip), time K1's f32 regime (tf32x3) at the test_3d
   chunk's largest conv beside its three bounds, time
   K1 at each of the 18 convs (with its regime) and its shallow and
   tile16 kernels against each other where plan() chooses between them,
   and break one batch of each scoring path down by device kernel with
   torch.profiler, checking that no cast, exp, softmax, division, copy
   or clone runs over the logits or the head outside K2 and K3; K2 and K3
   are also timed by device time (10 calls queued behind a spin kernel),
   and each profiled batch and step logs its kernel records against the
   launches the host made in it (a shortfall marks its totals
   unchecked).

Prints a ``{"kernels": [...]}`` JSON line and ends with
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or outside the repository.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

N_MEMBERS, PATCH, CLASSES, FILTERS = 5, 64, 2, 8
TRAIN_BATCH = 8           # the training CLI's batch (softmax_config)
BATCH, N_BATCHES, SEED = 32, 3, 0
AGG_PATCH, THRESHOLD = 10, 0.3
N_ALEATORIC = 10          # logit samples per member (the reference's default)
# MC-dropout passes and SSN samples per member; the SSN's rank
# (configs/model/ssn_unet3D_config.yaml); timed runs of each stochastic path
N_PRED, SSN_RANK, TIMED_RUNS = 10, 10, 5
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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}

# the script's start, for its total time
T_START = time.perf_counter()

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
    from values_tpu_torch.ops.kernels import ssn_sample
    from values_tpu_torch.ops.kernels.conv3d import (conv3d_fused,
                                                     conv3d_fused_dx,
                                                     conv3d_fused_train)
    from values_tpu_torch.ops.kernels.entropy import fused_entropy
    from values_tpu_torch.ops.kernels.sampling import sampled_softmax_stats
    return {"conv3d_fused": conv3d_fused,
            "conv3d_fused_train": conv3d_fused_train,
            "conv3d_fused_dx": conv3d_fused_dx,
            "fused_entropy": fused_entropy,
            "sampled_softmax_stats": sampled_softmax_stats,
            "ssn_capacitance": ssn_sample.capacitance,
            "ssn_sample_softmax": ssn_sample.sample_softmax}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def read_launches() -> dict:
    """K1's count holds every launch of K1's kernels, K1b's dx entry's
    included; conv3d_fused_train's holds K1b's dx launches and
    conv3d_fused_dx's the dx entry's launches; ssn_capacitance's and
    ssn_sample_softmax's count their wrappers' calls (SSN-C's two kernels,
    SSN-S's one)."""
    return {name: w.launches for name, w in _wrappers().items()}


def expect_launches(launches: dict, want: dict, what: str) -> None:
    """The counts must be ``want``'s; every K1b dx is one launch of the dx
    entry, so where ``want`` names no count for the entry it is K1b's; a
    kernel ``want`` does not name must not have launched."""
    want = dict(want)
    want.setdefault("conv3d_fused_dx", want.get("conv3d_fused_train", 0))
    for name in launches:
        want.setdefault(name, 0)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")


def regimes_since(before: dict) -> dict:
    """K1's launches by regime since the ``regime_launches`` ``before``."""
    from values_tpu_torch.ops.kernels.conv3d import conv3d_fused
    return {k: v - before[k] for k, v in conv3d_fused.regime_launches.items()
            if v != before[k]}


F32_REGIMES = {"f32", "tf32x3"}


def expect_f32_regime(ran: dict, f32: bool, what: str) -> None:
    """A float32 run launches K1's float32 regimes only (``tf32x3`` and,
    for Cin 1, ``f32``), a bfloat16 run never."""
    bad = set(ran) - F32_REGIMES if f32 else set(ran) & F32_REGIMES
    if bad or (f32 and not ran):
        raise AssertionError(f"{what}: K1 regimes {ran}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2, inner: int = 1) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds; with ``inner``
    > 1, each sample times that many calls back to back and divides, so
    that a kernel shorter than its wrapper's host time is timed as the
    card runs it, not as the host feeds it."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def queued_ms(fn, calls: int = 10, reps: int = 7) -> float:
    """Device ms of one call of ``fn``: CUDA events around ``calls``
    back-to-back calls, enqueued behind a 25 ms spin kernel
    (``torch.cuda._sleep``) so that the card runs them one after another
    without waiting for the host; the median of ``reps`` samples, over
    ``calls``. For calls shorter than the host's work around them, which
    ``cuda_ms`` would time on the host's pace."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # cycles: 25 ms at 1980 MHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuDNN's TF32 switch (PyTorch's default: on) for the block."""
    import torch
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev



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


# (name, B, D, H, W, G, Cin1, Cin2, Cout, prologue, activation, stats,
#  the bf16 regime of conv3d.plan; float32 runs the regime plan gives it,
#  "tf32x3" but at Cin 1)
K1_CASES = [
    ("plain", 2, 16, 16, 16, 5, 8, 0, 8, False, "none", False, "shallow"),
    ("ragged tiles", 2, 20, 12, 28, 5, 8, 0, 8, False, "none", False,
     "shallow"),
    ("x2 concat", 2, 16, 16, 16, 5, 8, 8, 8, False, "none", False, "shallow"),
    ("prologue slopes 1/0.01/0", 2, 16, 16, 16, 5, 8, 0, 16, True,
     "none", False, "shallow"),
    ("relu epilogue", 2, 16, 16, 16, 5, 8, 0, 8, False, "relu", False,
     "shallow"),
    ("leaky epilogue, x2 + prologue", 2, 16, 16, 16, 5, 8, 8, 8, True,
     "leaky", False, "shallow"),
    ("emit_stats + prologue", 2, 16, 16, 16, 5, 16, 0, 32, True, "none",
     True, "tile16"),
    ("Cin=1, G=5, stats", 2, 16, 16, 16, 5, 1, 0, 8, False, "none", True,
     "cin1"),
    ("center 4^3, 64->128, relu", 2, 4, 4, 4, 5, 64, 0, 128, True,
     "relu", False, "tile4"),
    ("expand_4_1 8^3, 64+64->64", 2, 8, 8, 8, 5, 64, 64, 64, True,
     "leaky", False, "tile8"),
    ("full width 64^3, G=5, 8->8, stats", 2, 64, 64, 64, 5, 8, 0, 8, True,
     "none", True, "shallow"),
    # one per regime at the training path's and the deep levels' shapes
    ("G=1 64^3 B=8, 1->8, stats", 8, 64, 64, 64, 1, 1, 0, 8, False, "none",
     True, "cin1"),
    ("G=1 64^3 B=8, 8->16 (a dx)", 8, 64, 64, 64, 1, 8, 0, 16, False,
     "none", False, "shallow"),
    ("G=1 64^3 B=8, 16->8, leaky", 8, 64, 64, 64, 1, 16, 0, 8, False,
     "leaky", False, "shallow"),
    ("16^3 2x8x16 tile, 32+32->32", 2, 16, 16, 16, 5, 32, 32, 32, True,
     "leaky", False, "tile16"),
    ("4^3 B=32, G=5, 128->128, stats", 32, 4, 4, 4, 5, 128, 0, 128, True,
     "none", True, "tile4"),
    ("ragged 9x12x10, 64->32, stats", 2, 9, 12, 10, 5, 64, 0, 32, True,
     "none", True, "tile8"),
    ("ragged 6x7x5, 32+32->64, leaky", 2, 6, 7, 5, 5, 32, 32, 64, True,
     "leaky", False, "tile4"),
    # the MC-dropout forward's unfused form at the scorers' batch: the norm
    # convs emit statistics with no prologue, the expand convs take the
    # materialized concat with a leaky epilogue
    ("dropout B=32 64^3, 8->8, stats", 32, 64, 64, 64, 5, 8, 0, 8, False,
     "none", True, "shallow"),
    ("dropout B=32 64^3, 16->8, leaky", 32, 64, 64, 64, 5, 16, 0, 8, False,
     "leaky", False, "shallow"),
    ("dropout B=32 8^3, 32->64, stats", 32, 8, 8, 8, 5, 32, 0, 64, False,
     "none", True, "tile8"),
]
# UNet3D f 8's 18 convs at 64^3 in forward order: (D, Cin1, Cin2, Cout,
# prologue, activation, stats, the bf16 regime)
UNET3D_F8_CONVS = [
    (64, 1, 0, 8, False, "none", True, "cin1"),
    (64, 8, 0, 8, True, "none", True, "shallow"),
    (32, 8, 0, 16, True, "none", True, "shallow"),
    (32, 16, 0, 16, True, "none", True, "shallow"),
    (16, 16, 0, 32, True, "none", True, "tile16"),
    (16, 32, 0, 32, True, "none", True, "tile16"),
    (8, 32, 0, 64, True, "none", True, "tile8"),
    (8, 64, 0, 64, True, "none", True, "tile8"),
    (4, 64, 0, 128, True, "relu", False, "tile4"),
    (4, 128, 0, 128, False, "relu", False, "tile4"),
    (8, 64, 64, 64, True, "leaky", False, "tile8"),
    (8, 64, 0, 64, False, "leaky", False, "tile8"),
    (16, 32, 32, 32, True, "leaky", False, "tile16"),
    (16, 32, 0, 32, False, "leaky", False, "tile16"),
    (32, 16, 16, 16, True, "leaky", False, "tile16"),
    (32, 16, 0, 16, False, "leaky", False, "shallow"),
    (64, 8, 8, 8, True, "leaky", False, "shallow"),
    (64, 8, 0, 8, False, "leaky", False, "shallow"),
]
# F2: bfloat16 shapes no regime takes as they are, run zero-padded
# (conv3d.py::padded_channels); the regime is plan's for the padded
# shape, None here
K1_CASES += [
    ("F2 pad Cin 4 -> Cout 6", 2, 16, 16, 16, 2, 4, 0, 6, True, "leaky",
     False, None),
    ("F2 pad Cin 12 -> Cout 12, stats", 2, 16, 16, 16, 2, 12, 0, 12, True,
     "none", True, None),
    ("F2 pad Cin 6+6 -> Cout 12", 2, 16, 16, 16, 2, 6, 6, 12, True, "leaky",
     False, None),
    ("F2 pad Cin 1 -> Cout 12, stats", 2, 16, 16, 16, 1, 1, 0, 12, False,
     "none", True, None),
    ("F2 pad 8^3 Cin 12 -> Cout 6", 2, 8, 8, 8, 5, 12, 0, 6, True, "relu",
     False, None),
    # UNet3D f 12's expand_4_1: 128 + 128 after padding, whose 4x8x8 tile
    # does not fit shared memory: plan takes 4x4x4
    ("F2 pad 8^3 Cin 96+96 -> Cout 96", 8, 8, 8, 8, 1, 96, 96, 96, True,
     "leaky", False, "tile4")]
# every conv of the AL loop's test_3d: one 64^3 window a chunk (B = 1), the
# Ensemble of two members (G = 2) and Softmax (G = 1)
K1_CASES += [
    (f"AL test_3d G={g} B=1 {d}^3, {c1}+{c2}->{co}", 1, d, d, d, g, c1, c2,
     co, pro, act, stats, regime)
    for g in (2, 1)
    for d, c1, c2, co, pro, act, stats, regime in UNET3D_F8_CONVS]

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


def check_k1() -> dict:
    """Every K1 case against the plain version; returns the F2 cases'
    (bfloat16, zero-padded) max_abs_err and regime, by name."""
    import torch
    from values_tpu_torch.ops.kernels.conv3d import (conv3d_fused,
                                                     conv3d_fused_reference,
                                                     padded_channels, plan)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    padded = {}
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol_rel, stats_rtol = K1_TOL[str(dtype).split(".")[1]]
        for (name, b, d, h, w, g, cin1, cin2, cout, pro, act, stats,
             regime) in K1_CASES:
            x, weight, bias, x2, maps = k1_inputs(
                gen, dtype, b, d, h, w, g, cin1, cin2, cout, pro)
            kw = dict(x2=x2, prologue=maps, activation=act,
                      emit_stats=stats)
            if dtype == torch.float32 or regime is None:
                regime = plan(dtype, d, h, w, g, *padded_channels(
                    dtype, cin1, cin2, cout)).regime
            before = dict(conv3d_fused.regime_launches)
            got = conv3d_fused(x, weight, bias, g, **kw)
            ran = regimes_since(before)
            if ran != {regime: 1}:
                raise AssertionError(f"K1 {dtype} case {name!r}: regime "
                                     f"launches {ran}, expected {regime}")
            want = conv3d_fused_reference(x, weight, bias, g, **kw)
            torch.cuda.synchronize()
            if stats:
                (got, (gs, gq)), (want, (ws, wq)) = got, want
            err = (got.float() - want.float()).abs()
            ref = want.float().abs()
            atol = (1e-4 if dtype == torch.float32
                    else atol_rel * float(ref.max()))
            bad = int((err > atol + rtol * ref).sum())
            msg = (f"K1 {str(dtype)[6:]:8s} {regime:7s} {name:34s} "
                   f"max_abs_err {float(err.max()):.3e} (max|ref| "
                   f"{float(ref.max()):.3f})")
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
            if name.startswith("F2") and dtype == torch.bfloat16:
                padded[name] = {"regime": regime,
                                "max_abs_err": float(err.max())}
    return padded


# -- K1's build: spills and tensor-core instructions --------------------------

K1_KERNELS = ("conv3d_f32_kernel", "conv3d_cin1_kernel", "conv3d_mma_kernel",
              "conv3d_shallow_kernel")
# the tensor-core kernels: conv3d_mma_kernel's bf16 and float (tf32x3)
# instances, the shallow kernel; each forward and dx (the dx entry's
# instances take FLIP = true)
K1_TENSOR_CORE_KERNELS = ("conv3d_mma_kernel", "conv3d_shallow_kernel")
# a kernel instance of the dx entry: the last template argument, FLIP,
# true (demangled, as the profiler names it, or mangled, as cuobjdump)
DX_MARKS = (", true>", "Lb1EE")


def is_dx_kernel(name: str) -> bool:
    return (any(k in name for k in K1_KERNELS)
            and any(m in name for m in DX_MARKS))


def k1_family(name: str) -> str:
    """A K1 kernel instance's family: tensor-core kernel, element type
    (the mma kernel's float instances are tf32x3), forward or dx."""
    kind = next(k for k in K1_KERNELS if k in name)
    tf32 = kind == "conv3d_mma_kernel" and re.search(r"(ELi\d+Ef|, float,)",
                                                     name)
    return (f"{kind}{' tf32x3' if tf32 else ''}"
            f"{' dx' if is_dx_kernel(name) else ''}")


def nvcc_report(lib, what: str) -> None:
    """Read the nvcc log beside a library: every kernel without register
    spills."""
    import re
    with open(os.path.splitext(lib._name)[0] + ".log") as fh:
        log_text = fh.read()
    spills = [(int(a), int(b)) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log_text)]
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log_text)]
    log(f"{what} build: {len(regs)} kernels, registers {min(regs)}-"
        f"{max(regs)}, spills {sum(a + b for a, b in spills)} bytes")
    if not spills or any(a or b for a, b in spills):
        raise AssertionError(f"{what}'s build spills registers: {spills}")


def sass_counts(lib, opcodes) -> dict:
    """{kernel: {opcode: count, "all": instructions}} from ``cuobjdump
    -sass`` of a library; {} where the toolkit has no cuobjdump."""
    import re
    from values_tpu_torch.ops.kernels.build import _nvcc
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return {}
    sass = subprocess.run([cuobjdump, "-sass", lib._name],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            counts[name] = dict.fromkeys(opcodes + ("all",), 0)
        elif name and re.search(r"/\*[0-9a-f]{4}\*/\s+\S", line):
            counts[name]["all"] += 1
            for op in opcodes:
                counts[name][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def check_k1_build(lib) -> None:
    """K1's build: no spills; the HMMA instructions of each of K1's
    kernels, where the toolkit has cuobjdump; a tensor-core kernel
    instance with none fails, and so does a missing family (bf16 and
    tf32x3, forward and dx)."""
    nvcc_report(lib, "K1")
    counts = sass_counts(lib, ("HMMA",))
    if not counts:
        log("K1 SASS: cuobjdump not found, HMMA count not measured")
        return
    for fn, n in sorted(counts.items()):
        log(f"K1 SASS: {n['HMMA']:5d} HMMA in {fn}")
    mma = {fn: n["HMMA"] for fn, n in counts.items()
           if any(k in fn for k in K1_TENSOR_CORE_KERNELS)}
    families = {k1_family(fn) for fn in mma}
    want = {f"{k}{t}{d}" for k in K1_TENSOR_CORE_KERNELS
            for t in ((" tf32x3", "") if k == "conv3d_mma_kernel" else ("",))
            for d in ("", " dx")}
    log(f"K1 SASS: tensor-core families {sorted(families)}")
    if families != want or not all(mma.values()):
        raise AssertionError(f"K1's tensor-core kernels lack HMMA or a "
                             f"family: {mma}")


# K3's kernel on the aleatoric path: two classes, Philox, log_var, bf16
K3_PATH_KERNEL = "sampled_stats_c2_kernelILb0ELb1E13__nv_bfloat16"


def check_stats_build(lib) -> dict:
    """K2 and K3's build: no spills; the MUFU and IMAD instructions of
    K3's kernel on the aleatoric path (static counts in its SASS), where
    the toolkit has cuobjdump."""
    nvcc_report(lib, "K2 + K3")
    every = sass_counts(lib, ("MUFU", "IMAD"))
    if not every:
        log("K3 SASS: cuobjdump not found, MUFU/IMAD counts not measured")
        return {}
    counts = {fn: n for fn, n in every.items() if K3_PATH_KERNEL in fn}
    if len(counts) != 1:
        raise AssertionError(f"K3 SASS: {len(counts)} kernels match "
                             f"{K3_PATH_KERNEL}, not 1: {sorted(every)}")
    (fn, n), = counts.items()
    log(f"K3 SASS of the path's kernel: {n['MUFU']} MUFU, {n['IMAD']} IMAD "
        f"of {n['all']} instructions ({fn})")
    return n


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
    """The probability form as the JAX kernel takes it (contiguous and a
    channels-last view, exact zeros), and the logits form in float32 and
    bfloat16 (voxel-major, and sample-major as the scorer hands it over),
    each against its plain version; every layout but sample-major goes
    through the wrapper's copy (at N = 100,003 into padded rows); then the
    streaming regime at K2_STREAM_SHAPES (checking that it launched).
    Returns the worst error."""
    import torch
    from values_tpu_torch.ops.kernels.entropy import (
        fused_entropy, fused_entropy_reference)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # atol 1e-5: the kernel's float32 SFU exp and log and PyTorch's differ
    # in the last ulps, and each map sums S*C terms of magnitude <= 1/e
    worst = 0.0
    for s, c, n in ((5, 2, 1 << 20), (3, 4, 100_003)):
        stack = entropy_stack(gen, s, c, n)
        if not bool((stack == 0).any()):
            raise AssertionError("the K2 check needs exact zeros")
        logits = (torch.randn((n, s, c), generator=gen, device="cuda") * 3
                  ).permute(1, 2, 0)
        # sample-major, as the forward's grouped head leaves its logits
        by_sample = logits.permute(0, 2, 1).contiguous().permute(0, 2, 1)
        cases = {"probabilities": (stack, False),
                 "probabilities, channels-last": (
                     stack.permute(2, 0, 1).contiguous().permute(1, 2, 0),
                     False),
                 "logits f32": (logits, True),
                 "logits bf16": (logits.to(torch.bfloat16), True),
                 "logits bf16, sample-major": (
                     by_sample.to(torch.bfloat16), True)}
        errs = {}
        for name, (x, is_logits) in cases.items():
            got = fused_entropy(x, logits=is_logits)
            want = fused_entropy_reference(x, logits=is_logits)
            torch.cuda.synchronize()
            errs[name] = max(float((got[k].float() - want[k].float()).abs()
                                   .max()) for k in want)
            if not errs[name] <= 1e-5:
                raise AssertionError(f"K2 {name} at S={s} C={c}: "
                                     f"max_abs_err {errs[name]:.3e}")
        worst = max(worst, *errs.values())
        log(f"K2 S={s} C={c} N={n}: max_abs_err " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()))
    for name, (x, is_logits) in k2_stream_cases(gen).items():
        before = dict(fused_entropy.regime_launches)
        got = fused_entropy(x, logits=is_logits)
        want = fused_entropy_reference(x, logits=is_logits)
        torch.cuda.synchronize()
        if fused_entropy.regime_launches["stream"] != before["stream"] + 1:
            raise AssertionError(f"K2 {name}: the stream regime did not "
                                 "launch")
        err = max(float((got[k].float() - want[k].float()).abs().max())
                  for k in want)
        if not err <= 1e-5:
            raise AssertionError(f"K2 {name}: max_abs_err {err:.3e}")
        worst = max(worst, err)
        log(f"K2 stream regime, {name}: max_abs_err {err:.3e}")
        del got, want
    return worst


# Part A's shapes for K2's streaming regime: more than 16 classes (the
# GTA path's 24, S 5 over 6 HRNet images at 256 x 478), and more than 454
# bytes of samples a voxel (80 TTA-sized samples of 2 classes over twelve
# 64^3 windows)
K2_STREAM_SHAPES = {"S=5 C=24 N=6x256x478 bf16 logits":
                    (5, 24, 6 * 256 * 478, "bfloat16", True),
                    "S=80 C=2 N=12x64^3 f32 probabilities":
                    (80, 2, 12 * 64 ** 3, "float32", False)}


def k2_stream_cases(gen) -> dict:
    """K2's streaming-regime inputs at K2_STREAM_SHAPES: the logits
    sample-major as a grouped head leaves them, the probabilities as a
    softmax stack with exact zeros."""
    import torch
    cases = {}
    for name, (s, c, n, dtype, is_logits) in K2_STREAM_SHAPES.items():
        if is_logits:
            x = (torch.randn((s, n, c), generator=gen, device="cuda") * 3
                 ).to(getattr(torch, dtype)).permute(0, 2, 1)
        else:
            x = entropy_stack(gen, s, c, n).to(getattr(torch, dtype))
        cases[name] = (x, is_logits)
    return cases


# -- K3 against its plain version ---------------------------------------------

def k3_head(gen, n, m, c):
    """An (N, M, 2C) float32 head and its (mu, sigma) views, as the
    aleatoric scorer slices them: mu = head[..., :C] ~ 2 N(0, 1), and
    sigma = exp(s / 2) of a unit-scale log-variance s ~ N(0, 1), written
    back into head[..., C:]. Returns (mu, sigma, s)."""
    import torch
    head = torch.randn((n, m, 2 * c), generator=gen, device="cuda")
    head[..., :c] *= 2
    log_var = head[..., c:].clone()
    head[..., c:] = torch.exp(head[..., c:] / 2)
    return head[..., :c], head[..., c:], log_var


def check_k3():
    """Both bit modes at M=5, n=3, C=2 (the two-class kernel), C=3 (the
    general one) and C=12, 24 and 100 (the shared-memory one, at 48 KB a
    block, above 48 KB, and with the block halved): the regime each
    launches, the bits exactly, then
    the sums in the sigma form, the log_var form and in bfloat16
    (log_var), and the sigma = 0 case; then the shared-memory kernel at
    Part A's shape (K3_WIDE_N voxels, 10 samples, bf16 log_var).
    Tolerances: sums atol 1e-4, rtol 1e-5 (the kernel's float32 SFU exp, log, sqrt and reciprocals and its FMAs differ from
    PyTorch's by ulps; each sum adds M*n = 15 terms of magnitude at most
    1, or log C); sigma = 0: atol 1e-5 against n * sum_m softmax(mu).
    Returns the worst sum error."""
    import torch
    from values_tpu_torch.ops.kernels import sampling
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    m, n_s, seed = N_MEMBERS, 3, 2 ** 33 + 12345
    # (bits, C, N, spatial, counter_rows): ragged N for the 256-voxel
    # blocks
    cases = (("philox", CLASSES, 100_003, None, None),
             ("counter", CLASSES, 5 * 8 * 7 * 16, (8, 7, 16), 4),
             ("philox", 3, 50_001, None, None),
             ("counter", 3, 3 * 8 * 8 * 16, (8, 8, 16), 4),
             # more than 8 classes: the shared-memory regime, at 12 (48 KB
             # a block), GTA's 24 (96 KB: the opt-in above 48 KB) and 100
             # (the block halved to 128 threads to fit)
             *((bits, c, n, spatial, rows) for c in K3_SHARED_CS
               for bits, n, spatial, rows in (
                   ("philox", 50_001, None, None),
                   ("counter", 3 * 8 * 8 * 16, (8, 8, 16), 4))))
    want_blocks = {K3_WIDE_C: 256, 24: 256, 100: 128}
    for c, block in want_blocks.items():
        if sampling.plan(c) != ("shared", block):
            raise AssertionError(f"K3 plan at C={c}: {sampling.plan(c)}, "
                                 f"not ('shared', {block})")
    worst = 0.0
    for bits, c, n, spatial, rows in cases:
        kw = dict(n_samples=n_s, bits=bits, spatial=spatial,
                  counter_rows=rows)
        regime = sampling.plan(c)[0]
        got_bits = sampling.sample_bits(n, m, c, seed, device="cuda", **kw)
        want_bits = sampling.sample_bits_reference(n, m, c, seed,
                                                   device="cuda", **kw)
        if not torch.equal(got_bits, want_bits):
            bad = int((got_bits != want_bits).sum())
            raise AssertionError(f"K3 {bits} bits: {bad} of "
                                 f"{got_bits.numel()} words differ")
        mu, sigma, log_var = k3_head(gen, n, m, c)
        forms = {"sigma": (mu, sigma, {}),
                 "log_var": (mu, None, {"log_var": log_var}),
                 "log_var bf16": (mu.to(torch.bfloat16), None,
                                  {"log_var": log_var.to(torch.bfloat16)})}
        errs = {}
        for form, (mu_t, sigma_t, extra) in forms.items():
            before = sampling.sampled_softmax_stats.regime_launches[regime]
            got = sampling.sampled_softmax_stats(mu_t, sigma_t, seed, **kw,
                                                 **extra)
            if sampling.sampled_softmax_stats.regime_launches[regime] != \
                    before + 1:
                raise AssertionError(f"K3 {bits} {form} at C={c}: the "
                                     f"{regime} regime did not launch")
            want = sampling.sampled_softmax_stats_reference(
                mu_t, sigma_t, seed, **kw, **extra)
            for name, g, w in zip(("sum_p", "sum_ent"), got, want):
                err = (g - w).abs()
                errs[f"{form} {name}"] = float(err.max())
                if bool((err > 1e-4 + 1e-5 * w.abs()).any()):
                    raise AssertionError(f"K3 {bits} {form} {name}: "
                                         f"max_abs_err {float(err.max()):.3e}")
        worst = max(worst, *errs.values())
        zero_p, _ = sampling.sampled_softmax_stats(
            mu, torch.zeros_like(sigma), seed, **kw)
        soft = n_s * torch.softmax(mu, dim=-1).sum(dim=1).t()
        err0 = float((zero_p - soft).abs().max())
        if not err0 <= 1e-5:
            raise AssertionError(f"K3 {bits} sigma=0: max_abs_err {err0:.3e}")
        log(f"K3 {bits:7s} M={m} C={c} n={n_s} N={n} {regime} "
            f"(block {sampling.plan(c)[1]}): bits equal "
            f"({got_bits.numel()} words); max_abs_err " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs.items())
            + f"; sigma=0 {err0:.3e} (strided views)")
    # Part A's shape for the shared-memory regime, as the scorer hands a
    # head over (bf16 mu and log_var views), against its plain version
    mu, _, log_var = k3_head(gen, K3_WIDE_N, N_MEMBERS, K3_WIDE_C)
    kw = dict(n_samples=N_ALEATORIC, log_var=log_var.to(torch.bfloat16))
    before = dict(sampling.sampled_softmax_stats.regime_launches)
    got = sampling.sampled_softmax_stats(mu.to(torch.bfloat16), None, seed,
                                         **kw)
    if sampling.sampled_softmax_stats.regime_launches["shared"] != \
            before["shared"] + 1:
        raise AssertionError("K3 at C=12: the shared regime did not launch")
    want = sampling.sampled_softmax_stats_reference(mu.to(torch.bfloat16),
                                                    None, seed, **kw)
    for name, g, w in zip(("sum_p", "sum_ent"), got, want):
        err = (g - w).abs()
        if bool((err > 1e-4 + 1e-5 * w.abs()).any()):
            raise AssertionError(f"K3 C={K3_WIDE_C} at the path's shape "
                                 f"{name}: max_abs_err {float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
        log(f"K3 shared regime M={N_MEMBERS} C={K3_WIDE_C} n={N_ALEATORIC} "
            f"N={K3_WIDE_N} bf16 log_var: {name} max_abs_err "
            f"{float(err.max()):.3e}")
    return worst


# Part A's shape for K3's shared-memory regime: 12 classes, 5 members, 10
# samples over 32 volumes of 64^3
K3_WIDE_C, K3_WIDE_N = 12, 32 * 64 ** 3
K3_SHARED_CS = (K3_WIDE_C, 24, 100)   # the shared regime's checked counts


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


K1B_FOLDS = ("stats", "leaky", "relu")
# (name, dtype, B, volume, G, forward Cin, forward Cout, the folds held)
K1B_CASES = [
    ("B 2, 32^3, G 2, 16 -> 8", "float32", 2, 32, 2, 16, 8, K1B_FOLDS),
    # a float32 shape that tf32x3 does not take (Cout 12, Cin 24): plan_dx
    # gives its dx to the CUDA-core kernel's dx instance; 12^3 is ragged
    # in its 4x8x8 tile
    ("CUDA-core dx: B 2, 12^3, G 2, 24 -> 12", "float32", 2, 12, 2, 24, 12,
     K1B_FOLDS)]
# the 17 convs whose dx a training step takes (UNET3D_F8_CONVS past the
# first conv, the decoder's concat as one input) at the training batch, G 1
# (a step) and G = M (a joint step), in both dtypes: every dx instance a
# training step launches; expand_1_1 (the 16th) also after a ReLU
K1B_CASES += [
    (f"dx {i:2d}/17 B {TRAIN_BATCH}, {d}^3, G {g}, {c1 + c2} -> {co}", dt,
     TRAIN_BATCH, d, g, c1 + c2, co, K1B_FOLDS if i == 16 else K1B_FOLDS[:2])
    for dt in ("float32", "bfloat16") for g in (1, N_MEMBERS)
    for i, (d, c1, c2, co, *_) in enumerate(UNET3D_F8_CONVS[1:], 1)]
# F2: bfloat16 forward and dx shapes run zero-padded (forward Cin 4 and
# 12, Cout 6 and 12)
K1B_CASES += [
    (f"F2 pad B 2, 16^3, G 2, {ci} -> {co}", "bfloat16", 2, 16, 2, ci, co,
     K1B_FOLDS) for ci, co in ((4, 6), (12, 12), (12, 6), (6, 12))]
# Tolerances: float32 atol 1e-4 max|g| -- dx, dW and db each add up to
# 27 Cout (dx; 3xTF32 products, float32's accuracy) or B D H W (dW, db)
# terms in another order than cuDNN does on the plain side (TF32 off),
# db with float32 atomics in an order that changes from run to run;
# bfloat16 K1's rule, 2**-7 |ref| + 2e-3 max|g|: both sides round the
# same float32 sums to bfloat16 and an ulp of order can flip a rounding.
K1B_TOL = {"float32": (0.0, 1e-4), "bfloat16": (2 ** -7, 2e-3)}


def check_k1b():
    """K1b's dx, dW and db on the card against autograd through K1's
    plain version, for the statistics case (activation none) and the
    leaky and ReLU epilogues: each backward's dx is one launch of the dx
    entry, in plan_dx's regime (the forward in plan's), which also writes
    the folded cotangent that dW reads (held through dW) and db."""
    import collections
    import torch
    from values_tpu_torch.ops.kernels.conv3d import (conv3d_fused,
                                                     conv3d_fused_train,
                                                     dx_padded_channels,
                                                     padded_channels, plan,
                                                     plan_dx)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    worst, padded = 0.0, {}
    for name, dt, b, p, g, cin, cout, folds in K1B_CASES:
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
        del pre
        # statistics cotangents large enough to survive K1b's bf16 fold
        # (fault R5: a shift below half an ulp of dy is rounded away)
        g1, g2 = torch.randn((2, b, g * cout), generator=gen,
                             device="cuda") * 0.1
        dx_regime = plan_dx(dtype, p, p, p, g, *dx_padded_channels(
            dtype, cout, cin)).regime
        expected = dict(collections.Counter(
            [plan(dtype, p, p, p, g, *padded_channels(dtype, cin, 0, cout)
                  ).regime, dx_regime]))
        for case in folds:
            reset_launches()
            regimes = dict(conv3d_fused.regime_launches)
            got = k1b_grads(conv3d_fused_train, x, weight, bias, g, case, gy,
                            g1, g2)
            torch.cuda.synchronize()
            launches = read_launches()
            expect_launches(launches, {"conv3d_fused": 2,
                                       "conv3d_fused_train": 1,
                                       "fused_entropy": 0,
                                       "sampled_softmax_stats": 0},
                            f"K1b {name} {case} (forward + dx)")
            ran = regimes_since(regimes)
            if ran != expected:
                raise AssertionError(f"K1b {dt} {name} {case}: regimes "
                                     f"{ran}, expected {expected} (the dx "
                                     f"entry's {dx_regime})")
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
                        f"K1b {dt} {name} {case} {what}: max_abs_err "
                        f"{float(err.max()):.3e} (max|g| {scale:.3e})")
            worst = max(worst, *errs)
            if name.startswith("F2"):
                padded[f"{name} {case}"] = {"dx_regime": dx_regime,
                                            "max_err_over_max_g": max(errs)}
            log(f"K1b {dt:8s} {name:36s} {case:5s}: max_abs_err / max|g| "
                f"dx {errs[0]:.2e} dW {errs[1]:.2e} db {errs[2]:.2e}; "
                f"dx entry launched once ({dx_regime})")
            del got, want
    return worst, padded


# -- the main path ------------------------------------------------------------

def member_state_dicts(seed: int, aleatoric: bool = False,
                       ssn: bool = False):
    """Per-member UNet3D state_dicts (with the ``final_aleatoric`` head
    when ``aleatoric``; SsnUNet3D's, rank SSN_RANK, when ``ssn``), drawn
    with numpy from ``seed`` at each parameter's fan-in scale (torch's
    default init range)."""
    import torch
    from values_tpu_torch.models.ssn_unet3d import SsnUNet3D
    from values_tpu_torch.models.unet3d import UNet3D
    rs = np.random.RandomState(seed)
    states = []
    for _ in range(N_MEMBERS):
        ref = (SsnUNet3D(CLASSES, initial_filter_size=FILTERS,
                         rank=SSN_RANK) if ssn else
               UNet3D(CLASSES, initial_filter_size=FILTERS,
                      aleatoric_loss=aleatoric)).state_dict()
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


def write_checkpoints(root: str, name: str, states, aleatoric: bool,
                      model=None):
    """One reference-format ``.ckpt`` per member state_dict; ``model``
    updates the UNet3D model config (dropout, the SSN)."""
    import torch
    hparams = {
        "seed": CLI_SEED, "data_input_dir": root,
        "model": {"_target_": "values_tpu.models.unet3d.UNet3D",
                  "num_classes": CLASSES, "in_channels": 1,
                  "initial_filter_size": FILTERS, "kernel_size": 3,
                  "do_instancenorm": True, **(model or {})},
        "datamodule": dict(LIDC_DATAMODULE, splits_path=os.path.join(
            root, "splits_texture.pkl"))}
    if aleatoric or model:
        hparams["n_aleatoric_samples"] = N_ALEATORIC
    if aleatoric:
        hparams["aleatoric_loss"] = True
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
TIMED_STEPS = 5
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
    """A config at its published widths; one epoch over ``root``."""
    return [f"data_input_dir={root}", f"save_dir={root}/exp",
            f"version={version}", "max_epochs=1"]


def run_config_cli(name: str, root: str, version: str, extra: list,
                   card: str):
    """The training CLI on config ``name`` over ``root`` (one epoch unless
    ``extra`` says otherwise), its launches counted and its epoch lines
    parsed; returns (checkpoint, seconds, launches, [per-epoch losses])."""
    import io
    from values_tpu_torch.training.main import main as train_main
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        ckpt = train_main(["--config-name", name, "--device", "cuda"]
                          + training_overrides(root, version) + extra)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    lines = [line for line in out.getvalue().splitlines()
             if line.startswith("epoch ")]
    losses = [{k: float(v) for k, v in (item.split("=") for item in
                                        line.split()[2:5])}
              for line in lines]
    log(f"training CLI {name} {version}: " + " | ".join(lines)
        + f"; {seconds:.2f} s; launches {json.dumps(launches)}; card {card}")
    if not os.path.exists(ckpt) or not losses or not all(
            np.isfinite(v) for epoch in losses for v in epoch.values()):
        raise AssertionError(f"training CLI {name} {version}: checkpoint "
                             f"{ckpt} or losses {losses} missing or not "
                             "finite")
    return ckpt, seconds, launches, losses


# P2: cuDNN's weight gradient under PyTorch's default (TF32) against TF32
# off. dW of a 64^3 conv sums 8 x 64^3 products whose operands TF32 rounds
# to 10 mantissa bits (2^-11 each); the forward (K1, 3xTF32) and dx (K1b)
# do not change. Read on an H100 (PR 11): 7.9e-5 of the gradient norm,
# 3.0e-3 at the worst leaf. Both bounds lie below bfloat16's unit
# roundoff (2^-8 = 3.9e-3) at the norm and near it at a leaf, so a dW
# taken at bf16 precision misses them. Random weights make this a weak
# test of a trained model's gradients.
TF32_LOSS_BOUND, TF32_GRAD_BOUND, TF32_LEAF_BOUND = 1e-5, 1e-3, 1e-2


def p2_against_tf32_off(names, loss, grads, loss_and_grads, card: str):
    """The same first step under PyTorch's default, cuDNN's TF32 on, held
    against the TF32-off step: the loss and every gradient leaf but the
    biases of the convs feeding an instance norm (true gradient 0, both
    sides roundoff, as in first_step_against_plain)."""
    with tf32(True):
        tf_loss, tf_grads = loss_and_grads()
    pairs = [(n, a, w) for n, a, w in zip(names, tf_grads, grads)
             if not (n.startswith("contr_") and n.endswith("bias"))]
    rel = {n: float((a - w).norm() / w.norm()) for n, a, w in pairs}
    total = float(sum(((a - w) ** 2).sum() for _, a, w in pairs).sqrt()
                  / sum((w ** 2).sum() for _, _, w in pairs).sqrt())
    worst = max(rel, key=rel.get)
    loss_rel = abs(tf_loss - loss) / abs(loss)
    log(f"P2, the first f32 step under PyTorch's default (cuDNN TF32 on) "
        f"against TF32 off: loss rel {loss_rel:.2e} (bound "
        f"{TF32_LOSS_BOUND:g}); gradient error {total:.2e} of the norm "
        f"(bound {TF32_GRAD_BOUND:g}), largest leaf {rel[worst]:.2e} "
        f"({worst}; bound {TF32_LEAF_BOUND:g}); card {card}")
    if (loss_rel > TF32_LOSS_BOUND or total > TF32_GRAD_BOUND
            or rel[worst] > TF32_LEAF_BOUND):
        raise AssertionError("the TF32 step is off by more than TF32")
    return {"loss": loss_rel, "total": total, "worst": rel[worst]}


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
    p2_against_tf32_off(names, got_loss, got, loss_and_grads, card)
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
        runs[version] = run_config_cli("softmax_config", root, version,
                                       extra, card)
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


# -- joint deep-ensemble training ---------------------------------------------

JOINT_STEPS = 3


def joint_batches(cfg, root: str, members: int):
    """JOINT_STEPS joint batches on the card, member m's rows from its own
    stream: the config's toy datamodule with seed + m, one epoch each."""
    import torch
    from values_tpu_torch.config import instantiate
    streams = []
    for m in range(members):
        dm = instantiate(cfg.datamodule, data_input_dir=root,
                         batch_size=cfg.batch_size,
                         seed=int(cfg.datamodule.get("seed", 42)) + m)
        dm.prepare_data()
        dm.setup()
        streams.append(list(dm.train_dataloader())[:JOINT_STEPS])
    return [{key: torch.from_numpy(np.stack([s[i][key] for s in streams]))
             .cuda() for key in ("data", "seg")} for i in range(JOINT_STEPS)]


def _grouped_tree(names, leaves):
    tree = {}
    for (module, leaf), value in zip(names, leaves):
        tree.setdefault(module, {})[leaf] = value
    return tree


def joint_step_against_experiments(trainer, state, batch, cfg, card: str,
                                   generators=None):
    """The first f32 joint step against N_MEMBERS independent port
    Experiments (each on its member's initial weights and stream, K1 and
    K1b at G = 1): each member's loss within rtol 2e-4, and its gradient,
    split off the joint one, within the limits of the first training
    step's check (``first_step_against_plain``): 1e-3 of the norm over
    all leaves and 1e-2 of each leaf's, the biases of the convs feeding an
    instance norm aside (their true gradient is 0). ``generators``: a
    function giving fresh, equally seeded per-member generators, so both
    sides draw the same dropout masks."""
    import torch
    from values_tpu_torch.models.ensemble_unet3d import \
        ungroup_member_variables
    from values_tpu_torch.training.experiment import Experiment, tree_leaves
    names = [(m, k) for m in sorted(state.params)
             for k in sorted(state.params[m])]
    leaves = tree_leaves(state.params)
    losses = trainer.loss(state.params, batch,
                          generators() if generators else None)
    grads = torch.autograd.grad(losses.sum(), leaves)
    losses = losses.detach()
    split = ungroup_member_variables(
        _grouped_tree(names, [g.cpu().numpy() for g in grads]),
        trainer.members)
    initial = trainer.member_variables(state)
    worst = {"loss": 0.0, "total": 0.0, "leaf": 0.0}
    for m in range(trainer.members):
        exp = Experiment(cfg, "cuda")
        est = exp.state_from_variables(initial[m])
        loss = exp.loss(est.params, {"data": batch["data"][m],
                                     "seg": batch["seg"][m]},
                        generators()[m] if generators else None)
        want = torch.autograd.grad(loss, tree_leaves(est.params))
        want_names = [f"{mod}/{k}" for mod in sorted(est.params)
                      for k in sorted(est.params[mod].get(
                          "conv", est.params[mod]))]
        got = [torch.from_numpy(v) for v in
               (split[m]["params"][mod].get("conv", split[m]["params"][mod])
                [k] for mod, k in (n.split("/") for n in want_names))]
        pairs = [(n, a, w.cpu()) for n, a, w in zip(want_names, got, want)
                 if not (n.startswith("contr_") and n.endswith("bias"))]
        rel = max(float((a - w).norm() / w.norm()) for _, a, w in pairs)
        total = float(torch.sqrt(sum(((a - w) ** 2).sum()
                                     for _, a, w in pairs))
                      / torch.sqrt(sum((w ** 2).sum() for _, _, w in pairs)))
        loss_rel = abs(float(losses[m]) - loss.item()) / abs(loss.item())
        worst = {"loss": max(worst["loss"], loss_rel),
                 "total": max(worst["total"], total),
                 "leaf": max(worst["leaf"], rel)}
    log(f"first f32 joint step (G={trainer.members}) against "
        f"{trainer.members} Experiment steps (G=1): loss rel "
        f"{worst['loss']:.2e}, gradient error {worst['total']:.2e} of the "
        f"norm, largest leaf {worst['leaf']:.2e}; card {card}")
    if worst["loss"] > 2e-4 or worst["total"] > 1e-3 or worst["leaf"] > 1e-2:
        raise AssertionError("the joint step disagrees with the "
                             "independent Experiment steps")


def joint_training_path(root: str, card: str):
    """EnsembleTrainer with N_MEMBERS members on softmax_config at its
    published widths (UNet3D f 8, 64^3 patches, batch 8 per member) over
    the toy Case_1, JOINT_STEPS steps at f32 and at bf16, launches and
    K1 regimes counted; the first f32 step against independent
    Experiments; the f32 members written as checkpoints. Returns the
    checkpoint paths, the launches and the timings."""
    import torch
    from values_tpu_torch.config import compose
    from values_tpu_torch.ops.kernels.conv3d import conv3d_fused
    from values_tpu_torch.training.ensemble import EnsembleTrainer
    from values_tpu_torch.training.main import DEFAULT_CONFIG_DIR
    out, ckpts = {}, None
    for name, extra in (("f32", []), ("bf16", ["+precision=bf16"])):
        cfg = compose(DEFAULT_CONFIG_DIR, "softmax_config",
                      training_overrides(root, "joint") + extra)
        trainer = EnsembleTrainer(cfg, N_MEMBERS, "cuda")
        state = trainer.init_state(cfg.seed, PATCH)
        batches = joint_batches(cfg, root, N_MEMBERS)
        if name == "f32":
            joint_step_against_experiments(trainer, state, batches[0], cfg,
                                           card)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        regimes = dict(conv3d_fused.regime_launches)
        reset_launches()
        times = []
        for batch in batches:
            t0 = time.perf_counter()
            _, losses = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches()
        ran = regimes_since(regimes)
        expect_launches(launches, {
            "conv3d_fused": (K1_FORWARD + K1_DX) * JOINT_STEPS,
            "conv3d_fused_train": K1_DX * JOINT_STEPS, "fused_entropy": 0,
            "sampled_softmax_stats": 0},
            f"joint training {name} ({JOINT_STEPS} steps of 18 K1 forward "
            f"and 17 K1b dx launches at G={N_MEMBERS})")
        expect_f32_regime(ran, name == "f32", f"joint training {name}")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"joint training {name}: losses {losses}")
        step_ms = statistics.mean(times[1:])
        vps = N_MEMBERS * TRAIN_BATCH / step_ms * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        with torch.no_grad():
            k1_fwd = device_times(lambda: trainer.loss(state.params,
                                                       batches[0]))[3]
        before = read_launches()["conv3d_fused"]
        table, wall, busy, k1, dw = device_times(
            lambda: trainer.train_step(state, batches[0]))
        records = kernel_records(table, {
            "conv3d_fused": read_launches()["conv3d_fused"] - before})
        with open(os.path.join(OUT_DIR, f"profile_joint_step_{name}.txt"),
                  "w") as fh:
            fh.write(table.table(sort_by="self_device_time_total",
                                 row_limit=40))
        out[name] = {"step_ms": times, "volumes_per_s": vps, "peak_gb": peak,
                     "launches": launches, "regimes": ran,
                     "profile": {"wall_ms": wall, "busy_ms": busy,
                                 "k1_forward_ms": k1_fwd,
                                 "k1_dx_ms": k1 - k1_fwd, "dw_ms": dw}}
        log(f"joint training {name}, {N_MEMBERS} members x batch "
            f"{TRAIN_BATCH} x {PATCH}^3: steps " + " / ".join(
                f"{t:.1f}" for t in times) + f" ms (mean of steps 2-"
            f"{JOINT_STEPS}: {step_ms:.2f} ms), {vps:.2f} volumes trained/s,"
            f" peak {peak:.2f} GB; losses " + " ".join(
                f"{v:.4f}" for v in losses.tolist())
            + f"; launches {json.dumps(launches)}, K1 regimes "
            f"{json.dumps(ran)}; profile of one step (profiler on): device "
            f"{busy:.2f} of {wall:.2f} ms wall, idle share "
            + ("not measured" if not busy else f"{1 - busy / wall:.3f}")
            + f", K1 forward {k1_fwd:.2f} ms, K1 dx {k1 - k1_fwd:.2f} ms, dW "
            f"(cuDNN) {dw:.2f} ms, the rest {busy - k1 - dw:.2f} ms; "
            f"{records_note(records)}; card {card}")
        if name == "f32":
            ckpts = trainer.save_member_checkpoints(
                state, os.path.join(root, "joint_members"),
                epoch=0)
    return ckpts, out


# -- the sliding-window test_3d CLI ---------------------------------------------

BIG, BIG_VOLUMES, TEST3D_CHUNK = 128, 4, 3
# of those, the volumes that the test_3d CLI runs and the aleatoric engine
# take (the engine's rate takes all BIG_VOLUMES)
BIG_CLI_VOLUMES = 2
# every map the CLI writes for one volume of a 5-member ensemble with 3
# raters: input, 3 rater masks, 6 label maps (mean + 5), 12 probability
# maps (mean + 5, 2 classes each) and the 3 C2 maps
MAPS_PER_VOLUME = 1 + RATERS + (1 + N_MEMBERS) + (1 + N_MEMBERS) * CLASSES + 3
METRICS = ["loss", "dice", "ged"] + [f"max dice rater {r}"
                                     for r in range(RATERS)] + [
    "max dice pred"]


def write_big_volumes(root: str) -> list:
    """BIG_VOLUMES noisy-ball volumes of BIG^3 (8 windows of 64^3 each)
    with RATERS rater masks, in the toy test layout (imagesTs/labelsTs,
    ``<id>_<rater>.npy``). Returns the subject file names."""
    grid = np.indices((BIG,) * 3).astype(np.float32)
    images, labels = (os.path.join(root, d) for d in ("imagesTs",
                                                      "labelsTs"))
    os.makedirs(images)
    os.makedirs(labels)
    subjects = []
    for i in range(BIG_VOLUMES):
        rs = np.random.RandomState(1000 + i)
        center = rs.uniform(40, 88, 3)[:, None, None, None]
        dist = np.sqrt(((grid - center) ** 2).sum(0))
        radius = rs.uniform(16, 32)
        name = f"big_{i:02d}.npy"
        np.save(os.path.join(images, name),
                ((dist < radius) + 0.3 * rs.randn(*dist.shape)
                 ).astype(np.float32))
        for r in range(RATERS):
            np.save(os.path.join(labels, f"big_{i:02d}_{r:02d}.npy"),
                    (dist < radius + r - 1).astype(np.uint8))
        subjects.append(name)
    return subjects


def check_result_tree(result_dir: str, subjects,
                      n_preds: int = N_MEMBERS) -> None:
    """The CLI's output tree, file by file: every map of every volume
    (``n_preds`` samples) present and finite, and metrics.json with each
    volume's metrics and their mean."""
    from values_tpu_torch.core import nifti
    stems = [s.split(".")[0] for s in subjects]
    want = {"metrics.json"}
    for stem in stems:
        want |= {f"input/{stem}.nii.gz"}
        want |= {f"gt_seg/{stem}_{r:02d}.nii.gz" for r in range(RATERS)}
        for pred in ["mean"] + [f"{p + 1:02d}" for p in range(n_preds)]:
            want.add(f"pred_seg/{stem}_{pred}.nii.gz")
            want |= {f"pred_prob/{stem}_{pred}_{c + 1:02d}.nii.gz"
                     for c in range(CLASSES)}
        want |= {f"{unc}/{stem}.nii.gz" for unc in (
            "pred_entropy", "aleatoric_uncertainty", "epistemic_uncertainty")}
    got = {os.path.relpath(os.path.join(d, f), result_dir)
           for d, _, files in os.walk(result_dir) for f in files}
    if got != want:
        raise AssertionError(f"test_3d tree: missing {sorted(want - got)[:5]},"
                             f" extra {sorted(got - want)[:5]}")
    for rel in sorted(want - {"metrics.json"}):
        arr, _ = nifti.load(os.path.join(result_dir, rel))
        if not np.isfinite(arr).all():
            raise AssertionError(f"test_3d map {rel} is not finite")
    with open(os.path.join(result_dir, "metrics.json")) as f:
        metrics = json.load(f)
    if "mean" not in metrics or len(metrics) != len(stems) + 1 or any(
            sorted(v) != sorted(METRICS) for v in metrics.values()):
        raise AssertionError(f"test_3d metrics.json: {metrics}")


def member_modules(states, aleatoric=False):
    """The plain path's per-member UNet3D modules on the card, from
    reference state_dicts (``model.`` prefix optional)."""
    from values_tpu_torch.models.torch_import import strip_model_prefix
    from values_tpu_torch.models.unet3d import UNet3D
    nets = []
    for state in states:
        net = UNet3D(CLASSES, initial_filter_size=FILTERS,
                     aleatoric_loss=aleatoric)
        net.load_state_dict(strip_model_prefix(state), strict=True)
        nets.append(net.cuda().eval())
    return nets


def plain_volume_sums(nets, volume, chunk: int, generator=None):
    """One volume through the plain path on the card: the engine's
    windowing (chunks of ``chunk`` windows, extract_windows, ordered
    stitch_windows) around per-member UNet3D modules (unfused, cuDNN with
    TF32 off) and a float32 softmax; with a generator, the aleatoric
    members' (mu, s), normals drawn as the engine draws them and the
    port's sample transform. Returns (softmax sums (S, C, *vol), sigma
    sums or None) as numpy."""
    import torch
    from values_tpu_torch.ops.uncertainty import aleatoric_softmax_samples
    from values_tpu_torch.ops.window import (enumerate_window_starts,
                                             extract_windows, stitch_windows)
    vol = torch.from_numpy(volume).cuda().float()
    starts = enumerate_window_starts(volume.shape, PATCH, 1.0)
    vol_shape = tuple(volume.shape)
    sums = None
    with torch.no_grad():
        for i in range(0, len(starts), chunk):
            part = starts[i:i + chunk]
            x = extract_windows(vol, part, PATCH)[..., None]
            if generator is None:
                stacks = [torch.softmax(torch.stack([n(x) for n in nets]),
                                        dim=-1)]
            else:
                mu, s = (torch.stack(t) for t in zip(*(n(x) for n in nets)))
                eps = torch.randn((len(nets), N_ALEATORIC)
                                  + tuple(mu.shape[1:]), generator=generator,
                                  device=mu.device)
                stacks = list(aleatoric_softmax_samples(mu, s, eps))
            out = [stitch_windows(t.permute(1, 2, 3, 4, 0, 5), part,
                                  vol_shape + (t.shape[0], t.shape[-1]))
                   for t in stacks]
            sums = out if sums is None else [a + b for a, b in zip(sums, out)]
    sums = [t.permute(3, 4, 0, 1, 2).cpu().numpy() for t in sums]
    return sums[0], (sums[1] if generator is not None else None)


def close(got, want, what: str) -> float:
    """atol + rtol 1e-3: the fused forward (deferred norms, K1's summation
    order) and the unfused modules round float32 differently."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    if (err > 1e-3 + 1e-3 * np.abs(want)).any():
        raise AssertionError(f"{what}: max_abs_err {err.max():.3e} beyond "
                             "atol + rtol 1e-3")
    return float(err.max())


def test3d_path(ckpts, train_root: str, card: str):
    """``python -m values_tpu_torch.inference.test_3d`` on the jointly
    trained checkpoints, at f32 and bf16: (a) the Case_1 validation split
    (64^3 volumes, one window each), (b) BIG_CLI_VOLUMES volumes of 128^3
    by --test_data_dir/--subject_ids at --test_batch_size 3 (chunks of 3, 3
    and 2). Each run's tree checked and its launches counted (18 K1 per
    chunk); run (b) at f32 held against the plain path. Returns the root,
    the big volumes' directory and subjects, the CLI seconds and K1's
    launches in each run."""
    import pickle as pkl
    import torch
    from values_tpu_torch.inference import test_3d
    from values_tpu_torch.ops.kernels.conv3d import conv3d_fused
    root = tempfile.mkdtemp(dir=OUT_DIR, prefix="test3d_")
    big_dir = os.path.join(root, "big")
    subjects = write_big_volumes(big_dir)
    with open(os.path.join(train_root, "Case_1", "splits.pkl"), "rb") as f:
        val = sorted(pkl.load(f)[0]["val"])
    cli_subjects = subjects[:BIG_CLI_VOLUMES]
    sets = {"val": (["--test_split", "val"], val, len(val), "val"),
            "128": (["--test_data_dir", big_dir, "--subject_ids",
                     *cli_subjects, "--test_batch_size", str(TEST3D_CHUNK)],
                    cli_subjects, BIG_CLI_VOLUMES * -(-8 // TEST3D_CHUNK),
                    "id")}
    seconds, runs, held = {}, {}, None
    for dtype in ("float32", "bfloat16"):
        for name, (extra, subj, chunks, split) in sets.items():
            save = os.path.join(root, f"{name}_{dtype}")
            regimes = dict(conv3d_fused.regime_launches)
            reset_launches()
            t0 = time.perf_counter()
            carrier = test_3d.run_test(test_3d.test_cli(
                ["--checkpoint_paths", *ckpts, "--save_dir", save,
                 "--dtype", dtype] + extra))
            seconds[name, dtype] = time.perf_counter() - t0
            launches = read_launches()
            ran = regimes_since(regimes)
            expect_launches(launches, {
                "conv3d_fused": 18 * chunks, "conv3d_fused_train": 0,
                "fused_entropy": 0, "sampled_softmax_stats": 0},
                f"test_3d {name} {dtype} ({chunks} chunks of 18 K1 launches)")
            expect_f32_regime(ran, dtype == "float32",
                              f"test_3d {name} {dtype}")
            result_dir = os.path.join(save, "Softmax-Case-1", "test_results",
                                      "joint", split)
            check_result_tree(result_dir, subj)
            runs[f"test_3d {name} {dtype}"] = launches["conv3d_fused"]
            if (name, dtype) == ("128", "float32"):
                held = carrier
            with open(os.path.join(result_dir, "metrics.json")) as f:
                mean = json.load(f)["mean"]
            log(f"test_3d CLI {name} ({len(subj)} volumes, {chunks} chunks) "
                f"{dtype}: {seconds[name, dtype]:.2f} s (checkpoint reading, "
                f"volume loading and {len(subj) * MAPS_PER_VOLUME} nii.gz "
                f"maps included); mean dice {mean['dice']:.4f}, ged "
                f"{mean['ged']:.4f}; launches {json.dumps(launches)}, K1 "
                f"regimes {json.dumps(ran)}; card {card}")
            if dtype == "bfloat16":
                shutil.rmtree(save)

    # run (b) at f32 against the plain path, volume by volume
    worst = hold_against_plain(held, ckpts, "test_3d f32")
    log("test_3d 128^3 f32 against the plain path (per-member UNet3D "
        "modules through the same windowing and carrier): max_abs_err "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f"; card {card}")
    del held
    torch.cuda.empty_cache()
    return root, big_dir, subjects, seconds, runs


def hold_against_plain(carrier, ckpts, what: str) -> dict:
    """Each volume of a float32 test_3d run against the plain path:
    per-member UNet3D modules of ``ckpts`` through the same windowing and
    a carrier of their own; the softmax sums and every C2 map the run
    computed, within atol + rtol 1e-3. Returns the largest error of
    each."""
    import torch
    from values_tpu_torch.inference.carrier import VolumeCarrier
    from values_tpu_torch.training.checkpoint import load_any_checkpoint
    nets = member_modules([load_any_checkpoint(p)[1] for p in ckpts])
    keys = ("softmax_pred", "pred_entropy", "aleatoric_uncertainty",
            "epistemic_uncertainty")
    worst = {}
    for path, value in carrier.data.items():
        sums, _ = plain_volume_sums(nets, np.load(path), TEST3D_CHUNK)
        plain = VolumeCarrier(carrier.device)
        plain.add_volume(path, None, value["data"], None, sums,
                         value["num_predictions"][0])
        if "pred_entropy" in value:
            plain.compute_uncertainty()
        for key in keys:
            if key in value:
                worst[key] = max(worst.get(key, 0.0), close(
                    value[key], plain.data[path][key], f"{what} {key}"))
    del nets
    torch.cuda.empty_cache()
    return worst


def aleatoric_engine_path(big_dir: str, subjects, card: str):
    """The aleatoric members of the aleatoric path (seed SEED + 10) through
    SlidingWindowEngine (grouped, K1, f32, chunks of 3) over the 128^3
    volumes, its launches counted from 0 over that run; then held against
    the plain path given the same normals (a generator seeded as the
    engine's, drawing the same shapes in the same order): softmax and
    sigma sums within atol + rtol 1e-3."""
    import torch
    from values_tpu_torch.inference.engine import SlidingWindowEngine
    from values_tpu_torch.models.torch_import import unet3d_params_from_torch
    from values_tpu_torch.models.unet3d import UNet3D
    states = member_state_dicts(SEED + 10, aleatoric=True)
    engine = SlidingWindowEngine(
        UNet3D(CLASSES, initial_filter_size=FILTERS, aleatoric_loss=True),
        [unet3d_params_from_torch(s) for s in states], mode="aleatoric",
        n_aleatoric_samples=N_ALEATORIC, patch_size=PATCH,
        window_batch=TEST3D_CHUNK, seed=CLI_SEED, device="cuda")
    volumes = [np.load(os.path.join(big_dir, "imagesTs", subject))
               for subject in subjects]
    reset_launches()
    got = []
    for volume in volumes:
        softmax, _, _, _, sigma = engine.run_volume(volume)
        got.append((softmax, sigma))
    launches = read_launches()
    chunks = len(subjects) * -(-8 // TEST3D_CHUNK)
    expect_launches(launches, {"conv3d_fused": 18 * chunks,
                               "conv3d_fused_train": 0, "fused_entropy": 0,
                               "sampled_softmax_stats": 0},
                    "aleatoric engine")
    nets = member_modules(states, aleatoric=True)
    gen = torch.Generator(device="cuda").manual_seed(CLI_SEED)
    worst = {"softmax": 0.0, "sigma": 0.0}
    for volume, (softmax, sigma) in zip(volumes, got):
        want, want_sigma = plain_volume_sums(nets, volume, TEST3D_CHUNK,
                                             generator=gen)
        worst["softmax"] = max(worst["softmax"], close(
            softmax, want, "aleatoric engine softmax sums"))
        worst["sigma"] = max(worst["sigma"], close(
            sigma, want_sigma, "aleatoric engine sigma sums"))
    log(f"aleatoric engine ({N_MEMBERS} members x {N_ALEATORIC} samples, "
        f"{len(subjects)} volumes of {BIG}^3, chunks of {TEST3D_CHUNK}, "
        f"f32) against the plain path given the same normals: max_abs_err "
        f"softmax sums {worst['softmax']:.3e}, sigma sums "
        f"{worst['sigma']:.3e}; launches {json.dumps(launches)}; card {card}")
    return launches


# passes over the 128^3 set for the engine's rate: one pass is 32 windows
ENGINE_PASSES = 7


def engine_throughput(ckpts, big_dir: str, subjects, card: str):
    """Windows and volumes per second of SlidingWindowEngine (the jointly
    trained members, grouped, the CLI's default chunk of 12) over the
    128^3 volumes from disk, f32 and bf16: ENGINE_PASSES timed passes
    over the set after one warm-up volume, median and spread; and a
    torch.profiler breakdown of one 12-window chunk (a 192x128x128
    volume) at each dtype, its device time split into kernels and
    memory copies, the idle share taken from the kernels alone. Returns
    the numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from values_tpu_torch.data.samples import get_val_test_data_samples
    from values_tpu_torch.inference.engine import SlidingWindowEngine
    from values_tpu_torch.models.torch_import import unet3d_params_from_torch
    from values_tpu_torch.models.unet3d import UNet3D
    from values_tpu_torch.training.checkpoint import load_any_checkpoint
    members = [unet3d_params_from_torch(load_any_checkpoint(p)[1])
               for p in ckpts]
    samples = get_val_test_data_samples(
        base_dir=big_dir, subject_ids=subjects, test=True,
        num_raters=RATERS, patch_size=PATCH)
    chunk_volume = np.random.RandomState(9).rand(192, 128, 128).astype(
        np.float32)
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        engine = SlidingWindowEngine(
            UNet3D(CLASSES, initial_filter_size=FILTERS), members,
            patch_size=PATCH, window_batch=12, dtype=dtype, device="cuda")
        engine.run_volume(np.load(samples[0]["image_path"]))
        passes = []
        for _ in range(ENGINE_PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carrier = engine.run_samples(samples)
            torch.cuda.synchronize()
            passes.append(time.perf_counter() - t0)
            if len(carrier.data) != len(subjects):
                raise AssertionError("the engine lost a volume")
            del carrier
        elapsed = float(np.median(passes))
        engine.run_volume(chunk_volume)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.run_volume(chunk_volume)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        table = prof.key_averages()
        device = [e for e in table if "CUDA" in str(e.device_type)
                  and e.self_device_time_total > 0]
        copies = [e for e in device if e.key.startswith(("Memcpy",
                                                         "Memset"))]
        copy_ms = sum(e.self_device_time_total for e in copies) / 1e3
        kernel_ms = sum(e.self_device_time_total for e in device
                        if e not in copies) / 1e3
        k1 = sum(e.self_device_time_total for e in device
                 if any(n in e.key for n in K1_KERNELS)) / 1e3
        with open(os.path.join(OUT_DIR, f"profile_test3d_chunk_{name}.txt"),
                  "w") as fh:
            fh.write(table.table(sort_by="self_device_time_total",
                                 row_limit=40, max_name_column_width=120))
        out[name] = {"windows_per_s": len(samples) / elapsed,
                     "volumes_per_s": len(subjects) / elapsed,
                     "pass_s": passes, "chunk_wall_ms": wall,
                     "chunk_kernel_ms": kernel_ms, "chunk_copy_ms": copy_ms,
                     "chunk_k1_ms": k1}
        idle = ("not measured" if not kernel_ms
                else f"{1 - kernel_ms / wall:.3f}")
        log(f"test_3d engine {name}: {ENGINE_PASSES} passes of "
            f"{len(samples)} windows over {len(subjects)} {BIG}^3 volumes: "
            f"median {elapsed:.4f} s (min {min(passes):.4f}, max "
            f"{max(passes):.4f}; all {', '.join(f'{t:.4f}' for t in passes)}"
            f"): {out[name]['windows_per_s']:.2f} windows/s, "
            f"{out[name]['volumes_per_s']:.2f} volumes/s (loading from "
            f"disk and the copy back included); one 12-window chunk under "
            f"the profiler: {wall:.2f} ms wall, kernels {kernel_ms:.2f} ms "
            f"(K1 {k1:.2f} ms), memory copies {copy_ms:.2f} ms, idle share "
            f"of the kernels {idle}; card {card}")
    return out


# -- the MC-dropout, TTA and SSN paths --------------------------------------------

@contextlib.contextmanager
def recorded(module, name: str):
    """Record what ``module.name`` (a draw function) returns while the
    context is open, in call order."""
    orig, calls = getattr(module, name), []

    def record(*args, **kwargs):
        calls.append(orig(*args, **kwargs))
        return calls[-1]

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def plain_modules(states, **kw):
    """Per-member plain modules on the card (UNet3D with ``kw``, or
    SsnUNet3D for SSN states), unfused, cuDNN with TF32 off."""
    from values_tpu_torch.models.ssn_unet3d import SsnUNet3D
    from values_tpu_torch.models.unet3d import UNet3D
    nets = []
    for state in states:
        net = (SsnUNet3D(CLASSES, initial_filter_size=FILTERS, rank=SSN_RANK)
               if "mean_conv.weight" in state else
               UNet3D(CLASSES, initial_filter_size=FILTERS, **kw))
        net.load_state_dict(state, strict=True)
        nets.append(net.cuda())
    return nets


def member_masks(masks, m: int):
    """Member m's channels of a pass's grouped keep masks."""
    return [k[..., m * (k.shape[-1] // N_MEMBERS):
              (m + 1) * (k.shape[-1] // N_MEMBERS)] for k in masks]


def plain_scores(carry, n_samples: int, gt):
    from values_tpu_torch.inference.scoring import score_from_carry
    return score_from_carry(carry, n_samples, gt, agg_patch=AGG_PATCH,
                            threshold=THRESHOLD, ignore_index=0)


def plain_dropout_scores(states, vols, gt, passes):
    """The dropout scorer's function from plain parts: per-member UNet3D
    modules with dropout, each pass given the masks the scorer drew (its
    member's channels), float32 softmax, each sample streamed in."""
    import torch
    from values_tpu_torch.inference.scoring import streaming_update
    nets = plain_modules(states, do_dropout=True)
    carry = None
    with torch.no_grad():
        for masks in passes:
            for m, net in enumerate(nets):
                logits = net(vols, keep_masks=member_masks(masks, m))
                carry = streaming_update(carry,
                                         torch.softmax(logits, dim=-1))
    return plain_scores(carry, len(passes) * N_MEMBERS, gt)


def plain_tta_scores(states, vols, gt, noise):
    """The TTA scorer's function from plain parts: the same noise, the 16
    variants through per-member UNet3D modules, un-flipped, streamed."""
    import torch
    from values_tpu_torch.inference.scoring import streaming_update
    from values_tpu_torch.models.ensemble_unet3d import FLIP_COMBOS
    nets = plain_modules(states)
    variance, field = noise
    carry = None
    with torch.no_grad():
        for base in (vols, vols + field * variance):
            for axes in ((),) + FLIP_COMBOS:
                xv = torch.flip(base, axes) if axes else base
                for net in nets:
                    p = torch.softmax(net(xv), dim=-1)
                    carry = streaming_update(
                        carry, torch.flip(p, axes) if axes else p)
    return plain_scores(carry, 16 * N_MEMBERS, gt)


def plain_ssn_scores(states, vols, gt, normals):
    """The SSN scorer's function from plain parts: per-member SsnUNet3D
    modules (their trunk unfused, their heads' low-rank normal), each
    sample given the normals the scorer drew (member-major)."""
    import torch
    from values_tpu_torch.inference.scoring import streaming_update
    nets = plain_modules(states)
    carry, draws = None, iter(normals)
    with torch.no_grad():
        for net in nets:
            dist = net(vols)
            factor, sqrt_diag = dist.sampling_terms()
            for _ in range(N_PRED):
                eps_r, eps_d = next(draws)
                smp = (dist.mean + torch.einsum("bnr,br->bn", factor,
                                                eps_r[0])
                       + sqrt_diag * eps_d[0])
                logits = smp.reshape((vols.shape[0], CLASSES)
                                     + (PATCH,) * 3).movedim(1, -1)
                carry = streaming_update(carry,
                                         torch.softmax(logits, dim=-1))
    return plain_scores(carry, N_PRED * N_MEMBERS, gt)


def stochastic_batches(seed: int, n: int, batch: int = 0):
    """n batches of ``batch`` (default BATCH) 64^3 volumes and masks on
    the card, drawn as the deterministic path draws its batches."""
    import torch
    rs = np.random.RandomState(seed)
    batch = batch or BATCH
    out = []
    for _ in range(n):
        vols = rs.rand(batch, PATCH, PATCH, PATCH, 1).astype(np.float32)
        gt = (rs.rand(batch, PATCH, PATCH, PATCH) > 0.7).astype(np.uint8)
        out.append((torch.from_numpy(vols).cuda(),
                    torch.from_numpy(gt).cuda()))
    return out


def stochastic_path(label: str, make, grouped, k1_per_batch: int, plain,
                    draw, seed: int, card: str):
    """One stochastic scorer at full width: ``make(dtype)`` builds it; a
    warm-up batch, then TIMED_RUNS batches of BATCH, each timed alone
    (host clock ending in a synchronize), K1's launches counted from 0
    over them, peak memory over them; one batch under the profiler; a
    2-volume float32 run against ``plain(vols, gt, draws)``, the draws
    recorded from the scorer's draw function ``draw`` (module, name)
    within atol + rtol 1e-3. Returns the numbers."""
    import torch
    from values_tpu_torch.inference.scoring import score_rows
    score = make(torch.bfloat16)
    batches = stochastic_batches(seed, TIMED_RUNS + 1)
    score(grouped, *batches[0], 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = []
    for i, b in enumerate(batches[1:]):
        t0 = time.perf_counter()
        out = score(grouped, *b, 2 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if tuple(out.shape) != (10, BATCH) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"{label}: scores of shape "
                                 f"{tuple(out.shape)} are not a finite "
                                 "(10, B) matrix")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    expect_launches(launches, {"conv3d_fused": k1_per_batch * TIMED_RUNS,
                               "conv3d_fused_train": 0, "fused_entropy": 0,
                               "sampled_softmax_stats": 0}, label)
    table, wall, busy, k1, _ = device_times(
        lambda: score(grouped, *batches[1], 99))
    with open(os.path.join(OUT_DIR, "profile_" + label.replace(" ", "_")
                           + ".txt"), "w") as fh:
        fh.write(table.table(sort_by="self_device_time_total",
                             row_limit=40, max_name_column_width=120))
    rates = sorted(BATCH / t for t in times)
    vps = float(np.median(rates))
    idle = "not measured" if not busy else f"{1 - busy / wall:.3f}"
    log(f"{label}: {TIMED_RUNS} batches of {BATCH} x {PATCH}^3, bf16, "
        f"each timed alone: median {vps:.2f} volumes/s (min {rates[0]:.2f},"
        f" max {rates[-1]:.2f}; batch ms " + ", ".join(
            f"{t * 1e3:.1f}" for t in times) + f"); peak {peak:.2f} GB; "
        f"launches {json.dumps(launches)} ({k1_per_batch} K1 a batch); one "
        f"batch under the profiler: device {busy:.2f} of {wall:.2f} ms "
        f"wall, idle share {idle}, K1 {k1:.2f} ms; card {card}")

    # correctness: 2 volumes in float32 against the plain path, given the
    # draws the scorer made
    score32 = make(torch.float32)
    vols, gt = stochastic_batches(seed + 1, 1, 2)[0]
    with recorded(*draw) as draws:
        got = score32(grouped, vols, gt, 5)
    want = plain(vols, gt, draws)
    err = (got - want).abs()
    # atol + rtol 1e-3, as the deterministic path's check: float32
    # rounding of the fused (or K1's unfused) and the plain forward on
    # image-level sums of 64^3 voxels; Dice moves ~1e-5 per voxel whose
    # argmax ties
    for i, name in enumerate(score_rows()):
        log(f"  {label} f32 vs plain path {name:34s} max_abs_err "
            f"{float(err[i].max()):.3e}")
    if not bool((err <= 1e-3 + 1e-3 * want.abs()).all()):
        raise AssertionError(f"{label}: the float32 scorer disagrees with "
                             "the plain path")
    return {"launches": launches["conv3d_fused"], "volumes_per_s": vps,
            "min": rates[0], "max": rates[-1], "peak_gb": peak,
            "device_ms": busy, "wall_ms": wall, "k1_ms": k1,
            "max_abs_err": float(err.max())}


def dropout_path(card: str):
    """5 dropout members (random weights), ``make_dropout_scorer`` with
    N_PRED passes: 18 K1 launches a pass (K1's unfused form: statistics
    without prologue at the 8 norm convs), N_PRED passes a batch."""
    from values_tpu_torch.inference.scoring import make_dropout_scorer
    from values_tpu_torch.models import ensemble_unet3d
    from values_tpu_torch.models.torch_import import group_member_state_dicts
    states = member_state_dicts(SEED + 40)
    grouped = group_member_state_dicts(states)

    def make(dtype):
        return make_dropout_scorer(N_MEMBERS, PATCH, n_pred=N_PRED,
                                   agg_patch=AGG_PATCH, threshold=THRESHOLD,
                                   dtype=dtype)[0]

    out = stochastic_path(
        "MC-dropout path", make, grouped, 18 * N_PRED,
        lambda vols, gt, draws: plain_dropout_scores(states, vols, gt,
                                                     draws),
        (ensemble_unet3d, "draw_dropout_masks"), 40, card)
    return out, grouped


def fusion_cost(grouped, card: str):
    """One dropout pass (K1 unfused, the 17 masks drawn and applied)
    beside one fused deterministic forward, both at batch BATCH in bf16
    on the same weights and input: CUDA-event time (median of 10) and
    device kernel time under the profiler."""
    import torch
    from values_tpu_torch.models.ensemble_unet3d import (
        cast_weights, dropout_forward, grouped_forward_fused)
    weights = cast_weights(grouped, torch.bfloat16, "cuda")
    x = stochastic_batches(41, 1)[0][0].to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    fns = {"dropout pass": lambda: dropout_forward(weights, x, N_MEMBERS,
                                                   gen),
           "fused forward": lambda: grouped_forward_fused(weights, x,
                                                          N_MEMBERS)}
    out = {}
    with torch.no_grad():
        for name, fn in fns.items():
            ms = cuda_ms(fn)
            _, wall, busy, k1, _ = device_times(fn)
            out[name] = {"ms": ms, "device_ms": busy, "k1_ms": k1}
    d, f = out["dropout pass"], out["fused forward"]
    log(f"dropout pass vs fused forward (batch {BATCH}, bf16, G = "
        f"{N_MEMBERS}): {d['ms']:.3f} vs {f['ms']:.3f} ms (CUDA events, "
        f"median of 10; ratio {d['ms'] / f['ms']:.2f}); device kernels "
        f"{d['device_ms']:.2f} vs {f['device_ms']:.2f} ms, K1 "
        f"{d['k1_ms']:.2f} vs {f['k1_ms']:.2f} ms; card {card}")
    return out


def tta_path(card: str):
    """The 5 softmax members of the deterministic path through
    ``make_tta_scorer``: 16 fused forwards a batch, 16 x 18 K1
    launches."""
    from values_tpu_torch.inference.scoring import make_tta_scorer
    from values_tpu_torch.models import ensemble_unet3d
    from values_tpu_torch.models.torch_import import group_member_state_dicts
    states = member_state_dicts(SEED)
    grouped = group_member_state_dicts(states)

    def make(dtype):
        return make_tta_scorer(N_MEMBERS, PATCH, agg_patch=AGG_PATCH,
                               threshold=THRESHOLD, dtype=dtype)[0]

    return stochastic_path(
        "TTA path", make, grouped, 16 * 18,
        lambda vols, gt, draws: plain_tta_scores(states, vols, gt,
                                                 draws[0]),
        (ensemble_unet3d, "draw_tta_noise"), 50, card)


def ssn_path(card: str):
    """5 SSN members (random weights, rank SSN_RANK), ``make_ssn_scorer``
    with N_PRED samples each: one fused trunk forward a batch (18 K1
    launches); then the degenerate fallback on the card: heads whose
    cov_diag is ~0 and whose factor is huge give finite scores, every
    item flagged degenerate."""
    import torch
    from values_tpu_torch.inference.scoring import make_ssn_scorer
    from values_tpu_torch.models import ssn_unet3d
    from values_tpu_torch.models.torch_import import group_member_state_dicts
    states = member_state_dicts(SEED + 50, ssn=True)
    grouped = group_member_state_dicts(states)

    def make(dtype):
        return make_ssn_scorer(CLASSES, N_MEMBERS, PATCH, n_pred=N_PRED,
                               rank=SSN_RANK, agg_patch=AGG_PATCH,
                               threshold=THRESHOLD, dtype=dtype)[0]

    out = stochastic_path(
        "SSN path", make, grouped, 18,
        lambda vols, gt, draws: plain_ssn_scores(states, vols, gt, draws),
        (ssn_unet3d, "draw_ssn_normals"), 60, card)
    bad = {k: dict(v) for k, v in grouped.items()}
    bad["log_cov_diag_conv"] = {
        "kernel": torch.zeros_like(grouped["log_cov_diag_conv"]["kernel"]),
        "bias": torch.full_like(grouped["log_cov_diag_conv"]["bias"],
                                -80.0)}
    bad["cov_factor_conv"] = dict(grouped["cov_factor_conv"], bias=torch.full_like(
        grouped["cov_factor_conv"]["bias"], 1e15))
    vols, gt = stochastic_batches(61, 1, 2)[0]
    with recorded(ssn_unet3d.LowRankMVN, "degenerate") as flags:
        got = make(torch.bfloat16)(bad, vols, gt, 3)
    degenerate = [bool(f.all()) for f in flags]
    if not bool(torch.isfinite(got).all()) or not all(degenerate):
        raise AssertionError(f"SSN degenerate fallback: finite "
                             f"{bool(torch.isfinite(got).all())}, every "
                             f"member degenerate {degenerate}")
    log(f"SSN degenerate fallback on the card: cov_diag ~0 (epsilon "
        f"only) and a 1e15 factor: all {len(flags)} members flagged on "
        f"every item, scores finite; card {card}")
    return out


def write_dropout_and_ssn_checkpoints(root: str):
    """The score CLI's dropout set (the dropout path's states) and SSN
    set (the SSN path's)."""
    return {"dropout": write_checkpoints(root, "dropout",
                                         member_state_dicts(SEED + 40),
                                         False, {"do_dropout": True}),
            "ssn": write_checkpoints(
                root, "ssn", member_state_dicts(SEED + 50, ssn=True), False,
                {"_target_": "values_tpu.models.ssn_unet3d.SsnUNet3D",
                 "rank": SSN_RANK, "epsilon": 1e-5})}


def stochastic_cli_path(card: str):
    """``run_score`` over CLI_VOLUMES volumes at batch 32 for the dropout
    set with ``--n_pred N_PRED``, ``-tta`` on the deterministic set and on
    the dropout set, and the SSN set (``n_pred`` from the checkpoints'
    ``n_aleatoric_samples``); each run's launches counted; each JSON
    against its scorer with the CLI's batch seeds on the same batches."""
    import torch
    from values_tpu_torch.core.seed import make_generator
    from values_tpu_torch.inference import scoring
    from values_tpu_torch.inference.score import run_score, score_cli
    from values_tpu_torch.models.torch_import import group_member_state_dicts
    from values_tpu_torch.training.checkpoint import load_any_checkpoint
    rows = scoring.score_rows()
    n_batches = -(-CLI_VOLUMES // BATCH)
    common = dict(agg_patch=AGG_PATCH, threshold=THRESHOLD,
                  dtype=torch.bfloat16)
    out = {}
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as root:
        data = write_cli_data(root, np.random.RandomState(5))
        ckpts = write_dropout_and_ssn_checkpoints(root)
        ckpts["deterministic"] = write_checkpoints(
            root, "det", member_state_dicts(SEED + 20), False)
        runs = {  # name: (set, flags, K1 a batch, scorer)
            "dropout --n_pred": ("dropout", ["--n_pred", str(N_PRED)],
                                 18 * N_PRED, scoring.make_dropout_scorer(
                                     N_MEMBERS, PATCH, n_pred=N_PRED,
                                     **common)[0]),
            "-tta": ("deterministic", ["-tta"], 16 * 18,
                     scoring.make_tta_scorer(N_MEMBERS, PATCH, **common)[0]),
            "dropout -tta": ("dropout", ["-tta"], 16 * 18,
                             scoring.make_tta_scorer(
                                 N_MEMBERS, PATCH, do_dropout=True,
                                 **common)[0]),
            "SSN": ("ssn", [], 18, scoring.make_ssn_scorer(
                CLASSES, N_MEMBERS, PATCH, n_pred=N_ALEATORIC,
                rank=SSN_RANK, **common)[0])}
        subjects = sorted(data)
        for name, (kind, flags, k1, score) in runs.items():
            path = os.path.join(root, "out.json")
            reset_launches()
            t0 = time.perf_counter()
            result = run_score(score_cli([
                "--checkpoint_paths", *ckpts[kind], "-i", root, "--out",
                path, "--test_split", "id", "--batch_size", str(BATCH),
                "--agg_patch", str(AGG_PATCH), "--threshold",
                str(THRESHOLD)] + flags))
            seconds = time.perf_counter() - t0
            launches = read_launches()
            expect_launches(launches, {"conv3d_fused": k1 * n_batches,
                                       "conv3d_fused_train": 0,
                                       "fused_entropy": 0,
                                       "sampled_softmax_stats": 0},
                            f"CLI {name}")
            if sorted(result) != subjects:
                raise AssertionError(f"CLI {name}: the JSON does not hold "
                                     f"the {CLI_VOLUMES} subjects")
            # the JSON against its scorer on the same batches with the
            # seeds run_score draws; K1's bfloat16 tolerance, as the
            # deterministic CLI's check
            grouped = group_member_state_dicts(
                [load_any_checkpoint(p)[1] for p in ckpts[kind]])
            gen = make_generator(CLI_SEED)
            worst = 0.0
            for i in range(0, len(subjects), BATCH):
                chunk = subjects[i:i + BATCH]
                vols = torch.from_numpy(np.stack([data[s][0]
                                                  for s in chunk]))
                gt = torch.from_numpy(np.stack([data[s][1] for s in chunk]))
                seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
                want = score(grouped, vols[..., None].cuda(), gt.cuda(),
                             seed).cpu().numpy()
                got = np.array([[result[s][r] for s in chunk] for r in rows])
                err = np.abs(got - want)
                worst = max(worst, float(err.max()))
                if not np.isfinite(got).all() or (
                        err > 2 ** -7 * np.abs(want) + 2e-3).any():
                    raise AssertionError(f"CLI {name} disagrees with its "
                                         "scorer on the same batches")
            out[name] = launches["conv3d_fused"]
            log(f"CLI {name}: {CLI_VOLUMES} volumes, {N_MEMBERS} "
                f"checkpoints, batch {BATCH}: {seconds:.2f} s (checkpoint "
                f"reading and volume loading included); launches "
                f"{json.dumps(launches)}; against its scorer max_abs_err "
                f"{worst:.3e}; card {card}")
    return out


# the val volumes of the -tta test_3d run (80 samples and 251 maps each)
TTA_CLI_VOLUMES = 2


def test3d_modes_path(joint_ckpts, train_root: str, card: str):
    """``python -m values_tpu_torch.inference.test_3d`` over the Case_1
    validation split (64^3, one window a volume) at f32: ``-tta`` on the
    jointly trained members over TTA_CLI_VOLUMES of its volumes (by
    --test_data_dir/--subject_ids), ``--n_pred 4`` on a dropout copy of
    member 0, and ``--n_pred 4`` on one SSN checkpoint; each tree checked
    file by file and each run's launches counted; then the engine's
    windows/s under ``-tta`` (the median of 3 passes over the split)."""
    import pickle as pkl
    import torch
    from values_tpu_torch.data.samples import get_val_test_data_samples
    from values_tpu_torch.inference import test_3d
    from values_tpu_torch.inference.engine import SlidingWindowEngine
    from values_tpu_torch.models.torch_import import unet3d_params_from_torch
    from values_tpu_torch.models.unet3d import UNet3D
    from values_tpu_torch.training.checkpoint import (load_any_checkpoint,
                                                      save_checkpoint)
    root = tempfile.mkdtemp(dir=OUT_DIR, prefix="test3d_modes_")
    with open(os.path.join(train_root, "Case_1", "splits.pkl"), "rb") as f:
        val = sorted(pkl.load(f)[0]["val"])
    hparams, state = load_any_checkpoint(joint_ckpts[0])
    dropout = os.path.join(root, "dropout.ckpt")
    save_checkpoint(dropout, unet3d_params_from_torch(state), dict(
        hparams, model=dict(hparams["model"], do_dropout=True)))
    ssn = os.path.join(root, "ssn.ckpt")
    save_checkpoint(ssn, unet3d_params_from_torch(
        member_state_dicts(SEED + 50, ssn=True)[0]), dict(hparams, model={
            "_target_": "values_tpu.models.ssn_unet3d.SsnUNet3D",
            "num_classes": CLASSES, "initial_filter_size": FILTERS,
            "rank": SSN_RANK, "epsilon": 1e-5}))
    tta_subjects = val[:TTA_CLI_VOLUMES]
    runs = {"-tta": (joint_ckpts, ["-tta", "--test_data_dir", os.path.join(
                train_root, "Case_1", "preprocessed"), "--subject_ids",
                *tta_subjects], 16 * N_MEMBERS, 16, tta_subjects),
            "dropout --n_pred 4": ([dropout], ["--n_pred", "4"], 4, 4, val),
            "SSN --n_pred 4": ([ssn], ["--n_pred", "4"], 4, 1, val)}
    out = {}
    for name, (paths, flags, samples, forwards, subjects) in runs.items():
        save = os.path.join(root, name.split()[0].strip("-"))
        reset_launches()
        t0 = time.perf_counter()
        carrier = test_3d.run_test(test_3d.test_cli(
            ["--checkpoint_paths", *paths, "--save_dir", save,
             "--test_split", "val", "--dtype", "float32"] + flags))
        seconds = time.perf_counter() - t0
        launches = read_launches()
        expect_launches(launches, {
            "conv3d_fused": 18 * forwards * len(subjects),
            "conv3d_fused_train": 0, "fused_entropy": 0,
            "sampled_softmax_stats": 0}, f"test_3d {name}")
        if any(v["softmax_pred"].shape[0] != samples
               for v in carrier.data.values()):
            raise AssertionError(f"test_3d {name}: not {samples} samples")
        check_result_tree(os.path.join(save, hparams["exp_name"],
                                       "test_results",
                                       str(hparams["version"]), "val"),
                          subjects, n_preds=samples)
        out[f"test_3d {name}"] = launches["conv3d_fused"]
        log(f"test_3d CLI {name} (val split, {len(subjects)} volumes of "
            f"{PATCH}^3, {samples} samples each), f32: {seconds:.2f} s "
            f"(checkpoint reading, volume loading and "
            f"{len(subjects) * (4 + RATERS + (1 + samples) * (1 + CLASSES))}"
            f" nii.gz maps included); launches {json.dumps(launches)}; "
            f"card {card}")
        shutil.rmtree(save)
        del carrier

    members = [unet3d_params_from_torch(load_any_checkpoint(p)[1])
               for p in joint_ckpts]
    samples = get_val_test_data_samples(
        base_dir=os.path.join(train_root, "Case_1", "preprocessed"),
        subject_ids=val, test=False, num_raters=RATERS, patch_size=PATCH)
    engine = SlidingWindowEngine(UNet3D(CLASSES, initial_filter_size=FILTERS),
                                 members, mode="tta", patch_size=PATCH,
                                 window_batch=12, device="cuda")
    engine.run_samples(samples[:1])
    passes = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_samples(samples)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t0)
    rate = len(samples) / float(np.median(passes))
    log(f"test_3d engine -tta ({N_MEMBERS} members x 16 variants, f32): 3 "
        f"passes of {len(samples)} windows over the val split: median "
        f"{float(np.median(passes)):.4f} s (min {min(passes):.4f}, max "
        f"{max(passes):.4f}): {rate:.2f} windows/s (loading from disk and "
        f"the copy back of {16 * N_MEMBERS} samples a window included); "
        f"card {card}")
    shutil.rmtree(root)
    return out, rate


# -- dropout and SSN training, the LIDC datamodule, augmentation ---------------

# Case_1 made by the port's generator at its published options and 64^3,
# cut from 200 training and 20 test volumes to these counts
GEN_TRAIN, GEN_TEST = 24, 2
# the synthetic LIDC tree: patients x nodules, 64^3 crops, 4 raters;
# the first LIDC_ID_PATIENTS patients' textures read ID
LIDC_PATIENTS, LIDC_NODULES, LIDC_ID_PATIENTS = 30, 2, 24
SSN_EPOCHS = ["max_epochs=2", "pretrain_epochs=1"]


def generate_case1(root: str) -> float:
    """``Case_1`` under ``root`` by ``values_tpu_torch.data.
    toy_generation`` (its benchmark options, GEN_TRAIN + GEN_TEST
    volumes); returns the seconds it took."""
    from values_tpu_torch.data import toy_generation as tg
    t0 = time.perf_counter()
    case = {split: [dict(cfg, n_samples=n) for cfg in
                    tg.BENCHMARK_CASES["Case_1"][split]]
            for split, n in (("train", GEN_TRAIN), ("test", GEN_TEST))}
    saved = tg.BENCHMARK_CASES["Case_1"]
    tg.BENCHMARK_CASES["Case_1"] = case
    try:
        tg.main(["--base_save_path", root, "--dataset_name", "Case_1"])
    finally:
        tg.BENCHMARK_CASES["Case_1"] = saved
    return time.perf_counter() - t0


def training_launches(root: str, epochs: int) -> dict:
    """The launches of ``epochs`` epochs on the Case_1 fold: 35 K1 a step
    (17 of them K1b's dx), 18 a validation forward and 18 for the panel."""
    with open(os.path.join(root, "Case_1", "splits.pkl"), "rb") as f:
        fold = pickle.load(f)[0]
    steps = -(-len(fold["train"]) // TRAIN_BATCH)
    n_val = len(fold["val"])
    return {"conv3d_fused": epochs * ((K1_FORWARD + K1_DX) * steps
                                      + K1_FORWARD * (n_val + 1)),
            "conv3d_fused_train": epochs * K1_DX * steps,
            "fused_entropy": 0, "sampled_softmax_stats": 0}


# The bottleneck's leaves (center_conv1, center_conv2, center_up) get a
# per-leaf limit of 3e-2 in the dropout and SSN first-step checks, the
# other leaves first_step_against_plain's 1e-2: their f32 gradients
# cancel heavily, and K1's f32 regimes sum each output's 27 * Cin
# products (1,728-3,456 there) in float32, so on a dropout step the
# kernel path's error there reaches about 1e-2. The dropout check logs
# both f32 paths against the float64 plain path to show it; a wrong
# gradient is off by order 1.
BOTTLENECK_LEAF_LIMIT = 3e-2


def step_against_plain(exp, state, batch, seed: int, pretrain: bool,
                       what: str, card: str, float64: bool = False) -> None:
    """One f32 step's loss and every parameter gradient through the
    kernels and through the plain versions (K1b's plain version in every
    conv), each side drawing its masks and normals from a card generator
    seeded with ``seed``: the limits of ``first_step_against_plain``,
    the bottleneck's leaves at BOTTLENECK_LEAF_LIMIT. ``float64``: also
    log each side's error at the bottleneck against the plain path in
    float64 (the same masks; not for the SSN, whose normals a float64
    run draws anew)."""
    import torch
    from values_tpu_torch.models import ensemble_unet3d as ens
    from values_tpu_torch.training.experiment import tree_leaves, tree_map
    names = [f"{m}/{k}" for m in sorted(state.params)
             for k in sorted(state.params[m].get("conv", state.params[m]))]

    def loss_and_grads(params, data):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        leaves = tree_leaves(params)
        loss = exp.loss(params, dict(batch, data=data), gen, pretrain)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.item(), [torch.zeros_like(t) if g is None else g
                             for t, g in zip(leaves, grads)]

    got_loss, got = loss_and_grads(state.params, batch["data"])
    real = ens.conv3d_fused_train
    ens.conv3d_fused_train = plain_train_conv
    try:
        want_loss, want = loss_and_grads(state.params, batch["data"])
        if float64:
            _, exact = loss_and_grads(
                tree_map(lambda t: t.detach().double().requires_grad_(True),
                         state.params), batch["data"].double())
    finally:
        ens.conv3d_fused_train = real
    pairs = [(n, a, w) for n, a, w in zip(names, got, want)
             if not (n.startswith("contr_") and n.endswith("bias"))
             and bool(w.any())]
    rel = {n: float((a - w).norm() / w.norm()) for n, a, w in pairs}
    total = float(torch.sqrt(sum(((a - w) ** 2).sum() for _, a, w in pairs))
                  / torch.sqrt(sum((w ** 2).sum() for _, _, w in pairs)))
    deep = {n: v for n, v in rel.items() if n.startswith("center_")}
    rest = {n: v for n, v in rel.items() if n not in deep}
    worst_name = max(rest, key=rest.get)
    deep_name = max(deep, key=deep.get)
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    zero = [n for n, a, w in zip(names, got, want)
            if not bool(w.any()) and not n.endswith("bias")]
    against64 = ""
    if float64:
        e = exact[names.index(deep_name)]
        a, w = got[names.index(deep_name)], want[names.index(deep_name)]
        against64 = (f"; against float64 at {deep_name}: kernel path "
                     f"{float((a.double() - e).norm() / e.norm()):.2e}, "
                     f"plain f32 path "
                     f"{float((w.double() - e).norm() / e.norm()):.2e}")
    log(f"{what} against the plain path: loss {got_loss:.7f} vs "
        f"{want_loss:.7f} (rel {loss_rel:.2e}); gradient error {total:.2e} "
        f"of the norm over {len(pairs)} leaves, largest {rest[worst_name]:.2e}"
        f" ({worst_name}), at the bottleneck {deep[deep_name]:.2e} "
        f"({deep_name}){against64}; leaves with a zero gradient on both "
        f"sides {zero}; card {card}")
    if (loss_rel > 1e-5 or total > 1e-3 or rest[worst_name] > 1e-2
            or deep[deep_name] > BOTTLENECK_LEAF_LIMIT):
        raise AssertionError(f"{what} disagrees with the plain path")


def adam_moves_unused_head(exp, state, batch, card: str) -> None:
    """One SSN pretraining step: ``cov_factor_conv`` is out of the graph,
    so its gradient is 0 and Adam's first step moves each weight by
    ``lr * g / (|g| + eps)`` with g = weight_decay * w, as optax does."""
    import torch
    before = {k: v.detach().clone()
              for k, v in state.params["cov_factor_conv"].items()}
    exp.train_step(state, batch, torch.Generator(device="cuda")
                   .manual_seed(1), pretrain=True)
    lr, wd = exp.learning_rate, exp.weight_decay
    worst, moved = 0.0, 0.0
    for key, w in before.items():
        g = wd * w
        want = w - lr * g / (g.abs() + 1e-8)
        got = state.params["cov_factor_conv"][key].detach()
        worst = max(worst, float((got - want).abs().max()))
        moved = max(moved, float((got - w).abs().max()))
    log(f"SSN pretraining step: cov_factor_conv moved by up to {moved:.3e} "
        f"(lr {lr}), {worst:.2e} from Adam's step on a zero gradient with "
        f"weight decay {wd}; card {card}")
    if worst > 1e-7 or moved < 0.5 * lr:
        raise AssertionError("the unused SSN head did not move as Adam "
                             "moves a zero gradient")


def profile_step(step, filename: str) -> dict:
    """One step under torch.profiler: device time, idle share, the five
    largest device ops."""
    before = read_launches()
    table, wall, busy, k1, dw = device_times(step)
    k1_launches = read_launches()["conv3d_fused"] - before["conv3d_fused"]
    with open(os.path.join(OUT_DIR, filename), "w") as fh:
        fh.write(table.table(sort_by="self_device_time_total",
                             row_limit=40))
    ops = sorted((e for e in table if "CUDA" in str(e.device_type)
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:5]
    top = [(e.key[:60], e.self_device_time_total / 1e3) for e in ops]
    return {"wall_ms": wall, "busy_ms": busy, "k1_ms": k1, "dw_ms": dw,
            "idle": None if not busy else 1 - busy / wall, "top": top,
            "records": kernel_records(table, {"conv3d_fused": k1_launches})}


def time_steps(step, batch_volumes: int, label: str, filename: str,
               card: str) -> dict:
    """ms a step and volumes trained/s (median, min-max over TIMED_STEPS
    steps after 2 warm-up steps, host clock ending in a synchronize),
    peak memory, and a profile of one more step."""
    import torch
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_step(step, filename)
    med = statistics.median(times)
    out = {"step_ms": times, "median_ms": med,
           "volumes_per_s": batch_volumes / med * 1e3,
           "min_vps": batch_volumes / max(times) * 1e3,
           "max_vps": batch_volumes / min(times) * 1e3, "peak_gb": peak,
           "profile": prof}
    log(f"{label}: steps " + " / ".join(f"{t:.2f}" for t in times)
        + f" ms, median {med:.2f} ms, {out['volumes_per_s']:.2f} volumes "
        f"trained/s ({out['min_vps']:.2f}-{out['max_vps']:.2f}), peak "
        f"{peak:.2f} GB; one profiled step: device {prof['busy_ms']:.2f} of "
        f"{prof['wall_ms']:.2f} ms wall, idle share "
        + ("not measured" if prof["idle"] is None else f"{prof['idle']:.3f}")
        + f", K1 {prof['k1_ms']:.2f} ms, dW (cuDNN) {prof['dw_ms']:.2f} ms;"
        " top device ops " + ", ".join(f"{n} {t:.2f} ms"
                                       for n, t in prof["top"])
        + f"; {records_note(prof['records'])}; card {card}")
    return out


def experiment_for(name: str, root: str, extra: list):
    """A port Experiment on config ``name`` at its published widths, its
    state from the config's seed, and the first training batch of the
    Case_1 fold on the card."""
    from values_tpu_torch.config import compose, instantiate
    from values_tpu_torch.training.experiment import Experiment
    from values_tpu_torch.training.loops import _device_batch
    from values_tpu_torch.training.main import DEFAULT_CONFIG_DIR
    cfg = compose(DEFAULT_CONFIG_DIR, name, [
        f"data_input_dir={root}", f"save_dir={root}/exp"] + extra)
    dm = instantiate(cfg.datamodule, data_input_dir=root,
                     batch_size=cfg.batch_size)
    dm.setup()
    batch = _device_batch(next(iter(dm.train_dataloader())), "cuda")
    exp = Experiment(cfg, "cuda")
    return cfg, exp, exp.init_state(cfg.seed, cfg.datamodule.patch_size), \
        batch


def joint_dropout_path(root: str, card: str) -> dict:
    """EnsembleTrainer on dropout_config with N_MEMBERS members (G = 5),
    JOINT_STEPS steps at f32 and at bf16, member m drawing its masks
    from its own card generator; 35 launches a step at G = 5; the first
    f32 step held against N_MEMBERS Experiment steps given the same
    generators (so the same masks)."""
    import torch
    from values_tpu_torch.config import compose
    from values_tpu_torch.ops.kernels.conv3d import conv3d_fused
    from values_tpu_torch.training.ensemble import EnsembleTrainer
    from values_tpu_torch.training.main import DEFAULT_CONFIG_DIR

    def gens():
        return [torch.Generator(device="cuda").manual_seed(200 + m)
                for m in range(N_MEMBERS)]

    out = {}
    for name, extra in (("f32", []), ("bf16", ["+precision=bf16"])):
        cfg = compose(DEFAULT_CONFIG_DIR, "dropout_config",
                      [f"data_input_dir={root}", f"save_dir={root}/exp"]
                      + extra)
        trainer = EnsembleTrainer(cfg, N_MEMBERS, "cuda")
        state = trainer.init_state(cfg.seed, PATCH)
        batches = joint_batches(cfg, root, N_MEMBERS)
        if name == "f32":
            joint_step_against_experiments(trainer, state, batches[0], cfg,
                                           card, generators=gens)
        regimes = dict(conv3d_fused.regime_launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        times = []
        for batch in batches:
            t0 = time.perf_counter()
            _, losses = trainer.train_step(state, batch, gens())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches()
        expect_launches(launches, {
            "conv3d_fused": (K1_FORWARD + K1_DX) * JOINT_STEPS,
            "conv3d_fused_train": K1_DX * JOINT_STEPS, "fused_entropy": 0,
            "sampled_softmax_stats": 0},
            f"joint dropout training {name} ({JOINT_STEPS} steps at "
            f"G={N_MEMBERS})")
        expect_f32_regime(regimes_since(regimes), name == "f32",
                          f"joint dropout training {name}")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"joint dropout {name}: losses {losses}")
        med = statistics.median(times[1:])
        vps = N_MEMBERS * TRAIN_BATCH / med * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = (profile_step(lambda: trainer.train_step(state, batches[0],
                                                        gens()),
                             "profile_joint_dropout_bf16.txt")
                if name == "bf16" else None)
        out[name] = {"step_ms": times, "median_ms": med,
                     "volumes_per_s": vps, "peak_gb": peak,
                     "launches": launches, "profile": prof}
        log(f"joint dropout training {name}, {N_MEMBERS} members x batch "
            f"{TRAIN_BATCH} x {PATCH}^3: steps " + " / ".join(
                f"{t:.1f}" for t in times) + f" ms (median of steps 2-"
            f"{JOINT_STEPS}: {med:.2f} ms), {vps:.2f} volumes trained/s, "
            f"peak {peak:.2f} GB; losses " + " ".join(
                f"{v:.4f}" for v in losses.tolist())
            + f"; launches {json.dumps(launches)}" + (
                "" if prof is None else
                f"; one profiled step: device {prof['busy_ms']:.2f} of "
                f"{prof['wall_ms']:.2f} ms wall, idle share "
                + ("not measured" if prof["idle"] is None
                   else f"{prof['idle']:.3f}")
                + ", top device ops " + ", ".join(
                    f"{n} {t:.2f} ms" for n, t in prof["top"])
                + f"; {records_note(prof['records'])}")
            + f"; card {card}")
    return out


def write_lidc(root: str) -> dict:
    """A synthetic LIDC tree under ``root`` (the reference's flat layout):
    LIDC_PATIENTS x LIDC_NODULES 64^3 crops with 4 rater masks each and
    a metadata.csv with patient ids and ratings; ``id_ood.csv`` made
    from it by the port's ``lidc.calculate_rater_agreement``, so the
    datamodule makes its own splits. Returns the row counts."""
    from values_tpu_torch.core import nifti
    from values_tpu_torch.data import lidc
    rs = np.random.RandomState(8)
    grid = np.indices((PATCH,) * 3).astype(np.float32)
    features = ["subtlety", "internal Structure", "calcification",
                "sphericity", "margin", "lobulation", "spiculation",
                "texture", "malignancy"]
    rows = []
    for os_dir in ("images", "labels"):
        os.makedirs(os.path.join(root, os_dir), exist_ok=True)
    for p in range(LIDC_PATIENTS):
        for n in range(LIDC_NODULES):
            image_id = f"{p:04d}_{n:02d}"
            center = rs.uniform(24, 40, 3)[:, None, None, None]
            dist = np.sqrt(((grid - center) ** 2).sum(0))
            radius = rs.uniform(4, 12)
            image = (-800 + 900 * (dist < radius)
                     + 60 * rs.randn(*dist.shape)).astype(np.float32)
            nifti.save(image, os.path.join(root, "images",
                                           f"{image_id}.nii.gz"))
            segs = []
            for r in range(4):
                path = os.path.join(root, "labels",
                                    f"{image_id}_{r:02d}_mask.nii.gz")
                nifti.save((dist < radius + r - 1.5).astype(np.intc), path)
                segs.append(path)
            texture = [int(v) for v in (rs.randint(3, 6, 4)
                                        if p < LIDC_ID_PATIENTS
                                        else rs.randint(1, 3, 4))]
            row = {"Patient ID": f"LIDC-IDRI-{p:04d}", "Scan ID": f"{p:04d}",
                   "Nodule Index": f"{n:02d}",
                   "Image Save Path": os.path.join(root, "images",
                                                   f"{image_id}.nii.gz"),
                   "Segmentation Save Paths": str(segs)}
            row.update({f: str([3, 3, 3, 3]) for f in features})
            row["texture"] = str(texture)
            rows.append(row)
    lidc.write_table(os.path.join(root, "metadata.csv"), list(rows[0]),
                     rows)
    kept = lidc.calculate_rater_agreement(root)
    return {"nodules": len(rows), "labelled": len(kept),
            "id": sum(r["texture_id"] is True for r in kept)}


def lidc_path(card: str) -> dict:
    """softmax_config_lidc through the training CLI for one epoch on the
    synthetic LIDC tree (the datamodule preprocesses it and makes its
    first-cycle splits from id_ood.csv); launches counted."""
    from values_tpu_torch.core.io import load_pickle
    root = tempfile.mkdtemp(dir=OUT_DIR, prefix="lidc_")
    t0 = time.perf_counter()
    counts = write_lidc(root)
    write_s = time.perf_counter() - t0
    ckpt, seconds, launches, losses = run_config_cli(
        "softmax_config_lidc", root, "lidc", [], card)
    fold = load_pickle(os.path.join(root, "splits_texture.pkl"))[0]
    steps = -(-len(fold["train"]) // TRAIN_BATCH)
    expect_launches(launches, {
        "conv3d_fused": (K1_FORWARD + K1_DX) * steps
        + K1_FORWARD * (len(fold["val"]) + 1),
        "conv3d_fused_train": K1_DX * steps, "fused_entropy": 0,
        "sampled_softmax_stats": 0}, "LIDC training CLI")
    log(f"LIDC tree: {counts['nodules']} nodules of {LIDC_PATIENTS} "
        f"patients ({counts['labelled']} with a texture label, "
        f"{counts['id']} ID), written in {write_s:.2f} s; splits: "
        + ", ".join(f"{k} {len(v)}" for k, v in fold.items())
        + f"; one epoch {seconds:.2f} s (preprocessing and splitting "
        f"included), {steps} steps; card {card}")
    shutil.rmtree(root)
    return {"launches": launches["conv3d_fused"], "steps": steps}


def dropout_ssn_training_path(card: str) -> dict:
    """The training of dropout and SSN models at published widths
    (configs/dropout_config.yaml, ssn_config.yaml: UNet3D f 8, 64^3,
    batch 8, Adam 3e-4, weight decay 1e-5; the SSN rank 10 with 10
    samples) on a Case_1 made by the port's generator: the CLIs at f32
    and bf16 (the SSN for 2 epochs, pretraining the first), launches
    counted; the f32 first steps against the plain path; Adam on the
    unused SSN head; joint MC-dropout training at G = 5; both
    checkpoints through the score CLI; softmax_config_lidc on a
    synthetic LIDC tree and augment=True on Case_1; step timings and
    profiles."""
    import torch
    from values_tpu_torch.inference.score import run_score, score_cli
    from values_tpu_torch.inference.scoring import score_rows
    os.makedirs(OUT_DIR, exist_ok=True)
    root = tempfile.mkdtemp(dir=OUT_DIR, prefix="train8_")
    gen_s = generate_case1(root)
    log(f"Case_1 by the port's generator: {GEN_TRAIN} training and "
        f"{GEN_TEST} test volumes of {PATCH}^3 with 3 raters in "
        f"{gen_s:.2f} s; card {card}")
    out = {"launches": {}}
    runs = {}
    for name, epochs, extra in (("dropout_config", 1, []),
                                ("ssn_config", 2, SSN_EPOCHS)):
        for version, prec in (("f32", []), ("bf16", ["+precision=bf16"])):
            ckpt, _, launches, losses = run_config_cli(
                name, root, f"{name}_{version}", extra + prec, card)
            expect_launches(launches, training_launches(root, epochs),
                            f"training CLI {name} {version} (35 K1 a step, "
                            "17 of them K1b's dx; 18 a validation forward)")
            out["launches"][f"{name} {version} CLI"] = launches
            runs[(name, version)] = ckpt
    # the f32 first steps against the plain path
    _, dexp, dstate, dbatch = experiment_for("dropout_config", root, [])
    step_against_plain(dexp, dstate, dbatch, 11, False,
                       "first f32 dropout step", card, float64=True)
    _, sexp, sstate, sbatch = experiment_for("ssn_config", root, [])
    step_against_plain(sexp, sstate, sbatch, 12, True,
                       "first f32 SSN pretraining step", card)
    step_against_plain(sexp, sstate, sbatch, 13, False,
                       "first f32 SSN sampling step", card)
    adam_moves_unused_head(sexp, sstate, sbatch, card)
    # step timings at G = 1
    gen = torch.Generator(device="cuda").manual_seed(3)
    out["timings"] = {}
    for name in ("dropout_config", "ssn_config"):
        for version, prec in (("f32", []), ("bf16", ["+precision=bf16"])):
            _, exp, state, batch = experiment_for(name, root, prec)
            pretrain = False
            reset_launches()
            exp.train_step(state, batch, gen, pretrain)
            expect_launches(read_launches(), {
                "conv3d_fused": K1_FORWARD + K1_DX,
                "conv3d_fused_train": K1_DX, "fused_entropy": 0,
                "sampled_softmax_stats": 0}, f"one {name} {version} step")
            out["timings"][f"{name} {version}"] = time_steps(
                lambda: exp.train_step(state, batch, gen, pretrain),
                TRAIN_BATCH, f"{name} step {version}, batch {TRAIN_BATCH} "
                f"x {PATCH}^3", f"profile_step_{name}_{version}.txt", card)
    out["joint"] = joint_dropout_path(root, card)
    # serve back the f32 checkpoints through the score CLI
    with open(os.path.join(root, "Case_1", "splits.pkl"), "rb") as f:
        n_val = len(pickle.load(f)[0]["val"])
    batches = -(-n_val // TRAIN_BATCH)
    for name, flags, k1 in (("dropout_config", ["--n_pred", str(N_PRED)],
                             18 * N_PRED), ("ssn_config", [], 18)):
        reset_launches()
        scores = run_score(score_cli([
            "--checkpoint_paths", runs[(name, "f32")], "-i", root, "--out",
            os.path.join(root, f"scores_{name}.json"), "--test_split",
            "val", "--batch_size", str(TRAIN_BATCH), "--device", "cuda"]
            + flags))
        launches = read_launches()
        expect_launches(launches, {"conv3d_fused": k1 * batches,
                                   "conv3d_fused_train": 0,
                                   "fused_entropy": 0,
                                   "sampled_softmax_stats": 0},
                        f"score CLI on the {name} checkpoint")
        if len(scores) != n_val or not all(
                list(s) == score_rows() and all(np.isfinite(list(s.values())))
                for s in scores.values()):
            raise AssertionError(f"scores of the {name} checkpoint: "
                                 f"{scores}")
        out["launches"][f"score CLI on the {name} checkpoint"] = launches
        log(f"score CLI on the trained {name} checkpoint "
            f"{' '.join(flags)}: {n_val} val volumes, mean dice "
            f"{np.mean([s['dice'] for s in scores.values()]):.4f}, all rows "
            f"finite; launches {json.dumps(launches)}; card {card}")
    # augment=True for one epoch on Case_1 (bf16)
    _, _, launches, losses = run_config_cli(
        "softmax_config", root, "augment",
        ["+precision=bf16", "+datamodule.augment=true"], card)
    expect_launches(launches, training_launches(root, 1), "augment=True")
    out["launches"]["augment=True CLI"] = launches
    shutil.rmtree(root)
    out["lidc"] = lidc_path(card)
    return out


# -- evaluation and active learning ------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
AL_SEEDS = (123, 124)     # the first cycle: two members, one Ensemble
AL_SPLITS = ("val", "id", "ood", "unlabeled")
# eval_config_lidc's version name "{shift}_fold{fold}_seed{seed}" at seed 123
AL_VERSION = "texture_fold0_seed123"
EVAL_TASKS = ("threshold", "aggregation", "ood_detection",
              "failure_detection", "calibration", "ambiguity_modeling",
              "second_cycle_splits", "second_cycle_splits_random")
# the second-cycle runs that the Ensemble's al_improvement reads: its
# non-aleatoric uncertainties x aggregations, and the random baseline
AL_QUERIES = [(unc, agg) for unc in ("predictive_uncertainty",
                                     "epistemic_uncertainty")
              for agg in ("patch_level", "threshold")] + [("random",
                                                           "random")]
# the card's box filter against the host's float64 convolution: float32
# cumulative sums rounded each box to under 1e-6 of its value (160 maps
# of this phase on an H100), which left a tenfold margin; since PR 10
# the card's sums are float64
BOX_RTOL = 1e-5


def eval_overrides(first: str, second: str, splits: str, models) -> list:
    """eval_config_lidc cut to one shift, one seed and ``models``, over
    the results under ``first`` and ``second`` and the splits under
    ``splits``."""
    return [f"base_path={first}", f"second_cycle_path={second}",
            "LIDC.iter_params.shift=[texture]",
            f"LIDC.iter_params.pred_model=[{', '.join(models)}]",
            "LIDC.iter_params.seed=['123']"] + [
        f"task_params.{task}.function.base_splits_path={splits}"
        for task in ("ood_detection", "second_cycle_splits",
                     "second_cycle_splits_random")]


def run_eval(overrides: list, tasks) -> float:
    """The evaluation CLI's driver on eval_config_lidc composed with
    ``overrides``, over ``tasks`` (the CLI cannot select them: ``tasks=``
    names the config group ``tasks/``); returns its seconds. A sample the
    OoD rule cannot place fails the run."""
    import io
    import warnings
    from values_tpu_torch.config import compose
    from values_tpu_torch.evaluation import EvalExperiments
    cfg = compose(os.path.join(REPO, "configs", "evaluation"),
                  "eval_config_lidc", overrides)
    cfg["tasks"] = list(tasks)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        EvalExperiments(cfg).analyse()
    if "Could not find" in out.getvalue():
        raise AssertionError(f"evaluation: {out.getvalue()}")
    return time.perf_counter() - t0


def al_test_3d(ckpts, data: str, save_dir: str, exp_name: str,
               split: str, dtype: str = "bfloat16"):
    """The test_3d CLI over one LIDC split, 18 K1 launches per volume (one
    64^3 window, one chunk each), K1's float32 regimes alone in float32
    and never in bfloat16; returns (seconds, launches, volumes, mean dice,
    the carrier)."""
    from values_tpu_torch.inference import test_3d
    from values_tpu_torch.ops.kernels.conv3d import conv3d_fused
    what = f"test_3d {exp_name} {split} {dtype}"
    regimes = dict(conv3d_fused.regime_launches)
    reset_launches()
    t0 = time.perf_counter()
    carrier = test_3d.run_test(test_3d.test_cli(
        ["--checkpoint_paths", *ckpts, "-i", data, "--save_dir", save_dir,
         "--exp_name", exp_name, "--test_split", split, "--dtype", dtype,
         "--device", "cuda"]))
    seconds = time.perf_counter() - t0
    launches = read_launches()
    n = len(carrier.data)
    expect_launches(launches, {"conv3d_fused": 18 * n,
                               "conv3d_fused_train": 0, "fused_entropy": 0,
                               "sampled_softmax_stats": 0},
                    f"{what} ({n} volumes)")
    expect_f32_regime(regimes_since(regimes), dtype == "float32", what)
    dice = [v["metrics"]["dice"] for v in carrier.data.values()]
    if not n or not np.isfinite(dice).all():
        raise AssertionError(f"{what}: dice {dice}")
    return seconds, launches, n, float(np.mean(dice)), carrier


def lidc_epoch_launches(splits_file: str) -> dict:
    """One epoch of softmax_config_lidc on a splits file: 35 K1 a step
    (17 of them K1b's dx), 18 a validation forward and 18 for the panel."""
    from values_tpu_torch.core.io import load_pickle
    fold = load_pickle(splits_file)[0]
    steps = -(-len(fold["train"]) // TRAIN_BATCH)
    return {"conv3d_fused": (K1_FORWARD + K1_DX) * steps
            + K1_FORWARD * (len(fold["val"]) + 1),
            "conv3d_fused_train": K1_DX * steps, "fused_entropy": 0,
            "sampled_softmax_stats": 0}


def _metric_leaves(node, key):
    """Every value under ``key`` in a task JSON."""
    if isinstance(node, dict):
        for k, v in node.items():
            if k == key and not isinstance(v, dict):
                yield v
            else:
                yield from _metric_leaves(v, key)


def check_task_results(first: str, splits: str) -> dict:
    """The task JSONs and split files: thresholds and Platt parameters
    finite; AUROC, detection rate and ACE in [0, 1]; AURC and E-AURC
    finite; NCC in [-1, 1], NaN only where a map has zero variance (R3);
    each queried training split half the unlabeled pool larger. Returns
    the means, for the log."""
    from values_tpu_torch.core.io import load_pickle
    from values_tpu_torch.evaluation import ExperimentDataloader
    from values_tpu_torch.evaluation.experiment_version import (
        ExperimentVersion)

    def load(*parts):
        with open(os.path.join(*parts)) as f:
            return json.load(f)

    out = {}
    thresholds = load(first, "threshold_analysis.json")
    if not all(np.isfinite(v) for d in thresholds.values()
               for v in d.values()):
        raise AssertionError(f"thresholds: {thresholds}")
    out["thresholds"] = thresholds["Mean"]
    for model in ("Softmax", "Ensemble"):
        exp = os.path.join(first, model, "test_results", AL_VERSION)
        platt = load(exp, "platt_scale_params.json")
        ood = load(exp, "ood_detection.json")
        rates = list(_metric_leaves(ood, "ood_detection_rate"))
        aurocs = list(_metric_leaves(ood, "auroc"))
        if not platt or not all(np.isfinite(v) for d in platt.values()
                                for v in d.values()) or not all(
                0 <= v <= 1 for v in rates + aurocs):
            raise AssertionError(f"{model}: Platt {platt}, OoD {ood}")
        out[model] = {"auroc": aurocs, "ood_detection_rate": rates}
        for split in ("id", "ood"):
            fd = load(exp, split, "failure_detection.json")
            aces = list(_metric_leaves(load(exp, split, "calibration.json"),
                                       "ace"))
            ncc = load(exp, split, "ambiguity_modeling.json")
            aurc = list(_metric_leaves(fd, "aurc")) + list(
                _metric_leaves(fd, "eaurc"))
            if not np.isfinite(aurc).all() or not all(0 <= v <= 1
                                                      for v in aces):
                raise AssertionError(f"{model} {split}: {fd}, ACE {aces}")
            unc_types = list(ncc["mean"])
            version = ExperimentVersion(
                first, "{shift}_fold{fold}_seed{seed}", model, ".nii.gz",
                ".nii.gz", unc_types, [], 4, shift="texture", fold=0,
                seed="123")
            dl = ExperimentDataloader(version, split)
            for unc, m in ncc["mean"].items():
                if np.isnan(m["metrics"]["ncc"]) and not any(
                        np.isnan(v[unc]["metrics"]["ncc"])
                        for k, v in ncc.items() if k != "mean"):
                    raise AssertionError(f"NCC mean NaN: {model} {split}")
            for image_id, uncs in ncc.items():
                for unc, m in uncs.items():
                    v = m["metrics"]["ncc"]
                    if np.isnan(v) and image_id != "mean":
                        flat = (np.var(dl.get_gt_unc_map(image_id)) == 0
                                or np.var(dl.get_unc_map(image_id, unc)) == 0)
                        if not flat:
                            raise AssertionError(f"NCC NaN without R3: {model}"
                                                 f" {split} {image_id} {unc}")
                    elif not np.isnan(v) and not -1 <= v <= 1:
                        raise AssertionError(f"NCC {v}: {model} {split} "
                                             f"{image_id} {unc}")
            out[model][split] = {
                "aurc": float(np.mean(list(_metric_leaves(fd, "aurc")))),
                "ace": [m["metrics"]["ace"] for m in load(
                    exp, split, "calibration.json")["mean"].values()],
                "ncc": [m["metrics"]["ncc"] for m in ncc["mean"].values()]}
    first_fold = load_pickle(os.path.join(splits, "texture", "firstCycle",
                                          "splits.pkl"))[0]
    pool = (len(first_fold["id_unlabeled_pool"])
            + len(first_fold["ood_unlabeled_pool"]))
    files = sorted(os.path.relpath(os.path.join(d, f), splits)
                   for d, _, fs in os.walk(os.path.join(splits, "texture",
                                                        "secondCycle"))
                   for f in fs)
    for rel in files:
        fold = load_pickle(os.path.join(splits, rel))[0]
        if (len(fold["train"]) != len(first_fold["train"]) + pool // 2
                or len(fold["id_unlabeled_pool"])
                + len(fold["ood_unlabeled_pool"]) != pool - pool // 2):
            raise AssertionError(f"{rel}: train {len(fold['train'])}")
    out["split_files"] = files
    return out


@contextlib.contextmanager
def watched(module, name: str):
    """Record every call of ``module.name`` while the block runs: (ms on
    the host clock, the device type of its first argument or None)."""
    fn = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            device = getattr(args[0], "device", None) if args else None
            calls.append(((time.perf_counter() - t0) * 1e3,
                          getattr(device, "type", None)))

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def compare_device_aggregation(host: dict, device: dict, unc_map,
                               card_calls: int) -> dict:
    """The use_device run's JSONs against the host's, keyed by (model,
    split, unc): every patch score within BOX_RTOL of the host's float64
    one; the same bounding box, or where float32 rounding broke a
    near-tie, a box whose float64 sum on the host's map (``unc_map(key,
    image)``) is within BOX_RTOL of the host's box's; the other
    aggregations identical; one box filter on a card tensor per map."""
    worst = {"abs": 0.0, "rel": 0.0, "maps": 0, "ties": 0}
    for key, images in host.items():
        for image, aggs in images.items():
            got = device[key][image]
            for agg, value in aggs.items():
                if agg != "patch_level":
                    if got[agg] != value:
                        raise AssertionError(f"{key} {image} {agg}")
                    continue
                a, b = got[agg]["max_score"], value["max_score"]
                err = abs(a - b)
                if err > BOX_RTOL * abs(b):
                    raise AssertionError(f"box filter on the card: {key} "
                                         f"{image}: {a} against {b}")
                if got[agg]["bounding_box"] != value["bounding_box"]:
                    heat = unc_map(key, image)
                    card, ref = (
                        float(heat[tuple(slice(*side) for side in box)].sum(
                            dtype=np.float64))
                        for box in (got[agg]["bounding_box"],
                                    value["bounding_box"]))
                    if abs(card - ref) > BOX_RTOL * abs(ref):
                        raise AssertionError(
                            f"box filter on the card: {key} {image}: box "
                            f"{got[agg]['bounding_box']} against "
                            f"{value['bounding_box']}")
                    worst["ties"] += 1
                worst["abs"] = max(worst["abs"], err)
                worst["rel"] = max(worst["rel"], err / max(abs(b), 1e-30))
                worst["maps"] += 1
    if card_calls != worst["maps"]:
        raise AssertionError(f"use_device: {card_calls} box filters on the "
                             f"card for {worst['maps']} maps")
    return worst


def box_filter_card_ms(path: str) -> float:
    """The box filter alone on one 64^3 map already on the card, in
    float64 as the aggregation runs it (CUDA events)."""
    import torch
    from values_tpu_torch.core import nifti
    from values_tpu_torch.ops.aggregation import box_filter_sum
    image, _ = nifti.load(path)
    x = torch.from_numpy(np.ascontiguousarray(image, np.float64)).cuda()
    return cuda_ms(lambda: box_filter_sum(x, (10,) * 3, range(3)))


def al_unc_map(first: str):
    """(model, split, unc), image file -> that uncertainty map under
    ``first``."""
    from values_tpu_torch.evaluation import ExperimentDataloader
    from values_tpu_torch.evaluation.experiment_version import (
        ExperimentVersion)

    def load(key, image):
        model, split, unc = key
        dl = ExperimentDataloader(ExperimentVersion(
            first, "{shift}_fold{fold}_seed{seed}", model, ".nii.gz",
            ".nii.gz", [unc], [], 4, shift="texture", fold=0, seed="123"),
            split)
        return dl.get_unc_map(image[:-len(".nii.gz")], unc)
    return load


def al_path(card: str) -> dict:
    """The active-learning loop on the card (eval_config_lidc,
    softmax_config_lidc at published widths, bf16): a synthetic LIDC
    tree; the first cycle (2 seeds x 1 epoch through the training CLI,
    test_3d on the Ensemble of both and on Softmax over val, id, ood and
    unlabeled, and over val in float32 against the plain path); the
    evaluation CLI's 8 tasks, the aggregation once more on the card; the
    second cycle (al_driver's dry run, then the 5 runs
    that al_improvement reads, each through al_driver, and its test_3d
    over ood, moved into al_improvement's layout); al_improvement.
    Every run's launches counted, every task file checked."""
    import io
    from pathlib import Path
    import torch
    from values_tpu_torch.core.io import load_pickle
    from values_tpu_torch.evaluation import al_driver
    from values_tpu_torch.evaluation import (
        aggregate_uncertainties as aggregate_module)
    from values_tpu_torch.evaluation.metrics import ace
    from values_tpu_torch.training import experiment as experiment_module
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(dir=OUT_DIR, prefix="al_")
    data, first, second, splits = (os.path.join(root, d) for d in (
        "LIDC", "FirstCycle", "SecondCycle", "splits"))
    os.makedirs(data)
    t0 = time.perf_counter()
    counts = write_lidc(data)
    write_s = time.perf_counter() - t0
    out = {"launches": {}, "seconds": {"write": write_s}}

    # step times of every training run (the cost of a synchronize a step)
    step_ms = []
    train_step = experiment_module.Experiment.train_step

    def timed_train_step(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = train_step(self, *args, **kwargs)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return result

    experiment_module.Experiment.train_step = timed_train_step
    try:
        # first cycle
        ckpts = []
        for seed in AL_SEEDS:
            ckpt, seconds, launches, _ = run_config_cli(
                "softmax_config_lidc", data, f"texture_fold0_seed{seed}",
                ["+precision=bf16", f"seed={seed}"], card)
            expect_launches(launches, lidc_epoch_launches(
                os.path.join(data, "splits_texture.pkl")),
                f"first cycle, seed {seed}")
            out["launches"][f"AL first cycle seed {seed} CLI"] = launches
            ckpts.append(ckpt)
        first_steps = list(step_ms)
        os.makedirs(os.path.join(splits, "texture", "firstCycle"))
        shutil.copy(os.path.join(data, "splits_texture.pkl"),
                    os.path.join(splits, "texture", "firstCycle",
                                 "splits.pkl"))
        t0 = time.perf_counter()
        test_runs = {}
        for exp_name, members in (("Ensemble", ckpts),
                                  ("Softmax", ckpts[:1])):
            for split in AL_SPLITS:
                test_runs[exp_name, split] = al_test_3d(
                    members, data, first, exp_name, split)[:4]
                out["launches"][f"AL test_3d {exp_name} {split}"] = \
                    test_runs[exp_name, split][1]
        out["seconds"]["first test_3d"] = time.perf_counter() - t0
        log("AL first cycle test_3d (bf16): " + "; ".join(
            f"{e} {s} {n} volumes {sec:.2f} s, dice {d:.4f}"
            for (e, s), (sec, _, n, d) in test_runs.items())
            + f"; card {card}")
        # the same runs' shapes (G = 2 and 1, B = 1) in float32, every val
        # volume held against the plain path
        held = {}
        for exp_name, members in (("Ensemble", ckpts),
                                  ("Softmax", ckpts[:1])):
            checked = os.path.join(root, "f32_check")
            _, launches, n, _, carrier = al_test_3d(
                members, data, checked, exp_name, "val", "float32")
            out["launches"][f"AL test_3d {exp_name} val f32 check"] = \
                launches
            held[exp_name] = (n, len(members), hold_against_plain(
                carrier, members, f"AL test_3d f32 {exp_name}"))
            del carrier
            shutil.rmtree(checked)
        log("AL test_3d f32 over val against the plain path (per-member "
            "UNet3D modules through the same windowing and carrier): "
            + "; ".join(f"{e} ({n} volumes, G = {g}) max_abs_err " + ", ".join(
                f"{k} {v:.3e}" for k, v in worst.items())
                for e, (n, g, worst) in held.items()) + f"; card {card}")

        # the evaluation CLI, task by task, then the aggregation on the
        # card; the tasks' own patch aggregations and Platt fits timed
        models = ("Softmax", "Ensemble")
        task_s = {}
        for task in EVAL_TASKS:
            with watched(aggregate_module, "patch_level_aggregation") as \
                    host_maps, watched(ace, "_sigmoid_calibration") as fits:
                task_s[task] = run_eval(eval_overrides(first, second, splits,
                                                       models), [task])
            if task == "aggregation":
                host_ms = [ms for ms, _ in host_maps]
            if task == "calibration":
                fit_s = [ms / 1e3 for ms, _ in fits]
        results = check_task_results(first, splits)

        def aggregated():
            files = {}
            for model in models:
                for split in AL_SPLITS:
                    d = os.path.join(first, model, "test_results",
                                     AL_VERSION, split)
                    for name in sorted(os.listdir(d)):
                        if name.startswith("aggregated_"):
                            with open(os.path.join(d, name)) as f:
                                files[model, split, name[len(
                                    "aggregated_"):-len(".json")]] = \
                                    json.load(f)
            return files

        host_files = aggregated()
        with watched(aggregate_module, "patch_level_aggregation") as \
                card_maps, watched(aggregate_module, "box_filter_sum") as \
                card_boxes:
            task_s["aggregation, use_device"] = run_eval(
                eval_overrides(first, second, splits, models)
                + ["AGG_PATCH_THRESH.function.aggregations.patch_level."
                   "use_device=true"], ["aggregation"])
        box_err = compare_device_aggregation(
            host_files, aggregated(), al_unc_map(first),
            sum(d == "cuda" for _, d in card_boxes))
        entropy_dir = os.path.join(first, "Ensemble", "test_results",
                                   AL_VERSION, "val", "pred_entropy")
        box_card_ms = box_filter_card_ms(os.path.join(
            entropy_dir, sorted(os.listdir(entropy_dir))[0]))
        card_ms = [ms for ms, _ in card_maps]
        out["seconds"]["tasks"] = task_s
        log("AL evaluation CLI (eval_config_lidc, texture, seed 123, "
            "Softmax and Ensemble) seconds per task: " + ", ".join(
                f"{t} {s:.2f}" for t, s in task_s.items())
            + f"; thresholds {json.dumps(results['thresholds'])}; "
            + "; ".join(f"{m}: AUROC {results[m]['auroc']}, detection rate "
                        f"{results[m]['ood_detection_rate']}, " + ", ".join(
                            f"{s} AURC {results[m][s]['aurc']:.4f} ACE "
                            f"{results[m][s]['ace']} NCC {results[m][s]['ncc']}"
                            for s in ("id", "ood")) for m in models)
            + f"; {len(results['split_files'])} second-cycle split files; "
            f"card {card}")
        log(f"AL box filter on the card against scipy's float64 "
            f"convolution: {box_err['maps']} maps, max abs err "
            f"{box_err['abs']:.3e}, max rel err {box_err['rel']:.3e}, "
            f"{box_err['ties']} bounding boxes moved by a near-tie; a 64^3 "
            f"map's patch aggregation in the tasks (median, min-max of "
            f"{len(host_ms)} / {len(card_ms)} maps): host "
            f"{statistics.median(host_ms):.2f} ms ({min(host_ms):.2f}-"
            f"{max(host_ms):.2f}), with the card's box filter "
            f"{statistics.median(card_ms):.2f} ms ({min(card_ms):.2f}-"
            f"{max(card_ms):.2f}, copies included); the box filter alone "
            f"{box_card_ms:.3f} ms; the calibration task's {len(fit_s)} "
            f"Platt fits on {4 * PATCH ** 3} voxel pairs each: median "
            f"{statistics.median(fit_s):.3f} s ({min(fit_s):.3f}-"
            f"{max(fit_s):.3f}), {sum(fit_s):.2f} s in all; card {card}")

        # second cycle
        dry_out = io.StringIO()
        with contextlib.redirect_stdout(dry_out):
            dry = al_driver.main(["--splits", splits, "--config",
                                  "softmax_config_lidc", "--config-dir",
                                  os.path.join(REPO, "configs"),
                                  "--dry-run"])
        if sorted(results["split_files"]) != sorted(
                os.path.relpath(p, splits) for p in
                al_driver.discover_second_cycle_splits(splits)) or len(
                dry) != 11:
            raise AssertionError(f"al_driver --dry-run: {dry}")
        second_runs, step_ms[:] = {}, []
        t0 = time.perf_counter()
        for unc, agg in AL_QUERIES:
            parts = (["random", "random"] if unc == "random"
                     else ["Ensemble", unc, agg])
            splits_file = os.path.join(splits, "texture", "secondCycle",
                                       *parts, "splits_seed123.pkl")
            version = al_driver.version_name_for_splits(Path(splits_file))
            reset_launches()
            t_run = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                ckpt = al_driver.train_second_cycle(
                    "softmax_config_lidc", splits_file, overrides=[
                        f"data_input_dir={data}",
                        f"save_dir={os.path.join(root, 'exp2')}",
                        "max_epochs=1", "+precision=bf16"],
                    config_dir=os.path.join(REPO, "configs"),
                    device="cuda")
            run_s = time.perf_counter() - t_run
            launches = read_launches()
            expect_launches(launches, lidc_epoch_launches(splits_file),
                            f"second cycle {version}")
            out["launches"][f"AL second cycle {unc} {agg} CLI"] = launches
            tested = os.path.join(root, "second_tests")
            sec, t_launches, n, dice, _ = al_test_3d(
                [ckpt], data, tested, version, "ood")
            out["launches"][f"AL second cycle test_3d {unc} {agg}"] = \
                t_launches
            dest = os.path.join(second, "Ensemble", "test_results", unc,
                                agg, AL_VERSION)
            os.makedirs(dest)
            shutil.move(os.path.join(tested, version, "test_results",
                                     version, "ood"), dest)
            second_runs[version] = (run_s, sec, dice)
        out["seconds"]["second cycle"] = time.perf_counter() - t0
        second_steps = list(step_ms)
    finally:
        experiment_module.Experiment.train_step = train_step
    task_s["al_improvement"] = run_eval(eval_overrides(
        first, second, splits, ["Ensemble"]), ["al_improvement"])
    with open(os.path.join(first, "Ensemble", "test_results", AL_VERSION,
                           "ood", "al_improvement.json")) as f:
        improvement = json.load(f)["mean"]
    values = list(_metric_leaves(improvement, "al_improvement"))
    if len(values) != 4 or not np.isfinite(values).all():
        raise AssertionError(f"al_improvement: {improvement}")
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    n_train = len(load_pickle(os.path.join(
        splits, "texture", "secondCycle", "random", "random",
        "splits_seed123.pkl"))[0]["train"])
    out["steps"] = {"first": first_steps, "second": second_steps}
    # every step's volumes over the steps' summed time
    out["second_volumes_per_s"] = (len(AL_QUERIES) * n_train * 1e3
                                   / sum(second_steps))
    log(f"AL second cycle (5 runs of one epoch, bf16, {n_train} training "
        "volumes each): " + "; ".join(
            f"{v} {r:.2f} s, test_3d ood {s:.2f} s, dice {d:.4f}"
            for v, (r, s, d) in second_runs.items())
        + f"; steps median {statistics.median(second_steps):.2f} ms (min "
        f"{min(second_steps):.2f}, max {max(second_steps):.2f}; first cycle "
        f"median {statistics.median(first_steps):.2f} ms), "
        f"{out['second_volumes_per_s']:.2f} volumes trained/s over the "
        f"steps' summed time; al_improvement {json.dumps(improvement)}; "
        f"LIDC tree {counts['nodules']} nodules in {write_s:.2f} s; the "
        f"phase {out['seconds']['phase']:.1f} s; card {card}")
    # the first cycle's results stay for the reporting phase, which
    # removes them
    kept = tempfile.mkdtemp(dir=OUT_DIR, prefix="al_first_")
    shutil.move(first, kept)
    out["first_cycle"] = os.path.join(kept, "FirstCycle")
    shutil.rmtree(root)
    return out


def time_k1_f32_chunk():
    """K1's float32 regime (``tf32x3``) at the test_3d default chunk's
    largest conv, expand_1_1 (B 12, 64^3, G 5, 8 + 8 -> 8 channels per
    group, prologue, leaky), beside its bounds (the 3xTF32 floor, three
    TF32 products at the tensor cores' rate, which is its bound; the
    CUDA-core float32 rate, the earlier regime's; the bytes), its plain
    version and F.conv3d(groups=5) in float32 with TF32 off (with the
    same prologue, concat and activation as separate passes)."""
    import torch
    import torch.nn.functional as F
    from values_tpu_torch.ops.kernels.conv3d import (concat_groups,
                                                     conv3d_fused,
                                                     conv3d_fused_reference,
                                                     plan)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    b, g, c = 12, N_MEMBERS, FILTERS
    x, weight, bias, x2, maps = k1_inputs(gen, torch.float32, b, PATCH,
                                          PATCH, PATCH, g, c, c, c, True)
    kw = dict(x2=x2, prologue=maps, activation="leaky")
    regime = plan(torch.float32, PATCH, PATCH, PATCH, g, c, c, c).regime
    before = dict(conv3d_fused.regime_launches)
    out = conv3d_fused(x, weight, bias, g, **kw)
    if regimes_since(before) != {regime: 1}:
        raise AssertionError(f"K1 f32 at the test_3d chunk: regimes "
                             f"{regimes_since(before)}, expected {regime}")
    ref = conv3d_fused_reference(x, weight, bias, g, **kw)
    err = float((out - ref).abs().max())
    if err > 1e-4:
        raise AssertionError(f"K1 f32 at the test_3d chunk: max_abs_err "
                             f"{err:.3e}")
    del out, ref
    ms = cuda_ms(lambda: conv3d_fused(x, weight, bias, g, **kw))
    plain_ms = cuda_ms(lambda: conv3d_fused_reference(x, weight, bias, g,
                                                      **kw), reps=3)
    w_lib = weight.permute(4, 3, 0, 1, 2).contiguous()
    sc, sh, sl = (m[:, None, None, None, :] for m in maps)

    def library():
        v = concat_groups(x, x2, g) * sc - sh
        v = torch.maximum(v, v * sl)
        y = F.conv3d(v.permute(0, 4, 1, 2, 3), w_lib, bias, padding=1,
                     groups=g)
        return F.leaky_relu(y, 0.01)

    library_ms = cuda_ms(library, reps=5)
    vox = b * PATCH ** 3
    bytes_moved = 4 * vox * g * 3 * c + 4 * weight.numel() + 3 * 4 * \
        maps[0].numel() + 4 * bias.numel()
    flops = 2 * vox * g * 27 * (2 * c) * c
    bound_ms, bound_by = bound(bytes_moved, 3 * flops, "tf32")
    return {"shape": f"expand_1_1 B={b} {PATCH}^3 G={g} Cin={2 * c} "
                     f"Cout={c} f32", "regime": regime, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "cuda_core_bound_ms": bound(0, flops, "float32")[0],
            "bytes_bound_ms": bound(bytes_moved, 0, "float32")[0],
            "library_ms": library_ms, "max_abs_err": err,
            "tflops": flops / ms / 1e9}


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
    """K2 at the path's shape: the logits form on the (M, C, N) view of
    one batch's bf16 logits, sample-major as the forward leaves them and
    the scorer hands them over (fails if they are not, as the wrapper
    would then copy them on every call); beside it the probability form
    on the float32 softmax of the same logits (the JAX kernel's contract,
    channels-last as torch.softmax leaves it, so its time includes the
    wrapper's copy into the sample-major layout), each with its bound."""
    import torch
    from values_tpu_torch.models.ensemble_unet3d import (
        cast_weights, grouped_forward_fused)
    from values_tpu_torch.ops.kernels.entropy import (
        _sample_stride, fused_entropy, fused_entropy_reference)
    with torch.no_grad():
        logits = grouped_forward_fused(
            cast_weights(grouped, torch.bfloat16, vols.device),
            vols.to(torch.bfloat16), N_MEMBERS)
    m, c = logits.shape[-2:]
    view = logits.reshape(-1, m, c).permute(1, 2, 0)
    if not _sample_stride(view):
        raise AssertionError(f"the forward's logits, strides {view.stride()}"
                             ", are not in K2's sample-major layout")
    probs = torch.softmax(logits.float(), dim=-1).reshape(-1, m, c
                                                          ).permute(1, 2, 0)
    err = 0.0
    for x, is_logits in ((view, True), (probs, False)):
        got = fused_entropy(x, logits=is_logits)
        want = fused_entropy_reference(x, logits=is_logits)
        err = max(err, *(float((got[k] - want[k]).abs().max())
                         for k in want))
    if not err <= 1e-5:
        raise AssertionError(f"K2 at the path's shape: max_abs_err {err}")
    n = view.shape[-1]
    # 10 back-to-back launches per sample: the kernel is shorter than the
    # wrapper's host time
    ms = cuda_ms(lambda: fused_entropy(view, logits=True), reps=20, inner=10)
    plain_ms = cuda_ms(lambda: fused_entropy_reference(view, logits=True),
                       reps=5)
    probs_ms = cuda_ms(lambda: fused_entropy(probs), reps=20, inner=10)
    probs_plain_ms = cuda_ms(lambda: fused_entropy_reference(probs), reps=5)
    # device time: 10 calls queued behind a spin kernel, so that the card
    # runs them back to back whatever the host's pace
    queued = queued_ms(lambda: fused_entropy(view, logits=True))
    probs_queued = queued_ms(lambda: fused_entropy(probs))
    # read S*C logits (bf16) or probabilities (f32); write C + 3 floats.
    # Operations per voxel: the softmax per sample (5C - 1: max, shift,
    # exp, sum, reciprocal, scale), then mean, p log p, sums, MI
    stats_ops = 4 * m * c + 4 * c + 3
    bound_ms, bound_by = bound(2 * n * m * c + 4 * n * (c + 3),
                               n * (m * (5 * c - 1) + stats_ops), "float32")
    probs_bound_ms, probs_bound_by = bound(4 * n * m * c + 4 * n * (c + 3),
                                           n * stats_ops, "float32")
    stream = time_k2_stream()
    return {"name": "fused_entropy", "route": "cuda",
            "stream_regime": stream,
            "source": "values_tpu_torch/csrc/entropy.cu",
            "replaces": "values_tpu/ops/pallas/entropy.py:28",
            "launches": launches["fused_entropy"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "queued_ms": queued,
            "shape": f"logits form, S={m} C={c} N={n} bf16, the forward's "
                     "sample-major layout",
            "probs_ms": probs_ms, "probs_plain_ms": probs_plain_ms,
            "probs_queued_ms": probs_queued,
            "probs_bound_ms": probs_bound_ms,
            "probs_bound_by": probs_bound_by,
            "probs_shape": f"probability form, S={m} C={c} N={n} f32 "
                           "channels-last view, the wrapper's copy "
                           "included"}


def time_k2_stream() -> dict:
    """K2's streaming regime at each of K2_STREAM_SHAPES: its time, its
    plain version's, and its bound (the same byte and operation counts as
    the tiled regime's, per form)."""
    import torch
    from values_tpu_torch.ops.kernels.entropy import (
        fused_entropy, fused_entropy_reference)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    out = {}
    for name, (x, is_logits) in k2_stream_cases(gen).items():
        s, c, n = x.shape
        got = fused_entropy(x, logits=is_logits)
        want = fused_entropy_reference(x, logits=is_logits)
        err = max(float((got[k].float() - want[k].float()).abs().max())
                  for k in want)
        del got, want
        ms = cuda_ms(lambda: fused_entropy(x, logits=is_logits), reps=10)
        plain_ms = cuda_ms(lambda: fused_entropy_reference(
            x, logits=is_logits), reps=3, warmup=1)
        stats_ops = 4 * s * c + 4 * c + 3
        softmax_ops = s * (5 * c - 1) if is_logits else 0
        out_bytes = 4 if is_logits else x.element_size()
        bound_ms, bound_by = bound(
            x.element_size() * n * s * c + out_bytes * n * (c + 3),
            n * (softmax_ops + stats_ops), "float32")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err": err}
        del x
    return out


ACKLAM_CENTRAL, ACKLAM_TAIL = 24, 27   # operations of each branch
ACKLAM_TAIL_SHARE = 2 * 0.02425       # P(u < PLOW or u > 1 - PLOW)
SFU_PER_CLOCK = 16 * 132              # MUFU results per clock, H100 SXM


def k3_operations(n: int, m: int, c: int, n_samples: int, bits: str
                  ) -> float:
    """Operations of K3's function at (N, M, C, n_samples), counting an
    FMA as 2 and each compare, select, integer op, exp, log, sqrt and
    division as 1, per (voxel, member, sample) draw group of C classes:

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
      log p, p log p, sum, two accumulates);

    and, as the aleatoric path hands over the head's log-variance, one
    exp (and a halving) per (voxel, member, class) to form sigma.
    """
    draw = 21 * c if bits == "philox" else 10 * c + 2
    normal = 2 + (1 - ACKLAM_TAIL_SHARE) * ACKLAM_CENTRAL \
        + ACKLAM_TAIL_SHARE * ACKLAM_TAIL
    per_group = draw + c * (4 + normal + 2) + 9 * c - 1
    return n * m * (n_samples * per_group + 2 * c)


def k3_sfu_operations(n: int, m: int, c: int, n_samples: int) -> float:
    """The SFU (MUFU) operations K3's function needs with the log_var
    head: per draw group the softmax and entropy (at C = 2 one exp, one
    log and one reciprocal; else C exps, a log and a reciprocal), per
    draw a reciprocal for the central branch's division or, at the tail
    share, a log, a square root and a reciprocal; per (voxel, member,
    class) one exp for sigma."""
    softmax = 3 if c == 2 else c + 2
    per_draw = (1 - ACKLAM_TAIL_SHARE) * 1 + ACKLAM_TAIL_SHARE * 3
    return n * m * (n_samples * (softmax + c * per_draw) + c)


def max_sm_clock_mhz():
    """Card 0's maximum SM clock (MHz) as nvidia-smi reads it, or None.
    An SFU floor at the maximum clock is the least one."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.strip()
    return float(out) if out.isdigit() else None


def time_k3(launches, grouped, vols):
    """K3 at the aleatoric path's shape, as the scorer calls it: the
    (N, M, C) bf16 mu and log_var views of one batch's (mu, s) head, 10
    samples per member, Philox bits; beside its plain version, the
    stock-torch streaming loop (torch.randn draws, softmax, accumulate
    per sample, on the float32 mu and sigma), the port's counterpart of
    the JAX package's ``sampler="xla"``, and its SFU floor (computed, as
    the bound is) at the card's maximum SM clock."""
    import torch
    from values_tpu_torch.models.ensemble_unet3d import (
        cast_weights, grouped_forward_fused)
    from values_tpu_torch.ops.kernels.sampling import (
        sampled_softmax_stats, sampled_softmax_stats_reference)
    from values_tpu_torch.ops.uncertainty import entropy
    with torch.no_grad():
        out = grouped_forward_fused(
            cast_weights(grouped, torch.bfloat16, vols.device),
            vols.to(torch.bfloat16), N_MEMBERS)
    c = out.shape[-1] // 2
    head = out.reshape(-1, N_MEMBERS, 2 * c)
    mu, log_var = head[..., :c], head[..., c:]
    n = mu.shape[0]
    kw = dict(n_samples=N_ALEATORIC, log_var=log_var)
    got = sampled_softmax_stats(mu, None, 3, **kw)
    want = sampled_softmax_stats_reference(mu, None, 3, **kw)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    # the check phase's tolerance, on sums of M*n = 50 terms
    if not all(bool(((g - w).abs() <= 1e-4 + 1e-5 * w.abs()).all())
               for g, w in zip(got, want)):
        raise AssertionError(f"K3 at the path's shape: max_abs_err {err}")
    del got, want
    ms = cuda_ms(lambda: sampled_softmax_stats(mu, None, 3, **kw), reps=20)
    queued = queued_ms(lambda: sampled_softmax_stats(mu, None, 3, **kw))
    plain_ms = cuda_ms(lambda: sampled_softmax_stats_reference(
        mu, None, 3, **kw), reps=2, warmup=1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    mu32 = mu.float()
    sigma32 = torch.exp(log_var.float() / 2.0)

    def loop():
        sum_p = torch.zeros((n, c), device="cuda")
        sum_ent = torch.zeros((n,), device="cuda")
        for j in range(N_MEMBERS * N_ALEATORIC):
            im = j // N_ALEATORIC
            eps = torch.randn((n, c), generator=gen, device="cuda")
            probs = torch.softmax(mu32[:, im] + sigma32[:, im] * eps, dim=-1)
            sum_p = sum_p + probs
            sum_ent = sum_ent + entropy(probs, class_axis=-1)
        return sum_p, sum_ent

    loop_ms = cuda_ms(loop, reps=3)
    # read the bf16 head once (mu and s), write sum_p and sum_ent
    bytes_moved = 2 * (2 * n * N_MEMBERS * c) + 4 * (c * n + n)
    flops = k3_operations(n, N_MEMBERS, c, N_ALEATORIC, "philox")
    bound_ms, bound_by = bound(bytes_moved, flops, "float32")
    sfu = k3_sfu_operations(n, N_MEMBERS, c, N_ALEATORIC)
    clock_mhz = max_sm_clock_mhz()
    mufu_ms = (None if clock_mhz is None
               else sfu / (SFU_PER_CLOCK * clock_mhz * 1e6) * 1e3)
    del mu32, sigma32
    return {"name": "sampled_softmax_stats", "route": "cuda",
            "shared_regime": time_k3_wide(),
            "source": "values_tpu_torch/csrc/sampling.cu",
            "replaces": "values_tpu/ops/pallas/sampling.py:135",
            "launches": launches["sampled_softmax_stats"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "queued_ms": queued, "loop_ms": loop_ms, "operations": flops,
            "sfu_operations": sfu, "mufu_ms": mufu_ms,
            "max_sm_clock_mhz": clock_mhz,
            "shape": f"N={n} M={N_MEMBERS} C={c} n={N_ALEATORIC} bf16 "
                     "mu and log_var views of the head, philox"}


def time_k3_wide() -> dict:
    """K3's shared-memory regime at Part A's shape (M 5, C 12, 10
    samples, K3_WIDE_N voxels; bf16 mu and log_var, Philox): its time,
    its plain version's and its bound, counted as time_k3 counts."""
    import torch
    from values_tpu_torch.ops.kernels.sampling import (
        sampled_softmax_stats, sampled_softmax_stats_reference)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    mu, _, log_var = k3_head(gen, K3_WIDE_N, N_MEMBERS, K3_WIDE_C)
    mu, log_var = mu.to(torch.bfloat16), log_var.to(torch.bfloat16)
    kw = dict(n_samples=N_ALEATORIC, log_var=log_var)
    ms = cuda_ms(lambda: sampled_softmax_stats(mu, None, 3, **kw), reps=5,
                 warmup=1)
    plain_ms = cuda_ms(lambda: sampled_softmax_stats_reference(
        mu, None, 3, **kw), reps=1, warmup=0)
    n, m, c = K3_WIDE_N, N_MEMBERS, K3_WIDE_C
    bound_ms, bound_by = bound(2 * (2 * n * m * c) + 4 * (c * n + n),
                               k3_operations(n, m, c, N_ALEATORIC, "philox"),
                               "float32")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "shape": f"N={n} M={m} C={c} n={N_ALEATORIC} bf16, philox"}


def time_k1b(launches):
    """K1b's dx at the training path's largest conv, expand_1_1 (B 8,
    64^3, G 1, 16 -> 8 channels, leaky epilogue), in bf16 and f32: the dx
    entry as a training step launches it (the fold, the conv on the
    forward's weight read flipped, the folded cotangent for dW and db, in
    one launch), checked through the autograd Function against its plain
    version (autograd through conv3d_fused_reference); beside cuDNN's
    input gradient after the same fold (torch.where and
    aten.convolution_backward: what library calls give for the same dx)
    and, for the record, cuDNN's weight gradient at the same conv (the dW
    that K1b leaves to the library). Device time of each like for like
    (queued_ms: 10 calls queued behind a spin kernel), the host clock
    (CUDA events around 10 back-to-back calls, over 10), and the
    profiler's device time of the entry (every kernel of 10 calls, over
    10) with its count of dx-kernel records (10 when none is lost). The
    bf16 numbers lead; the f32 ones (tf32x3, bound by the 3xTF32 floor)
    are under "float32"."""
    import torch
    from values_tpu_torch.ops.kernels.conv3d import (conv3d_fused_dx,
                                                     conv3d_fused_train,
                                                     plan_dx)
    b, cin, cout = TRAIN_BATCH, 2 * FILTERS, FILTERS
    vox = b * PATCH ** 3

    def profiled(fn):  # the profiler's ms a call and its dx records
        def ten():
            for _ in range(10):
                fn()
        table = device_times(ten)[0]
        kernels = [e for e in table if "CUDA" in str(e.device_type)
                   and e.self_device_time_total > 0]
        return (sum(e.self_device_time_total for e in kernels) / 1e4,
                sum(e.count for e in kernels if is_dx_kernel(e.key)))

    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[1]
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        x, weight, bias, _, _ = k1_inputs(gen, dtype, b, PATCH, PATCH,
                                          PATCH, 1, cin, 0, cout, False)
        dy = torch.randn((b, PATCH, PATCH, PATCH, cout), generator=gen,
                         device="cuda")
        # no cotangent within 1e-3 of the leaky kink, where the kernel and
        # the plain forward, rounding apart, may take different branches
        pre = plain_train_conv(x, weight, bias, 1).float()
        dy = torch.where(pre.abs() < 1e-3 * pre.abs().max(), 0.0,
                         dy).to(dtype)
        del pre
        x = x.requires_grad_(True)
        graphs = {name: fn(x, weight, bias, 1, activation="leaky")
                  for name, fn in (("kernel", conv3d_fused_train),
                                   ("plain", plain_train_conv))}

        def dx(name):
            return torch.autograd.grad(graphs[name], x, dy,
                                       retain_graph=True)[0]

        got, want = dx("kernel").float(), dx("plain").float()
        err = float((got - want).abs().max())
        rtol, atol_rel = K1B_TOL[dt]
        if bool(((got - want).abs() > atol_rel * float(want.abs().max())
                 + rtol * want.abs()).any()):
            raise AssertionError(f"K1b dx at expand_1_1 {dt}: max_abs_err "
                                 f"{err}")
        y = graphs["kernel"].detach()
        views = dict(x=x.detach().permute(0, 4, 1, 2, 3),
                     w=weight.permute(4, 3, 0, 1, 2))

        def entry():
            return conv3d_fused_dx(dy, weight, 1, y=y, fold="leaky",
                                   cotangent=True, bias_grad=True)

        def library(mask):
            g = torch.where(y > 0, dy, 0.01 * dy).permute(0, 4, 1, 2, 3)
            return torch.ops.aten.convolution_backward(
                g, views["x"], views["w"], None, [1, 1, 1], [1, 1, 1],
                [1, 1, 1], False, [0, 0, 0], 1, mask)

        # 10 back-to-back calls per sample: one call is shorter than the
        # host's time around it
        ms = cuda_ms(entry, inner=10)
        library_ms = cuda_ms(lambda: library([True, False, False]), inner=10)
        dw_library_ms = cuda_ms(lambda: library([False, True, False]),
                                inner=10)
        device_ms = queued_ms(entry)
        library_device_ms = queued_ms(lambda: library([True, False, False]))
        profiler_ms, profiler_records = profiled(entry)
        plain_ms = cuda_ms(lambda: dx("plain"), reps=5)
        size = 2 if dtype == torch.bfloat16 else 4
        # read dy and y, write dx and the folded cotangent; the weight
        # once; db
        bytes_moved = size * vox * (cout + cout + cin + cout) + \
            size * weight.numel() + 4 * cout
        flops = 2 * vox * 27 * cin * cout
        if dtype == torch.bfloat16:
            bound_ms, bound_by = bound(bytes_moved, flops, "bfloat16")
        else:  # tf32x3: three TF32 products each on the tensor cores
            bound_ms, bound_by = bound(bytes_moved, 3 * flops, "tf32")
        result[dt] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "dw_library_ms": dw_library_ms, "device_ms": device_ms,
            "library_device_ms": library_device_ms,
            "profiler_ms": profiler_ms, "profiler_records": profiler_records,
            "max_abs_err": err,
            "regime": plan_dx(dtype, PATCH, PATCH, PATCH, 1, cout,
                              cin).regime}
        del graphs, got, want
    out = dict(result["bfloat16"])
    out.update({
        "name": "conv3d_fused_train", "route": "cuda",
        "source": "values_tpu_torch/csrc/conv3d_fused.cu",
        "replaces": "values_tpu/ops/pallas/conv3d.py:906",
        "launches": launches["conv3d_fused_train"],
        "float32": result["float32"],
        "shape": f"dx of expand_1_1 B={b} {PATCH}^3 G=1 Cin={cin} "
                 f"Cout={cout} bf16, the dx entry (leaky fold, flipped "
                 "weight, folded cotangent and db out)"})
    return out


def device_times(fn):
    """One call of ``fn`` under torch.profiler: (the table, wall ms, device
    kernel ms, K1's kernel ms, the dW library call's device ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
             if any(n in e.key for n in K1_KERNELS)) / 1e3
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    dw = sum(e.device_time_total for e in table
             if e.key == "aten::convolution_backward") / 1e3
    return table, wall, busy, k1, dw


# the host's kernel launches, as the profiler names the runtime and driver
# calls
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
# the port's kernels by wrapper: the profiler's kernel names
WRAPPER_KERNELS = {"conv3d_fused": K1_KERNELS,
                   "fused_entropy": ("fused_entropy_kernel",
                                     "fused_entropy_stream_kernel"),
                   "sampled_softmax_stats": ("sampled_stats_c2_kernel",
                                             "sampled_stats_kernel",
                                             "sampled_stats_wide_kernel")}


def kernel_records(table, wrapper_launches=None) -> dict:
    """A profile's count of device kernel records against the kernel
    launches the host made in it (``LAUNCH_CALLS``), and, for the port's
    kernels, its records of each against the launches its wrapper counted
    (``wrapper_launches``). The profiler has dropped kernel records in
    long sessions: a profile whose records fall short of its launches has
    unchecked device-time totals."""
    records = sum(e.count for e in table if "CUDA" in str(e.device_type)
                  and not getattr(e, "is_user_annotation", False)
                  and not e.key.startswith(("Memcpy", "Memset")))
    launches = sum(e.count for e in table if e.key in LAUNCH_CALLS)
    out = {"records": records, "launches": launches,
           "complete": records >= launches}
    for name, want in (wrapper_launches or {}).items():
        got = sum(e.count for e in table if "CUDA" in str(e.device_type)
                  and any(k in e.key for k in WRAPPER_KERNELS[name]))
        out[name] = {"records": got, "launches": want}
        out["complete"] = out["complete"] and got >= want
    return out


def records_note(rec: dict) -> str:
    """The log's words for ``kernel_records``."""
    ports = "".join(f", {n} {r['records']} of {r['launches']}"
                    for n, r in rec.items() if isinstance(r, dict))
    return (f"{rec['records']} kernel records of {rec['launches']} "
            f"launches{ports}" + ("" if rec["complete"] else
                                  " (records lost: these totals are "
                                  "unchecked)"))


# the elementwise ops that K1b's dx entry does in the kernel (the fold, the
# flip, the float32 copies for the fold and db, db's sum)
K1B_HOST_OPS = ("aten::where", "aten::flip", "aten::_to_copy", "aten::add",
                "aten::mul", "aten::sum")


def k1b_backward_ops(step, bf16: bool) -> dict:
    """Profile one call of ``step`` (a training step; host ops with their
    shapes) and count the K1B_HOST_OPS on volume-sized inputs that run in
    K1b's backward nodes (Conv3dFusedFnBackward), outside the dW library
    call (aten::convolution_backward). Only the first conv, which has no
    dx, still folds in torch: its statistics fold ``dy + ds1 + 2 y ds2``
    adds twice and multiplies twice, db is one sum, and in bf16 dy and y
    go to float32 and back and the cotangent to float32 again for db (4
    copies). The counts fail where they rise above that."""
    import collections
    from torch.profiler import ProfilerActivity, profile
    # the smallest cotangent of a step: the bottleneck's, B 4^3 x 16 F;
    # per-channel maps and db stay below it
    volume = TRAIN_BATCH * (PATCH // 16) ** 3 * 16 * FILTERS
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        step()
    counts = collections.Counter()
    for e in prof.events():
        if e.name not in K1B_HOST_OPS or not e.input_shapes:
            continue
        if int(np.prod(e.input_shapes[0] or [1])) < volume:
            continue
        a, in_dw = e.cpu_parent, False
        while a is not None and "Conv3dFusedFnBackward" not in a.name:
            in_dw |= a.name == "aten::convolution_backward"
            a = a.cpu_parent
        if a is not None and not in_dw:
            counts[e.name] += 1
    allowed = {"aten::add": 2, "aten::mul": 2, "aten::sum": 1,
               "aten::_to_copy": 4 if bf16 else 0}
    rose = {op: n for op, n in counts.items() if n > allowed.get(op, 0)}
    if rose:
        raise AssertionError(f"K1b's backward ran {dict(counts)} over "
                             f"volumes outside the dx entry (at most "
                             f"{allowed}: the first conv's fold)")
    return dict(counts)


def time_training(exp32, state32, batch, root: str, card: str):
    """Milliseconds per training step and volumes trained per second at
    batch 8, f32 (with TF32 off and on) and bf16: host clock around
    TIMED_STEPS steps ending in a synchronize, after 2 warm-up steps, the
    batch already on the card; peak device memory of a step; and a
    profile of one step of each, split into K1 forward (from a profile of
    the forward alone), K1b's dx (the dx entry's kernels: 17 launches a
    step, and no aten::flip), the dW library call
    (aten::convolution_backward), the rest (norms, losses, optimizer,
    casts) and idle; a further step, profiled on the host, holds the ops
    around K1b's dx entry (k1b_backward_ops)."""
    import torch
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

        def forward():
            with torch.no_grad():
                exp.loss(state.params, batch)

        _, _, _, k1_fwd, _ = device_times(forward)
        before = read_launches()["conv3d_fused"]
        table, wall, busy, k1, dw = device_times(
            lambda: exp.train_step(state, batch))
        records = kernel_records(table, {
            "conv3d_fused": read_launches()["conv3d_fused"] - before})
        # K1b's dx: one launch of the dx entry each, and no separate fold,
        # flip or float32 copy of dy around it
        kernels = [e for e in table if "CUDA" in str(e.device_type)
                   and e.self_device_time_total > 0]
        dx_launches = sum(e.count for e in kernels if is_dx_kernel(e.key))
        dx_ms = sum(e.self_device_time_total for e in kernels
                    if is_dx_kernel(e.key)) / 1e3
        ops = {op: sum(e.count for e in table if e.key == op)
               for op in ("aten::flip", "aten::where", "aten::_to_copy")}
        if busy and (dx_launches != K1_DX or ops["aten::flip"]):
            raise AssertionError(f"training step {name}: {dx_launches} "
                                 f"launches of the dx entry (expected "
                                 f"{K1_DX}), host ops {ops}")
        k1b_ops = k1b_backward_ops(lambda: exp.train_step(state, batch),
                                   name == "bf16")
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
                        "k1_dx_ms": dx_ms, "dx_launches": dx_launches,
                        "host_ops": ops, "k1b_backward_ops": k1b_ops,
                        "dw_ms": dw, "records": records,
                        "other_ms": busy - k1 - dw}
        r = result[name]
        if not busy:
            log(f"training step {name}: no device time recorded (profile "
                "not measured)")
        log(f"training step {name}, batch {TRAIN_BATCH} x {PATCH}^3: "
            f"{step_ms:.2f} ms, {r['volumes_per_s']:.2f} volumes/s, peak "
            f"{peak_gb:.2f} GB; profile of one step (profiler on): device "
            f"{busy:.2f} of {wall:.2f} ms wall, idle share "
            f"{1 - busy / wall:.3f}; K1 forward {k1_fwd:.2f} ms, K1b dx "
            f"{dx_ms:.2f} ms in {dx_launches} launches of the dx entry "
            f"(aten::flip {ops['aten::flip']}, aten::where "
            f"{ops['aten::where']}, aten::_to_copy "
            f"{ops['aten::_to_copy']} in the step; over volumes in K1b's "
            f"backward outside dW {k1b_ops}), K1 in all {k1:.2f} ms, "
            f"dW (cuDNN) {dw:.2f} ms, the rest {busy - k1 - dw:.2f} ms; "
            f"{records_note(records)}; card {card}")
    return result


# (name, B, S, G, Cin1, Cin2, Cout, prologue, activation, stats): the
# 64^3 and 32^3 convs of the scored batch and expand_1_1's dx in training
K1_REGIME_SHAPES = [
    ("expand_1_1", BATCH, 64, N_MEMBERS, 8, 8, 8, True, "leaky", False),
    ("contr_1_2", BATCH, 64, N_MEMBERS, 8, 0, 8, True, "none", True),
    ("contr_2_2", BATCH, 32, N_MEMBERS, 16, 0, 16, True, "none", True),
    ("expand_2_1", BATCH, 32, N_MEMBERS, 16, 16, 16, True, "leaky", False),
    ("dx of expand_1_1, B 8, G 1", 8, 64, 1, 8, 0, 16, False, "none",
     False),
]


def time_k1_regimes():
    """K1's shallow and tile16 kernels on the same inputs at the shapes
    where plan() chooses between them (each forced in turn, checked
    against the plain version with K1's bf16 tolerance): CUDA-event
    medians, written to build/chip_smoke/k1_regimes.json."""
    import torch
    from values_tpu_torch.ops.kernels import conv3d
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    rtol, atol_rel, _ = K1_TOL["bfloat16"]
    real, rows = conv3d.plan, []
    try:
        for name, b, sz, g, c1, c2, co, pro, act, stats in K1_REGIME_SHAPES:
            x, w, bias, x2, maps = k1_inputs(gen, torch.bfloat16, b, sz, sz,
                                             sz, g, c1, c2, co, pro)
            kw = dict(x2=x2, prologue=maps, activation=act,
                      emit_stats=stats)
            want = conv3d.conv3d_fused_reference(x, w, bias, g, **kw)
            want = (want[0] if stats else want).float()
            chosen = real(torch.bfloat16, sz, sz, sz, g, c1, c2, co)
            row = {"conv": name, "plan": chosen.regime}
            for regime in ("shallow", "tile16"):
                forced = (conv3d._shallow_plan(chosen.block_n, c1, c2)
                          if regime == "shallow" else conv3d._mma_plan(
                              "tile16", (2, 8, 16), chosen.block_n, c1 + c2))
                conv3d.plan = lambda *a, f=forced: f
                got = conv3d.conv3d_fused(x, w, bias, g, **kw)
                got = (got[0] if stats else got).float()
                if bool(((got - want).abs() > atol_rel * float(
                        want.abs().max()) + rtol * want.abs()).any()):
                    raise AssertionError(f"K1 {regime} at {name} disagrees "
                                         "with its plain version")
                row[f"{regime}_ms"] = cuda_ms(
                    lambda: conv3d.conv3d_fused(x, w, bias, g, **kw))
                conv3d.plan = real
            rows.append(row)
            log(f"K1 regimes at {name:28s}: shallow {row['shallow_ms']:.3f} "
                f"ms, tile16 {row['tile16_ms']:.3f} ms; plan takes "
                f"{row['plan']}")
            del x, w, x2, want, got
    finally:
        conv3d.plan = real
    with open(os.path.join(OUT_DIR, "k1_regimes.json"), "w") as fh:
        json.dump(rows, fh, indent=1)


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
    from values_tpu_torch.ops.kernels.conv3d import plan
    rows = []
    for xs, c2, ws, pro, act, stats, start, end in calls:
        b, d, h, w, c1 = xs
        vox, cin, gcout = b * d * h * w, ws[3], ws[4]
        launch = plan(torch.bfloat16, d, h, w, N_MEMBERS, c1 // N_MEMBERS,
                      c2 // N_MEMBERS, gcout // N_MEMBERS)
        bytes_moved = 2 * vox * (c1 + c2 + gcout) + 2 * 27 * cin * gcout
        flops = 2 * vox * 27 * cin * gcout
        bound_ms, bound_by = bound(bytes_moved, flops, "bfloat16")
        rows.append({"x": list(xs), "cin_per_group": cin,
                     "cout_per_group": gcout // N_MEMBERS, "x2": c2 > 0,
                     "prologue": pro, "activation": act, "stats": stats,
                     "regime": launch.regime, "tile": list(launch.tile),
                     "block_n": launch.block_n,
                     "ms": start.elapsed_time(end), "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "tflops": flops / start.elapsed_time(end) / 1e9})
    total = sum(r["ms"] for r in rows)
    log(f"K1 per conv (bf16, batch {vols.shape[0]}): {len(rows)} convs, "
        f"{total:.2f} ms, bound {sum(r['bound_ms'] for r in rows):.3f} ms")
    for r in rows:
        log(f"  {'x'.join(map(str, r['x'][1:4])):>8s} cin {r['cin_per_group']:3d}"
            f" cout {r['cout_per_group']:3d} {r['regime']:6s} "
            f"{'x'.join(map(str, r['tile']))} n{r['block_n']}: "
            f"{r['ms']:8.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}), "
            f"{r['tflops']:.1f} TFLOP/s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "k1_layers.json"), "w") as fh:
        json.dump(rows, fh, indent=1)


# what must not run over the logits or the head outside K2 and K3: a
# cast, an exp, a softmax, a division, a copy or a clone of a tensor that
# large
HEAD_OPS = ("aten::_to_copy", "aten::exp", "aten::softmax",
            "aten::_softmax", "aten::div", "aten::copy_", "aten::clone")
# The one copy of that size a scored batch makes, and not of the head: the
# k2s2 transposed convs' interleave, the reshape of the permuted GEMM
# output, a 9-D (B, D, 2, H, 2, W, 2, M, Cout) tensor
# (values_tpu_torch/models/ensemble_unet3d.py::transpose_conv_k2s2; at
# 64^3 and 32^3 it has 335,544,320 and 83,886,080 elements). The JAX
# package's packed forward makes the same copy
# (values_tpu/models/ensemble_unet3d_pallas.py::_transpose_conv_k2s2, its
# step (3) transpose).
K2S2_INTERLEAVE_OPS, K2S2_INTERLEAVE_DIMS = ("aten::copy_", "aten::clone"), 9


def profile_batch(score, args, label: str, filename: str, head_numel: int):
    """Device time of one batch, ``score(*args)``, by kernel, from
    torch.profiler; the table is written to build/chip_smoke/<filename>.
    Raises if an operator of HEAD_OPS takes a tensor of ``head_numel``
    elements or more (the logits, or one half of the aleatoric head)."""
    import math
    import torch
    from torch.profiler import ProfilerActivity, profile
    score(*args)
    torch.cuda.synchronize()
    before = read_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        score(*args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    after = read_launches()
    big = [(e.name, e.input_shapes[0]) for e in prof.events()
           if e.name in HEAD_OPS and e.input_shapes and e.input_shapes[0]
           and math.prod(e.input_shapes[0]) >= head_numel]
    interleave = [(n, shape) for n, shape in big
                  if n in K2S2_INTERLEAVE_OPS
                  and len(shape) == K2S2_INTERLEAVE_DIMS]
    over_head = sorted({(n, str(shape)) for n, shape in big
                        if (n, shape) not in interleave})
    if over_head:
        raise AssertionError(f"profile {label}: operators over the head or "
                             f"the logits: {over_head}")
    table = prof.key_averages()
    kernels = [e for e in table if "CUDA" in str(e.device_type)
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels)
    records = kernel_records(table, {k: after[k] - before[k]
                                     for k in WRAPPER_KERNELS})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, filename), "w") as fh:
        fh.write(table.table(sort_by="self_device_time_total",
                             row_limit=40, max_name_column_width=120))
    if not busy:
        log(f"profile {label}: no device time recorded (not measured)")
        return
    log(f"profile of one {label} batch ({BATCH} volumes): device kernels "
        f"{busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall, idle share "
        f"{1 - busy / wall_us:.3f} (profiler on); no cast, exp, softmax, "
        f"division, copy or clone of {head_numel} or more elements but the "
        f"k2s2 interleave's {len(interleave)} (copy_ and clone of "
        f"{sorted({str(shape) for _, shape in interleave})}); "
        f"{records_note(records)}")
    for e in kernels[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
            f"{100 * e.self_device_time_total / busy:5.1f}%  "
            f"x{e.count:<4d} {e.key[:90]}")


# -- the 2D path: HRNet-W48 through the test_2d CLI --------------------------

# configs/model/hrnet_config.yaml's widths (HRNet-W48), GTA's 24 classes
# (configs/datamodule/gta_torch_config.yaml) and its val_batch_size; the
# preprocessed geometry (values_tpu/data/gta_preprocess.py:110-113: a
# centre crop to 1024x1912, then 0.25x) and the full-resolution one
GTA_CLASSES, GTA_BATCH, GTA_HW, GTA_FULL_HW = 24, 6, (256, 478), (1024,
                                                                   1912)
GTA_IMAGES, GTA_FULL_IMAGES, GTA_MEMBERS, GTA_N_PRED = 12, 2, 5, 10
GTA_SEED = 123            # the checkpoints' hparams["seed"]
TIMED_FORWARDS = 10
# |dlogits| of the card's float32 forward (TF32 off) against the CPU's, as
# a share of max|logits|: float32 accumulations in another order and
# another algorithm, over HRNet-W48's depth
F32_CARD_BOUND = 1e-4
# The TF32 default against TF32 off, as a share of max|logits|: TF32
# rounds each conv's operands to 11 significant bits (2^-11), and random
# calibrated weights amplify that through HRNet-W48's ~100 convs. Read on
# an H100 (PR 11): 7.27e-2, against bf16's 0.446 on the same batch (a
# ratio of 0.16; bf16 rounds 8x coarser and stores every activation
# rounded). The bound is twice the reading and a third of bf16's error,
# so a forward at bf16 precision misses it. A trained checkpoint's error
# is not measured (its weights would need a download).
TF32_LOGIT_BOUND = 0.15
# bfloat16 |dsoftmax| against float32: the JAX package's mean limit for
# its small HRNet (5e-3, tests/test_2d_path.py), read at 4.65e-3 on an
# H100 (PR 11); a max of 0.5: single pixels near a decision edge move by
# a large share of their probability (read 8.3e-2)
BF16_MEAN_BOUND, BF16_MAX_BOUND = 5e-3, 0.5
# the families and their sample counts per image (S)
GTA_RUNS = (("softmax", "float32", "id"), ("softmax", "float32", "ood"),
            ("softmax", "bfloat16", "ood"), ("ensemble", "float32", "ood"),
            ("ensemble", "bfloat16", "ood"), ("dropout", "float32", "ood"),
            ("tta", "float32", "ood"), ("ssn", "float32", "ood"),
            ("ssn", "float64", "ood"), ("sliding", "float32", "id"))
GTA_SAMPLES = {"softmax": 1, "ensemble": GTA_MEMBERS, "dropout": GTA_N_PRED,
               "tta": 4, "ssn": GTA_N_PRED, "sliding": 1}
# device kernels by family, matched on the lower-cased kernel name, first
# match wins
KERNEL_FAMILIES = (
    ("bilinear resize", ("upsample_bilinear", "upsample")),
    ("BN", ("batch_norm", "batchnorm", "bn_fw")),
    ("softmax", ("softmax",)),
    ("copies", ("copy", "memcpy", "memset", "cat")),
    ("cuDNN conv", ("conv", "cudnn", "xmma", "implicit", "gemm", "sm90",
                    "cutlass", "winograd", "fft", "nhwc", "nchw")),
    ("C2/GED (reductions, sort, indexing)", ("reduce", "sum", "max", "arg",
                                             "index", "scan", "sort",
                                             "where", "log")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def write_gta_tree(root: str, n_gta: int, n_cs: int, hw, seed: int) -> str:
    """A synthetic preprocessed GTA/Cityscapes tree in
    tests/test_2d_path.py::make_gta_tree's layout: uint8 (H, W, 3) images
    and int64 masks of train ids 0-18 in 16 x 16 blocks, with ignore (255)
    rows at the top; GTA images make ``id_test``, Cityscapes ``ood_test``
    (and the first of each ``val`` and the unlabeled pools)."""
    rs = np.random.RandomState(seed)
    h, w = hw
    names = {"gta": [f"{i:05d}.npy" for i in range(n_gta)],
             "cs": [f"city_{i:03d}.npy" for i in range(n_cs)]}
    for ds, sub in (("gta", "OriginalData"), ("cs",
                                              "CityScapesOriginalData")):
        for kind in ("images", "labels"):
            os.makedirs(os.path.join(root, sub, "preprocessed", kind),
                        exist_ok=True)
        for name in names[ds]:
            np.save(os.path.join(root, sub, "preprocessed", "images", name),
                    rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
            blocks = rs.randint(0, 19, (-(-h // 16), -(-w // 16)))
            mask = np.kron(blocks, np.ones((16, 16), np.int64))[:h, :w]
            mask[:h // 32] = 255
            np.save(os.path.join(root, sub, "preprocessed", "labels", name),
                    mask.astype(np.int64))
    splits = [{"train": [], "val": [(names["gta"][0], "gta")],
               "id_test": [(n, "gta") for n in names["gta"]],
               "ood_test": [(n, "cs") for n in names["cs"]],
               "id_unlabeled_pool": [(names["gta"][0], "gta")],
               "ood_unlabeled_pool": [(names["cs"][0], "cs")]}]
    path = os.path.join(root, "splits", "firstCycle", "splits.pkl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(splits, f)
    return path


def gta_hparams(config: str, root: str, splits: str, extra=()) -> dict:
    """A GTA config at its published widths, composed by the port as the
    training CLI composes it, pointed at ``root``."""
    from values_tpu_torch.config import compose
    cfg = compose(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs"), config,
                  [f"data_input_dir={root}", f"save_dir={root}/exp",
                   "version=0", f"seed={GTA_SEED}",
                   f"datamodule.dataset.splits_path={splits}"] + list(extra))
    return cfg.to_container()


def calibrated_hrnet(hparams: dict, seed: int, calib):
    """HRNet-W48 with random weights from ``seed`` (torch's default conv
    init) and BatchNorm running statistics taken over ``calib`` (a
    cumulative average of train-mode batch statistics), so that each BN
    normalizes as a trained network's would; returned in eval mode."""
    import torch
    from values_tpu_torch.models.hrnet import HighResolutionNet
    torch.manual_seed(seed)
    with torch.device(calib[0].device):
        model = HighResolutionNet(hparams["model"]["cfg"])
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None
    model.train()
    gen = torch.Generator(calib[0].device).manual_seed(seed)
    with torch.no_grad(), tf32(False):
        for x in calib:
            model(x, generator=gen)
    return model.eval()


def write_hrnet_checkpoint(path: str, model, hparams: dict) -> str:
    """A reference-format ``.ckpt``: the ``model.``-prefixed state_dict
    and the hparams."""
    import torch
    torch.save({"state_dict": {"model." + k: v.cpu() for k, v in
                               model.state_dict().items()},
                "hyper_parameters": hparams}, path)
    return path


def check_2d_tree(base: str, family: str, split_ids, hw) -> None:
    """Every image's PNGs (the mean and each of S predictions, or the one),
    TIFs (PE, aleatoric, epistemic; 1 - MSR alone for S = 1) and
    metrics.json entry; PE in [0, log 25], MI >= -1e-6, every map finite,
    Dice in [0, 1]."""
    import math
    import struct
    from values_tpu_torch.evaluation.experiment_dataloader import (
        read_tiff_float32)
    s = GTA_SAMPLES[family]
    metrics = json.load(open(os.path.join(base, "metrics.json")))
    if sorted(metrics) != sorted(list(split_ids) + ["mean"]):
        raise AssertionError(f"{base}: metrics.json holds {sorted(metrics)}")
    pngs = (["mean"] + [f"{i:02d}" for i in range(1, s + 1)] if s > 1
            else ["01"])
    maps = (["pred_entropy", "aleatoric_uncertainty",
             "epistemic_uncertainty"] if s > 1 else ["pred_entropy"])
    mi = {"dropout": "epistemic_uncertainty", "ensemble":
          "epistemic_uncertainty", "tta": "epistemic_uncertainty",
          "ssn": "aleatoric_uncertainty"}.get(family)
    h, w = hw
    for image_id in split_ids:
        entry = metrics[image_id]["metrics"]
        if sorted(entry) != ["dice", "ged"] or not 0 <= entry["dice"] <= 1 \
                or not np.isfinite(entry["ged"]):
            raise AssertionError(f"{base}: {image_id} metrics {entry}")
        for p in pngs:
            path = os.path.join(base, "pred_seg", f"{image_id}_{p}.png")
            with open(path, "rb") as f:
                head = f.read(24)
            if head[:8] != b"\x89PNG\r\n\x1a\n" or struct.unpack(
                    ">II", head[16:24]) != (w, h):
                raise AssertionError(f"{path}: not a {w}x{h} PNG")
        for name in maps:
            arr = read_tiff_float32(os.path.join(base, name,
                                                 f"{image_id}.tif"))
            if arr.shape != (h, w):
                raise AssertionError(f"{base}/{name}/{image_id}: "
                                     f"{arr.shape}")
            if not np.isfinite(arr).all():
                raise AssertionError(f"{base}/{name}/{image_id}: not finite")
            if name == "pred_entropy" and s > 1 and not (
                    arr.min() >= 0 and arr.max() <= math.log(25) + 1e-5):
                raise AssertionError(f"{base}: PE in [{arr.min()}, "
                                     f"{arr.max()}]")
            if name == mi and arr.min() < -1e-6:
                raise AssertionError(f"{base}: MI {arr.min()}")
    if sorted(os.listdir(base)) != sorted(maps + ["metrics.json",
                                                  "pred_seg"]):
        raise AssertionError(f"{base}: {sorted(os.listdir(base))}")


def conv_flops(model, x) -> float:
    """Multiply-adds x 2 of every conv of one forward of ``x`` (the 1x1
    head included), from each conv's output shape."""
    import torch
    total = [0.0]

    def hook(m, _inp, out):
        k = m.kernel_size[0] * m.kernel_size[1] * m.in_channels // m.groups
        total[0] += 2.0 * out.numel() * k

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(x, generator=torch.Generator(x.device).manual_seed(0))
    for h in hooks:
        h.remove()
    return total[0]


def kernel_families(table) -> dict:
    """Device ms by KERNEL_FAMILIES of a profiler table."""
    out = {}
    for e in table:
        if "CUDA" not in str(e.device_type) or e.self_device_time_total <= 0:
            continue
        name = e.key.lower()
        family = next((f for f, keys in KERNEL_FAMILIES
                       if any(k in name for k in keys)), "other")
        out[family] = out.get(family, 0.0) + e.self_device_time_total / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def host_ops(table, n: int = 6) -> str:
    """The host side of a profiler table: the ops' summed self CPU time
    and the ``n`` largest by it, with their counts and time per call."""
    events = sorted((e for e in table if e.self_cpu_time_total > 0),
                    key=lambda e: -e.self_cpu_time_total)
    total = sum(e.self_cpu_time_total for e in events) / 1e3
    return f"self CPU {total:.2f} ms; " + ", ".join(
        f"{e.key[:40]} x{e.count} {e.self_cpu_time_total / 1e3:.2f} ms "
        f"({e.self_cpu_time_total / e.count:.1f} us each)"
        for e in events[:n])


def forward_numbers(model, x, dtype_name: str, allow_tf32: bool,
                    flops: float, card: str) -> dict:
    """HRNet-W48's forward over one batch: images/s (median and min-max
    of TIMED_FORWARDS host-clock runs, each ending in a synchronize), the
    CUDA-event median, achieved TFLOP/s, the least time at the card's
    peak for the type, peak memory; one profiled forward's device time
    and its host side (the ops' self CPU time)."""
    import torch
    peak = {("float32", True): "tf32", ("float32", False): "float32",
            ("bfloat16", True): "bfloat16"}[(dtype_name, allow_tf32)]
    with torch.no_grad(), tf32(allow_tf32):
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(TIMED_FORWARDS):
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        event_ms = cuda_ms(lambda: model(x), reps=TIMED_FORWARDS)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        table = prof.key_averages()
        busy_ms = sum(kernel_families(table).values())
    rates = sorted(x.shape[0] / t for t in times)
    least_ms = flops / PEAK_FLOPS[peak] * 1e3
    out = {"images_per_s": statistics.median(rates), "min": rates[0],
           "max": rates[-1], "event_ms": event_ms,
           "tflops": flops / event_ms / 1e9, "least_ms": least_ms,
           "peak_tflops": PEAK_FLOPS[peak] / 1e12, "peak_gb": peak_gb,
           "busy_ms": busy_ms, "wall_ms": wall_ms}
    log(f"HRNet-W48 forward {dtype_name}"
        f"{' (TF32 default)' if dtype_name == 'float32' and allow_tf32 else ''}"
        f"{' (TF32 off)' if not allow_tf32 else ''}, batch {x.shape[0]} x "
        f"{x.shape[2]}x{x.shape[3]}: {out['images_per_s']:.2f} images/s "
        f"(median of {TIMED_FORWARDS}, {rates[0]:.2f}-{rates[-1]:.2f}); "
        f"CUDA events {event_ms:.3f} ms a batch, {out['tflops']:.1f} "
        f"TFLOP/s of {flops / 1e12:.3f} TFLOP; least time at "
        f"{out['peak_tflops']:.0f} TFLOP/s {least_ms:.3f} ms "
        f"({least_ms / event_ms:.1%} of it); peak memory {peak_gb:.2f} GB; "
        f"one profiled forward: device {busy_ms:.2f} ms of {wall_ms:.2f} ms "
        f"wall, idle share {1 - busy_ms / max(wall_ms, 1e-9):.3f}; host "
        f"{host_ops(table)}; card {card}")
    return out


def profile_2d_batch(tester, model, x, label: str, card: str) -> dict:
    """One batch as the tester runs it (forward, softmax, per-image C2,
    Dice and GED, PNG/TIF writes) under torch.profiler: device time by
    kernel family and the idle share; the table to build/chip_smoke."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    gt = np.zeros((x.shape[0], 5) + tuple(x.shape[2:]), np.int64)
    ids = [f"profile_{label}_{i}" for i in range(x.shape[0])]

    def batch():
        with torch.inference_mode(), tf32(True):  # the CLI's default
            tester.process_output({
                "softmax_pred": torch.stack([tester._forward(model, x)]),
                "image_id": ids, "gt": gt, "dataset": ["gta"] * len(ids)},
                is_ssn=False)

    batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_2d_{label}.txt"), "w") as fh:
        fh.write(table.table(sort_by="self_device_time_total",
                             row_limit=40, max_name_column_width=120))
    families = kernel_families(table)
    busy = sum(families.values())
    if not busy:
        log(f"profile 2D {label}: no device time recorded (not measured)")
        return {}
    log(f"profile of one 2D {label} batch ({x.shape[0]} images, the "
        f"tester's forward, C2, Dice, GED and writes): device {busy:.2f} ms"
        f" of {wall:.2f} ms wall, idle share {1 - busy / wall:.3f} "
        f"(profiler on); by family: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in families.items())
        + f"; host {host_ops(table)}; card {card}")
    return {"device_ms": busy, "wall_ms": wall, "families": families}


def plain_sliding_map(model, image, patch, overlap: float):
    """The regular padded grid of SlidingPredictor2D computed plainly: the
    padded image by numpy, one window at a time through the model,
    accumulated by slicing, divided by counts accumulated alike."""
    import torch
    ph, pw = patch
    h, w = image.shape[1:]
    sh, sw = (max(1, int(p * overlap)) for p in patch)
    while ph % sh:
        sh -= 1
    while pw % sw:
        sw -= 1
    hp = ph + -(-max(h - ph, 0) // sh) * sh
    wp = pw + -(-max(w - pw, 0) // sw) * sw
    host = image.cpu().numpy()
    if hp > h or wp > w:
        mode = "reflect" if hp - h < h and wp - w < w else "edge"
        host = np.pad(host, ((0, 0), (0, hp - h), (0, wp - w)), mode=mode)
    padded = torch.from_numpy(host).to(image.device)
    acc = torch.zeros((GTA_CLASSES, hp, wp), device=image.device)
    cnt = torch.zeros((hp, wp), device=image.device)
    for a in range(0, hp - ph + 1, sh):
        for b in range(0, wp - pw + 1, sw):
            win = padded[None, :, a:a + ph, b:b + pw].contiguous(
                memory_format=torch.channels_last)
            p = torch.softmax(model(win).float(), dim=1)[0]
            acc[:, a:a + ph, b:b + pw] += p
            cnt[a:a + ph, b:b + pw] += 1.0
    return (acc / cnt)[:, :h, :w]


def twod_checks(model, ssn_model, x, card: str) -> dict:
    """The card's HRNet-W48 against the port's CPU path on one batch, the
    TF32 default against TF32 off, bf16 against f32, each against its bound
    above; the bounds missed under ``misses``."""
    import copy
    import torch
    from values_tpu_torch.inference.test_2d import Tester2D
    from values_tpu_torch.ops import metrics as M
    from values_tpu_torch.ops import uncertainty as U
    cpu = copy.deepcopy(model).cpu().to(memory_format=torch.contiguous_format)
    x_cpu = x.cpu().contiguous()
    gt = torch.from_numpy(np.random.RandomState(5).randint(
        0, GTA_CLASSES, (x.shape[0], 2) + tuple(x.shape[2:])))
    with torch.no_grad():
        t0 = time.perf_counter()
        want = cpu(x_cpu)
        cpu_s = time.perf_counter() - t0
        with tf32(False):
            off = model(x)
        with tf32(True):
            on = model(x)
        bf = copy.deepcopy(model).to(torch.bfloat16)(
            x.to(torch.bfloat16)).float()

    def outputs(logits):
        """softmax, 1 - MSR, per-image Dice (the tester's extra-class
        form) and GED of one pass, on the logits' device."""
        p = torch.softmax(logits, dim=1)
        ext = torch.cat([p, p.new_zeros((p.shape[0], 1) + p.shape[2:])], 1)
        g = gt.to(p.device)
        dice = torch.stack([Tester2D.calculate_test_metrics(ext[i], g[i])[
            "dice"] for i in range(p.shape[0])])
        ged = torch.stack([M.generalized_energy_distance(
            ext[i:i + 1], g[i], ignore_index=GTA_CLASSES,
            ged_only=True)["ged"] for i in range(p.shape[0])])
        return {"softmax": p, "1-MSR": U.one_minus_msr(p, 1)["pred_entropy"],
                "dice": dice, "ged": ged}

    scale = float(want.abs().max())
    card_err = float((off.cpu() - want).abs().max()) / scale
    tf32_err = float((on - off).abs().max()) / scale
    o_cpu, o_off, o_on = outputs(want), outputs(off), outputs(on)
    o_err = {k: float((o_off[k].cpu().double() - o_cpu[k].double()).abs()
                      .max()) for k in o_cpu}
    on_err = {k: float((o_on[k].double() - o_off[k].double()).abs().max())
              for k in o_off}
    dp = (torch.softmax(bf, 1) - o_off["softmax"]).abs()
    bf_mean, bf_max = float(dp.mean()), float(dp.max())
    bf_logits = float((bf - off).abs().max()) / scale
    with torch.no_grad(), tf32(False):
        ssn_card = ssn_model(x, mean_only=True).mean
        ssn_cpu = copy.deepcopy(ssn_model).cpu().to(
            memory_format=torch.contiguous_format)(x_cpu,
                                                   mean_only=True).mean
    ssn_err = float((ssn_card.cpu() - ssn_cpu).abs().max()) / float(
        ssn_cpu.abs().max())
    log(f"2D checks, HRNet-W48 batch {x.shape[0]} x {x.shape[2]}x"
        f"{x.shape[3]}, max|logits| {scale:.3f}: card f32 (TF32 off) "
        f"against the CPU forward ({cpu_s:.1f} s) {card_err:.2e} of "
        f"max|logits| (bound {F32_CARD_BOUND:g}); softmax, 1-MSR, Dice, GED "
        f"worst {json.dumps({k: float(f'{v:.3e}') for k, v in o_err.items()})}"
        f" (bound 1e-4); the TF32 default against TF32 off {tf32_err:.2e} "
        f"of max|logits| (bound {TF32_LOGIT_BOUND:g}; bf16's {bf_logits:.2e},"
        f" a ratio of {tf32_err / bf_logits:.3f}), outputs "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in on_err.items()})};"
        f" bf16 against f32 |dsoftmax| mean {bf_mean:.2e} (bound "
        f"{BF16_MEAN_BOUND:g}) max {bf_max:.2e} (bound {BF16_MAX_BOUND:g}); "
        f"the SSN mean head against its CPU forward {ssn_err:.2e} of "
        f"max|mean| (bound {F32_CARD_BOUND:g}); card {card}")
    misses = [what for what, bad in (
        ("card f32 logits", card_err > F32_CARD_BOUND),
        ("card f32 outputs", max(o_err.values()) > 1e-4),
        ("TF32 logits", tf32_err > TF32_LOGIT_BOUND),
        ("bf16 softmax", bf_mean > BF16_MEAN_BOUND or bf_max > BF16_MAX_BOUND),
        ("SSN mean head", ssn_err > F32_CARD_BOUND)) if bad]
    return {"misses": misses, "card_f32": card_err, "outputs": o_err, "tf32_logits": tf32_err,
            "tf32_outputs": on_err, "bf16_logits": bf_logits,
            "bf16_mean": bf_mean, "bf16_max": bf_max,
            "ssn_mean": ssn_err, "cpu_forward_s": cpu_s}


def twod_path(card: str) -> dict:
    """The 2D path at HRNet-W48's published widths on synthetic GTA /
    Cityscapes trees (12 + 12 images at 256x478; 2 at 1024x1912): random
    calibrated weights written as reference checkpoints (a softmax model,
    4 more ensemble members, DROPOUT_FINAL, the SSN at rank 10); every C1
    family through the test_2d CLI under PyTorch's default (TF32), each
    tree checked; the card against the CPU path, TF32, bf16; the sliding
    window against a plain loop; the forward's rates, FLOP/s, memory and
    profiles. No launch of K1-K3 anywhere in it; the SSN run launches
    SSN-C and SSN-S once a member and batch, and nothing else does."""
    import threading
    from collections import Counter
    import torch
    from values_tpu_torch.inference import test_2d
    from values_tpu_torch.inference.window2d import SlidingPredictor2D
    t_phase = time.perf_counter()
    reset_launches()
    threads = Counter(re.sub(r"[-_ ]?\d+", "", t.name)
                      for t in threading.enumerate())
    log(f"2D: the process's threads at the phase's start, by name: "
        f"{dict(threads)}; torch CPU threads {torch.get_num_threads()}; "
        f"load average {os.getloadavg()}")
    root = tempfile.mkdtemp(dir=OUT_DIR, prefix="gta_")
    data, full = os.path.join(root, "GTA"), os.path.join(root, "GTA_full")
    splits = write_gta_tree(data, GTA_IMAGES, GTA_IMAGES, GTA_HW, 0)
    full_splits = write_gta_tree(full, GTA_FULL_IMAGES, 1, GTA_FULL_HW, 1)
    hp = {"softmax": gta_hparams("gta_softmax_config", data, splits),
          "dropout": gta_hparams("gta_softmax_config", data, splits,
                                 ["model=hrnet_config_dropout_final"]),
          "ssn": gta_hparams("gta_ssn_config", data, splits)}
    mean = np.array([0.485, 0.456, 0.406], np.float32) * 255
    std = np.array([0.229, 0.224, 0.225], np.float32) * 255
    calib_rs = np.random.RandomState(7)
    calib = [torch.from_numpy(((calib_rs.randint(0, 256, (GTA_BATCH,) + GTA_HW
                                                 + (3,)) - mean) / std)
                              .astype(np.float32)).permute(0, 3, 1, 2)
             .cuda() for _ in range(2)]
    t0 = time.perf_counter()
    ckpts = {"ensemble": []}
    for m in range(GTA_MEMBERS):
        model = calibrated_hrnet(hp["softmax"], SEED + m, calib)
        ckpts["ensemble"].append(write_hrnet_checkpoint(
            os.path.join(root, f"softmax_{m}.ckpt"), model, hp["softmax"]))
        if m == 0:
            softmax_model = model
    ckpts["softmax"] = ckpts["ensemble"][:1]
    dropout_model = calibrated_hrnet(hp["dropout"], SEED + 10, calib)
    ckpts["dropout"] = [write_hrnet_checkpoint(
        os.path.join(root, "dropout.ckpt"), dropout_model, hp["dropout"])]
    ssn_model = calibrated_hrnet(hp["ssn"], SEED + 20, calib)
    ckpts["ssn"] = [write_hrnet_checkpoint(os.path.join(root, "ssn.ckpt"),
                                           ssn_model, hp["ssn"])]
    params = sum(p.numel() for p in softmax_model.parameters())
    log(f"2D: HRNet-W48 ({params / 1e6:.2f} M parameters, "
        f"{GTA_CLASSES} classes), {GTA_MEMBERS + 2} checkpoints written in "
        f"{time.perf_counter() - t0:.1f} s; trees of {GTA_IMAGES} + "
        f"{GTA_IMAGES} images at {GTA_HW[0]}x{GTA_HW[1]} and "
        f"{GTA_FULL_IMAGES} at {GTA_FULL_HW[0]}x{GTA_FULL_HW[1]}; card "
        f"{card}")

    runs = {}
    for family, dtype, split in GTA_RUNS:
        names = {"tta": "softmax", "sliding": "softmax"}.get(family, family)
        argv = (["--checkpoint_paths"] + ckpts[names]
                + ["--test_split", split, "--dtype", dtype,
                   "--test_batch_size", str(GTA_BATCH), "--save_dir",
                   os.path.join(root, "results", f"{family}_{dtype}")])
        if family in ("dropout", "ssn"):
            argv += ["--n_pred", str(GTA_N_PRED)]
        if family == "tta":
            argv += ["-tta"]
        if family == "sliding":
            argv += ["--sliding_window", str(GTA_HW[0]), str(GTA_HW[1]),
                     "-i", full]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tf32(True):  # PyTorch's default, which main() turned off
            tester = test_2d.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ids = [k for k in tester.results_dict if k != "mean"]
        # one member: a capacitance and a sample launch a batch
        batches = -(-len(ids) // GTA_BATCH)
        want = ({"ssn_capacitance": batches, "ssn_sample_softmax": batches}
                if family == "ssn" else {})
        expect_launches(read_launches(), want, f"test_2d {family} {dtype}")
        if family == "ssn" and dtype == "float32":
            ssn_launches = want
        hw = GTA_FULL_HW if family == "sliding" else GTA_HW
        check_2d_tree(tester.save_dir, family, ids, hw)
        runs[f"{family} {dtype} {split}"] = {
            "seconds": seconds,
            "images": len(ids), "samples": GTA_SAMPLES[family],
            "dice": tester.results_dict["mean"]["metrics"]["dice"]}
        log(f"test_2d {family} {dtype} over {split}: {len(ids)} images, S = "
            f"{GTA_SAMPLES[family]}, {seconds:.2f} s ({seconds / len(ids):.3f}"
            f" s an image); mean Dice "
            f"{runs[f'{family} {dtype} {split}']['dice']:.4f}; tree checked;"
            f" card {card}")
        del tester
    reset_launches()

    # one batch of the id split, as the tester feeds it
    loader_args = test_2d.test_cli(["--checkpoint_paths"] + ckpts["softmax"]
                                   + ["--test_batch_size", str(GTA_BATCH),
                                      "--save_dir", os.path.join(root, "x")])
    tester = test_2d.Tester2D(loader_args)
    model = tester.models[0]
    x = tester._to_device(next(iter(tester.test_dataloader))["data"])
    checks = twod_checks(model, ssn_model.to(
        memory_format=torch.channels_last), x, card)

    # the sliding window on the card against a plain loop (TF32 off)
    image = torch.from_numpy(np.load(os.path.join(
        full, "OriginalData", "preprocessed", "images", "00000.npy"))
        .astype(np.float32)).permute(2, 0, 1).cuda()
    image = (image - torch.from_numpy(mean).to(image.device)[:, None, None]
             ) / torch.from_numpy(std).to(image.device)[:, None, None]
    sp = SlidingPredictor2D(model, GTA_HW, GTA_CLASSES)
    with torch.no_grad(), tf32(False):
        stitched = sp(image)
        one_by_one = SlidingPredictor2D(model, GTA_HW, GTA_CLASSES,
                                        window_batch=1)(image)
        plain = plain_sliding_map(model, image, GTA_HW, 0.5)
    n_windows = len(sp.grid(*image.shape[1:])[3])
    sliding_err = float((stitched - plain).abs().max())
    stitch_err = float((one_by_one - plain).abs().max())
    with torch.no_grad(), tf32(True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp(image)
        torch.cuda.synchronize()
        sliding_s = time.perf_counter() - t0
    # the predictor one window at a time runs the plain loop's forwards,
    # so its grid, pad and stitch are held to 1e-6; batches of 8 windows
    # change cuDNN's sums, so that map is held to the float32 outputs'
    # bound (1e-4)
    log(f"sliding window at {GTA_FULL_HW[0]}x{GTA_FULL_HW[1]} ({n_windows}"
        f" windows of {GTA_HW[0]}x{GTA_HW[1]}, f32, TF32 off): the predictor"
        f" one window at a time against a plain loop (numpy's pad, one "
        f"window at a time, summed by slicing) {stitch_err:.2e} (bound "
        f"1e-6); the predictor (forwards of 8 windows) against the plain "
        f"loop {sliding_err:.2e} (bound 1e-4); {sliding_s:.3f} s an image"
        f" (TF32 default); card {card}")
    if stitch_err > 1e-6 or sliding_err > 1e-4:
        checks["misses"].append("sliding window")

    # the forward's numbers and one profiled batch per type
    flops = conv_flops(model, x)
    forward = {"f32 (TF32 default)": forward_numbers(model, x, "float32",
                                                     True, flops, card),
               "f32 (TF32 off)": forward_numbers(model, x, "float32", False,
                                                 flops, card)}
    profiles = {"f32": profile_2d_batch(tester, model, x, "f32", card)}
    tester.models = [model.to(torch.bfloat16)]
    tester.dtype = torch.bfloat16
    x16 = x.to(torch.bfloat16)
    forward["bf16"] = forward_numbers(tester.models[0], x16, "bfloat16", True,
                                      flops, card)
    profiles["bf16"] = profile_2d_batch(tester, tester.models[0], x16,
                                        "bf16", card)
    launches = read_launches()
    if any(launches.values()):
        checks["misses"].append(f"kernel launches {launches}")
    shutil.rmtree(root)
    seconds = time.perf_counter() - t_phase
    log(f"2D phase: {seconds:.1f} s; the SSN run's launches "
        f"{json.dumps(ssn_launches)} (as expected, and none in the other "
        f"runs); launches after the runs {json.dumps(launches)} (none "
        f"expected); card {card}")
    if checks["misses"]:
        raise AssertionError(f"the 2D phase missed: {checks['misses']}")
    return {"runs": runs, "checks": checks, "forward": forward,
            "ssn_launches": ssn_launches,
            "profiles": profiles, "sliding_err": sliding_err,
            "sliding_s": sliding_s, "flops": flops, "seconds": seconds}


# -- the SSN's sampling kernels (no TPU counterpart) -------------------------

def ssn_sample_inputs(gen):
    """mean, cov_diag (B, N) and cov_factor (B, N, R) at the 2D SSN's
    shape (GTA_BATCH images, GTA_CLASSES classes at GTA_HW, rank
    SSN_RANK), float32: the factor as the HRNet head's ``reshape(B, R,
    N).transpose(1, 2)`` view of (B, R*C, H, W), sum_r W^2 about D, log D
    uniform in [-2, 2]."""
    import torch
    b, c, (h, w), r = GTA_BATCH, GTA_CLASSES, GTA_HW, SSN_RANK
    n = c * h * w
    mean = 2 * torch.randn((b, n), generator=gen, device="cuda")
    cov_diag = torch.exp(torch.rand((b, n), generator=gen, device="cuda") * 4
                         - 2)
    factor = (torch.randn((b, r * c, h, w), generator=gen, device="cuda")
              .reshape(b, r, n) * (cov_diag / r).sqrt()[:, None]
              ).transpose(1, 2)
    return mean, cov_diag, factor


def time_ssn_sample(launches: dict, card: str) -> list:
    """SSN-C and SSN-S through their wrappers at the 2D SSN's shape (B 6,
    C 24, 256x478, R 10, S GTA_N_PRED; float32, the head's factor view),
    with image 1's factor made non-finite: the capacitance against
    float64's ``I + W^T D^-1 W`` (relative to its diagonal, 1e-5; the
    same bits twice) and the flags as ``degenerate()``'s (image 1 alone);
    the samples against the float64 plain composition (``samples``, then
    the softmax) on the same normals: |dp| at most 1e-5 (float32 rounding
    of logits ~10; a wrong term, skip or softmax misses by orders more),
    image 1 the diagonal's alone. Then, on the sound factor, device time
    (10 calls queued), the float32 plain versions' (cuBLAS's capacitance
    product; the composition with ``degenerate()``), the byte bounds and
    the launches the 2D phase's SSN run made."""
    import torch
    from values_tpu_torch.models.ssn_unet3d import LowRankMVN
    from values_tpu_torch.ops.kernels import ssn_sample
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    mean, cov_diag, factor = ssn_sample_inputs(gen)
    b, n, r = factor.shape
    c, s = GTA_CLASSES, GTA_N_PRED
    sound = factor[1, 5, 3].clone()
    factor[1, 5, 3] = float("inf")
    cap = ssn_sample.capacitance(cov_diag, factor)
    same = torch.equal(cap, ssn_sample.capacitance(cov_diag, factor))
    flags = ssn_sample.cholesky_flags(cap)
    dist = LowRankMVN(mean, cov_diag, factor)
    wd = factor[flags.logical_not()].double()
    want_cap = torch.eye(r, dtype=torch.float64, device="cuda") + (
        wd / cov_diag[flags.logical_not()].double()[..., None]
    ).transpose(1, 2) @ wd
    scale = want_cap.diagonal(dim1=1, dim2=2).sqrt()
    cap_err = float(((cap[flags.logical_not()].double() - want_cap).abs()
                     / (scale[:, :, None] * scale[:, None, :])).max())
    eps_r = torch.randn((s, b, r), generator=gen, device="cuda")
    eps_d = torch.randn((s, b, n), generator=gen, device="cuda")
    got = ssn_sample.sample_softmax(mean, cov_diag, factor, flags, eps_r,
                                    eps_d, c)
    want = torch.softmax(LowRankMVN(
        mean.double(), cov_diag.double(), factor.double()).samples(
            eps_r.double(), eps_d.double()).reshape(got.shape), dim=2)
    err = float((got.double() - want).abs().max())
    diagonal = torch.softmax((mean[1].double() + cov_diag[1].double().sqrt()
                              * eps_d[:, 1].double()).reshape(s, c, -1),
                             dim=1)
    diag_err = float((got[:, 1].double() - diagonal).abs().max())
    del want, diagonal, wd
    misses = [m for m, bad in (
        ("capacitance", not cap_err < 1e-5), ("run to run", not same),
        ("flags", flags.tolist() != [k == 1 for k in range(b)]
         or not torch.equal(flags, dist.degenerate())),
        ("samples", not err <= 1e-5),
        ("degenerate image", not diag_err <= 1e-5)) if bad]
    log(f"SSN-C and SSN-S at B {b}, C {c}, {GTA_HW[0]}x{GTA_HW[1]}, R {r}, S "
        f"{s} (f32, image 1's factor non-finite): capacitance against "
        f"float64 {cap_err:.2e} of its diagonal (bound 1e-5), the same bits "
        f"twice {same}, flags {flags.tolist()}; samples against float64 "
        f"max |dp| {err:.2e}, the degenerate image against its diagonal "
        f"alone {diag_err:.2e} (bound 1e-5); card {card}")
    if misses:
        raise AssertionError(f"the SSN sampling kernels missed: {misses}")

    factor[1, 5, 3] = sound
    flags = ssn_sample.degenerate(cov_diag, factor)
    if bool(flags.any()):
        raise AssertionError("the timed SSN inputs are degenerate")
    dist = LowRankMVN(mean, cov_diag, factor)
    shape = (s, b, c, n // c)
    cap_bytes = 4 * b * n * (r + 1)            # the factor and D, once
    sample_bytes = 4 * b * n * (r + 2 + 2 * s)  # W, mean, D; eps_d, out
    entries = []
    for name, fn, plain, nbytes, ops in (
            ("ssn_capacitance",
             lambda: ssn_sample.capacitance(cov_diag, factor),
             lambda: ssn_sample.capacitance_reference(cov_diag, factor),
             cap_bytes, b * n * (r + r * (r + 1))),
            ("ssn_sample_softmax",
             lambda: ssn_sample.sample_softmax(mean, cov_diag, factor, flags,
                                               eps_r, eps_d, c),
             lambda: torch.softmax(dist.samples(eps_r, eps_d).reshape(shape),
                                   dim=2),
             sample_bytes, s * b * n * (2 * r + 6))):
        bound_ms, bound_by = bound(nbytes, ops, "float32")
        entries.append({
            "name": name, "route": "cuda",
            "source": "values_tpu_torch/csrc/ssn_sample.cu",
            "replaces": None, "launches": launches[name],
            "max_abs_err": cap_err if name == "ssn_capacitance" else err,
            "ms": queued_ms(fn), "plain_ms": cuda_ms(plain, reps=3),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "bytes": nbytes, "operations": ops,
            "shape": f"B={b} C={c} HW={GTA_HW[0]}x{GTA_HW[1]} R={r}"
                     + ("" if name == "ssn_capacitance" else f" S={s}")
                     + " f32, the head's factor view"})
    for k in entries:
        log(f"{k['name']} [{k['shape']}]: device time (10 calls queued "
            f"behind a spin kernel) {k['ms']:.4f} ms, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}, {k['bytes'] / 1e9:.3f}"
            f" GB; {k['bound_ms'] / k['ms']:.1%} of it), plain (float32 "
            f"torch) {k['plain_ms']:.3f} ms, max_abs_err "
            f"{k['max_abs_err']:.2e}; launches {k['launches']} in the 2D "
            f"phase's SSN run; card {card}")
    return entries


# -- the GTA pipeline's training half -----------------------------------------

GTA_RAW_IMAGES, CS_RAW_IMAGES = 24, 8       # raw PNG pairs written
GTA_RAW_HW, CS_RAW_HW = (1052, 1914), (1024, 2048)   # published raw sizes
CS_CITIES = {"train": ("aachen", "bochum"), "val": ("lindau", "munster")}
GTA_TRAIN_SEEDS = (123, 124)
# gta_ssn_config's RMSprop at its learning rate 0.01 moves every weight by
# about 10 lr on its first step; from random weights the SSN's cov_diag =
# exp(logits) then overflows float32 and the training loss is NaN within
# the first epoch (read on an NVIDIA H100 80GB HBM3), so the SSN run takes
# 1e-4
GTA_SSN_LR = 1e-4
GTA_TRAIN_EPOCHS = 2
GTA_TIMED_STEPS = 10
GTA_CPU_BATCH = 2        # images of the CPU-held first step
GTA_EVAL_MODELS = ("Softmax", "Ensemble", "Dropout-Final", "TTA", "SSN")
GTA_EVAL_SPLITS = ("val", "id", "ood", "unlabeled")
GTA_EVAL_TASKS = ("threshold", "aggregation", "ood_detection",
                  "failure_detection", "calibration", "ambiguity_modeling")
# The first training step from the same weights and batch, read on an
# NVIDIA H100 80GB HBM3 (700 W) on two batches. float64 on the card and
# the CPU is the same function: 5.2e-13 and 1.8e-12 of the gradient norm
# apart, so 1e-10. float32 (TF32 off): the loss 1e-5 of the CPU's (7.9e-8
# and 7.4e-8 read); the gradient and the BN statistics no further from
# float64 than 3x the CPU's float32 (read: gradient 1.86e-2 and 1.54e-2
# of the norm against the CPU's 1.50e-2 and 1.33e-2, statistics 6.3e-6
# and 5.5e-6 against 3.7e-6 and 3.3e-6): this random HRNet-W48's
# BatchNorms amplify float32's rounding ~10^5-fold, so a bound of 1e-4 on
# the card's gradient norm against the CPU's (read: 7.7e-5 and 3.2e-4)
# sits below float32's own error. TF32 against off: the gradient's
# direction moved 51-53% (P2's 3D bounds, 1e-3 and 1e-2, do not
# transfer: every conv of this forward runs TF32), its norm 1.9e-3 and
# 4.8e-3, the loss 2.2e-5 and 3.8e-5, the statistics 5.8e-3 and 5.9e-3;
# bounded at about five times the larger readings.
GTA_F64_BOUND = 1e-10
GTA_CPU_LOSS_BOUND = 1e-5
GTA_F32_FACTOR = 3.0
GTA_TF32_BOUNDS = {"loss": 2e-4, "norm": 2.5e-2, "stats": 3e-2}


def png_rows(pixels: np.ndarray, bpp: int, types) -> bytes:
    """PNG's filtered scanlines (the specification, section 9) of (H,
    stride) uint8 ``pixels``, row y filtered with ``types[y]``; the encoder
    reads only unfiltered rows, so each row is a few numpy operations."""
    raw = pixels.astype(np.int16)
    h, n = raw.shape
    out = np.empty((h, n + 1), np.uint8)
    zeros = np.zeros(n, np.int16)
    for y in range(h):
        x, b = raw[y], raw[y - 1] if y else zeros
        a = np.concatenate([zeros[:bpp], x[:-bpp]])
        c = np.concatenate([zeros[:bpp], b[:-bpp]])
        kind = types[y]
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out[y, 0] = kind
        out[y, 1:] = (x - pred) & 255
    return out.tobytes()


def write_test_png(path: str, pixels: np.ndarray, colour: int,
                   palette=None) -> None:
    """A test PNG (grey 0, RGB 2 or palette 3; 8 bits) whose rows cycle
    through the five filters, as libpng's adaptive filtering mixes them."""
    import struct
    import zlib
    h = pixels.shape[0]
    rows = pixels.reshape(h, -1)
    bpp = 3 if colour == 2 else 1

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", pixels.shape[1], h, 8,
                                      colour, 0, 0, 0))
    if palette is not None:
        body += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    body += chunk(b"IDAT", zlib.compress(
        png_rows(rows, bpp, [y % 5 for y in range(h)]), 1))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body + chunk(b"IEND", b""))


def raw_image(rs, hw) -> np.ndarray:
    """A smooth-ish uint8 RGB image: 8x8 blocks of random colour with
    noise on top (every filter then has work to do)."""
    h, w = hw
    blocks = rs.randint(0, 256, (-(-h // 8), -(-w // 8), 3))
    img = np.repeat(np.repeat(blocks, 8, 0), 8, 1)[:h, :w]
    return np.clip(img + rs.randint(-12, 13, img.shape), 0, 255).astype(
        np.uint8)


def write_raw_gta(root: str, seed: int) -> dict:
    """The raw GTA5 and Cityscapes trees at the published sizes, as the
    preprocessing reads them (under ``OriginalData`` and
    ``CityScapesOriginalData``, the layout the splits read the cities
    from): GTA ``images/`` and colour ``labels/`` (the
    label table's colours in 16x16 blocks; one label PNG written as a
    palette image), Cityscapes ``leftImg8bit`` and grey
    ``gtFine_labelIds`` in two train and two val cities. Returns the
    arrays written (RGB), by dataset and image id."""
    from values_tpu_torch.data import cityscapes_labels as cs_labels
    rs = np.random.RandomState(seed)
    colours = np.array(sorted(cs_labels.color2trainId), np.uint8)
    written = {"gta": {}, "cityscapes": {}}
    gta = os.path.join(root, "OriginalData")
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(gta, sub), exist_ok=True)
    h, w = GTA_RAW_HW
    for i in range(GTA_RAW_IMAGES):
        name = f"{i:05d}"
        image = raw_image(rs, GTA_RAW_HW)
        index = np.kron(rs.randint(0, len(colours), (-(-h // 16),
                                                     -(-w // 16))),
                        np.ones((16, 16), np.int64))[:h, :w]
        write_test_png(os.path.join(gta, "images", f"{name}.png"), image, 2)
        path = os.path.join(gta, "labels", f"{name}.png")
        if i == 0:
            write_test_png(path, index.astype(np.uint8), 3, colours)
        else:
            write_test_png(path, colours[index], 2)
        written["gta"][name] = (image, colours[index])
    cs = os.path.join(root, "CityScapesOriginalData")
    for split, cities in CS_CITIES.items():
        for city in cities:
            img_dir = os.path.join(cs, "images", "leftImg8bit", split, city)
            lbl_dir = os.path.join(cs, "labels", "gtFine", split, city)
            os.makedirs(img_dir, exist_ok=True)
            os.makedirs(lbl_dir, exist_ok=True)
            for k in range(CS_RAW_IMAGES // 4):
                name = f"{city}_{k:06d}_000019"
                image = raw_image(rs, CS_RAW_HW)
                ids = np.kron(rs.randint(0, 34, (CS_RAW_HW[0] // 16,
                                                 CS_RAW_HW[1] // 16)),
                              np.ones((16, 16), np.int64)).astype(np.uint8)
                write_test_png(os.path.join(
                    img_dir, f"{name}_leftImg8bit.png"), image, 2)
                write_test_png(os.path.join(
                    lbl_dir, f"{name}_gtFine_labelIds.png"), ids, 0)
                written["cityscapes"][name] = (image, ids)
    return written


def expected_preprocessed(image: np.ndarray, label: np.ndarray, dataset):
    """The script's own crop and 0.25x resizes of what it wrote: the
    centre 1024x1912 crop, the rounded mean of each 4x4 block's central
    2x2 (cv2's uint8 linear rule at 4x), each block's top-left label,
    trainIds through the label table (GTA: by colour)."""
    from values_tpu_torch.data import cityscapes_labels as cs_labels

    def crop(a):
        y = (a.shape[0] - 1024) // 2
        x = (a.shape[1] - 1912) // 2
        return a[y:y + 1024, x:x + 1912]

    img = crop(image).astype(np.uint16).reshape(256, 4, 478, 4, 3)
    img = ((img[:, 1:3, :, 1:3].sum(axis=(1, 3)) + 2) // 4).astype(np.uint8)
    lbl = crop(label)[::4, ::4]
    if dataset == "gta":
        table = {tuple(int(v) for v in c): t
                 for c, t in cs_labels.color2trainId.items()}
        flat = lbl.reshape(-1, 3)
        keys = [tuple(int(v) for v in c) for c in flat]
        train = np.array([table[k] for k in keys]).reshape(lbl.shape[:2])
    else:
        lut = np.arange(256)
        for k, v in cs_labels.id2trainId.items():
            lut[k] = v
        train = lut[lbl]
    return img, train


def gta_overrides(data: str, splits: str, save_dir: str, seed: int,
                  version: str, epochs: int, extra=()) -> list:
    return [f"data_input_dir={data}", f"save_dir={save_dir}",
            f"datamodule.dataset.splits_path={splits}", f"seed={seed}",
            f"version={version}", f"max_epochs={epochs}"] + list(extra)


def gta_train_cli(config: str, overrides: list, label: str, card: str):
    """The training CLI on a GTA config under PyTorch's default (cuDNN
    TF32 on): its checkpoint, seconds, epoch lines and K1-K3 launches
    (none expected)."""
    import io
    from values_tpu_torch.training.main import main as train_main
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), tf32(True):
        ckpt = train_main(["--config-name", config] + overrides)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    lines = [line for line in out.getvalue().splitlines()
             if line.startswith("epoch ")]
    losses = [float(line.split("train_loss=")[1].split()[0])
              for line in lines]
    log(f"training CLI {label}: " + " | ".join(lines) + f"; {seconds:.2f} "
        f"s; launches {json.dumps(launches)}; card {card}")
    if not os.path.exists(ckpt) or not losses or not all(
            np.isfinite(losses)) or any(launches.values()):
        raise AssertionError(f"training CLI {label}: checkpoint {ckpt}, "
                             f"losses {losses}, launches {launches}")
    return ckpt, seconds, lines


def gta_step_numbers(exp, state, batch, label: str, card: str,
                     allow_tf32: bool) -> dict:
    """ms a training step and images trained/s (median, min-max over
    GTA_TIMED_STEPS after 2 warm-up steps, host clock ending in a
    synchronize), peak memory, one profiled step: device time by kernel
    family, idle share, host ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(exp.device).manual_seed(0)

    def step():
        exp.train_step(state, batch, gen)

    with tf32(allow_tf32):
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(GTA_TIMED_STEPS):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    table = prof.key_averages()
    name = re.sub(r"\W+", "_", label).strip("_")
    with open(os.path.join(OUT_DIR, f"profile_gta_step_{name}.txt"),
              "w") as fh:
        fh.write(table.table(sort_by="self_device_time_total",
                             row_limit=40, max_name_column_width=120))
    families = kernel_families(table)
    busy = sum(families.values())
    records = kernel_records(table)
    n = batch["data"].shape[0]
    med = statistics.median(times)
    out = {"median_ms": med, "min_ms": min(times), "max_ms": max(times),
           "images_per_s": n / med * 1e3, "min_ips": n / max(times) * 1e3,
           "max_ips": n / min(times) * 1e3, "peak_gb": peak,
           "busy_ms": busy, "wall_ms": wall,
           "idle": None if not busy else 1 - busy / wall,
           "families": families, "records": records}
    log(f"HRNet-W48 training step {label}, batch {n} x "
        f"{tuple(batch['data'].shape[1:3])}: steps " + " / ".join(
            f"{t:.2f}" for t in times) + f" ms, median {med:.2f} ms, "
        f"{out['images_per_s']:.2f} images trained/s ({out['min_ips']:.2f}-"
        f"{out['max_ips']:.2f}), peak {peak:.2f} GB; one profiled step: "
        f"device {busy:.2f} of {wall:.2f} ms wall, idle share "
        + ("not measured" if not busy else f"{out['idle']:.3f}")
        + "; by family " + ", ".join(f"{k} {v:.2f} ms"
                                     for k, v in families.items())
        + f"; host {host_ops(table)}; {records_note(records)}; card {card}")
    return out


def gta_first_step_checks(cfg, variables, batch, card: str) -> dict:
    """The first training step's loss, gradient and BN running statistics
    on the first GTA_CPU_BATCH images, from the same weights: the card's
    float64 against the CPU's (the same function: GTA_F64_BOUND); the
    card's float32 (TF32 off) against the CPU's loss, and against the
    float64 step no further than GTA_F32_FACTOR times the CPU's own
    float32 (gradient and statistics: float32 alone puts this random
    HRNet-W48's gradient 1.5-1.9% off float64's on an H100); PyTorch's
    default (TF32) against TF32 off (GTA_TF32_BOUNDS).
    The biases of the convs feeding a BatchNorm (true gradient 0) are
    left out of the gradient comparison."""
    import torch
    from values_tpu_torch.training.experiment import Experiment

    def run(device, dtype, allow_tf32):
        exp = Experiment(cfg, device)
        state = exp.state_from_variables(variables)
        state.params.to(dtype)
        gen = torch.Generator(exp.device).manual_seed(0)
        small = {k: v[:GTA_CPU_BATCH].to(exp.device) for k, v in
                 batch.items()}
        small["data"] = small["data"].to(dtype)
        t0 = time.perf_counter()
        with tf32(allow_tf32):
            loss = exp.loss(state.params, small, gen)
            loss.backward()
        grads = {n: p.grad.detach().double().cpu()
                 for n, p in state.params.named_parameters()
                 if not (n.endswith("bias") and n.startswith(
                     ("last_layer.0", "cov_factor_conv.0")))}
        stats = {k: v.detach().double().cpu() for k, v in
                 state.params.state_dict().items() if "running" in k}
        return (float(loss.detach()), grads, stats,
                time.perf_counter() - t0)

    runs = {key: run(*key) for key in (
        ("cpu", torch.float64, False), ("cpu", torch.float32, False),
        ("cuda", torch.float64, False), ("cuda", torch.float32, False),
        ("cuda", torch.float32, True))}

    def norm(gs):
        return float(sum((g ** 2).sum() for g in gs.values()).sqrt())

    def apart(a, b):
        """loss rel, gradient |a - b| / |b|, gradient norm rel, the worst
        leaf's |a - b| / |b|, BN statistics max|a - b| / max|b|."""
        la, ga, sa, _ = runs[a]
        lb, gb, sb, _ = runs[b]
        leaf = {n: float((ga[n] - gb[n]).norm() / gb[n].norm())
                for n in gb if float(gb[n].norm()) > 0}
        worst = max(leaf, key=leaf.get)
        return {"loss": abs(la - lb) / abs(lb),
                "grad": norm({n: ga[n] - gb[n] for n in gb}) / norm(gb),
                "norm": abs(norm(ga) - norm(gb)) / norm(gb),
                "leaf": leaf[worst], "leaf_name": worst,
                "stats": max(float((sa[k] - v).abs().max())
                             / max(float(v.abs().max()), 1e-30)
                             for k, v in sb.items())}

    f64 = ("cpu", torch.float64, False)
    out = {"card f64 vs CPU f64": apart(("cuda", torch.float64, False), f64),
           "CPU f32 vs CPU f64": apart(("cpu", torch.float32, False), f64),
           "card f32 vs CPU f64": apart(("cuda", torch.float32, False), f64),
           "card f32 vs CPU f32": apart(("cuda", torch.float32, False),
                                        ("cpu", torch.float32, False)),
           "TF32 vs off": apart(("cuda", torch.float32, True),
                                ("cuda", torch.float32, False))}
    log(f"GTA first step, HRNet-W48, batch {GTA_CPU_BATCH} at "
        f"{tuple(batch['data'].shape[1:3])}, loss {runs[f64][0]:.9f} "
        f"(CPU float64, {runs[f64][3]:.1f} s): " + "; ".join(
            f"{k}: loss rel {v['loss']:.2e}, gradient {v['grad']:.2e} of "
            f"the norm, norm rel {v['norm']:.2e}, worst leaf {v['leaf']:.2e}"
            f" ({v['leaf_name']}), BN statistics {v['stats']:.2e}"
            for k, v in out.items())
        + f"; bounds: float64 {GTA_F64_BOUND:g}; card f32 loss "
        f"{GTA_CPU_LOSS_BOUND:g} of the CPU's, gradient and statistics "
        f"within {GTA_F32_FACTOR:g}x the CPU f32's distance from float64; "
        f"TF32 {json.dumps(GTA_TF32_BOUNDS)}; card {card}")
    card64, cpu32, card32 = (out["card f64 vs CPU f64"],
                             out["CPU f32 vs CPU f64"],
                             out["card f32 vs CPU f64"])
    misses = [what for what, bad in (
        ("float64 loss", card64["loss"] > GTA_F64_BOUND),
        ("float64 gradient", card64["grad"] > GTA_F64_BOUND),
        ("float64 statistics", card64["stats"] > GTA_F64_BOUND),
        ("float32 loss", out["card f32 vs CPU f32"]["loss"]
         > GTA_CPU_LOSS_BOUND),
        ("float32 gradient", card32["grad"]
         > GTA_F32_FACTOR * cpu32["grad"]),
        ("float32 statistics", card32["stats"]
         > GTA_F32_FACTOR * cpu32["stats"]),
        ("TF32 loss", out["TF32 vs off"]["loss"] > GTA_TF32_BOUNDS["loss"]),
        ("TF32 gradient norm", out["TF32 vs off"]["norm"]
         > GTA_TF32_BOUNDS["norm"]),
        ("TF32 statistics", out["TF32 vs off"]["stats"]
         > GTA_TF32_BOUNDS["stats"])) if bad]
    if misses:
        raise AssertionError(f"GTA first step missed: {misses}")
    return out


def gta_task_results(base: str) -> dict:
    """eval_config_gta's task files: thresholds finite; every model's
    Platt parameters finite; AUROC and detection rates, ACE in [0, 1];
    AURC finite; NCC in [-1, 1] or NaN (R3). Returns the means."""
    def load(*parts):
        with open(os.path.join(*parts)) as f:
            return json.load(f)

    thresholds = load(base, "threshold_analysis.json")
    if not all(np.isfinite(v) for d in thresholds.values()
               for v in d.values()):
        raise AssertionError(f"thresholds: {thresholds}")
    out = {"thresholds": thresholds.get("Mean")}
    for model in GTA_EVAL_MODELS:
        version = ("fold0_rank10_seed123" if model == "SSN"
                   else "fold0_seed123")
        exp = os.path.join(base, model, "test_results", version)
        platt = load(exp, "platt_scale_params.json")
        ood = load(exp, "ood_detection.json")
        values = (list(_metric_leaves(ood, "ood_detection_rate"))
                  + list(_metric_leaves(ood, "auroc")))
        if not platt or not all(np.isfinite(v) for d in platt.values()
                                for v in d.values()) or not values or \
                not all(0 <= v <= 1 for v in values):
            raise AssertionError(f"{model}: Platt {platt}, OoD {ood}")
        for split in ("id", "ood"):
            for name in ("failure_detection.json", "calibration.json",
                         "ambiguity_modeling.json"):
                path = os.path.join(exp, split, name)
                if not os.path.exists(path):
                    raise AssertionError(f"{path} missing")
                leaves = [v for v in _json_numbers(load(path))]
                if not leaves or any(
                        not np.isfinite(v) for v in leaves
                        if "ambiguity" not in name):
                    raise AssertionError(f"{path}: {load(path)}")
        out[model] = {"auroc": float(np.mean(list(_metric_leaves(
            ood, "auroc"))))}
    return out


def _json_numbers(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _json_numbers(v)
    elif isinstance(node, list):
        for v in node:
            yield from _json_numbers(v)
    elif isinstance(node, (int, float)) and not isinstance(node, bool):
        yield float(node)


def gta_training_path(card: str) -> dict:
    """GTA's training half at HRNet-W48's published widths: the raw GTA5
    and Cityscapes trees at their published sizes written as PNGs (every
    filter, one palette file), preprocessing and splits through the
    CLI (each output checked against the script's own crop and resize);
    the training CLI on gta_softmax_config (2 epochs, seeds 123 and 124),
    gta_ssn_config (2 epochs, the first mean-only),
    model=hrnet_config_dropout_final (1 epoch) under PyTorch's default and
    gta_softmax_config in bf16; training steps timed and profiled (f32
    under the default and with TF32 off, bf16); the first step against
    the CPU and P2; test_2d on the trained checkpoints (Softmax, the
    2-member Ensemble, Dropout-Final, TTA, SSN) over val, id, ood and
    unlabeled; eval_config_gta's six tasks on seed 123, each timed. Cuts:
    24 + 8 raw images (of the archives' ~25,000 + 5,000), 2 epochs (of
    300), pretrain_epochs 1 (of 5), random initial weights (ImageNet's
    would need a download), the SSN's learning rate (GTA_SSN_LR). No
    launch of K1-K3 anywhere in it; SSN-C and SSN-S once a batch of the
    SSN's test_2d runs."""
    import io
    import torch
    from values_tpu_torch.config import compose, make_config
    from values_tpu_torch.data import gta_preprocess
    from values_tpu_torch.evaluation import EvalExperiments
    from values_tpu_torch.inference import test_2d
    from values_tpu_torch.training.experiment import Experiment
    from values_tpu_torch.training.loops import (_device_batch,
                                                 build_datamodule)
    t_phase = time.perf_counter()
    reset_launches()
    root = tempfile.mkdtemp(dir=OUT_DIR, prefix="gta_train_")
    raw, data = os.path.join(root, "raw"), os.path.join(root, "GTA")
    t0 = time.perf_counter()
    written = write_raw_gta(raw, SEED)
    write_s = time.perf_counter() - t0

    # preprocessing and splits through the CLI
    seconds = {}
    for dataset, sub in (("gta", "OriginalData"),
                         ("cityscapes", "CityScapesOriginalData")):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            gta_preprocess.main([
                "preprocess", "--dataset_path", os.path.join(raw, sub),
                "--save_path", os.path.join(data, sub), "--dataset",
                dataset])
        seconds[dataset] = time.perf_counter() - t0
    splits = os.path.join(data, "splits", "firstCycle", "splits.pkl")
    gta_preprocess.main(["splits", "--dataset_path", data,
                         "--original_dataset_path", raw, "--splits_path",
                         splits, "--seed", "123"])
    checked = 0
    for dataset, sub in (("gta", "OriginalData"),
                         ("cityscapes", "CityScapesOriginalData")):
        for name, (image, label) in written[dataset].items():
            if dataset == "gta" and f"{name}.png" in (
                    gta_preprocess.CORRUPT_GTA_FILES):
                continue
            want_img, want_lbl = expected_preprocessed(image, label, dataset)
            pre = os.path.join(data, sub, "preprocessed")
            got_img = np.load(os.path.join(pre, "images", f"{name}.npy"))
            got_lbl = np.load(os.path.join(pre, "labels", f"{name}.npy"))
            if got_img.dtype != np.uint8 or not np.array_equal(
                    got_img, want_img) or not np.array_equal(got_lbl,
                                                             want_lbl):
                raise AssertionError(f"preprocessed {dataset} {name} "
                                     "differs from the script's own")
            checked += 1
    with open(splits, "rb") as f:
        fold = pickle.load(f)[0]
    n_raw = GTA_RAW_IMAGES + CS_RAW_IMAGES
    log(f"GTA preprocessing: {GTA_RAW_IMAGES} GTA PNG pairs at "
        f"{GTA_RAW_HW[1]}x{GTA_RAW_HW[0]} and {CS_RAW_IMAGES} Cityscapes at "
        f"{CS_RAW_HW[1]}x{CS_RAW_HW[0]} written in {write_s:.1f} s (every "
        f"PNG filter, one palette label); the CLI: GTA {seconds['gta']:.2f}"
        f" s ({seconds['gta'] / GTA_RAW_IMAGES:.3f} s an image), Cityscapes"
        f" {seconds['cityscapes']:.2f} s "
        f"({seconds['cityscapes'] / CS_RAW_IMAGES:.3f} s an image); "
        f"{checked} of {n_raw} outputs "
        f"equal to the script's own crop and resize; splits: "
        + ", ".join(f"{k} {len(v)}" for k, v in fold.items())
        + f"; card {card}")

    # training through the CLI, under PyTorch's default (TF32)
    train_dir = os.path.join(root, "train")
    runs, ckpts = {}, {}
    for seed in GTA_TRAIN_SEEDS:
        ckpts[f"softmax {seed}"], s, _ = gta_train_cli(
            "gta_softmax_config", gta_overrides(
                data, splits, train_dir, seed, f"fold0_seed{seed}",
                GTA_TRAIN_EPOCHS, ["exp_name=Softmax"]),
            f"gta_softmax_config seed {seed} f32", card)
        runs[f"softmax {seed} f32"] = s
    ckpts["ssn"], runs["ssn f32"], _ = gta_train_cli(
        "gta_ssn_config", gta_overrides(
            data, splits, train_dir, 123, "fold0_rank10_seed123",
            GTA_TRAIN_EPOCHS, ["pretrain_epochs=1", "exp_name=SSN",
                               f"learning_rate={GTA_SSN_LR}"]),
        f"gta_ssn_config seed 123 f32 (pretrain_epochs 1, learning_rate "
        f"{GTA_SSN_LR:g})", card)
    ckpts["dropout"], runs["dropout f32"], _ = gta_train_cli(
        "gta_softmax_config", gta_overrides(
            data, splits, train_dir, 123, "fold0_seed123", 1,
            ["model=hrnet_config_dropout_final", "exp_name=Dropout-Final"]),
        "gta_softmax_config model=hrnet_config_dropout_final seed 123 f32",
        card)
    ckpts["bf16"], runs["softmax 123 bf16"], _ = gta_train_cli(
        "gta_softmax_config", gta_overrides(
            data, splits, train_dir, 123, "bf16", GTA_TRAIN_EPOCHS,
            ["precision=bf16", "exp_name=Softmax-bf16"]),
        "gta_softmax_config seed 123 bf16", card)

    # the training step: timed and profiled, held against the CPU
    cfg = compose(os.path.join(REPO, "configs"), "gta_softmax_config",
                  gta_overrides(data, splits, train_dir, 123, "steps", 1))
    exp = Experiment(cfg, "cuda")
    state = exp.init_state_2d(123, 256, 478, 3)
    variables = {c: {m: {k: v.copy() for k, v in leaves.items()}
                     for m, leaves in tree.items()}
                 for c, tree in exp.variables(state).items()}
    dm = build_datamodule(cfg)
    dm.setup("fit")
    batch = _device_batch(next(iter(dm.train_dataloader())), exp.device)
    steps = {"f32 (TF32 default)": gta_step_numbers(
        exp, state, batch, "f32 (TF32 default)", card, True),
        "f32 (TF32 off)": gta_step_numbers(
            exp, state, batch, "f32 (TF32 off)", card, False)}
    cfg16 = make_config(dict(cfg.to_container(), precision="bf16"))
    exp16 = Experiment(cfg16, "cuda")
    steps["bf16"] = gta_step_numbers(exp16, exp16.state_from_variables(
        variables), batch, "bf16", card, True)
    del state
    checks = gta_first_step_checks(cfg, variables, batch, card)

    # test_2d on the trained checkpoints, laid out for eval_config_gta
    eval_base = os.path.join(root, "eval")
    sets = {"Softmax": ([ckpts["softmax 123"]], []),
            "Ensemble": ([ckpts[f"softmax {s}"] for s in GTA_TRAIN_SEEDS],
                         []),
            "Dropout-Final": ([ckpts["dropout"]],
                              ["--n_pred", str(GTA_N_PRED)]),
            "TTA": ([ckpts["softmax 123"]], ["-tta"]),
            "SSN": ([ckpts["ssn"]], ["--n_pred", str(GTA_N_PRED)])}
    test_runs = {}
    ssn_batches = 0
    for model, (paths, flags) in sets.items():
        for split in GTA_EVAL_SPLITS:
            t0 = time.perf_counter()
            with tf32(True):
                tester = test_2d.main(
                    ["--checkpoint_paths", *paths, "--test_split", split,
                     "--save_dir", eval_base, "--exp_name", model,
                     "--test_batch_size", str(GTA_BATCH)] + flags)
            torch.cuda.synchronize()
            dice = tester.results_dict["mean"]["metrics"]["dice"]
            test_runs[f"{model} {split}"] = {
                "seconds": time.perf_counter() - t0,
                "images": len(tester.results_dict) - 1, "dice": dice}
            if model == "SSN":
                ssn_batches += -(-test_runs[f"{model} {split}"]["images"]
                                 // GTA_BATCH)
            if not 0 <= dice <= 1:
                raise AssertionError(f"test_2d {model} {split}: Dice {dice}")
            del tester
    log("test_2d on the trained checkpoints (TF32 default): " + "; ".join(
        f"{k} {v['images']} images {v['seconds']:.2f} s Dice "
        f"{v['dice']:.4f}" for k, v in test_runs.items()) + f"; card {card}")

    # eval_config_gta's six tasks on seed 123, one at a time
    eval_cfg = compose(os.path.join(REPO, "configs", "evaluation"),
                       "eval_config_gta",
                       [f"base_path={eval_base}",
                        "GTA.iter_params.seed=['123']",
                        f"GTA.datamodule_config.data_input_dir={data}",
                        f"GTA.datamodule_config.dataset.splits_path={splits}"])
    eval_cfg["task_params"]["ood_detection"]["function"][
        "base_splits_path"] = os.path.join(data, "splits")
    task_s = {}
    import warnings
    for task in GTA_EVAL_TASKS:
        eval_cfg["tasks"] = [task]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            EvalExperiments(eval_cfg).analyse()
        task_s[task] = time.perf_counter() - t0
        if "Could not find" in out.getvalue():
            raise AssertionError(f"evaluation {task}: {out.getvalue()}")
    results = gta_task_results(eval_base)
    log("eval_config_gta on seed 123 (5 models, val/id/ood/unlabeled): "
        "seconds per task " + ", ".join(f"{t} {s:.2f}"
                                        for t, s in task_s.items())
        + f"; results {json.dumps(results)}; card {card}")

    launches = read_launches()
    # eval_config_gta's tree stays for the reporting phase, which removes it
    kept = tempfile.mkdtemp(dir=OUT_DIR, prefix="gta_eval_")
    shutil.move(eval_base, kept)
    shutil.rmtree(root)
    seconds_phase = time.perf_counter() - t_phase
    log(f"GTA training phase: {seconds_phase:.1f} s; launches "
        f"{json.dumps(launches)} (none of K1-K3; SSN-C and SSN-S "
        f"{ssn_batches} each, one a batch of the SSN's test_2d); card {card}")
    expect_launches(launches, {"ssn_capacitance": ssn_batches,
                               "ssn_sample_softmax": ssn_batches},
                    "the GTA training phase")
    return {"preprocess_s_per_image": {
        k: v / (GTA_RAW_IMAGES if k == "gta" else CS_RAW_IMAGES)
        for k, v in seconds.items()}, "runs": runs, "steps": steps,
        "checks": checks, "test_2d": test_runs, "tasks": task_s,
        "seconds": seconds_phase, "eval_tree": os.path.join(kept, "eval")}


def f2_training_step(card: str) -> dict:
    """F2 on a training step: softmax_config at initial_filter_size 12 in
    bf16 (K1 and the dx entry zero-pad 12 channels to 16), one step on a
    batch of 2 at 64^3 through Experiment, its loss finite and near the
    f32 step's (which runs these shapes unpadded), K1 and K1b launched."""
    import torch
    from values_tpu_torch.config import compose
    from values_tpu_torch.training.experiment import Experiment
    losses = {}
    gen = np.random.RandomState(3)
    batch = {"data": torch.from_numpy(gen.rand(2, PATCH, PATCH, PATCH, 1)
                                      .astype(np.float32)).cuda(),
             "seg": torch.from_numpy(gen.randint(0, CLASSES, (2, PATCH,
                                                             PATCH, PATCH)))
             .cuda()}
    for precision in ("32", "bf16"):
        cfg = compose(os.path.join(REPO, "configs"), "softmax_config",
                      ["model.initial_filter_size=12",
                       f"precision={precision}"])
        exp = Experiment(cfg, "cuda")
        state = exp.init_state(SEED, PATCH)
        reset_launches()
        _, loss = exp.train_step(state, batch,
                                 torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        launches = read_launches()
        losses[precision] = float(loss)
        if precision == "bf16" and (not launches["conv3d_fused"]
                                    or not launches["conv3d_fused_train"]):
            raise AssertionError(f"F2 step: launches {launches}")
    rel = abs(losses["bf16"] - losses["32"]) / abs(losses["32"])
    log(f"F2: softmax_config at initial_filter_size 12, one step at 64^3, "
        f"batch 2: bf16 (channels padded 12 -> 16 in K1 and the dx entry) "
        f"loss {losses['bf16']:.6f} against f32 {losses['32']:.6f}, rel "
        f"{rel:.2e} (bound 1e-2); launches {json.dumps(launches)}; card "
        f"{card}")
    if not np.isfinite(losses["bf16"]) or rel > 1e-2:
        raise AssertionError(f"F2 step: losses {losses}")
    return {"losses": losses, "rel": rel, "launches": launches}


# -- reporting: the results table and the bar plots --------------------------

EVAL_CONFIG_DIR = os.path.join(REPO, "configs", "evaluation")
# the results tree's cut, as al_path and the GTA phase evaluated it: one
# shift, one seed, their models; "~ds_tasks.<task>" drops a task the phase
# wrote no file for
REPORT_LIDC_MODELS = ("Softmax", "Ensemble")
REPORT_LIDC = ["split_param.split_values=[texture]",
               "LIDC.iter_params.shift=[texture]",
               "LIDC.iter_params.seed=['123']"]
REPORTING_MODULES = ("pandas", "matplotlib", "seaborn")


def report_cell_errors(cfg: dict, mean) -> float:
    """Every mean cell of the table against the mean (x 100) over the
    seeds of the task JSON values it reads, read here again; NaN where a
    value is NaN (R3) and in al_improvement's aleatoric rows. Raises on a
    NaN in another place; returns the largest difference."""
    experiment = cfg["experiments"][0]
    models = experiment["iter_params"]["pred_model"]
    split_name = (cfg.get("split_param") or {}).get("name")
    names = [n if isinstance(n, str) else n[1] for n in mean.index_names]
    scalars = {k: v for k, v in experiment.items()
               if not isinstance(v, (dict, list))}
    worst = 0.0
    for r, row in enumerate(mean.index):
        labels = dict(zip(names, row))
        model = labels["pred_model"]
        if model == "Dropout" and "Dropout-Final" in models:
            model = "Dropout-Final"
        scheme = experiment["prediction_models"][model][
            "naming_scheme_version"]
        fmt = dict(scalars, **({split_name: labels[split_name]}
                               if split_name else {}))
        for c, (task, column) in enumerate(mean.columns):
            metric, _, split = column.partition(" ")
            probs = cfg["ds_tasks"][task][metric]
            levels = len(probs["levels"])
            values = []
            for seed in experiment["iter_params"]["seed"]:
                path = os.path.join(cfg["base_path"], model, "test_results",
                                    scheme.format(**dict(fmt, seed=seed)),
                                    split, probs["metrics_file_name"])
                with open(path) as f:
                    node = json.load(f)["mean"]
                if metric == "al_improvement" and \
                        labels["unc_type"] == "aleatoric_uncertainty":
                    values.append(float("nan"))
                    continue
                for level in ("unc_type", "aggregation")[:levels - 1]:
                    node = node[labels[level]]
                values.append(node.get("metrics", node)[probs["metrics_key"]])
            want = float(np.mean(values)) * 100
            got = float(mean.values[r, c])
            if np.isnan(want) != np.isnan(got):
                raise AssertionError(f"table cell {row} {column}: {got}, "
                                     f"the JSONs' mean {want}")
            if not np.isnan(want):
                worst = max(worst, abs(got - want))
    if not worst <= 1e-12:
        raise AssertionError(f"table cells off the JSONs' means by {worst}")
    return worst


def report_table(config_name: str, overrides: list, label: str) -> dict:
    """The table CLI on ``config_name`` with ``overrides``: its text, the
    same table built here (its text equal to the CLI's), every mean cell
    against the JSONs (``report_cell_errors``); the LaTeX goes to
    build/chip_smoke/report_<label>.tex."""
    import io
    from values_tpu_torch.config import compose
    from values_tpu_torch.evaluation.visualization import ds_task_table
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        ds_task_table.main(["-cd", EVAL_CONFIG_DIR, "-cn", config_name,
                            *overrides])
    seconds = time.perf_counter() - t0
    cfg = compose(EVAL_CONFIG_DIR, config_name, overrides).to_container()
    table = ds_task_table.DsTaskTable(cfg)
    mean, std = table.create()
    with contextlib.redirect_stdout(io.StringIO()):
        text = table.to_latex(mean, std)
    if printed.getvalue() != text + "\n":
        raise AssertionError(f"{label}: the CLI printed another table")
    with open(os.path.join(OUT_DIR, f"report_{label}.tex"), "w") as f:
        f.write(text)
    return {"seconds": seconds, "rows": len(mean.index),
            "columns": len(mean.columns), "max_err": report_cell_errors(
                cfg, mean), "nan_cells": int(np.isnan(mean.values).sum()),
            "grey_cells": text.count(r"{\cellcolor[HTML]{D3D3D3}}"),
            "models": sorted(set(mean.level(mean.index_names[
                1 if cfg.get("split_param") else 0]))),
            "std_nan": bool(np.isnan(std.values).all())}


def report_plots(overrides: list) -> dict:
    """run_plots on plot_config with ``overrides``: every SVG parses and
    holds one bar per (group, dataset)."""
    import xml.etree.ElementTree as ET
    from values_tpu_torch.config import compose
    from values_tpu_torch.evaluation.visualization import ds_task_barplots
    cfg = compose(EVAL_CONFIG_DIR, "plot_config", overrides).to_container()
    t0 = time.perf_counter()
    paths = ds_task_barplots.run_plots(cfg)
    seconds = time.perf_counter() - t0
    bars = 0
    for path in paths:
        rects = [(e.get("data-group"), e.get("data-dataset"))
                 for e in ET.parse(path).getroot().iter(
                     "{http://www.w3.org/2000/svg}rect")
                 if e.get("class") == "bar"]
        groups = {g for g, _ in rects}
        datasets = {d for _, d in rects}
        if not rects or len(rects) != len(set(rects)) or \
                len(rects) != len(groups) * len(datasets):
            raise AssertionError(f"{path}: bars {rects}")
        bars += len(rects)
    return {"seconds": seconds, "plots": len(paths), "bars": bars,
            "files": sorted(os.path.relpath(p, cfg["save_path"])
                            for p in paths)}


def reporting_path(card: str, first_cycle: str, gta_eval: str) -> dict:
    """The reporting layer over the trees the AL and GTA phases wrote: the
    table CLI on table_config_lidc (Softmax and Ensemble without
    active_learning, for which only the Ensemble has a file; the Ensemble
    alone with every task, al_improvement's aleatoric rows empty), run_plots
    on plot_config and the table CLI on table_config_gta (every model of
    the GTA phase, without active_learning), each cut to what its phase
    evaluated (texture, seed 123: one seed, so every std is NaN); every
    mean cell against the JSONs, every SVG's bars, no pandas, matplotlib or
    seaborn imported, no launch of K1-K3. Removes both trees."""
    t_phase = time.perf_counter()
    reset_launches()
    lidc = [f"base_path={first_cycle}"] + REPORT_LIDC
    out = {"tables": {
        "LIDC, Softmax and Ensemble": report_table(
            "table_config_lidc", lidc + [
                f"LIDC.iter_params.pred_model=[{', '.join(REPORT_LIDC_MODELS)}]",
                "~ds_tasks.active_learning"], "lidc"),
        "LIDC, Ensemble, every task": report_table(
            "table_config_lidc", lidc + [
                "LIDC.iter_params.pred_model=[Ensemble]"], "lidc_ensemble"),
        "GTA": report_table(
            "table_config_gta", [f"base_path={gta_eval}",
                                 "GTA.iter_params.seed=['123']",
                                 "~ds_tasks.active_learning"], "gta")}}
    save = tempfile.mkdtemp(dir=OUT_DIR, prefix="plots_")
    out["plots"] = report_plots(
        [f"datasets.LIDC.base_path={first_cycle}", f"save_path={save}"]
        + [f"datasets.LIDC.{o}" if o.startswith("split_param") else o
           for o in REPORT_LIDC]
        + [f"LIDC.iter_params.pred_model=[{', '.join(REPORT_LIDC_MODELS)}]",
           "~datasets.LIDC.ds_tasks.active_learning"])
    gta = out["tables"]["GTA"]
    if "Dropout" not in gta["models"] or "Dropout-Final" in gta["models"]:
        raise AssertionError(f"GTA table: models {gta['models']}")
    # al_improvement leaves the aleatoric rows empty; such a cell is grey
    # unless its column's other cells are all equal (the Styler's
    # Normalize then maps the whole column, NaN included, to 0)
    if not out["tables"]["LIDC, Ensemble, every task"]["nan_cells"]:
        raise AssertionError("the Ensemble's table has no empty cell")
    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in REPORTING_MODULES)
    if imported:
        raise AssertionError(f"the reporting phase imported {imported}")
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the reporting phase launched {launches}")
    for tree in (os.path.dirname(first_cycle), os.path.dirname(gta_eval),
                 save):
        shutil.rmtree(tree)
    out["seconds"] = time.perf_counter() - t_phase
    log("reporting (host only; LIDC: texture, seed 123, one seed so every "
        "std is NaN; GTA: seed 123, the phase's 5 models): " + "; ".join(
            f"table {n}: {t['rows']} rows x {t['columns']} columns, models "
            f"{t['models']}, {t['nan_cells']} NaN means, {t['grey_cells']} "
            f"grey cells, cells within {t['max_err']:.1e} of the JSONs' "
            f"means, CLI {t['seconds']:.3f} s" for n, t in out[
                "tables"].items())
        + f"; run_plots on plot_config: {out['plots']['plots']} SVGs, "
        f"{out['plots']['bars']} bars, {out['plots']['seconds']:.3f} s; "
        "Dropout-Final shown as Dropout; none of pandas, matplotlib, "
        f"seaborn imported; K1-K3 launches {json.dumps(launches)} (none "
        f"expected); the phase {out['seconds']:.1f} s; card {card}")
    return out


# -- data parallelism over torch.distributed ----------------------------------

DP_RANKS = 2          # ranks that share the one card (gloo: NCCL refuses)
DP_TIMED_STEPS = 3
# the phase's device: a CPU rehearsal of the phase sets "cpu" (and small
# sizes) in every rank
DP_DEVICE = "cuda"


def dp_batch(seed: int):
    """A global training batch of TRAIN_BATCH 64^3 volumes on the card."""
    import torch
    rs = np.random.RandomState(seed)
    return {"data": torch.from_numpy(rs.rand(TRAIN_BATCH, PATCH, PATCH,
                                             PATCH, 1).astype(np.float32))
            .to(DP_DEVICE),
            "seg": torch.from_numpy(rs.randint(0, CLASSES, size=(
                TRAIN_BATCH, PATCH, PATCH, PATCH))).to(DP_DEVICE)}


def dp_experiment(precision: str):
    from values_tpu_torch.config import compose
    from values_tpu_torch.training.experiment import Experiment
    from values_tpu_torch.training.main import DEFAULT_CONFIG_DIR
    cfg = compose(DEFAULT_CONFIG_DIR, "softmax_config", [
        f"model.initial_filter_size={FILTERS}",
        f"datamodule.patch_size={PATCH}", f"batch_size={TRAIN_BATCH}",
        f"precision={precision}"])
    exp = Experiment(cfg, DP_DEVICE)
    return exp, exp.init_state(int(cfg.seed), PATCH)


def dp_grads(exp, state) -> dict:
    """The gradients a step left on the leaves (the averaged ones after a
    data-parallel step), on the host."""
    from values_tpu_torch.training.experiment import tree_leaves
    names = [f"{m}/{k}" for m in sorted(state.params)
             for k in sorted(state.params[m].get("conv", state.params[m]))]
    return {n: leaf.grad.detach().float().cpu()
            for n, leaf in zip(names, tree_leaves(state.params))}


def dp_scorer_inputs(aleatoric: bool):
    import torch
    from values_tpu_torch.models.torch_import import group_member_state_dicts
    grouped = group_member_state_dicts(member_state_dicts(
        SEED + 11, aleatoric=aleatoric))
    rs = np.random.RandomState(12)
    vols = torch.from_numpy(rs.rand(BATCH, PATCH, PATCH, PATCH, 1)
                            .astype(np.float32)).to(DP_DEVICE)
    gt = torch.from_numpy((rs.rand(BATCH, PATCH, PATCH, PATCH) > 0.7)
                          .astype(np.uint8)).to(DP_DEVICE)
    return grouped, vols, gt


def dp_scorers(dtype):
    import torch
    from values_tpu_torch.inference.scoring import (make_aleatoric_scorer,
                                                    make_scorer)
    det, _ = make_scorer(N_MEMBERS, PATCH, agg_patch=AGG_PATCH,
                         threshold=THRESHOLD, dtype=dtype, device=DP_DEVICE)
    ale, _ = make_aleatoric_scorer(N_MEMBERS, PATCH,
                                   n_aleatoric_samples=N_ALEATORIC,
                                   agg_patch=AGG_PATCH, threshold=THRESHOLD,
                                   dtype=dtype, device=DP_DEVICE)
    return {"deterministic": lambda w, v, g, seed: det(w, v, g),
            "aleatoric": ale}


def dp_engine(kind: str, mesh=None):
    """The 128^3 engine runs of the phase: "window", 5 members over the
    data axis; "tta", one member's 16 variants over the sample axis; f32."""
    import torch
    from values_tpu_torch.inference.engine import SlidingWindowEngine
    from values_tpu_torch.models.unet3d import UNet3D
    from values_tpu_torch.models.torch_import import unet3d_params_from_torch
    states = member_state_dicts(SEED + 13)
    trees = [unet3d_params_from_torch(s) for s in states]
    if kind == "tta":
        trees = trees[:1]
    rs = np.random.RandomState(14)
    vol = rs.rand(BIG, BIG, BIG).astype(np.float32)
    kw = dict(patch_size=PATCH, window_batch=TEST3D_CHUNK,
              dtype=torch.float32, device=DP_DEVICE, seed=5,
              mode="tta" if kind == "tta" else "default")
    engine = SlidingWindowEngine(UNet3D(CLASSES, initial_filter_size=FILTERS),
                                 trees, mesh=mesh,
                                 mesh_strategy="sample" if kind == "tta"
                                 else "window", **kw)
    return engine.run_volume(vol)


def dp_rank(out_dir: str) -> None:
    """One rank of the phase's world (DP_RANKS ranks on card 0, gloo):
    the data-parallel softmax_config step at f32 and bf16 (the first
    step's loss and averaged gradients kept, DP_TIMED_STEPS more timed),
    the sharded deterministic and aleatoric scorers (f32 kept, bf16
    timed), the engine's window and TTA sample strategies at 128^3, and
    the gradient bucket's all-reduce timed; every kernel's launches
    counted over that run. Rank 0 then computes the single-rank
    references. Its results go to ``out_dir/rank{r}.pkl``; a failed
    check raises, which fails the whole script."""
    import torch
    import torch.distributed as dist
    from values_tpu_torch.core.seed import fold_seed
    from values_tpu_torch.parallel.collectives import all_reduce_sum
    from values_tpu_torch.parallel.mesh import (initialize_distributed,
                                                make_mesh,
                                                make_parallel_train_step,
                                                make_sharded_scorer,
                                                shard_rows)
    from values_tpu_torch.training.experiment import tree_leaves
    if DP_DEVICE == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed("gloo")       # two ranks on one card
    rank = dist.get_rank()
    by_data = make_mesh(n_data=DP_RANKS, n_sample=1)
    by_sample = make_mesh(n_data=1, n_sample=DP_RANKS)
    out = {"steps": {}, "scores": {}, "engine": {}}
    reset_launches()
    for precision in ("32", "bf16"):
        exp, state = dp_experiment(precision)
        step = make_parallel_train_step(exp, by_data)
        gen = torch.Generator(device=DP_DEVICE).manual_seed(SEED)
        state, loss = step(state, shard_rows(dp_batch(0), by_data), gen)
        first = {"loss": float(loss), "grads": dp_grads(exp, state)}
        times = []
        for i in range(DP_TIMED_STEPS):
            rows = shard_rows(dp_batch(1 + i), by_data)
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            state, loss = step(state, rows, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if not all(bool(torch.isfinite(leaf).all())
                   for leaf in tree_leaves(state.params)):
            raise AssertionError(f"rank {rank}: non-finite parameters")
        flat = torch.cat([leaf.grad.reshape(-1).float()
                          for leaf in tree_leaves(state.params)])
        reduce_ms = cuda_ms(lambda: all_reduce_sum(flat, by_data.data_group),
                            reps=5)
        first.update(step_ms=statistics.median(times), step_times=times,
                     bucket_numel=flat.numel(), bucket_reduce_ms=reduce_ms)
        out["steps"][precision] = first
        del exp, state
    for dtype in (torch.float32, torch.bfloat16):
        for kind, score in dp_scorers(dtype).items():
            sharded = make_sharded_scorer(score, by_data)
            inputs = dp_scorer_inputs(kind == "aleatoric")
            got = sharded(*inputs, 7)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(N_BATCHES):
                sharded(*inputs, 7)
            torch.cuda.synchronize()
            per_rank = BATCH // DP_RANKS * N_BATCHES
            out["scores"][(kind, str(dtype))] = {
                "scores": got.cpu(), "volumes_per_s_per_rank":
                per_rank / (time.perf_counter() - t0)}
    for kind, mesh in (("window", by_data), ("tta", by_sample)):
        t0 = time.perf_counter()
        out["engine"][kind] = {"out": dp_engine(kind, mesh),
                               "s": time.perf_counter() - t0}
    torch.cuda.synchronize()
    out["launches"] = read_launches()
    missing = [k for k in ("conv3d_fused", "conv3d_fused_train",
                           "conv3d_fused_dx", "fused_entropy",
                           "sampled_softmax_stats") if not out["launches"][k]]
    if missing:
        raise AssertionError(f"rank {rank}: {missing} never launched in the "
                             f"data-parallel run: {out['launches']}")
    dist.barrier()
    if rank == 0:      # the single-rank references, counted nowhere
        out["single"] = {}
        for precision in ("32", "bf16"):
            exp, state = dp_experiment(precision)
            gen = torch.Generator(device=DP_DEVICE).manual_seed(SEED)
            state, loss = exp.train_step(state, dp_batch(0), gen)
            out["single"][precision] = {"loss": float(loss),
                                        "grads": dp_grads(exp, state)}
            del exp, state
        for kind, score in dp_scorers(torch.float32).items():
            w, vols, gt = dp_scorer_inputs(kind == "aleatoric")
            half = BATCH // DP_RANKS
            out["single"][kind] = torch.cat([
                score(w, vols[i * half:(i + 1) * half],
                      gt[i * half:(i + 1) * half], fold_seed(7, i))
                for i in range(DP_RANKS)], dim=1).cpu()
        for kind in ("window", "tta"):
            out["single"][f"engine {kind}"] = dp_engine(kind)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def grad_errors(got: dict, want: dict):
    """Relative gradient errors of ``got`` against ``want``: over all
    leaves (of the norm) and per leaf, the biases feeding an instance norm
    aside (their true gradient is 0)."""
    import torch
    pairs = [(n, got[n], w) for n, w in want.items()
             if not (n.startswith("contr_") and n.endswith("bias"))]
    rel = {n: float((a - w).norm() / w.norm()) for n, a, w in pairs}
    total = float(torch.sqrt(sum(((a - w) ** 2).sum() for _, a, w in pairs))
                  / torch.sqrt(sum((w ** 2).sum() for _, _, w in pairs)))
    return total, rel


def dp_compare_grads(got: dict, want: dict, what: str, total_limit: float,
                     leaf_limit: float, own=None) -> str:
    """The averaged gradients of a data-parallel step against the
    single-rank step's: over all leaves within ``total_limit`` of the
    norm, each leaf within ``leaf_limit`` of its own. ``own``: the
    single-rank step's own (total, per-leaf) error from a reference (bf16
    against f32), which raises each limit to it: a leaf whose gradient
    cancels to rounding (the bottleneck's biases in bf16) differs between
    two summation orders by as much as bf16 differs from f32 there."""
    total, rel = grad_errors(got, want)
    limits = {n: max(leaf_limit, own[1][n]) if own else leaf_limit
              for n in rel}
    total_limit = max(total_limit, own[0]) if own else total_limit
    worst = max(rel, key=lambda n: rel[n] / limits[n])
    if total > total_limit or rel[worst] > limits[worst]:
        raise AssertionError(f"{what}: gradient error {total:.2e} of the "
                             f"norm (limit {total_limit:.2e}), "
                             f"{rel[worst]:.2e} at {worst} (limit "
                             f"{limits[worst]:.2e})")
    return (f"gradient error {total:.2e} of the norm (limit "
            f"{total_limit:.2e}), the leaf nearest its limit {worst} "
            f"{rel[worst]:.2e} (limit {limits[worst]:.2e})")


def nccl_one_rank(card: str) -> dict:
    """A world of one rank over NCCL in this process: the data-parallel
    step against the plain step, in turns (plain, data-parallel,
    data-parallel, plain; DP_TIMED_STEPS steps each, bf16). The step's
    gradient bucket and loss go through ``all_reduce_sum``'s NCCL branch
    (a group of one still calls NCCL), so the difference is the hook's
    cost: the flat bucket, its copy and NCCL's call, which in a world of
    one moves no bytes between cards. Then that call alone on a float32
    bucket of the model's parameter count: NCCL's floor on one card, not
    a transfer."""
    import torch
    import torch.distributed as dist
    from values_tpu_torch.parallel.collectives import all_reduce_sum
    from values_tpu_torch.parallel.launch import free_port
    from values_tpu_torch.parallel.mesh import (make_mesh,
                                                make_parallel_train_step,
                                                shard_rows)
    from values_tpu_torch.training.experiment import tree_leaves
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(n_data=1, n_sample=1)
        if mesh.data_group is None or \
                dist.get_backend(mesh.data_group) != "nccl":
            raise AssertionError("the 1-rank world has no NCCL data group")
        exp, state = dp_experiment("bf16")
        plain = exp.train_step
        parallel = make_parallel_train_step(exp, mesh)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        batch = dp_batch(0)
        state, loss = parallel(state, shard_rows(batch, mesh), gen)
        if not bool(torch.isfinite(loss)):
            raise AssertionError(f"the 1-rank NCCL step: loss {loss}")
        times = {"plain": [], "data-parallel": []}
        for name in ("plain", "data-parallel", "data-parallel", "plain"):
            fn = plain if name == "plain" else parallel
            for _ in range(DP_TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = fn(state, batch, gen)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        numel = sum(leaf.numel() for leaf in tree_leaves(state.params))
        bucket = torch.zeros(numel, device="cuda")
        reduce_ms = queued_ms(lambda: all_reduce_sum(bucket,
                                                     mesh.data_group))
        out = {"plain_ms": statistics.median(times["plain"]),
               "dp_ms": statistics.median(times["data-parallel"]),
               "times": times, "params": numel, "bucket_bytes": 4 * numel,
               "all_reduce_ms": reduce_ms}
        log(f"data parallel, 1-rank NCCL world (bf16 softmax_config step, "
            f"batch {TRAIN_BATCH} x {PATCH}^3): data-parallel step "
            f"{out['dp_ms']:.2f} ms against the plain step "
            f"{out['plain_ms']:.2f} ms (medians of {2 * DP_TIMED_STEPS} in "
            f"turns); all_reduce_sum of the {numel}-parameter bucket "
            f"({4 * numel} bytes) over NCCL in a world of one, no bytes "
            f"between cards, {reduce_ms:.4f} ms (device time, 10 calls "
            f"queued); card {card}")
        return out
    finally:
        dist.destroy_process_group()


def data_parallel_path(card: str) -> dict:
    """The "data parallel" phase: DP_RANKS spawned ranks on card 0 over
    gloo (``dp_rank``), each result held against rank 0's single-rank
    reference; then a 1-rank NCCL world in this process
    (``nccl_one_rank``)."""
    import torch
    from values_tpu_torch.parallel.launch import spawn
    torch.cuda.empty_cache()
    out_dir = os.path.join(OUT_DIR, "data_parallel")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    spawn(dp_rank, (out_dir,), DP_RANKS)
    spawned_s = time.perf_counter() - t0
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    shutil.rmtree(out_dir)     # the ranks' volumes and gradients, ~1 GB
    single = ranks[0]["single"]
    # limits: f32 those of the first training step against the plain path
    # (the two sides add K1's statistics and K1b's db by atomics in
    # another order, and sum the loss over other rows); bf16 ten times
    # looser, each raised to the bf16 step's own distance from the f32
    # step where that is larger (a leaf that cancels to rounding)
    limits = {"32": (2e-4, 1e-3, 1e-2), "bf16": (2e-3, 1e-2, 1e-1)}
    own = {"32": None, "bf16": grad_errors(single["bf16"]["grads"],
                                           single["32"]["grads"])}
    report = {"ranks": DP_RANKS, "spawned_s": spawned_s, "steps": {},
              "launches": [r["launches"] for r in ranks]}
    for precision, (loss_rtol, total, leaf) in limits.items():
        want = single[precision]
        for r, res in enumerate(ranks):
            got = res["steps"][precision]
            rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            if rel > loss_rtol:
                raise AssertionError(f"data-parallel {precision} step, rank "
                                     f"{r}: loss {got['loss']} vs "
                                     f"{want['loss']}")
            msg = dp_compare_grads(got["grads"], want["grads"],
                                   f"data-parallel {precision} step, rank "
                                   f"{r}", total, leaf, own[precision])
            log(f"data parallel, {'f32' if precision == '32' else precision} "
                f"softmax_config step, rank {r} "
                f"of {DP_RANKS} (gloo, one card): loss {got['loss']:.7f} vs "
                f"single-rank {want['loss']:.7f} (rel {rel:.2e}); {msg}; "
                f"step {got['step_ms']:.2f} ms (median of {DP_TIMED_STEPS}, "
                f"{TRAIN_BATCH // DP_RANKS} rows a rank); gradient bucket "
                f"all-reduce through the host "
                f"{got['bucket_reduce_ms']:.3f} ms "
                f"({4 * got['bucket_numel']} bytes); card {card}")
        report["steps"][precision] = {
            "step_ms": [r["steps"][precision]["step_ms"] for r in ranks],
            "bucket_reduce_ms": [r["steps"][precision]["bucket_reduce_ms"]
                                 for r in ranks],
            "bucket_bytes": 4 * ranks[0]["steps"][precision]["bucket_numel"]}
    report["volumes_per_s_per_rank"] = {}
    for kind in ("deterministic", "aleatoric"):
        want = single[kind]
        for r, res in enumerate(ranks):
            got = res["scores"][(kind, str(torch.float32))]["scores"]
            err = (got - want).abs()
            # the main path's limits against its plain path: image sums
            # add 64^3 entropies in another order
            if tuple(got.shape) != (10, BATCH) or \
                    not bool((err <= 1e-3 + 1e-3 * want.abs()).all()):
                raise AssertionError(f"sharded {kind} scorer, rank {r}: "
                                     f"max_abs_err {float(err.max()):.3e}")
        rates = {dt: [r["scores"][(kind, dt)]["volumes_per_s_per_rank"]
                      for r in ranks]
                 for dt in (str(torch.float32), str(torch.bfloat16))}
        report["volumes_per_s_per_rank"][kind] = rates
        log(f"data parallel, sharded {kind} scorer ({N_MEMBERS} members, "
            f"batch {BATCH} over {DP_RANKS} ranks): f32 against the local "
            f"scorer on each rank's rows with its folded seed, max_abs_err "
            f"{float(err.max()):.3e}; volumes/s per rank " + ", ".join(
                f"{dt.split('.')[-1]} {', '.join(f'{v:.2f}' for v in vs)}"
                for dt, vs in rates.items()) + f"; card {card}")
    for kind in ("window", "tta"):
        want = single[f"engine {kind}"]
        for r, res in enumerate(ranks):
            got = res["engine"][kind]["out"]
            if not np.array_equal(got[1], want[1]):
                raise AssertionError(f"engine {kind} over {DP_RANKS} ranks, "
                                     f"rank {r}: counts differ")
            errs = [float(np.abs(g - w).max()) for g, w in
                    zip((got[0], got[2]), (want[0], want[2]))]
            if max(errs) > 1e-4:
                raise AssertionError(f"engine {kind} over {DP_RANKS} ranks, "
                                     f"rank {r}: max_abs_err {errs}")
        layout = ("1 member x 16 TTA variants over the sample axis"
                  if kind == "tta" else
                  f"{N_MEMBERS} members, 8 windows over the data axis")
        log(f"data parallel, engine {kind} strategy over {DP_RANKS} ranks "
            f"({BIG}^3, f32, {layout}"
            f"): softmax and data sums within {max(errs):.2e} of the "
            f"single-rank engine, counts equal; "
            f"{ranks[0]['engine'][kind]['s']:.2f} s on rank 0; card {card}")
    for r, launches in enumerate(report["launches"]):
        log(f"data parallel, rank {r} launches {json.dumps(launches)}")
    report["nccl"] = nccl_one_rank(card)
    with open(os.path.join(OUT_DIR, "data_parallel.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from values_tpu_torch.inference.scoring import (make_aleatoric_scorer,
                                                    make_scorer)
    from values_tpu_torch.ops.kernels import conv3d, entropy, sampling

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; cards visible {torch.cuda.device_count()}, "
        "this run uses 1")
    log(smi)
    log(f"PyTorch's defaults here: cudnn.allow_tf32 "
        f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    # float32 references run in full float32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with phase("build", smi):
        # one nvcc per library, both started together
        from concurrent.futures import ThreadPoolExecutor

        def timed(load):
            t0 = time.perf_counter()
            return load(), time.perf_counter() - t0

        with ThreadPoolExecutor(2) as pool:
            k1_build = pool.submit(timed, conv3d.load_kernel)
            stats_build = pool.submit(timed, sampling.load_kernel)
            (k1_lib, k1_s), (stats_lib, stats_s) = (k1_build.result(),
                                                    stats_build.result())
        entropy.load_kernel()
        log(f"build: K1 nvcc {k1_s:.1f} s, K2 + K3 nvcc {stats_s:.1f} s "
            f"(in parallel); card {smi}")
        check_k1_build(k1_lib)
        k3_sass = check_stats_build(stats_lib)

    with phase("K1 check", smi):
        k1_padded = check_k1()
    with phase("K2 check", smi):
        check_k2()
    with phase("K3 check", smi):
        check_k3()
    with phase("K1b check", smi):
        _, k1b_padded = check_k1b()
    with phase("F2: a bf16 training step at initial_filter_size 12", smi):
        f2_training_step(smi)
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
    with phase("joint ensemble training", smi):
        joint_ckpts, joint = joint_training_path(train_root, smi)
    with phase("test_3d CLI", smi):
        (t3_root, big_dir, big_subjects, t3_seconds,
         t3_launches) = test3d_path(joint_ckpts, train_root, smi)
    with phase("aleatoric engine", smi):
        ale_engine = aleatoric_engine_path(
            big_dir, big_subjects[:BIG_CLI_VOLUMES], smi)
    with phase("test_3d engine timings and profiles", smi):
        engine_rates = engine_throughput(joint_ckpts, big_dir, big_subjects,
                                         smi)
        shutil.rmtree(t3_root)
    with phase("MC-dropout path", smi):
        dropout, dropout_grouped = dropout_path(smi)
        fusion = fusion_cost(dropout_grouped, smi)
    with phase("TTA path", smi):
        tta = tta_path(smi)
    with phase("SSN path", smi):
        ssn = ssn_path(smi)
    with phase("score CLI: MC dropout, TTA, SSN", smi):
        stochastic_cli = stochastic_cli_path(smi)
    with phase("test_3d CLI: TTA, MC dropout, SSN", smi):
        modes_launches, tta_windows_per_s = test3d_modes_path(
            joint_ckpts, train_root, smi)
    with phase("kernel timings", smi):
        kernels = [time_k1(launches, vols.shape[0]),
                   time_k1b(train_runs["f32"][2]),
                   time_k2(launches, grouped, vols),
                   time_k3(a_launches, a_grouped, a_vols)]
        kernels[-1]["sass"] = k3_sass
        # F2: the bf16 shapes K1 and K1b's dx run zero-padded
        kernels[0]["f2_padded"] = k1_padded
        kernels[1]["f2_padded"] = k1b_padded
        # the launches of the other paths, each counted from 0 in its run
        kernels[0]["test_3d_f32"] = time_k1_f32_chunk()
        kernels[0]["path_launches"] = dict(
            {f"joint training {n} ({JOINT_STEPS} steps, G={N_MEMBERS})":
             joint[n]["launches"]["conv3d_fused"] for n in joint},
            **t3_launches,
            **{"aleatoric engine f32": ale_engine["conv3d_fused"],
               f"MC-dropout path ({TIMED_RUNS} batches, {N_PRED} passes)":
               dropout["launches"],
               f"TTA path ({TIMED_RUNS} batches, 16 variants)":
               tta["launches"],
               f"SSN path ({TIMED_RUNS} batches)": ssn["launches"]},
            **{f"score CLI {n}": v for n, v in stochastic_cli.items()},
            **modes_launches)
        kernels[1]["path_launches"] = {
            f"joint training {n} ({JOINT_STEPS} steps, G={N_MEMBERS})":
            joint[n]["launches"]["conv3d_fused_train"] for n in joint}
        for k in kernels:
            extra = ""
            if "loop_ms" in k:
                mufu = ("not computed (no clock read)"
                        if k["mufu_ms"] is None else
                        f"{k['mufu_ms']:.3f} ms at the maximum SM clock, "
                        f"{k['max_sm_clock_mhz']:.0f} MHz")
                extra = (f", stock-torch loop {k['loop_ms']:.3f} ms; "
                         f"{k['operations'] / 1e9:.2f} G operations and "
                         f"{k['sfu_operations'] / 1e9:.3f} G SFU "
                         f"operations needed, SFU floor (computed) "
                         f"{mufu}")
            if "probs_ms" in k:
                extra = (f"; {k['probs_shape']}: {k['probs_ms']:.3f} ms "
                         f"(device time, 10 calls queued: "
                         f"{k['probs_queued_ms']:.4f} ms), "
                         f"bound {k['probs_bound_ms']:.3f} ms "
                         f"({k['probs_bound_by']}), plain "
                         f"{k['probs_plain_ms']:.3f} ms")
            if "dw_library_ms" in k:
                extra = "".join(
                    f"; {dt} ({r['regime']}): device time (10 calls "
                    f"queued) {r['device_ms']:.4f} ms against cuDNN's fold + "
                    f"input gradient {r['library_device_ms']:.4f} ms "
                    f"(the profiler: {r['profiler_ms']:.4f} ms, "
                    f"{r['profiler_records']} of 10 dx records), "
                    f"{r['bound_ms'] / r['device_ms']:.1%} of its bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']}); host clock "
                    f"{r['ms']:.4f} ms against {r['library_ms']:.4f} ms; dW "
                    f"(cuDNN weight gradient) {r['dw_library_ms']:.4f} ms; "
                    f"plain {r['plain_ms']:.3f} ms; max_abs_err "
                    f"{r['max_abs_err']:.2e}"
                    for dt, r in (("bf16", k), ("f32", k["float32"])))
            if "test_3d_f32" in k:
                t = k["test_3d_f32"]
                extra = (f"; {t['regime']} regime at the test_3d chunk "
                         f"[{t['shape']}]: {t['ms']:.3f} ms ("
                         f"{t['tflops']:.1f} TFLOP/s), bound "
                         f"{t['bound_ms']:.3f} ms ({t['bound_by']}, the "
                         f"3xTF32 floor; {t['bound_ms'] / t['ms']:.1%} of "
                         f"it), CUDA-core bound {t['cuda_core_bound_ms']:.3f}"
                         f" ms ({t['cuda_core_bound_ms'] / t['ms']:.1%}), "
                         f"byte bound {t['bytes_bound_ms']:.3f} ms ("
                         f"{t['bytes_bound_ms'] / t['ms']:.1%}), max_abs_err "
                         f"{t['max_abs_err']:.2e}, plain {t['plain_ms']:.3f}"
                         f" ms, F.conv3d(groups={N_MEMBERS}) f32 with TF32 "
                         f"off {t['library_ms']:.3f} ms")
            for key in ("stream_regime", "shared_regime"):
                if key in k:
                    extra += f"; {key} {json.dumps(k[key])}"
            if "path_launches" in k:
                extra += f"; other paths' launches {json.dumps(k['path_launches'])}"
            library = ("none" if k["library_ms"] is None
                       else f"{k['library_ms']:.3f} ms")
            if "queued_ms" in k:
                extra = (f"; device time (10 calls queued behind a spin "
                         f"kernel) {k['queued_ms']:.4f} ms" + extra)
            log(f"{k['name']} [{k['shape']}]: {k['ms']:.3f} ms, bound "
                f"{k['bound_ms']:.3f} ms ({k['bound_by']}), plain "
                f"{k['plain_ms']:.3f} ms, library {library}"
                f"{extra}; launches {k['launches']}; card {smi}")
    with phase("training timings and profiles", smi):
        training = time_training(exp32, state32, train_batch, train_root,
                                 smi)
        shutil.rmtree(train_root)
    with phase("throughput and profiles", smi):
        for b in (16, 128):
            throughput(grouped, smi, b)
        time_k1_layers(grouped, vols)
        time_k1_regimes()
        score, _ = make_scorer(N_MEMBERS, PATCH, agg_patch=AGG_PATCH,
                               threshold=THRESHOLD, dtype=torch.bfloat16)
        head_numel = vols.shape[0] * PATCH ** 3 * N_MEMBERS * CLASSES
        profile_batch(score, (grouped, vols, gt), "deterministic",
                      "profile_main_path.txt", head_numel)
        a_score, _ = make_aleatoric_scorer(
            N_MEMBERS, PATCH, n_aleatoric_samples=N_ALEATORIC,
            agg_patch=AGG_PATCH, threshold=THRESHOLD, dtype=torch.bfloat16)
        profile_batch(a_score, (a_grouped, a_vols, a_gt, 9), "aleatoric",
                      "profile_aleatoric_path.txt", head_numel)
    with phase("dropout and SSN training", smi):
        trained = dropout_ssn_training_path(smi)
        for run, launches in trained["launches"].items():
            kernels[0]["path_launches"][run] = launches["conv3d_fused"]
            if launches["conv3d_fused_train"]:
                kernels[1]["path_launches"][run] = launches[
                    "conv3d_fused_train"]
        for dtype, run in trained["joint"].items():
            key = f"joint dropout training {dtype} ({JOINT_STEPS} steps, " \
                f"G={N_MEMBERS})"
            kernels[0]["path_launches"][key] = run["launches"]["conv3d_fused"]
            kernels[1]["path_launches"][key] = run["launches"][
                "conv3d_fused_train"]
        kernels[0]["path_launches"]["softmax_config_lidc CLI"] = trained[
            "lidc"]["launches"]
    with phase("evaluation and active learning", smi):
        al = al_path(smi)
        for run, launches in al["launches"].items():
            kernels[0]["path_launches"][run] = launches["conv3d_fused"]
            if launches["conv3d_fused_train"]:
                kernels[1]["path_launches"][run] = launches[
                    "conv3d_fused_train"]
    with phase("2D path", smi):
        twod = twod_path(smi)
    with phase("SSN sampling kernels", smi):
        kernels += time_ssn_sample(twod["ssn_launches"], smi)
    with phase("GTA training path", smi):
        gta = gta_training_path(smi)
    with phase("reporting", smi):
        reporting_path(smi, al["first_cycle"], gta["eval_tree"])
    with phase("data parallel", smi):
        dp = data_parallel_path(smi)
        for r, launches in enumerate(dp["launches"]):
            run = f"data parallel rank {r} of {DP_RANKS}"
            kernels[0]["path_launches"][run] = launches["conv3d_fused"]
            kernels[1]["path_launches"][run] = launches["conv3d_fused_train"]
            kernels[2].setdefault("path_launches", {})[run] = launches[
                "fused_entropy"]
            kernels[3].setdefault("path_launches", {})[run] = launches[
                "sampled_softmax_stats"]
    log(f"headline: {vps:.2f} volumes/s deterministic, {a_vps:.2f} "
        f"volumes/s aleatoric ({N_ALEATORIC} samples) (ensemble-{N_MEMBERS},"
        f" {PATCH}^3, bf16, batch {BATCH}); training "
        f"{training['f32']['volumes_per_s']:.2f} volumes/s f32, "
        f"{training['bf16']['volumes_per_s']:.2f} bf16 (UNet3D, "
        f"{PATCH}^3, batch {TRAIN_BATCH}); joint training of {N_MEMBERS} "
        f"members {joint['f32']['volumes_per_s']:.2f} volumes/s f32, "
        f"{joint['bf16']['volumes_per_s']:.2f} bf16; test_3d engine "
        f"{engine_rates['f32']['volumes_per_s']:.2f} / "
        f"{engine_rates['bf16']['volumes_per_s']:.2f} {BIG}^3 volumes/s "
        f"f32 / bf16; test_3d CLI seconds " + ", ".join(
            f"{n} {d} {s:.2f}" for (n, d), s in t3_seconds.items())
        + f"; card {smi}")
    log("headline, stochastic paths (ensemble-5, 64^3, bf16, batch "
        f"{BATCH}; median of {TIMED_RUNS} batches, min-max): " + "; ".join(
            f"{n} {r['volumes_per_s']:.2f} ({r['min']:.2f}-{r['max']:.2f}) "
            f"volumes/s, device {r['device_ms']:.2f} ms a batch, peak "
            f"{r['peak_gb']:.2f} GB" for n, r in (
                (f"MC dropout x {N_PRED}", dropout), ("TTA x 16", tta),
                (f"SSN x {N_PRED}", ssn)))
        + f"; a dropout pass {fusion['dropout pass']['ms']:.3f} ms against "
        f"a fused forward {fusion['fused forward']['ms']:.3f} ms; test_3d "
        f"engine -tta {tta_windows_per_s:.2f} windows/s; card {smi}")
    log("headline, dropout and SSN training (UNet3D f 8, 64^3, batch "
        f"{TRAIN_BATCH}; median of {TIMED_STEPS} steps, min-max): " + "; ".join(
            f"{n} {r['volumes_per_s']:.2f} ({r['min_vps']:.2f}-"
            f"{r['max_vps']:.2f}) volumes trained/s, {r['median_ms']:.2f} ms"
            for n, r in trained["timings"].items())
        + "; joint dropout at G=5 " + ", ".join(
            f"{n} {r['volumes_per_s']:.2f} volumes trained/s"
            for n, r in trained["joint"].items()) + f"; card {smi}")
    log("headline, evaluation and active learning (softmax_config_lidc, "
        f"UNet3D f 8, 64^3, bf16): the phase {al['seconds']['phase']:.1f} s; "
        "evaluation CLI seconds per task " + ", ".join(
            f"{t} {s:.2f}" for t, s in al["seconds"]["tasks"].items())
        + f"; second cycle {al['second_volumes_per_s']:.2f} volumes "
        f"trained/s, step median {statistics.median(al['steps']['second']):.2f}"
        f" ms; card {smi}")
    log(f"headline, the 2D path (HRNet-W48, {GTA_CLASSES} classes, batch "
        f"{GTA_BATCH} x {GTA_HW[0]}x{GTA_HW[1]}; median of {TIMED_FORWARDS} "
        "forwards, min-max): " + "; ".join(
            f"{n} {r['images_per_s']:.2f} ({r['min']:.2f}-{r['max']:.2f}) "
            f"images/s, {r['tflops']:.1f} TFLOP/s, peak {r['peak_gb']:.2f} GB"
            for n, r in twod["forward"].items())
        + "; test_2d seconds " + ", ".join(
            f"{n} {r['seconds']:.2f}"
            for n, r in twod["runs"].items())
        + f"; sliding window {twod['sliding_s']:.3f} s per "
        f"{GTA_FULL_HW[0]}x{GTA_FULL_HW[1]} image; the phase "
        f"{twod['seconds']:.1f} s; card {smi}")
    log("headline, the GTA pipeline's training half (HRNet-W48, batch "
        f"{GTA_BATCH} x {GTA_HW[0]}x{GTA_HW[1]}; median of {GTA_TIMED_STEPS} "
        "steps, min-max): " + "; ".join(
            f"{n} {r['median_ms']:.2f} ms a step, {r['images_per_s']:.2f} "
            f"({r['min_ips']:.2f}-{r['max_ips']:.2f}) images trained/s, "
            f"idle {r['idle'] if r['idle'] is None else round(r['idle'], 3)}"
            f", peak {r['peak_gb']:.2f} GB" for n, r in gta["steps"].items())
        + "; preprocessing s an image " + ", ".join(
            f"{k} {v:.3f}" for k, v in gta["preprocess_s_per_image"].items())
        + "; eval_config_gta seconds " + ", ".join(
            f"{t} {s:.2f}" for t, s in gta["tasks"].items())
        + f"; the phase {gta['seconds']:.1f} s; card {smi}")
    log("headline, data parallelism (softmax_config f 8, 64^3, global "
        f"batch {TRAIN_BATCH}; {DP_RANKS} gloo ranks sharing one card, so "
        "no scaling claim): step ms a rank " + "; ".join(
            f"{p} {', '.join(f'{v:.2f}' for v in r['step_ms'])}"
            for p, r in dp["steps"].items())
        + f"; 1-rank NCCL step {dp['nccl']['dp_ms']:.2f} ms against plain "
        f"{dp['nccl']['plain_ms']:.2f} ms; its NCCL all-reduce of "
        f"{dp['nccl']['bucket_bytes']} bytes in a world of one (no bytes "
        f"between cards) {dp['nccl']['all_reduce_ms']:.4f} ms; sharded scorer volumes/s per rank (bf16) " + ", ".join(
            f"{k} {', '.join(f'{v:.2f}' for v in r[str(torch.bfloat16)])}"
            for k, r in dp["volumes_per_s_per_rank"].items())
        + f"; the phase's spawned ranks {dp['spawned_s']:.1f} s; card {smi}")
    log(f"the script: {time.perf_counter() - T_START:.1f} s from its "
        f"imports to its last phase's end; card {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    # the run drives one card, whatever else the machine shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
