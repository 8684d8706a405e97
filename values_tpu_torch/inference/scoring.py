"""Per-volume scoring of the deep ensemble: only scalars come out.

Counterpart of ``values_tpu/inference/scoring.py`` (``UNC_KEYS``,
``AGG_KEYS``, ``score_rows`` :33-39; ``streaming_update`` and
``streaming_finalize`` :58-75; ``_score_from_stats`` and
``make_packed_scorer`` :118-165; ``make_packed_aleatoric_scorer``
:210-293; ``make_packed_tta_scorer`` :322-383,
``make_packed_dropout_scorer`` :386-442 and ``make_packed_ssn_scorer``
:445-564) and of the softmax + statistics step of
``values_tpu/ops/packed_stats.py:72-88``. One call runs the grouped
ensemble forward (K1 for every 3x3x3 conv), the softmax in float32 and
the C2 statistics over the members (both K2), the argmax and micro Dice against
the ground truth, and the three C3 aggregations of each uncertainty map,
and returns the (10, B) score matrix in :func:`score_rows` order. The
aleatoric scorer replaces the softmax and K2 by members x samples logit
draws accumulated in one pass (K3).

The MC-dropout, TTA and SSN scorers stream their samples one at a time
into ``(sum_softmax, sum_entropy)`` (:func:`streaming_update`), in plain
torch, as the JAX package's scorers do; K2 and K3 stay off them. Their
random draws go through the module-level functions of
:mod:`~values_tpu_torch.models.ensemble_unet3d` (dropout masks, TTA
noise) and :mod:`~values_tpu_torch.models.ssn_unet3d` (the SSN's
normals), from a ``torch.Generator`` on the scorer's device seeded with
the call's ``seed``.

This is the scorer of the OoD, failure-detection and active-learning
test beds, which need image-level scores and no per-voxel maps. The
port keeps the JAX scorer's call contract but not its lane layout:
tensors stay NDHWC, and B is any batch size.
"""
from __future__ import annotations

from typing import (Callable, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch

from ..core.device import resolve_device
from ..core.tracing import span
from ..models.ensemble_unet3d import (PATCH_MULTIPLE, cast_weights,
                                      dropout_forward, grouped_forward_fused,
                                      member_heads, tta_inputs)
from ..models.ssn_unet3d import SSN_HEADS, ssn_distribution
from ..ops.aggregation import UNC_KEYS, aggregate_all_maps
from ..ops.kernels.entropy import fused_entropy
from ..ops.kernels.sampling import BITS, sampled_softmax_stats
from ..ops.metrics import mean_rater_dice
from ..ops.uncertainty import _guarded_plogp

AGG_KEYS = ("patch_level", "image_level", "threshold")


def score_rows() -> List[str]:
    """Row labels of the (10, B) score matrix."""
    return ["dice"] + [f"{u}/{a}" for u in UNC_KEYS for a in AGG_KEYS]


def streaming_update(carry, probs: torch.Tensor, grouped: bool = False):
    """Add a softmax sample (..., C) into ``(sum_softmax, sum_entropy)``,
    or with ``grouped`` the M samples of a grouped forward (..., M, C).
    ``carry`` None starts from zero."""
    ent = -torch.sum(_guarded_plogp(probs), dim=-1)
    if grouped:
        probs, ent = probs.sum(dim=-2), ent.sum(dim=-1)
    if carry is None:
        return probs, ent
    return carry[0] + probs, carry[1] + ent


def streaming_finalize(carry, n_samples: int, class_axis: int = 0) -> dict:
    """``(sum_softmax, sum_entropy)`` over ``n_samples`` samples -> the
    C2 statistics in K2's layout (``mean_softmax``, PE, EE, MI)."""
    sum_p, sum_ent = carry
    mean_softmax = sum_p / n_samples
    pe = -torch.sum(_guarded_plogp(mean_softmax), dim=class_axis)
    ee = sum_ent / n_samples
    return {"mean_softmax": mean_softmax, "pred_entropy": pe,
            "expected_entropy": ee, "mutual_information": pe - ee}


def ensemble_statistics(logits: torch.Tensor) -> dict:
    """Logits (B, D, H, W, M, C) -> float32 softmax over C, then the C2
    statistics over the M members, both in K2's logits form. Returns
    ``mean_softmax`` (C, N) and the PE/EE/MI maps (N,) in float32, N =
    B*D*H*W voxels."""
    m, c = logits.shape[-2:]
    # an (M, C, N) view; the forward leaves its logits grouped by member,
    # which is K2's sample-major layout, so the kernel reads them as is
    return fused_entropy(logits.reshape(-1, m, c).permute(1, 2, 0),
                         logits=True)


def score_from_statistics(stats: Mapping[str, torch.Tensor],
                          gt: torch.Tensor, *, agg_patch: int,
                          threshold, ignore_index: int) -> torch.Tensor:
    """K2's statistics of a (B, D, H, W) batch -> (10, B) float32."""
    b = gt.shape[0]
    spatial = gt.shape[-3:]
    seg = torch.argmax(stats["mean_softmax"], dim=0).reshape(b, *spatial)
    rows = [mean_rater_dice(seg, gt, ignore_index)]
    maps = {k: stats[k].to(torch.float32).reshape(b, *spatial)
            for k in UNC_KEYS}
    aggs = aggregate_all_maps(maps, patch=agg_patch, threshold=threshold)
    for key in UNC_KEYS:
        rows.extend(aggs[key][a] for a in AGG_KEYS)
    return torch.stack([r.to(torch.float32) for r in rows])


def _scorer_device(patch: int, agg_patch: int, device) -> torch.device:
    """Validate a scorer's patch geometry; resolve its device."""
    device = resolve_device(device)
    if patch % PATCH_MULTIPLE:
        raise ValueError(f"patch={patch} must be a multiple of "
                         f"{PATCH_MULTIPLE} (four 2x pools)")
    if not 1 <= agg_patch <= patch:
        raise ValueError(f"agg_patch={agg_patch} must lie in [1, {patch}]")
    return device


def _batch(volumes, gt, patch: int, device):
    """Volumes as (B, p, p, p, 1) and gt as (B, [R,] p, p, p) on
    ``device``, or ValueError."""
    volumes = torch.as_tensor(volumes, device=device)
    gt = torch.as_tensor(gt, device=device)
    if volumes.ndim == 4:
        volumes = volumes[..., None]
    if tuple(volumes.shape[1:]) != (patch, patch, patch, 1):
        raise ValueError(f"volumes: shape {tuple(volumes.shape)}, "
                         f"expected (B, {patch}, {patch}, {patch}[, 1])")
    if gt.shape[0] != volumes.shape[0] or gt.ndim not in (4, 5) \
            or tuple(gt.shape[-3:]) != (patch,) * 3:
        raise ValueError(f"gt: shape {tuple(gt.shape)}, expected "
                         f"({volumes.shape[0]}, [R,] {patch}, {patch}, "
                         f"{patch})")
    return volumes, gt


def make_scorer(members: int, patch: int, *, agg_patch: int = 10,
                threshold: Union[float, Sequence[float]] = 0.3,
                ignore_index: int = 0, dtype: torch.dtype = torch.bfloat16,
                device=None) -> Tuple[Callable, List[str]]:
    """Build the ensemble-entropy scorer.

    Returns ``(score_fn, rows)`` with ``score_fn(grouped_weights,
    volumes, gt) -> (10, B) float32`` on the scorer's device:

    - ``grouped_weights``: from
      :func:`values_tpu_torch.models.torch_import.group_member_state_dicts`;
    - ``volumes``: (B, p, p, p) or (B, p, p, p, 1), any B;
    - ``gt``: integer (B, p, p, p), or (B, R, p, p, p) for R raters, whose
      Dice row is then the mean over raters.

    ``threshold`` is a scalar or a (PE, EE, MI) triple. The forward runs
    in ``dtype``; softmax and statistics run in float32. ``device=None``
    means the CUDA card and raises when there is none.
    """
    device = _scorer_device(patch, agg_patch, device)

    def score(grouped_weights, volumes, gt) -> torch.Tensor:
        with span("score"), torch.no_grad():
            with span("score.cast"):
                volumes, gt = _batch(volumes, gt, patch, device)
                weights = cast_weights(grouped_weights, dtype, device)
                x = volumes.to(dtype)
            with span("score.forward"):
                logits = grouped_forward_fused(weights, x, members)
            with span("score.c2"):
                stats = ensemble_statistics(logits)
            with span("score.c3"):
                return score_from_statistics(
                    stats, gt, agg_patch=agg_patch, threshold=threshold,
                    ignore_index=ignore_index)

    return score, score_rows()


def make_aleatoric_scorer(members: int, patch: int, *,
                          n_aleatoric_samples: int = 10,
                          agg_patch: int = 10,
                          threshold: Union[float, Sequence[float]] = 0.3,
                          ignore_index: int = 0,
                          dtype: torch.dtype = torch.bfloat16,
                          bits: str = "philox",
                          counter_rows: Optional[int] = None,
                          device=None) -> Tuple[Callable, List[str]]:
    """Build the scorer of the aleatoric-logit-sampling deep ensemble
    (reference loop test_3D.py:458-469).

    Returns ``(score_fn, rows)`` with ``score_fn(grouped_weights,
    volumes, gt, seed) -> (10, B) float32``; weights, volumes and gt as
    for :func:`make_scorer`, the weights with a ``final_aleatoric`` head.
    One grouped forward gives (mu, s) per member; K3 takes them as the
    forward leaves them, forms ``sigma = exp(s / 2)`` in float32, draws
    ``n_aleatoric_samples`` logit samples per member from the int
    ``seed`` and accumulates their softmax and entropy; the C2
    statistics over members x samples then feed Dice and C3. No (S, ...)
    stack is ever held.

    ``bits`` picks K3's bit source: ``"philox"``, or ``"counter"``, which
    draws exactly what the JAX package's counter-bits kernel draws for a
    D-block of ``counter_rows`` rows (default: the JAX kernel's own
    default block) and needs ``128 % patch == 0``.
    """
    device = _scorer_device(patch, agg_patch, device)
    if bits not in BITS:
        raise ValueError(f"bits={bits!r} is not one of {BITS}")
    if bits == "counter" and 128 % patch:
        raise ValueError(f"bits='counter' needs a patch that divides 128, "
                         f"not {patch}")
    n = int(n_aleatoric_samples)

    def score(grouped_weights, volumes, gt, seed: int) -> torch.Tensor:
        with span("score"), torch.no_grad():
            with span("score.cast"):
                volumes, gt = _batch(volumes, gt, patch, device)
                if "final_aleatoric" not in grouped_weights:
                    raise ValueError("the aleatoric scorer needs weights "
                                     "with a 'final_aleatoric' head")
                weights = cast_weights(grouped_weights, dtype, device)
                x = volumes.to(dtype)
            with span("score.forward"):
                out = grouped_forward_fused(weights, x, members)
            with span("score.c2"):
                # (B, D, H, W, M, 2C): the first C channels are mu, the
                # last s; K3 reads both in the forward's type and forms
                # sigma itself
                c = out.shape[-1] // 2
                head = out.reshape(-1, members, 2 * c)
                carry = sampled_softmax_stats(
                    head[..., :c], None, seed, log_var=head[..., c:],
                    n_samples=n, bits=bits, spatial=(patch,) * 3,
                    counter_rows=counter_rows)
                stats = streaming_finalize(carry, members * n)
            with span("score.c3"):
                return score_from_statistics(
                    stats, gt, agg_patch=agg_patch, threshold=threshold,
                    ignore_index=ignore_index)

    return score, score_rows()


def score_from_carry(carry, n_samples: int, gt: torch.Tensor, **kw
                    ) -> torch.Tensor:
    """A streamed ``(sum_softmax (B, D, H, W, C), sum_entropy (B, D, H,
    W))`` over ``n_samples`` samples -> (10, B) float32."""
    stats = streaming_finalize(carry, n_samples, class_axis=-1)
    c = stats["mean_softmax"].shape[-1]
    stats["mean_softmax"] = stats["mean_softmax"].reshape(-1, c).t()
    return score_from_statistics(stats, gt, **kw)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def make_dropout_scorer(members: int, patch: int, *, n_pred: int,
                        agg_patch: int = 10,
                        threshold: Union[float, Sequence[float]] = 0.3,
                        ignore_index: int = 0,
                        dtype: torch.dtype = torch.bfloat16,
                        device=None) -> Tuple[Callable, List[str]]:
    """Build the MC-dropout scorer (models left in train mode, reference
    test_3D.py:417-483).

    Returns ``(score_fn, rows)`` with ``score_fn(grouped_weights,
    volumes, gt, seed) -> (10, B) float32``; weights, volumes and gt as
    for :func:`make_scorer`. Each of the ``n_pred`` passes draws its 17
    dropout masks and runs the grouped dropout forward
    (:func:`~values_tpu_torch.models.ensemble_unet3d.dropout_forward`: 18
    K1 launches, no fusion across the dropout sites); every member's
    softmax (float32) is streamed in. Samples: members x ``n_pred``.
    """
    device = _scorer_device(patch, agg_patch, device)
    kw = dict(agg_patch=agg_patch, threshold=threshold,
              ignore_index=ignore_index)

    def score(grouped_weights, volumes, gt, seed: int) -> torch.Tensor:
        with span("score"), torch.no_grad():
            with span("score.cast"):
                volumes, gt = _batch(volumes, gt, patch, device)
                if "final" not in grouped_weights:
                    raise ValueError(
                        "the MC-dropout scorer needs weights with a 'final' "
                        "head; an aleatoric-head ensemble goes to "
                        "make_aleatoric_scorer")
                weights = cast_weights(grouped_weights, dtype, device)
                gen = _generator(device, seed)
                x = volumes.to(dtype)
            carry = None
            for _ in range(n_pred):
                with span("score.forward"):
                    logits = dropout_forward(weights, x, members, gen)
                with span("score.c2"):
                    carry = streaming_update(
                        carry, torch.softmax(logits.float(), dim=-1),
                        grouped=True)
            with span("score.c3"):
                return score_from_carry(carry, members * n_pred, gt, **kw)

    return score, score_rows()


def make_tta_scorer(members: int, patch: int, *, do_dropout: bool = False,
                    agg_patch: int = 10,
                    threshold: Union[float, Sequence[float]] = 0.3,
                    ignore_index: int = 0,
                    dtype: torch.dtype = torch.bfloat16,
                    device=None) -> Tuple[Callable, List[str]]:
    """Build the test-time-augmentation scorer (reference loop
    test_3D.py:427-456).

    Returns ``(score_fn, rows)`` with ``score_fn(grouped_weights,
    volumes, gt, seed) -> (10, B) float32``. The 16 variants (clean and
    noisy input, each as is and under the 7 flips; the noise drawn once
    per call) run as 16 sequential grouped forwards at G = M, each
    softmax un-flipped and streamed in member by member. With
    ``do_dropout`` dropout stays live, each variant drawing its own
    masks. Samples: members x 16.
    """
    device = _scorer_device(patch, agg_patch, device)
    kw = dict(agg_patch=agg_patch, threshold=threshold,
              ignore_index=ignore_index)

    def score(grouped_weights, volumes, gt, seed: int) -> torch.Tensor:
        with span("score"), torch.no_grad():
            with span("score.cast"):
                volumes, gt = _batch(volumes, gt, patch, device)
                weights = cast_weights(grouped_weights, dtype, device)
                gen = _generator(device, seed)
            carry = None
            for xv, axes in tta_inputs(volumes.to(torch.float32), gen):
                with span("score.forward"):
                    xv = xv.to(dtype)
                    logits = (dropout_forward(weights, xv, members, gen)
                              if do_dropout else
                              grouped_forward_fused(weights, xv, members))
                with span("score.c2"):
                    p = torch.softmax(logits.float(), dim=-1)
                    carry = streaming_update(
                        carry, torch.flip(p, axes) if axes else p,
                        grouped=True)
            with span("score.c3"):
                return score_from_carry(carry, members * 16, gt, **kw)

    return score, score_rows()


def make_ssn_scorer(num_classes: int, members: int, patch: int, *,
                    n_pred: int = 1, rank: int = 10, epsilon: float = 1e-5,
                    agg_patch: int = 10,
                    threshold: Union[float, Sequence[float]] = 0.3,
                    ignore_index: int = 0,
                    dtype: torch.dtype = torch.bfloat16,
                    device=None) -> Tuple[Callable, List[str]]:
    """Build the SSN deep-ensemble scorer (reference loop
    test_3D.py:361-396).

    Returns ``(score_fn, rows)`` with ``score_fn(grouped_weights,
    volumes, gt, seed) -> (10, B) float32``, the weights with the three
    SSN heads. One grouped trunk forward in ``dtype`` (18 K1 launches, no
    head), then the members one at a time: the heads in float32 give the
    member's low-rank normal, whose (B, C*V, R) factor is the largest
    tensor of the path and lives for one member only; the degeneracy
    check runs once per member; each of the ``n_pred`` samples is drawn,
    softmaxed and streamed in before the next. Samples: members x
    ``n_pred``.
    """
    device = _scorer_device(patch, agg_patch, device)
    kw = dict(agg_patch=agg_patch, threshold=threshold,
              ignore_index=ignore_index)

    def score(grouped_weights, volumes, gt, seed: int) -> torch.Tensor:
        with span("score"), torch.no_grad():
            with span("score.cast"):
                volumes, gt = _batch(volumes, gt, patch, device)
                missing = [h for h in SSN_HEADS if h not in grouped_weights]
                if missing:
                    raise ValueError(
                        f"the SSN scorer needs the SSN heads {missing}")
                trunk = cast_weights({k: v for k, v in
                                      grouped_weights.items()
                                      if k not in SSN_HEADS}, dtype, device)
                heads = cast_weights({k: grouped_weights[k]
                                      for k in SSN_HEADS},
                                     torch.float32, device)
                gen = _generator(device, seed)
                x = volumes.to(dtype)
            b = volumes.shape[0]
            with span("score.forward"):
                feats = grouped_forward_fused(trunk, x, members,
                                              apply_final=False)
            carry = None
            for m in range(members):
                with span("score.forward"):
                    dist = ssn_distribution(
                        feats[..., m, :].float(),
                        member_heads(heads, m, members, torch.float32),
                        num_classes, rank, epsilon)
                    terms = dist.sampling_terms()
                with span("score.c2"):
                    for _ in range(n_pred):
                        logits = dist.rsample(gen, 1, terms)[0].reshape(
                            (b, num_classes) + (patch,) * 3).movedim(1, -1)
                        carry = streaming_update(
                            carry, torch.softmax(logits, dim=-1))
                del dist, terms   # free this member's factor before the next
            with span("score.c3"):
                return score_from_carry(carry, members * n_pred, gt, **kw)

    return score, score_rows()
