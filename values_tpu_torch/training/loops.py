"""The fit loop: epochs over the host pipeline feeding the train step.

The port's counterpart of ``values_tpu/training/loops.py`` (reference:
uncertainty_modeling/main.py:33-88), on one device: datamodule
prepare/setup, per-epoch training and validation, scalar logging, the
learning-rate schedule (polynomial per step, plateau per epoch), and
self-describing checkpoints under
``save_dir/<exp_name>/<version>/checkpoints/``. A config with
``AUGMENTATIONS`` is the 2D path (JAX :126-135, :190-193): the 2D
datamodule built with the augmentations, batch size, epochs and seed, the
HRNet from ``init_state_2d`` on the crop's height and width, and
checkpoints of its ``{params, batch_stats}``.

Data parallelism (JAX :104-107, :141-185, :236-340): ``devices``/``gpus``
> 1 trains over a ``torch.distributed`` world of that many ranks, one a
card (clamped to the visible cards, with the JAX message), the data axis
laid out over ``dcn_granules`` nodes when given. The world comes from a
launcher (torchrun) or from ``values_tpu_torch.training.main``, which
spawns the local ranks itself. Rank 0 prepares the data behind a
barrier; every rank iterates the same seeded loader and keeps its rows of
each global batch (so the global batch is byte-equal to the single-rank
one, for N times the host's loading work), a ragged tail batch is dropped
as the JAX loop drops it, the step is
:func:`~values_tpu_torch.parallel.mesh.make_parallel_train_step`, every
rank validates on the whole batch (the plateau decision is rank 0's), and
rank 0 alone logs and writes checkpoints.
"""
from __future__ import annotations

import os
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config, instantiate
from ..core import tracing
from ..core.device import resolve_device
from ..core.seed import set_seed
from ..parallel.mesh import (global_rank, initialize_distributed,
                             make_hybrid_mesh, make_mesh,
                             make_parallel_train_step, rank_device,
                             requested_ranks, shard_rows, world_size)
from . import optim
from .checkpoint import (TORCH_OPTIMIZER_KEY, CheckpointRetention,
                         load_checkpoint, to_torch_tree)
from .experiment import Experiment
from .tb_logging import TensorBoardLogger


def data_parallel_ranks(cfg: Config, device) -> int:
    """The data-parallel width that ``devices`` (or the reference's
    ``gpus``) asks for, clamped to what ``device``'s type shows."""
    return requested_ranks(cfg.get("devices", cfg.get("gpus")), device)


def _device_batch(batch: Dict, device: torch.device) -> Dict:
    out = {"data": tracing.to_device(
        torch.from_numpy(np.asarray(batch["data"])), device)}
    if "seg" in batch:
        out["seg"] = tracing.to_device(
            torch.from_numpy(np.asarray(batch["seg"])), device)
    return out


def _log_val_image(logger, experiment, params, batch, step: int) -> None:
    """One validation panel (input / ground truth / prediction; of the
    central slice in 3D), as the reference's TensorBoard image grids
    (lightning_experiment.py:332-372). A DROPOUT_FINAL HRNet draws its
    masks from a generator of its own, seeded with the step, so logging
    leaves the training draws alone. Best effort: a failure warns once
    and never stops training."""
    try:
        data = batch["data"][:1]
        generator = torch.Generator(device=data.device).manual_seed(step)
        out = experiment.eval_apply(params, data, generator)
        if isinstance(out, tuple):
            out = out[0]
        spatial = tuple(data.shape[1:-1])
        if hasattr(out, "rsample"):  # the SSN's distribution: its mean
            out = out.mean.reshape((1, experiment.num_classes) + spatial)
        elif not experiment.is_2d:
            out = out.movedim(-1, 1)
        pred = tracing.to_host(torch.argmax(out, dim=1)[0]).numpy()
        img = tracing.to_host(data[0]).numpy()
        seg = (tracing.to_host(batch["seg"][0]).numpy() if "seg" in batch
               else None)
        if experiment.is_2d:
            img2d, pred2d = img.mean(axis=-1), pred
            seg2d = seg if seg is not None and seg.ndim == 2 else (
                seg[0] if seg is not None else np.zeros_like(pred2d))
        else:
            mid = img.shape[0] // 2
            img2d, pred2d = img[mid, ..., 0], pred[mid]
            seg2d = seg[mid] if seg is not None else np.zeros_like(pred2d)

        def norm(x):
            x = x.astype(np.float32)
            lo, hi = x.min(), x.max()
            return (x - lo) / (hi - lo + 1e-8)

        panel = np.concatenate([norm(img2d), norm(seg2d), norm(pred2d)],
                               axis=1)[..., None]
        logger.log_image("validation/example", np.repeat(panel, 3, axis=-1),
                         step)
    except Exception as exc:  # a logging boundary: warn, keep training
        if not getattr(_log_val_image, "_warned", False):
            _log_val_image._warned = True
            warnings.warn(f"validation image logging failed: {exc!r} "
                          "(further failures suppressed)")


def build_datamodule(cfg: Config):
    """The config's datamodule, not yet set up: the 2D one (a config with
    ``AUGMENTATIONS``) given the augmentations, batch size, epochs and
    seed, as the JAX ``fit`` builds it (:126-135); a 3D one given the
    data directory and batch size."""
    if "AUGMENTATIONS" not in cfg:
        return instantiate(
            cfg.datamodule, data_input_dir=cfg.get("data_input_dir"),
            batch_size=cfg.get("batch_size",
                               cfg.datamodule.get("batch_size", 8)))
    augmentations = cfg["AUGMENTATIONS"]
    if hasattr(augmentations, "to_container"):
        augmentations = augmentations.to_container()
    return instantiate(
        dict(cfg.datamodule.to_container(), _recursive_=False),
        data_input_dir=cfg.get("data_input_dir"),
        augmentations=augmentations,
        batch_size=cfg.get("batch_size", cfg.datamodule.get("batch_size", 6)),
        max_epochs=cfg.get("max_epochs", 1), seed=int(cfg.get("seed", 123)))


def fit(cfg: Config, max_steps_override: Optional[int] = None,
        resume_from: Optional[str] = None, device=None) -> str:
    """Train per the config on ``device`` (default: the CUDA card);
    returns the final checkpoint's path. ``resume_from``: a port
    checkpoint whose parameters, optimizer state, epoch and step are
    restored (a JAX checkpoint's optax state is not: the optimizer
    starts afresh)."""
    device = torch.device(device if device is not None else "cuda")
    initialize_distributed("nccl" if device.type == "cuda" else "gloo")
    n_devices = data_parallel_ranks(cfg, device)
    mesh = _training_mesh(cfg, n_devices)
    device = resolve_device(rank_device(device))
    # one writer of data, logs and checkpoints in a world of several
    # ranks (the JAX package's process 0)
    shared = world_size() > 1
    is_main = global_rank() == 0
    seed = int(cfg.get("seed", 123))
    set_seed(seed)
    if "DATASET_LOCATION" in os.environ:
        cfg["data_input_dir"] = os.environ["DATASET_LOCATION"]
    if "EXPERIMENT_LOCATION" in os.environ:
        cfg["save_dir"] = os.environ["EXPERIMENT_LOCATION"]
    if "LSB_JOBID" in os.environ and not cfg.get("version"):
        cfg["version"] = os.environ["LSB_JOBID"]

    logger = _logger(cfg) if is_main else None
    if shared:   # rank 0's version on every rank
        version = [cfg.get("version") or (logger.version if is_main
                                          else None)]
        dist.broadcast_object_list(version, src=0)
        cfg["version"] = version[0]
        logger = logger or _logger(cfg)
    if not cfg.get("version"):
        cfg["version"] = logger.version

    is_2d = "AUGMENTATIONS" in cfg
    datamodule = build_datamodule(cfg)
    if is_main:
        datamodule.prepare_data()   # one writer of the preprocessed data
    if shared:
        dist.barrier()
    datamodule.setup()

    experiment = Experiment(cfg, device)
    retention = CheckpointRetention(
        os.path.join(logger.log_dir, "checkpoints"),
        save_top_k=int(cfg.get("save_top_k", 0) or 0),
        every_n_epochs=int(cfg.get("checkpoint_every_n_epochs", 0) or 0),
        monitor="val_loss", fmt=str(cfg.get("checkpoint_format", "pickle")))
    if is_2d:
        state = experiment.init_state_2d(
            seed, int(cfg.select("AUGMENTATIONS.height")),
            int(cfg.select("AUGMENTATIONS.width")),
            int(cfg.select("MODEL.INPUT_CHANNELS", 3)))
    else:
        state = experiment.init_state(
            seed, int(cfg.select("datamodule.patch_size", 64)))
    start_epoch = global_step = 0
    if resume_from:
        payload = load_checkpoint(resume_from)
        state = experiment.state_from_variables(payload["state_dict"])
        if payload.get(TORCH_OPTIMIZER_KEY) is not None:
            state.optimizer.load_state_dict(
                to_torch_tree(payload[TORCH_OPTIMIZER_KEY]))
        global_step = state.step = int(payload.get("global_step", 0))
        start_epoch = int(payload.get("epoch", -1)) + 1
        print(f"Resumed from {resume_from} at epoch {start_epoch}, "
              f"step {global_step}")
    # every draw of a step, in the JAX step's key order: the dropout
    # masks, then the SSN's or the aleatoric objective's normals
    generator = torch.Generator(device=device).manual_seed(seed)

    max_epochs = int(cfg.get("max_epochs", 1))
    train_loader = datamodule.train_dataloader()
    val_loader = datamodule.val_dataloader()
    max_steps = max_steps_override or len(train_loader) * max_epochs
    schedule = experiment.lr_schedule
    if schedule.kind == "polynomial" and schedule.total_iters <= 0:
        schedule = schedule._replace(total_iters=max_steps)
    plateau = optim.PlateauTracker(schedule)
    if is_main:
        logger.log_hparams(cfg.to_container())
    step = experiment.train_step
    if mesh is not None:
        step = make_parallel_train_step(experiment, mesh)
        print(f"data-parallel over {mesh.shape} mesh"
              + (f" ({_dcn(cfg)} DCN granules)" if _dcn(cfg) > 1 else ""))

    t_start = time.time()
    for epoch in range(start_epoch, max_epochs):
        # the SSN (3D and 2D) pretrains its mean for the first
        # pretrain_epochs
        pretrain = experiment.is_ssn and epoch < experiment.pretrain_epochs
        epoch_losses = []
        for batch in train_loader:
            if mesh is not None:
                if len(batch["data"]) % n_devices:
                    # a ragged tail batch does not divide: dropped, as
                    # the JAX loop drops it (logged once)
                    if not getattr(fit, "_ragged_warned", False):
                        fit._ragged_warned = True
                        print(f"dropping ragged batch of "
                              f"{len(batch['data'])} (not divisible by "
                              f"{n_devices} devices)")
                    continue
                batch = shard_rows(batch, mesh)
            if schedule.kind == "polynomial":
                optim.set_learning_rate(state.optimizer,
                                        schedule.value(global_step))
            state, loss = step(state, _device_batch(batch, device),
                               generator, pretrain)
            epoch_losses.append(loss)
            global_step += 1
            if max_steps_override and global_step >= max_steps_override:
                break
        if not epoch_losses:
            raise RuntimeError(
                f"epoch {epoch} ran zero steps: every batch was smaller "
                f"than the {n_devices}-device mesh width (train set too "
                "small for the configured batch_size/devices)")
        train_loss = tracing.item(torch.stack(epoch_losses).float().mean())
        if is_main:
            logger.log_scalars(
                {"training/train_loss": train_loss,
                 "lr": optim.get_learning_rate(state.optimizer)},
                global_step)

        val_metrics: Dict[str, list] = {}
        for i, batch in enumerate(val_loader):
            batch = _device_batch(batch, device)
            out = experiment.val_step(state.params, batch, generator)
            for k, v in out.items():
                val_metrics.setdefault(k, []).append(tracing.item(v))
            if i == 0 and is_main:
                _log_val_image(logger, experiment, state.params, batch,
                               global_step)
        val_means = {f"validation/{k}": float(np.mean(v))
                     for k, v in val_metrics.items()}
        if is_main:
            logger.log_scalars(val_means, global_step)
        val_loss = val_means.get("validation/val_loss", train_loss)
        if shared:   # one plateau and retention decision
            shared = [val_loss]
            dist.broadcast_object_list(shared, src=0)
            val_loss = shared[0]
        print(f"epoch {epoch}: train_loss={train_loss:.4f} "
              + " ".join(f"{k.split('/')[-1]}={v:.4f}"
                         for k, v in val_means.items())
              + f" [{time.time() - t_start:.1f}s]")

        if schedule.kind == "plateau":
            optim.set_learning_rate(state.optimizer, plateau.step(val_loss))
        if is_main:
            retention.save(experiment.variables(state), cfg.to_container(),
                           epoch=epoch, global_step=global_step,
                           torch_optimizer_state=state.optimizer.state_dict(),
                           monitored=val_loss)
        if max_steps_override and global_step >= max_steps_override:
            break

    if is_main:
        logger.finalize()
    if shared:   # the checkpoint is written before any rank returns
        dist.barrier()
    return os.path.join(retention.ckpt_dir, "last.ckpt")


def _dcn(cfg: Config) -> int:
    return int(cfg.get("dcn_granules", 0) or 0)


def _training_mesh(cfg: Config, n_devices: int):
    """The data-parallel mesh of ``n_devices`` ranks (over ``dcn_granules``
    nodes, granule-major), or None for one device."""
    if n_devices <= 1:
        return None
    if world_size() != n_devices:
        raise RuntimeError(
            f"data-parallel training over {n_devices} devices runs one "
            f"process a device, but this process's torch.distributed world "
            f"has {world_size()}: launch it through python -m "
            "values_tpu_torch.training.main (which spawns the local ranks) "
            "or torchrun")
    if _dcn(cfg) > 1:
        return make_hybrid_mesh(n_sample=1, dcn_data=_dcn(cfg))
    return make_mesh(n_data=n_devices, n_sample=1)


def _logger(cfg: Config):
    logger_cfg = cfg.get("logger")
    if logger_cfg:
        return instantiate(dict(logger_cfg, version=cfg.get("version")))
    return TensorBoardLogger(cfg.get("save_dir", "."),
                             cfg.get("exp_name", "default"),
                             version=cfg.get("version"))
