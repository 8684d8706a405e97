"""The port's scaling layer: a (data, sample) grid of ranks in a
``torch.distributed`` world.

Counterpart of ``values_tpu/parallel/mesh.py``. A JAX mesh is one
process driving many chips; in PyTorch a rank is one process driving one
card, so the port's mesh is a grid of ranks with a process group for
each axis, and ``shard_map``'s ``psum``/``all_gather`` are
:mod:`~values_tpu_torch.parallel.collectives` calls over those groups:

- ``data`` splits the training batch and the scorer's and engine's
  window batches (:func:`make_parallel_train_step`,
  :func:`make_sharded_scorer`, the engine's ``"window"`` strategy);
- ``sample`` splits the stochastic passes: ensemble members, MC-dropout
  passes, TTA variants, aleatoric and SSN draws
  (:func:`make_parallel_pass_predict`, :func:`make_parallel_sample_predict`,
  the engine's ``"sample"`` strategy).

Backends: NCCL for CUDA tensors, gloo for CPU tensors; two ranks that
share one card must name gloo, as NCCL refuses a duplicate GPU. The code
never switches backend after a failure. Every collective is an explicit
call on the process group of an axis; there is no hand-written
collective, as the JAX package has none.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.seed import draw_seed, fold_generator, fold_seed
from .collectives import (DataShard, all_gather_cat, all_reduce_sum,
                          data_shard)

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"


def resolve_device_count(value, available: Optional[int] = None) -> int:
    """A ``devices`` / reference ``gpus`` config value: an int, a numeric
    string (the reference writes ``gpus: '1'``), or "all"/-1 for every
    visible card (``available``, default the CUDA device count)."""
    if value is None:
        return 1
    if str(value).strip().lower() in ("all", "-1"):
        return available if available is not None \
            else torch.cuda.device_count()
    return max(1, int(value))


def requested_ranks(value, device) -> int:
    """The ranks a ``devices``/``--devices`` value asks for on
    ``device``'s type: "all"/-1 is every visible device (the world's
    ranks once a launcher set one, else the CUDA cards, or the CPU's
    cores for CPU ranks), and a count above that is clamped with the JAX
    package's message."""
    device = torch.device(device if device is not None else "cuda")
    if world_size() > 1:
        available = world_size()
    elif device.type == "cuda":
        available = torch.cuda.device_count()
    else:
        available = os.cpu_count() or 1
    n = resolve_device_count(value, available=available)
    if n > max(available, 1):
        print(f"requested {n} devices but only {available} visible on "
              f"{device.type}; clamping")
        n = available
    return max(1, n)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's index among its node's ranks (torchrun's
    ``LOCAL_RANK``; else the global rank)."""
    return int(os.environ.get("LOCAL_RANK", global_rank()))


def rank_device(device) -> torch.device:
    """The device this rank runs on: for a CUDA ``device`` without an
    index, card ``local_rank() % device_count``; any other as given."""
    device = torch.device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if cards and device.index is None:
        return torch.device("cuda", local_rank() % cards)
    return device


def launcher_world() -> Optional[Tuple[str, int, int]]:
    """(host:port, size, rank) of the world a launcher described in the
    environment, or None: the JAX CLI's ``COORDINATOR_ADDRESS``,
    ``NUM_PROCESSES`` and ``PROCESS_ID``, or torchrun's ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``."""
    env = os.environ
    if env.get("COORDINATOR_ADDRESS"):
        return (env["COORDINATOR_ADDRESS"], int(env["NUM_PROCESSES"]),
                int(env["PROCESS_ID"]))
    if env.get("WORLD_SIZE") and env.get("RANK") and env.get("MASTER_ADDR"):
        return (f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}",
                int(env["WORLD_SIZE"]), int(env["RANK"]))
    return None


def initialize_distributed(backend: Optional[str] = None) -> int:
    """Join the ``torch.distributed`` world that a launcher described in
    the environment (:func:`launcher_world`) and return its size. A no-op
    returning 1 without one, and the world's size when it is already
    joined. ``backend``: NCCL where a CUDA card is visible, gloo
    otherwise, unless named."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = launcher_world()
    if world is None:
        return 1
    address, size, rank = world
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank_device("cuda"))
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=size, rank=rank)
    return size


@dataclasses.dataclass
class Mesh:
    """A (data, sample) grid of global ranks and this rank's place in it.
    ``data_group`` spans this rank's column (the ranks that share its
    sample index), ``sample_group`` its row; both None in a world of one
    process."""
    grid: np.ndarray
    rank: int
    data_group: Any = None
    sample_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: int(self.grid.shape[0]),
                SAMPLE_AXIS: int(self.grid.shape[1])}

    @property
    def n_data(self) -> int:
        return int(self.grid.shape[0])

    @property
    def n_sample(self) -> int:
        return int(self.grid.shape[1])

    @property
    def coords(self):
        (i,), (j,) = np.nonzero(self.grid == self.rank)
        return int(i), int(j)

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def sample_index(self) -> int:
        return self.coords[1]

    @property
    def data_ranks(self):
        """This rank's data axis in order."""
        return [int(r) for r in self.grid[:, self.sample_index]]

    @property
    def sample_ranks(self):
        """This rank's sample axis in order."""
        return [int(r) for r in self.grid[self.data_index]]


def _mesh_from_grid(grid: np.ndarray) -> Mesh:
    """This rank's Mesh over ``grid``; every rank of the world calls it
    with the same grid (``new_group`` is collective)."""
    rank = global_rank()
    if not dist.is_initialized():
        return Mesh(grid, rank)
    data = sample = None
    for j in range(grid.shape[1]):
        group = dist.new_group([int(r) for r in grid[:, j]])
        if rank in grid[:, j]:
            data = group
    for i in range(grid.shape[0]):
        group = dist.new_group([int(r) for r in grid[i]])
        if rank in grid[i]:
            sample = group
    return Mesh(grid, rank, data, sample)


def make_mesh(n_data: Optional[int] = None, n_sample: int = 1) -> Mesh:
    """A (data, sample) mesh over the world's ranks in rank order
    (``n_data``: world // n_sample by default)."""
    n_total = world_size()
    if n_data is None:
        n_data = n_total // n_sample
    if n_data * n_sample != n_total:
        raise ValueError(f"mesh {n_data}x{n_sample} != {n_total} devices")
    return _mesh_from_grid(np.arange(n_total).reshape(n_data, n_sample))


def hybrid_grid(n_total: int, n_sample: int, dcn_data: int,
                granules: Optional[Sequence[int]] = None) -> np.ndarray:
    """The (data, sample) grid of ``n_total`` ranks over ``dcn_data``
    granules (nodes), granule-major: all of granule 0's ranks first, so
    the outer blocks of the data axis align with node boundaries and each
    sample row stays on one node. ``granules``: each rank's node; where
    it does not name ``dcn_data`` nodes, contiguous blocks of ranks are
    taken as the granules (the JAX package's rule for devices without a
    granule attribute)."""
    if n_total % (dcn_data * n_sample):
        raise ValueError(f"{n_total} devices not divisible into "
                         f"{dcn_data} DCN granules x {n_sample} sample")
    if granules is None or len(set(granules)) != dcn_data:
        granules = [r * dcn_data // n_total for r in range(n_total)]
    order = sorted(range(n_total), key=lambda r: (granules[r], r))
    return np.asarray(order).reshape(n_total // n_sample, n_sample)


def node_index() -> int:
    """This rank's node: torchrun's ``GROUP_RANK``, else the global rank
    over ``LOCAL_WORLD_SIZE`` ranks a node, else 0."""
    env = os.environ
    if "GROUP_RANK" in env:
        return int(env["GROUP_RANK"])
    if "LOCAL_WORLD_SIZE" in env:
        return global_rank() // int(env["LOCAL_WORLD_SIZE"])
    return 0


def make_hybrid_mesh(n_sample: int = 1,
                     dcn_data: Optional[int] = None) -> Mesh:
    """A (data, sample) mesh over several nodes (JAX's DCN granules),
    laid out by :func:`hybrid_grid`; ``dcn_data`` defaults to the number
    of nodes. A single granule falls back to :func:`make_mesh`."""
    n_total = world_size()
    granules = [node_index()]
    if dist.is_initialized() and n_total > 1:
        granules = [None] * n_total
        dist.all_gather_object(granules, node_index())
    if dcn_data is None:
        dcn_data = len(set(granules))
    if dcn_data <= 1:
        return make_mesh(n_data=n_total // n_sample, n_sample=n_sample)
    return _mesh_from_grid(hybrid_grid(n_total, n_sample, dcn_data,
                                       granules))


def shard_rows(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's contiguous rows of a global batch (every array-valued
    entry, batch axis first); the batch must divide over the data axis.
    Replaces the JAX package's ``batch_sharding``/``shard_batch``."""
    arrays = {k: v for k, v in batch.items()
              if isinstance(v, (np.ndarray, torch.Tensor))}
    b = len(next(iter(arrays.values())))
    if b % mesh.n_data:
        raise ValueError(f"a batch of {b} does not divide over "
                         f"{mesh.n_data} data ranks")
    per = b // mesh.n_data
    lo = mesh.data_index * per
    return {k: v[lo:lo + per] for k, v in arrays.items()}


def average_gradients(leaves: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Replace each leaf's gradient by its mean over the data axis: one
    flat float32 bucket, one all-reduce (also on a data axis of one rank
    in a world; nothing outside one)."""
    if mesh.data_group is None:
        return
    grads = [leaf.grad for leaf in leaves]
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    flat = all_reduce_sum(flat, mesh.data_group) / mesh.n_data
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_parallel_train_step(experiment, mesh: Mesh) -> Callable:
    """The experiment's update over the data axis (``:81-95``):
    ``step(state, rows, generator=None, pretrain=False)`` with ``rows``
    this rank's rows of the global batch (:func:`shard_rows`) and
    ``generator`` seeded alike on every rank. The forward and backward run
    inside a :class:`DataShard` of those rows (the masked cross entropy,
    the 2D BatchNorm and the step's random draws span the global batch),
    every gradient is averaged over the data axis before clipping and the
    optimizer step, and the returned loss is the mean of the ranks'
    losses: the single-device step's on the global batch. Parameters stay
    equal on every rank."""
    def reduce_grads(leaves):
        average_gradients(leaves, mesh)

    def step(state, rows, generator=None, pretrain=False):
        per = len(rows["data"])
        lo = mesh.data_index * per
        shard = DataShard(mesh.data_group, mesh.n_data, lo, lo + per,
                          per * mesh.n_data)
        with data_shard(shard):
            state, loss = experiment.train_step(state, rows, generator,
                                                pretrain,
                                                reduce_grads=reduce_grads)
        return state, all_reduce_sum(loss, mesh.data_group) / mesh.n_data

    return step


# -- inference over the mesh --------------------------------------------------

def make_sharded_scorer(score_fn: Callable, mesh: Mesh) -> Callable:
    """The scores-only pipeline over the data axis (``:182-225``):
    ``score(weights, volumes, gt, seed)`` on the global batch, each rank
    scoring its contiguous rows with ``score_fn`` and the seed
    ``fold_seed(seed, data index)`` (the stochastic families draw
    distinct streams a rank, the same on every run), the (10, b) score
    matrices gathered over the data axis. A batch that does not divide is
    zero-padded up and the pad's scores sliced off."""
    n_data = mesh.n_data

    def score(weights, volumes, gt, seed):
        b = volumes.shape[0]
        pad = (-b) % n_data
        if pad:
            volumes = torch.cat([volumes, volumes.new_zeros(
                (pad,) + tuple(volumes.shape[1:]))])
            gt = torch.cat([gt, gt.new_zeros((pad,) + tuple(gt.shape[1:]))])
        per = (b + pad) // n_data
        lo = mesh.data_index * per
        out = score_fn(weights, volumes[lo:lo + per], gt[lo:lo + per],
                       fold_seed(seed, mesh.data_index))
        return all_gather_cat(out, mesh.data_group, mesh.data_ranks,
                              dim=1)[:, :b]

    return score


def make_parallel_pass_predict(mode: str, n_models: int, mesh: Mesh,
                               n_pred: int = 1,
                               n_aleatoric_samples: int = 10,
                               **model_kwargs) -> Callable:
    """The global stochastic-pass axis over the sample axis (``:98-180``):
    ``predict(weights, x, generator)`` -> (stack, sigma | None), every
    rank computing passes [k n_local, (k + 1) n_local) with the pass-range
    predictor (every draw keyed by its global pass), the stacks gathered
    in global pass order. Outputs equal for any number of sample ranks.
    ``model_kwargs``: ``do_dropout``, ``num_classes``, ``rank``,
    ``epsilon`` of :func:`~values_tpu_torch.inference.predictors.
    make_pass_range_predictor`."""
    from ..inference.predictors import (make_pass_range_predictor,
                                        total_passes)
    n_shards = mesh.n_sample
    s_total = total_passes(mode, n_models, n_pred, n_aleatoric_samples)
    if s_total % n_shards:
        raise ValueError(
            f"mode={mode!r}: {s_total} stochastic passes not divisible "
            f"by {n_shards} sample shards")
    n_local = s_total // n_shards
    local = make_pass_range_predictor(mode, n_models, n_pred,
                                      n_aleatoric_samples, **model_kwargs)
    start = mesh.sample_index * n_local

    def predict(weights, x, generator=None):
        stack, sigma = local(weights, x, generator, start, n_local)
        gather = lambda t: all_gather_cat(t, mesh.sample_group,  # noqa: E731
                                          mesh.sample_ranks)
        return gather(stack), None if sigma is None else gather(sigma)

    return predict


def make_parallel_sample_predict(n_models: int, mesh: Mesh, n_pred: int = 1,
                                 stochastic: bool = False) -> Callable:
    """A deep ensemble's members over the sample axis (``:98-135``): each
    rank runs its slice of members as one group (the default mode, dropout
    live when ``stochastic``, its draws from a generator folded with the
    rank's sample index), and the (M * n_pred, B, ..., C) stacks are
    gathered member-major."""
    from ..inference.predictors import make_predictor
    from ..models.ensemble_unet3d import member_slice
    n_shards = mesh.n_sample
    if n_models % n_shards:
        raise ValueError(f"{n_models} members not divisible by "
                         f"{n_shards} sample shards")
    per = n_models // n_shards
    lo = mesh.sample_index * per
    local = make_predictor("default", per, n_pred, do_dropout=stochastic)

    def predict(weights, x, generator=None):
        part = member_slice(weights, lo, lo + per, n_models)
        gen = generator
        if stochastic:
            gen = fold_generator(draw_seed(generator), mesh.sample_index,
                                 x.device)
        stack, _ = local(part, x, gen)
        return all_gather_cat(stack, mesh.sample_group, mesh.sample_ranks)

    return predict
