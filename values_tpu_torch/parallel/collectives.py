"""The collectives of the port's parallel layer, and the data shard a
training step runs on.

Where the JAX package's ``shard_map`` programs call ``psum`` and
``all_gather`` over a mesh axis (``values_tpu/parallel/mesh.py``), the
port calls :func:`all_reduce_sum` and :func:`all_gather_cat` over the
axis's process group. NCCL takes CUDA tensors as they are; any other
backend (gloo: the CPU tests, and two ranks that share one card) gets
them through the host and back. Only outside a world (no group) is a
collective skipped: a group of one rank still makes its call, so a
one-rank NCCL world runs the same communicator calls as a larger one.

:class:`DataShard` says which rows of a global batch this rank holds and
over which group the data axis runs. A data-parallel training step
(``make_parallel_train_step``) activates one around its forward and
backward; the few places whose arithmetic spans the batch read it, so
that the step computes what the JAX package's SPMD step computes on the
global batch:

- the masked cross entropy divides by the mask count of the global batch
  (:mod:`values_tpu_torch.ops.losses`);
- the 2D BatchNorm takes its statistics over the global batch
  (:class:`values_tpu_torch.models.hrnet.BatchNorm2d`), through
  :func:`global_sum`, whose backward sums the gradient over the group;
- random draws over the batch (dropout masks, aleatoric and SSN normals)
  are drawn at the global batch's shape from the step's generator, which
  every rank seeds alike, and :func:`draw_rows` keeps this rank's rows.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataShard:
    """Rows [lo, hi) of a global batch of ``total`` rows, on a data axis
    of ``size`` ranks that ``group`` spans."""
    group: Any
    size: int
    lo: int
    hi: int
    total: int


_SHARD: contextvars.ContextVar = contextvars.ContextVar("data_shard",
                                                        default=None)


def current_shard() -> Optional[DataShard]:
    """The data shard of the running training step, or None."""
    return _SHARD.get()


@contextlib.contextmanager
def data_shard(shard: DataShard):
    """Run the block as the step of ``shard``'s rows."""
    token = _SHARD.set(shard)
    try:
        yield shard
    finally:
        _SHARD.reset(token)


def _via_host(t: torch.Tensor, group) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) != "nccl"


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``'s ranks (``t`` itself without a
    group); not differentiable."""
    if group is None:
        return t
    if _via_host(t, group):
        host = t.detach().cpu()
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather_cat(t: torch.Tensor, group, order: Sequence[int],
                   dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all) concatenated along ``dim``
    in the global-rank ``order`` given (the mesh axis's order); ``t``
    itself without a group."""
    if group is None:
        return t
    src = t.detach().cpu() if _via_host(t, group) else t.detach()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src.contiguous(), group=group)
    by_rank = dict(zip(dist.get_process_group_ranks(group), parts))
    return torch.cat([by_rank[r] for r in order], dim=dim).to(t.device)


class _GlobalSum(torch.autograd.Function):
    """All-reduce sum whose backward all-reduces the gradient: each rank's
    input feeds every rank's output (the autograd form of
    ``torch.distributed.nn.functional.all_reduce``, also on backends that
    go through the host)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the running step's data axis (``t`` itself
    outside a data-parallel step), differentiably."""
    shard = current_shard()
    if shard is None or shard.size == 1:
        return t
    return _GlobalSum.apply(t, shard.group)


def draw_rows(draw: Callable[[tuple], Any], shape: Sequence[int],
              dim: int = 0):
    """``draw(shape)`` (a tensor or a list of tensors) with ``shape``'s
    batch axis ``dim`` set to the global batch inside a data-parallel
    step, cut back to this rank's rows; ``draw(shape)`` elsewhere."""
    shard = current_shard()
    if shard is None or shard.size == 1:
        return draw(tuple(shape))
    shape = tuple(shape)
    out = draw(shape[:dim] + (shard.total,) + shape[dim + 1:])

    def rows(t):
        return t.narrow(dim, shard.lo, shard.hi - shard.lo)
    return [rows(t) for t in out] if isinstance(out, list) else rows(out)
