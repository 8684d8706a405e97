"""Local ranks for a command that asks for several devices: the port's
form of the JAX CLI's one process over all of a host's chips.

When ``devices``/``gpus`` (training) or ``--devices`` (scoring) asks for
N > 1 and no launcher has described a world (torchrun's ``RANK``/
``WORLD_SIZE``/``MASTER_ADDR``, or the JAX CLI's
``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``), the entry
point spawns N processes on this host with a fresh localhost rendezvous;
each joins the world through
:func:`~values_tpu_torch.parallel.mesh.initialize_distributed` and runs
the command as rank ``i``. The user's command is then the JAX one.
"""
from __future__ import annotations

import os
import socket
from typing import Any, Callable, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import launcher_world


def launched() -> bool:
    """Whether this process already belongs to a described world."""
    return dist.is_initialized() or launcher_world() is not None


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(index: int, fn: Callable, args: Sequence, nprocs: int,
               port: int, results) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(nprocs), RANK=str(index),
                      LOCAL_RANK=str(index), LOCAL_WORLD_SIZE=str(nprocs))
    try:
        out = fn(*args)
        if index == 0:
            results.put(out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, args: Sequence, nprocs: int) -> Any:
    """Run ``fn(*args)`` in ``nprocs`` spawned ranks of one world on this
    host; returns rank 0's result. A rank that raises ends the others and
    raises here (``torch.multiprocessing``'s process context)."""
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    context = mp.start_processes(
        _rank_main, args=(fn, tuple(args), nprocs, free_port(), results),
        nprocs=nprocs, join=False, start_method="spawn")
    while not context.join():
        pass
    return results.get()
