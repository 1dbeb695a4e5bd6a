"""Data parallelism over ranks (the counterpart of ``gastx.parallel.mesh``).

The JAX package runs one SPMD program over a ``jax.sharding.Mesh``: the
batch is sharded on axis 0, the parameters are replicated, and XLA emits
the gradient and batch-statistic ``psum``s. PyTorch's form of the same
strategy is one process per rank (``python -m torch.distributed.run``), a
process group, ``DistributedDataParallel`` for the gradients, and the
global-batch BN of ``gastx_torch.ops.batchnorm``; the collectives are
NCCL's or gloo's. This module is the whole distributed layer:

  * :func:`init_distributed` joins the process group and picks its
    backend: NCCL where each rank on the host has a card of its own, gloo
    where ranks share a card or run on the CPU (NCCL refuses two ranks on
    one card). The choice is printed; nothing falls back after a failure.
  * :func:`make_mesh` gives the :class:`Mesh` of this rank: the group,
    its size, this rank and the device it runs on.
  * :func:`batch_sharding` and :func:`shard_batch` cut a batch that every
    rank assembled alike into this rank's contiguous rows.
  * :func:`replicate` wraps a model in DDP.
  * :func:`all_reduce_sum` is the differentiable sum over ranks that the
    global-batch BN takes its statistics with.
  * :func:`spawn` runs a function on ``n`` ranks of one host.

``replicated_sharding`` has no counterpart: in one process a rank, every
rank holds its own full copy of the parameters and the optimizer state,
so replication is the default rather than a placement.
"""
from __future__ import annotations

import os
import pickle
import queue
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from gastx_torch.data.prefetch import stage
from gastx_torch.device import resolve_device

DATA_AXIS = "data"  # the JAX mesh's axis name; this mesh has one axis

Device = Union[str, torch.device]


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D data-parallel mesh. ``group`` is None
    for a one-rank mesh built without a process group."""

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int
    device: torch.device


def local_rank() -> int:
    """This rank's index on its host (``LOCAL_RANK`` of
    ``torch.distributed.run``; the global rank where it is not set)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()
                              if dist.is_initialized() else 0))


def choose_backend(ranks_on_host: int, device: Optional[Device] = None
                   ) -> str:
    """``"nccl"`` where each of the host's ``ranks_on_host`` ranks has a
    card of its own, ``"gloo"`` where they share one or run on the CPU."""
    if resolve_device(device).type != "cuda":
        return "gloo"
    return "nccl" if ranks_on_host <= torch.cuda.device_count() else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device: Optional[Device] = None) -> str:
    """Join the process group before :func:`make_mesh`; returns the
    backend.

    With no address the group is read from the environment that
    ``torch.distributed.run`` sets (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``). Elsewhere give the
    coordinator's ``host:port`` (``tcp://``), the number of processes and
    this one's id. ``device``: where the ranks run (``cuda`` unless
    given); it decides the backend (:func:`choose_backend`).
    """
    if coordinator_address is None:
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    else:
        if None in (num_processes, process_id):
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = num_processes, process_id
    on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(on_host, device)
    if rank == 0:
        print(f"INFO: process group of {world} rank(s), {on_host} on this "
              f"host, on {backend}", flush=True)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return backend


def make_mesh(devices: Optional[Sequence[Device]] = None) -> Mesh:
    """The data-parallel mesh over every rank of the process group, or a
    one-rank mesh where there is no group.

    ``devices``: one device per rank in rank order, as the JAX mesh takes
    its device list; this rank runs on ``devices[rank]``. None: each rank
    on its own card, ``cuda:{LOCAL_RANK % device_count}`` (ranks beyond
    the host's cards share them).
    """
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        group = dist.group.WORLD
    else:
        size, rank, group = 1, 0, None
    if devices is None:
        resolve_device(None)  # raises where there is no card
        device = torch.device("cuda",
                              local_rank() % torch.cuda.device_count())
    else:
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for a mesh of {size} "
                             f"rank(s)")
        device = resolve_device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(group, size, rank, device)


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's contiguous rows of a batch of ``batch`` rows (a
    multiple of the mesh size)."""
    if batch % mesh.size:
        raise ValueError(f"a batch of {batch} rows does not split over "
                         f"{mesh.size} ranks")
    rows = batch // mesh.size
    return slice(mesh.rank * rows, (mesh.rank + 1) * rows)


def shard_batch(mesh: Mesh, *arrays) -> Tuple[List[Optional[torch.Tensor]],
                                              int]:
    """This rank's rows of host arrays that every rank holds alike, as
    tensors on the mesh's device.

    Pads the batch to a multiple of the mesh size by repeating the last
    row (callers weight their loss by the true count or pass full
    batches), as the JAX ``shard_batch`` does. Returns (this rank's
    arrays, the true batch size); None stays None.
    """
    out: List[Optional[torch.Tensor]] = []
    true_b = None
    for arr in arrays:
        if arr is None:
            out.append(None)
            continue
        arr = np.asarray(arr)
        if true_b is None:
            true_b = arr.shape[0]
        rem = (-arr.shape[0]) % mesh.size
        if rem:
            arr = np.concatenate([arr, np.repeat(arr[-1:], rem, axis=0)])
        out.append(stage(arr[batch_sharding(mesh, arr.shape[0])],
                         mesh.device))
    return out, true_b


def replicate(mesh: Mesh, model: nn.Module) -> nn.Module:
    """The model on the mesh's device with rank 0's parameters and
    buffers, wrapped in DDP under a process group; the model itself on a
    one-rank mesh without a group.

    DDP broadcasts rank 0's parameters as it wraps; the buffers (the BN
    running statistics) are broadcast here first, since DDP is built with
    ``broadcast_buffers=False``: the global-batch BN gives every rank the
    same running statistics, so none is sent again at each forward. Every
    parameter takes part in every train forward (each BN's bias too,
    init_bn's whose gradient is zero up to rounding), so unused-parameter
    detection stays off.
    """
    model = model.to(mesh.device)
    if mesh.group is None:
        return model
    with torch.no_grad():
        for b in model.buffers():
            dist.broadcast(b, src=0, group=mesh.group)
    ids = [mesh.device.index] if mesh.device.type == "cuda" else None
    return nn.parallel.DistributedDataParallel(
        model, device_ids=ids, process_group=mesh.group,
        broadcast_buffers=False)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum
    over the ranks of the output's gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable sum of ``x`` over the mesh's ranks (the JAX
    ``psum``)."""
    return _AllReduceSum.apply(x, mesh.group)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n, address, args, results):
    try:
        # By value: a tensor sent through the queue as itself would live
        # in this process's shared memory, gone once the rank exits.
        results.put((rank, True, pickle.dumps(fn(rank, n, address, *args))))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n: int, *args, timeout: float = 600.0) -> list:
    """Run ``fn(rank, n, address, *args)`` on ``n`` processes started by
    the spawn method (a process that has initialised CUDA cannot fork),
    ``address`` a free ``localhost:port`` for :func:`init_distributed`.
    Returns the ranks' results in rank order; raises if a rank fails,
    exits non-zero or is still running after ``timeout`` seconds (then
    every rank is killed)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = f"localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, address, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    out, failed = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(out) < n and not failed:  # drain before joining
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                # A rank that died before it could report (in its start-up,
                # or killed) sends nothing.
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    failed.append(f"ranks {dead} exited without a result")
                elif time.monotonic() > deadline:
                    failed.append(f"no result within {timeout} s from ranks "
                                  f"{sorted(set(range(n)) - set(out))}")
                continue
            if ok:
                out[rank] = pickle.loads(value)
            else:
                failed.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=30 if not failed else 5)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if failed or any(codes):
        raise RuntimeError(f"spawned ranks failed (exit codes {codes}): "
                           + "\n".join(failed))
    return [out[r] for r in range(n)]
