"""torch.distributed bring-up for the mesh path: one process per rank.

The MPI_Init / rank / size equivalent of the reference (``gaussian.cu:
133-139``). Three ways into a world, in this order:

- ``coordinator`` (``HOST:PORT``, or a ``tcp://`` / ``file://`` URL) with
  ``num_processes`` and ``process_id``: an explicit world, the JAX CLI's
  ``--coordinator/--num-processes/--process-id``;
- ``RANK`` and ``WORLD_SIZE`` in the environment (``torchrun``), or
  ``num_processes=0``: ``env://``;
- none of these: a single process, no process group.

The collective backend is chosen explicitly: ``nccl`` when the device is
CUDA and every rank has a GPU of its own (the ranks on this host, torchrun's
``LOCAL_WORLD_SIZE`` or else the world size, <= the visible GPUs),
otherwise ``gloo``. gloo reduces CUDA tensors by staging them through the
host, so several ranks can share one GPU (NCCL refuses that); the kernels
still run on the card. Each CUDA rank's current device is set to its own
GPU (``LOCAL_RANK``, else the rank, modulo the GPU count), so ``'cuda'``
names it.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def backend() -> Optional[str]:
    """The collective backend of the world ('nccl' or 'gloo'), or None."""
    return dist.get_backend() if is_initialized() else None


def choose_backend(device: str, world: int) -> str:
    """NCCL when every rank on this host has a GPU of its own. The ranks per
    host are torchrun's ``LOCAL_WORLD_SIZE`` when it is set (a multi-node
    world), else the whole world (one host)."""
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if (device == "cuda" and torch.cuda.is_available()
            and per_host <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def initialize(device: str = "cuda", coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: float = 1800.0) -> Tuple[int, int]:
    """Join (or skip) the world; returns (rank, world size). A partial set
    of the explicit arguments raises instead of running single-process."""
    if is_initialized():
        return rank(), world_size()
    explicit = (coordinator, num_processes, process_id)
    if num_processes == 0 or (all(a is None for a in explicit)
                              and "RANK" in os.environ
                              and "WORLD_SIZE" in os.environ):
        method = "env://"
        world, me = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    elif all(a is None for a in explicit):
        return 0, 1
    elif any(a is None for a in explicit):
        raise ValueError(
            "distributed bring-up needs ALL of coordinator, num_processes "
            "and process_id (or RANK/WORLD_SIZE in the environment)")
    else:
        method = (coordinator if "://" in coordinator
                  else f"tcp://{coordinator}")
        world, me = int(num_processes), int(process_id)
    if device == "cuda" and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", me))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend=choose_backend(device, world), init_method=method,
        world_size=world, rank=me,
        timeout=datetime.timedelta(seconds=timeout_s))
    return rank(), world_size()


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Cross-rank sync point (MPI_Barrier); a no-op in one process."""
    if is_initialized():
        dist.barrier()


def _collective_device() -> torch.device:
    return (torch.device("cuda", torch.cuda.current_device())
            if backend() == "nccl" else torch.device("cpu"))


def allgather_host(values) -> np.ndarray:
    """A small host array from every rank: [world, *values.shape], in rank
    order. One all_reduce SUM of a zero buffer in which each rank fills its
    own row, which is exact and works on every backend. Single process:
    ``values[None]``."""
    values = np.asarray(values)
    if not is_initialized():
        return values[None]
    wide = torch.int64 if values.dtype.kind in "biu" else torch.float64
    buf = torch.zeros((world_size(),) + values.shape, dtype=wide,
                      device=_collective_device())
    buf[rank()] = torch.as_tensor(values, device=buf.device).to(wide)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.cpu().numpy().astype(values.dtype)


def allgather_json(obj) -> list:
    """One small JSON-serializable object from every rank: ``[rank0_obj,
    rank1_obj, ...]``, the same on every rank (the JAX package's
    ``allgather_json``). Two collectives through :func:`allgather_host`:
    the payloads' lengths, then the payloads as byte rows padded to the
    longest. Every rank must call it. Single process: ``[obj]``. For
    summaries, not data."""
    import json

    if not is_initialized():
        return [obj]
    payload = np.frombuffer(json.dumps(obj).encode("utf-8"), np.uint8)
    sizes = allgather_host(np.asarray([payload.size], np.int64)).reshape(-1)
    buf = np.zeros((max(int(sizes.max()), 1),), np.uint8)
    buf[:payload.size] = payload
    rows = allgather_host(buf)
    return [json.loads(rows[i, :int(n)].tobytes().decode("utf-8"))
            for i, n in enumerate(sizes)]
