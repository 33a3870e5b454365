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


def allreduce_max_int(value: int, group=None) -> int:
    """The largest of every rank's ``value`` (one all_reduce MAX); the value
    itself in one process."""
    if not is_initialized():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


# -- per-rank reading (the JAX package's parallel/distributed.py:261-333) ----

def host_slice(num_events: int, process_id: int, process_count: int):
    """This rank's contiguous event range [start, stop): the reference's
    contiguous per-GPU split (gaussian.cu:347-368), with the remainder
    spread over the first ranks instead of left on one."""
    base, rem = divmod(num_events, process_count)
    start = process_id * base + min(process_id, rem)
    stop = start + base + (1 if process_id < rem else 0)
    return start, stop


def host_chunk_bounds(num_events: int, chunk_size: int, data_axis_size: int,
                      process_id: int, process_count: int):
    """(start, stop, num_chunks) of this rank's slice, with the same chunk
    count on every rank: the global event count is padded to a whole
    number of ``chunk_size`` x ``data_axis_size`` blocks, the chunk grid is
    split evenly over the ranks and each rank pads its own tail. So the
    slice is exactly the rank's block of the grid that ``chunk_events(...,
    num_shards=data_axis_size)`` builds from all of the events.
    ``process_count`` must divide ``data_axis_size``."""
    if data_axis_size % process_count:
        raise ValueError(f"data axis size {data_axis_size} not divisible by "
                         f"{process_count} processes")
    step = chunk_size * data_axis_size
    total = num_events + ((-num_events) % step)
    per_host = total // chunk_size // process_count
    start = min(process_id * per_host * chunk_size, num_events)
    stop = min((process_id + 1) * per_host * chunk_size, num_events)
    return start, stop, per_host


def require_host_local_chunks(chunks_shape, group=None) -> None:
    """Every rank's chunk block must have the same shape, or the first
    collective would deadlock on mismatched buffers: one all_reduce of the
    shape and its negation checks it, and every rank raises alike."""
    if not is_initialized():
        return
    shape = np.asarray(chunks_shape, np.int64)
    both = torch.as_tensor(np.concatenate([shape, -shape]),
                           device=_collective_device())
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    hi, lo = both[:shape.size].tolist(), (-both[shape.size:]).tolist()
    if hi != lo:
        raise ValueError(
            "per-rank chunk blocks differ in shape across ranks "
            f"({lo} .. {hi}); derive the slices with host_chunk_bounds")


def moment_part(block: np.ndarray) -> np.ndarray:
    """One chunk's [1 + 2D] float64 (count, sum, sum of squares) partial."""
    d = block.shape[1]
    part = np.empty((1 + 2 * d,), np.float64)
    part[0] = block.shape[0]
    part[1:1 + d] = block.sum(axis=0, dtype=np.float64)
    part[1 + d:] = (block.astype(np.float64) ** 2).sum(axis=0)
    return part


def global_moments(local_data: np.ndarray, chunk_size: int, num_chunks: int,
                   *, index: int = 0, count: int = 1, group=None):
    """The global per-dimension float64 (mean, E[x^2] - E[x]^2) from each
    rank's slice, the same bits for every rank count: each rank builds the
    per-chunk partials of its ``num_chunks`` chunk slots (missing tail
    chunks are zeros) and :func:`reduce_moment_parts` sums the partials of
    every slice in global chunk order. ``index`` of ``count`` slices, over
    ``group`` (the mesh's data axis; None in one process)."""
    return reduce_moment_parts(moment_parts(local_data, chunk_size,
                                            num_chunks),
                               index=index, count=count, group=group)


def moment_parts(local_data: np.ndarray, chunk_size: int,
                 num_chunks: int) -> np.ndarray:
    """[num_chunks, 1 + 2D] per-chunk partials of one slice (zero rows for
    the chunk slots past its events)."""
    d = local_data.shape[1]
    parts = np.zeros((num_chunks, 1 + 2 * d), np.float64)
    for j in range(num_chunks):
        block = local_data[j * chunk_size:(j + 1) * chunk_size]
        if block.shape[0]:
            parts[j] = moment_part(block)
    return parts


def reduce_moment_parts(parts: np.ndarray, *, index: int = 0, count: int = 1,
                        group=None):
    """(mean [D], var [D]) float64 from this slice's [num_chunks, 1 + 2D]
    partials: one all_reduce SUM of a zero [count, num_chunks, 1 + 2D]
    buffer in which each slice fills its own row (exact: x + 0 = x) gathers
    every slice's partials, and each rank sums the rows in global chunk
    order, as one process sums its own."""
    d = (parts.shape[1] - 1) // 2
    if count > 1:
        buf = torch.zeros((count,) + parts.shape, dtype=torch.float64,
                          device=_collective_device())
        buf[index] = torch.as_tensor(parts, device=buf.device)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        parts = buf.cpu().numpy().reshape(-1, 1 + 2 * d)
    total = parts.sum(axis=0)
    n = total[0]
    if n <= 0:
        raise ValueError("no events across all ranks")
    mean = total[1:1 + d] / n
    return mean, total[1 + d:] / n - mean * mean


# -- the named barrier with a timeout (distributed.py:169-235) ---------------

def barrier(name: str = "gmm_barrier",
            timeout_s: Optional[float] = None) -> None:
    """Cross-rank sync point (MPI_Barrier); a no-op in one process.

    With ``timeout_s`` -- given, or that of an active run supervisor whose
    liveness watchdog runs -- a dead or wedged peer raises
    :class:`~cuda_gmm_mpi_tpu_torch.supervisor.PeerLostError` after the
    timeout instead of blocking this rank for good. The waiting collective
    cannot be cancelled: the raise leaves its daemon thread behind, and the
    caller's next act is an emergency checkpoint and a loud exit. An armed
    ``collective_timeout`` fault raises the same error first, in one
    process too."""
    from . import elastic

    elastic.take_collective_timeout(name, timeout_s)
    if not is_initialized():
        return
    if timeout_s is None:
        from .. import supervisor

        timeout_s = supervisor.current().collective_timeout_s
    if not timeout_s:
        dist.barrier()
        return
    import threading

    done = threading.Event()
    err: list = []

    def _run():
        try:
            dist.barrier()
        except Exception as e:  # surfaced on the caller's thread
            err.append(e)
        finally:
            done.set()

    threading.Thread(target=_run, name=f"gmm-barrier-{name}",
                     daemon=True).start()
    if not done.wait(float(timeout_s)):
        from .. import supervisor

        raise supervisor.PeerLostError(
            f"barrier {name!r} timed out after {timeout_s:.1f}s: a peer "
            "rank is dead or wedged", timeout_s=float(timeout_s))
    if err:
        raise err[0]


# -- rank heartbeats (the liveness watchdog's medium, :237-258) --------------
#
# Files on the checkpoint filesystem, not a collective: a hung peer is the
# case where collectives stop returning, and a collective from a background
# thread would interleave with the fit's own. The layout is the JAX
# package's, so either package's watchdog reads the other's heartbeats.

def heartbeat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"rank{int(rank):05d}.hb")


def write_rank_heartbeat(directory: str, rank: int) -> None:
    """Atomically touch this rank's heartbeat file (tmp + rename: a reader
    never sees a partial write, and the mtime moves forward)."""
    import time

    os.makedirs(directory, exist_ok=True)
    path = heartbeat_path(directory, rank)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{os.getpid()} {time.time():.3f}\n")
    os.replace(tmp, path)


def read_rank_heartbeat(directory: str, rank: int) -> Optional[float]:
    """The peer's last heartbeat mtime, or None if it never wrote one."""
    try:
        return os.stat(heartbeat_path(directory, rank)).st_mtime
    except OSError:
        return None


# -- per-rank .results parts and their assembly (:334-490) ------------------

def results_part_path(out_path: str, part_dir: Optional[str] = None) -> str:
    """This rank's ``.results`` part: beside ``out_path`` (so rank 0 can
    concatenate the parts on a shared filesystem), or in ``part_dir``
    (rank-local scratch on hosts without one)."""
    d = part_dir or os.path.dirname(os.path.abspath(out_path))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, os.path.basename(out_path) + f".part{rank():05d}")


def _part_fingerprint(path: str, sample: int = 1 << 20) -> int:
    """crc32 of the part's first and last ``sample`` bytes: with the size,
    the staleness guard of the shared-filesystem path (a leftover part of
    an earlier run passes only if it holds the same bytes)."""
    import zlib

    size = os.path.getsize(path)
    with open(path, "rb") as f:
        crc = zlib.crc32(f.read(sample))
        if size > sample:
            f.seek(max(size - sample, sample))
            crc = zlib.crc32(f.read(sample), crc)
    return crc


def _allgather_bytes(buf: np.ndarray) -> np.ndarray:
    """[world, len(buf)] uint8 rows, one all_gather of byte tensors."""
    t = torch.as_tensor(buf, device=_collective_device())
    out = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def assemble_results_multihost(out_path: str, part_path: str,
                               chunk_bytes: int = 32 * 1024 * 1024) -> None:
    """Every rank's part, in rank order, into ``out_path`` on rank 0, with
    or without a shared filesystem (the reference's MPI_Send/Recv gather
    of the memberships, gaussian.cu:798-817; here the formatted bytes
    move). The ranks hold the events in rank order, so concatenating the
    parts gives the single-process file byte for byte.

    All ranks exchange their part's (size, crc32). If rank 0 sees every
    part at that size and checksum, it concatenates them from the
    filesystem; otherwise the parts come to rank 0 over the process group
    in rounds of ``chunk_bytes`` (one all_gather each), spooled on its
    local disk. Every rank must call this; each part is deleted after."""
    import shutil
    import tempfile

    me, world = rank(), world_size()
    barrier("results_parts")
    meta = np.asarray([os.path.getsize(part_path),
                       _part_fingerprint(part_path)], np.int64)
    metas = allgather_host(meta).reshape(world, 2)
    sizes = metas[:, 0]
    local_dir = os.path.dirname(os.path.abspath(part_path))

    def path_of(i: int) -> str:  # rank 0's view of rank i's part
        return os.path.join(local_dir,
                            os.path.basename(out_path) + f".part{i:05d}")

    visible = 0
    if me == 0:
        visible = int(all(
            os.path.isfile(path_of(i))
            and os.path.getsize(path_of(i)) == int(sizes[i])
            and _part_fingerprint(path_of(i)) == int(metas[i, 1])
            for i in range(world)))
    if allgather_host(np.asarray([visible], np.int64)).reshape(-1)[0]:
        if me == 0:
            with open(out_path, "wb") as out:
                for i in range(world):
                    with open(path_of(i), "rb") as f:
                        shutil.copyfileobj(f, out, chunk_bytes)
            for i in range(world):
                os.remove(path_of(i))
        barrier("results_done")
        if me != 0 and os.path.isfile(part_path):
            os.remove(part_path)
        return
    rounds = int(max(-(-int(s) // chunk_bytes) for s in sizes))
    spool_dir = tempfile.mkdtemp(prefix="gmm_results_gather_") if me == 0 \
        else None
    try:
        spools = ([open(os.path.join(spool_dir, f"rank{i}"), "wb")
                   for i in range(world)] if me == 0 else [])
        with open(part_path, "rb") as f:
            for r in range(rounds):
                data = f.read(chunk_bytes)
                buf = np.zeros((chunk_bytes,), np.uint8)
                buf[:len(data)] = np.frombuffer(data, np.uint8)
                rows = _allgather_bytes(buf)
                for i, fh in enumerate(spools):
                    n = max(0, min(int(sizes[i]) - r * chunk_bytes,
                                   chunk_bytes))
                    fh.write(rows[i, :n].tobytes())
        for fh in spools:
            fh.close()
        if me == 0:
            with open(out_path, "wb") as out:
                for i in range(world):
                    with open(os.path.join(spool_dir, f"rank{i}"), "rb") as f:
                        shutil.copyfileobj(f, out, chunk_bytes)
    finally:
        if spool_dir is not None:
            shutil.rmtree(spool_dir, ignore_errors=True)
    barrier("results_done")
    os.remove(part_path)
