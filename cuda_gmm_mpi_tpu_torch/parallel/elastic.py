"""Elastic membership: shrink the world and continue.

The port's own copy of the JAX package's ``parallel/elastic.py``: the same
membership files, rendezvous, world overlay and summary section, so either
package reads the membership the other wrote. The reference is fail-stop:
one dead MPI rank kills or wedges the whole job. When a peer is declared
lost, the surviving ranks rendezvous ON THE CHECKPOINT FILESYSTEM (the only
channel that does not need the dead peer), agree on a shrunken world in a
generation-stamped membership file, and refit over the survivors: bounds
from ``host_chunk_bounds`` over the new world, state from the newest
checkpoint (which holds the whole sweep state, so any world restores it).

Protocol:

1. Generation ``g`` is the current membership: ``membership/gen<g>.json``
   with the surviving ORIGINAL rank ids (sorted) and the original world
   size. Generation 0 is implicit (every rank of the launch world) unless a
   seed file exists.
2. On ``PeerLostError`` each survivor announces itself for generation
   ``g+1`` (``gen<g+1>.rank<r>.alive``, atomic tmp + rename).
3. The coordinator -- the lowest rank the previous membership expects to
   survive -- collects the announcements for a bounded window and publishes
   ``gen<g+1>.json`` atomically with the announced set.
4. The others poll for the published file (bounded); a rank that finds
   itself excluded exits 75 as a peer loss without ``--elastic`` does.

The *world overlay* is the process-local consequence of a sealed
membership: :func:`world` reports (my contiguous rank, world size) over the
survivors. Unlike JAX's multi-controller runtime, a torch.distributed world
can be rebuilt in process: :func:`rebuild_world` tears the process group
down and, with more than one survivor, brings up a new one over them
through a ``file://`` store under the membership directory keyed by the
generation, so the overlay and the live process group agree again.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

from ..testing import faults

MEMBERSHIP_DIRNAME = "membership"

_GEN_FMT = "gen{g}.json"


@dataclasses.dataclass(frozen=True)
class Membership:
    """One sealed generation of the elastic world.

    ``ranks`` are ORIGINAL (launch-world) rank ids, sorted; a rank's
    position in the tuple is its new contiguous rank, so shard bounds and
    coordinator election are deterministic for a given survivor set.
    """

    generation: int
    ranks: Tuple[int, ...]
    world_size0: int  # the launch world's size (generation 0)

    @property
    def world_size(self) -> int:
        return len(self.ranks)

    def index_of(self, orig_rank: int) -> Optional[int]:
        """The survivor's new contiguous rank, or None if excluded."""
        try:
            return self.ranks.index(int(orig_rank))
        except ValueError:
            return None


def membership_dir(checkpoint_dir: str) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir),
                        MEMBERSHIP_DIRNAME)


def _fsync_dir(directory: str) -> None:
    """POSIX-gated directory fsync: durably persist a just-renamed entry.

    Windows cannot ``os.open`` a directory (and rename durability is the
    filesystem's problem there); skip instead of crashing.
    """
    if os.name != "posix":
        return
    try:
        dir_fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def write_membership(directory: str, m: Membership) -> str:
    """Atomically publish one generation file (tmp + replace + dir fsync).

    The single-writer publish of the rendezvous protocol: a reader either
    sees the complete file or no file, never a torn one.
    """
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, _GEN_FMT.format(g=int(m.generation)))
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"generation": int(m.generation),
                   "ranks": [int(r) for r in m.ranks],
                   "world_size0": int(m.world_size0),
                   "sealed_at": time.time()}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(directory)
    return path


def read_membership(directory: str,
                    generation: Optional[int] = None) -> Optional[Membership]:
    """The requested (default: newest) sealed generation, or None."""
    if not os.path.isdir(directory):
        return None
    if generation is None:
        gens = []
        for f in os.listdir(directory):
            if f.startswith("gen") and f.endswith(".json"):
                body = f[3:-5]
                if body.isdigit():
                    gens.append(int(body))
        if not gens:
            return None
        generation = max(gens)
    path = os.path.join(directory, _GEN_FMT.format(g=int(generation)))
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return Membership(generation=int(doc["generation"]),
                      ranks=tuple(sorted(int(r) for r in doc["ranks"])),
                      world_size0=int(doc.get("world_size0",
                                              len(doc["ranks"]))))


def announce_alive(directory: str, generation: int, rank: int) -> str:
    """This rank's survivor announcement for ``generation`` (atomic)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory,
                        f"gen{int(generation)}.rank{int(rank):05d}.alive")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{os.getpid()} {time.time():.3f}\n")
    os.replace(tmp, path)
    return path


def announced_ranks(directory: str, generation: int) -> List[int]:
    """Sorted original ranks that have announced for ``generation``."""
    if not os.path.isdir(directory):
        return []
    prefix = f"gen{int(generation)}.rank"
    out = []
    for f in os.listdir(directory):
        if f.startswith(prefix) and f.endswith(".alive"):
            body = f[len(prefix):-6]
            if body.isdigit():
                out.append(int(body))
    return sorted(out)


def rendezvous(directory: str, *, my_rank: int, prev: Membership,
               lost: Tuple[int, ...], window_s: float = 5.0,
               poll_s: float = 0.05) -> Membership:
    """Seal generation ``prev.generation + 1`` over the survivors.

    Deterministic for a given survivor set: every survivor announces, the
    lowest announced rank publishes the sorted announced set once its
    expected peers are in (or the window closes), everyone else polls for
    the published file. Raises the caller's give-up path
    (:class:`~cuda_gmm_mpi_tpu_torch.supervisor.PeerLostError`) when the file
    never appears -- the coordinator died too; exit 75 as today.
    """
    from .. import supervisor

    gen = int(prev.generation) + 1
    expected = tuple(r for r in prev.ranks
                     if r not in set(int(x) for x in lost))
    if int(my_rank) not in expected:
        raise supervisor.PeerLostError(
            f"rank {my_rank} was declared lost by the generation-{gen} "
            "membership; not rejoining a sealed world", rank=int(my_rank))
    announce_alive(directory, gen, my_rank)

    sealed = read_membership(directory, gen)
    if sealed is not None:
        return _check_included(sealed, my_rank)

    deadline = time.monotonic() + max(float(window_s), 0.0)
    # Coordinator = the lowest rank the PREVIOUS membership expects to
    # survive. If it is actually dead too, its absence surfaces as a
    # publish timeout below and the caller's bounded retry re-runs the
    # whole declare-lost -> rendezvous cycle against the newer loss.
    coordinator = min(expected)
    if int(my_rank) == coordinator:
        while time.monotonic() < deadline:
            have = announced_ranks(directory, gen)
            if set(expected).issubset(have):
                break
            time.sleep(poll_s)
        survivors = tuple(r for r in announced_ranks(directory, gen)
                          if r in expected)
        sealed = Membership(generation=gen, ranks=survivors,
                            world_size0=prev.world_size0)
        write_membership(directory, sealed)
        return _check_included(sealed, my_rank)
    while time.monotonic() < deadline:
        sealed = read_membership(directory, gen)
        if sealed is not None:
            return _check_included(sealed, my_rank)
        time.sleep(poll_s)
    raise supervisor.PeerLostError(
        f"elastic rendezvous for generation {gen} timed out after "
        f"{window_s:.1f}s (coordinator rank {coordinator} did not publish "
        "a membership); giving up", rank=coordinator,
        timeout_s=float(window_s))


def _check_included(sealed: Membership, my_rank: int) -> Membership:
    from .. import supervisor

    if sealed.index_of(my_rank) is None:
        raise supervisor.PeerLostError(
            f"rank {my_rank} is excluded from the sealed generation-"
            f"{sealed.generation} membership {sealed.ranks}; exiting as a "
            "lost peer", rank=int(my_rank))
    return sealed


# -- the process-local world overlay ----------------------------------------

_overlay: Optional[Membership] = None
_overlay_rank: int = 0  # my ORIGINAL rank within the overlay membership
_counters: Dict[str, int] = {"shrinks": 0, "resumes": 0}


def set_world_overlay(m: Membership, my_orig_rank: int) -> None:
    """Adopt a sealed membership as this process's effective world."""
    global _overlay, _overlay_rank
    idx = m.index_of(my_orig_rank)
    if idx is None:
        raise ValueError(
            f"rank {my_orig_rank} is not in membership {m.ranks}")
    _overlay = m
    _overlay_rank = int(my_orig_rank)


def clear_world_overlay() -> None:
    global _overlay
    _overlay = None


def current_membership() -> Optional[Membership]:
    return _overlay


def generation() -> int:
    """The effective membership generation (0 = the launch world)."""
    return 0 if _overlay is None else int(_overlay.generation)


def world() -> Tuple[int, int]:
    """(rank, world_size) of the EFFECTIVE world: the elastic overlay when
    one is adopted, the launch runtime otherwise. Shard-bounds consumers
    (``host_chunk_bounds`` callers) use this instead of the
    process group's rank and size, so a refit after a shrink
    recomputes every survivor's slice over the new world."""
    if _overlay is not None:
        return int(_overlay.index_of(_overlay_rank)), _overlay.world_size
    from . import distributed

    return distributed.rank(), distributed.world_size()


def original_rank() -> int:
    """This process's LAUNCH-world rank (heartbeat files, membership
    announcements, and coordinator election all speak original ranks)."""
    if _overlay is not None:
        return _overlay_rank
    from . import distributed

    return distributed.rank()


def peer_ranks() -> Optional[List[int]]:
    """Original rank ids of my current peers (heartbeat files to watch),
    or None when no overlay is adopted (watch the whole launch world)."""
    if _overlay is None:
        return None
    return [int(r) for r in _overlay.ranks if int(r) != _overlay_rank]


def assert_world_coherent() -> None:
    """Fail loudly -- instead of hanging in the first collective -- when an
    overlay shrank the world but the live process group still spans more
    ranks (a shrink whose :func:`rebuild_world` did not run)."""
    if _overlay is None:
        return
    from . import distributed

    live = distributed.world_size()
    if live > 1 and live != _overlay.world_size:
        raise RuntimeError(
            f"elastic membership generation {_overlay.generation} has "
            f"{_overlay.world_size} rank(s) but the live process group "
            f"spans {live}: collectives would hang on the dead ranks")


def store_path(directory: str, generation: int) -> str:
    """The ``file://`` store of generation ``generation``'s process group."""
    return os.path.join(directory, f"store.gen{int(generation)}")


def rebuild_world(directory: str, sealed: Membership, my_orig_rank: int,
                  device: str = "cuda", timeout_s: float = 1800.0) -> bool:
    """Tear down the current process group and, with more than one
    survivor, bring up a new one over ``sealed``'s ranks: rank = this
    rank's index in the sealed membership, world size = the survivors,
    rendezvous through :func:`store_path` of the generation. Returns True
    when a process group was torn down or built (the caller rebuilds its
    mesh)."""
    from . import distributed

    had = distributed.is_initialized()
    if had:
        distributed.shutdown()
    if sealed.world_size > 1:
        distributed.initialize(
            device, coordinator="file://" + store_path(
                directory, sealed.generation),
            num_processes=sealed.world_size,
            process_id=int(sealed.index_of(my_orig_rank)),
            timeout_s=timeout_s)
        return True
    return had


def note_shrink() -> None:
    _counters["shrinks"] += 1


def note_resume() -> None:
    _counters["resumes"] += 1


def run_summary_section() -> Optional[dict]:
    """The ``run_summary.elastic`` block (None when nothing elastic
    happened -- clean runs carry no elastic section)."""
    if _overlay is None and not _counters["shrinks"]:
        return None
    return {
        "generation": generation(),
        "world_size": world()[1],
        "shrinks": int(_counters["shrinks"]),
        "resumes": int(_counters["resumes"]),
    }


def live_gauges() -> dict:
    """Elastic run gauges for the OpenMetrics exporter (rev v2.1;
    telemetry/exporter.py): keys are final metric names. Cheap enough
    to evaluate per scrape; generation 0 / launch world on clean runs,
    so the gauges exist (and are alertable) before anything shrinks."""
    return {
        "gmm_elastic_generation": generation(),
        "gmm_elastic_shrinks": int(_counters["shrinks"]),
        "gmm_elastic_resumes": int(_counters["resumes"]),
    }


def reset() -> None:
    """Test hook: drop the overlay and counters (module state is
    process-wide)."""
    global _overlay
    _overlay = None
    _counters["shrinks"] = 0
    _counters["resumes"] = 0


def take_collective_timeout(name: str, timeout_s) -> None:
    """Deterministic ``collective_timeout`` chaos hook for barriers: when
    armed (and the optional ``name`` matches), raise the exact
    PeerLostError a timed-out collective would."""
    cfg = faults.take("collective_timeout", name=name)
    if cfg is None:
        return
    from .. import supervisor

    raise supervisor.PeerLostError(
        f"barrier {name!r} timed out (injected collective_timeout): a "
        "peer rank is dead or wedged",
        rank=(int(cfg["rank"]) if "rank" in cfg else None),
        timeout_s=float(cfg.get("timeout_s", timeout_s or 0.0)))
