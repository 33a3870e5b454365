"""Ragged-tenant packing: T independent datasets -> pow2-bucketed groups.

The port of the JAX package's ``tenancy/packing.py``. The fleet workload is
many SMALL independent mixtures -- the reference's own flow-cytometry
domain fits one model per patient sample. Packing them into shape-bucketed
groups lets ``fit_fleet`` run each group's sweep step as one fleet EM
call (``GMMModel.run_em_fleet``).

The packing policy is the pow2 bucketing applied per tenant:

- the EVENT axis pads to the smallest power-of-two bucket >= N_t,
  expressed as a forced chunk count (``chunk_events(num_chunks=...)``)
  whose pad rows carry ZERO weight -- exactly the tail padding every solo
  fit already does, so the pad is algebraically inert;
- the CLUSTER axis pads to the pow2 bucket >= K_t with inert inactive
  slots (``seed_state_from_parts``'s ``num_clusters_padded``), rounded up
  to the cluster-mesh axis on sharded models so lanes stay evenly
  partitionable.

Tenants sharing a (chunk-count, K-bucket) signature group together. Per
tenant, seeding, the centering shift, the moments and the convergence
epsilon reuse the solo fit's own host recipe (``order_search._seed_rows``,
``distributed.global_moments`` at the solo chunk count,
``convergence_epsilon`` from the true N), which is what makes a fleet
tenant's results bit-identical to its solo fit by construction. Pure
numpy, but for the seeded states, which are built on ``device`` as the
solo fit builds them on its model's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import GMMConfig
from ..validation import validate_finite


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's fit request: its own events, K, target, and seed."""

    name: str
    data: np.ndarray              # [N_t, D] events (in-memory)
    num_clusters: int             # starting K_t
    target_num_clusters: int = 0  # 0 = search down to 1, keep best score
    seed: Optional[int] = None    # None -> config.seed

    def __post_init__(self):
        data = np.asarray(self.data)
        if data.ndim != 2 or data.shape[0] < 1:
            raise ValueError(
                f"tenant {self.name!r}: data must be a non-empty "
                f"[N, D] array, got shape {data.shape}")
        if self.num_clusters < 1:
            raise ValueError(
                f"tenant {self.name!r}: num_clusters must be >= 1")
        if self.target_num_clusters > self.num_clusters:
            raise ValueError(
                f"tenant {self.name!r}: target_num_clusters "
                f"({self.target_num_clusters}) must be <= num_clusters "
                f"({self.num_clusters})")


@dataclasses.dataclass
class FleetGroup:
    """One packed-shape bucket: the tenants one fleet EM call serves."""

    indices: List[int]   # positions into the fleet's tenant list
    num_chunks: int      # forced chunk count (pow2 event bucket / chunk)
    k_bucket: int        # shared padded cluster width
    n_bucket: int        # pow2 event bucket (num_chunks * chunk_size)


@dataclasses.dataclass
class PackedGroup:
    """Host-side arrays of one group, ready for device placement."""

    group: FleetGroup
    chunks: np.ndarray        # [T, C, B, D] per-tenant packed chunk grids
    wts: np.ndarray           # [T, C, B] weight rows (0 beyond N_t)
    states: list              # per-lane GMMState, padded to k_bucket
    epsilons: np.ndarray      # [T] per-tenant convergence epsilon
    shifts: np.ndarray        # [T, D] per-tenant centering shift
    n_events: np.ndarray      # [T] true event counts
    k0: np.ndarray            # [T] starting cluster counts
    targets: np.ndarray       # [T] target cluster counts (0 = search)
    names: List[str]
    solo_chunks: np.ndarray   # [T] each tenant's solo-fit chunk count
    data_axis: int            # data-mesh extent the layout was packed for


def pow2_bucket(n: int, lo: int = 1) -> int:
    """Smallest power of two >= ``n`` (>= ``lo``) -- the event-axis
    bucketing policy shared with the serving executor."""
    b = 1 << max(0, int(n) - 1).bit_length()
    return max(b, int(lo))


def plan_fleet(tenants: List[TenantSpec], config: GMMConfig,
               data_axis: int = 1, cluster_axis: int = 1,
               ) -> List[FleetGroup]:
    """Group tenants by packed shape: (forced chunk count, K bucket).

    ``data_axis``/``cluster_axis`` are the target model's mesh extents:
    the chunk count rounds up to a data-axis multiple (every shard gets an
    equal chunk slice) and the K bucket to a cluster-axis multiple (the
    ``pad_state_clusters`` contract). ``config.fleet_group_size`` splits
    oversized groups so one group's [T, C, B, D] device residency stays
    bounded.
    """
    if not tenants:
        raise ValueError("fit_fleet needs at least one tenant")
    dims = {int(np.asarray(t.data).shape[1]) for t in tenants}
    if len(dims) > 1:
        raise ValueError(
            f"all tenants must share one dimensionality; got D in "
            f"{sorted(dims)} (run mixed-D fleets as separate calls)")
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate tenant names: {dupes}")
    for t in tenants:
        if t.num_clusters > config.max_clusters:
            raise ValueError(
                f"tenant {t.name!r}: num_clusters ({t.num_clusters}) "
                f"exceeds max_clusters ({config.max_clusters})")

    chunk = int(config.chunk_size)
    by_shape: Dict[Tuple[int, int], List[int]] = {}
    for i, t in enumerate(tenants):
        n = int(np.asarray(t.data).shape[0])
        num_chunks = -(-pow2_bucket(n) // chunk)          # ceil
        num_chunks += (-num_chunks) % max(data_axis, 1)
        kb = pow2_bucket(t.num_clusters)
        if cluster_axis > 1:
            kb += (-kb) % cluster_axis
        by_shape.setdefault((num_chunks, kb), []).append(i)
    groups: List[FleetGroup] = []
    cap = config.fleet_group_size
    for (num_chunks, kb), idxs in sorted(by_shape.items()):
        step = len(idxs) if cap is None else max(1, int(cap))
        for lo in range(0, len(idxs), step):
            groups.append(FleetGroup(
                indices=idxs[lo:lo + step], num_chunks=num_chunks,
                k_bucket=kb, n_bucket=num_chunks * chunk))
    return groups


def pack_group(group: FleetGroup, tenants: List[TenantSpec],
               config: GMMConfig, data_axis: int = 1,
               device="cpu") -> PackedGroup:
    """Pack one group's tenants into stacked [T, ...] host arrays.

    Per tenant, this is exactly the solo fit's ``_prepare_data`` /
    ``_prepare_fit`` recipe -- float64 chunk-ordered moments at the SOLO
    chunk count (so the centering shift and the variance floor are the
    solo fit's bits), centering, the seed rows of
    ``order_search._seed_rows`` at the tenant's seed, the seeded state
    built on ``device`` (the solo fit builds it on its model's), and the
    convergence epsilon from the TRUE event count -- followed by the
    group's forced chunk count, whose extra all-zero chunks are
    algebraically inert.
    """
    from ..models.gmm import chunk_events
    from ..models.order_search import _seed_rows
    from ..ops.formulas import convergence_epsilon
    from ..ops.seeding import seed_state_from_parts
    from ..parallel.distributed import global_moments, host_chunk_bounds
    from ..testing import faults

    dtype = np.dtype(config.dtype)
    chunk = int(config.chunk_size)
    S = max(data_axis, 1)
    chunks_l, wts_l, states, eps_l, shifts = [], [], [], [], []
    n_l, k_l, tgt_l, names, solo_l = [], [], [], [], []
    for lane, i in enumerate(group.indices):
        t = tenants[i]
        data = np.ascontiguousarray(np.asarray(t.data))
        n, d = data.shape
        if config.validate_input:
            validate_finite(data, 0, dtype=dtype, collective=False)
        # Moments at the SOLO chunk count: the partials' reduction depends
        # on the chunk-slot layout, and the solo fit's shift must be
        # reproduced bit for bit.
        _, _, solo_chunks = host_chunk_bounds(n, chunk, S, 0, 1)
        mean64, var64 = global_moments(data, chunk, solo_chunks)
        shift = (mean64.astype(dtype) if config.center_data
                 else np.zeros((d,), dtype))
        local = data.astype(dtype, copy=False)
        if config.center_data:
            local = local - shift[None, :]
        # The tenant's SOLO chunk layout first, then its pad chunks
        # interleaved PER DATA SHARD: shard s of the group holds exactly
        # the solo fit's shard-s chunk block (plus trailing all-zero
        # chunks), so a rank's real rows stay in front of its block, as in
        # the solo fit.
        c_solo, w_solo = chunk_events(local, chunk, num_chunks=solo_chunks)
        B = c_solo.shape[1]
        c_np = np.zeros((group.num_chunks, B, d), dtype)
        w_np = np.zeros((group.num_chunks, B), dtype)
        per_solo = solo_chunks // S
        per_g = group.num_chunks // S
        for s in range(S):
            c_np[s * per_g:s * per_g + per_solo] = \
                c_solo[s * per_solo:(s + 1) * per_solo]
            w_np[s * per_g:s * per_g + per_solo] = \
                w_solo[s * per_solo:(s + 1) * per_solo]
        rows = _seed_rows(data, t.num_clusters, n,
                          seed_method=config.seed_method,
                          seed=(config.seed if t.seed is None
                                else int(t.seed)))
        state = seed_state_from_parts(
            np.asarray(rows, dtype) - shift[None, :], n,
            float(var64.mean()), t.num_clusters,
            covariance_dynamic_range=config.covariance_dynamic_range,
            dtype=dtype, device=device,
            num_clusters_padded=group.k_bucket)
        if lane == 0:
            # Deterministic seed poisoning targets lane 0 of the group
            # (the batched-restart convention, models/restarts.py).
            state = faults.maybe_poison_state(state)
        chunks_l.append(c_np)
        wts_l.append(w_np)
        states.append(state)
        eps_l.append(convergence_epsilon(n, d, config.epsilon_scale))
        shifts.append(np.asarray(shift, np.float64))
        n_l.append(n)
        k_l.append(t.num_clusters)
        tgt_l.append(t.target_num_clusters)
        names.append(t.name)
        solo_l.append(solo_chunks)
    return PackedGroup(
        group=group,
        chunks=np.stack(chunks_l),
        wts=np.stack(wts_l),
        states=states,
        epsilons=np.asarray(eps_l, np.float64),
        shifts=np.stack(shifts),
        n_events=np.asarray(n_l, np.int64),
        k0=np.asarray(k_l, np.int64),
        targets=np.asarray(tgt_l, np.int64),
        names=names,
        solo_chunks=np.asarray(solo_l, np.int64),
        data_axis=S,
    )


def unpack_rows(packed: PackedGroup, lane: int) -> np.ndarray:
    """One tenant's rows back out of the packed grid (fit coordinates).

    The ragged round-trip contract: gathering the lane's per-shard solo
    chunk blocks (the pad chunks interleave per data shard -- see
    :func:`pack_group`) and dropping the pad rows returns exactly the
    centered rows that went in -- packing is pure layout, never
    arithmetic. Add ``packed.shifts[lane]`` back for original coordinates
    (a float round-trip, not a bit one: centering subtracts in the compute
    dtype).
    """
    n = int(packed.n_events[lane])
    d = packed.chunks.shape[-1]
    S = packed.data_axis
    per_solo = int(packed.solo_chunks[lane]) // S
    per_g = packed.chunks.shape[1] // S
    grid = np.asarray(packed.chunks[lane])
    blocks = [grid[s * per_g:s * per_g + per_solo] for s in range(S)]
    return np.concatenate(blocks, axis=0).reshape(-1, d)[:n]
