"""Multi-tenancy: fit many independent GMMs as packed fleet groups (the
port of the JAX package's ``tenancy/``).

- :mod:`~cuda_gmm_mpi_tpu_torch.tenancy.packing` -- ragged tenants into
  pow2 (event-bucket, cluster-bucket) groups; pure layout, never
  arithmetic.
- :mod:`~cuda_gmm_mpi_tpu_torch.tenancy.fleet` -- the fleet fit:
  one packed group = one fleet EM call per sweep step, per-tenant
  freeze-out / health rows / checkpoints, bit-identical to solo fits in
  'scan' mode.
- :mod:`~cuda_gmm_mpi_tpu_torch.tenancy.cli` -- the ``gmm fleet`` command:
  manifest of per-tenant input files -> per-tenant fitted models, with
  registry export.
"""

from .fleet import FleetResult, TenantResult, fit_fleet
from .packing import (
    FleetGroup, PackedGroup, TenantSpec, pack_group, plan_fleet,
    unpack_rows,
)

__all__ = [
    "FleetGroup", "FleetResult", "PackedGroup", "TenantResult",
    "TenantSpec", "fit_fleet", "pack_group", "plan_fleet", "unpack_rows",
]
