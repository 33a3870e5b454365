"""Test support shipped in the package: deterministic fault injection
(``testing.faults``), consulted by the EM loop, the sweep, the checkpointer
and the run supervisor. With no plan installed every hook is a near-free
no-op."""

from . import faults

__all__ = ["faults"]
