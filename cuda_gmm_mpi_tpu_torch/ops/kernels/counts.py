"""The kernel wrappers' launch counters, held per thread while a CUDA
graph's body is warmed up or captured.

Each wrapper counts one launch on its own ``launches`` attribute where it
launches its kernel (:func:`note_launch`). A graph's warm-up runs its
kernels outside any dispatch, and its capture launches nothing, so inside
:func:`held_launches` the current thread's launches go to a tally instead
of the counters; launches that other threads make meanwhile count as
usual.
"""

from __future__ import annotations

import contextlib
import threading

_held = threading.local()


class LaunchCount:
    """The ``launches`` counter of a kernel's second form, which has no
    wrapper of its own: :func:`note_launch` counts on it as on a wrapper."""

    def __init__(self) -> None:
        self.launches = 0


def note_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel: on the wrapper, or on the
    current thread's tally inside :func:`held_launches`."""
    tally = getattr(_held, "tally", None)
    if tally is None:
        wrapper.launches += 1
    else:
        tally[wrapper] = tally.get(wrapper, 0) + 1


@contextlib.contextmanager
def held_launches():
    """Yield a dict {wrapper: launches} that takes this thread's launches
    until the block ends; the wrappers' counters do not move for them."""
    outer = getattr(_held, "tally", None)
    tally: dict = {}
    _held.tally = tally
    try:
        yield tally
    finally:
        _held.tally = outer
