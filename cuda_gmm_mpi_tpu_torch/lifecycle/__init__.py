"""Closed-loop model lifecycle (rev v2.6; docs/ROBUSTNESS.md).

The reference fits once and exits; our repro already has every piece of
a production ML loop -- stepwise minibatch EM, registry hot-reload,
drift envelopes/alarms -- as disconnected subsystems. This package
closes the loop: a :class:`LifecycleController` consumes ``drift_alarm``
events for a served route and drives retrain -> canary -> promote ->
watch with rollback as a first-class state, never touching the serving
path until a candidate has passed every gate.
"""

from .controller import (LifecycleController, LifecycleError,
                         LifecyclePolicy)

__all__ = ["LifecycleController", "LifecycleError", "LifecyclePolicy"]
