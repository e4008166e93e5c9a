"""Fault-tolerant serving (port of ``repro.resilience``): outcomes, admission
control, degradation, injection.

The resilience layer turns the serving engine's fail-stop contract into a
shed/quarantine/degrade contract:

* :class:`ResilienceConfig` — deadlines, bounded admission queue with
  pluggable shed policies, per-slot numeric fault isolation;
* :class:`RequestOutcome` — every request ends in exactly one structured
  outcome (``ok`` / ``expired`` / ``shed`` / ``faulted`` / ``aborted``);
* :class:`DegradationPolicy` — overload-driven cap on the controller's
  CORDIC-depth ladder: demote the whole batch before shedding, promote back
  with hysteresis;
* :class:`FaultInjector` — deterministic NaN-cache / NaN-weight / delay
  faults pinned to decode-round indices, for tests and the card's smoke.
"""
from .degrade import DegradationConfig, DegradationPolicy
from .inject import (DelayFault, FaultInjector, NaNCacheFault, NaNWeightFault,
                     oversized_request, poison_cache_slot, poison_tree)
from .outcome import (OUTCOME_STATUSES, RequestOutcome, ResilienceConfig,
                      SHED_POLICIES, shed_overflow)

__all__ = [
    "DegradationConfig",
    "DegradationPolicy",
    "DelayFault",
    "FaultInjector",
    "NaNCacheFault",
    "NaNWeightFault",
    "OUTCOME_STATUSES",
    "RequestOutcome",
    "ResilienceConfig",
    "SHED_POLICIES",
    "oversized_request",
    "poison_cache_slot",
    "poison_tree",
    "shed_overflow",
]
