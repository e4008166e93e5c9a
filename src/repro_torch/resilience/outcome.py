"""Request outcomes, admission control, and load-shedding policies (port of
``repro.resilience.outcome``, pure Python as there).

Every request a resilient :class:`~repro_torch.serve.engine.BatchedServer` run
touches ends in exactly one structured :class:`RequestOutcome`:

=========== ================================================================
``ok``       ran to its token budget (``max_new``) and was returned
``expired``  missed its deadline mid-decode; evicted at a burst boundary
             with the tokens it had committed so far
``shed``     never admitted — rejected at the queue with an attributable
             ``reason`` (``queue_full`` / ``too_long`` / ``empty_prompt`` /
             ``deadline_expired``)
``faulted``  produced non-finite or saturated logits; quarantined and
             evicted at the burst boundary so its slot state never corrupts
             neighbors (clean tokens committed before the fault are kept)
``aborted``  the run itself died mid-flight (filled in by ``_end_run`` so a
             crashed run is still fully attributable), or — on the streaming
             frontend — the client cancelled / disconnected (reason
             ``cancelled``, partial tokens kept)
=========== ================================================================

:class:`ResilienceConfig` switches the server from the legacy fail-stop
contract (oversized prompt raises, NaN poisons the batch silently) to the
shed/quarantine contract above. ``resilience=None`` keeps the legacy
behavior byte-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["OUTCOME_STATUSES", "RequestOutcome", "ResilienceConfig",
           "SHED_POLICIES", "shed_overflow"]

OUTCOME_STATUSES = ("ok", "expired", "shed", "faulted", "aborted")

# shed policies: how a bounded queue picks victims when it overflows
SHED_POLICIES = ("reject_newest", "reject_largest", "deadline_aware")


@dataclasses.dataclass
class RequestOutcome:
    """The structured terminal state of one request in one run."""

    rid: int
    status: str                        # one of OUTCOME_STATUSES
    reason: Optional[str] = None       # shed/fault attribution
    tokens: int = 0                    # tokens committed (partial for expired/faulted)
    deadline_s: Optional[float] = None # the request's deadline (run-relative)
    wall_s: Optional[float] = None     # run entry -> outcome decision

    def __post_init__(self):
        if self.status not in OUTCOME_STATUSES:
            raise ValueError(
                f"unknown outcome status {self.status!r}; expected one of "
                f"{OUTCOME_STATUSES}"
            )

    @property
    def deadline_met(self) -> bool:
        """Completed with its full budget inside its deadline (requests
        without a deadline count as met when they complete)."""
        if self.status != "ok":
            return False
        if self.deadline_s is None or self.wall_s is None:
            return True
        return self.wall_s <= self.deadline_s

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["deadline_met"] = self.deadline_met
        return d


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Fault-tolerance knobs for one :class:`BatchedServer`.

    ``queue_limit`` bounds the admission queue: overflow is shed per
    ``shed_policy`` with reason ``queue_full`` instead of waiting unboundedly.
    ``fault_isolation`` turns on the per-slot non-finite-logit flag in the
    decode burst's slot state (detection itself is always in the burst
    program — it rides the burst's existing host transfer — this switches
    whether the host acts on it). ``logit_limit`` additionally treats ``|logit| > limit`` as a
    saturated accumulator. ``default_deadline_s`` applies to requests that
    carry no ``deadline_s`` of their own.
    """

    queue_limit: Optional[int] = None
    shed_policy: str = "reject_newest"
    fault_isolation: bool = True
    logit_limit: Optional[float] = None
    default_deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"unknown shed policy {self.shed_policy!r}; expected one of "
                f"{SHED_POLICIES}"
            )
        if self.queue_limit is not None and self.queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {self.queue_limit}")
        if self.logit_limit is not None and self.logit_limit <= 0:
            raise ValueError(f"logit_limit must be > 0, got {self.logit_limit}")
        if self.default_deadline_s is not None and self.default_deadline_s <= 0:
            raise ValueError(
                f"default_deadline_s must be > 0, got {self.default_deadline_s}"
            )


def shed_overflow(queue: List, limit: int, policy: str,
                  deadline_of=None) -> Tuple[List, List]:
    """Shrink ``queue`` to ``limit`` requests; returns ``(kept, shed)``.

    ``kept`` preserves arrival order (admission fairness is FIFO among the
    survivors regardless of policy). Policies pick the victims:

    * ``reject_newest`` — drop from the tail (arrival order is priority);
    * ``reject_largest`` — drop the largest prompts first (one oversized
      prompt costs more prefill than several small ones);
    * ``deadline_aware`` — drop the requests with the least deadline slack
      first (they are the least likely to finish in time anyway; requests
      without a deadline have infinite slack and shed last).

    ``deadline_of`` lets the caller supply resolved deadlines (e.g. the
    server's run-local resolution of ``default_deadline_s``) instead of the
    raw ``request.deadline_s`` field the request happens to carry.
    """
    if deadline_of is None:
        deadline_of = lambda r: r.deadline_s
    if len(queue) <= limit:
        return list(queue), []
    if policy == "reject_newest":
        return list(queue[:limit]), list(queue[limit:])
    if policy == "reject_largest":
        # stable sort: ties shed newest-first
        order = sorted(range(len(queue)), key=lambda i: (-len(queue[i].prompt), -i))
    elif policy == "deadline_aware":
        inf = float("inf")
        order = sorted(
            range(len(queue)),
            key=lambda i: (
                deadline_of(queue[i]) if deadline_of(queue[i]) is not None
                else inf,
                i,
            ),
        )
    else:
        raise ValueError(f"unknown shed policy {policy!r}")
    victims = set(order[: len(queue) - limit])
    kept = [r for i, r in enumerate(queue) if i not in victims]
    shed = [r for i, r in enumerate(queue) if i in victims]
    return kept, shed
