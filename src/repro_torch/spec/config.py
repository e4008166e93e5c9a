"""Speculative-serving configuration (port of ``repro.spec.config``)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """One speculative round drafts ``draft_len`` tokens, then verifies k+1.

    ``draft_point`` names the bank execution point the draft loop runs at;
    ``None`` lets an attached :class:`repro_torch.runtime.ModeController`
    pick it per round, else the bank's cheapest point. ``verify_point``
    defaults to the bank reference (all-accurate): greedy outputs are
    bit-identical to serving every token at that point.
    """

    draft_len: int = 4
    draft_point: Optional[str] = None
    verify_point: Optional[str] = None

    def __post_init__(self):
        if self.draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {self.draft_len}")
        if (
            self.draft_point is not None
            and self.draft_point == self.verify_point
        ):
            raise ValueError(
                "draft_point == verify_point drafts at full cost; pick a "
                "cheaper draft point (or leave draft_point=None)"
            )
