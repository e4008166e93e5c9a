"""Self-speculative serving (port of ``repro.spec``): draft on a shallow CORDIC
point, verify deep.

* **draft** (:func:`make_draft_loop`): k single-token decode steps at the
  draft point, one program; the drafted KV rows land past each slot's
  committed index, a region the per-query-causal mask hides;
* **verify** (:func:`make_verify_step`): one multi-token ``decode_step`` over
  the pending token and the k drafts at the verify point, which rewrites the
  drafted rows, then greedy exact-match or rejection-sampling acceptance;
* **rollback** (:mod:`.rollback`): the write index is set to
  ``start + accepted + 1``;
* **telemetry** (:class:`SpecTelemetry`): acceptance rate, tokens per verify,
  and weight-pass cycles under the ``K*(depth+1)`` iterative-PE model.

``BatchedServer(speculate=SpecConfig(...))`` is the serving integration.
"""
from .config import SpecConfig
from .decoding import make_draft_loop, make_verify_step
from .engine import SpeculativeDecoder
from .rollback import cache_positions, rollback, with_cache_positions
from .telemetry import SpecTelemetry

__all__ = [
    "SpecConfig",
    "SpecTelemetry",
    "SpeculativeDecoder",
    "cache_positions",
    "make_draft_loop",
    "make_verify_step",
    "rollback",
    "with_cache_positions",
]
