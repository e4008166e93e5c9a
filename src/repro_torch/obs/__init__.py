"""Serving observability (port of ``repro.obs``): SLO latency metrics and
replayable structured traces.

Three pieces, all host-side, never inside a device program (token streams
are bit-identical with observability on or off, held in
``tests/test_torch_obs.py``):

* :mod:`repro_torch.obs.metrics` — counters, gauges and streaming
  histograms (p50/p90/p99) for the SLO quantities: time-to-first-token,
  inter-token latency, queue wait, prefill/decode wall time, per-request and
  run tok/s, acceptance rate, host transfers.
* :mod:`repro_torch.obs.trace` — a structured event timeline (admission,
  prefill, bursts with their execution point, controller switches with
  their ``StepSignals``, speculative draft/verify/rollback, graph captures)
  with two exports: Chrome-trace JSON (Perfetto) and the versioned
  ``carmen-serve-trace`` JSONL, which the reference's PE-array simulator
  (``repro.sim.replay``) replays.
* :mod:`repro_torch.obs.observer` — :class:`ServingObserver`, the hook
  bundle ``BatchedServer(observer=...)`` drives at its existing host sync
  points.
"""
from .metrics import Counter, Gauge, MetricsRegistry, StreamingHistogram
from .observer import ServingObserver
from .trace import (TRACE_SCHEMA, TRACE_VERSION, TraceReader, TraceRecorder,
                    iter_trace, read_trace)

__all__ = [
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "ServingObserver",
    "StreamingHistogram",
    "TraceReader",
    "TraceRecorder",
    "TRACE_SCHEMA",
    "TRACE_VERSION",
    "iter_trace",
    "read_trace",
]
