"""Structured serving traces: versioned JSONL + Chrome-trace/Perfetto export
(port of ``repro.obs.trace``; the same ``carmen-serve-trace`` v1 schema,
``docs/trace-schema.md``).

A :class:`TraceRecorder` accumulates timestamped events during one serving
run. Events are recorded host-side at the engine's existing synchronization
points, so tracing never changes a compiled program or adds a device
round-trip; span durations therefore measure what the *host* observed —
dispatch plus any device wait the call already contained. (The draft/verify
spans inside a speculative round are dispatch-only: a graph replay is
asynchronous and the round synchronizes once, at its single host transfer.)

Two exports from the same event list:

* **JSONL** (:meth:`TraceRecorder.write_jsonl` / :func:`read_trace`): the
  replayable serving-telemetry format. Line 1 is the header
  (``schema``/``version``, wall-clock anchor, run metadata, optional sharding
  report and collective-bytes snapshot); every following line is one event
  ``{"ts": seconds-since-run-start, "ph": "B"|"E"|"I", "name": ...,
  "track": ..., "args": {...}}``. This is the trace the ROADMAP's
  cycle-accurate PE-array simulator replays — treat field removals as a
  version bump.
* **Chrome trace** (:meth:`TraceRecorder.to_chrome`): the same events as a
  Chrome ``traceEvents`` JSON (load in Perfetto / ``chrome://tracing``).
  Tracks map to tids — one lane per serving slot plus ``engine`` (bursts,
  prefills, spec rounds), ``sched`` (admission), and ``run``.

B/E spans must nest per track; :meth:`end` enforces it at record time so an
exported trace is always well-formed, and :meth:`close_open` settles any
spans left open by an aborted run.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["TRACE_SCHEMA", "TRACE_VERSION", "TraceRecorder", "iter_trace",
           "read_trace"]

TRACE_SCHEMA = "carmen-serve-trace"
TRACE_VERSION = 1


class TraceRecorder:
    """Append-only event recorder for one serving run.

    ``sink`` names a JSONL path the recorder can always flush to. Used as a
    context manager, a recorder with a sink is crash-safe: if the ``with``
    body raises, ``__exit__`` settles the open spans (:meth:`close_open`)
    and writes the JSONL tail anyway, so the trace of a crashed or aborted
    run is still complete, well-formed, and replayable by the reference's ``sim/replay.py``
    (``meta.aborted`` is set so the replay report names it). A normal exit
    flushes too — ``flush()`` is idempotent and explicit calls remain fine.
    """

    def __init__(self, clock=time.perf_counter,
                 sink: Optional[str] = None) -> None:
        self._clock = clock
        self._t0 = clock()
        self.sink = sink
        self.header: Dict = {
            "schema": TRACE_SCHEMA,
            "version": TRACE_VERSION,
            "t0_unix": time.time(),
            "meta": {},
        }
        self.events: List[Dict] = []
        self._open: Dict[str, List[str]] = {}  # track -> stack of open spans

    def now(self) -> float:
        """Seconds since recorder creation (the trace time base)."""
        return self._clock() - self._t0

    def at(self, clock_value: float) -> float:
        """Convert a raw reading of the recorder's clock into trace time —
        how streaming submit timestamps (stamped on the caller's thread)
        land on the same time base as every other event."""
        return clock_value - self._t0

    def attach(self, key: str, value) -> None:
        """Attach a header field (sharding report, collective bytes, ...)."""
        self.header[key] = value

    def _emit(self, ph: str, name: str, track: str, args: Dict,
              ts: Optional[float] = None) -> None:
        self.events.append({
            "ts": self.now() if ts is None else ts,
            "ph": ph,
            "name": name,
            "track": track,
            "args": args,
        })

    def instant(self, name: str, track: str = "engine", **args) -> None:
        self._emit("I", name, track, args)

    def begin(self, name: str, track: str = "engine", **args) -> None:
        self._open.setdefault(track, []).append(name)
        self._emit("B", name, track, args)

    def end(self, name: str, track: str = "engine", **args) -> None:
        stack = self._open.get(track, [])
        if not stack or stack[-1] != name:
            raise ValueError(
                f"trace span mismatch on track {track!r}: ending {name!r}, "
                f"open spans are {stack}"
            )
        stack.pop()
        self._emit("E", name, track, args)

    def close_open(self, **args) -> None:
        """End every open span (innermost first) — aborted-run cleanup, so
        exports are always nesting-consistent."""
        for track, stack in self._open.items():
            while stack:
                self._emit("E", stack.pop(), track, args)

    def flush(self, path: Optional[str] = None) -> Optional[str]:
        """Settle open spans and write the JSONL trace to ``path`` (default:
        the configured ``sink``). Returns the written path, or None when
        neither is set. Safe to call repeatedly — the exports rewrite."""
        target = path or self.sink
        if target is None:
            return None
        self.close_open()
        return self.write_jsonl(target)

    # -- context manager: flush-on-exception ----------------------------------

    def __enter__(self) -> "TraceRecorder":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.header.setdefault("meta", {})["aborted"] = True
        self.flush()

    # -- exports --------------------------------------------------------------

    def to_chrome(self) -> Dict:
        """Chrome trace-event JSON (open in Perfetto / chrome://tracing)."""
        tids: Dict[str, int] = {}
        out = []
        for ev in self.events:
            tid = tids.setdefault(ev["track"], len(tids))
            out.append({
                "name": ev["name"],
                "ph": {"B": "B", "E": "E", "I": "i"}[ev["ph"]],
                "ts": ev["ts"] * 1e6,  # chrome wants microseconds
                "pid": 1,
                "tid": tid,
                "cat": "serving",
                "args": ev["args"],
            })
        meta = [
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
             "args": {"name": track}}
            for track, tid in tids.items()
        ]
        return {
            "traceEvents": meta + out,
            "displayTimeUnit": "ms",
            "metadata": self.header,
        }

    def write_chrome(self, path: str) -> str:
        _ensure_dir(path)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path

    def write_jsonl(self, path: str) -> str:
        """The versioned replayable trace: header line, then one event/line."""
        _ensure_dir(path)
        with open(path, "w") as f:
            f.write(json.dumps(self.header) + "\n")
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")
        return path


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def _checked_header(path: str, header: Dict) -> Dict:
    if header.get("schema") != TRACE_SCHEMA:
        raise ValueError(
            f"{path}: not a {TRACE_SCHEMA} trace (schema={header.get('schema')!r})"
        )
    if header.get("version", 0) > TRACE_VERSION:
        raise ValueError(
            f"{path}: trace version {header['version']} is newer than this "
            f"reader ({TRACE_VERSION})"
        )
    return header


class TraceReader:
    """Streaming JSONL trace reader: header eagerly, events lazily.

    The header line is read and schema-checked at construction; iterating
    yields one validated event dict per JSONL line without ever holding the
    whole file — a multi-hundred-MB serving trace replays in O(1) memory.
    Single-pass: iterate once (the PE-array simulator's replay is a single
    forward sweep by design).
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path)
        first = self._f.readline()
        if not first.strip():
            self._f.close()
            raise ValueError(f"{path}: empty trace")
        self.header: Dict = _checked_header(path, json.loads(first))

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        for line in self._f:
            if not line.strip():
                continue
            ev = json.loads(line)
            if "ts" not in ev or "ph" not in ev or "name" not in ev:
                self._f.close()
                raise ValueError(f"{self.path}: malformed event {ev!r}")
            return ev
        self._f.close()
        raise StopIteration

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "TraceReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def iter_trace(path: str) -> TraceReader:
    """Open a JSONL trace for streaming replay.

    Returns a :class:`TraceReader`: ``reader.header`` is the schema-checked
    header (validated before the first event is touched, same checks as
    :func:`read_trace`), and iterating the reader yields events one line at a
    time. Use as an iterator or a context manager::

        with iter_trace(path) as tr:
            for ev in tr: ...
    """
    return TraceReader(path)


def read_trace(path: str) -> Tuple[Dict, List[Dict]]:
    """Load a JSONL trace fully: ``(header, events)``, schema-checked.

    Thin wrapper over :func:`iter_trace` that materializes the event list —
    convenient for tests and small traces; the simulator streams instead.
    """
    with iter_trace(path) as tr:
        return tr.header, list(tr)
