"""Device programs of the server: the port's counterpart of ``jax.jit`` with
donation.

The reference compiles each decode burst and each prefill bucket into one
XLA program and donates the KV cache and the slot state to it. Here a
program is a function ``fn(cache, state) -> out`` that updates the cache and
state in place and returns one tensor, the program's whole output, or None:
a program with no output (one step of the scan prefill) costs no transfer. On a CUDA
device :class:`GraphRunner` captures each program as one CUDA graph at its
first call and replays it after; on the CPU it runs the function eagerly, as
the caller asked for the CPU. ``GraphRunner(device, capture=False)`` runs
the same programs eagerly on the card too, every launch issued from the
host: the uncaptured yardstick that captured runs are held against.

What capture keeps true:

* **Inputs are copied, never rebound.** A program reads its host inputs from
  static device buffers (:class:`Staged`), filled before each replay by one
  copy each from pinned host memory; a buffer's host side is written again
  only once its last copy has run. The fused and MAC-array launches encode
  their TMA descriptors on the host from the addresses they see, and the
  graph replays those addresses.
* **Outputs live outside the graph pool.** The output buffer is the warm-up
  run's own output, allocated by the ordinary allocator.
* **The pool holds scratch only.** All of a runner's graphs share one memory
  pool. PyTorch allows that for graphs replayed in any order only when no
  block allocated inside a capture outlives it, so that each graph's pool
  memory is scratch that no later replay reads; after every capture the
  runner asserts that the pool holds no live block
  (:func:`pool_live_bytes`). The graphs never run at once: one stream.
* **Nothing is first built inside a capture.** The first call runs the
  program once eagerly on copies of the cache and state, on the runner's
  stream: that builds the kernel libraries, the AF tables, the split-K
  counters at their largest size and cuBLAS's workspace for that stream,
  none of which may be allocated or copied from the host inside a capture.
  The runner asserts that the AF tables and the split-K counters are the
  same after the capture as before it (:func:`lazy_state`), and that every
  counter buffer an earlier capture saw, by any runner, is still the one it
  saw: a counter buffer reallocated after a capture would leave that graph
  writing freed memory. The capture itself does not execute, so the
  first call then replays the graph on the real cache and state.
* **One stream.** Warm-up, capture, uploads, replays and the transfer back
  run on one side stream for the runner's life (the split-K counters are
  shared by every launch and must see launches in order).

A capture or replay that fails raises; nothing falls back to eager launches.
The kernel wrappers count launches when a launch is issued, so they tick in
the warm-up and at capture, not at replay: the runner records each graph's
launches by instantiation at capture (``captured_launches``) and its
``replays``, and the launches a run made on the device are their products.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import torch

__all__ = ["GraphRunner", "Staged", "lazy_state", "pool_bytes", "pool_live_bytes"]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _to_host(out: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if out is None else out.cpu()


def _diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


# the split-K counter buffers that captured graphs write: device -> (address,
# size) when first captured
_captured_counters: Dict[str, tuple] = {}


def lazy_state():
    """What the kernel wrappers build at their first use on a device: the
    AF tables' keys, and each split-K counter buffer's address and size."""
    from repro_torch.kernels import af_table, int_dot

    return (frozenset(af_table._device_tables),
            {k: (v.data_ptr(), v.numel()) for k, v in int_dot._counters.items()})


def pool_live_bytes(pool) -> int:
    """Bytes of live (``active_allocated``) blocks in the segments of the
    caching allocator's pool ``pool``."""
    return sum(b["size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool)
               for b in seg["blocks"] if b["state"] == "active_allocated")


def pool_bytes(pool) -> int:
    """Bytes the caching allocator holds for the pool ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


class Staged:
    """A static device buffer that a program reads, and the host tensor it is
    filled from (pinned on a CUDA device; on the CPU the two are one).

    An upload is an asynchronous copy that reads the host tensor when the
    stream reaches it, so a fill first waits for the buffer's last upload to
    have run: programs without output (the frontend's chunks) are queued
    back to back, with no transfer between them to wait on."""

    def __init__(self, shape, dtype, device: torch.device):
        self.device_buf = torch.zeros(shape, dtype=dtype, device=device)
        self.host = (torch.zeros(shape, dtype=dtype, pin_memory=True)
                     if device.type == "cuda" else self.device_buf)
        self._uploaded = None  # the CUDA event after the last upload

    def fill(self, value) -> None:
        """Write ``value`` (a scalar, array or tensor of the buffer's shape) to the host side."""
        if self._uploaded is not None:
            self._uploaded.synchronize()
            self._uploaded = None
        self.host.copy_(torch.as_tensor(value, dtype=self.host.dtype))

    def upload(self) -> None:
        if self.host is not self.device_buf:
            self.device_buf.copy_(self.host, non_blocking=True)
            self._uploaded = torch.cuda.Event()
            self._uploaded.record()


class GraphRunner:
    """Runs a server's programs by name: one CUDA graph each on a CUDA
    device (eagerly with ``capture=False``), eagerly on the CPU.
    ``replays`` counts each graph's replays, ``captured_launches`` its kernel
    launches by instantiation (counted at capture), ``warmup_launches``
    those of its warm-up and ``capture_seconds`` the wall time of warm-up
    plus capture. :meth:`drop` discards graphs whose inputs were replaced
    (a poisoned weight tree); the next call of such a program captures it
    again, counted in ``recaptures`` (its ``capture_seconds`` then holds
    the re-capture's time)."""

    def __init__(self, device: torch.device, capture: bool = True):
        self.device = device
        self.capture = capture and device.type == "cuda"
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self._outs: Dict[str, torch.Tensor] = {}
        self.replays: Dict[str, int] = {}
        self.captured_launches: Dict[str, Dict[str, int]] = {}
        self.warmup_launches: Dict[str, Dict[str, int]] = {}
        self.capture_seconds: Dict[str, float] = {}
        self.recaptures: Dict[str, int] = {}
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device=device)
        if self.capture:
            self.pool = torch.cuda.graph_pool_handle()

    def staged(self, shape, dtype) -> Staged:
        return Staged(shape, dtype, self.device)

    def run(self, name: str, fn: Callable, cache, state,
            inputs: Sequence[Staged] = ()) -> Optional[torch.Tensor]:
        """Run program ``name`` (``fn`` is read only at its first call when
        capturing) after uploading ``inputs``; returns its output on the
        host, the program's one transfer (None for a program without
        output: no transfer)."""
        if self.device.type != "cuda":
            return _to_host(fn(cache, state))
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for inp in inputs:
                inp.upload()
            if not self.capture:
                return _to_host(fn(cache, state))
            if name not in self.graphs:
                self._capture(name, fn, cache, state)
            self.graphs[name].replay()
            self.replays[name] = self.replays.get(name, 0) + 1
            return _to_host(self._outs[name])

    def eager(self, fn: Callable):
        """Run ``fn()`` uncaptured, in order with the programs: on the
        runner's stream on a CUDA device (the streaming frontend zeroes its
        static prefill buffers so)."""
        if self.device.type != "cuda":
            return fn()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            return fn()

    def drop(self, keep: Callable[[str], bool]) -> list:
        """Discard every graph whose name ``keep`` rejects; returns their
        names. Their pool memory is scratch, so nothing else changes."""
        gone = [name for name in self.graphs if not keep(name)]
        for name in gone:
            del self.graphs[name]
            self._outs.pop(name, None)
        return gone

    def _capture(self, name: str, fn: Callable, cache, state) -> None:
        from repro_torch.kernels import launch_counts

        t0 = time.perf_counter()
        before = launch_counts()
        out = fn(_clone(cache), _clone(state))  # warm-up, on copies
        mid = launch_counts()
        built = lazy_state()
        moved = {k: v for k, v in _captured_counters.items() if built[1].get(k) != v}
        if moved:
            raise RuntimeError(f"graph {name!r}: the split-K counters that earlier graphs write "
                               f"were reallocated ({moved} -> {built[1]})")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            res = fn(cache, state)
            if out is not None:
                out.copy_(res)
            del res
        after = launch_counts()
        torch.cuda.synchronize(self.device)
        if lazy_state() != built:
            raise RuntimeError(f"graph {name!r}: an AF table or split-K counter buffer was "
                               "first built inside the capture")
        live = pool_live_bytes(self.pool)
        if live:
            raise RuntimeError(f"graph {name!r}: {live} bytes allocated inside the capture "
                               "outlive it in the shared graph pool")
        _captured_counters.update(built[1])
        if name in self.capture_seconds:
            self.recaptures[name] = self.recaptures.get(name, 0) + 1
        self.graphs[name], self._outs[name] = graph, out
        self.warmup_launches[name] = _diff(mid, before)
        self.captured_launches[name] = _diff(after, mid)
        self.capture_seconds[name] = time.perf_counter() - t0
