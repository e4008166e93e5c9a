"""Serving engine, greedy subset (port of ``repro.serve.engine``).

Continuous batching over a fixed slot count, with the reference's two fast
paths:

* **bucketed prefill**: an admitted prompt is padded to a power-of-two
  bucket, run through the model in one multi-token decode step into a fresh
  f32 row cache, the row is scattered into the slot and its write index
  rewound to the true prompt length;
* **decode bursts**: ``burst`` single-token steps keep the pending tokens,
  counts, budgets, emitted tokens and top-2 margins on the device; one host
  transfer per burst brings tokens and margins back, and the host clips each
  slot's run to its remaining budget.

Slots that are free or drained keep decoding every burst, as in the
reference; their cache index runs on and the KV write clamps at ``max_len``.
The burst is a plain Python loop (CUDA-graph capture is later work).
Sampling, adaptive precision, speculative decoding, resilience, observability
and mesh serving are not yet ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import EngineContext, prepare_params
from repro_torch.models import ModelApi

from .kvcache import bucket_length, scatter_rows, with_cache_positions


def top2(last: torch.Tensor):
    """Greedy token (first occurrence of the max, as ``lax.top_k``) and the
    top-2 logit margin, from (B, V) f32 logits."""
    tok = torch.argmax(last, dim=-1).to(torch.int32)
    vals = torch.topk(last, 2, dim=-1).values
    return tok, vals[:, 0] - vals[:, 1]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32, P >= 1
    max_new: int
    temperature: float = 0.0  # <= 0: greedy (the only mode ported)
    generated: Optional[List[int]] = None
    margins: Optional[List[float]] = None


def _checked_prompt(req: Request) -> np.ndarray:
    prompt = np.asarray(req.prompt, np.int32)
    if prompt.size == 0:
        raise ValueError(
            f"request {req.rid}: empty prompt — prompts must carry at least "
            "one token (seed with BOS)"
        )
    return prompt


class BatchedServer:
    """Continuous batching over ``slots`` concurrent sequences.

    ``device`` defaults to ``cuda`` (and raises without a card); pass
    ``"cpu"`` to serve with the kernels' plain versions.
    ``prepare_weights=True`` (default) prepares the weight bank once, at
    construction; ``False`` serves the raw tree through the per-call path,
    which re-rounds every weight at every dot (the reference's A/B against
    the prepared path). ``host_transfers`` counts device-to-host
    round trips in the last ``run``; ``prefill_calls`` and ``decode_steps``
    count model forwards, and ``prefill_seconds`` / ``decode_seconds`` their
    wall time.
    """

    def __init__(self, model: ModelApi, ctx: EngineContext, params, slots: int = 4,
                 max_len: int = 256, burst: int = 8, device=None, prepare_weights: bool = True):
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.model, self.ctx = model, ctx
        self.slots, self.max_len, self.burst = slots, max_len, burst
        self.device = resolve_device(device)
        params = _to_device(params, self.device)
        if prepare_weights:
            params = prepare_params(params, ctx.policy, ctx.mode, specs=model.specs())
        self.params = params
        self.cache = model.make_cache(slots, max_len, dtype=torch.float32, device=self.device)
        self._state = {
            "tok": torch.zeros((slots, 1), dtype=torch.int32, device=self.device),
            "count": torch.zeros((slots,), dtype=torch.int32, device=self.device),
            "rem": torch.zeros((slots,), dtype=torch.int32, device=self.device),
        }
        self.active: Dict[int, Request] = {}
        self._reset_counters()

    def _reset_counters(self):
        self.host_transfers = 0
        self.prefill_calls = 0
        self.decode_steps = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    def _admission_error(self, req: Request) -> None:
        prompt = _checked_prompt(req)
        if req.temperature > 0.0:
            raise NotImplementedError("sampled decoding is not yet ported; use temperature=0")
        if len(prompt) + req.max_new > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(prompt)}) + max_new ({req.max_new}) "
                f"exceeds max_len ({self.max_len}) — the KV cache would overflow mid-decode"
            )

    @torch.no_grad()
    def _prefill_slot(self, slot: int, req: Request) -> None:
        t0 = time.perf_counter()
        prompt = _checked_prompt(req)
        plen = len(prompt)
        bucket = bucket_length(plen, self.max_len)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :plen] = prompt
        tokens = torch.from_numpy(padded).to(self.device)
        row = self.model.make_cache(1, self.max_len, dtype=torch.float32, device=self.device)
        logits, row = self.model.decode_step(self.params, tokens, row, self.ctx)
        self.prefill_calls += 1
        last = logits[:, plen - 1, :].to(torch.float32)
        with_cache_positions(row, torch.tensor([plen], dtype=torch.int32))
        tok, margin = top2(last)
        scatter_rows(self.cache, row, slot)
        st = self._state
        st["tok"][slot, 0] = tok[0]
        st["count"][slot] = 1  # prefill emitted token 0
        st["rem"][slot] = req.max_new - 1
        out = torch.stack([tok.to(torch.float32), margin]).cpu()
        self.host_transfers += 1
        req.generated = [int(out[0, 0])]
        req.margins = [float(out[1, 0])]
        self.prefill_seconds += time.perf_counter() - t0

    @torch.no_grad()
    def _burst_round(self, slot_of: Dict[int, int]) -> None:
        t0 = time.perf_counter()
        st = self._state
        tok, count, rem = st["tok"], st["count"], st["rem"]
        toks = torch.empty((self.slots, self.burst), dtype=torch.float32, device=self.device)
        margins = torch.empty_like(toks)
        for j in range(self.burst):
            logits, self.cache = self.model.decode_step(self.params, tok, self.cache, self.ctx)
            self.decode_steps += 1
            nxt, margin = top2(logits[:, -1, :].to(torch.float32))
            active = (rem > 0).to(torch.int32)
            count, rem = count + active, rem - active
            toks[:, j] = nxt
            margins[:, j] = margin
            tok = nxt[:, None]
        st.update(tok=tok, count=count, rem=rem)
        out = torch.stack([toks, margins]).cpu().numpy()  # the burst's one transfer
        self.host_transfers += 1
        for rid, req in self.active.items():
            s = slot_of[rid]
            n = min(self.burst, req.max_new - len(req.generated))
            req.generated.extend(int(t) for t in out[0, s, :n])
            req.margins.extend(float(m) for m in out[1, s, :n])
        self.decode_seconds += time.perf_counter() - t0

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve requests to completion; returns rid -> generated tokens."""
        for req in requests:  # reject before any state mutates
            self._admission_error(req)
        self._reset_counters()
        self.active.clear()
        queue = list(requests)
        results: Dict[int, List[int]] = {}
        slot_of: Dict[int, int] = {}
        free = list(range(self.slots))
        while queue or self.active:
            while queue and free:
                req, slot = queue.pop(0), free.pop(0)
                self._prefill_slot(slot, req)
                if len(req.generated) >= req.max_new:
                    results[req.rid] = req.generated
                    free.append(slot)
                else:
                    self.active[req.rid] = req
                    slot_of[req.rid] = slot
            if not self.active:
                continue
            self._burst_round(slot_of)
            for rid in [r for r, q in self.active.items() if len(q.generated) >= q.max_new]:
                results[rid] = self.active.pop(rid).generated
                free.append(slot_of.pop(rid))
        return results


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
