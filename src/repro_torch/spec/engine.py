"""SpeculativeDecoder: the draft/verify pair bound to a weight bank (port of
``repro.spec.engine``).

A round is two device programs run through a ``serve.capture.GraphRunner``:
the draft loop at the draft point (``"draft <variant> @<point>"``, no output)
and the verify at the verify point (``"verify <variant> @<point>"``), whose
one output tensor is the round's one device-to-host transfer; the variant is
``greedy`` when no slot samples (no threefry and no softmax) and ``sampled``
otherwise, as the server picks its bursts. On the card each is a CUDA graph
captured at its first call, so the draft program is captured once per draft
point it visits and the verify once; a point already visited replays its
graph, with no copy of any bank.

The round's host inputs (the slots' pending tokens and generated counts, the
committed row counts, the round counter) are copied into static ``Staged``
buffers before the draft program, which writes the tokens and counts into
the slot state: the reference's post-round resync of ``tok``/``count``
arrives with the next round's uploads, never as a transfer of its own. The
drafts live in device buffers made before any capture.

Under a mesh (the server's ``mesh=``) the rounds run on the rank's local
slots: the host inputs are the local slots' entries of the server's host
arrays, and the verify's output is all-gathered over ``data`` before the
transfer, so every rank commits the same tokens.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import EngineContext
from repro_torch.models import ModelApi
from repro_torch.runtime.bank import MultiPointBank

from .config import SpecConfig
from .decoding import make_draft_loop, make_verify_step
from .telemetry import SpecTelemetry

__all__ = ["SpeculativeDecoder"]


class SpeculativeDecoder:
    """Draft-k-then-verify serving rounds over a multi-point weight bank.

    ``programs`` is the ``GraphRunner`` the rounds run through (the server
    passes its own, so that every graph shares one pool and one stream);
    without one, a runner is made on the device of the first round's state.
    """

    def __init__(self, model: ModelApi, ctx: EngineContext, bank: MultiPointBank,
                 cfg: Optional[SpecConfig] = None, *, programs=None, mesh=None,
                 data_shards: int = 1):
        self.cfg = cfg or SpecConfig()
        self.bank = bank
        self.verify_point = self.cfg.verify_point or bank.reference
        for name in (self.cfg.draft_point, self.verify_point):
            if name is not None and name not in bank.names:
                raise ValueError(
                    f"unknown execution point {name!r}; bank has {bank.names}"
                )
        # default draft point: the cheapest rung of the ladder
        self.default_draft_point = self.cfg.draft_point or bank.names[0]
        if self.default_draft_point == self.verify_point:
            raise ValueError(
                f"draft point {self.default_draft_point!r} is the verify "
                "point: every round would pay k full-cost draft passes on "
                "top of the verify pass — pick a cheaper draft point"
            )
        self.model = model
        self.mesh, self.data_shards = mesh, data_shards
        # each in two variants, by whether any slot samples (False: all greedy)
        self.draft_loops = {s: make_draft_loop(model, ctx, self.cfg.draft_len, sampled=s)
                            for s in (False, True)}
        self.verifies = {s: make_verify_step(model, ctx, self.cfg.draft_len, sampled=s)
                         for s in (False, True)}
        self.telemetry = SpecTelemetry.for_bank(bank, self.cfg.draft_len)
        self.programs = programs
        # an optional obs.ServingObserver: the draft and verify dispatch
        # spans and the rollback commit land on the serving trace (the
        # server wires it a run)
        self.observer = None
        self._inputs = None  # Staged host inputs, made at the first round
        self._drafts = None  # device draft tokens and probs
        self._round = 0

    @property
    def draft_len(self) -> int:
        return self.cfg.draft_len

    def reset(self) -> None:
        """Fresh telemetry and round counter (PRNG folds restart), so
        consecutive ``BatchedServer.run`` calls are reproducible."""
        self.telemetry.reset()
        self._round = 0

    def _setup(self, state) -> None:
        if self.programs is None:
            from repro_torch.serve.capture import GraphRunner

            self.programs = GraphRunner(state["tok"].device)
        staged, b = self.programs.staged, state["tok"].shape[0]
        self._inputs = {"tok": staged((b, 1), torch.int32), "count": staged((b,), torch.int32),
                        "start": staged((b,), torch.int32), "round": staged((), torch.int32)}
        dev, k = state["tok"].device, self.cfg.draft_len
        self._drafts = {
            "tokens": torch.zeros((b, k), dtype=torch.int32, device=dev),
            "probs": torch.zeros((b, k, self.model.cfg.vocab_size), dtype=torch.float32,
                                 device=dev)}

    def _local_rows(self, slots: int) -> slice:
        """The server's host-array rows of this rank's slots."""
        if self.data_shards == 1:
            return slice(None)
        n = slots // self.data_shards
        c = self.mesh.coord("data")
        return slice(c * n, (c + 1) * n)

    @torch.no_grad()
    def round(self, tokens, cache, state, counts, start, *,
              draft_point: Optional[str] = None, sampled: bool = True):
        """One draft+verify round over the whole slot batch.

        ``tokens`` (B,) each slot's pending token, ``counts`` (B,) its
        generated-token index (PRNG folds), ``start`` (B,) its committed row
        count: host arrays, uploaded as the round's inputs; ``state`` is the
        server's slot state (its ``key`` and ``temp`` are read, its ``tok``
        and ``count`` set from ``tokens`` and ``counts``). ``sampled=False``
        runs the all-greedy variants, which give what the sampled ones give
        when no slot's temperature is above 0. Returns numpy ``(emitted (B,
        k+1), accepted (B,), margins (B, k+1), draft_fault (B,), verify_fault
        (B,))`` and the draft point, from one transfer; the cache is rolled
        back to ``start + accepted + 1`` rows a slot.
        """
        point = draft_point or self.default_draft_point
        draft_tree = self.bank.tree(point)
        verify_tree = self.bank.tree(self.verify_point)
        if self._inputs is None:
            self._setup(state)
        inp, k = self._inputs, self.cfg.draft_len
        local = self._local_rows(len(tokens))
        inp["tok"].fill(np.asarray(tokens, np.int32)[local, None])
        inp["count"].fill(np.asarray(counts, np.int32)[local])
        inp["start"].fill(np.asarray(start, np.int32)[local])
        inp["round"].fill(self._round)
        self._round += 1
        buf = {name: s.device_buf for name, s in inp.items()}
        draft_loop, verify_step = self.draft_loops[sampled], self.verifies[sampled]

        def draft(cache, st):
            slots, d = st["slots"], st["drafts"]
            slots["tok"].copy_(buf["tok"])
            slots["count"].copy_(buf["count"])
            toks, probs = draft_loop(draft_tree, slots["tok"], cache, slots["key"],
                                     slots["count"], slots["temp"], buf["round"])
            d["tokens"].copy_(toks)
            if probs is not None:
                d["probs"].copy_(probs)

        def verify(cache, st):
            slots, d = st["slots"], st["drafts"]
            emitted, accepted, margins, draft_fault, verify_fault = verify_step(
                verify_tree, slots["tok"], d["tokens"], d["probs"], cache, buf["start"],
                slots["key"], slots["count"], slots["temp"], buf["round"])
            out = torch.cat([emitted.to(torch.float32), margins,
                             torch.stack([accepted.to(torch.float32),
                                          draft_fault.to(torch.float32),
                                          verify_fault.to(torch.float32)], dim=1)], dim=1)
            if self.data_shards > 1:  # every slot's row, in global slot order
                from repro_torch.sharding.collectives import all_gather

                out = all_gather(out, self.mesh, "data", dim=0)
            return out

        st = {"slots": state, "drafts": self._drafts}
        variant = "sampled" if sampled else "greedy"
        obs = self.observer
        if obs is not None:
            obs.spec_stage_begin("draft", point)
        self.programs.run(f"draft {variant} @{point}", draft, cache, st,
                          inputs=list(inp.values()))
        if obs is not None:
            obs.spec_stage_end("draft", point)
            obs.spec_stage_begin("verify", self.verify_point)
        out = self.programs.run(f"verify {variant} @{self.verify_point}", verify, cache,
                                st).numpy()
        if obs is not None:
            obs.spec_stage_end("verify", self.verify_point)
        emitted = out[:, :k + 1].astype(np.int64)
        margins = out[:, k + 1:2 * k + 2]
        accepted = out[:, 2 * k + 2].astype(np.int64)
        draft_fault, verify_fault = out[:, 2 * k + 3] > 0, out[:, 2 * k + 4] > 0
        if obs is not None:
            obs.spec_commit(accepted)
        return emitted, accepted, margins, draft_fault, verify_fault, point
