"""Deterministic, stateless synthetic data pipeline (port of
``repro.data.pipeline``).

Batches are a pure function of (seed, step, shape): a restart or a skip
ahead costs nothing, and every host computes its own shard of the batch from
the step index alone.

* :class:`TokenPipeline`: Zipf-ish tokens, Markov-mixed so that the LM loss
  can fall, for LM training. The bits are the reference's ``jax.random``
  bits (``serve/threefry.py``: ``fold_in``, ``split``, ``uniform``,
  ``bernoulli``, ``normal``). The tokens then pass ``exp(-log(u) * 0.35)``
  and a truncating cast: an ulp of difference between two libraries'
  ``exp``/``log`` moves a token where the value sits on an integer
  boundary, and the vision stub's embeddings go through ``erfinv``
  (``tests/test_torch_train.py`` says what it finds).
* :class:`ClusterPipeline`: Gaussian-cluster classification sets for the
  paper's MLP accuracy experiments (numpy, the reference's arrays).

``input_specs`` (the dry-run's abstract inputs) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serve import threefry


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    device: torch.device = torch.device("cpu")

    def _key(self, step: int) -> torch.Tensor:
        key = threefry.prng_key(self.seed, self.device)
        return threefry.fold_in(key, torch.tensor(step, device=self.device))

    def batch(self, step: int, *, host_index: int = 0, host_count: int = 1) -> Dict:
        """The full batch for ``step`` (or this host's shard of it), on
        ``device``: int64 ``tokens`` and ``targets`` (B, seq_len)."""
        b = self.global_batch // host_count
        key = threefry.fold_in(self._key(step), torch.tensor(host_index, device=self.device))
        k1, k2, k3 = threefry.split(key, 3).unbind(0)
        v = self.cfg.vocab_size
        # zipf-ish marginal via an exponential transform of uniforms
        u = threefry.uniform(k1, (b, self.seq_len + 1), minval=1e-6)
        zipf = (torch.exp(-torch.log(u) * 0.35) - 1) * 50
        toks = torch.clamp(zipf, max=float(v - 1)).to(torch.int32).to(torch.int64)
        # markov mixing: with p=0.5 copy the previous token (learnable structure)
        copy = threefry.bernoulli(k2, 0.5, toks.shape)
        toks = torch.where(copy, torch.roll(toks, 1, dims=1), toks)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if self.cfg.frontend:
            normal = threefry.normal(k3, (b, self.cfg.frontend_tokens, self.cfg.d_model))
            batch["frontend_embeds"] = 0.02 * normal
        return batch


@dataclasses.dataclass(frozen=True)
class ClusterPipeline:
    """Gaussian clusters for the paper's 196-64-32-32-10 MLP experiments."""

    n_features: int = 196
    n_classes: int = 10
    seed: int = 0
    spread: float = 2.2

    def dataset(self, n: int):
        rng = np.random.default_rng(self.seed)
        centers = rng.normal(0, self.spread, (self.n_classes, self.n_features))
        y = rng.integers(0, self.n_classes, n)
        x = centers[y] + rng.normal(0, 1.0, (n, self.n_features))
        # normalize into FxP-friendly range [-2, 2)
        x = np.clip(x / (np.abs(x).max() / 1.9), -1.99, 1.99)
        return x.astype(np.float32), y.astype(np.int32)
