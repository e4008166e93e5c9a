"""Training step construction: loss, microbatching, remat, CARMEN modes
(port of ``repro.train.train_loop``).

``make_train_step`` returns a function ``(params, opt_state, batch) ->
(params, opt_state, metrics)`` that leaves its inputs untouched: the
gradient is taken with ``torch.autograd.grad`` on detached aliases of the
parameters, and AdamW returns new tensors. The step is deterministic given
(params, opt_state, batch): together with the stateless data pipeline a
restarted trainer replays identically, and ``train/checkpoint.py`` carries
the rest. The step runs under ``torch.use_deterministic_algorithms(True)``
(warn-only, so that cuBLAS, deterministic on one stream, runs without
``CUBLAS_WORKSPACE_CONFIG``): the embedding's and the cross-entropy's
scatters then sum in a fixed order on a card and on a multi-threaded CPU
alike, and remat changes no bit of a step.

The modes train as the reference's: ``exact`` in f32; ``carmen`` through
the straight-through product (``core/backends/carmen.CarmenSTE``); ``int8``
through the MAC-array kernel, whose gradient reaches only the scales
(``kernels/cordic_mac.mac_matmul_scaled_grad``). Attention runs the
``"xla"`` chains (``EngineContext.attn_impl``), as in the reference's
trainer: neither flash kernel has a backward.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Optional

import torch

from repro_torch.core.backends.base import PreparedWeight
from repro_torch.core.engine import EngineContext
from repro_torch.models import ModelApi

from . import optimizer as opt
from ._tree import leaves_like, tree_leaves, tree_unflatten

__all__ = ["TrainConfig", "cross_entropy", "deterministic", "make_eval_step", "make_loss_fn",
           "make_train_step"]


def _check_trainable(params):
    """QAT trains raw float weights through the per-call quantization path;
    prepared weight banks (``prepare_params``) are inference-only."""
    def walk(node):
        if isinstance(node, dict):
            return any(walk(v) for v in node.values())
        return isinstance(node, PreparedWeight)

    if walk(params):
        raise ValueError(
            "train_step received prepared weight banks — training (QAT) "
            "requires raw float params; prepare_params is for inference "
            "(use make_eval_step to evaluate prepared trees)")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: opt.AdamWConfig = dataclasses.field(default_factory=opt.AdamWConfig)
    microbatches: int = 1  # gradient accumulation steps inside one train_step
    remat: bool = True
    lb_loss_weight: float = 0.01  # MoE load-balance aux
    z_loss_weight: float = 1e-4  # logit z-loss (stabilizes large-vocab training)


def cross_entropy(logits, targets, *, z_loss_weight: float = 0.0):
    """Mean CE over all positions; f32; optional z-loss."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, targets[..., None].to(torch.int64))[..., 0]
    nll = (lse - true_logit).mean()
    if z_loss_weight:
        nll = nll + z_loss_weight * torch.square(lse).mean()
    return nll


def make_loss_fn(model: ModelApi, ctx: EngineContext, tcfg: TrainConfig):
    cfg = model.cfg

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch, ctx, remat=tcfg.remat)
        targets = batch["targets"]
        logits = logits[:, -targets.shape[1]:]  # frontend positions carry no loss
        loss = cross_entropy(logits, targets, z_loss_weight=tcfg.z_loss_weight)
        if cfg.moe:
            loss = loss + tcfg.lb_loss_weight * aux.get("lb_loss", 0.0)
        return loss, {"ce_loss": loss}

    return loss_fn


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the backward pass: on a card and on a
    CPU running several threads, the embedding's ``index_put_`` accumulates
    in an order fixed by a sort instead of by atomics. Warn-only,
    uninitialized memory left unfilled, the cuBLAS workspace warning
    silenced. The previous settings come back on exit."""
    import torch.utils.deterministic as det

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CUBLAS_WORKSPACE_CONFIG.*")
            yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        det.fill_uninitialized_memory = was[2]


def _grad_fn(loss_fn):
    """``(params, batch) -> (loss, metrics, grads)``: grads in the params'
    tree shape, ``None`` where no path reaches a leaf."""
    def grad_fn(params, batch):
        flat = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        live = tree_unflatten(params, flat)
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(params, list(grads))

    return grad_fn


def make_train_step(model: ModelApi, ctx: EngineContext, tcfg: TrainConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    With ``microbatches > 1`` the global batch is split along axis 0 and
    the gradients are accumulated one microbatch after another into one f32
    sum, so no two microbatches' gradients coexist.
    """
    grad_fn = _grad_fn(make_loss_fn(model, ctx, tcfg))

    def train_step(params, opt_state, batch):
        _check_trainable(params)
        device = tree_leaves(params)[0].device
        with deterministic():
            if tcfg.microbatches > 1:
                mb = tcfg.microbatches

                def split(x, i):
                    b = x.shape[0]
                    return x.reshape(mb, b // mb, *x.shape[1:])[i]

                acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                       for p in tree_leaves(params)]
                loss_sum = torch.zeros((), dtype=torch.float32, device=device)
                for i in range(mb):
                    loss, _, grads = grad_fn(params, {k: split(v, i) for k, v in batch.items()})
                    for a, g in zip(acc, leaves_like(params, grads)):
                        if g is not None:
                            a.add_(g)
                    del grads
                    loss_sum = loss_sum + loss
                loss = loss_sum / torch.full_like(loss_sum, mb)
                grads = tree_unflatten(params, [a / torch.full_like(a, mb) for a in acc])
                metrics = {"ce_loss": loss}
            else:
                loss, metrics, grads = grad_fn(params, batch)
            params, opt_state, om = opt.apply_updates(params, grads, opt_state, tcfg.optimizer)
        metrics = dict(metrics, **om, loss=loss)
        return params, opt_state, metrics

    return train_step


def make_eval_step(model: ModelApi, ctx: EngineContext, tcfg: Optional[TrainConfig] = None):
    """(params, batch) -> metrics; gradient-free, so prepared weight banks
    (``prepare_params``) evaluate on their serving fast path."""
    loss_fn = make_loss_fn(model, ctx, tcfg or TrainConfig(remat=False))

    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = loss_fn(params, batch)
        return dict(metrics, loss=loss)

    return eval_step
