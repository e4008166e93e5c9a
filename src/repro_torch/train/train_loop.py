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

**On a mesh** (``ctx.mesh``; the reference's step is the same program under
GSPMD on any mesh): the parameters and the AdamW moments are this rank's
shards (``partition.train_shardings`` of ``ModelApi.serving_specs()``;
``model.init(mesh=)`` or ``partition.shard_params`` makes them). Each data
rank takes its rows of the pipeline's global batch: with ``microbatches >
1`` the global batch is split first, as the reference splits it, and a
rank's rows of microbatch ``i`` are the data shard of that microbatch. A
rank's loss is its rows' mean (its z-loss likewise; the MoE's
load-balancing loss is the global batch's, ``ctx.batch_shards``) over the
data extent, so the data ranks' losses sum to the reference's loss over
the global batch, which ``metrics["loss"]`` reports on every rank. The
collectives carry the gradients (``sharding/collectives.py``): a leaf
stored FSDP-sharded over ``data`` gets its gradient summed over the data
ranks by its gather's backward, and every other leaf's gradient is summed
over ``data`` after the backward. AdamW then updates the shards
(``optimizer.apply_updates(shardings=)``).
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
from repro_torch.sharding import partition
from repro_torch.sharding.collectives import all_reduce

from . import optimizer as opt
from ._tree import leaves_like, leaves_with_specs, tree_leaves, tree_unflatten

__all__ = ["TrainConfig", "cross_entropy", "deterministic", "make_eval_step", "make_grad_fn",
           "make_loss_fn", "make_train_step"]


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


def _grad_fn(loss_fn, data_shards: int = 1):
    """``(params, batch) -> (loss, metrics, grads)``: grads in the params'
    tree shape, ``None`` where no path reaches a leaf. With ``data_shards >
    1`` the loss and metrics are the rank's share of the global batch's (its
    rows' value over the data extent), and so are the gradients."""
    def grad_fn(params, batch):
        flat = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        live = tree_unflatten(params, flat)
        loss, metrics = loss_fn(live, batch)
        if data_shards > 1:
            loss = loss / torch.full_like(loss, data_shards)
            metrics = {k: v / torch.full_like(v, data_shards) for k, v in metrics.items()}
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(params, list(grads))

    return grad_fn


def _mesh_setup(model: ModelApi, ctx: EngineContext):
    """The training context and placement on ``ctx.mesh``."""
    sh = partition.train_shardings(model.serving_specs(), ctx.mesh)
    ctx = dataclasses.replace(ctx, param_specs=sh.specs, batch_shards=ctx.mesh.size("data"))
    return ctx, sh


def _rows(x: torch.Tensor, mb: int, i: int, mesh) -> torch.Tensor:
    """Microbatch ``i`` of ``mb`` of the global batch ``x`` (split along axis
    0), then, on a mesh, this data rank's rows of it."""
    if mb > 1:
        x = x.reshape(mb, x.shape[0] // mb, *x.shape[1:])[i]
    d = mesh.size("data") if mesh is not None else 1
    if d > 1:
        n = x.shape[0] // d
        c = mesh.coord("data")
        x = x[c * n:(c + 1) * n]
    return x


def make_grad_fn(model: ModelApi, ctx: EngineContext, tcfg: TrainConfig):
    """``(params, batch) -> (loss, metrics, grads)``: the global batch's loss
    and the gradients a train step updates with (microbatches accumulated;
    on ``ctx.mesh`` this rank's shards of them, module docstring), under
    :func:`deterministic`. Returns the function and the parameters'
    placement (a ``partition.TreeShardings``, None without a mesh)."""
    mesh, sh = ctx.mesh, None
    if mesh is not None:
        ctx, sh = _mesh_setup(model, ctx)
    d = mesh.size("data") if mesh is not None else 1
    grad_fn = _grad_fn(make_loss_fn(model, ctx, tcfg), d)
    mb = tcfg.microbatches

    def data_sum(params, grads):
        """Every gradient whole on each data rank, summed over ``data``."""
        return tree_unflatten(params, [
            g if g is None or "data" in partition.sharded_axes(spec, mesh)
            else all_reduce(g, mesh, "data") for g, spec in leaves_with_specs(grads, sh.specs)])

    def grads_of(params, batch):
        _check_trainable(params)
        if sh is not None:
            partition.require_local(params, model.serving_specs(), sh, "training on a mesh")
        rows = batch["tokens"].shape[0]
        if rows % (mb * d):
            raise ValueError(f"a batch of {rows} rows does not split into {mb} microbatches "
                             f"over {d} data ranks")
        device = tree_leaves(params)[0].device
        with deterministic():
            if mb > 1:
                acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                       for p in tree_leaves(params)]
                loss_sum = torch.zeros((), dtype=torch.float32, device=device)
                for i in range(mb):
                    loss, _, grads = grad_fn(params, {k: _rows(v, mb, i, mesh)
                                                      for k, v in batch.items()})
                    for a, g in zip(acc, leaves_like(params, grads)):
                        if g is not None:
                            a.add_(g)
                    del grads
                    loss_sum = loss_sum + loss
                loss = loss_sum / torch.full_like(loss_sum, mb)
                grads = tree_unflatten(params, [a / torch.full_like(a, mb) for a in acc])
                metrics = {"ce_loss": loss}
            else:
                loss, metrics, grads = grad_fn(params, {k: _rows(v, 1, 0, mesh)
                                                        for k, v in batch.items()})
            if d > 1:  # the global batch's loss and gradients
                grads = data_sum(params, grads)
                loss = all_reduce(loss, mesh, "data")
                metrics = {k: all_reduce(v, mesh, "data") for k, v in metrics.items()}
        return loss, metrics, grads

    return grads_of, sh


def make_train_step(model: ModelApi, ctx: EngineContext, tcfg: TrainConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    With ``microbatches > 1`` the global batch is split along axis 0 and
    the gradients are accumulated one microbatch after another into one f32
    sum, so no two microbatches' gradients coexist. With ``ctx.mesh`` the
    step runs on this rank's shards and rows (module docstring); every rank
    of the mesh calls it with the same global batch.
    """
    grads_of, sh = make_grad_fn(model, ctx, tcfg)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grads_of(params, batch)
        params, opt_state, om = opt.apply_updates(params, grads, opt_state, tcfg.optimizer, sh)
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
