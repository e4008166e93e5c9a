#!/usr/bin/env python3
"""Why an int8 train step on a (1, 2) mesh, run from its own first step,
parts from mesh=None's second step by ~3e-4 of the loss on an H100.

    python3 benchmarks/int8_mesh_probe.py

Two gloo ranks share the card, as in ``chip_smoke.py``'s train_tp phase:
full-width olmo-1b (16 layers, f32, seeded random weights, batch 8 x seq 64,
remat on) in the int8 mode. Rank 0 runs two steps on mesh=None; both ranks
then run the same two steps on (1, 2), and rank 0 gathers the meshed
parameters after the first step whole. Rank 0 then reads the loss of the
second step's batch on mesh=None (a forward, no update) at four parameter
sets:

* ``A``: mesh=None's parameters after the first step;
* ``B``: the meshed parameters after the first step;
* ``C``: ``B`` with every weight channel whose int8 scale (the max of |w|
  over the channel's contraction axes) differs from ``A``'s reset to
  ``A``'s values, the rest left as ``B``;
* ``D``: ``A`` with those channels taken from ``B``;
* ``E``: ``A`` with the embedding taken from ``B``;
* ``F``: ``A`` with as many channels of each weight as ``B`` requantized,
  chosen at random (seeded), each channel's largest |w| moved one ulp away
  from zero: a change of the same size that no mesh made.

If the gap comes from those requantized channels alone, ``C``'s loss is
``A``'s and ``D``'s is ``B``'s; ``B``'s is also the meshed run's second
loss if the meshed second step adds nothing of its own; ``F``'s distance
from ``A`` is what the int8 forward makes of ulp-sized changes. Prints one JSON
line and writes it to ``chiprun_out/int8_mesh_probe.json``. Needs a CUDA
card and no JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# each leaf's contraction axes in the int8 mode's products (the channel is
# the rest): the q/k/v banks (L, D, H, hd) and MLP banks contract D (or F),
# wo (L, H, hd, D) contracts H and hd, the tied head embed.T contracts D
K_AXES = {"embed": (1,), "wo": (1, 2)}


def k_axes(name: str) -> tuple:
    return K_AXES.get(name.rsplit("/", 1)[-1], (1,))


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def probe_rank(rank, world, cfg=None, device=None):
    """One rank of the probe: ``cfg`` defaults to full-width olmo-1b and
    ``device`` to the rank's card."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.mesh import mesh_from_shape
    from repro_torch.launch.train import engine_ctx
    from repro_torch.models import get_model
    from repro_torch.sharding.partition import gather_tensor, train_shardings
    from repro_torch.train import optimizer as opt
    from repro_torch.train._tree import leaves_with_specs, tree_leaves, tree_unflatten
    from repro_torch.train.train_loop import TrainConfig, make_loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = device or torch.device("cuda", torch.cuda.current_device())
    cfg = cfg or cs.olmo()
    model = get_model(cfg)
    pipe = TokenPipeline(cfg, cs.TRAIN_SEQ, cs.TRAIN_BATCH, device=device)
    mesh = mesh_from_shape((1, 2))
    sh = train_shardings(model.serving_specs(), mesh)

    def init(m=None):
        params = model.init(torch.Generator(device=device).manual_seed(cs.SEED), torch.float32,
                            mesh=m)
        return params, opt.init_state(params)

    out = {}
    if rank == 0:  # mesh=None
        step_fn = cs.train_step_fn(cfg, "int8", 2)
        params, state = init()
        params, state, met = step_fn(params, state, pipe.batch(0))
        a = [t.to("cpu") for t in tree_leaves(params)]
        _, _, met1 = step_fn(params, state, pipe.batch(1))
        out["mesh_none_losses"] = [float(met["loss"]), float(met1["loss"])]
        del params, state, step_fn
        cs.free_card()
    dist.barrier()

    step_fn = cs.train_step_fn(cfg, "int8", 2, mesh=mesh)
    params, state = init(mesh)
    params, state, met = step_fn(params, state, pipe.batch(0))
    b = [gather_tensor(t, spec, mesh).to("cpu")
         for t, spec in leaves_with_specs(params, sh.specs)]
    _, _, met1 = step_fn(params, state, pipe.batch(1))
    out["mesh_losses"] = [float(met["loss"]), float(met1["loss"])]
    del params, state, step_fn
    cs.free_card()
    if rank != 0:
        return out

    template = model.abstract_params()
    names = [n for n, _ in named_leaves(template)]
    mixed_c, mixed_d, embed_e, nudged_f, channels = [], [], [], [], {}
    gen = torch.Generator().manual_seed(cs.SEED)
    for name, x, y in zip(names, a, b):
        dims = k_axes(name)
        amax = torch.amax(x.abs(), dim=dims, keepdim=True)
        moved = amax != torch.amax(y.abs(), dim=dims, keepdim=True)
        channels[name] = dict(requantized=int(moved.sum()), of=int(moved.numel()),
                              elements_differ=int((x != y).sum()),
                              max_abs_diff=float((x - y).abs().max()))
        mixed_c.append(torch.where(moved, x, y))
        mixed_d.append(torch.where(moved, y, x))
        embed_e.append(y if name == "embed" else x)
        chosen = torch.zeros(moved.numel(), dtype=torch.bool)
        chosen[torch.randperm(moved.numel(), generator=gen)[:int(moved.sum())]] = True
        at = (x.abs() == amax) & chosen.reshape(moved.shape)
        nudged_f.append(torch.where(at, torch.nextafter(x, x.sign() * float("inf")), x))

    ctx = engine_ctx("int8")
    loss_fn = make_loss_fn(model, ctx, TrainConfig(remat=False))
    batch = pipe.batch(1)

    def loss_at(leaves):
        with torch.no_grad():
            p = tree_unflatten(template, [t.to(device) for t in leaves])
            loss = float(loss_fn(p, batch)[0])
        del p
        cs.free_card()
        return loss

    out["second_batch_loss_on_mesh_none"] = {k: loss_at(v) for k, v in
                                             (("A", a), ("B", b), ("C", mixed_c),
                                              ("D", mixed_d), ("E", embed_e),
                                              ("F", nudged_f))}
    out["channels"] = channels
    out["requantized_channels"] = sum(c["requantized"] for c in channels.values())
    out["leaves_differ"] = sum(c["elements_differ"] > 0 for c in channels.values())
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("int8_mesh_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn

    _build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    per_rank = spawn(probe_rank, 2, backend="gloo", device="cuda:0", timeout=900)
    rep = dict(per_rank[0], rank1_mesh_losses=per_rank[1]["mesh_losses"],
               card=card.strip().splitlines()[0])
    line = json.dumps(rep)
    print(line, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "int8_mesh_probe.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
