"""Checkpoint/restore with atomic manifests (port of
``repro.train.checkpoint``).

Layout (one directory per step), the reference's::

    ckpt_dir/
      step_00000123.tmp/...    (in-flight writes)
      step_00000123/
        manifest.json          {step, num_leaves, shapes, dtypes, treedef}
        leaf_00000.npy ...     one file per tree leaf

Leaves are numbered in JAX's flatten order (dict keys sorted;
``AdamWState`` as ``(step, m, v)``), so a checkpoint either package writes
restores in the other.

* **atomic**: leaves are written into a ``.tmp`` directory, renamed only
  after the manifest is fsync'd; a crash mid-save leaves the previous
  checkpoint intact and the partial directory ignored.
* **async**: ``save(..., background=True)`` snapshots the leaves to host
  memory at once and writes them in a thread, overlapping the next step.

``restore`` places the leaves on ``device`` (default: each like-leaf's
device).

**On a mesh** (``shardings``: the tree's ``partition.TreeShardings``, each
leaf this rank's shard): ``save`` gathers every leaf whole over the axes its
spec shards, only rank 0 writes, and the ranks meet at a barrier before it
returns (``background=True`` still gathers and snapshots at once), so the
layout is the reference's whatever the mesh. ``restore(..., shardings=)``
loads the whole leaves and keeps this rank's shard of each: the reference's
elastic reshard, so a checkpoint written on any mesh (or on none) restores
on any other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.partition import gather_tensor, local_shape, shard_tensor

from ._tree import leaves_with_specs, tree_leaves, tree_unflatten

__all__ = ["latest_step", "restore", "save"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise ValueError("bfloat16 leaves have no numpy dtype; checkpoint f32 trees")
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _treedef(tree) -> str:
    """A readable description of the tree's structure (informational, as
    the reference's ``str(treedef)``; restore checks the leaf count)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (f"{type(tree).__name__}("
                + ", ".join(f"{f}={_treedef(v)}" for f, v in zip(tree._fields, tree)) + ")")
    return "*"


def _pairs(tree, shardings):
    if shardings is None:
        return [(x, None) for x in tree_leaves(tree)]
    return leaves_with_specs(tree, shardings.specs)


def save(ckpt_dir: str, step: int, tree, *, background: bool = False, shardings=None):
    """Write ``tree`` as step ``step``; returns the writer thread when
    ``background`` (join it before reading the checkpoint), else None.
    ``shardings``: ``tree`` holds this rank's shards on that placement's
    mesh; every rank must call, rank 0 writes."""
    mesh = shardings.mesh if shardings is not None else None
    lead = mesh is None or mesh.rank == 0
    host = []
    for x, spec in _pairs(tree, shardings):  # snapshot (device -> host), a leaf at a time
        whole = x if spec is None else gather_tensor(x, spec, mesh)
        if lead:
            host.append(_host(whole))
        del whole
    treedef_str = _treedef(tree)

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for i, arr in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest = {
            "step": step,
            "num_leaves": len(host),
            "shapes": [list(a.shape) for a in host],
            "dtypes": [str(a.dtype) for a in host],
            "treedef": treedef_str,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    thread = None
    if lead and background:
        thread = threading.Thread(target=_write, daemon=False)
        thread.start()
    elif lead:
        _write()
    if mesh is not None and mesh.device_mesh is not None:
        dist.barrier()
    return thread


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete step in ``ckpt_dir`` (None when there is none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name[5:]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree, *, device=None, shardings=None):
    """The tree saved as ``step``, shaped like ``like_tree``, each leaf on
    ``device`` (default: the like-leaf's device) with the saved dtype. With
    ``shardings`` (``like_tree``'s placement; its leaves are this rank's
    shards) each leaf is this rank's shard of the saved whole one."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    pairs = _pairs(like_tree, shardings)
    if manifest["num_leaves"] != len(pairs):
        raise ValueError(f"{path}: {manifest['num_leaves']} leaves saved, the tree has "
                         f"{len(pairs)}: the tree structure changed")
    leaves = []
    for i, (like, spec) in enumerate(pairs):
        arr = torch.from_numpy(np.array(np.load(os.path.join(path, f"leaf_{i:05d}.npy")),
                                        order="C"))
        if spec is not None:
            want = local_shape(arr.shape, spec, shardings.mesh)
            if tuple(like.shape) != want:
                raise ValueError(f"{path}: leaf {i} is {tuple(arr.shape)}, whose shard under "
                                 f"{spec} is {want}, not the tree's {tuple(like.shape)}")
            arr = shard_tensor(arr, spec, shardings.mesh)
        dev = device if device is not None else getattr(like, "device", "cpu")
        leaves.append(arr.to(dev))
    return tree_unflatten(like_tree, leaves)
