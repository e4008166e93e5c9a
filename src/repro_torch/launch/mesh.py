"""Device meshes over ``torch.distributed`` ranks, and the spawn helper that
starts them (port of ``repro.launch.mesh``).

One rank stands for one device of the reference's mesh. A :class:`Mesh`
wraps a ``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")`` (or ``("pod", "data", "model")``) over the process group's ranks
and gives what the port's sharding code reads: ``axis_names``, ``shape``
(axis -> extent), this rank's coordinate on each axis and the process group
of each axis. A mesh of one rank needs no process group: its collectives are
identities.

The backend is always the caller's choice, never a fallback: ``nccl`` for
one card a rank, ``gloo`` for ranks that share a card or run on the CPU.

:func:`spawn` starts ``world`` ranks as fresh processes (the ``spawn``
start method), each joining the group through a ``file://`` rendezvous in a
private temporary directory (no TCP port to race for), with one torch
thread a CPU rank and a ``timeout`` on every collective. It joins them with
a deadline and kills every rank as soon as one fails or the deadline
passes: a rank that dies inside a collective would otherwise leave the
others waiting in it.
"""
from __future__ import annotations

import datetime
import math
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_host_mesh", "make_production_mesh", "mesh_from_shape",
           "parse_mesh", "spawn"]

BACKENDS = ("gloo", "nccl")


class Mesh:
    """A device mesh over this process group's ranks (row-major: the last
    axis varies fastest, as ``jax.make_mesh`` lays devices out).

    ``device_mesh`` is the ``DeviceMesh`` (None for a mesh of one rank
    outside any process group); ``rank`` the global rank;
    :meth:`coord`, :meth:`size` and :meth:`group` read one axis.
    """

    def __init__(self, shape: Dict[str, int], *, device_mesh=None, rank: int = 0):
        self.shape = {a: int(n) for a, n in shape.items()}
        self.axis_names = tuple(self.shape)
        self.device_mesh = device_mesh
        self.rank = int(rank)
        strides, s = {}, 1
        for a in reversed(self.axis_names):
            strides[a] = s
            s *= self.shape[a]
        self._coords = {a: (self.rank // strides[a]) % self.shape[a] for a in self.axis_names}

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self._coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of ``axis`` (the ranks that differ only in their
        coordinate on it), or None where the axis has extent 1."""
        if self.size(axis) == 1:
            return None
        return self.device_mesh.get_group(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def mesh_from_shape(shape: Sequence[int], axes: Sequence[str] = ("data", "model")) -> Mesh:
    """The mesh of ``shape`` over the initialized process group (whose world
    size must equal the mesh's device count), or, for a one-rank mesh, with
    no process group at all. The ``DeviceMesh``'s device type follows the
    group's backend: ``cuda`` under NCCL, ``cpu`` under gloo (which moves
    tensors through the host wherever they lie)."""
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {tuple(axes)}")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} ranks, the process "
                         f"group has {world}")
    sizes = dict(zip(axes, shape))
    if not dist.is_initialized():
        return Mesh(sizes)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device_mesh = init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes))
    return Mesh(sizes, device_mesh=device_mesh, rank=dist.get_rank())


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The spec'd production shapes: 16x16 single-pod, 2x16x16 multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return mesh_from_shape(shape, axes)


def make_host_mesh(*, model: Optional[int] = None) -> Mesh:
    """(data, model) mesh over the process group's ranks.

    ``model=`` fixes the tensor-parallel extent (it must divide the rank
    count). By default the rank count is factored into the most square
    (data, model) split with ``model <= data``: 1 -> 1x1, 4 -> 2x2, 8 -> 4x2.
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    if model is None:
        model = max(d for d in range(1, n + 1) if n % d == 0 and d * d <= n)
    if model < 1 or n % model:
        raise ValueError(f"model={model} does not divide the {n} ranks")
    return mesh_from_shape((n // model, model))


def parse_mesh(text: str, world: Optional[int] = None) -> Tuple[int, int]:
    """``"DATA,MODEL"`` -> (data, model); ``"auto"`` factors ``world`` as
    :func:`make_host_mesh` does."""
    if text == "auto":
        n = world or 1
        model = max(d for d in range(1, n + 1) if n % d == 0 and d * d <= n)
        return n // model, model
    parts = text.split(",")
    if len(parts) != 2 or not all(p.strip().isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"--mesh takes DATA,MODEL (positive integers) or auto, got {text!r}")
    return int(parts[0]), int(parts[1])


# ---------------------------------------------------------------------------
# spawn
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, backend: str, init_file: str, timeout_s: float,
               device: str, fn: Callable, args: tuple, results) -> None:
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
            results.put((rank, "ok", out))
        finally:
            dist.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, "error", f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


def spawn(fn: Callable, world: int, *, args: tuple = (), backend: str = "gloo",
          device: str = "cpu", timeout: float = 300.0, collective_timeout: float = 120.0
          ) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` fresh processes joined in
    one process group of ``backend`` and return their results by rank.

    ``fn`` must be importable by name (a module-level function) and its
    result picklable. ``device`` is each rank's device: ``"cpu"``, a card
    such as ``"cuda:0"`` that the ranks share, or ``"cuda"``: rank r on card
    r (one card a rank, as NCCL needs). The ranks rendezvous
    through a file in a fresh temporary directory; a CPU rank runs one torch
    thread; a collective that waits longer than ``collective_timeout``
    seconds raises in its rank. The join has a deadline of ``timeout``
    seconds: when a rank fails or the deadline passes, every rank still
    alive is killed and this raises.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_rdzv_")
    results = ctx.Queue()
    devices = [f"cuda:{r}" if device == "cuda" else device for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, os.path.join(tmp, "rdzv"), collective_timeout,
                               devices[r], fn, args, results), daemon=True)
             for r in range(world)]
    out: Dict[int, Any] = {}
    error: Optional[str] = None
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world and error is None:
            left = deadline - time.monotonic()
            if left <= 0:
                error = f"spawn: {world - len(out)} of {world} ranks still running after " \
                        f"{timeout} s"
                break
            try:
                rank, status, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    error = f"spawn: rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                continue
            if status == "ok":
                out[rank] = payload
            else:
                error = f"spawn: rank {rank} raised {payload}"
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if error is not None and p.is_alive():
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if error is not None:
        raise RuntimeError(error)
    return [out[r] for r in range(world)]
