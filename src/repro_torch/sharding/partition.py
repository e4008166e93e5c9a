"""Logical-axis sharding rules -> partition specs, divisibility-aware (port of
``repro.sharding.partition``).

The paper's N-PE vector engine scales by adding lanes; on a cluster the lane
axis is the ``model`` mesh axis (TP/EP) and throughput scaling comes from
``(pod, data)`` (DP/FSDP). Rules map logical parameter axes to mesh axes; a
rule only applies when the dimension divides the mesh-axis extent, otherwise
the dimension falls back to replication, recorded by ``sharding_report``
(e.g. 40-head attention on a 16-way model axis replicates heads and relies on
FSDP for weight memory).

A partition spec is a plain tuple with one entry per leading dimension (a
mesh-axis name, a tuple of them, or None), trailing Nones dropped: the
entries of the reference's ``PartitionSpec`` for the same spec and mesh
shape. Every function reads only ``mesh.axis_names`` and ``mesh.shape`` (a
mapping from axis name to extent), so a duck-typed mesh works as well as
:class:`repro_torch.launch.mesh.Mesh`.

The reference binds its activation layouts to an ambient mesh
(``constrain``, ``current_mesh_axes``) and lets GSPMD insert the
collectives. The port has no GSPMD: the mesh is passed explicitly, as the
``mesh`` field of the ``EngineContext`` that model code already threads
through, and the model calls the collectives of ``sharding.collectives``
itself. ``constrain`` has therefore no counterpart, and ``use_2d_ep`` takes
the mesh as an argument.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.backends.base import PreparedWeight
from repro_torch.models.params import ParamSpec, tree_map_specs

__all__ = [
    "PARAM_RULES", "BATCH_AXES", "ServingShardings", "param_pspec", "param_shardings",
    "sharding_report", "prepared_shardings", "slot_pspec", "slot_shardings",
    "cache_shardings", "serving_shardings", "serving_sharding_report", "batch_pspec",
    "use_2d_ep", "axis_sizes", "local_index", "local_shape", "shard_tensor", "shard_params",
]

# logical axis -> ordered candidate mesh-axis groups (first that divides wins)
PARAM_RULES: Dict[Optional[str], Tuple[Tuple[str, ...], ...]] = {
    "vocab": (("model",),),
    "embed": (("pod", "data"), ("data",), ("pod",)),  # FSDP shard of the d_model dim
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head_dim": (),
    "mlp": (("model",),),
    "experts": (("model",),),  # model-axis EP
    "layers": (),
    "q_lora": (),
    "kv_lora": (),
    "ssm_inner": (("model",),),
    "ssm_heads": (("model",),),
    "ssm_state": (),
    "conv": (),
    "groups": (),
    "frames": (),
    None: (),
}

# activation/batch rules used by input and cache shardings
BATCH_AXES = ("pod", "data")


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: extent}`` of a mesh."""
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _entry(group):
    """One spec entry for a group of mesh axes, normalized as
    ``PartitionSpec`` normalizes it: one axis is its name, none is None."""
    group = tuple(group)
    return None if not group else group[0] if len(group) == 1 else group


def _extent(mesh, group) -> int:
    return int(math.prod(mesh.shape[a] for a in group))


def _resolve(axis_name: Optional[str], dim: int, mesh, report: list) -> Optional[Tuple[str, ...]]:
    for group in PARAM_RULES.get(axis_name, ()):  # ordered preference
        group = tuple(a for a in group if a in mesh.axis_names)
        if not group:
            continue
        extent = _extent(mesh, group)
        if dim % extent == 0:
            return group
        report.append((axis_name, dim, group, extent))
    return None


def param_pspec(spec: ParamSpec, mesh, report: Optional[list] = None) -> tuple:
    """The partition spec of one ParamSpec."""
    report = report if report is not None else []
    entries, used = [], set()
    for dim, ax in zip(spec.shape, spec.axes):
        group = _resolve(ax, dim, mesh, report)
        if group and not (set(group) & used):
            entries.append(_entry(group))
            used.update(group)
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def param_shardings(specs, mesh):
    """(tree of partition specs matching ``specs``, fallback report). The
    report lists the leaves in the reference's order: JAX flattens a dict by
    its sorted keys."""
    report: list = []

    def walk(node):
        if isinstance(node, dict):
            done = {k: walk(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        return param_pspec(node, mesh, report)

    return walk(specs), report


def sharding_report(specs, mesh):
    """(logical_axis, dim, group, extent) tuples for every replication fallback."""
    _, report = param_shardings(specs, mesh)
    return report


def _placement(leaf: PreparedWeight, spec: tuple) -> PreparedWeight:
    """The placement container of one prepared leaf: the payload takes the
    raw leaf's spec; the keepdims per-channel scale the entries of the axes it
    shares with the payload (size-1 axes replicate); the params vector is
    replicated."""
    scale = None
    if leaf.scale is not None:
        entries = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        scale = [entries[i] if leaf.scale.shape[i] == leaf.shape[i] else None
                 for i in range(leaf.scale.ndim)]
        while scale and scale[-1] is None:
            scale.pop()
        scale = tuple(scale)
    point = () if leaf.point is not None else None
    return PreparedWeight(spec, leaf.backend, point, scale, leaf.meta)


def prepared_shardings(params, specs, mesh, report: Optional[list] = None):
    """Partition specs for a serving param tree (raw or ``prepare_params``
    output): the tree's structure matches ``specs`` except that engine-routed
    matmul leaves may be :class:`PreparedWeight` containers (the result holds
    a PreparedWeight of specs there: payload, point, scale) and tied-embedding
    trees carry a synthesized transposed ``lm_head``, whose spec comes from
    the embedding spec with shape and axes reversed."""
    report = report if report is not None else []
    param_sh, rep = param_shardings(specs, mesh)
    report.extend(rep)
    if (isinstance(params, dict) and "lm_head" in params and isinstance(param_sh, dict)
            and "lm_head" not in param_sh):
        embed = specs["embed"]
        head_spec = ParamSpec(embed.shape[::-1], embed.axes[::-1])
        param_sh = dict(param_sh, lm_head=param_pspec(head_spec, mesh, report))

    def one(sh, leaf):
        if isinstance(sh, dict):
            return {k: one(sh[k], leaf[k]) for k in sh}
        return _placement(leaf, sh) if isinstance(leaf, PreparedWeight) else sh

    return one(param_sh, params)


def slot_pspec(shape, mesh) -> tuple:
    """Per-slot serving-state leaves (and KV slot axes): dim 0 over the batch
    axes when the slot count divides their extent; replicated otherwise."""
    axes = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
    extent = _extent(mesh, axes) if axes else 1
    if shape and axes and extent > 1 and shape[0] % extent == 0:
        return (_entry(axes),)
    return ()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def slot_shardings(state_tree, mesh):
    """Partition specs of the server's per-slot state."""
    return _map(lambda leaf: slot_pspec(tuple(leaf.shape), mesh), state_tree)


def cache_shardings(cache_tree, mesh, cfg=None, *, row_axis_len: Optional[int] = None):
    """KV caches: batch over (pod, data); kv_heads/model-dim over model when
    divisible. Layouts: attn (L, B, S, KV, hd) | mla latent (L, B, S, R) |
    ssm conv (L, B, W, C) / state (L, B, H, N, P).

    ``row_axis_len`` (the serving path passes ``max_len``) marks the sequence
    row axis: dim 2 of that extent is never model-sharded and the earliest
    remaining divisible dim wins (the heads or latent axis). Without it (the
    dry run) the largest trailing dim wins. Integer leaves (write indices)
    and 0/1-d leaves are replicated."""
    batch_axes = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
    batch_extent = _extent(mesh, batch_axes) if batch_axes else 1
    model_extent = int(mesh.shape["model"]) if "model" in mesh.axis_names else 1

    def one(leaf):
        shape = tuple(leaf.shape)
        if len(shape) <= 1:
            return ()
        if not leaf.dtype.is_floating_point:
            return ()
        entries: list = [None] * len(shape)
        if shape[1] % max(batch_extent, 1) == 0:
            entries[1] = _entry(batch_axes)
        best = None
        for i in range(2, len(shape)):
            if row_axis_len is not None and i == 2 and shape[i] == row_axis_len:
                continue  # the S row axis: decode writes here, never shard it
            if shape[i] % model_extent == 0 and shape[i] >= model_extent:
                if best is None:
                    best = i
                elif row_axis_len is None and shape[i] > shape[best]:
                    best = i
        if best is not None:
            entries[best] = "model"
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    return _map(one, cache_tree)


@dataclasses.dataclass
class ServingShardings:
    """Every placement the serving hot path needs, derived from one mesh:
    ``params`` matches the (possibly prepared) serving tree, ``cache`` the
    multi-slot KV cache as the port stores it, ``state`` the per-slot decode
    state; ``report`` collects every rule the divisibility fallback dropped."""

    mesh: object
    params: object
    cache: object
    state: object
    report: list = dataclasses.field(default_factory=list)

    def slots(self, shape) -> tuple:
        """Spec of a ``(slots, ...)`` emit buffer."""
        return slot_pspec(tuple(shape), self.mesh)

    def snapshot(self) -> Dict:
        return serving_sharding_report(self)


def serving_shardings(mesh, *, params, cache, state, specs, cfg=None,
                      max_len: Optional[int] = None) -> ServingShardings:
    """The serving placement bundle of ``BatchedServer(mesh=...)``."""
    report: list = []
    params_sh = prepared_shardings(params, specs, mesh, report=report)
    cache_sh = cache_shardings(cache, mesh, cfg, row_axis_len=max_len)
    state_sh = slot_shardings(state, mesh)
    return ServingShardings(mesh, params_sh, cache_sh, state_sh, report)


def _spec_str(spec) -> str:
    return "P(" + ", ".join(repr(e) for e in spec) + ")"


def _spec_entries(tree, prefix=()) -> Dict[str, str]:
    out: Dict[str, str] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_spec_entries(v, prefix + (str(k),)))
    else:
        out["/".join(prefix)] = _spec_str(tree)
    return out


def _param_specs(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _param_specs(v)
    elif isinstance(tree, PreparedWeight):
        for part in (tree.data, tree.scale, tree.point):
            if part is not None:
                yield part
    else:
        yield tree


def serving_sharding_report(sh: ServingShardings) -> Dict:
    """JSON-able placement summary of a serving mesh: ``dropped`` lists every
    rule the divisibility fallback rejected, ``params`` counts sharded vs
    replicated weight specs, ``cache``/``state`` give each leaf's spec."""
    specs = list(_param_specs(sh.params))
    n_sharded = sum(1 for s in specs if tuple(s))
    sizes = axis_sizes(sh.mesh)
    return {
        "mesh": sizes,
        "devices": int(math.prod(sizes.values())),
        "dropped": [{"axis": a, "dim": int(d), "mesh_axes": list(g), "extent": int(e)}
                    for a, d, g, e in sh.report],
        "params": {"sharded": n_sharded, "replicated": len(specs) - n_sharded},
        "cache": _spec_entries(sh.cache),
        "state": _spec_entries(sh.state),
    }


def batch_pspec(mesh, *, extra: Sequence[Optional[str]] = ()) -> tuple:
    axes = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
    return (_entry(axes), *extra)


def use_2d_ep(num_experts: int, mesh) -> bool:
    """True when experts divide the full (data x model) extent (weights are
    then fully local)."""
    sizes = axis_sizes(mesh) if mesh is not None else {}
    extent = sizes.get("data", 1) * sizes.get("model", 1)
    return extent > 1 and num_experts % extent == 0


# ---------------------------------------------------------------------------
# The port's placement (its device_put): a rank keeps the block of each leaf
# that its mesh coordinates select, every entry of the spec applied:
# ``model`` entries are tensor (and expert) parallelism, ``data`` entries the
# FSDP shard that ``collectives.gather_data`` all-gathers over the data group
# where a layer is used.
# ---------------------------------------------------------------------------


def _axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _applies(spec: tuple, mesh) -> bool:
    """Whether ``spec`` splits anything on ``mesh`` (an entry of extent > 1)."""
    return any(_extent(mesh, _axes(e)) > 1 for e in spec)


def local_index(shape, spec: tuple, mesh) -> tuple:
    """The slices of a leaf of global ``shape`` that this rank stores: along
    each dim, block ``c`` of ``extent``, with ``c`` this rank's row-major
    coordinate over the entry's axes."""
    idx = []
    for i, n in enumerate(shape):
        axes = _axes(spec[i] if i < len(spec) else None)
        extent, c = 1, 0
        for a in axes:
            extent, c = extent * int(mesh.shape[a]), c * int(mesh.shape[a]) + mesh.coord(a)
        idx.append(slice(c * (n // extent), (c + 1) * (n // extent)) if extent > 1
                   else slice(None))
    return tuple(idx)


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of this rank's shard of a leaf of global ``shape``."""
    return tuple(len(range(n)[i]) for n, i in zip(shape, local_index(shape, spec, mesh)))


def _shard(t, spec: tuple, shape: tuple, mesh):
    """``t`` (of global ``shape``, or already this rank's shard of it)
    sliced to this rank's shard; the slice is a view."""
    have = tuple(t.shape)
    if have == tuple(shape):
        return t[local_index(have, spec, mesh)] if _applies(spec, mesh) else t
    if have == local_shape(shape, spec, mesh):
        return t
    raise ValueError(f"a leaf of shape {have} is neither the whole {tuple(shape)} nor this "
                     f"rank's shard of it under {spec}")


def shard_tensor(t, spec: tuple, mesh, shape: Optional[tuple] = None):
    """This rank's shard of ``t`` (a contiguous copy where it slices, so the
    whole can be freed; ``t`` itself where the spec stores it whole or ``t``
    already is the shard). ``shape`` is the leaf's global shape (default
    ``t``'s)."""
    part = _shard(t, spec, tuple(t.shape) if shape is None else shape, mesh)
    return part if part is t else part.contiguous()


def _global_shapes(tree, specs):
    """Each leaf's global shape, the tied ``lm_head`` included."""
    shapes = tree_map_specs(lambda sp: tuple(sp.shape), specs)
    if isinstance(tree, dict) and "lm_head" in tree and "lm_head" not in shapes:
        shapes = dict(shapes, lm_head=tuple(specs["embed"].shape[::-1]))
    return shapes


def shard_params(tree, specs, mesh, memo: Optional[Dict[int, object]] = None):
    """A parameter tree (raw or prepared, tied ``lm_head`` included; whole,
    or already this rank's shards) -> this rank's shards. Slicing the raw
    tree and then preparing the shards (``prepare_params``) equals slicing
    the prepared tree, the signed-digit rounding being elementwise; the
    first never holds a whole prepared bank. A prepared payload is sliced
    and copied back into its layout (an integer bank K-major again, with its
    own K padding, through ``int_dot.to_k_major``; never a strided view,
    which the kernels refuse); its point vector is replicated, its
    per-channel scale sliced with its payload's channel axis. ``memo`` (id
    -> shard) shards a leaf shared between trees once, so aliasing survives
    placement."""
    from repro_torch.core.backends import iter_dot_weights

    memo = {} if memo is None else memo
    sh = prepared_shardings(tree, specs, mesh)
    shapes = _global_shapes(tree, specs)
    layout = {keys: (stacked, in_axes)
              for keys, _, _, stacked, in_axes in iter_dot_weights(tree, specs=specs)}

    def bank(leaf: PreparedWeight, spec: PreparedWeight, shape, keys) -> PreparedWeight:
        data = leaf.data
        part = _shard(data, spec.data, shape, mesh)
        if part is not data:
            if data.dtype.is_floating_point:
                data = part.contiguous()
            else:
                from repro_torch.kernels.int_dot import to_k_major

                stacked, in_axes = layout[keys]
                lead = tuple(part.shape[:stacked])
                k = math.prod(part.shape[stacked:stacked + in_axes])
                data = to_k_major(part.reshape(*lead, k, -1)).reshape(part.shape)
        if data is leaf.data:  # whole on every rank, or already this rank's shard
            return leaf
        scale = leaf.scale
        if scale is not None:
            scale_shape = tuple(n if s > 1 else 1 for n, s in zip(shape, scale.shape))
            scale = shard_tensor(scale, spec.scale, mesh, scale_shape)
        return PreparedWeight(data, leaf.backend, leaf.point, scale, leaf.meta)

    def walk(p, s, shape, keys):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k], shape[k], keys + (k,)) for k in p}
        if id(p) not in memo:
            memo[id(p)] = (bank(p, s, shape, keys) if isinstance(p, PreparedWeight)
                           else shard_tensor(p, s, mesh, shape))
        return memo[id(p)]

    return walk(tree, sh, shapes, ())
