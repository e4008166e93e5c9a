"""Cost analyzer of one step: the PyTorch counterpart of the reference's
``repro/launch/hlo_analysis.py``.

The reference parses the optimized HLO of a compiled step. The port has no
HLO: it runs the step eagerly, on the card or on meta tensors (which move no
data and need no card), under a ``TorchDispatchMode`` that reads every aten
op the step dispatches, and takes from the kernel wrappers one record a
hand-written kernel call (``kernels.kernel_call``: the kernel, its
instantiation and its ``kernels/costs.py`` cost). The aten ops a wrapper
dispatches on its own are skipped (``kernels.entry``). The fields of
:class:`Costs` keep the reference's names:

* ``dot_flops``: 2 * M * N * K of every matmul (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``_int_mm``, ``mv``, ``dot``: what ``matmul``, ``einsum``
  and ``linear`` dispatch), and the kernels' multiply-adds;
* ``hbm_bytes``: the fused model. A tensor is *materialized* when it comes
  from outside the step (a parameter, an input, a cache) or from an op that
  is neither pointwise nor a cast, copy or fill (a matmul, a reduction, a
  norm, a concatenation, a gather or scatter, a kernel): each op charges
  the materialized tensors it reads, and a materializing op its output;
  pointwise chains fuse into their consumers and move nothing more. A step
  output that is still unmaterialized at the end is charged its write.
  Every charge is one the literal model also makes, so ``hbm_bytes <=
  hbm_bytes_upper``; every read of a parameter or a cache row is charged;
* ``hbm_bytes_upper``: the literal eager model, the operands and results of
  every op that is not a view;
* ``collective_bytes`` and ``collective_by_kind``: the result bytes of the
  c10d collectives (functional and in-place), under the reference's kind
  names;
* the port's additions: ``ops_by_kind`` (matmul flops by the rate that
  bounds them: f32, bf16 or int8, and the kernels' work by kind, for the
  roofline) and ``kernels`` (calls by ``"<kernel>/<instantiation>"``) with
  ``kernel_costs`` (bytes, flops and ops summed by kernel).

A view reads or writes only the elements it spans (a layer's slice of a
stacked weight is charged once, a broadcast dimension once). Eager torch has
no ``while``: every loop iteration dispatches its own ops, so the
reference's trip-count correction (``while_trips``) has nothing to do here
and is left out.

The analyzer also tracks the live bytes of the storages the step creates,
through weak references: their peak is the record's ``temp_size_in_bytes``.

:func:`analyze` runs a step under the mode. Its op trace (one record an op
or kernel call) can be saved as gzipped JSONL (:func:`save_trace`), which is
what the reference's saved HLO is to ``reanalyze``: :func:`summarize`
rebuilds the :class:`Costs` from it.
"""
from __future__ import annotations

import dataclasses
import gzip
import json
from typing import Dict, List, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels

TRACE_FORMAT = "carmen-torch-ops v1"

# c10d ops (functional and in-place) by the reference's collective kinds
_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "c10d_functional")

# ops that fuse like pointwise ones without the tag: casts, copies, fills
_FUSIBLE = {"_to_copy", "clone", "copy", "copy_", "fill", "fill_", "zero_", "lift_fresh",
            "lift_fresh_copy", "masked_fill", "masked_fill_", "where", "_local_scalar_dense"}

_MATMULS = {"mm", "addmm", "bmm", "baddbmm", "_int_mm", "mv", "addmv", "dot", "vdot"}
# allocations: no data moves
_EMPTY = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
# gathers read only the rows they return from their first operand (an
# embedding lookup does not read the whole table)
_GATHERS = {"embedding", "index", "index_select", "gather", "take"}
# scatters read and write only the rows they update in their first operand
# (a cache row write does not move the whole cache): as many elements as
# their last tensor operand (the values, or the index where a scalar is
# scattered)
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "index_copy", "index_copy_",
             "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
             "scatter_reduce_", "index_add", "index_add_"}


def _span_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` spans: a broadcast (stride 0) dimension once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _kind(dtype: torch.dtype) -> str:
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    return "f32"


def matmul_flops(name: str, args) -> float:
    """2 x the multiply-adds of a matmul-family aten op, from its operands."""
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    if name in ("addmm", "baddbmm", "addmv"):
        ts = ts[1:]  # the added term
    a, b = ts[0], ts[1]
    if name in ("dot", "vdot"):
        return 2.0 * a.shape[0]
    if name in ("mv", "addmv"):
        return 2.0 * a.shape[0] * a.shape[1]
    if name in ("bmm", "baddbmm"):
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


@dataclasses.dataclass
class Costs:
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0  # fused model
    hbm_bytes_upper: float = 0.0  # literal model: every op materializes
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    hbm_by_cat: Dict[str, float] = dataclasses.field(default_factory=dict)
    ops_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_costs: Dict[str, Dict] = dataclasses.field(default_factory=dict)

    def _add(self, table: Dict, key: str, v: float) -> None:
        if v:
            table[key] = table.get(key, 0.0) + v

    def kernel_totals(self) -> Dict[str, int]:
        """Kernel calls by kernel (the instantiations summed)."""
        return kernels.kernel_totals(self.kernels)


def summarize(records: List[dict]) -> Costs:
    """The :class:`Costs` of an op trace (:attr:`Analyzer.records`)."""
    c = Costs()
    for r in records:
        if "kernel" in r:
            key = f"{r['kernel']}/{r['inst']}"
            c.kernels[key] = c.kernels.get(key, 0) + 1
            c.dot_flops += r["flops"]
            c.hbm_bytes += r["bytes"]
            c.hbm_bytes_upper += r["bytes"]
            c._add(c.hbm_by_cat, "kernel", r["bytes"])
            for kind, v in r["ops"].items():
                c._add(c.ops_by_kind, kind, v)
            kc = c.kernel_costs.setdefault(r["kernel"], dict(calls=0, hbm_bytes=0.0,
                                                             dot_flops=0.0, ops_by_kind={}))
            kc["calls"] += 1
            kc["hbm_bytes"] += r["bytes"]
            kc["dot_flops"] += r["flops"]
            for kind, v in r["ops"].items():
                kc["ops_by_kind"][kind] = kc["ops_by_kind"].get(kind, 0.0) + v
            continue
        c.dot_flops += r.get("flops", 0.0)
        if r.get("flops"):
            c._add(c.ops_by_kind, r["kind"], r["flops"])
        c.hbm_bytes += r["bytes"]
        c.hbm_bytes_upper += r["bytes_upper"]
        c._add(c.hbm_by_cat, r["cat"], r["bytes"])
        if r.get("coll"):
            c.collective_bytes += r["coll_bytes"]
            c._add(c.collective_by_kind, r["coll"], r["coll_bytes"])
    return c


class Analyzer(TorchDispatchMode):
    """Reads the aten ops and kernel calls of the code run under it (see the
    module docstring). ``records`` is the op trace; :meth:`costs` sums it;
    ``argument_bytes``, ``peak_temp_bytes`` and ``output_bytes`` are the
    memory of the step passed to :meth:`run`."""

    def __init__(self):
        super().__init__()
        self.records: List[dict] = []
        self._in_kernel = 0
        self._materialized: Dict[int, bool] = {}  # storage id -> materialized
        self._live: Dict[int, tuple] = {}  # storage id -> (weak ref, bytes)
        self.live_bytes = 0
        self.peak_temp_bytes = 0
        self.argument_bytes = 0
        self.output_bytes = 0

    # -- the kernel wrappers' hooks (kernels.entry, kernels.kernel_call) ------
    def enter_kernel(self) -> None:
        self._in_kernel += 1

    def exit_kernel(self) -> None:
        self._in_kernel -= 1

    def kernel(self, name: str, instantiation: str, cost) -> None:
        self.records.append(dict(kernel=name, inst=instantiation, bytes=float(cost.hbm_bytes),
                                 flops=float(cost.dot_flops), ops=cost.ops_by_kind(),
                                 bound_ms=cost.bound()[0]))

    def kernel_output(self, out) -> None:
        for t in _tensors(out):
            self._created(t, materialized=True)

    # -- storage bookkeeping ---------------------------------------------------
    def _sweep(self) -> None:
        dead = [sid for sid, (ref, _) in self._live.items() if ref.expired()]
        for sid in dead:
            self.live_bytes -= self._live.pop(sid)[1]
            self._materialized.pop(sid, None)

    def _created(self, t: torch.Tensor, materialized: bool) -> None:
        ref = StorageWeakRef(t.untyped_storage())
        sid = ref.cdata
        self._materialized[sid] = materialized
        if sid not in self._live:
            nbytes = t.untyped_storage().nbytes()
            self._live[sid] = (ref, nbytes)
            self.live_bytes += nbytes
            self.peak_temp_bytes = max(self.peak_temp_bytes, self.live_bytes)

    def is_materialized(self, t: torch.Tensor) -> bool:
        """Outside the step (unknown storage) or made by a materializing op."""
        return self._materialized.get(StorageWeakRef(t.untyped_storage()).cdata, True)

    # -- the dispatch hook -----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._in_kernel:
            return out
        self._sweep()
        self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        schema = func._schema
        name = func._overloadpacket.__name__
        namespace = func.namespace
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_storages = {StorageWeakRef(t.untyped_storage()).cdata for t in ins}
        written = [a.name for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write]
        aliasing = all(StorageWeakRef(t.untyped_storage()).cdata in in_storages for t in outs)
        if (func.is_view or (aliasing and not written)) and namespace not in _COLLECTIVE_NAMESPACES:
            return  # a view or a metadata op: no data moves
        if name in _EMPTY:
            for t in outs:
                self._created(t, materialized=False)
            return
        # factories (no tensor operand) fuse like fills
        fusible = torch.Tag.pointwise in func.tags or name in _FUSIBLE or not ins
        in_bytes = [_span_bytes(t) for t in ins]
        out_bytes = [_span_bytes(t) for t in outs]
        if name in _GATHERS and outs:
            in_bytes[0] = min(in_bytes[0], out_bytes[0])
        if name in _SCATTERS:
            rows = ins[-1].numel() * ins[0].element_size()
            accumulate = (kwargs.get("accumulate", len(args) > 3 and args[3] is True)
                          if name.startswith(("index_put", "_index_put")) else
                          name.startswith(("index_add", "scatter_add", "scatter_reduce")))
            in_bytes[0] = rows if accumulate else 0
            out_bytes = [rows for _ in outs]
        rec = dict(op=str(func), ins=[_desc(t) for t in ins], outs=[_desc(t) for t in outs])
        reads = sum(b for t, b in zip(ins, in_bytes) if self.is_materialized(t))
        literal = sum(in_bytes) + sum(out_bytes)
        writes = 0
        for t, b in zip(outs, out_bytes):
            sid = StorageWeakRef(t.untyped_storage()).cdata
            if sid in in_storages:  # written in place (or out=)
                if not fusible or self._materialized.get(sid, True):
                    self._materialized[sid] = True
                    writes += b
            else:
                self._created(t, materialized=not fusible)
                if not fusible:
                    writes += b
        rec.update(bytes=reads + writes, bytes_upper=literal,
                   cat="elementwise" if fusible else "materialize")
        if name in _MATMULS and namespace == "aten":
            rec.update(flops=matmul_flops(name, args), kind=_kind(ins[-1].dtype), cat="dot")
        if namespace in _COLLECTIVE_NAMESPACES and name in _COLLECTIVES:
            coll = sum(t.numel() * t.element_size() for t in outs)
            rec.update(coll=_COLLECTIVES[name], coll_bytes=coll, bytes=2 * coll,
                       bytes_upper=2 * coll, cat="collective")
        self.records.append(rec)

    # -- a step ----------------------------------------------------------------
    def run(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` under the analyzer: the arguments' bytes,
        the peak of the bytes the step keeps live, its outputs' bytes, and
        the write of any output still unmaterialized at the end."""
        self.argument_bytes = _storage_bytes(_tensors((args, kwargs)))
        with self:
            out = fn(*args, **kwargs)
        self._sweep()
        outs = _tensors(out)
        self.output_bytes = _storage_bytes(outs)
        pending = [t for t in outs if not self.is_materialized(t)]
        if pending:
            b = sum(_span_bytes(t) for t in pending)
            self.records.append(dict(op="<output write>", ins=[], outs=[_desc(t) for t in pending],
                                     bytes=b, bytes_upper=0, cat="output"))
        return out

    def __enter__(self):
        kernels._listeners.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            kernels._listeners.remove(self)

    def costs(self) -> Costs:
        return summarize(self.records)

    def memory(self) -> Dict[str, int]:
        """The reference's memory keys: arguments, outputs and the peak of
        the step's own live bytes (``temp_size_in_bytes``)."""
        return dict(argument_size_in_bytes=self.argument_bytes,
                    output_size_in_bytes=self.output_bytes,
                    temp_size_in_bytes=self.peak_temp_bytes)


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a pytree, those in dataclass leaves (a prepared weight
    bank's payload, point and scale) included."""
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            out.extend(_tensors([getattr(x, f.name) for f in dataclasses.fields(x)]))
    return out


def _storage_bytes(ts) -> int:
    seen: Dict[int, int] = {}
    for t in ts:
        seen[StorageWeakRef(t.untyped_storage()).cdata] = t.untyped_storage().nbytes()
    return sum(seen.values())


def _desc(t: torch.Tensor) -> list:
    return [list(t.shape), str(t.dtype).removeprefix("torch.")]


def analyze(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a fresh :class:`Analyzer`; returns
    ``(analyzer, out)``."""
    an = Analyzer()
    out = an.run(fn, *args, **kwargs)
    return an, out


def record_key(rec: dict) -> tuple:
    """What two runs of one step must agree on, op for op: the op or kernel,
    shapes, dtypes, flops and bytes."""
    if "kernel" in rec:
        return ("kernel", rec["kernel"], rec["inst"], rec["flops"], rec["bytes"])
    return (rec["op"], json.dumps(rec["ins"]), json.dumps(rec["outs"]), rec.get("flops", 0.0),
            rec["bytes"], rec["bytes_upper"])


def first_difference(a: List[dict], b: List[dict]) -> Optional[str]:
    """``None`` when two traces agree op for op, else where they first differ."""
    for i, (x, y) in enumerate(zip(a, b)):
        if record_key(x) != record_key(y):
            return f"record {i}: {x} != {y}"
    if len(a) != len(b):
        return f"{len(a)} records != {len(b)}"
    return None


def save_trace(path: str, records: List[dict], header: Optional[dict] = None) -> None:
    """The op trace as gzipped JSONL: a header line, then one record a line."""
    with gzip.open(path, "wt") as f:
        f.write(json.dumps(dict(format=TRACE_FORMAT, **(header or {}))) + "\n")
        for r in records:
            f.write(json.dumps(r) + "\n")


def load_trace(path: str):
    """``(header, records)`` of a trace written by :func:`save_trace`."""
    with gzip.open(path, "rt") as f:
        lines = [json.loads(line) for line in f if line.strip()]
    if not lines or lines[0].get("format") != TRACE_FORMAT:
        raise ValueError(f"{path}: not a {TRACE_FORMAT} trace")
    return lines[0], lines[1:]

