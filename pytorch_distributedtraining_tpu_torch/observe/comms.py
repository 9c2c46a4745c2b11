"""The collective inventory of a traced step: which collectives ran, on how
many elements, over how many ranks, and whether compute hid them.

Counterpart of ``pytorch_distributedtraining_tpu/observe/hlo.py``. Under
XLA the collectives of a step are a compiler decision, so JAX audits the
compiled HLO text; eager torch issues each one from Python or from DDP's
reducer, so the port audits what a ``torch.profiler`` trace recorded of
them. No HLO is parsed. The records come from, in this order:

- ``record_param_comms`` events: every c10d call on a backend that records
  them (NCCL) carries ``Collective name``, ``dtype``, ``In msg nelems``,
  ``Out msg nelems`` and ``Group size`` (the fields
  ``torch/profiler/_trace_validator.py`` requires of them);
- else the host's ``c10d::*`` ops, with the input shapes the session
  recorded (``observe.profiling`` records shapes). Gloo records no
  ``record_param_comms`` (torch 2.13 on the CPU), so this is the CPU tests'
  path. An all-gather's or reduce-scatter's group size is the ratio of its
  output and input elements; an all-reduce's is not in the op and comes
  from the caller (``group_size=``); a tensor list's element type is not
  either (its dtype is left empty, which ``observe.opcost.dtype_bytes``
  charges at 4 bytes, JAX's default).

Kinds are the HLO names, so the audits read the same as JAX's:
``all-reduce``, ``reduce-scatter``, ``all-gather``, ``all-to-all``,
``collective-permute`` (send/recv) and ``collective-broadcast``.

- :func:`collective_inventory` / :func:`wire_inventory` /
  :func:`counts` / :func:`max_all_reduce_elems` /
  :func:`has_logical_reduce_scatter`: JAX's audits over those records
  (torch's reduce-scatter is always literal: there is no CPU pipeline that
  leaves it as an all-reduce and a slice);
- :func:`hop_bytes`: a step's reduction bytes under ``TrainStep.
  comm_cost``'s hop convention;
- :func:`overlap_audit` / :func:`collectives_schedulable`: measured, not
  read from a schedule: the share of each NCCL kernel's span that compute
  kernels on another stream overlap.

Two of JAX's audits wait for their slices: ``hierarchy_audit`` (the
hierarchical-mesh slice) and ``pipeline_audit`` (the pipeline sub-slice of
the advanced-parallelism slice). Stdlib only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = [
    "CollectiveOp", "WireCollective", "OverlapFinding", "OverlapAudit", "collective_kind",
    "collective_inventory", "wire_inventory", "counts",
    "max_all_reduce_elems", "has_logical_reduce_scatter", "hop_bytes", "overlap_audit",
    "collectives_schedulable",
]

# (fragment of the lower-cased, underscore-free name, HLO kind), first hit wins
_KINDS = (
    ("allreduce", "all-reduce"),
    ("reducescatter", "reduce-scatter"),
    ("allgather", "all-gather"),
    ("alltoall", "all-to-all"),
    ("sendrecv", "collective-permute"),
    ("send", "collective-permute"),
    ("recv", "collective-permute"),
    ("broadcast", "collective-broadcast"),
)

# torch's element-type spellings (ScalarType names in record_param_comms,
# C++ names in a host op's input types) -> HLO dtype tokens
_DTYPES = {
    "float": "f32", "float32": "f32", "double": "f64", "float64": "f64",
    "bfloat16": "bf16", "c10::bfloat16": "bf16", "half": "f16", "c10::half": "f16",
    "float16": "f16", "long": "s64", "long int": "s64", "int64": "s64", "int": "s32",
    "int32": "s32", "short": "s16", "short int": "s16", "char": "s8", "signed char": "s8",
    "byte": "u8", "unsigned char": "u8", "bool": "pred",
    "float8_e4m3fn": "f8e4m3fn", "c10::float8_e4m3fn": "f8e4m3fn",
    "float8_e5m2": "f8e5m2", "c10::float8_e5m2": "f8e5m2",
}


def collective_kind(name: str) -> str | None:
    """The HLO kind of a collective named by torch: an NCCL kernel
    (``ncclDevKernel_AllReduce_Sum_f32_RING_LL``), a ``record_param_comms``
    collective name (``_reduce_scatter_base``) or a host op
    (``c10d::allreduce_``); None for anything else (a barrier, a
    non-collective kernel)."""
    low = name.lower().replace("_", "")
    for frag, kind in _KINDS:
        if frag in low:
            return kind
    return None


def _dtype_token(name: str) -> str:
    """The HLO dtype token of a torch element-type name ("" when unknown)."""
    return _DTYPES.get((name or "").strip().lower(), "")


@dataclass(frozen=True)
class CollectiveOp:
    """One collective of a traced step."""

    kind: str        # all-reduce | reduce-scatter | all-gather | ...
    max_elems: int   # the result's element count (the output message)
    line: str        # the event's name and fields, for failed asserts

    def __repr__(self) -> str:
        return f"CollectiveOp({self.kind}, {self.max_elems})"


@dataclass(frozen=True)
class WireCollective:
    """One collective with its wire dtype, its result elements, its input
    elements and its group size (None when the record does not say)."""

    kind: str
    dtype: str
    elems: int
    line: str
    in_elems: int = 0
    group_size: int | None = None

    def __repr__(self) -> str:
        return (f"WireCollective({self.kind}, {self.dtype}, {self.elems}, "
                f"group {self.group_size})")


def _numel(dims) -> int:
    """Elements of one shape (``[]``: a scalar, one element), or of a list
    of shapes (a tensor list's)."""
    if all(isinstance(d, int) for d in dims):
        return math.prod(dims)
    return sum(_numel(d) for d in dims if isinstance(d, list))


def _param_comms_record(e: dict) -> tuple | None:
    a = e.get("args", {})
    kind = collective_kind(str(a.get("Collective name", "")))
    if kind is None:
        return None
    group = a.get("Group size")
    return (kind, _dtype_token(str(a.get("dtype", ""))), int(a.get("Out msg nelems", 0)),
            int(a.get("In msg nelems", 0)), None if group is None else int(group))


def _host_op_record(e: dict, group_size: int | None) -> tuple | None:
    kind = collective_kind(e["name"])
    if kind is None:
        return None
    a = e.get("args", {})
    dims, types = a.get("Input Dims") or [], a.get("Input type") or []
    first = _numel(dims[0]) if dims else 0
    dtype = _dtype_token(types[0]) if types else ""
    # the _base ops and their single-tensor successors take (output, input)
    if kind in ("all-gather", "reduce-scatter", "all-to-all") and len(dims) > 1:
        out, inp = first, _numel(dims[1])
    else:  # in-place on a tensor (list): the result is the input
        out = inp = first
    group = group_size
    if kind == "all-gather" and inp:
        group = out // inp
    elif kind == "reduce-scatter" and out:
        group = inp // out
    return kind, dtype, out, inp, group


def _records(events, group_size: int | None = None) -> list[tuple]:
    """(kind, dtype, out elems, in elems, group size, event) of each
    collective, from ``record_param_comms`` where the trace has them, else
    from the host's ``c10d::`` ops."""
    comms = [e for e in events if e.get("name") == "record_param_comms" and "dur" in e]
    out = []
    if comms:
        for e in comms:
            rec = _param_comms_record(e)
            if rec is not None:
                out.append((*rec, e))
        return out
    for e in events:
        if e.get("cat") == "cpu_op" and str(e.get("name", "")).startswith("c10d::"):
            rec = _host_op_record(e, group_size)
            if rec is not None:
                out.append((*rec, e))
    return out


def _line(e: dict) -> str:
    return f"{e.get('name')} {e.get('args', {})}"


def collective_inventory(events, group_size: int | None = None) -> list[CollectiveOp]:
    """The traced collectives, in trace order, with their result sizes."""
    return [CollectiveOp(kind, out, _line(e))
            for kind, _, out, _, _, e in _records(events, group_size)]


def wire_inventory(events, group_size: int | None = None) -> list[WireCollective]:
    """The traced collectives with their wire dtypes, element counts and
    group sizes (``group_size`` stands in where a record has none)."""
    return [WireCollective(kind, dtype, out, _line(e), inp,
                           group if group is not None else group_size)
            for kind, dtype, out, inp, group, e in _records(events, group_size)]


def counts(events) -> dict[str, int]:
    """{kind: occurrences}: the one-line summary."""
    agg: dict[str, int] = {}
    for op in collective_inventory(events):
        agg[op.kind] = agg.get(op.kind, 0) + 1
    return agg


def max_all_reduce_elems(events) -> int:
    """The largest all-reduce result in the trace (0 when none)."""
    return max((op.max_elems for op in collective_inventory(events)
                if op.kind == "all-reduce"), default=0)


def has_logical_reduce_scatter(events, shard_elems: int | None = None) -> bool:
    """True when the trace reduce-scatters (to a ``shard_elems`` result,
    when given). torch's reduce-scatter is a collective of its own, so the
    literal form is the only one."""
    return any(op.kind == "reduce-scatter" and (shard_elems is None or op.max_elems == shard_elems)
               for op in collective_inventory(events))


def hop_bytes(wires) -> int:
    """Bytes of the reductions among ``wires`` under ``TrainStep.comm_cost``'s
    hop convention: an all-reduce moves its payload twice (reduce, then
    gather), a reduce-scatter its input once. All-gathers of parameters are
    not a gradient hop and do not count."""
    from .opcost import dtype_bytes

    total = 0
    for w in wires:
        if w.kind == "all-reduce":
            total += 2 * w.elems * dtype_bytes(w.dtype)
        elif w.kind == "reduce-scatter":
            total += w.in_elems * dtype_bytes(w.dtype)
    return total


# -- compute/communication overlap, measured --------------------------------------


@dataclass(frozen=True)
class OverlapFinding:
    """One NCCL kernel and the share of its span that compute kernels on
    another stream covered."""

    kind: str
    name: str
    stream: object
    dur_us: float
    overlapped_us: float
    line: str

    @property
    def share(self) -> float:
        return self.overlapped_us / self.dur_us if self.dur_us > 0 else 0.0

    @property
    def schedulable(self) -> bool:
        return self.overlapped_us > 0

    def __repr__(self) -> str:
        return f"OverlapFinding({self.kind}, overlapped {self.share:.3f})"


@dataclass(frozen=True)
class OverlapAudit:
    """The trace's verdict over every NCCL kernel's OverlapFinding."""

    findings: tuple

    @property
    def total(self) -> int:
        return len(self.findings)

    @property
    def blocking(self) -> tuple:
        """Collectives that no compute overlapped: on the critical path."""
        return tuple(f for f in self.findings if not f.schedulable)

    @property
    def ok(self) -> bool:
        """True when compute overlapped every collective."""
        return not self.blocking


def _covered(a: float, b: float, spans: list) -> float:
    """Length of [a, b) covered by the union of ``spans`` (sorted)."""
    covered, end = 0.0, a
    for s, t in spans:
        if t <= end:
            continue
        if s >= b:
            break
        lo = max(s, end)
        hi = min(t, b)
        if hi > lo:
            covered += hi - lo
            end = hi
    return covered


def overlap_audit(events) -> OverlapAudit:
    """For every NCCL kernel in the trace, how much of its span compute
    kernels on other streams ran beside it. NCCL runs on its own stream;
    an overlap of 0 means the collective sat on the critical path."""
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    compute = [e for e in kernels if not str(e.get("name", "")).lower().startswith("nccl")]
    findings = []
    for e in kernels:
        name = str(e.get("name", ""))
        if not name.lower().startswith("nccl"):
            continue
        stream = e.get("args", {}).get("stream")
        spans = sorted((float(c["ts"]), float(c["ts"]) + float(c["dur"])) for c in compute
                       if c.get("args", {}).get("stream") != stream)
        a, dur = float(e["ts"]), float(e["dur"])
        findings.append(OverlapFinding(collective_kind(name) or "nccl", name, stream, dur,
                                       _covered(a, a + dur, spans), _line(e)))
    return OverlapAudit(tuple(findings))


def collectives_schedulable(events) -> bool:
    """True when compute overlapped every NCCL kernel of the trace;
    vacuously True with none (one rank, or gloo)."""
    return overlap_audit(events).ok
