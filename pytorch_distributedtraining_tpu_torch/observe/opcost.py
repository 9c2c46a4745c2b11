"""Op-cost attribution: profiler traces -> per-class cost tables, per-axis
collective bandwidth, analytic-model calibration, and the device-time
breakdown of a traced window.

Counterpart of ``pytorch_distributedtraining_tpu/observe/opcost.py``. JAX
reads the trace-event JSON ``jax.profiler`` writes and classifies HLO op
names on the device lanes; the port reads the Chrome trace
``torch.profiler`` writes (``observe.profiling``) and classifies CUDA
activity, which it selects by category (``kernel``, ``gpu_memcpy``,
``gpu_memset``), not by lane:

- :func:`op_table`: the per-class cost table (compute / collective / copy /
  host-transfer, JAX's four classes) and the per-collective rows. An
  ``nccl*`` kernel is a collective, its kind read from its name; a
  host-to-device or device-to-host copy is a host transfer; a
  device-to-device copy or a copy kernel is a copy; everything else
  computes. The template instantiations of one kernel share a row. A
  trace with no device activity and no CUDA runtime call (a gloo run on
  the CPU) gets its table from the host's collective ops instead; a trace
  that called the CUDA runtime but holds no device activity (an empty
  CUPTI capture on the card) raises.
- :func:`collective_bandwidth`: the trace's collective seconds joined with
  the bytes of its own collective records (``observe.comms.wire_inventory``,
  in place of JAX's HLO wire inventory): measured bytes per second per mesh
  axis. At one rank NCCL runs no kernel (a one-rank collective is a copy),
  so the seconds are 0 and the bandwidth is None: not measured.
- :func:`calibrate` / :func:`write_calibration` / :func:`load_calibration`:
  JAX's, unchanged: analytic predictions scored against measurements, with
  drift against a previous calibration.
- :func:`device_breakdown` / :func:`kernel_stats`: device time by kernel
  family and by name, busy and idle shares of the traced window and the
  host's blocking CUDA calls; the profiler layer ``benchmarks/
  profile_swinir.py``, ``benchmarks/ladder.py --trace`` and
  ``chip_smoke.py`` share.

:data:`runtime_stats` and :data:`rolling_gauges` are process-wide on
purpose, as in JAX, for readers that look them up through ``sys.modules``.
Stdlib only at import.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os

from .comms import collective_kind, wire_inventory

__all__ = [
    "load_trace_events",
    "op_class",
    "op_table",
    "collective_bandwidth",
    "calibrate",
    "write_calibration",
    "load_calibration",
    "ingest_trace",
    "opcost_from_env",
    "device_breakdown",
    "kernel_stats",
    "runtime_stats",
    "rolling_gauges",
    "reset",
]

runtime_stats: dict = {
    "tables_built": 0,          # op_table() calls this process
    "axis_bandwidth": {},       # axis -> latest measured bytes/s
    "axis_bandwidth_best": {},  # axis -> best bytes/s ever seen here
    "calibration": {},          # latest calibrate() result, by model
}

# gauge name -> value, for a metrics publisher (the serving-fleet slice)
rolling_gauges: dict = {}


def reset() -> None:
    """Restore the module gauges to their import-time state."""
    runtime_stats.update(
        tables_built=0,
        axis_bandwidth={},
        axis_bandwidth_best={},
        calibration={},
    )
    rolling_gauges.clear()


# -- trace loading ------------------------------------------------------


def load_trace_events(trace_dir: str):
    """All events from every trace file of the newest run under
    ``trace_dir`` (one file a process); a bare .json whose .gz sibling
    exists is skipped, not doubled. Returns ``(events, n_files)``. Raises
    :class:`FileNotFoundError` when the dir holds no trace files."""
    pats = [
        os.path.join(trace_dir, "**", "*.trace.json.gz"),
        os.path.join(trace_dir, "**", "*.trace.json"),
    ]
    files = sorted(
        f for pat in pats for f in glob.glob(pat, recursive=True)
    )
    files = [f for f in files if not (
        f.endswith(".json") and f + ".gz" in files
    )]
    if not files:
        raise FileNotFoundError(f"no *.trace.json(.gz) under {trace_dir}")
    # one profiling RUN = one timestamped parent dir; merge only the
    # newest run's files (one per process) — summing several runs would
    # silently multiply every op time
    newest_run = max(os.path.dirname(f) for f in files)
    files = [f for f in files if os.path.dirname(f) == newest_run]
    events = []
    for f in files:
        events.extend(read_trace(f))
    return events, len(files)


def read_trace(path: str, keep_lead: bool = False) -> list:
    """The ``traceEvents`` of one Chrome trace file (``.json`` or
    ``.json.gz``), without the lead a guarded session opens with
    (:func:`cut_lead`) unless ``keep_lead``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        events = json.loads(fh.read()).get("traceEvents", [])
    return events if keep_lead else cut_lead(events)[0]


# the range ``observe.profiling`` opens a session's window with
LEAD_NAME = "observe.profiling.lead"


def cut_lead(events: list) -> tuple[list, int]:
    """A trace's events without its lead: the ``LEAD_NAME`` ranges, the host
    ops and CUDA calls on the lead's thread inside its range, the device
    records and flow arrows of those calls; and how many of the lead's
    launch, copy and set calls have no device record."""
    lead = next((e for e in events if e.get("name") == LEAD_NAME
                 and e.get("cat") == "user_annotation"), None)
    if lead is None:
        return events, 0
    t0, t1, tid = lead["ts"], lead["ts"] + lead.get("dur", 0), lead.get("tid")

    def inside(e) -> bool:
        return e.get("tid") == tid and t0 <= e.get("ts", t0 - 1) <= t1

    calls = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver") and inside(e)
             and "correlation" in e.get("args", {})]
    ids = {e["args"]["correlation"] for e in calls}
    device = {e.get("args", {}).get("correlation") for e in events
              if e.get("cat") in DEVICE_CATS}
    lost = sum(1 for e in calls if e["args"]["correlation"] not in device
               and any(k in e.get("name", "") for k in ("Launch", "Memcpy", "Memset")))
    kept = [e for e in events
            if not (e.get("name") == LEAD_NAME
                    or (e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver") and inside(e))
                    or (e.get("cat") in DEVICE_CATS and e.get("args", {}).get("correlation") in ids)
                    or (e.get("cat") == "ac2g" and e.get("id") in ids))]
    return kept, lost


# -- op classification --------------------------------------------------

OP_CLASSES = ("compute", "collective", "copy", "host-transfer")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_base(name: str) -> str:
    """One row's name for every template instantiation of a kernel:
    ``void (anonymous namespace)::window_attn_fwd_kernel<float, 2, 16>(...)``
    -> ``window_attn_fwd_kernel``."""
    base = name.replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        base = base.split(stop, 1)[0]
    base = base.strip()
    return base[5:] if base.startswith("void ") else base


def op_class(name: str) -> str:
    """Cost class of one device activity (or host collective op) by name:
    compute / collective / copy / host-transfer."""
    low = name.lower()
    if low.startswith("nccl") or low.startswith("c10d::") or low == "record_param_comms":
        return "collective"
    if low.startswith("memcpy"):
        return "host-transfer" if ("htod" in low or "dtoh" in low) else "copy"
    if "copy" in low:
        return "copy"
    return "compute"


def _collective_row(name: str) -> str:
    """A collective row's key: its HLO kind (``all-reduce``), or the
    kernel's base name for one whose kind the name does not give."""
    return collective_kind(name) or kernel_base(name)


def op_table(events, top: int = 25, *, require_device: bool = False) -> dict:
    """Per-op-class cost table from the trace events of a ``torch.profiler``
    session: the device's kernels, copies and sets (grouped by
    :func:`kernel_base`), or, in a trace with neither device activity nor a
    CUDA runtime call, the host's ``c10d::`` collective ops. Raises
    ``RuntimeError`` for a trace that called the CUDA runtime, or was
    taken with ``require_device``, and holds no device activity.
    Durations in seconds; each op and collective row counts its events."""
    device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not device:
        cuda = any(e.get("cat") in ("cuda_runtime", "cuda_driver") for e in events)
        if cuda or require_device:
            raise RuntimeError("the trace holds no device activity (no CUPTI kernels, copies "
                               "or sets): an empty capture, not zero work")
        device = [e for e in events if e.get("cat") == "cpu_op" and "dur" in e
                  and str(e.get("name", "")).startswith("c10d::")
                  and collective_kind(e["name"]) is not None]
    dur = collections.Counter()
    n_ev = collections.Counter()
    for e in device:
        full = e.get("name", "?")
        name = kernel_base(full)
        if op_class(name) != op_class(full):  # a copy named in the template arguments
            name = f"{name} [{op_class(full)}]"
        dur[name] += e.get("dur", 0.0)  # microseconds
        n_ev[name] += 1

    classes = {
        cls: {"seconds": 0.0, "events": 0} for cls in OP_CLASSES
    }
    collectives = collections.Counter()
    coll_events = collections.Counter()
    for name, us in dur.items():
        cls = op_class(name)
        classes[cls]["seconds"] += us / 1e6
        classes[cls]["events"] += n_ev[name]
        if cls == "collective":
            kind = _collective_row(name)
            collectives[kind] += us / 1e6
            coll_events[kind] += n_ev[name]
    for row in classes.values():
        row["seconds"] = round(row["seconds"], 9)
    total = sum(dur.values())
    table = {
        "total_s": round(total / 1e6, 9),
        "classes": classes,
        "ops": [
            {
                "op": name,
                "class": op_class(name),
                "s": round(us / 1e6, 9),
                "share": round(us / total, 4) if total else 0.0,
                "events": n_ev[name],
            }
            for name, us in dur.most_common(top)
        ],
        "collectives": [
            {
                "op": name,
                "s": round(s, 9),
                "events": coll_events[name],
            }
            for name, s in collectives.most_common()
        ],
    }
    runtime_stats["tables_built"] += 1
    return table


# -- collective bandwidth: trace seconds x collective bytes -------------

# HLO dtype-token widths for the wire-inventory byte join; tokens the
# table misses are charged at 4 bytes (f32 — the conservative default)
_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "c64": 8,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e4m3": 1, "f8e4m3b11fnuz": 1, "f8e5m2": 1,
}


def dtype_bytes(token: str) -> int:
    return _DTYPE_BYTES.get((token or "").lower(), 4)


def wire_bytes(wire) -> int:
    """Per-partition payload bytes of one ``WireCollective``."""
    return int(wire.elems) * dtype_bytes(wire.dtype)


def collective_bandwidth(
    table: dict, wires, mesh_axes: dict, steps: int = 1,
) -> dict:
    """Measured bytes-per-second per mesh axis.

    ``table`` is an :func:`op_table`; ``wires`` is a list of
    ``observe.comms.WireCollective`` (their ``group_size``); ``mesh_axes``
    maps axis name -> size; ``steps`` is how many times the trace ran the
    ``wires`` (1 for the trace's own records, which cover its whole window).

    Each collective is attributed to the mesh axis whose size matches its
    group size; collectives with no group size, or one no axis matches, land
    under ``"?"`` (all of them go to the one axis above size 1 when there is
    only one). The trace does not label kernels with axes, so each
    collective *kind*'s measured seconds are apportioned across axes by that
    kind's byte share per axis: exact when a kind runs on one axis.
    """
    bytes_by_kind_axis: dict = collections.defaultdict(collections.Counter)
    sizes = {int(v): k for k, v in mesh_axes.items() if int(v) > 1}
    for w in wires:
        gsz = w.group_size
        axis = sizes.get(gsz, "?") if gsz is not None else "?"
        if axis == "?" and len(sizes) == 1:
            # one non-trivial axis: every collective belongs to it
            axis = next(iter(sizes.values()))
        bytes_by_kind_axis[w.kind][axis] += wire_bytes(w)
    secs_by_kind = collections.Counter()
    for row in table.get("collectives", []):
        kind = row["op"]
        for suffix in ("-start", "-done"):
            if kind.endswith(suffix):
                kind = kind[: -len(suffix)]
        secs_by_kind[kind] += row["s"]
    out: dict = {}
    for kind, by_axis in bytes_by_kind_axis.items():
        kind_bytes = sum(by_axis.values())
        kind_s = secs_by_kind.get(kind, 0.0)
        for axis, b in by_axis.items():
            row = out.setdefault(
                axis, {"bytes": 0, "seconds": 0.0, "bytes_per_s": None}
            )
            row["bytes"] += b * max(1, int(steps))
            if kind_bytes > 0 and kind_s > 0:
                row["seconds"] += kind_s * (b / kind_bytes)
    for axis, row in out.items():
        if row["seconds"] > 0:
            row["bytes_per_s"] = row["bytes"] / row["seconds"]
            row["seconds"] = round(row["seconds"], 9)
    _note_bandwidth(out)
    return out


def _note_bandwidth(per_axis: dict) -> None:
    """Fold measured per-axis bandwidth into the module gauges."""
    for axis, row in per_axis.items():
        bw = row.get("bytes_per_s")
        if not bw or axis == "?":
            continue
        runtime_stats["axis_bandwidth"][axis] = float(bw)
        best = runtime_stats["axis_bandwidth_best"].get(axis, 0.0)
        runtime_stats["axis_bandwidth_best"][axis] = max(best, float(bw))
        rolling_gauges[f"collective_bw_bytes_per_s_{axis}"] = float(bw)


# -- analytic-model calibration -----------------------------------------


def calibrate(models: dict, previous: dict | None = None) -> dict:
    """Score analytic predictions against measurements.

    ``models`` maps model name → ``{"analytic": x, "measured": y,
    "unit": u}`` (e.g. ``mfu_flops`` in seconds, ``wire`` in bytes,
    ``bubble`` as a fraction). Returns the same keys with ``ratio``
    (measured / analytic — 1.0 means the model is exact, 2.0 means
    reality is twice the prediction) and ``drift`` (relative change of
    the ratio vs ``previous``'s entry for the same model, None on first
    sight). Entries whose analytic side is missing or non-positive are
    dropped — a ratio against zero is noise, not calibration.

    The result also lands in ``runtime_stats["calibration"]``.
    """
    out: dict = {}
    previous = previous or {}
    for name, row in models.items():
        analytic = row.get("analytic")
        measured = row.get("measured")
        if (
            analytic is None or measured is None
            or not analytic > 0 or measured < 0
        ):
            continue
        ratio = float(measured) / float(analytic)
        drift = None
        prev = previous.get(name) or {}
        prev_ratio = prev.get("ratio")
        if prev_ratio:
            drift = round(ratio / float(prev_ratio) - 1.0, 6)
        out[name] = {
            "analytic": float(analytic),
            "measured": float(measured),
            "unit": row.get("unit", ""),
            "ratio": round(ratio, 6),
            "drift": drift,
        }
    runtime_stats["calibration"] = out
    for name, row in out.items():
        rolling_gauges[f"calibration_ratio_{name}"] = row["ratio"]
    _mark_plan_stale_on_drift(out)
    return out


def _mark_plan_stale_on_drift(calibration: dict) -> None:
    """Drift past tolerance (``GRAFT_CALIB_DRIFT_TOL``, default 0.5) marks
    the active plan stale through the port's ``analyze.plan``, looked up in
    ``sys.modules``: absent until the analyze slice, so a no-op."""
    import sys as _sys

    tol_env = os.environ.get("GRAFT_CALIB_DRIFT_TOL", "")
    try:
        tol = float(tol_env) if tol_env else 0.5
    except ValueError:
        tol = 0.5
    drifted = sorted(
        f"{name}:{row['drift']:+.3f}"
        for name, row in calibration.items()
        if row.get("drift") is not None and abs(row["drift"]) > tol
    )
    if not drifted:
        return
    plan_mod = _sys.modules.get(
        "pytorch_distributedtraining_tpu_torch.analyze.plan"
    )
    if plan_mod is None:
        return
    plan_mod.mark_stale(
        f"calibration drift past tolerance {tol}: {', '.join(drifted)}"
    )


def write_calibration(path: str, calibration: dict, meta: dict | None = None) -> str:
    """Write ``calibration.json`` (atomic; the planner-facing artifact)."""
    doc = {"calibration": calibration}
    if meta:
        doc["meta"] = meta
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1)
    os.replace(tmp, path)
    return path


def load_calibration(path: str) -> dict | None:
    """Read a previous ``calibration.json``'s per-model table (None when
    missing/unreadable — first runs have no drift baseline)."""
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    return doc.get("calibration") if isinstance(doc, dict) else None


def ingest_trace(
    trace_dir: str,
    *,
    mesh_axes: dict | None = None,
    steps: int = 1,
    top: int = 25,
    device: str | None = None,
) -> dict | None:
    """Parse one profiler capture into the module gauges.

    The on-demand capture's post-fire hook and the facade call this: load
    the newest run under ``trace_dir``, build the op table (``device="cuda"``
    requires device activity in it) and, with ``mesh_axes``, join the
    collective bandwidth per axis from the same trace's collective records.
    Returns ``{"table", "bandwidth", "wires", "steps"}`` (``steps``: the
    optimizer steps the capture covers, for per-step figures), or None when
    the dir holds no trace. A trace with no device activity raises (see
    :func:`op_table`); the capture's hook swallows that, as any ingest
    error."""
    try:
        events, _ = load_trace_events(trace_dir)
    except (FileNotFoundError, OSError, json.JSONDecodeError):
        return None
    table = op_table(events, top=top, require_device=device == "cuda")
    wires = wire_inventory(events)
    bandwidth = None
    if mesh_axes:
        bandwidth = collective_bandwidth(table, wires, mesh_axes)
    return {"table": table, "bandwidth": bandwidth, "wires": wires, "steps": int(steps)}


def opcost_from_env(opcost: bool = False, env=None) -> bool:
    """The op-cost plane's switch: ``$GRAFT_OPCOST`` (any value but a falsy
    one) overrides ``opcost`` (JAX facade's ``_opcost_from_env``)."""
    raw = (os.environ if env is None else env).get("GRAFT_OPCOST")
    if raw is not None:
        return raw.strip().lower() not in ("", "0", "false", "off", "no")
    return bool(opcost)


# -- the device-time breakdown of a traced window -----------------------

TOP_KERNELS = 12  # kernels listed by name in a breakdown

# kernel-name fragments -> family, first match wins
# (cuDNN's implicit-GEMM convolutions carry "gemm" and "xmma" too, so
# convolution is tested before GEMM)
FAMILIES = (
    ("window attention (K1/K2)", ("window_attn", "dbias_reduce")),
    ("flash attention (K3-K5)", ("flash_attn",)),
    ("softmax / cross entropy", ("softmax", "nll_loss")),
    ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad")),
    ("GEMM", ("gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet")),
    ("LayerNorm", ("layer_norm",)),
    ("optimizer (foreach)", ("foreach", "multi_tensor")),
    ("reduction", ("reduce",)),
    ("copy / permute / roll", ("copy", "memcpy", "memset", "roll")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)

# CUDA runtime calls in which the host waits for the device
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D", "cudaMemset", "cudaStreamQuery")


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def _union_us(spans: list[tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _events(trace) -> list:
    return read_trace(trace) if isinstance(trace, str) else trace


def device_breakdown(trace) -> dict:
    """Device time by kernel family and of the longest kernels by name, and
    busy/idle shares of the span from the first kernel's start to the last
    kernel's end, from a Chrome trace written by ``torch.profiler`` (a path,
    or its events); also the host's time in each blocking CUDA runtime call
    (``host_wait_ms``) and in the longest host ops and annotations by name,
    each counted with the ops it calls (``top_host_ops_ms``). Raises on a
    trace with no device activity."""
    events = _events(trace)
    kernels = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not kernels:
        raise RuntimeError("the trace holds no device activity (no CUPTI kernels)")
    by_family: dict[str, float] = {}
    by_name: dict[str, float] = {}
    spans = []
    for e in kernels:
        by_family[family(e["name"])] = by_family.get(family(e["name"]), 0.0) + e["dur"]
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    busy = _union_us(spans)
    waits: dict[str, float] = {}
    host_ops: dict[str, float] = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("name") in HOST_WAITS:
            waits[e["name"]] = waits.get(e["name"], 0.0) + e.get("dur", 0.0) / 1e3
        elif e.get("cat") in ("cpu_op", "user_annotation") and "dur" in e:
            host_ops[e["name"]] = host_ops.get(e["name"], 0.0) + e["dur"] / 1e3
    return {
        "kernels": len(kernels),
        "host_wait_ms": waits,
        "top_host_ops_ms": sorted(host_ops.items(), key=lambda kv: -kv[1])[:TOP_KERNELS],
        "device_ms_by_family": {k: v / 1e3 for k, v in
                                sorted(by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": [(k[:120], v / 1e3) for k, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]],
        "busy_ms": busy / 1e3,
        "window_ms": window / 1e3,
        "idle_share": 1.0 - busy / window,
    }


def kernel_stats(trace, names: dict[str, str]) -> dict:
    """``{key: {"ms", "launches"}}``: the device ms and launches of the
    kernels whose name holds ``names[key]``, in a trace (a path, or its
    events)."""
    events = _events(trace)
    out = {}
    for key, frag in names.items():
        durs = [e["dur"] for e in events if e.get("cat") == "kernel" and frag in e["name"]]
        out[key] = {"ms": sum(durs) / 1e3, "launches": len(durs)}
    return out
