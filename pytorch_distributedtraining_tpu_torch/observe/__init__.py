"""Metrics sinks, the wandb-compatible module the driver logs through, span
telemetry with the crash flight record (``trace``), request-lifecycle SLO
accounting (``slo``), training numerics (``numerics``: the step's probe and
the divergence watchdog), goodput and MFU (``goodput``: the time ledger,
analytic FLOPs, straggler detection), device memory (``memory``: the
budget, the high-water, the batch-size search), the guarded profiler and
step timing (``profiling``), the anomaly-triggered capture (``capture``),
op-cost tables, collective bandwidth and calibration (``opcost``) and the
collective inventory of a traced step (``comms``, the counterpart of JAX's
``observe/hlo.py``)."""

from . import capture, comms, goodput, memory, numerics, opcost, profiling, trace
from . import wandb_compat as wandb
from .capture import OnDemandProfiler
from .opcost import calibrate, collective_bandwidth, load_trace_events, op_table
from .profiling import StepTimer, TransferOverlapProbe
from .profiling import trace as profiler_trace

__all__ = [
    "capture", "comms", "goodput", "memory", "numerics", "opcost", "profiling", "trace",
    "wandb", "OnDemandProfiler", "StepTimer", "TransferOverlapProbe", "profiler_trace",
    "op_table", "calibrate", "collective_bandwidth", "load_trace_events",
]
