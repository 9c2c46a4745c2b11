"""The drivers' ``--trace``, ``--numerics``, ``--opcost`` and
``--capture`` flags, shared by both.

``add_arguments`` defines them as JAX's drivers do (``--trace [DIR]``,
env twin ``GRAFT_TRACE``; ``--numerics [halt|rollback|degrade]``, a bare
flag meaning ``halt``; ``--opcost``, env twin ``GRAFT_OPCOST``;
``--capture [DIR]``, a bare flag writing under the run dir, env twin
``GRAFT_CAPTURE``); ``apply`` threads them through their env twins
(``GRAFT_TELEMETRY``/``GRAFT_TRACE``, ``GRAFT_NUMERICS``/
``GRAFT_NUMERICS_ACTION``, ``GRAFT_OPCOST``, ``GRAFT_CAPTURE``), which the
facade and ``observe`` read, and turns the tracer on; ``armed_capture``
arms the anomaly capture on a driver's own step loop; ``report`` writes
the Chrome trace at exit and prints the goodput breakdown and the MFU.
"""

from __future__ import annotations

import argparse
import os

from ..observe import capture, goodput, opcost
from ..observe import trace as telemetry


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--trace", type=str, nargs="?", const="",
                        default=os.environ.get("GRAFT_TRACE"),
                        help="telemetry (step, input and checkpoint spans, the crash flight "
                             "record): the Chrome trace at exit under DIR (bare --trace: the "
                             "run dir), the goodput breakdown and MFU printed (env twin "
                             "$GRAFT_TRACE; $GRAFT_TELEMETRY=0 turns it off)")
    parser.add_argument("--numerics", type=str, nargs="?", const="halt", default=None,
                        choices=[None, "halt", "rollback", "degrade"],
                        help="the numerics probe on each step and the divergence watchdog; the "
                             "value is the watchdog's action (bare --numerics = halt; env twins "
                             "$GRAFT_NUMERICS / $GRAFT_NUMERICS_ACTION)")
    parser.add_argument("--opcost", action="store_true",
                        default=bool(os.environ.get("GRAFT_OPCOST")),
                        help="the op-cost attribution plane: a landed profiler capture is "
                             "parsed into per-class cost tables and per-axis collective "
                             "bandwidth gauges (env twin $GRAFT_OPCOST)")
    parser.add_argument("--capture", type=str, nargs="?", const="1",
                        default=os.environ.get("GRAFT_CAPTURE"),
                        help="arm the anomaly-triggered profiler capture on the training loop "
                             "(a bounded torch.profiler trace on a straggler, SLO-burn, numerics "
                             "or regression signal); bare --capture writes under the run dir, "
                             "--capture DIR there (env twin $GRAFT_CAPTURE; with --opcost the "
                             "capture is ingested)")


def apply(opt: argparse.Namespace) -> None:
    """Set the env twins of ``opt.numerics`` and ``opt.trace`` and resolve
    the tracer from the environment (``observe.trace.configure_from_env``)."""
    if opt.numerics:
        os.environ["GRAFT_NUMERICS"] = "1"
        os.environ["GRAFT_NUMERICS_ACTION"] = opt.numerics
        print(f"===> numerics plane on, watchdog action={opt.numerics}")
    if opt.opcost:
        os.environ["GRAFT_OPCOST"] = "1"
        print("===> op-cost attribution on")
    if opt.capture and opt.capture.strip().lower() not in telemetry.FALSY:
        os.environ["GRAFT_CAPTURE"] = opt.capture
        print(f"===> anomaly capture armed (dir: "
              f"{opt.capture if opt.capture != '1' else 'run dir'})")
    if opt.trace is not None:
        os.environ.setdefault("GRAFT_TELEMETRY", "1")
        if opt.trace:
            os.environ["GRAFT_TRACE"] = opt.trace
    if telemetry.configure_from_env():
        print(f"===> telemetry on (trace dir: {opt.trace or 'run dir'})")


def armed_capture(mesh_axes: dict | None, device_type: str) -> capture.OnDemandProfiler | None:
    """The anomaly capture a driver arms on its own step loop when
    ``GRAFT_CAPTURE`` says so (None otherwise); with ``GRAFT_OPCOST`` a
    landed capture is ingested (``observe.opcost.ingest_trace``) with
    ``mesh_axes`` (``observe.capture.armed``: a directory per rank under a
    group). ``note_step()`` goes after each step's numerics."""
    on, capture_dir = capture.capture_from_env()
    if not on:
        return None
    prof = capture.armed(capture_dir)
    if opcost.opcost_from_env():
        def on_capture(cap_dir, source):
            opcost.ingest_trace(cap_dir, mesh_axes=mesh_axes, steps=prof.capture_steps,
                                device=device_type)
        prof.on_capture = on_capture
    return prof


def report(path: str | None, steps: int, flops_per_step: float | None, device) -> dict:
    """Write the Chrome trace to ``path`` (a ``.json`` file or a directory;
    default the run dir), print where and the traced window's goodput
    breakdown and MFU (``observe.goodput.run_summary``); returns the
    summary."""
    written = telemetry.export_chrome_trace(telemetry.trace_path(path))
    summary = goodput.run_summary(steps, flops_per_step, device)
    ledger = ", ".join(f"{k}={v:.3f}s" for k, v in summary["breakdown"].items() if v > 0)
    if summary["peak_flops"] is None:
        mfu = "n/a (no peak FLOP/s for this device; set GRAFT_PEAK_FLOPS)"
    elif summary["mfu"] is None:
        mfu = "n/a (no analytic FLOPs for this model)"
    else:
        mfu = f"{summary['mfu']:.4f} of {summary['peak_flops']:.3g} FLOP/s"
    print(f"===> telemetry trace written: {written} (load in Perfetto / chrome://tracing)")
    print(f"===> goodput: wall {summary['wall_s']:.3f}s over {steps} steps, "
          f"{ledger or 'no spans'}; MFU {mfu}")
    return summary
