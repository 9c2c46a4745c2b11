"""Goodput ledger, analytic model FLOPs / MFU, and straggler detection.

Counterpart of ``pytorch_distributedtraining_tpu/observe/goodput.py``,
stdlib only, on the port's ``observe/trace.py``:

- :class:`GoodputLedger` buckets a window of span records into
  ``productive / compile / input_wait / checkpoint / collective / outage /
  other`` by their categories: per-bucket interval unions of the top-level
  spans of the busiest thread, ``other`` the unattributed rest, so the
  buckets sum to the window's wall time. ``TrainStep``'s dispatch span
  (``compile`` on its first call, ``step`` after), the loader's
  ``input.fetch``/``input.wait`` spans and the checkpoint spans feed it.
  Eager torch dispatches asynchronously too: a step span covers the
  launches, and the device's remainder lands where the host next waits
  (a loss read, a synchronize).
- the analytic training FLOPs of GPT-2, ViT and SwinIR from their configs
  (fwd + bwd as 3x forward), :func:`model_train_flops` on the port's
  models (a DDP wrapper is looked through), and :func:`mfu` against
  :data:`PEAK_FLOPS` (``GRAFT_PEAK_FLOPS`` overrides). Remat's recompute
  is not useful work and does not count.
- cross-process straggler detection: :class:`StepLog` per rank,
  :func:`read_step_logs` and :func:`flag_stragglers` (robust z-score of
  each rank's median step time), feeding the outage classifier's
  taxonomy. The logs are JSONL files of the same records as JAX's, so
  either package reads the other's.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field

from ..resilience.outage import OutageClass

BUCKETS = (
    "productive",
    "compile",
    "input_wait",
    "checkpoint",
    "collective",
    "outage",
    "other",
)

# span category (observe.trace.CATEGORIES) -> ledger bucket
CATEGORY_BUCKET = {
    "step": "productive",
    "compile": "compile",
    "input": "input_wait",
    "checkpoint": "checkpoint",
    "collective": "collective",
    "outage": "outage",
    "fault": "outage",  # an injected fault's ride-out is outage time
}


def _merged_total(intervals: list) -> float:
    """Total covered time of possibly-overlapping [a, b) intervals."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_a, cur_b = intervals[0]
    for a, b in intervals[1:]:
        if a > cur_b:
            total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    return total + (cur_b - cur_a)


@dataclass
class GoodputLedger:
    """Wall-clock classification of one measurement window.

    ``wall_s`` is the window's measured duration; ``buckets`` maps every
    name in :data:`BUCKETS` to seconds, with ``other`` the unattributed
    remainder so the buckets always sum to ``wall_s`` (within the float
    clipping at interval edges — the bench acceptance bound is 5%).
    """

    wall_s: float
    buckets: dict = field(default_factory=dict)
    events: int = 0  # instant events inside the window (faults, recompiles)

    @classmethod
    def from_records(
        cls,
        records: list,
        t0: float,
        t1: float,
        tid: int | None = None,
    ) -> "GoodputLedger":
        """Build a ledger from tracer records clipped to ``[t0, t1]``.

        Only spans from one thread are accounted (default: the thread
        with the most recorded span time in the window — the hot loop);
        a prefetch feeder's staging time overlaps the consumer's wall
        clock by design and must not be double-billed.
        """
        wall = max(0.0, t1 - t0)
        in_window = [
            r for r in records
            if not r.get("instant")
            and r["t0"] + r["dur"] > t0 and r["t0"] < t1
        ]
        n_events = sum(
            1 for r in records
            if r.get("instant") and t0 <= r["t0"] <= t1
        )
        if tid is None and in_window:
            by_tid: dict = {}
            for r in in_window:
                by_tid[r["tid"]] = by_tid.get(r["tid"], 0.0) + r["dur"]
            tid = max(by_tid, key=by_tid.get)
        per_bucket: dict = {b: [] for b in BUCKETS}
        for r in in_window:
            if r["tid"] != tid or r.get("depth", 0) != 0:
                continue
            bucket = CATEGORY_BUCKET.get(r["cat"], "other")
            a = max(t0, r["t0"])
            b = min(t1, r["t0"] + r["dur"])
            if b > a:
                per_bucket[bucket].append((a, b))
        buckets = {b: _merged_total(iv) for b, iv in per_bucket.items()}
        accounted = sum(buckets.values())
        buckets["other"] += max(0.0, wall - accounted)
        return cls(wall_s=wall, buckets=buckets, events=n_events)

    @classmethod
    def from_tracer(cls, tracer=None, t0: float | None = None,
                    t1: float | None = None) -> "GoodputLedger":
        from . import trace as _trace

        tracer = tracer or _trace.get_tracer()
        recs = tracer.records()
        if not recs:
            return cls(wall_s=0.0, buckets={b: 0.0 for b in BUCKETS})
        if t0 is None:
            t0 = min(r["t0"] for r in recs)
        if t1 is None:
            t1 = max(r["t0"] + r["dur"] for r in recs)
        return cls.from_records(recs, t0, t1)

    def goodput_fraction(self) -> float | None:
        """Share of wall clock that was productive step time."""
        if self.wall_s <= 0.0:
            return None
        return max(0.0, min(1.0, self.buckets.get("productive", 0.0)
                            / self.wall_s))

    def time_breakdown(self, ndigits: int = 4) -> dict:
        """``{bucket: seconds}`` in canonical order (json-ready)."""
        return {b: round(self.buckets.get(b, 0.0), ndigits) for b in BUCKETS}

    def render(self) -> str:
        parts = ", ".join(
            f"{b}={self.buckets.get(b, 0.0):.3f}s" for b in BUCKETS
            if self.buckets.get(b, 0.0) > 0.0
        )
        gf = self.goodput_fraction()
        head = f"wall {self.wall_s:.3f}s"
        if gf is not None:
            head += f", goodput {gf:.1%}"
        return f"{head}: {parts or 'no spans'}"


# -- analytic model FLOPs ----------------------------------------------
#
# Training cost as 3x forward (fwd + ~2x bwd), the standard estimate, with
# the JAX package's formulas term for term, so both packages count the same
# FLOPs for the same config.

_TRAIN_MULT = 3.0  # fwd + bwd ≈ 3x fwd matmul FLOPs


def transformer_fwd_flops(
    n_layer: int, d_model: int, seq: int,
    mlp_ratio: float = 4.0, vocab: int = 0,
) -> float:
    """Forward matmul FLOPs for one sequence through a standard
    pre-LN transformer trunk (2*m*n*k per matmul convention)."""
    per_layer = (
        2 * seq * 4 * d_model * d_model          # qkv + out projections
        + 2 * 2 * seq * seq * d_model            # qk^T and att*v
        + 2 * seq * 2 * mlp_ratio * d_model * d_model  # mlp up + down
    )
    head = 2 * seq * d_model * vocab if vocab else 0
    return n_layer * per_layer + head


def gpt2_train_flops(cfg, batch: int, seq: int | None = None) -> float:
    """Per-step training FLOPs for a GPT2Config-shaped config."""
    seq = seq or getattr(cfg, "n_positions", 1024)
    fwd = transformer_fwd_flops(
        cfg.n_layer, cfg.n_embd, seq,
        mlp_ratio=getattr(cfg, "mlp_ratio", 4),
        vocab=getattr(cfg, "vocab_size", 0),
    )
    return _TRAIN_MULT * fwd * batch


def vit_train_flops(cfg, batch: int) -> float:
    """Per-step training FLOPs for a ViTConfig-shaped config."""
    tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
    d = cfg.hidden_dim
    fwd = transformer_fwd_flops(
        cfg.num_layers, d, tokens,
        mlp_ratio=cfg.mlp_dim / d,
        vocab=getattr(cfg, "num_classes", 0),
    )
    # patch embedding: one P x P x 3 -> d matmul per token
    fwd += 2 * tokens * d * (cfg.patch_size ** 2 * 3)
    return _TRAIN_MULT * fwd * batch


def swinir_train_flops(
    batch: int,
    h: int,
    w: int,
    embed_dim: int = 60,
    depths=(6, 6, 6, 6),
    mlp_ratio: float = 2.0,
    window_size: int = 8,
    upscale: int = 2,
    in_chans: int = 3,
) -> float:
    """Per-step training FLOPs for SwinIR at input resolution h x w.

    Window attention: the qk^T/att*v matmuls see ``window_size**2``-long
    sequences, so their cost is linear in tokens. Defaults are SwinIR-S
    x2, the main path's model (about 21 GFLOPs an image trained at
    64x64).
    """
    tokens = h * w
    c = embed_dim
    n_layers = sum(depths)
    per_layer = (
        2 * tokens * 4 * c * c                     # qkv + proj
        + 2 * 2 * tokens * (window_size ** 2) * c  # windowed qk^T, att*v
        + 2 * tokens * 2 * mlp_ratio * c * c       # mlp
    )
    conv = (
        2 * 9 * in_chans * c * tokens              # shallow 3x3 conv
        + len(depths) * 2 * 9 * c * c * tokens     # per-RSTB conv
        + 2 * 9 * c * c * tokens                   # conv after body
        + 2 * 9 * c * (in_chans * upscale ** 2) * tokens  # upsample conv
    )
    fwd = n_layers * per_layer + conv
    return _TRAIN_MULT * fwd * batch


def model_train_flops(model, batch: int, input_hw=None) -> float | None:
    """Dispatch on the model object's shape (the port's ``GPT2`` and ``ViT``
    by their configs, ``SwinIR`` by its name and attributes; a DDP wrapper's
    ``module``); None when unrecognized."""
    model = getattr(model, "module", model)
    cfg = getattr(model, "cfg", model)
    name = type(model).__name__.lower()
    if hasattr(cfg, "n_embd") and hasattr(cfg, "n_layer"):
        return gpt2_train_flops(cfg, batch)
    if hasattr(cfg, "hidden_dim") and hasattr(cfg, "patch_size"):
        return vit_train_flops(cfg, batch)
    if "swinir" in name or hasattr(model, "embed_dim"):
        if input_hw is None:
            hw = getattr(model, "img_size", 64)
            input_hw = (hw, hw)
        return swinir_train_flops(
            batch, input_hw[0], input_hw[1],
            embed_dim=getattr(model, "embed_dim", 60),
            depths=tuple(getattr(model, "depths", (6, 6, 6, 6))),
            mlp_ratio=float(getattr(model, "mlp_ratio", 2.0)),
            window_size=int(getattr(model, "window_size", 8)),
            upscale=int(getattr(model, "upscale", 2)),
        )
    return None


# -- per-device peak FLOPs and MFU -------------------------------------

# dense bf16 peak per device, matched by substring against the device kind
# (torch.cuda.get_device_name(), lowercased, spaces removed); a platform row
# is the fallback. "h100": NVIDIA's dense bf16 tensor-core figure for the
# H100 SXM5 part at its 700 W board limit (nvidia-smi: "NVIDIA H100 80GB
# HBM3, 700.00 W"); a card capped below 700 W runs below it. CPU has no
# meaningful tensor peak: the placeholder keeps MFU defined on CPU runs (it
# reads as "fraction of a 100 GFLOP/s core"). Any other card has no peak
# here (set GRAFT_PEAK_FLOPS), and its MFU is None.
PEAK_FLOPS = {
    "h100": 989e12,
    "cpu": 100e9,
}


def peak_flops(platform: str = "", device_kind: str = "") -> float | None:
    """Per-device peak from the table; ``GRAFT_PEAK_FLOPS`` overrides
    (a deployment knows its card better than a substring table). None for
    a device that is neither a CPU nor a card with a row."""
    env = os.environ.get("GRAFT_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            raise ValueError(
                f"GRAFT_PEAK_FLOPS must be a float, got {env!r}"
            ) from None
    kind = (device_kind or "").lower().replace(" ", "")
    for key, val in PEAK_FLOPS.items():
        if key in kind:
            return val
    if (platform or "cpu").lower() == "cpu":
        return PEAK_FLOPS["cpu"]
    return None


def mfu(
    model_flops_per_step: float,
    step_time_s: float,
    n_devices: int = 1,
    platform: str = "",
    device_kind: str = "",
) -> float | None:
    """Model FLOPs utilization: achieved model FLOP/s over the mesh's
    aggregate peak. Uses *analytic* model FLOPs (the MFU convention —
    remat recompute does not count as useful work). None where the device
    has no known peak."""
    peak = peak_flops(platform, device_kind)
    if step_time_s <= 0.0 or model_flops_per_step <= 0.0 or peak is None:
        return None
    return model_flops_per_step / step_time_s / (peak * max(1, n_devices))


def device_kind(device=None) -> tuple[str, str]:
    """``(platform, device_kind)`` of a torch device for :func:`mfu`:
    ``("gpu", torch.cuda.get_device_name(device))`` on the card, ``("cpu",
    "")`` otherwise."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return "cpu", ""
    return "gpu", torch.cuda.get_device_name(device)


def run_summary(steps: int, flops_per_step: float | None, device=None, tracer=None) -> dict:
    """The traced window's goodput ledger and MFU, as the drivers print them
    at exit with ``--trace``: ``{"wall_s", "goodput", "breakdown", "steps",
    "step_s", "mfu", "peak_flops"}``. The step time is the window's wall time
    over ``steps`` (input waits and compile included), so the MFU is the
    whole run's; None without analytic FLOPs for the model."""
    ledger = GoodputLedger.from_tracer(tracer)
    platform, kind = device_kind(device)
    step_s = ledger.wall_s / steps if steps else 0.0
    return {
        "wall_s": ledger.wall_s,
        "goodput": ledger.goodput_fraction(),
        "breakdown": ledger.time_breakdown(),
        "steps": steps,
        "step_s": step_s,
        "mfu": (None if not flops_per_step else
                mfu(flops_per_step, step_s, 1, platform=platform, device_kind=kind)),
        "peak_flops": peak_flops(platform, kind),
    }


# -- cross-process straggler detection ---------------------------------


def _log_epoch(epoch: int | None = None) -> int:
    """Generation epoch namespace for step logs: explicit arg wins, then
    ``GRAFT_GEN_EPOCH`` (exported per generation by the elastic
    launcher), else 0 (flat legacy layout)."""
    if epoch is not None:
        return int(epoch)
    try:
        return int(os.environ.get("GRAFT_GEN_EPOCH", "0"))
    except ValueError:
        return 0


def step_log_dir(base: str | None = None, epoch: int | None = None) -> str:
    from . import trace as _trace

    d = os.path.join(base or _trace.run_dir(), "steps")
    e = _log_epoch(epoch)
    if e > 0:
        # namespaced per generation: after an elastic shrink the new
        # world's straggler statistics must not be polluted by stale
        # logs from ranks of the larger world that no longer exist
        d = os.path.join(d, f"epoch_{e}")
    os.makedirs(d, exist_ok=True)
    return d


class StepLog:
    """Per-rank append-only step-timing log (one JSONL file per rank).

    Buffered: records are flushed every ``flush_every`` appends so the
    hot loop pays a file write only occasionally; ``close()`` drains.
    """

    def __init__(self, rank: int | None = None, base: str | None = None,
                 flush_every: int = 16, epoch: int | None = None):
        from . import trace as _trace

        self.rank = _trace._rank() if rank is None else int(rank)
        self.path = os.path.join(
            step_log_dir(base, epoch), f"rank_{self.rank}.jsonl"
        )
        self.flush_every = max(1, int(flush_every))
        self._pending: list = []

    def record(self, step: int, dt_s: float) -> None:
        self._pending.append(
            {"rank": self.rank, "step": int(step),
             "dt_s": float(dt_s), "t": time.time()}
        )
        if len(self._pending) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        with open(self.path, "a", encoding="utf-8") as fh:
            for rec in self._pending:
                fh.write(json.dumps(rec) + "\n")
        self._pending.clear()

    def close(self) -> None:
        self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_step_logs(
    base: str | None = None,
    epoch: int | None = None,
    stats: dict | None = None,
) -> dict:
    """``{rank: [dt_s, ...]}`` from every rank's step log (rank 0 and the
    fleet monitor call this).

    A rank killed mid-write — elastic shrink, preemption, fault drill —
    leaves a torn trailing line (no newline, possibly split inside a
    UTF-8 sequence). The reader must tolerate it: the partial record is
    skipped, never raised, and counted in ``stats`` (pass a dict to
    receive ``files`` / ``lines`` / ``skipped_lines`` /
    ``torn_tail_lines``) so the monitor can report torn tails instead of
    silently eating them.
    """
    d = step_log_dir(base, epoch)
    counters = {
        "files": 0, "lines": 0, "skipped_lines": 0, "torn_tail_lines": 0,
    }
    out: dict = {}
    for name in sorted(os.listdir(d)):
        if not (name.startswith("rank_") and name.endswith(".jsonl")):
            continue
        try:
            rank = int(name[len("rank_"):-len(".jsonl")])
        except ValueError:
            continue
        try:
            with open(os.path.join(d, name), "rb") as fh:
                raw = fh.read()
        except OSError:
            continue
        counters["files"] += 1
        torn_tail = bool(raw) and not raw.endswith(b"\n")
        lines = raw.split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        times: list = []
        for i, line in enumerate(lines):
            counters["lines"] += 1
            try:
                times.append(
                    float(json.loads(line.decode("utf-8", "replace"))["dt_s"])
                )
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                counters["skipped_lines"] += 1
                if torn_tail and i == len(lines) - 1:
                    counters["torn_tail_lines"] += 1
        if times:
            out[rank] = times
    if stats is not None:
        stats.update(counters)
    return out


@dataclass
class StragglerReport:
    """Robust z-scores of per-rank median step time, plus the flagged set.

    ``outage_class`` feeds the shared classifier's taxonomy: a flagged
    straggler is OUTAGE-class (a contended host / flaky link — waiting,
    rescheduling or excluding the rank helps), never DETERMINISTIC (the
    same program runs on every rank under SPMD).
    """

    medians: dict
    zscores: dict
    stragglers: tuple
    threshold: float

    @property
    def outage_class(self) -> OutageClass | None:
        return OutageClass.OUTAGE if self.stragglers else None

    def render(self) -> str:
        if not self.medians:
            return "straggler check: no step records"
        if not self.stragglers:
            return (
                f"straggler check: {len(self.medians)} ranks within "
                f"|z| < {self.threshold:g}"
            )
        worst = ", ".join(
            f"rank {r} (median {self.medians[r]:.4f}s, "
            f"z={self.zscores[r]:+.1f})"
            for r in self.stragglers
        )
        return (
            f"straggler check: {len(self.stragglers)}/{len(self.medians)} "
            f"ranks flagged ({self.outage_class.value}-class): {worst}"
        )


def flag_stragglers(
    times_by_rank: dict, z_threshold: float = 3.5, min_ranks: int = 3,
) -> StragglerReport:
    """Flag outlier ranks by robust z-score over per-rank median step time.

    Modified z = 0.6745 * (x - median) / MAD — the standard
    outlier-robust form; below ``min_ranks`` ranks the statistic is
    meaningless and nothing is flagged. Only *slow* outliers (z > 0)
    are stragglers; an anomalously fast rank is a measurement artifact,
    not a capacity problem.
    """
    medians = {
        r: sorted(ts)[len(ts) // 2]
        for r, ts in times_by_rank.items() if ts
    }
    if len(medians) < min_ranks:
        return StragglerReport(medians, {}, (), z_threshold)
    vals = sorted(medians.values())
    med = vals[len(vals) // 2]
    mad = sorted(abs(v - med) for v in vals)[len(vals) // 2]
    if mad <= 0.0:
        # degenerate spread: fall back to a relative-excess test so one
        # rank 2x slower than an otherwise identical fleet still flags
        zscores = {
            r: (math.inf if v > 1.5 * med and med > 0 else 0.0)
            for r, v in medians.items()
        }
    else:
        zscores = {
            r: 0.6745 * (v - med) / mad for r, v in medians.items()
        }
    stragglers = tuple(
        sorted(r for r, z in zscores.items() if z > z_threshold)
    )
    return StragglerReport(medians, zscores, stragglers, z_threshold)


def straggler_check(base: str | None = None, z_threshold: float = 3.5,
                    epoch: int | None = None) -> StragglerReport:
    """Rank-0 entry point: aggregate every rank's step log and flag."""
    return flag_stragglers(
        read_step_logs(base, epoch), z_threshold=z_threshold
    )
