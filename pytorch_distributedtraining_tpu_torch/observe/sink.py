"""Metrics sinks: a thin interface with W&B and offline-JSONL backends.

Counterpart of ``pytorch_distributedtraining_tpu/observe/sink.py``; stdlib
only. The driver logs to a ``MetricsSink``: the wandb adapter when the
client is importable and logging is enabled, otherwise a JSONL file, so
training never blocks on a network service. All sinks are rank-0 gated
through ``RANK``.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import time
from typing import Any


def _is_rank0() -> bool:
    raw = os.environ.get("RANK")
    try:
        return raw in (None, "") or int(raw) == 0
    except ValueError:
        return True


def _default_path() -> str:
    """Per-process file under the temp directory, never the working tree."""
    return os.path.join(
        tempfile.gettempdir(), "pdt-torch-runs", str(os.getpid()), "metrics.jsonl"
    )


def _scalar(v):
    if hasattr(v, "item") and getattr(v, "ndim", 0) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


class MetricsSink:
    """Interface: ``log(metrics, step=None)`` + ``finish()``.

    Non-finite scalars are dropped at this boundary and counted per key in
    ``nonfinite_dropped``: a NaN in JSONL breaks every ``json.loads``
    consumer downstream.
    """

    def __init__(self):
        self.nonfinite_dropped: dict[str, int] = {}

    def _finite(self, metrics: dict[str, Any]) -> dict[str, Any]:
        out = {}
        for k, v in metrics.items():
            s = _scalar(v)
            if isinstance(s, float) and not math.isfinite(s):
                self.nonfinite_dropped[k] = self.nonfinite_dropped.get(k, 0) + 1
                continue
            out[k] = s
        return out

    def log(self, metrics: dict[str, Any], step: int | None = None) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        pass


class JSONLSink(MetricsSink):
    """Offline fallback: one JSON object per log call."""

    def __init__(self, path: str | None = None):
        super().__init__()
        self.path = path or _default_path()
        self._f = None

    def log(self, metrics, step=None):
        if not _is_rank0():
            return
        if self._f is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._f = open(self.path, "a")
        rec = {"_time": time.time()}
        if step is not None:
            rec["_step"] = int(step)
        rec.update(self._finite(metrics))
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def finish(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class WandbSink(MetricsSink):
    """The W&B client, rank-0 gated, with bounded init retries."""

    def __init__(self, project: str, config: dict | None = None,
                 retry_interval: float = 10.0, max_retries: int = 3, **init_kwargs):
        super().__init__()
        self._run = None
        if not _is_rank0():
            return
        import wandb

        for attempt in range(max_retries):
            try:
                self._run = wandb.init(project=project, config=config, **init_kwargs)
                break
            except Exception as e:
                if attempt == max_retries - 1:
                    raise RuntimeError(f"wandb.init failed after {max_retries} attempts") from e
                print("Retrying")
                time.sleep(retry_interval)
        self._wandb = wandb

    def log(self, metrics, step=None):
        if self._run is not None:
            self._wandb.log(self._finite(metrics), step=step)

    def finish(self):
        if self._run is not None:
            self._wandb.finish()
            self._run = None


def make_sink(project: str | None = None, config: dict | None = None, **kwargs) -> MetricsSink:
    """wandb if importable and enabled, else JSONL."""
    if os.environ.get("WANDB_MODE") == "disabled" or project is None:
        return JSONLSink(kwargs.get("path"))
    try:
        import wandb  # noqa: F401
    except ImportError:
        return JSONLSink(kwargs.get("path"))
    return WandbSink(project, config, **kwargs)
