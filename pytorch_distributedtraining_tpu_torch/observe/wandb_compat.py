"""Module-level wandb-compatible API, so the driver keeps the reference's
call shape (``wandb.init(project=..., config=..., reinit=True)``,
``wandb.log``, ``wandb.config``, ``wandb.finish``).

Counterpart of ``pytorch_distributedtraining_tpu/observe/wandb_compat.py``:
backed by the real client when available, otherwise the JSONL sink; rank-0
gated and idempotent when ``init`` is called again on every log.
"""

from __future__ import annotations

from .sink import JSONLSink, MetricsSink, make_sink

_sink: MetricsSink | None = None
_config: dict = {}


def login(*args, **kwargs) -> bool:
    return True


def init(project: str | None = None, config: dict | None = None, reinit: bool = False,
         **kwargs):
    global _sink, _config
    if _sink is not None and not reinit:
        return _sink
    if _sink is not None:
        _sink.finish()
    _config = dict(config or {})
    _sink = make_sink(project, config, **kwargs)
    return _sink


def log(metrics: dict, step: int | None = None) -> None:
    global _sink
    if _sink is None:
        _sink = JSONLSink()
    _sink.log(metrics, step=step)


def finish() -> None:
    global _sink
    if _sink is not None:
        _sink.finish()
        _sink = None


def nonfinite_dropped() -> dict:
    """Per-key counts of non-finite scalars the sink dropped this run."""
    if _sink is None:
        return {}
    return dict(_sink.nonfinite_dropped)


class _Config(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


def __getattr__(name):
    if name == "config":
        return _Config(_config)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
