"""Serving: continuous-batching GPT-2 decode and tiled SwinIR super-resolution.

Counterpart of ``pytorch_distributedtraining_tpu/serve/``:

- :mod:`.kv_cache`: host-side page allocator over the paged KV layout
  (``models/generate.py`` owns the device-side primitives).
- :mod:`.scheduler`: FIFO admission, prefill chunk bucketing, slot and page
  occupancy.
- :mod:`.engine`: the continuous-batching engine (chunked prefill
  interleaved with batched decode, speculative decode, the closed set of
  programs, lifecycle records, fault sites).
- :mod:`.tiles`: SwinIR request tiling: tile, batch tiles across requests,
  stitch.

The router and the fleet (``serve/router.py``, ``serve/fleet.py``) wait for
the serving-fleet slice.

Env knobs (the ``GRAFT_SERVE_*`` family, resolved by
:func:`serve_knobs_from_env` and :func:`tile_knobs_from_env`, consumed by
:func:`build_engine` and ``Stoke.serve``):

============================  ==============================================
``GRAFT_SERVE_SLOTS``         decode batch slots (default 4)
``GRAFT_SERVE_PAGE``          KV page size in tokens (default 16)
``GRAFT_SERVE_PAGES``         total pool pages incl. the null page
                              (default: slots * max_len / page + 1)
``GRAFT_SERVE_MAX_LEN``       per-request length cap (default: the model's
                              ``n_positions``)
``GRAFT_SERVE_PREFILL_CHUNK`` max prompt tokens per prefill tick (default 32)
``GRAFT_SERVE_BUCKETS``       comma-separated prefill chunk buckets
                              (default "8,16,32")
``GRAFT_SERVE_SPEC_K``        speculative draft depth per decode tick
                              (default 0 = off; >= 2 adds the
                              ``[n_slots, k]`` verify program; greedy only)
``GRAFT_SERVE_KV_WIRE``       quantized KV pages: unset (dense) is the only
                              value the port takes (the quantized-KV slice)
``GRAFT_SERVE_TILE``          SwinIR tile edge (default 48)
``GRAFT_SERVE_TILE_BATCH``    tiles per SwinIR batch (default 4)
``GRAFT_SERVE_TILE_OVERLAP``  tile overlap in pixels (default 8)
============================  ==============================================

SLO knobs (``GRAFT_SERVE_SLO_*``, resolved by :func:`slo_knobs_from_env`
into the engines' ``observe.slo.SLOTracker``): ``GRAFT_SERVE_SLO_LATENCY_MS``
(default 60000), ``GRAFT_SERVE_SLO_TTFT_MS`` (default unset: latency only),
``GRAFT_SERVE_SLO_FRACTION`` (default 0.99), ``GRAFT_SERVE_SLO_WINDOW_S``
(default 60).
"""

from __future__ import annotations

import os

from ..observe.slo import slo_knobs_from_env

__all__ = [
    "AdmissionScheduler",
    "PagePool",
    "Request",
    "ServeEngine",
    "SwinIRTileServer",
    "TileRequest",
    "build_engine",
    "serve_knobs_from_env",
    "slo_knobs_from_env",
    "tile_knobs_from_env",
]


def _int_knob(env, name: str, default: int) -> int:
    raw = (env.get(name) or "").strip()
    return int(raw) if raw else default


def serve_knobs_from_env(env=None) -> dict:
    """Resolve the ``GRAFT_SERVE_*`` knob family into engine kwargs."""
    e = os.environ if env is None else env
    buckets_raw = (e.get("GRAFT_SERVE_BUCKETS") or "").strip()
    buckets = (tuple(sorted(int(x) for x in buckets_raw.split(",") if x.strip()))
               if buckets_raw else (8, 16, 32))
    return dict(
        n_slots=_int_knob(e, "GRAFT_SERVE_SLOTS", 4),
        page_size=_int_knob(e, "GRAFT_SERVE_PAGE", 16),
        num_pages=_int_knob(e, "GRAFT_SERVE_PAGES", 0) or None,
        max_len=_int_knob(e, "GRAFT_SERVE_MAX_LEN", 0) or None,
        prefill_chunk=_int_knob(e, "GRAFT_SERVE_PREFILL_CHUNK", 32),
        prefill_buckets=buckets,
        spec_k=_int_knob(e, "GRAFT_SERVE_SPEC_K", 0),
        kv_wire=(e.get("GRAFT_SERVE_KV_WIRE") or "").strip() or None,
    )


def tile_knobs_from_env(env=None) -> dict:
    """Resolve the SwinIR tiling knobs (``GRAFT_SERVE_TILE*``)."""
    e = os.environ if env is None else env
    return dict(
        tile=_int_knob(e, "GRAFT_SERVE_TILE", 48),
        tile_batch=_int_knob(e, "GRAFT_SERVE_TILE_BATCH", 4),
        overlap=_int_knob(e, "GRAFT_SERVE_TILE_OVERLAP", 8),
    )


def build_engine(model, params: dict | None = None, **overrides):
    """Engine for ``model`` (the ``Stoke.serve`` back end): a
    :class:`~.engine.ServeEngine` for the port's ``GPT2``, a
    :class:`~.tiles.SwinIRTileServer` for its ``SwinIR``. ``params`` (a
    state dict; default: the model's own) is copied into the engine, and
    env knobs fill what ``overrides`` leaves out. Engines run on
    ``"cuda"`` unless ``device=`` says otherwise.
    """
    from ..models.gpt2 import GPT2
    from ..models.swinir import SwinIR

    if params is None:
        params = model.state_dict()
    if isinstance(model, GPT2):
        from .engine import ServeEngine

        kw = serve_knobs_from_env()
        kw.update(overrides)
        return ServeEngine(model.cfg, params, **kw)
    if isinstance(model, SwinIR):
        from .tiles import SwinIRTileServer

        kw = tile_knobs_from_env()
        kw.update(overrides)
        return SwinIRTileServer(model, params, **kw)
    raise TypeError(f"no serving engine for {type(model).__name__}: GPT2 (continuous-batching "
                    "decode) and SwinIR (tiled super-resolution) are served")


def __getattr__(name):
    if name == "PagePool":
        from .kv_cache import PagePool

        return PagePool
    if name in ("Request", "AdmissionScheduler"):
        from . import scheduler

        return getattr(scheduler, name)
    if name == "ServeEngine":
        from .engine import ServeEngine

        return ServeEngine
    if name in ("SwinIRTileServer", "TileRequest"):
        from . import tiles

        return getattr(tiles, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
