"""SwinIR request tiling: tile, batch tiles across requests, stitch.

Counterpart of ``pytorch_distributedtraining_tpu/serve/tiles.py``.
Super-resolution requests arrive at any image size, and the server maps
each onto one fixed unit of work, a ``[tile_batch, tile, tile, C]`` batch:

- each image is cut into overlapping ``tile x tile`` tiles
  (:func:`tile_grid`: fixed stride, the last row and column clamped so
  tiles stay in bounds; images smaller than a tile are reflect-padded up
  first),
- tiles of all in-flight requests share one global FIFO, so a batch mixes
  requests; a short last batch is zero-padded to ``tile_batch``,
- outputs accumulate into per-request sum and weight canvases at upscaled
  coordinates (overlaps average, which suppresses seams); a finished
  canvas is normalised, cropped and delivered.

One program at one shape: request sizes change the number of tiles, never
the shape. The forward runs under ``torch.inference_mode()`` (and the
``compute_dtype`` autocast), so the port's SwinIR launches K1 (the window
attention forward kernel) once per Swin layer a batch on the card, and no
K2. Delivery passes the ``serve.client`` fault site (``raise`` =
disconnect, the request is cancelled and counted). Each request gets the
decode engine's lifecycle record: ``queue_wait`` until its first tile is
batched, one ``tile`` interval per batch it is resident in (tile count,
batch share, zero-padded-row fraction), ``stall`` and ``deliver``.
"""

from __future__ import annotations

import copy
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..observe import slo as _slo
from ..observe import trace
from ..precision import Policy
from ..resilience.faults import InjectedFault, fault_point
from ..runtime.dist import resolve_device


def tile_grid(h: int, w: int, tile: int, overlap: int) -> list[tuple[int, int]]:
    """(y, x) origins of ``tile x tile`` tiles covering ``h x w``.

    Stride ``tile - overlap``; the final row/column is clamped to
    ``h - tile`` / ``w - tile`` so every tile is in bounds. Needs ``h >=
    tile`` and ``w >= tile``: pad smaller images first.
    """
    if h < tile or w < tile:
        raise ValueError(f"image {h}x{w} smaller than tile {tile}")
    if not 0 <= overlap < tile:
        raise ValueError(f"overlap {overlap} must be in [0, tile)")
    stride = tile - overlap

    def starts(extent):
        out = list(range(0, extent - tile, stride))
        out.append(extent - tile)  # clamped last tile: exact coverage
        return sorted(set(out))

    return [(y, x) for y in starts(h) for x in starts(w)]


@dataclass
class TileRequest:
    """One super-resolution request: an ``[H, W, C]`` image."""

    rid: int
    image: np.ndarray
    arrival_s: float = 0.0


@dataclass
class _TileJob:
    rid: int
    y: int
    x: int


@dataclass
class _InFlight:
    req: TileRequest
    remaining: int
    sum_canvas: np.ndarray     # [pad_h*up, pad_w*up, C] accumulators
    weight_canvas: np.ndarray  # [pad_h*up, pad_w*up, 1]
    orig_hw: tuple[int, int] = (0, 0)  # pre-padding size, for the crop
    first_tile_s: float | None = None
    first_tile_pc: float | None = None  # TTFT on the lifecycle clock
    total_tiles: int = 0
    started: bool = False  # first tile batched -> queue_wait closed


class SwinIRTileServer:
    """Cross-request tile batching for SwinIR super-resolution.

    ``model``: an NHWC module with an ``upscale`` attribute (the port's
    ``SwinIR``). The server runs its own copy on ``device``, with
    ``params`` (a state dict) loaded into it when given, so later training
    steps do not reach it. ``compute_dtype`` (e.g. ``torch.bfloat16``)
    runs the forward under that autocast; None is f32.
    """

    def __init__(self, model: torch.nn.Module, params: dict | None = None, *, tile: int = 48,
                 tile_batch: int = 4, overlap: int = 8, slo: _slo.SLOTracker | None = None,
                 compute_dtype: torch.dtype | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = copy.deepcopy(model)
        if params is not None:
            self.model.load_state_dict(params)
        self.model.to(self.device).requires_grad_(False).eval()
        self.policy = Policy(compute_dtype)
        self.tile = int(tile)
        self.tile_batch = int(tile_batch)
        self.overlap = int(overlap)
        self.ledger = _slo.RequestLedger()
        self.slo = slo if slo is not None else _slo.SLOTracker(**_slo.slo_knobs_from_env())
        self.upscale = int(getattr(model, "upscale", 1))
        self.programs: set = set()  # input signatures dispatched so far
        self._queue: deque[_TileJob] = deque()  # global FIFO across requests
        self._inflight: dict[int, _InFlight] = {}
        self.delivered: list[dict] = []
        self.cancelled: list[int] = []
        self._occupancy_samples: list[float] = []
        self._warm = False
        self._steady_programs: int | None = None
        self._tick = 0

    # -- request intake ----------------------------------------------------

    def submit(self, req: TileRequest) -> None:
        img = np.asarray(req.image, np.float32)
        if img.ndim != 3:
            raise ValueError(f"request {req.rid}: expected [H, W, C] image")
        h, w, _ = img.shape
        pad_h, pad_w = max(h, self.tile), max(w, self.tile)
        if (pad_h, pad_w) != (h, w):  # small image: reflect-pad up to a tile
            img = np.pad(img, ((0, pad_h - h), (0, pad_w - w), (0, 0)), mode="reflect")
        grid = tile_grid(pad_h, pad_w, self.tile, self.overlap)
        up = self.upscale
        st = _InFlight(
            req=TileRequest(req.rid, img, req.arrival_s),
            remaining=len(grid), total_tiles=len(grid),
            sum_canvas=np.zeros((pad_h * up, pad_w * up, img.shape[2]), np.float32),
            weight_canvas=np.zeros((pad_h * up, pad_w * up, 1), np.float32),
            orig_hw=(h, w),
        )
        self._inflight[req.rid] = st
        self._queue.extend(_TileJob(req.rid, y, x) for (y, x) in grid)
        self.ledger.begin(req.rid)  # queue_wait clock starts at enqueue

    # -- the program -------------------------------------------------------

    def _apply(self, batch: np.ndarray) -> np.ndarray:
        """The tile-batch program: ``[tile_batch, tile, tile, C]`` f32 in,
        the upscaled batch out, on the host."""
        self.programs.add((batch.shape, str(batch.dtype)))
        with torch.inference_mode(), self.policy.autocast(self.device):
            out = self.model(torch.from_numpy(batch).to(self.device))
        return out.float().cpu().numpy()

    def warmup(self) -> float:
        """Run the single tile-batch program once; returns its seconds."""
        t0 = time.perf_counter()
        zeros = np.zeros((self.tile_batch, self.tile, self.tile, 3), np.float32)
        with trace.bucket_dispatch_span(self, "serve.tile", self.tile_batch):
            self._apply(zeros)
        self._warm = True
        self._steady_programs = len(self.programs)
        return time.perf_counter() - t0

    def steady_recompiles(self) -> int:
        if self._steady_programs is None:
            return 0
        return max(0, len(self.programs) - self._steady_programs)

    # -- tick loop ---------------------------------------------------------

    def tick(self, now: float) -> None:
        """Run one tile batch: pop up to ``tile_batch`` jobs (across
        requests), zero-pad the remainder, infer, accumulate, deliver."""
        if not self._queue:
            return
        jobs = [self._queue.popleft() for _ in range(min(self.tile_batch, len(self._queue)))]
        self._occupancy_samples.append(len(jobs) / self.tile_batch)
        chans = self._inflight[jobs[0].rid].req.image.shape[2]
        batch = np.zeros((self.tile_batch, self.tile, self.tile, chans), np.float32)
        for i, job in enumerate(jobs):
            st = self._inflight[job.rid]
            batch[i] = st.req.image[job.y: job.y + self.tile, job.x: job.x + self.tile]
            if not st.started:  # first residency: queue_wait ends here
                st.started = True
                self.ledger.note_admit(job.rid)
        t0 = time.perf_counter()
        with trace.bucket_dispatch_span(self, "serve.tile", self.tile_batch):
            out = self._apply(batch)
        t1 = time.perf_counter()
        # the batch interval bills to every resident request; share and
        # padding carry the cost split (zero-padded rows are the waste)
        per_rid: dict = {}
        for job in jobs:
            per_rid[job.rid] = per_rid.get(job.rid, 0) + 1
        pad = round(1.0 - len(jobs) / self.tile_batch, 4)
        for rid, n in per_rid.items():
            self.ledger.add_phase(rid, "tile", t0, t1, tiles=n, share=round(n / len(jobs), 4),
                                  padding_fraction=pad)
        up, ts = self.upscale, self.tile * self.upscale
        finished = []
        for i, job in enumerate(jobs):
            st = self._inflight[job.rid]
            if st.first_tile_s is None:
                st.first_tile_s = now
                st.first_tile_pc = t1
            y, x = job.y * up, job.x * up
            st.sum_canvas[y: y + ts, x: x + ts] += out[i]
            st.weight_canvas[y: y + ts, x: x + ts] += 1.0
            st.remaining -= 1
            if st.remaining == 0:
                finished.append(st)
        self._retire(finished, now)
        self._tick += 1

    def _retire(self, finished, now: float) -> None:
        for st in finished:
            del self._inflight[st.req.rid]
            t0 = time.perf_counter()
            try:
                fault_point("serve.client", rid=st.req.rid)
                ok = True
            except InjectedFault:
                ok = False
            t1 = time.perf_counter()
            self.ledger.add_phase(st.req.rid, "stall", t0, t1)
            if not ok:
                self.cancelled.append(st.req.rid)
                self.ledger.complete(st.req.rid, outcome=_slo.CANCELLED)
                continue
            h, w = st.orig_hw
            up = self.upscale
            td = time.perf_counter()
            img = st.sum_canvas / np.maximum(st.weight_canvas, 1e-8)
            rec = {
                "rid": st.req.rid,
                "image": img[: h * up, : w * up],
                "tiles": st.total_tiles,
                "latency_s": now - st.req.arrival_s,
                "ttft_s": (None if st.first_tile_s is None
                           else st.first_tile_s - st.req.arrival_s),
            }
            self.ledger.add_phase(st.req.rid, "deliver", td, time.perf_counter())
            life = self.ledger.complete(st.req.rid)
            rec.update(req_id=life["uid"], wall_s=life["wall_s"], phases=life["phases"])
            self.slo.observe(life["wall_s"], None if st.first_tile_pc is None
                             else st.first_tile_pc - life["t_start"])
            self.delivered.append(rec)

    def run(self, requests, *, realtime: bool = False) -> list[dict]:
        """Serve a trace of :class:`TileRequest`; the loop contract of
        :meth:`.engine.ServeEngine.run`."""
        if not self._warm:
            self.warmup()
        pending = sorted(requests, key=lambda r: r.arrival_s)
        t0 = time.monotonic()
        while pending or self._queue or self._inflight:
            now = time.monotonic() - t0 if realtime else float(self._tick)
            while pending and (not realtime or pending[0].arrival_s <= now):
                self.submit(pending.pop(0))
            if not self._queue and pending:
                time.sleep(0.0005)
                continue
            self.tick(now)
        return self.delivered

    # -- reporting ---------------------------------------------------------

    def metrics(self) -> dict:
        return {
            "delivered": len(self.delivered),
            "cancelled_at_delivery": len(self.cancelled),
            "ticks": self._tick,
            "mean_batch_occupancy": (float(np.mean(self._occupancy_samples))
                                     if self._occupancy_samples else 0.0),
            "steady_recompiles": self.steady_recompiles(),
            "slo": self.slo.snapshot(),
        }

    def tail_attribution(self, q: float = 99.0) -> dict:
        """Phase attribution of the latency tail (>= q-th percentile)."""
        return _slo.tail_attribution(self.ledger.completed, q=q)

    def export_serve_trace(self, path: str | None = None) -> str:
        """Write completed lifecycles as the ``graft-serve`` lane."""
        return _slo.export_serve_trace(self.ledger.completed, path)
