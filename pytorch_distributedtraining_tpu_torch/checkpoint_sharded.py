"""Sharded checkpoints and run management: the save and restore path at scale.

Counterpart of ``pytorch_distributedtraining_tpu/checkpoint_sharded.py``.
``checkpoint.py`` is the consolidated format (everything gathered, rank 0
writes one ``.pt``). This module is the path where every rank writes its
own share, in two formats:

- :func:`save_sharded` / :func:`restore_sharded` over
  ``torch.distributed.checkpoint`` (DCP, shipped with torch), in place of
  JAX's orbax: sharded state goes in as ``DTensor``\\ s (FSDP2's own, and
  ZeRO-1/2 moment shards or ``FusedAdamW``'s flat slice wrapped over the
  data axis), so each rank writes only its shard, and the restore loads
  straight into the live tensors. Transient write errors retry through
  ``resilience.outage.RetryPolicy``.
- the **portable format**, :func:`save_portable` / :func:`restore_portable`
  / :func:`reshard_restore`, byte for byte the JAX package's container:
  ``manifest.json`` (``format: "graft-portable-ckpt"``, ``version: 1``,
  each leaf's global ``shape``, ``dtype`` and ``spec``, the world size and
  a nonce), one ``shards_r{rank}.npz`` a rank with its ``.json`` sidecar
  (fsynced, then renamed into place), and a ``_COMMIT`` marker written
  last, after which ``<dir>.tmp`` is renamed to ``<dir>``. A kill at any
  point leaves a ``.tmp`` dir or a marker-less one, and both are skipped
  by :meth:`CheckpointManager.restore_latest`. Restore assembles each
  leaf's global array from every rank's pieces and re-places it onto the
  live state's layout, so a checkpoint taken under one policy and world
  size resumes under another: DDP, ZeRO-1/2 shards and FSDP2 ``DTensor``\\ s,
  moments included.
- :class:`CheckpointManager`: a save every N steps keeping the last k,
  discovery of the newest committed step for auto-resume, a SIGTERM hook
  that forces a save at the next step boundary (agreed across ranks), and
  an async writer: the step path pays only the copy to host memory, and
  one background thread serializes and commits, one save in flight, with
  a host-memory budget (``GRAFT_CKPT_HOST_BUDGET_MB``) above which the
  write is synchronous.

The unit saved is a :class:`~.parallel.state.TrainState` plus ``meta``, a
dict of numbers, lists, tensors and dicts of them (the facade's step, lr,
loss scaler, ...). Its leaves are named by the port's own paths:
``params/<state-dict key>``, ``opt_state/count`` and
``opt_state/{mu,nu,ema,trace}/<parameter name>`` (``FusedAdamW``'s flat
moments are kept per parameter, so they restore into either optimizer),
``rng/seed`` and ``rng/step`` (the train state's step stream, where it has
one) and ``meta/<key>``. Only the container is JAX's: a JAX checkpoint's
leaves are ``keystr`` paths, and its parameters reach the port's models
through the ``interop`` key maps (``interop.params_from_jax_portable``).

Two choices differ from a plain copy of the JAX module:

- A bfloat16 leaf is written as its float32 values (exact) with
  ``dtype: "bfloat16"`` in the manifest. JAX's writer leaves the raw
  bits (numpy's ``|V2``), which JAX's own reader cannot assign into an
  ``ml_dtypes`` bfloat16 array ("No cast function available"); float32
  values it can. This module reads both.
- The snapshot copies each piece to (pinned) host memory on the compute
  stream and waits for the copies before it returns, so the next
  ``step()``'s in-place update cannot reach the snapshot; the writer
  thread gets host arrays only and makes no collective call.

Every rank takes part in ``save_portable``, ``save_sharded``,
``CheckpointManager.save`` and ``maybe_save`` (the nonce agreement, the
SIGTERM agreement and the gathers of ``FusedAdamW``'s ZeRO-1 moments are
collectives, made on the main thread at a step boundary). The environment
knobs are ``GRAFT_CKPT_WRITE_ATTEMPTS`` (tries of a sharded write, default
3), ``GRAFT_CKPT_COMMIT_TIMEOUT`` (seconds a portable commit waits for
every rank's payload, default 120) and ``GRAFT_CKPT_HOST_BUDGET_MB``
(default 4096).
"""

from __future__ import annotations

import glob
import json
import os
import queue
import re
import shutil
import signal
import sys
import threading
import time
import uuid
import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as tdist

from .observe import trace as telemetry
from .resilience.faults import fault_point
from .resilience.outage import OutageClass, RetryPolicy, classify_exception

PORTABLE_FORMAT = "graft-portable-ckpt"
PORTABLE_VERSION = 1
MANIFEST_NAME = "manifest.json"
COMMIT_MARKER = "_COMMIT"

# live counters, JAX's keys: a run that initiated saves but never observed
# a commit has a dead async writer; a restore whose template disagreed
# with the manifest is recorded with the leaves named
runtime_stats: dict = {
    "save_every": None,
    "saves_initiated": 0,
    "commits_observed": 0,
    "last_snapshot_s": None,
    "last_write_error": None,
    "manifest_mismatches": [],
    "forced_saves": 0,
    # only rank 0 commits, so commits_observed stays 0 on other ranks
    "process_index": None,
}


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def _world() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def _collective_device() -> torch.device:
    """Where a small collective's tensor lives: the card under NCCL."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for a torch dtype (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


# -- the train state as leaves ------------------------------------------------


class Leaf(NamedTuple):
    """One array of the state: its global shape and dtype, the mesh axis of
    each sharded dimension (``spec``, None for a leaf every rank holds
    whole), and the pieces this rank writes, ``[(index, tensor)]`` with
    ``index`` as ``[[start, stop], ...]`` per dimension."""

    path: str
    shape: tuple
    dtype: torch.dtype
    spec: list | None
    pieces: list


def _whole(path: str, t: torch.Tensor) -> Leaf:
    """A leaf every rank holds whole: rank 0 writes it."""
    t = t.detach()
    index = [[0, int(n)] for n in t.shape]
    return Leaf(path, tuple(t.shape), t.dtype, None, [(index, t)] if _rank() == 0 else [])


def _sharded(path: str, shape, t: torch.Tensor, index: list, axis: str) -> Leaf:
    spec = [None if (a, b) == (0, int(n)) else axis for (a, b), n in zip(index, shape)]
    pieces = [(index, t.detach())] if t.numel() else []
    return Leaf(path, tuple(int(n) for n in shape), t.dtype, spec, pieces)


def _data_axis(mesh) -> str:
    from .runtime.mesh import DATA_AXES, mesh_axis_size

    if mesh is None:
        return "fsdp"
    return next((a for a in DATA_AXES if mesh_axis_size(mesh, a) > 1), "fsdp")


def _as_meta_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, int):
        return torch.tensor(v, dtype=torch.int64)
    if isinstance(v, float):
        return torch.tensor(v, dtype=torch.float64)
    if isinstance(v, (list, tuple)):
        ints = all(isinstance(x, int) for x in v)
        return torch.as_tensor(np.asarray(v, dtype=np.int64 if ints else None))
    raise TypeError(f"checkpoint meta holds numbers, lists, tensors and dicts; got "
                    f"{type(v).__name__}")


def _flat_meta(meta: dict | None, prefix: str = "") -> dict[str, torch.Tensor]:
    """``meta`` as ``{"a/b": tensor}``; None values are left out."""
    out = {}
    for k, v in (meta or {}).items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat_meta(v, f"{key}/"))
        elif v is not None:
            out[key] = _as_meta_tensor(v)
    return out


def _nested_meta(flat: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`_flat_meta`: 0-d tensors become Python numbers."""
    out: dict = {}
    for key, t in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.item() if t.dim() == 0 else t
    return out


def _is_fused(tx) -> bool:
    from .optim import FusedAdamW

    return isinstance(tx, FusedAdamW)


def state_leaves(state, meta: dict | None = None) -> list[Leaf]:
    """The leaves of ``state`` (a ``TrainState``) and ``meta``, each with
    this rank's pieces: FSDP2 parameters and ZeRO-1/2 moment shards from
    every rank, the rest whole from rank 0. ``FusedAdamW``'s moments are
    cut per parameter (gathered first under ZeRO-1: a collective)."""
    from .parallel.spec import dim0_chunk_start, is_dtensor

    state.tx.settle()  # offloaded state: the host copies, complete
    axis = _data_axis(state.mesh)
    leaves = []
    for name, t in state.module.state_dict().items():
        if is_dtensor(t):
            local, mesh = t.to_local(), t.device_mesh
            start = dim0_chunk_start(t.shape[0], mesh.get_local_rank(), mesh.size())
            index = [[start, start + int(local.shape[0])]] + [[0, int(n)] for n in t.shape[1:]]
            leaves.append(_sharded(f"params/{name}", t.shape, local, index, axis))
        else:
            leaves.append(_whole(f"params/{name}", t))
    tx = state.tx
    if _is_fused(tx):
        sd = tx.leaf_state_dict()
        leaves.append(_whole("opt_state/count", torch.tensor(sd["count"], dtype=torch.int64)))
        for key in ("mu", "nu", "ema"):
            for name, t in (sd[key] or {}).items():
                leaves.append(_whole(f"opt_state/{key}/{name}", t))
    else:
        leaves.append(_whole("opt_state/count", torch.tensor(tx.count, dtype=torch.int64)))
        for key in tx.STATE:
            for i, (name, p, t) in enumerate(zip(tx.names, tx.params, getattr(tx, key) or [])):
                index = None if tx.shard is None else tx.shard.index(i, p, t.shape)
                path = f"opt_state/{key}/{name}"
                leaves.append(_whole(path, t) if index is None
                              else _sharded(path, p.shape, t, index, axis))
    for key, t in _rng_leaves(state).items():
        leaves.append(_whole(key, t))
    for key, t in _flat_meta(meta).items():
        leaves.append(_whole(f"meta/{key}", t))
    return leaves


def _rng_leaves(state) -> dict[str, torch.Tensor]:
    """The step stream's ``rng/seed`` and ``rng/step`` (none without one)."""
    rng = getattr(state, "rng", None)
    if rng is None:
        return {}
    return {f"rng/{k}": torch.tensor(v, dtype=torch.int64) for k, v in rng.state_dict().items()}


def _load_rng(state, values: dict) -> None:
    """Put ``{"seed", "step"}`` back into the step stream, where both sides
    have one (an older checkpoint has none)."""
    rng = getattr(state, "rng", None)
    if rng is not None and {"seed", "step"} <= set(values):
        rng.load_state_dict({k: int(values[k]) for k in ("seed", "step")})


def template_of(state) -> dict[str, tuple[tuple, torch.dtype]]:
    """``{path: (global shape, dtype)}`` of the parameter and optimizer
    leaves of ``state``, as :func:`state_leaves` names them (no copy, no
    collective)."""
    want = {f"params/{k}": (tuple(v.shape), v.dtype)
            for k, v in state.module.state_dict().items()}
    tx = state.tx
    want["opt_state/count"] = ((), torch.int64)
    if _is_fused(tx):
        for key in ("mu", "nu", "ema"):
            if getattr(tx.state, key) is not None:
                want.update({f"opt_state/{key}/{n}": (tuple(p.shape), torch.float32)
                             for n, p in zip(tx.names, tx.params)})
    else:
        for key in tx.STATE:
            for n, p, t in zip(tx.names, tx.params, getattr(tx, key) or []):
                want[f"opt_state/{key}/{n}"] = (tuple(p.shape), t.dtype)
    return want


def load_state(state, arrays: dict[str, torch.Tensor]) -> dict:
    """Put whole arrays ``{path: tensor}`` (as :func:`state_leaves` names
    them) into ``state`` in place: the module's state through
    ``load_module_state`` (each FSDP2 rank its chunk), the optimizer's
    through its ``load_state_dict`` (each rank its share). Returns the
    ``meta`` dict."""
    from .parallel.state import load_module_state

    params = {k[len("params/"):]: v for k, v in arrays.items() if k.startswith("params/")}
    state.tx.settle()  # into the master parameters (host ones if offloaded)
    load_module_state(state.module, params)
    tx = state.tx
    opt: dict = {"count": int(arrays["opt_state/count"])}
    for key in ("mu", "nu", "ema") if _is_fused(tx) else tx.STATE:
        pre = f"opt_state/{key}/"
        opt[key] = {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)} or None
    tx.load_state_dict(opt)
    _load_rng(state, {k[len("rng/"):]: v for k, v in arrays.items() if k.startswith("rng/")})
    return _nested_meta({k[len("meta/"):]: v for k, v in arrays.items()
                         if k.startswith("meta/")})


# -- sharded format (torch.distributed.checkpoint) ------------------------------


def _dcp_state(state, meta: dict | None = None) -> dict:
    """The live state as a DCP state dict whose tensors share storage with
    it: sharded pieces as ``DTensor``\\ s over the data axis."""
    from .parallel.spec import _dtensor_type, is_dtensor

    def wrap(local, mesh, placements, shape):
        shape = tuple(int(n) for n in shape)
        stride = tuple(int(s) for s in torch.empty(shape, device="meta").stride())
        return _dtensor_type().from_local(local, mesh, placements, run_check=False,
                                          shape=shape, stride=stride)

    from torch.distributed.tensor import Shard

    state.tx.settle()

    tx = state.tx
    axis = _data_axis(state.mesh)
    opt: dict = {}
    if _is_fused(tx):
        opt["count"] = tx.state.count
        for key in ("mu", "nu", "ema"):
            flat = getattr(tx.state, key)
            if flat is None:
                continue
            opt[key] = flat if tx.shard_group is None else wrap(
                flat, state.mesh[axis], [Shard(0)], tx.flat_param.shape)
    else:
        opt["count"] = torch.tensor(tx.count, dtype=torch.int64)
        for key in tx.STATE:
            vals = getattr(tx, key)
            if vals is None:
                continue
            entry = {}
            for i, (name, p, t) in enumerate(zip(tx.names, tx.params, vals)):
                if tx.shard is None or not tx.shard.sharded(i):
                    entry[name] = t
                elif tx.shard.dtensor:
                    entry[name] = (wrap(t, p.device_mesh, p.placements, p.shape)
                                   if is_dtensor(p) else t)
                else:
                    entry[name] = wrap(t, state.mesh[axis], [Shard(tx.shard.dims[i])], p.shape)
            opt[key] = entry
    out = {"params": state.module.state_dict(), "opt_state": opt, "meta": _flat_meta(meta)}
    rng = {k[len("rng/"):]: v for k, v in _rng_leaves(state).items()}
    if rng:
        out["rng"] = rng
    return out


def _dcp_call(fn, sd: dict, path: str) -> None:
    """``dcp.save`` or ``dcp.load`` of ``sd`` at ``path``: without a process
    group in one-process mode, whose every call warns that it assumes so."""
    if tdist.is_initialized():
        fn(sd, checkpoint_id=path)
        return
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        fn(sd, checkpoint_id=path, no_dist=True)


def _write_attempts() -> RetryPolicy:
    return RetryPolicy(attempts=int(os.environ.get("GRAFT_CKPT_WRITE_ATTEMPTS", "3")),
                       base_delay_s=0.5, max_delay_s=10.0)


def save_sharded(path: str, state, meta: dict | None = None, *,
                 retry: RetryPolicy | None = None) -> str:
    """Write ``state`` (a ``TrainState``) and ``meta`` as a DCP checkpoint
    in the directory ``path``: every rank writes its own shards (a
    collective). A write error the outage classifier calls OUTAGE (``EIO``
    on a flaky mount, a reset connection) is retried with backoff, up to
    ``GRAFT_CKPT_WRITE_ATTEMPTS`` tries; anything else propagates. The
    retry is per rank: a failure on some ranks only still needs a
    relaunch."""
    import torch.distributed.checkpoint as dcp

    path = _abs(path)
    sd = _dcp_state(state, meta)

    def write():
        # the injected error surfaces where a real one would: at the write
        fault_point("checkpoint.write", path=path)
        with telemetry.span("checkpoint.write", "checkpoint", path=path):
            _dcp_call(dcp.save, sd, path)

    (retry or _write_attempts()).run(
        write, retry_on=lambda e: classify_exception(e) is OutageClass.OUTAGE)
    return path


def restore_sharded(path: str, state) -> dict:
    """Load a :func:`save_sharded` checkpoint into ``state`` in place (DCP
    re-slices ``DTensor`` shards for this layout; the optimizer must be of
    the same kind and, for ``FusedAdamW``, the same flat layout as the one
    saved). Returns the ``meta`` dict."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    path = _abs(path)
    sd = _dcp_state(state)
    saved = FileSystemReader(path).read_metadata().state_dict_metadata
    for key, md in saved.items():
        if key.startswith("meta."):
            sd["meta"][key[len("meta."):]] = torch.empty(
                tuple(md.size), dtype=md.properties.dtype)
    if "rng.step" not in saved:  # saved without a step stream
        sd.pop("rng", None)
    _dcp_call(dcp.load, sd, path)
    tx = state.tx
    if not _is_fused(tx):
        tx.count = int(sd["opt_state"]["count"])
    _load_rng(state, sd.get("rng", {}))
    return _nested_meta(sd["meta"])


# -- portable (topology-independent) format ------------------------------------


def _host_copies(leaves: list[Leaf]) -> list[list]:
    """Each leaf's pieces copied to host memory: pinned buffers filled by
    non-blocking copies on the current stream, then one wait, so the
    snapshot is complete (and no later in-place update reaches it) when
    this returns."""
    out, cuda = [], False
    for leaf in leaves:
        pieces = []
        for index, t in leaf.pieces:
            if t.device.type == "cuda":
                host = torch.empty(tuple(t.shape), dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                cuda = True
            else:
                host = t.clone(memory_format=torch.contiguous_format)
            pieces.append((index, host))
        out.append(pieces)
    if cuda:
        torch.cuda.current_stream().synchronize()
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bfloat16 as its float32 values (exact)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class _HostSnapshot:
    """A host copy of one state: ``leaves`` is ``[(path, shape, dtype
    name, spec, shards)]`` with ``shards`` this rank's ``[(index,
    np.ndarray)]``."""

    def __init__(self, leaves: list[Leaf]):
        self.leaves = []
        self.nbytes = 0
        for leaf, pieces in zip(leaves, _host_copies(leaves)):
            shards = [(index, _to_numpy(host)) for index, host in pieces]
            self.nbytes += sum(a.nbytes for _, a in shards)
            self.leaves.append((leaf.path, tuple(leaf.shape), _dtype_name(leaf.dtype),
                                leaf.spec, shards))

    def manifest(self, step: int | None = None) -> dict:
        return {
            "format": PORTABLE_FORMAT,
            "version": PORTABLE_VERSION,
            "step": step,
            "world_size": _world(),
            "leaves": {p: {"shape": list(shape), "dtype": dtype, "spec": spec}
                       for p, shape, dtype, spec, _ in self.leaves},
        }


def snapshot_to_host(state, meta: dict | None = None) -> _HostSnapshot:
    """The copy of ``state`` and ``meta`` to host memory, the only cost an
    async save puts on the step path (timed into ``runtime_stats``)."""
    t0 = time.perf_counter()
    with telemetry.span("checkpoint.snapshot", "checkpoint"):
        snap = _HostSnapshot(state_leaves(state, meta))
    runtime_stats["last_snapshot_s"] = time.perf_counter() - t0
    return snap


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # a platform without directory descriptors
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _agree_nonce() -> str:
    """One write-attempt stamp every rank agrees on (rank 0's uuid): a
    broadcast, so call it from the main thread at a point every rank
    reaches in the same order (``CheckpointManager.save`` does). Over NCCL
    it goes as a CUDA tensor on this rank's card, over gloo as an object.
    Other ranks' writers enter a staging dir only after seeing a manifest
    with this nonce, so it also keeps them out of a dir rank 0 is about to
    clear."""
    local = uuid.uuid4().hex
    if _world() == 1:
        return local
    if tdist.get_backend() == "nccl":
        t = torch.tensor(list(bytes.fromhex(local)), dtype=torch.uint8,
                         device=_collective_device())
        tdist.broadcast(t, src=0)
        return bytes(t.cpu().tolist()).hex()
    obj = [local]
    tdist.broadcast_object_list(obj, src=0)
    return obj[0]


def _commit_deadline() -> float:
    return time.monotonic() + float(os.environ.get("GRAFT_CKPT_COMMIT_TIMEOUT", "120"))


def _wait_manifest_nonce(tmp_dir: str, expect: str | None) -> str:
    """Ranks other than 0: wait until rank 0's manifest for this attempt is
    visible and return its nonce. A manifest a crashed earlier attempt
    left carries another nonce and is waited out, so this rank's payload
    never lands in a dir rank 0 is about to clear."""
    deadline = _commit_deadline()
    man = os.path.join(tmp_dir, MANIFEST_NAME)
    while True:
        try:
            with open(man, encoding="utf-8") as fh:
                nonce = json.load(fh).get("nonce")
            if nonce is not None and (expect is None or nonce == expect):
                return nonce
        except (OSError, ValueError):
            pass  # not there yet, or mid-write
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint write: no manifest for attempt "
                               f"{expect or '<any>'} appeared in {tmp_dir}")
        time.sleep(0.05)


def _write_rank_shards(tmp_dir: str, snap: _HostSnapshot, rank: int, nonce: str) -> None:
    """This rank's payload and sidecar. The ``.json`` sidecar is written and
    fsynced after the ``.npz`` and renamed into place: its appearance says
    the payload is durable. The nonce scopes it to this attempt."""
    arrays: dict = {}
    entries = []
    for i, (pstr, _shape, _dtype, _spec, shards) in enumerate(snap.leaves):
        for j, (index, arr) in enumerate(shards):
            key = f"L{i}_S{j}"
            arrays[key] = arr
            entries.append({"key": key, "leaf": pstr, "index": index})
    npz = os.path.join(tmp_dir, f"shards_r{rank}.npz")
    np.savez(npz, **arrays)
    _fsync_file(npz)
    sidecar = os.path.join(tmp_dir, f"shards_r{rank}.json")
    with open(sidecar + ".part", "w", encoding="utf-8") as fh:
        json.dump({"rank": rank, "nonce": nonce, "entries": entries}, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.rename(sidecar + ".part", sidecar)


def _ranks_present(tmp_dir: str, nonce: str) -> set:
    """Ranks whose sidecar for this attempt has landed."""
    have = set()
    for sidecar in glob.glob(os.path.join(tmp_dir, "shards_r*.json")):
        try:
            with open(sidecar, encoding="utf-8") as fh:
                meta = json.load(fh)
        except (OSError, ValueError):
            continue
        if meta.get("nonce") == nonce:
            have.add(int(meta.get("rank", -1)))
    return have


def _commit_portable(tmp_dir: str, final_dir: str, world_size: int, step: int | None,
                     nonce: str) -> None:
    """Rank 0's commit: wait for every rank's sidecar of this attempt,
    write the marker, fsync, rename ``<dir>.tmp`` to ``<dir>``."""
    deadline = _commit_deadline()
    while True:
        have = _ranks_present(tmp_dir, nonce)
        if have >= set(range(world_size)):
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"checkpoint commit: only {len(have)}/{world_size} rank payloads for attempt "
                f"{nonce} arrived in {tmp_dir}; leaving the dir torn (un-renamed)")
        time.sleep(0.05)
    marker = os.path.join(tmp_dir, COMMIT_MARKER)
    with open(marker, "w", encoding="utf-8") as fh:
        json.dump({"step": step, "t": time.time(), "ranks": world_size, "nonce": nonce}, fh)
        fh.flush()
        os.fsync(fh.fileno())
    _fsync_dir(tmp_dir)
    os.rename(tmp_dir, final_dir)
    _fsync_dir(os.path.dirname(final_dir) or ".")
    runtime_stats["commits_observed"] += 1
    telemetry.instant("ckpt.commit", "checkpoint", path=final_dir, step=step)


def write_portable(path: str, snap: _HostSnapshot, *, step: int | None = None,
                   nonce: str | None = None) -> str:
    """Serialize a host snapshot with the commit protocol: rank 0 clears a
    staging dir an earlier attempt left, writes the manifest, waits for
    every rank's payload stamped with ``nonce``, writes ``_COMMIT`` and
    renames; the other ranks wait for that manifest and write their
    payload. A kill anywhere leaves a dir :meth:`CheckpointManager.
    all_steps` never lists. Pass :func:`_agree_nonce`'s result from
    several ranks; without one, ranks other than 0 adopt the nonce of the
    manifest they see."""
    path = _abs(path)
    tmp_dir = path + ".tmp"
    rank, world = _rank(), _world()
    runtime_stats["process_index"] = rank
    if rank == 0:
        if nonce is None:
            nonce = uuid.uuid4().hex
        if os.path.isdir(tmp_dir):
            shutil.rmtree(tmp_dir)  # an earlier attempt's payloads must not count
        os.makedirs(tmp_dir)
    # a kill or delay here, inside the (background) writer, leaves a torn dir
    fault_point("ckpt.write", path=path, step=step, rank=rank)
    if rank == 0:
        manifest = snap.manifest(step)
        manifest["nonce"] = nonce
        man = os.path.join(tmp_dir, MANIFEST_NAME)
        with open(man, "w", encoding="utf-8") as fh:
            json.dump(manifest, fh)
            fh.flush()
            os.fsync(fh.fileno())
    else:
        nonce = _wait_manifest_nonce(tmp_dir, nonce)
    _write_rank_shards(tmp_dir, snap, rank, nonce)
    if rank == 0:
        _commit_portable(tmp_dir, path, world, step, nonce)
    return path


def save_portable(path: str, state, meta: dict | None = None, *,
                  step: int | None = None) -> str:
    """Synchronous snapshot and portable write, commit included. Every rank
    calls it (the nonce is agreed collectively)."""
    runtime_stats["saves_initiated"] += 1
    nonce = _agree_nonce()
    snap = snapshot_to_host(state, meta)
    with telemetry.span("checkpoint.write", "checkpoint", path=path):
        return write_portable(path, snap, step=step, nonce=nonce)


def is_portable_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MANIFEST_NAME))


def is_committed_dir(path: str) -> bool:
    """A complete portable checkpoint: manifest and commit marker, and not a
    ``*.tmp`` staging dir."""
    return (not path.rstrip(os.sep).endswith(".tmp") and is_portable_dir(path)
            and os.path.isfile(os.path.join(path, COMMIT_MARKER)))


def read_manifest(path: str) -> dict:
    with open(os.path.join(_abs(path), MANIFEST_NAME), encoding="utf-8") as fh:
        return json.load(fh)


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """A bfloat16 payload as uint16 bits: JAX's raw ``|V2`` entries as they
    are, float32 values (the port's) rounded (exactly) to bfloat16."""
    if a.dtype.kind == "V":
        return a.view(np.uint16)
    return torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _assemble_host_tree(path: str) -> tuple[dict, dict]:
    """``(manifest, {leaf path: whole np.ndarray})`` from a committed
    portable dir, every rank's pieces placed by global index. Only
    sidecars stamped with the manifest's nonce, from a rank inside its
    world, count. A bfloat16 leaf comes back as its uint16 bits
    (:func:`host_tensor` makes it a tensor)."""
    path = _abs(path)
    manifest = read_manifest(path)
    leaves = manifest["leaves"]
    nonce = manifest.get("nonce")
    world = manifest.get("world_size")
    out: dict = {}
    for sidecar in sorted(glob.glob(os.path.join(path, "shards_r*.json"))):
        with open(sidecar, encoding="utf-8") as fh:
            meta = json.load(fh)
        if nonce is not None and meta.get("nonce") != nonce:
            continue  # a stale attempt
        if world is not None and not 0 <= int(meta.get("rank", -1)) < world:
            continue  # a rank from an old, larger world
        with np.load(sidecar[: -len(".json")] + ".npz") as npz:
            for entry in meta["entries"]:
                pstr = entry["leaf"]
                info = leaves[pstr]
                bf16 = info["dtype"] == "bfloat16"
                if pstr not in out:
                    out[pstr] = np.empty(tuple(info["shape"]),
                                         dtype=np.uint16 if bf16 else np.dtype(info["dtype"]))
                idx = tuple(slice(a, b) for a, b in entry["index"])
                piece = npz[entry["key"]]
                out[pstr][idx] = _bf16_bits(piece) if bf16 else piece
    missing = set(leaves) - set(out)
    if missing:
        raise ValueError(f"portable checkpoint {path} is missing shard data for "
                         f"{sorted(missing)[:5]}{'...' if len(missing) > 5 else ''}")
    return manifest, out


def host_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A host array of :func:`_assemble_host_tree` as a tensor of the
    manifest's ``dtype``."""
    t = torch.from_numpy(np.require(arr, requirements="C"))  # keeps 0-d arrays 0-d
    return t.view(torch.int16).view(torch.bfloat16) if dtype == "bfloat16" else t


def _record_mismatch(msg: str) -> None:
    runtime_stats["manifest_mismatches"].append(msg)


def reshard_restore(path: str, state) -> dict:
    """Restore a portable checkpoint into ``state`` (a ``TrainState``), in
    place, onto its own layout, whatever the layout and world size that
    saved it: each leaf's global array is assembled from every rank's
    pieces and each rank takes its share (DDP replicas, ZeRO-1/2 moment
    shards, FSDP2 chunks, ``FusedAdamW``'s flat slice). A leaf whose
    shape or dtype disagrees with the live one raises ``ValueError``
    naming the leaves, recorded in ``runtime_stats``. Returns the
    ``meta`` dict."""
    path = _abs(path)
    manifest, host = _assemble_host_tree(path)
    want = template_of(state)
    dtypes = {p: info["dtype"] for p, info in manifest["leaves"].items()}
    problems = []
    for pstr, (shape, dtype) in want.items():
        if pstr not in host:
            problems.append(f"{pstr}: absent from checkpoint manifest")
            continue
        got = (tuple(host[pstr].shape), dtypes.get(pstr, str(host[pstr].dtype)))
        if got != (tuple(shape), _dtype_name(dtype)):
            problems.append(f"{pstr}: checkpoint {got[0]}/{got[1]} vs template "
                            f"{tuple(shape)}/{_dtype_name(dtype)}")
    if problems:
        for p in problems:
            _record_mismatch(p)
        raise ValueError(f"reshard_restore: template disagrees with checkpoint manifest "
                         f"({path}): " + "; ".join(problems[:5])
                         + ("..." if len(problems) > 5 else ""))
    arrays = {p: host_tensor(a, dtypes.get(p, str(a.dtype))) for p, a in host.items()
              if p in want or p.startswith(("meta/", "rng/"))}
    return load_state(state, arrays)


def restore_portable(path: str, state) -> dict:
    """Restore a portable checkpoint into ``state`` (:func:`reshard_restore`:
    a resume at the same layout is the case where nothing moves)."""
    return reshard_restore(path, state)


# -- background writer -----------------------------------------------------------


class _AsyncWriter:
    """One daemon thread serializing host snapshots off the step path.

    At most one write is in flight (``submit`` drains the previous one).
    A failed write leaves its torn ``.tmp`` dir (restore skips it) and
    reports the error in ``runtime_stats`` and on stderr without killing
    the training process.
    """

    def __init__(self):
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._idle = threading.Event()
        self._idle.set()
        self._thread = threading.Thread(target=self._run, name="ckpt-writer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            path, snap, step, nonce = item
            try:
                with telemetry.span("checkpoint.write.bg", "checkpoint", path=path):
                    write_portable(path, snap, step=step, nonce=nonce)
            except BaseException as e:  # noqa: BLE001 -- must not die silently
                runtime_stats["last_write_error"] = f"{type(e).__name__}: {e}"
                print(f"[ckpt] background write of {path} failed ({type(e).__name__}: {e}); "
                      "torn dir left for restore_latest to skip", file=sys.stderr, flush=True)
            finally:
                self._idle.set()

    @property
    def in_flight(self) -> bool:
        return not self._idle.is_set()

    def submit(self, path: str, snap: _HostSnapshot, step: int, nonce: str) -> None:
        self.drain()
        self._idle.clear()
        self._q.put((path, snap, step, nonce))

    def drain(self) -> None:
        self._idle.wait()

    def close(self) -> None:
        if self._thread.is_alive():
            self.drain()
            self._q.put(None)
            self._thread.join(timeout=30.0)


class CheckpointManager:
    """Step-based run checkpointing with GC, resume and a preemption save.

    Layout: ``<root>/step_<N>/`` portable dirs (commit protocol; DCP dirs
    from :func:`save_sharded` restore too). :meth:`latest_step` is the
    newest committed step: a ``*.tmp`` staging dir or a marker-less dir
    from a kill mid-write is never a resume source. :meth:`maybe_save`
    saves every ``save_every`` steps, or at once when a SIGTERM arrived on
    any rank, waiting for the write so it is on disk before the job dies.
    With ``async_save`` :meth:`save` returns after the copy to host memory
    and a background thread writes and commits; a snapshot above the
    host budget (``host_budget_mb``, else ``GRAFT_CKPT_HOST_BUDGET_MB``,
    default 4096) is written synchronously instead of holding a second
    copy in a queue. ``handle_sigterm`` installs the handler only in the
    main thread, chains to the one it replaced, and :meth:`close` puts
    that one back.
    """

    def __init__(self, root: str, *, save_every: int = 1000, keep: int = 3,
                 handle_sigterm: bool = True, async_save: bool = False,
                 host_budget_mb: float | None = None):
        self.root = _abs(root)
        self.save_every = int(save_every)
        self.keep = int(keep)
        self._preempted = threading.Event()
        self._prev_handler = None
        self._installed = False
        self.async_save = bool(async_save)
        budget = (host_budget_mb if host_budget_mb is not None
                  else os.environ.get("GRAFT_CKPT_HOST_BUDGET_MB", "4096"))
        self.host_budget_bytes = int(float(budget) * 1024 * 1024)
        self._writer = _AsyncWriter() if async_save else None
        runtime_stats["save_every"] = self.save_every
        runtime_stats["process_index"] = _rank()
        os.makedirs(self.root, exist_ok=True)
        if handle_sigterm and threading.current_thread() is threading.main_thread():
            self._prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
            self._installed = True

    # -- preemption -------------------------------------------------------

    def _on_sigterm(self, signum, frame):
        self._preempted.set()
        if callable(self._prev_handler):
            self._prev_handler(signum, frame)

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()

    # -- paths ------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)", name)
            d = os.path.join(self.root, name)
            if not (m and os.path.isdir(d) and os.listdir(d)):
                continue
            if is_portable_dir(d) and not is_committed_dir(d):
                continue  # torn portable dir: a manifest but no _COMMIT
            # a DCP dir carries no marker; it counts once its metadata exists
            if not is_portable_dir(d) and not os.path.isfile(os.path.join(d, ".metadata")):
                continue
            steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save and restore ---------------------------------------------------

    @property
    def in_flight(self) -> bool:
        """True while a background write has not yet committed."""
        return self._writer is not None and self._writer.in_flight

    def save(self, step: int, state, meta: dict | None = None) -> str:
        """Save ``state`` (a ``TrainState``) and ``meta`` as step ``step``.
        Every rank calls it at the same step."""
        path = self._step_dir(step)
        fault_point("checkpoint.write", path=path)
        runtime_stats["saves_initiated"] += 1
        runtime_stats["process_index"] = _rank()
        # agreed on the main thread (a collective); the writers then
        # coordinate through the manifest's nonce alone
        nonce = _agree_nonce()
        if self._writer is not None:
            self._writer.drain()  # one write in flight: bounded host memory
            self._gc()
            snap = snapshot_to_host(state, meta)
            if snap.nbytes > self.host_budget_bytes:
                with telemetry.span("checkpoint.write", "checkpoint", path=path):
                    write_portable(path, snap, step=step, nonce=nonce)
                self._gc()
                return path
            self._writer.submit(path, snap, step, nonce)
            return path
        snap = snapshot_to_host(state, meta)
        with telemetry.span("checkpoint.write", "checkpoint", path=path):
            write_portable(path, snap, step=step, nonce=nonce)
        self._gc()
        return path

    def wait(self) -> None:
        """Block until an in-flight async write has landed."""
        if self._writer is not None:
            with telemetry.span("checkpoint.wait", "checkpoint"):
                self._writer.drain()
            self._gc()

    def _preempted_anywhere(self) -> bool:
        """The SIGTERM flag of any rank, by one all-reduce: the commit is
        rank 0's rename, so every rank must take the forced save."""
        local = self._preempted.is_set()
        if _world() == 1:
            return local
        flag = torch.tensor([1.0 if local else 0.0], device=_collective_device())
        with telemetry.span("preempt.agreement", "collective"):
            tdist.all_reduce(flag, op=tdist.ReduceOp.MAX)
        return bool(flag.item() > 0)

    def maybe_save(self, step: int, state, meta: dict | None = None) -> str | None:
        """Save when on schedule or preempted on any rank; returns the path
        if it saved. Every rank calls it every step (it holds the SIGTERM
        agreement)."""
        # an action "sigterm" here is a preemption mid-step, an action
        # "kill" a death with only the committed checkpoints left
        fault_point("train.preempt", step=step)
        scheduled = self.save_every > 0 and step > 0 and step % self.save_every == 0
        anywhere = self._preempted_anywhere()
        if scheduled or anywhere:
            self._preempted.clear()
            if step in self.all_steps():
                # a resume re-enters the step it restored: already durable
                return None
            if anywhere:
                runtime_stats["forced_saves"] += 1
                telemetry.instant("ckpt.preempt_save", "checkpoint", step=step)
            path = self.save(step, state, meta)
            if anywhere:
                self.wait()  # on disk on every rank before the job dies
            return path
        return None

    def restore_latest(self, state) -> tuple[int, dict] | None:
        """``(step, meta)`` after restoring the newest committed checkpoint
        into ``state`` (in place, onto its layout), or None when there is
        none. Torn dirs are skipped."""
        self.wait()  # an in-flight async save may be the latest
        step = self.latest_step()
        if step is None:
            return None
        path = self._step_dir(step)
        if is_portable_dir(path):
            return step, restore_portable(path, state)
        return step, restore_sharded(path, state)

    def _gc(self) -> None:
        if _rank() != 0:
            return
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        if steps:
            # staging dirs below the newest commit are dead (one write is in
            # flight at most, and it is the newest step)
            for tmp in glob.glob(os.path.join(self.root, "step_*.tmp")):
                m = re.fullmatch(r"step_(\d+)\.tmp", os.path.basename(tmp))
                if m and int(m.group(1)) < steps[-1]:
                    shutil.rmtree(tmp, ignore_errors=True)

    def close(self) -> None:
        if self._writer is not None:
            self.wait()
            self._writer.close()
            self._writer = None
        if self._installed:
            prev = self._prev_handler
            signal.signal(signal.SIGTERM, signal.SIG_DFL if prev is None else prev)
            self._installed = False
            self._prev_handler = None

