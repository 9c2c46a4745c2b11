"""The process group: rendezvous, rank and world size, barriers.

Counterpart of ``pytorch_distributedtraining_tpu/runtime/dist.py``. The
reference starts one process per GPU and rendezvouses over env://
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); so does this
module, with ``torch.distributed``: NCCL when the run trains on ``cuda``,
gloo only when the caller asked for ``device="cpu"``. A failure to bring
NCCL up is fatal: a run that asked for the card never falls back to gloo.
Each process drives one device, so the JAX module's two levels (devices
and host processes) coincide here: :func:`world_size` ==
:func:`process_count` == :func:`device_count`, and the card is
``cuda:LOCAL_RANK``.

A run started with none of the env contract is a no-op for
:func:`initialize`, as in JAX: one process, no group. Once ``WORLD_SIZE``
(even 1) and ``MASTER_ADDR``/``MASTER_PORT`` are set, :func:`initialize`
forms the group, so ``torch.distributed.run --nproc_per_node 1`` trains
through the same collectives as a run on many GPUs.

The rendezvous retries as JAX's does: the ``dist.rendezvous`` fault site,
then ``init_process_group`` under ``RetryPolicy(attempts=
GRAFT_RENDEZVOUS_ATTEMPTS or 2, base 1 s, max 15 s)``, retrying only what
the outage classifier calls OUTAGE and is not a ``ValueError``. Whatever
a failed attempt left (a default group registered before the failure,
its store) is destroyed before the next. Under the elastic launcher
(``GRAFT_MEMBERSHIP``, a directory store) each rank notes itself up in
the membership store when it joins and down at :func:`shutdown`,
best-effort. :func:`coordination_barrier` holds the ``collective.barrier``
fault site.

The XLA-only helpers of the JAX module have no counterpart here:
``enable_latency_hiding_scheduler`` (NCCL kernels overlap compute on their
own streams) and ``force_platform`` (the device is an argument of every
entry point).
"""

from __future__ import annotations

import datetime
import gc
import inspect
import logging
import os

import torch
import torch.distributed as tdist

from ..resilience.faults import fault_point
from ..resilience.outage import OutageClass, RetryPolicy, classify_exception
from .ports import find_free_port

__all__ = ["resolve_device", "find_free_port", "initialize", "shutdown", "is_initialized",
           "world_size", "rank", "process_count", "process_index", "device_count",
           "local_device_count", "backend", "coordination_barrier"]

logger = logging.getLogger(__name__)

INIT_TIMEOUT_S = 60.0  # a rendezvous that hangs fails within a minute


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device a run asked for. ``"cuda"`` without a CUDA device raises:
    the port never quietly trains on the CPU; pass ``"cpu"`` to ask for it.
    Under a launcher a bare ``"cuda"`` is the process's card, ``LOCAL_RANK``."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if device.index is None:
            local = _env_int("LOCAL_RANK", -1)
            index = local if local >= 0 else torch.cuda.current_device()
            device = torch.device("cuda", index)
    elif device.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {device}")
    return device


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw in (None, "", "None"):
        return default
    return int(raw)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device: str | torch.device = "cuda",
               timeout_s: float = INIT_TIMEOUT_S) -> None:
    """Form the process group from the arguments or the env contract.

    ``coordinator_address`` (``"host:port"``) defaults to
    ``MASTER_ADDR:MASTER_PORT``, ``num_processes`` to ``WORLD_SIZE`` and
    ``process_id`` to ``RANK``. With no world size and no coordinator this
    is a no-op (one process, no group). ``device`` picks the backend: NCCL
    for ``cuda`` (on ``cuda:LOCAL_RANK``), gloo for ``cpu``. The rendezvous
    and every later collective time out after ``timeout_s`` seconds; a
    rendezvous that fails with an outage is tried again (module
    docstring). An NCCL group comes up with ``TORCH_NCCL_ASYNC_ERROR_HANDLING``
    0 unless the environment sets it: the graphed steps capture their
    collectives. Idempotent.
    """
    if tdist.is_initialized():
        return
    explicit = coordinator_address is not None
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if addr and port:
            coordinator_address = f"{addr}:{port}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", 0) or None
    if process_id is None:
        process_id = _env_int("RANK", 0)
    if num_processes is None and not explicit:
        return  # one process, launched by hand: nothing to join
    num_processes = num_processes or 1
    if coordinator_address is None:
        raise ValueError(
            f"WORLD_SIZE={num_processes} needs a coordinator: set MASTER_ADDR and MASTER_PORT "
            "(torch.distributed.run does) or pass coordinator_address")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"RANK={process_id} out of range for WORLD_SIZE={num_processes}")
    device = torch.device(device)
    kwargs = {}
    if device.type == "cuda":
        device = resolve_device(device)
        if not tdist.is_nccl_available():
            raise RuntimeError("device='cuda' needs NCCL, and this torch has none")
        torch.cuda.set_device(device)
        backend = "nccl"
        # the train steps capture their collectives in CUDA graphs
        # (parallel.graph), which PyTorch documents with NCCL's async error
        # handling off: set here, where every group of the port is formed
        # (drivers, launcher children, by hand), before the group reads it;
        # a value the caller set stays
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        if "device_id" in inspect.signature(tdist.init_process_group).parameters:
            kwargs["device_id"] = device  # bring NCCL up now, so a failure is fatal here
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {device}")

    def rendezvous():
        # a failed handshake surfaces here, before torch talks to the store
        fault_point("dist.rendezvous", process_id=process_id)
        try:
            tdist.init_process_group(
                backend=backend, init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id,
                timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
        except BaseException:
            _discard_partial_group()
            raise

    # a store still binding, or a peer late to the rendezvous, gets one
    # in-process backoff cycle before the rank dies and the launcher's
    # restart takes over; what the classifier cannot call an outage
    # propagates at once
    policy = RetryPolicy(attempts=_env_int("GRAFT_RENDEZVOUS_ATTEMPTS", 2),
                         base_delay_s=1.0, max_delay_s=15.0)
    policy.run(
        rendezvous,
        retry_on=lambda e: (not isinstance(e, ValueError)
                            and classify_exception(e) is OutageClass.OUTAGE),
        on_retry=lambda i, e, d: logger.warning(
            "rendezvous attempt %d failed (%s); retrying in %.1fs", i + 1, e, d))
    _note_membership_rank(up=True)


def _discard_partial_group() -> None:
    """Destroy what a failed ``init_process_group`` left behind: a default
    group registered before the failure (NCCL's eager init with
    ``device_id`` runs after it) and, with it, its store, so the next
    attempt starts clean instead of failing on "initialize the default
    process group twice"."""
    if tdist.is_initialized():
        try:
            tdist.destroy_process_group()
        except Exception:  # noqa: BLE001 -- the group was half made; best effort
            logger.debug("destroying a half-made process group failed", exc_info=True)
    gc.collect()  # drop the failed attempt's store (and its listening socket)


def _note_membership_rank(up: bool = True) -> None:
    """Rank-level liveness into the elastic membership store, when the
    launcher exported one (``GRAFT_MEMBERSHIP``, directory-backed only).

    This is how a launcher watching the store can see REMOTE rank deaths:
    a rank that registered ``up`` and then stopped refreshing has died with
    its machine, even though no local exit code exists for it. Best-effort:
    membership never breaks initialization.
    """
    location = os.environ.get("GRAFT_MEMBERSHIP")
    if not location or location.startswith("tcp://"):
        return
    if "RANK" not in os.environ:
        return
    try:
        from .membership import MembershipStore

        MembershipStore(location).note_rank(
            rank=int(os.environ["RANK"]),
            host_id=f"node{os.environ.get('GRAFT_NODE_RANK', '0')}", up=up)
    except (OSError, ValueError):
        logger.debug("membership rank note failed", exc_info=True)


def shutdown() -> None:
    """Tear the group down (``dist.destroy_process_group()``); a no-op
    without one."""
    if tdist.is_initialized():
        _note_membership_rank(up=False)
        tdist.destroy_process_group()


def is_initialized() -> bool:
    return tdist.is_initialized()


def world_size() -> int:
    """Ranks in the group, else the launcher's ``WORLD_SIZE`` (default 1)."""
    return tdist.get_world_size() if tdist.is_initialized() else _env_int("WORLD_SIZE", 1)


def rank() -> int:
    """This process's rank in the group, else the launcher's ``RANK`` (default 0)."""
    return tdist.get_rank() if tdist.is_initialized() else _env_int("RANK", 0)


def process_count() -> int:
    """Processes in the run: one per device, so the world size."""
    return world_size()


def process_index() -> int:
    return rank()


def device_count() -> int:
    """Devices across all processes, the data-parallel width."""
    return world_size()


def local_device_count() -> int:
    """Devices this process drives: one."""
    return 1


def backend() -> str | None:
    """``"nccl"``, ``"gloo"`` or None without a group."""
    return tdist.get_backend() if tdist.is_initialized() else None


def coordination_barrier(name: str = "sync", timeout_s: float = 600.0) -> None:
    """Every rank waits here until all have arrived, or raises after
    ``timeout_s``; a no-op without a group. ``name`` labels the barrier in
    the error."""
    if not tdist.is_initialized():
        return
    # a hang or an UNAVAILABLE raise during a pool flap surfaces at the
    # barrier: the first place a dead peer is observable
    fault_point("collective.barrier", name=name)
    work = tdist.barrier(async_op=True)
    try:
        work.wait(timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e
