"""Shared outage classifier and retry policy.

Counterpart of ``pytorch_distributedtraining_tpu/resilience/outage.py``,
a stdlib copy (the port imports nothing of the JAX package): every layer
that has to decide "is this failure the storage or the network flapping,
or is my code broken?" asks the same classifier. The checkpoint writes of
``checkpoint_sharded`` retry through :class:`RetryPolicy` on
:attr:`OutageClass.OUTAGE`.

:func:`classify_exception` gives JAX's answers, with one extension for
the errors torch's own I/O and stores raise:

- ``OSError`` is split by ``errno``: a missing path, a permission or a
  read-only filesystem (``ENOENT``, ``EACCES``, ``EROFS``, ...) is
  DETERMINISTIC, since retrying the same write cannot help; every other
  ``OSError`` (``EIO`` on a flaky mount, ``ENOSPC`` races, ``ESTALE``, or
  no errno at all) stays OUTAGE, as in JAX;
- ``torch.distributed``'s ``DistStoreError`` (a rendezvous store that
  timed out or went away) and ``DistNetworkError`` are OUTAGE, and so is a
  ``DistBackendError`` whose text says a collective timed out. They are
  matched by class name, so this module stays stdlib-only;
- :func:`is_outage_text` knows the two texts torch's ``TCPStore`` gives a
  rendezvous that could not form, which JAX's gRPC and transport
  signatures miss: a client that never reached the store ("... timed out
  after 3000ms while trying to connect to (127.0.0.1, 29500)": torch
  retries a refused connection until its timeout) and a store whose
  ranks never all came ("Timed out after 60 seconds waiting for clients.
  1/2 clients joined."). So a child's last lines carrying either classify
  as an outage, as JAX's coordinator texts do there.

:func:`classify`, :func:`external_termination` and
:func:`attributes_to_host` read a child's return code (and its last
lines): the elastic launcher's restart, shrink and quarantine decisions
(``runtime/launch.py``), copied as they are.
"""

from __future__ import annotations

import enum
import errno
import random
import time
from dataclasses import dataclass
from typing import Callable, Iterator


class OutageClass(enum.Enum):
    """What a failed probe/attempt says about the world.

    OUTAGE          — the shared pool / network is down; waiting helps.
    DETERMINISTIC   — the failure is ours (ImportError, typoed platform,
                      usage error); retrying the same thing cannot help.
    UNKNOWN         — a generic failure (rc=1, no recognizable signature).
                      Callers should ride it as outage-class for a
                      couple of attempts, then treat it as
                      deterministic.
    """

    OUTAGE = "outage"
    DETERMINISTIC = "deterministic"
    UNKNOWN = "unknown"


# gRPC status names a remote runtime raises while its pool is down
# (matched case-sensitively: they are uppercase canonical tokens)
_GRPC_SENTINELS = ("UNAVAILABLE", "DEADLINE_EXCEEDED")

# transport-level phrases — matched case-insensitively; connection text
# varies by layer ("Connection refused", "connection reset by peer", ...)
_CONNECTION_SENTINELS = (
    "connection refused",
    "connection reset",
    "connection closed",
    "connection aborted",
    "failed to connect",
    "broken pipe",
    "socket closed",
    "transport closed",
    "host unreachable",
)

# torch's TCPStore rendezvous texts (case-insensitive): a client that never
# reached the store, and a store whose ranks never all joined
_TORCH_STORE_SENTINELS = (
    "while trying to connect to",
    "waiting for clients",
)

# return codes that are outage-class by construction:
#   None -- the caller killed a hung child
#   3    -- a probe's refusal to fall back to the CPU (the pool dropped)
#   4    -- a bench child's refusal to fall back to the CPU
#   124  -- coreutils `timeout` expiry (a driver-side kill of a hung run)
_OUTAGE_RCS = frozenset({3, 4, 124})


def is_outage_text(text: str) -> bool:
    """True when ``text`` carries a recognized outage signature."""
    if any(s in text for s in _GRPC_SENTINELS):
        return True
    low = text.lower()
    return any(s in low for s in _CONNECTION_SENTINELS + _TORCH_STORE_SENTINELS)


def classify(rc: int | None, tail: str = "") -> OutageClass:
    """Classify one failed probe/attempt from its return code + output tail.

    ``rc`` is the child's return code (None = killed on timeout); ``tail``
    is whatever diagnostic text survived (the informative last lines).
    """
    if rc is None or rc in _OUTAGE_RCS:
        return OutageClass.OUTAGE
    if rc in (-9, -15, 137, 143):
        # killed by SIGKILL/SIGTERM (subprocess negative convention or the
        # 128+N shell convention): an *external* termination -- preemption,
        # OOM-killer, driver timeout -- is outage-class, not a code bug
        return OutageClass.OUTAGE
    if tail and is_outage_text(tail):
        return OutageClass.OUTAGE
    if rc is not None and rc < 0:
        # some other signal (SIGSEGV, SIGILL): could be a flaky backend or
        # a real crash -- ride briefly, like a bare rc=1
        return OutageClass.UNKNOWN
    if rc == 1:
        # a bare interpreter-level failure with no recognizable signature:
        # could be either (errors sometimes lose their text to a truncated
        # tail) -- let the caller's fast-fail window decide
        return OutageClass.UNKNOWN
    # rc=2 (usage), ImportError-style startup rc, or any other distinct
    # code with no outage text: deterministic, retrying cannot help
    return OutageClass.DETERMINISTIC


def external_termination(rc: int | None) -> bool:
    """True when a rank's exit looks like the WORKER WAS TAKEN AWAY --
    SIGKILL/SIGTERM (negative subprocess convention or the 128+N shell
    convention) or a kill-on-timeout (rc None) -- rather than the program
    failing on its own. This is the elastic launcher's shrink-vs-retry
    discriminator: a preempted/OOM-killed/timed-out rank is *gone*, so
    the surviving world relaunches smaller (shrink-to-survive); any other
    outage-class failure (rendezvous flake, transient I/O) retries at the
    same world size first.
    """
    return rc is None or rc in (-9, -15, 124, 137, 143)


# crash signatures that point at the HOST rather than the code or the
# pool: memory/bus faults and illegal instructions are the classic
# bad-DIMM / cooked-device ways a machine eats a rank, and a hardware
# sentinel in the tail is the driver saying so outright
_HOST_FAULT_RCS = frozenset({-11, -7, -4, -8, 139, 135, 132, 136})
_HOST_FAULT_SENTINELS = (
    "uncorrectable ecc",
    "hbm error",
    "device failure",
    "hardware error",
    "machine check",
    "bus error",
    "segmentation fault",
)


def attributes_to_host(rc: int | None, tail: str = "") -> bool:
    """True when a rank's failure is plausibly the HOST's fault -- the
    elastic launcher's quarantine discriminator.

    An external termination (preemption/OOM-kill/timeout) says the pool
    took the worker: the host is innocent and stays admissible for
    grow-back. A SIGSEGV/SIGBUS/SIGILL/SIGFPE death, or a hardware
    sentinel in the diagnostic tail, says the machine itself ate the
    rank -- growing back onto it would just crash the next generation,
    so it enters quarantine with exponential backoff instead.
    """
    if rc is not None and rc in _HOST_FAULT_RCS:
        return True
    if external_termination(rc):
        return False
    low = tail.lower()
    return any(s in low for s in _HOST_FAULT_SENTINELS)


# errno values that say the request itself is wrong: retrying cannot help
_DETERMINISTIC_ERRNOS = frozenset(
    getattr(errno, name) for name in (
        "ENOENT", "ENOTDIR", "EISDIR", "EACCES", "EPERM", "EROFS", "EEXIST",
        "ENOTEMPTY", "ENAMETOOLONG", "EINVAL", "EBADF", "EXDEV", "ELOOP",
    ) if hasattr(errno, name)
)

# torch.distributed's transient failures, by class name (stdlib module)
_DIST_OUTAGE_TYPES = ("DistStoreError", "DistNetworkError")


def _type_names(exc: BaseException) -> set:
    return {t.__name__ for t in type(exc).__mro__}


def classify_exception(exc: BaseException) -> OutageClass:
    """Classify an in-process exception (rendezvous, I/O).

    Transient-by-nature exception types (connection/timeout/IO, and
    ``torch.distributed``'s store and network errors) classify as OUTAGE
    even without sentinel text; an ``OSError`` whose ``errno`` says the
    request is wrong is DETERMINISTIC; everything else falls back to the
    message scan.
    """
    if isinstance(exc, (ConnectionError, TimeoutError, InterruptedError)):
        return OutageClass.OUTAGE
    names = _type_names(exc)
    if names.intersection(_DIST_OUTAGE_TYPES):
        return OutageClass.OUTAGE
    text = f"{type(exc).__name__}: {exc}"
    if "DistBackendError" in names and any(
            s in text.lower() for s in ("timed out", "timeout")):
        return OutageClass.OUTAGE
    if isinstance(exc, OSError) and exc.errno in _DETERMINISTIC_ERRNOS:
        return OutageClass.DETERMINISTIC
    if is_outage_text(text):
        return OutageClass.OUTAGE
    if isinstance(exc, OSError):
        # a transient filesystem/network hiccup (EIO on a flaky NFS
        # checkpoint dir, ENOSPC races) — worth one backoff cycle
        return OutageClass.OUTAGE
    return OutageClass.UNKNOWN


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter.

    One policy object describes *how* to retry; the decision *whether* a
    failure is retryable belongs to :func:`classify_exception` (or the
    caller's ``retry_on``). Jitter is
    seeded so chaos tests replay identical schedules.

    ``attempts`` counts total tries (first call included), matching the
    W&B sink's historical ``max_retries`` semantics.
    """

    attempts: int = 3
    base_delay_s: float = 1.0
    max_delay_s: float = 60.0
    multiplier: float = 2.0
    jitter_frac: float = 0.1
    seed: int = 0

    def delays(self) -> Iterator[float]:
        """The backoff schedule: one delay per retry (attempts - 1 of them)."""
        rng = random.Random(self.seed)
        delay = self.base_delay_s
        for _ in range(max(0, self.attempts - 1)):
            jitter = delay * self.jitter_frac
            yield max(0.0, min(self.max_delay_s, delay)
                      + rng.uniform(-jitter, jitter))
            delay *= self.multiplier

    def run(
        self,
        fn: Callable,
        *,
        retry_on: Callable[[BaseException], bool] | None = None,
        sleep: Callable[[float], None] = time.sleep,
        on_retry: Callable[[int, BaseException, float], None] | None = None,
    ):
        """Call ``fn()`` with this policy; re-raise the last failure.

        ``retry_on`` gates which exceptions are worth another attempt
        (default: anything the shared classifier does not call
        DETERMINISTIC). ``on_retry(attempt_index, exc, delay_s)`` observes
        each scheduled retry.
        """
        if retry_on is None:
            retry_on = (
                lambda e: classify_exception(e) is not OutageClass.DETERMINISTIC
            )
        delays = self.delays()
        for attempt in range(self.attempts):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — gated by retry_on below
                delay = next(delays, None)
                if delay is None or not retry_on(e):
                    raise
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                sleep(delay)
        raise AssertionError("unreachable: loop either returns or raises")

