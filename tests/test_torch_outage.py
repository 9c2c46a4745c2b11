"""``resilience.outage``, the port's stdlib copy of the JAX module: the
exception classifier, the outage-text scan, the return-code classifiers
(``classify``, ``external_termination``, ``attributes_to_host``) and
``RetryPolicy`` give the JAX module's answers on the same inputs, and the
port's extension classifies torch's own errors: an ``OSError`` whose errno says the request is wrong is
DETERMINISTIC (JAX calls every ``OSError`` an outage), and
``torch.distributed``'s store and network errors, and a backend error that
timed out, are OUTAGE; the texts torch's ``TCPStore`` gives a refused
connection and a timed-out rendezvous (taken from torch here, not typed
in) are outage texts. The fault sites the checkpoint path and the
launcher add are registered."""

import datetime
import errno
import socket

import pytest
import torch.distributed as tdist

from pytorch_distributedtraining_tpu.resilience import outage as jout
from pytorch_distributedtraining_tpu_torch.resilience import faults
from pytorch_distributedtraining_tpu_torch.resilience import outage as tout

TAILS = ["", "UNAVAILABLE: pool", "Connection refused by peer", "deadline_exceeded",
         "socket closed", "uncorrectable ECC error", "Segmentation fault", "usage: x"]


@pytest.mark.parametrize("tail", TAILS)
def test_outage_text_equals_jax(tail):
    assert tout.is_outage_text(tail) == jout.is_outage_text(tail)


EXCEPTIONS = [ConnectionResetError("reset"), TimeoutError("slow"), InterruptedError(),
              OSError(errno.EIO, "I/O error"), OSError(errno.ENOSPC, "full"), OSError("bare"),
              RuntimeError("UNAVAILABLE: backend"), RuntimeError("boom"), ValueError("bad"),
              KeyError("k"), RuntimeError("connection reset by peer")]


@pytest.mark.parametrize("exc", EXCEPTIONS, ids=lambda e: f"{type(e).__name__}:{e}")
def test_exception_classifier_equals_jax(exc):
    assert tout.classify_exception(exc).value == jout.classify_exception(exc).value


@pytest.mark.parametrize("code", [errno.ENOENT, errno.EACCES, errno.EROFS, errno.EISDIR,
                                  errno.ENOTDIR, errno.EEXIST])
def test_an_oserror_of_a_wrong_request_is_deterministic(code):
    exc = OSError(code, "no")
    assert tout.classify_exception(exc) is tout.OutageClass.DETERMINISTIC
    assert jout.classify_exception(exc) is jout.OutageClass.OUTAGE  # JAX retries it
    assert tout.classify_exception(FileNotFoundError(errno.ENOENT, "x")).value == "deterministic"


@pytest.mark.parametrize("exc", [tdist.DistStoreError("wait timed out for key"),
                                 tdist.DistNetworkError("Connection lost"),
                                 tdist.DistBackendError("Watchdog caught collective operation "
                                                        "timeout: WorkNCCL(SeqNum=3)")],
                         ids=["store", "network", "backend-timeout"])
def test_torch_distributed_failures_are_outages(exc):
    assert tout.classify_exception(exc) is tout.OutageClass.OUTAGE


def test_a_torch_backend_error_without_a_timeout_is_unknown():
    exc = tdist.DistBackendError("NCCL error: invalid usage")
    assert tout.classify_exception(exc) is tout.OutageClass.UNKNOWN


@pytest.mark.parametrize("kw", [{}, dict(attempts=5, base_delay_s=0.2, max_delay_s=1.0, seed=3),
                                dict(attempts=1), dict(multiplier=3.0, jitter_frac=0.0)])
def test_retry_policy_schedule_and_run_equal_jax(kw):
    assert list(tout.RetryPolicy(**kw).delays()) == list(jout.RetryPolicy(**kw).delays())

    def attempt(log, outcomes):
        def fn():
            log.append(len(log))
            out = outcomes[len(log) - 1]
            if isinstance(out, BaseException):
                raise out
            return out
        return fn

    for outcomes in ([OSError(errno.EIO, "x"), OSError(errno.EIO, "y"), "done", "done", "done"],
                     [ValueError("usage"), "done"], ["first"]):
        got, want = [], []
        slept_t, slept_j = [], []
        res = []
        for mod, log, slept in ((tout, got, slept_t), (jout, want, slept_j)):
            try:
                res.append(mod.RetryPolicy(**kw).run(attempt(log, outcomes),
                                                     sleep=slept.append))
            except Exception as e:  # noqa: BLE001 -- both sides must raise alike
                res.append(type(e).__name__)
        assert res[0] == res[1] and got == want and slept_t == slept_j


def test_checkpoint_fault_sites_are_registered():
    assert {"checkpoint.write", "ckpt.write", "train.preempt"} <= faults.SITES
    plan = faults.FaultPlan.from_json([{"site": "ckpt.write", "action": "kill", "at": 2}])
    assert plan.rules_for("ckpt.write")[0].at == 2
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.FaultPlan.from_json([{"site": "ckpt.nope"}])


RCS = [None, 0, 1, 2, 3, 17, 124, 137, 139, 143, -4, -7, -8, -9, -11, -15, 132, 135, 136]
# JAX's sentinel tails: outage texts, hardware texts, and neither
SENTINEL_TAILS = ["", "UNAVAILABLE: TPU backend", "DEADLINE_EXCEEDED", "Connection refused",
                  "connection reset by peer", "broken pipe", "host unreachable",
                  "uncorrectable ECC error on HBM", "HBM error", "device failure",
                  "hardware error", "Machine check exception", "Bus error",
                  "Segmentation fault (core dumped)", "ImportError: no module x",
                  "usage: launch.py [-h]"]


@pytest.mark.parametrize("tail", SENTINEL_TAILS)
@pytest.mark.parametrize("rc", RCS, ids=str)
def test_return_code_classifiers_equal_jax(rc, tail):
    assert tout.classify(rc, tail).value == jout.classify(rc, tail).value
    assert tout.external_termination(rc) == jout.external_termination(rc)
    assert tout.attributes_to_host(rc, tail) == jout.attributes_to_host(rc, tail)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _store_text(is_master: bool) -> str:
    """What torch's ``TCPStore`` raises: a client whose connection is refused
    until its timeout, or a store whose second rank never joins."""
    with pytest.raises(tdist.DistError) as e:
        tdist.TCPStore("127.0.0.1", _free_port(), 2, is_master,
                       timeout=datetime.timedelta(seconds=1), wait_for_workers=True)
    return f"{type(e.value).__name__}: {e.value}"


@pytest.mark.parametrize("is_master,sentinel", [(False, "while trying to connect to"),
                                                (True, "waiting for clients")],
                         ids=["refused-connection", "rendezvous-timeout"])
def test_torch_store_texts_are_outage_texts(is_master, sentinel):
    """JAX's gRPC and transport signatures miss both of torch's texts; the
    port adds one signature for each, named here."""
    text = _store_text(is_master)
    assert sentinel in text.lower()
    assert not jout.is_outage_text(text)
    assert tout.is_outage_text(text)
    assert tout.classify(1, text) is tout.OutageClass.OUTAGE
    assert jout.classify(1, text) is jout.OutageClass.UNKNOWN


def test_launch_fault_sites_are_registered():
    assert {"launch.worker", "launch.grow", "membership.heartbeat", "dist.rendezvous",
            "collective.barrier"} <= faults.SITES
    rule = faults.FaultPlan.from_json([{"site": "launch.worker", "rank": 1, "attempt": 0,
                                        "after_s": 0.5}]).rules_for("launch.worker")[0]
    assert (rule.rank, rule.attempt, rule.after_s) == (1, 0, 0.5)
