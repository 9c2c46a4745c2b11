"""``resilience.outage``, the port's stdlib copy of the JAX module: the
exception classifier, the outage-text scan and ``RetryPolicy`` give the
JAX module's answers on the same inputs, and the port's extension classifies torch's
own errors: an ``OSError`` whose errno says the request is wrong is
DETERMINISTIC (JAX calls every ``OSError`` an outage), and
``torch.distributed``'s store and network errors, and a backend error that
timed out, are OUTAGE. The fault sites the checkpoint path adds are
registered."""

import errno

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
