"""``runtime.dist.initialize``'s rendezvous retry, JAX's: the
``dist.rendezvous`` fault site, then ``init_process_group`` under
``RetryPolicy(attempts=GRAFT_RENDEZVOUS_ATTEMPTS or 2, base 1 s)``,
retrying only OUTAGE-class errors that are not ``ValueError``.

Over gloo at two ranks (started by ``runtime.launch.spawn``): a ``raise``
rule with an outage message fails each rank's first attempt and the
second forms the group; a first ``init_process_group`` that formed the
group and then raised torch's refused-connection error is cleaned up, so
the retry forms a fresh group on the same port; the ``collective.barrier``
site fires in ``coordination_barrier``; and each rank notes itself up,
then down, in the membership store the launcher exports
(``GRAFT_MEMBERSHIP``). In process: a ``ValueError`` and an error the
classifier does not call an outage are raised at once, never retried.
"""

import json

import pytest
import torch.distributed as tdist

from pytorch_distributedtraining_tpu_torch.resilience import faults
from pytorch_distributedtraining_tpu_torch.runtime import dist
from pytorch_distributedtraining_tpu_torch.runtime.launch import spawn
from pytorch_distributedtraining_tpu_torch.runtime.membership import MembershipStore
from test_torch_dist_workers import rendezvous_worker

OUTAGE_RULE = {"site": "dist.rendezvous", "action": "raise",
               "message": "UNAVAILABLE: rendezvous store (injected)"}
BARRIER_RULE = {"site": "collective.barrier", "action": "raise",
                "message": "UNAVAILABLE: barrier (injected)"}


def _spawn(tmp_path, monkeypatch, half_made: bool, rules: list) -> list:
    monkeypatch.setenv("GRAFT_FAULT_PLAN", json.dumps({"faults": rules}))
    monkeypatch.setenv("GRAFT_MEMBERSHIP", str(tmp_path / "membership"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    spawn(rendezvous_worker, args=(str(tmp_path), half_made), nprocs=2)
    return [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]


def test_an_outage_at_the_rendezvous_is_retried_and_the_barrier_site_fires(tmp_path,
                                                                          monkeypatch):
    for rank, seen in enumerate(_spawn(tmp_path, monkeypatch, False,
                                       [OUTAGE_RULE, BARRIER_RULE])):
        assert seen["sum"] == 3.0
        assert seen["calls"] == [False]  # the injected failure came before torch
        assert seen["hits"] == {"dist.rendezvous": [2], "collective.barrier": [1]}
        assert seen["barrier"] == "UNAVAILABLE: barrier (injected)"
    ranks = MembershipStore(str(tmp_path / "membership")).live_ranks(alive_within_s=0)
    assert ranks == []  # both noted up at the join, down at shutdown
    notes = sorted((tmp_path / "membership" / "ranks").iterdir())
    assert [p.name for p in notes] == ["0.json", "1.json"]
    assert [json.loads(p.read_text())["host_id"] for p in notes] == ["node0", "node0"]


def test_a_half_made_group_is_destroyed_before_the_retry(tmp_path, monkeypatch):
    for seen in _spawn(tmp_path, monkeypatch, True, []):
        # the retry found no default group left by the failed attempt
        assert seen["calls"] == [False, False]
        assert seen["sum"] == 3.0 and seen["barrier"] is None


@pytest.mark.parametrize("exc", [ValueError("bad world size"),
                                 faults.InjectedFault("a handshake bug")],
                         ids=["ValueError", "unknown-class"])
def test_a_non_outage_error_is_not_retried(exc, monkeypatch):
    calls = []

    def fail(*args, **kwargs):
        calls.append(1)
        raise exc

    monkeypatch.setattr(tdist, "init_process_group", fail)
    with pytest.raises(type(exc)):
        dist.initialize("127.0.0.1:1", 2, 0, device="cpu")
    assert calls == [1] and not tdist.is_initialized()


def test_an_exhausted_retry_raises_the_last_outage(monkeypatch):
    calls = []

    def fail(*args, **kwargs):
        calls.append(1)
        raise tdist.DistStoreError("Timed out after 1 seconds waiting for clients. 1/2 "
                                   "clients joined.")

    monkeypatch.setattr(tdist, "init_process_group", fail)
    monkeypatch.setenv("GRAFT_RENDEZVOUS_ATTEMPTS", "3")
    monkeypatch.setattr("time.sleep", lambda s: None)
    with pytest.raises(tdist.DistStoreError):
        dist.initialize("127.0.0.1:1", 2, 0, device="cpu")
    assert calls == [1, 1, 1]
