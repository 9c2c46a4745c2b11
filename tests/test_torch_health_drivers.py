"""Both drivers' ``--numerics`` and ``--trace`` on the CPU.

The ESPCN driver (``TrainStep``) with ``GRAFT_NUMERICS_INJECT`` poisoning
``conv1.weight``: ``--numerics`` (halt) raises ``NumericsDivergence`` on
the second non-finite step naming the poisoned leaf first, as JAX's driver
exits; ``--numerics rollback --ckpt`` rolls back to the committed step and
ends the run. The SwinIR driver (the facade) with ``--numerics --trace``
trains an epoch clean and writes the Chrome trace, printing the goodput
breakdown and an MFU from SwinIR's analytic FLOPs.
"""

import json

import pytest
import torch

from pytorch_distributedtraining_tpu_torch.drivers import fairscale_ddp, stoke_ddp
from pytorch_distributedtraining_tpu_torch.observe import numerics, trace

torch.set_num_threads(1)

ENV = ("GRAFT_NUMERICS", "GRAFT_NUMERICS_ACTION", "GRAFT_NUMERICS_INJECT",
       "GRAFT_NUMERICS_EVERY", "GRAFT_TELEMETRY", "GRAFT_TRACE", "GRAFT_WIRE")


@pytest.fixture
def env(monkeypatch, tmp_path):
    """Every knob the drivers set is put back after the test."""
    for var in ENV:
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)
    monkeypatch.setenv("GRAFT_RUN_DIR", str(tmp_path / "run"))
    monkeypatch.setenv("WANDB_MODE", "disabled")
    monkeypatch.chdir(tmp_path)
    numerics.reset()
    trace.clear()
    yield monkeypatch
    trace.disable()
    trace.clear()
    numerics.reset()


@pytest.mark.parametrize("value, on", [("1", True), ("enabled", True), ("0", False),
                                       ("off", False), ("", False)])
def test_one_resolver_per_env_pair(env, value, on):
    """The facade (``telemetry_from_env``/``numerics_from_env``) and the
    drivers (``configure_from_env``, ``probe_from_env``) read a value the
    same way; a bad action fails at construction."""
    env.setenv("GRAFT_TELEMETRY", value)
    env.setenv("GRAFT_NUMERICS", value)
    assert trace.telemetry_from_env(not on, "d") == (on, "d")
    assert trace.configure_from_env() is on and trace.enabled() is on
    assert numerics.numerics_from_env(not on) == (on, "halt")
    assert (numerics.probe_from_env() is not None) is on
    env.setenv("GRAFT_NUMERICS_ACTION", "Rollback")
    assert numerics.watchdog_from_env().action == "rollback"
    env.setenv("GRAFT_NUMERICS_ACTION", "retry")
    with pytest.raises(ValueError, match="GRAFT_NUMERICS_ACTION"):
        numerics.watchdog_from_env()
    env.delenv("GRAFT_TELEMETRY")
    env.setenv("GRAFT_TRACE", "out.json")
    assert trace.telemetry_from_env() == (True, "out.json")
    assert trace.trace_path("out.json") == "out.json"
    assert trace.trace_path("dir").startswith("dir/telemetry-")


ESPCN = ["--synthetic", "--synthetic-n", "48", "--batch-size", "8", "--workers", "0",
         "--device", "cpu"]


def test_espcn_numerics_halt_names_the_poisoned_leaf(env, capsys):
    env.setenv("GRAFT_NUMERICS_INJECT", "conv1.weight@2")
    with pytest.raises(numerics.NumericsDivergence, match="2 consecutive non-finite steps"):
        fairscale_ddp.main(ESPCN + ["--epochs", "1", "--numerics"])
    assert numerics.runtime_stats["verdicts"][-1]["action"] == "halt"
    assert numerics.runtime_stats["nonfinite_steps_total"] == 2
    assert "watchdog action=halt" in capsys.readouterr().out


def test_espcn_numerics_rollback_resumes_the_committed_step(env, tmp_path, capsys):
    env.setenv("GRAFT_NUMERICS_INJECT", "conv1.weight@3")
    loss = fairscale_ddp.main(ESPCN + ["--epochs", "1", "--numerics", "rollback", "--ckpt",
                                       str(tmp_path / "ck"), "--save-every", "2"])
    out = capsys.readouterr().out
    assert "rolled back to committed step 2" in out
    assert numerics.runtime_stats["verdicts"][0]["kind"] == "nonfinite"
    assert loss is not None


def test_stoke_numerics_and_trace(env, tmp_path, capsys):
    out_dir = tmp_path / "trace"
    stoke_ddp.main(["--synthetic", "--synthetic-n", "20", "--nEpochs", "1", "--batchSize", "2",
                    "--threads", "0", "--device", "cpu", "--numerics", "--trace",
                    str(out_dir)])
    printed = capsys.readouterr().out
    assert "numerics plane on, watchdog action=halt" in printed
    assert numerics.runtime_stats["steps_observed"] == 4  # 18 images, batch 2, accum 2
    assert numerics.runtime_stats["nonfinite_steps_total"] == 0
    (path,) = out_dir.glob("telemetry-*.trace.json")
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"Stoke.model.compile+dispatch", "Stoke.model.dispatch", "Stoke.backward.dispatch",
            "Stoke.step.dispatch", "input.wait"} <= names  # the prefetcher's
    line = next(ln for ln in printed.splitlines() if ln.startswith("===> goodput"))
    assert "over 4 steps" in line and "productive=" in line and "MFU 0." in line
