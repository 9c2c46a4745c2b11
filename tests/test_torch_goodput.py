"""``observe/goodput.py`` of the port against the JAX package's.

Both modules are stdlib arithmetic, so every comparison here is exact
(``==``, no tolerance): the analytic FLOP functions on the GPT-2, ViT and
SwinIR configs (full sizes and the tiny ones, from the config objects and
from the models themselves), ``mfu`` under one ``GRAFT_PEAK_FLOPS``, the
ledger's buckets from identical span records, and the step logs that each
package writes and the other reads, with the same straggler verdict. The
port's peak table holds the H100 row and the CPU placeholder only. A
``--trace`` run of the ESPCN driver writes a Chrome trace whose ledger
buckets sum to its wall time.
"""

import json
import os

import pytest
import torch

from pytorch_distributedtraining_tpu.models import gpt2 as jgpt2
from pytorch_distributedtraining_tpu.models import swinir as jswinir
from pytorch_distributedtraining_tpu.models import vit as jvit
from pytorch_distributedtraining_tpu.observe import goodput as jgp
from pytorch_distributedtraining_tpu_torch.models import gpt2 as tgpt2
from pytorch_distributedtraining_tpu_torch.models import swinir as tswinir
from pytorch_distributedtraining_tpu_torch.models import vit as tvit
from pytorch_distributedtraining_tpu_torch.observe import goodput as tgp

torch.set_num_threads(1)

GPT2_CONFIGS = ["gpt2_125m", "gpt2_medium", "gpt2_large", "gpt2_xl"]
SWINIR = [dict(), dict(embed_dim=180, depths=(6,) * 6, mlp_ratio=2.0),
          dict(embed_dim=12, depths=(2, 2), window_size=4, upscale=4)]


@pytest.mark.parametrize("name", GPT2_CONFIGS)
@pytest.mark.parametrize("batch,seq", [(8, 512), (4, None)])
def test_gpt2_train_flops_equal_jax(name, batch, seq):
    jcfg, tcfg = getattr(jgpt2.GPT2Config, name)(), getattr(tgpt2.GPT2Config, name)()
    want = jgp.gpt2_train_flops(jcfg, batch, seq)
    assert tgp.gpt2_train_flops(tcfg, batch, seq) == want
    assert tgp.model_train_flops(tcfg, batch) == jgp.model_train_flops(jcfg, batch)


def test_phase7_step_flops_and_mfu():
    """Phase 7's GPT-2 step by JAX's formula: 3.268e12 FLOP; at 30.02 ms on
    989 TFLOP/s that is an MFU of 0.110."""
    flops = tgp.gpt2_train_flops(tgpt2.GPT2Config(), 8, seq=512)
    assert flops == jgp.gpt2_train_flops(jgpt2.GPT2Config(), 8, seq=512)
    assert round(flops / 1e12, 3) == 3.268
    assert round(tgp.mfu(flops, 30.02e-3, 1, "gpu", "NVIDIA H100 80GB HBM3"), 3) == 0.110


@pytest.mark.parametrize("kw", [dict(), dict(image_size=64, patch_size=8, hidden_dim=48,
                                             num_layers=3, mlp_dim=96, num_classes=7)])
def test_vit_train_flops_equal_jax(kw):
    jcfg = jvit.ViTConfig(**kw)
    tcfg = tvit.ViTConfig(**kw)
    assert tgp.vit_train_flops(tcfg, 64) == jgp.vit_train_flops(jcfg, 64)
    assert tgp.model_train_flops(tcfg, 64) == jgp.model_train_flops(jcfg, 64)


@pytest.mark.parametrize("kw", SWINIR)
def test_swinir_train_flops_equal_jax(kw):
    assert tgp.swinir_train_flops(18, 64, 48, **kw) == jgp.swinir_train_flops(18, 64, 48, **kw)


def test_transformer_fwd_flops_equal_jax():
    for args in [(12, 768, 1024, 4.0, 50257), (2, 32, 17, 2.5, 0), (6, 60, 64, 2.0, 10)]:
        assert tgp.transformer_fwd_flops(*args) == jgp.transformer_fwd_flops(*args)


def test_model_train_flops_dispatches_on_the_port_models():
    """The port's GPT2, ViT and SwinIR objects count what the JAX models
    count (a DDP-style ``module`` wrapper is looked through)."""
    jg, tg = jgpt2.GPT2Config.tiny(), tgpt2.GPT2Config.tiny()
    assert tgp.model_train_flops(tgpt2.GPT2(tg), 4) == jgp.model_train_flops(jgpt2.GPT2(jg), 4)
    jv, tv = jvit.ViTConfig.tiny(), tvit.ViTConfig.tiny()
    assert tgp.model_train_flops(tvit.ViT(tv), 4) == jgp.model_train_flops(jvit.ViT(jv), 4)
    toy = dict(upscale=2, img_size=16, window_size=4, depths=(2, 2), embed_dim=12,
               num_heads=(2, 2), mlp_ratio=2.0)
    port = tswinir.SwinIR(**toy)
    want = jgp.model_train_flops(jswinir.SwinIR(**toy), 3, input_hw=(16, 24))
    assert tgp.model_train_flops(port, 3, input_hw=(16, 24)) == want
    assert tgp.model_train_flops(port, 3) == jgp.model_train_flops(jswinir.SwinIR(**toy), 3)

    class Wrapped(torch.nn.Module):
        def __init__(self, module):
            super().__init__()
            self.module = module

    assert tgp.model_train_flops(Wrapped(port), 3) == tgp.model_train_flops(port, 3)
    assert tgp.model_train_flops(torch.nn.Linear(2, 2), 3) is None


def test_peak_table_holds_the_h100_and_the_cpu_placeholder(monkeypatch):
    monkeypatch.delenv("GRAFT_PEAK_FLOPS", raising=False)
    assert set(tgp.PEAK_FLOPS) == {"h100", "cpu"}
    assert tgp.peak_flops("gpu", "NVIDIA H100 80GB HBM3") == 989e12
    assert tgp.peak_flops("cpu") == jgp.peak_flops("cpu") == 100e9
    assert tgp.peak_flops("gpu", "NVIDIA A100-SXM4-80GB") is None  # no A100 row
    assert tgp.mfu(3.268e12, 0.03, 1, "gpu", "NVIDIA A100-SXM4-80GB") is None
    assert tgp.device_kind("cpu") == ("cpu", "")


@pytest.mark.parametrize("peak", ["2.5e14", "1e9"])
def test_mfu_under_one_peak_override(monkeypatch, peak):
    monkeypatch.setenv("GRAFT_PEAK_FLOPS", peak)
    for args in [(3.268e12, 0.03, 1), (1e12, 0.5, 4), (0.0, 1.0, 1), (1e12, 0.0, 1)]:
        assert tgp.mfu(*args, device_kind="NVIDIA H100 80GB HBM3") == jgp.mfu(*args)
    monkeypatch.setenv("GRAFT_PEAK_FLOPS", "fast")
    with pytest.raises(ValueError, match="GRAFT_PEAK_FLOPS"):
        tgp.peak_flops()


def _records():
    """Span records of two threads: nested and overlapping spans, an
    instant, and a span that reaches past the window."""
    recs = []

    def span(name, cat, t0, dur, tid=1, depth=0):
        recs.append({"name": name, "cat": cat, "t0": t0, "dur": dur, "tid": tid,
                     "depth": depth, "attrs": {}})

    span("TrainStep.compile+dispatch", "compile", 0.0, 0.5)
    span("input.fetch", "input", 0.5, 0.1)
    for i in range(4):
        span("TrainStep.dispatch", "step", 0.6 + 0.3 * i, 0.25)
        span("inner", "step", 0.61 + 0.3 * i, 0.1, depth=1)
        span("input.wait", "input", 0.85 + 0.3 * i, 0.04)
    span("checkpoint.snapshot", "checkpoint", 1.8, 0.2)
    span("ckpt.retry", "outage", 2.0, 0.1)
    span("checkpoint.write.bg", "checkpoint", 1.0, 3.0, tid=2)  # another thread
    span("late", "step", 2.3, 5.0)
    recs.append({"name": "numerics.nonfinite", "cat": "fault", "t0": 1.2, "dur": 0.0,
                 "tid": 1, "depth": 0, "attrs": {}, "instant": True})
    return recs


@pytest.mark.parametrize("window", [(0.0, 2.5), (0.55, 1.9), (None, None)])
def test_ledger_buckets_from_identical_records(window):
    recs = _records()
    if window == (None, None):
        class T:
            def records(self):
                return recs

        got, want = tgp.GoodputLedger.from_tracer(T()), jgp.GoodputLedger.from_tracer(T())
    else:
        got = tgp.GoodputLedger.from_records(recs, *window)
        want = jgp.GoodputLedger.from_records(recs, *window)
    assert got.buckets == want.buckets and got.wall_s == want.wall_s
    assert got.events == want.events
    assert got.time_breakdown() == want.time_breakdown()
    assert got.goodput_fraction() == want.goodput_fraction()
    assert got.render() == want.render()
    assert abs(sum(got.buckets.values()) - got.wall_s) < 1e-9


def _write_logs(mod, base, times: dict):
    for rank, dts in times.items():
        with mod.StepLog(rank=rank, base=base, flush_every=3) as log:
            for i, dt in enumerate(dts):
                log.record(i, dt)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_step_logs_cross_read_with_the_same_straggler_verdict(tmp_path, writer):
    times = {0: [0.10, 0.11, 0.10, 0.12], 1: [0.10, 0.10, 0.11, 0.10],
             2: [0.11, 0.10, 0.10, 0.11], 3: [0.31, 0.30, 0.33, 0.29]}
    _write_logs(tgp if writer == "port" else jgp, str(tmp_path), times)
    with open(tmp_path / "steps" / "rank_3.jsonl", "ab") as f:
        f.write(b'{"rank": 3, "step": 9, "dt')  # a torn tail, as a killed rank leaves
    got_stats, want_stats = {}, {}
    got = tgp.read_step_logs(str(tmp_path), stats=got_stats)
    want = jgp.read_step_logs(str(tmp_path), stats=want_stats)
    assert got == want == times and got_stats == want_stats
    assert got_stats["torn_tail_lines"] == 1
    a, b = tgp.flag_stragglers(got), jgp.flag_stragglers(want)
    assert a.stragglers == b.stragglers == (3,) and a.zscores == b.zscores
    assert a.render() == b.render()
    assert tgp.straggler_check(str(tmp_path)).stragglers == (3,)
    assert a.outage_class.value == b.outage_class.value


def test_espcn_driver_trace_buckets_sum_to_wall_time(tmp_path, monkeypatch, capsys):
    """``--trace DIR`` on the ESPCN driver: the tracer records the step,
    input and checkpoint spans, the Chrome trace lands under DIR, and the
    ledger of its records accounts for the whole window."""
    from pytorch_distributedtraining_tpu_torch.drivers import fairscale_ddp
    from pytorch_distributedtraining_tpu_torch.observe import trace

    for var in ("GRAFT_TELEMETRY", "GRAFT_TRACE", "GRAFT_NUMERICS", "GRAFT_NUMERICS_ACTION"):
        monkeypatch.setenv(var, "")  # so that the driver's own settings are undone after
        monkeypatch.delenv(var)
    monkeypatch.setenv("GRAFT_RUN_DIR", str(tmp_path / "run"))
    trace.clear()
    out = tmp_path / "trace"
    try:
        fairscale_ddp.main(["--synthetic", "--synthetic-n", "40", "--epochs", "1",
                            "--batch-size", "8", "--workers", "0", "--device", "cpu",
                            "--trace", str(out), "--ckpt", str(tmp_path / "ck"),
                            "--save-every", "2"])
        recs = trace.records()
    finally:
        trace.disable()
        trace.clear()
    files = list(out.glob("telemetry-*.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"TrainStep.compile+dispatch", "TrainStep.dispatch", "input.fetch"} <= names
    ledger = tgp.GoodputLedger.from_records(recs, min(r["t0"] for r in recs),
                                            max(r["t0"] + r["dur"] for r in recs))
    assert abs(sum(ledger.buckets.values()) - ledger.wall_s) < 1e-9
    assert ledger.buckets["productive"] > 0 and ledger.buckets["compile"] > 0
    assert ledger.buckets["input_wait"] > 0 and ledger.buckets["checkpoint"] > 0
    printed = capsys.readouterr().out
    assert "===> goodput: wall" in printed and "MFU n/a" in printed
    assert os.environ.get("GRAFT_TELEMETRY") == "1"
