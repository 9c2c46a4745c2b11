"""The port's measurement scripts on the CPU. The step profiler
(``benchmarks/profile_swinir.py``): the bench step it times runs end to end
at a toy size, and its trace digest sorts kernels into families and
computes busy and idle time from a Chrome trace. The ladder twin
(``benchmarks/ladder.py``): its GPT-2 rung and its image rungs (ResNet-18,
ResNet-50 under DDP and ZeRO-2, ViT-B/16 under ZeRO-3) run at the JAX
ladder's tiny sizes. The
collate timer (``benchmarks/collate.py``) times both ways at a toy batch.
Device numbers come only from a GPU run."""

import json
import math
from pathlib import Path

import pytest
import torch

from pytorch_distributedtraining_tpu_torch.benchmarks import profile_swinir as ps
from pytorch_distributedtraining_tpu_torch.drivers import stoke_ddp
from pytorch_distributedtraining_tpu_torch.models import SwinIR


def test_profile_runs_the_bench_step_on_cpu(tmp_path):
    """The driver's facade around a toy SwinIR, as the profiler's main()
    builds it around SwinIR-S."""
    model = SwinIR(img_size=8, window_size=4, depths=(2,), embed_dim=12, num_heads=(2,),
                   generator=torch.Generator().manual_seed(0))
    stoke = stoke_ddp.build_stoke(model, fp16="bf16", batch_size=2, device="cpu")
    trace = tmp_path / "t.json"
    r = ps.profile(stoke, ps.make_batches("cpu", batch=2, lr_size=8), steps=1, warmup=1,
                   trace_path=str(trace))
    assert r["precision"] == "bf16" and r["step_ms"] > 0 and math.isfinite(r["loss"])
    assert r["images_per_s"] == ps.ACCUM * 2 / r["step_ms"] * 1e3
    assert "idle_share" not in r  # no device, no device metric
    assert json.loads(trace.read_text())["traceEvents"]


def test_device_breakdown_families_and_idle_share(tmp_path):
    names = [
        "void (anonymous namespace)::window_attn_fwd_kernel<float, 2, 16>(...)",
        "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc",
        "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x16",
        "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float>(...)",
        "void at::native::elementwise_kernel<128, 4, direct_copy_kernel_cuda>(...)",
        "void at::native::vectorized_elementwise_kernel<4, GeluCUDAKernelImpl>(...)",
        "void at::native::reduce_kernel<512, 1, ReduceOp<float>>(...)",
        "void at::native::multi_tensor_apply_kernel<FusedAdam>(...)",
        "something_else",
    ]
    # kernels back to back from t=0, 10 us each, with one 10 us gap and
    # the last two overlapping by 5 us
    events, t = [], 0.0
    for i, name in enumerate(names):
        if i == 4:
            t += 10.0
        if i == len(names) - 1:
            t -= 5.0
        events.append({"cat": "kernel", "name": name, "ts": t, "dur": 10.0})
        t += 10.0
    events.append({"cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 500.0})
    events += [{"cat": "cuda_runtime", "name": n, "ts": 0.0, "dur": d}
               for n, d in (("cudaStreamSynchronize", 40.0), ("cudaLaunchKernel", 3.0),
                            ("cudaStreamSynchronize", 20.0), ("cudaMemcpyAsync", 5.0))]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = ps.device_breakdown(str(path))
    fam = r["device_ms_by_family"]
    assert r["kernels"] == len(names)
    assert set(fam) == {"window attention (K1/K2)", "convolution", "GEMM", "LayerNorm",
                        "copy / permute / roll", "elementwise", "reduction",
                        "optimizer (foreach)", "other"}
    assert all(v == 0.01 for v in fam.values())
    window = 10.0 * len(names) + 10.0 - 5.0
    busy = 10.0 * len(names) - 5.0
    assert math.isclose(r["window_ms"], window / 1e3)
    assert math.isclose(r["busy_ms"], busy / 1e3)
    assert math.isclose(r["idle_share"], 1 - busy / window)
    assert r["host_wait_ms"] == {"cudaStreamSynchronize": 0.06}  # async calls do not wait
    assert r["top_host_ops_ms"] == [("aten::mm", 0.5)]


def test_ladder_lm_rung_runs_tiny_on_cpu(capsys):
    """The ladder twin's config 4 at ``GPT2Config.tiny`` on the CPU (flash
    attention's plain versions): one JSON line with a positive rate."""
    from pytorch_distributedtraining_tpu_torch.benchmarks import ladder

    assert ladder.main(["--config", "4", "--tiny", "--device", "cpu", "--steps", "2",
                        "--warmup", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["metric"] == "tokens_per_sec" and r["value"] > 0 and r["device"] == "cpu"
    assert r["value"] <= r["roofline"] and math.isfinite(r["loss"])


def test_gpt2_options_sweep_runs_tiny_on_cpu(capsys):
    """The per-option GPT-2 sweep at ``GPT2Config.tiny`` on the CPU: one
    JSON line a row, the base first and last, each with a finite loss."""
    from pytorch_distributedtraining_tpu_torch.benchmarks import gpt2_options

    assert gpt2_options.main(["--tiny", "--device", "cpu", "--steps", "1", "--warmup", "1"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["options"] for r in rows] == [name for name, _ in gpt2_options.ROWS]
    assert all(math.isfinite(r["loss"]) and r["step_ms"] > 0 for r in rows)
    assert rows[0]["loss"] == rows[-1]["loss"]  # the same seed, the same run


@pytest.mark.parametrize("config,name,policy,optimizer", [
    (1, "1_resnet18_cifar10_single", "none", "FusedAdamW"),
    (2, "2_resnet50_ddp", "ddp", "FusedAdamW"),
    (3, "3_resnet50_oss_sddp", "zero2", "AdamW"),
    (5, "5_vitb16_bf16_fsdp", "zero3", "AdamW"),
])
def test_ladder_image_rung_runs_tiny_on_cpu(capsys, config, name, policy, optimizer):
    """The ladder twin's image rungs at the JAX ladder's tiny sizes on the
    CPU, each under its own policy (a process group of one, over gloo,
    where it has one) and with the optimizer ``fused_adamw_eligible``
    picks: one JSON line under the JAX config's name with a positive rate
    under the roofline and a finite loss."""
    from pytorch_distributedtraining_tpu_torch.benchmarks import ladder

    assert ladder.main(["--config", str(config), "--tiny", "--device", "cpu", "--steps", "2",
                        "--warmup", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["config"] == name and r["policy"] == policy and r["optimizer"] == optimizer
    assert r["metric"] == "images_per_sec" and r["unit"] == "images/sec"
    assert 0 < r["value"] <= r["roofline"] and math.isfinite(r["loss"])
    assert r["batch"] == 8 and r["image"] == [32, 32, 3] and r["device"] == "cpu"
    assert set(r["tf32"]) == {"matmul", "cudnn"}


def test_flash_kernel_times_are_read_by_name(tmp_path):
    """K3-K5's device time and launches per step from a trace: each kernel
    by its name, other kernels and host events ignored."""
    from pytorch_distributedtraining_tpu_torch.benchmarks import ladder

    events = [{"cat": "kernel", "name": f"void (anonymous namespace)::{n}<__nv_bfloat16, 64>",
               "ts": 0.0, "dur": dur}
              for n, dur in (("flash_attn_fwd_kernel", 30.0), ("flash_attn_dkv_kernel", 90.0),
                             ("flash_attn_fwd_kernel", 50.0), ("flash_attn_dq_kernel", 500.0))]
    events += [{"cat": "kernel", "name": "void cutlass::Kernel2<gemm>(...)", "ts": 0.0,
                "dur": 700.0},
               {"cat": "cpu_op", "name": "flash_attn_fwd_kernel", "ts": 0.0, "dur": 900.0}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = ladder.flash_kernel_ms(str(path), n_steps=2)
    assert r == {"K3": {"ms": 0.04, "launches": 1.0}, "K4": {"ms": 0.25, "launches": 0.5},
                 "K5": {"ms": 0.045, "launches": 0.5}}


def test_ab_ladder_runs_both_trees_in_turns(capsys):
    """Parent against change: base, change, change, base, each a fresh
    ladder process from its tree (here both trees are this one, tiny, on
    the CPU), and a summary of the step times per tree."""
    from pytorch_distributedtraining_tpu_torch.benchmarks import ab_ladder

    assert ab_ladder.order(2) == ["base", "change", "change", "base"] * 2
    root = Path(__file__).resolve().parents[1]
    assert ab_ladder.main(["--base", str(root), "--rounds", "1", "--", "--steps", "1",
                           "--tiny", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["tree"] for x in lines[:-1]] == ab_ladder.order(1)
    summary = lines[-1]["ab_ladder"]
    for tree in ("base", "change"):
        s = summary[tree]
        assert len(s["step_ms"]) == 2 and s["median_step_ms"] == sum(s["step_ms"]) / 2
        assert s["tokens_per_s_at_median"] == 8 * 512 / s["median_step_ms"] * 1e3
        assert all(math.isfinite(x) for x in s["loss"]) and "busy_ms" not in s


def test_ab_ladder_summary_reads_traced_runs():
    from pytorch_distributedtraining_tpu_torch.benchmarks import ab_ladder

    def rec(step_ms, busy, k4):
        return {"step_ms": step_ms, "loss": 3.0, "busy_ms": busy, "idle_share": 1 - busy / step_ms,
                "flash_kernels": {"K4": {"ms": k4, "launches": 12.0}}}

    runs = [("base", rec(40.0, 36.0, 6.8)), ("change", rec(30.0, 29.0, 0.5)),
            ("change", rec(32.0, 29.0, 0.4)), ("base", rec(38.0, 36.0, 6.8))]
    s = ab_ladder.summarize(runs)
    assert s["base"]["step_ms"] == [40.0, 38.0] and s["base"]["median_step_ms"] == 39.0
    assert s["change"]["flash_ms_per_step"] == {"K4": 0.45}
    assert s["change"]["busy_ms"] == 29.0
    assert s["base"]["step_idle_share"] == pytest.approx((4 / 40 + 2 / 38) / 2)


def _profile_record(precision, step_ms, busy_ms, window_ms):
    """A line of ``profile_swinir`` as a traced run on the card prints it."""
    return {"precision": precision, "step_ms": step_ms, "images_per_s": 36 / step_ms * 1e3,
            "traced_step_ms": 2 * step_ms, "loss": 0.1, "busy_ms": busy_ms,
            "device_ms_by_family": {"window attention (K1/K2)": window_ms, "GEMM": 30.0}}


def test_ab_swinir_runs_both_trees_in_turns_and_summarizes(monkeypatch, capsys, tmp_path):
    """Parent against change with faked profile runs: base, change, change,
    base, each one fresh process from its tree, and per tree and precision
    the median step, images/s at it, busy ms, the untraced step's idle share
    and window attention's device ms."""
    from pytorch_distributedtraining_tpu_torch.benchmarks import ab_swinir

    fake = {"base": [(164.0, 154.0, 60.0, 186.0, 131.0, 61.0),
                     (166.0, 154.0, 60.0, 190.0, 131.0, 61.0)],
            "change": [(136.0, 126.0, 32.0, 160.0, 100.0, 25.0),
                       (138.0, 126.0, 32.0, 158.0, 100.0, 25.0)]}
    calls = []

    def run(tree, args):
        name = "change" if tree == ab_swinir.HERE else "base"
        calls.append((name, args))
        f32_step, f32_busy, f32_win, bf_step, bf_busy, bf_win = fake[name][
            sum(1 for c in calls if c[0] == name) - 1]
        return [_profile_record("fp32", f32_step, f32_busy, f32_win),
                _profile_record("bf16", bf_step, bf_busy, bf_win)]

    monkeypatch.setattr(ab_swinir, "run", run)
    assert ab_swinir.main(["--base", str(tmp_path), "--", "--steps", "5"]) == 0
    assert [c[0] for c in calls] == ["base", "change", "change", "base"]
    assert all(c[1] == ["--steps", "5"] for c in calls)
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["tree"] for x in lines[:-1]] == ["base"] * 2 + ["change"] * 4 + ["base"] * 2
    summary = lines[-1]["ab_swinir"]
    base, change = summary["base"]["fp32"], summary["change"]["fp32"]
    assert base["step_ms"] == [164.0, 166.0] and base["median_step_ms"] == 165.0
    assert change["images_per_s_at_median"] == pytest.approx(36 / 137.0 * 1e3)
    assert change["busy_ms"] == 126.0 and change["window_attn_ms"] == 32.0
    assert change["step_idle_share"] == pytest.approx((10 / 136 + 12 / 138) / 2)
    assert summary["base"]["bf16"]["window_attn_ms"] == 61.0
    assert summary["change"]["bf16"]["median_step_ms"] == 159.0


def test_ab_swinir_summary_of_untraced_runs():
    """CPU profile runs carry no device numbers: the summary has step times
    only."""
    from pytorch_distributedtraining_tpu_torch.benchmarks import ab_swinir

    rec = {"precision": "bf16", "step_ms": 50.0, "loss": 0.1}
    s = ab_swinir.summarize([("change", rec), ("change", dict(rec, step_ms=70.0))])
    assert set(s) == {"change"} and set(s["change"]) == {"bf16"}
    assert s["change"]["bf16"] == {"step_ms": [50.0, 70.0], "median_step_ms": 60.0,
                                   "images_per_s_at_median": 36 / 60.0 * 1e3}


def test_collate_timer_times_both_ways_at_a_toy_batch(capsys):
    from pytorch_distributedtraining_tpu_torch.benchmarks import collate

    r = collate.time_case((3, 8, 2, 4))
    assert set(r) == {"np_stack_ms", "fast_stack_ms"} and min(r.values()) > 0
    assert collate.main(["--reps", "2", "--procs", "1"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["path"] for x in lines] == [c[0] for c in collate.CASES]
    assert all(x["procs"] == 1 and x["np_stack_ms"] > 0 and x["fast_stack_ms"] > 0 for x in lines)


def test_trace_loss_needs_a_card(capsys):
    """``benchmarks/trace_loss.py`` measures CUPTI's record loss on a card
    only: without one it prints why and exits 2, before importing the
    smoke script or building anything."""
    from pytorch_distributedtraining_tpu_torch.benchmarks import trace_loss

    assert not torch.cuda.is_available()
    assert trace_loss.main(["--age", "--reps", "1", "--observe", "1"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
    assert set(trace_loss.VARIANTS) >= {"raw", "warm 256", "observe.profiling"}
