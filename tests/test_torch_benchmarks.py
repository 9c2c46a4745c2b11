"""The port's step profiler (``benchmarks/profile_swinir.py``) on the CPU:
the bench step it times runs end to end at a toy size, and its trace
digest sorts kernels into families and computes busy and idle time from
a Chrome trace. Device numbers come only from a GPU run."""

import json
import math

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
