"""``chip_smoke.py``'s checks that need no card, on the CPU. The build
check reads ptxas's report and the HMMA counts of the SASS, and fails
unless every body of K3 (flash forward), K4 (flash dq) and K5 (flash
dk/dv) runs on the tensor cores, as ``ops.flash_attn.uses_tensor_cores``
says, and no flash kernel spills; and unless every body of K1 and K2
(window-attention forward and backward) runs on the tensor cores, as
``ops.window_attn.uses_tensor_cores`` says, and no window kernel spills.
The flash bounds take each kernel's body's rate, and phase 4 fails on a
kernel slower than its plain version. The optimizer phase's bound is the
bytes of one pass over p, g and the moments, and its gate check names each
buffer a skipped step changed. Phase 15's resume check names the first
loss, parameter or moment in which two runs differ. Phase 17 reads K1/K2
(and K3-K5) launches from the op table of a capture, counts FSDP2's
all-gathers by its annotations and a collective inventory by kind. Phase
18 reads a launcher run's output: the driver's final losses, each
generation's ``[kernels]`` lines, the resume and restart lines and when
each generation reached its training loop, and sees each line (and the
processes the ranks started) as it comes; its launcher runs see no
group's contract and no ``GRAFT_*`` knob an earlier phase left. Phase 19
holds a graphed run against its eager twin (bitwise, else within the
stated tolerance of the eager run's change) and reads a replay's graph
launches and K1-K5 kernels a step from its device records."""

import importlib.util
import os
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _mangled(kind: str, dtype: str, d: int) -> str:
    code = {"f32": "f", "f16": "6__half", "bf16": "13__nv_bfloat16"}[dtype]
    return f"_ZN12_GLOBAL__N_119flash_attn_{kind}_kernelI{code}Li{d}EEEvPKT_"


KEYS = [f"{kind} {dtype} D={d}" for kind in ("fwd", "dq", "dkv")
        for dtype in ("f32", "bf16", "f16") for d in (16, 32, 64)]


@pytest.mark.parametrize("key", KEYS)
def test_kernel_key_reads_the_mangled_name(smoke, key):
    kind, dtype, d = key.split()
    assert smoke.kernel_key(_mangled(kind, dtype, int(d[2:]))) == key


def test_ptxas_entries_pairs_registers_with_spills(smoke):
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{_mangled('dq', 'bf16', 64)}' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{_mangled('dq', 'f32', 64)}' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 166 registers, used 1 barriers, 400 bytes cmem[0]",
    ])
    assert smoke.ptxas_entries(log) == {"dq bf16 D=64": (255, 8), "dq f32 D=64": (166, 0)}


def _as_designed():
    """No spill; HMMA in every K3, K4 and K5 body."""
    regs = {k: (128, 0) for k in KEYS}
    hmma = {k: 64 for k in KEYS}
    return regs, hmma


def test_build_as_designed_has_no_faults(smoke):
    assert smoke.flash_build_faults(*_as_designed()) == []
    assert smoke.flash_build_faults(_as_designed()[0], None) == []


@pytest.mark.parametrize("fault", ["dq bf16 on cuda cores", "dq f16 on cuda cores",
                                   "fwd bf16 on cuda cores", "dq f32 spill", "spill",
                                   "spill without cuobjdump", "fwd f32 on cuda cores",
                                   "dq f32 on cuda cores", "dkv f32 on cuda cores"])
def test_build_faults_are_found(smoke, fault):
    regs, hmma = _as_designed()
    if fault.endswith("on cuda cores"):
        key = fault.split(" on")[0] + " D=64"
        hmma[key] = 0
        want = [f"{key}: 0 HMMA"]
    elif fault == "dq f32 spill":
        regs["dq f32 D=64"] = (255, 16)
        want = ["dq f32 D=64: 16 bytes spill stores"]
    else:
        regs["dq f16 D=64"] = (255, 24)
        want = ["dq f16 D=64: 24 bytes spill stores"]
        if fault == "spill without cuobjdump":
            hmma = None
    assert smoke.flash_build_faults(regs, hmma) == want


# -- window attention (K1, K2 and the dbias reduction) ---------------------------

WINDOW_KEYS = ([f"wfwd {t} N={n} D={d}" for t in ("f32", "bf16", "f16") for n in (32, 64, 128)
                for d in (16, 32)]
               + [f"wbwd {t} N={n} D={d}" for t in ("f32", "bf16", "f16") for n in (64, 128)
                  for d in (16, 32)] + ["dbias_reduce"])
# anonymous namespaces as nvcc mangles them: plain, or with the file's hash
SPACES = ["_ZN12_GLOBAL__N_1", "_ZN47_GLOBAL__N__38bc5ccd_14_window_attn_cu_ff9b4fd8"]


def _window_mangled(key: str, space: str) -> str:
    if key == "dbias_reduce":
        return f"{space}19dbias_reduce_kernelEPKfPfii"
    kind, dtype, a, d = key.split()
    code = {"f32": "f", "f16": "6__half", "bf16": "13__nv_bfloat16"}[dtype]
    name = {"wfwd": "22window_attn_fwd_kernel", "wbwd": "22window_attn_bwd_kernel"}[kind]
    return f"{space}{name}I{code}Li{a[2:]}ELi{d[2:]}EEEvPKT_"


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("key", WINDOW_KEYS)
def test_kernel_key_reads_window_names(smoke, key, space):
    assert smoke.kernel_key(_window_mangled(key, space)) == key


def test_ptxas_entries_read_window_kernels(smoke):
    bwd, fwd = (_window_mangled(k, SPACES[1]) for k in ("wbwd f32 N=64 D=16", "wfwd bf16 N=64 D=16"))
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{bwd}' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'",
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 48 registers, used 1 barriers, 8 bytes cumulative stack size",
    ])
    assert smoke.ptxas_entries(log) == {"wbwd f32 N=64 D=16": (168, 0),
                                        "wfwd bf16 N=64 D=16": (48, 8)}


def _window_as_designed():
    """No spill; HMMA in every body of K1 and K2, none in the reduction."""
    regs = {k: (128, 0) for k in WINDOW_KEYS}
    hmma = {k: 0 if k == "dbias_reduce" else 64 for k in WINDOW_KEYS}
    return regs, hmma


def test_window_build_as_designed_has_no_faults(smoke):
    regs, hmma = _window_as_designed()
    assert not any(s for _, s in regs.values())
    assert smoke.window_build_faults(regs, hmma) == []
    assert smoke.window_build_faults(regs, None) == []


@pytest.mark.parametrize("fault", ["k2 spill", "k1 spill", "k1 spill at n=128",
                                   "reduce spill", "k2 f32 on cuda cores",
                                   "k2 bf16 on cuda cores", "k1 f32 on cuda cores",
                                   "k1 bf16 on cuda cores", "reduce on tensor cores"])
def test_window_build_faults_are_found(smoke, fault):
    """A spill of any size in any window kernel is a fault (K1's 8-byte
    spills no longer excepted), and so is a K1 or K2 body without HMMA."""
    regs, hmma = _window_as_designed()
    if fault == "k2 spill":
        regs["wbwd bf16 N=64 D=16"] = (168, 4)
        want = ["wbwd bf16 N=64 D=16: 4 bytes spill stores"]
    elif fault == "k1 spill":
        regs["wfwd f32 N=64 D=16"] = (56, 8)
        want = ["wfwd f32 N=64 D=16: 8 bytes spill stores"]
    elif fault == "k1 spill at n=128":
        regs["wfwd f16 N=128 D=32"] = (64, 4)
        want = ["wfwd f16 N=128 D=32: 4 bytes spill stores"]
    elif fault == "reduce spill":
        regs["dbias_reduce"] = (32, 8)
        want = ["dbias_reduce: 8 bytes spill stores"]
    elif fault == "reduce on tensor cores":
        hmma["dbias_reduce"] = 4
        want = ["dbias_reduce: 4 HMMA"]
    else:
        kind = {"k1": "wfwd", "k2": "wbwd"}[fault.split()[0]]
        key = f"{kind} {fault.split()[1]} N=64 D=16"
        hmma[key] = 0
        want = [f"{key}: 0 HMMA"]
    assert smoke.window_build_faults(regs, hmma) == want


def test_k2_bound_takes_the_3xtf32_rate_in_f32(smoke):
    """K1's and K2's f32 products run as three TF32 products each: their
    bound by operations is at 495/3 TFLOP/s, not the CUDA cores' 67; bf16
    at 989."""
    gflop = 2.83e9
    assert smoke.bound_ms(0, gflop, "float32", smoke.TENSOR_PEAK_FLOPS)[0] == pytest.approx(
        gflop * 3 / 495e12 * 1e3)
    assert smoke.bound_ms(0, gflop, "float32")[0] == pytest.approx(gflop / 67e12 * 1e3)
    assert smoke.bound_ms(125e6, gflop, "float32", smoke.TENSOR_PEAK_FLOPS)[1] == "bytes"
    assert smoke.bound_ms(0, gflop, "bfloat16", smoke.TENSOR_PEAK_FLOPS)[0] == pytest.approx(
        gflop / 989e12 * 1e3)


GPT2_SHAPE = (8, 512, 12, 64)  # the GPT-2 phase's q/k/v: batch 8, seq 512, 12 heads of 64
CAUSAL_FLOP = 4 * 8 * 12 * (512 * 513 // 2) * 64  # K3's products, 3.23 GFLOP


@pytest.mark.parametrize("kernel,factor,rate", [("fwd", 1, 495e12 / 3), ("dq", 1.5, 495e12 / 3),
                                                ("dkv", 2, 495e12 / 3)])
def test_flash_bound_takes_each_kernels_body_rate_in_f32(smoke, kernel, factor, rate):
    """f32 K3, K4 and K5 run as 3xTF32 (495/3 TFLOP/s: 0.0196, 0.0293 and
    0.0391 ms at GPT-2's shape); all three bound by operations."""
    ms, by = smoke.flash_bounds(GPT2_SHAPE, "float32", True)[kernel]
    assert by == "operations" and ms == pytest.approx(factor * CAUSAL_FLOP / rate * 1e3)


def test_flash_bound_in_bf16_is_by_bytes(smoke):
    """In bf16 every body is on the tensor cores and K3 moves q/k/v/o (2
    bytes each) and lse (f32) once: 0.0076 ms at 3.35 TB/s."""
    bounds = smoke.flash_bounds(GPT2_SHAPE, "bfloat16", True)
    moved = 4 * 2 * 8 * 512 * 12 * 64 + 4 * 8 * 12 * 512
    assert bounds["fwd"] == pytest.approx((moved / 3.35e12 * 1e3, "bytes"))
    assert {by for _, by in bounds.values()} == {"bytes"}
    causal, full = (smoke.flash_bounds((1, 1024, 1, 64), "float32", c)["fwd"][0]
                    for c in (True, False))
    assert full == pytest.approx(causal * 1024 / 512.5)


def _flash_times(**slow):
    times = {"fwd": 0.06, "dq": 0.5, "dkv": 0.6, "plain_fwd": 0.84, "plain_dq": 0.9,
             "plain_dkv": 1.0}
    times.update(slow)
    return times


@pytest.mark.parametrize("slow,want", [({}, []),
                                       ({"fwd": 0.9}, ["fwd 0.9000 ms > plain 0.8400 ms"]),
                                       ({"dkv": 1.2, "plain_dq": 0.4},
                                        ["dq 0.5000 ms > plain 0.4000 ms",
                                         "dkv 1.2000 ms > plain 1.0000 ms"])])
def test_flash_speed_faults_name_kernels_slower_than_plain(smoke, slow, want):
    assert smoke.flash_speed_faults(_flash_times(**slow)) == want


def test_flash_speed_faults_read_only_the_kernels_a_case_ran(smoke):
    """Phase 4's f32 non-causal case runs K4 and K5: its times hold no K3
    entry, and only K4 and K5 are held against their plain versions."""
    assert smoke.flash_speed_faults({"dq": 0.2, "plain_dq": 1.7, "dkv": 0.3,
                                     "plain_dkv": 1.9}) == []
    assert smoke.flash_speed_faults({"dq": 1.8, "plain_dq": 1.7, "dkv": 2.0,
                                     "plain_dkv": 1.9}) == [
        "dq 1.8000 ms > plain 1.7000 ms", "dkv 2.0000 ms > plain 1.9000 ms"]


@pytest.mark.parametrize("ema,per", [(False, 28), (True, 36)])
def test_optimizer_bound_is_the_bytes_of_one_pass(smoke, ema, per):
    """GPT-2 125M: 28 B a parameter (read p, g, mu, nu; write p, mu, nu) at
    3.35 TB/s is 1.04 ms; the EMA adds a read and a write."""
    n = 124_439_808
    ms, by = smoke.optimizer_bound_ms(n, ema=ema)
    assert by == "bytes" and ms == pytest.approx(per * n / 3.35e12 * 1e3)
    assert smoke.optimizer_bound_ms(n)[0] == pytest.approx(1.0401, abs=1e-4)


@pytest.mark.parametrize("moved", [None, "params", "mu", "nu", "count"])
def test_gated_step_faults_find_a_buffer_that_moved(smoke, moved):
    import torch

    before = {"params": torch.arange(5.0), "mu": torch.zeros(5), "nu": torch.ones(5),
              "count": torch.tensor(3, dtype=torch.int32)}
    after = {k: v.clone() for k, v in before.items()}
    if moved is not None:
        after[moved].view(-1)[0] += 1
    assert smoke.gated_step_faults(before, after) == ([] if moved is None else [moved])


def _run(**changes) -> dict:
    run = {"losses": [0.5, 0.25, 0.125],
           "params": {"conv.weight": torch.arange(6.0).view(2, 3), "conv.bias": torch.zeros(2)},
           "moments": {"count": torch.tensor(2), "mu/conv.weight": torch.ones(2, 3),
                       "nu/conv.weight": torch.full((2, 3), 0.5)}}
    for path, value in changes.items():
        group, _, name = path.partition(":")
        if group == "losses":
            run["losses"][int(name)] = value
        elif value is None:
            del run[group][name]
        else:
            run[group][name] = value
    return run


@pytest.mark.parametrize("changes,first,worst", [
    ({}, None, 0.0),
    ({"losses:2": 0.125 + 2**-20}, "loss 2", 2**-20),
    ({"params:conv.bias": torch.tensor([0.0, -1e-7])}, "params/conv.bias", 1e-7),
    ({"moments:nu/conv.weight": torch.full((2, 3), 0.75),
      "losses:1": 0.3}, "loss 1", 0.25),
    ({"moments:mu/conv.weight": torch.ones(3, 2)}, "moments/mu/conv.weight",
     float("inf")),
    ({"moments:count": None}, "moments/count", float("inf")),
    ({"params:conv.weight": torch.full((2, 3), float("nan"))},
     "params/conv.weight", float("inf")),
], ids=["equal", "a-loss", "a-parameter", "first-of-two", "a-shape", "a-missing-moment", "nan"])
def test_resume_mismatch_names_the_first_entry_that_differs(smoke, changes, first, worst):
    """Phase 15's check: two runs' losses, parameters and moments compared
    bitwise, the largest difference and the first entry (losses, then
    parameters, then moments) that is not equal."""
    got_worst, got_first = smoke.resume_mismatch(_run(), _run(**changes))
    assert got_first == first
    assert got_worst == pytest.approx(worst, rel=1e-6)


def _k1k2_trace(steps: int, per_step: int, drop: int = 0) -> list:
    """A capture's events: K1, K2 and its dbias reduction ``per_step`` times a
    step over ``steps`` steps, as CUPTI names them (template arguments
    vary by shape), a GEMM, a copy, an NCCL all-reduce a step, host ops."""
    events = []
    for i in range(steps * per_step - drop):
        for name in (f"void (anonymous namespace)::window_attn_fwd_kernel<float, {i % 2 + 1}, 16>(x)",
                     "void (anonymous namespace)::window_attn_bwd_kernel<float, 64, 16>(x)",
                     "void (anonymous namespace)::dbias_reduce_kernel(x)"):
            events.append({"ph": "X", "cat": "kernel", "name": name, "ts": float(i), "dur": 1.0})
    for i in range(steps):
        events.append({"ph": "X", "cat": "kernel", "ts": 0.0, "dur": 5.0,
                       "name": "ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)"})
    events += [{"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_f32f32", "ts": 0.0,
                "dur": 500.0},
               {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)",
                "ts": 0.0, "dur": 2.0},
               {"ph": "X", "cat": "cpu_op", "name": "window_attn_fwd_kernel", "ts": 0.0,
                "dur": 900.0}]
    return events


@pytest.mark.parametrize("drop,faults", [(0, []), (1, ["K1", "K2"])])
def test_k1_k2_launches_read_from_a_captures_op_table(smoke, drop, faults):
    """Phase 17 (a): 48 K1 and 48 K2 a step (24 a micro-batch, two
    micro-batches) over the capture's three steps, read from the op table's
    compute rows; a missing launch is a fault."""
    from pytorch_distributedtraining_tpu_torch.observe import opcost

    table = opcost.op_table(_k1k2_trace(3, 48, drop))
    launches = smoke.table_launches(table, smoke.WINDOW_KERNELS)
    assert launches == {"K1": 144 - drop, "K2": 144 - drop}
    got = smoke.launch_faults(launches, 48, 3)
    assert [f.split(":")[0] for f in got] == faults
    assert smoke.table_launches(table, smoke.FLASH_KERNELS) == {"K3": 0, "K4": 0, "K5": 0}


def test_fsdp_all_gathers_and_wire_counts(smoke):
    from pytorch_distributedtraining_tpu_torch.observe import comms

    events = [{"cat": "user_annotation", "name": f"FSDP::all_gather ({m})"}
              for m in ("transformer.h.0", "transformer.h.1", "")]
    events += [{"cat": "user_annotation", "name": "FSDP::all_gather_copy_out (transformer.h.0)"},
               {"cat": "cpu_op", "name": "FSDP::all_gather (x)"}]
    assert smoke.fsdp_all_gathers(events) == 3
    wires = [comms.WireCollective(k, "f32", 4, "") for k in
             ("all-gather", "reduce-scatter", "all-gather")]
    assert smoke.wire_counts(wires) == {"all-gather": 2, "reduce-scatter": 1}


def test_lost_launches_are_the_calls_without_a_device_record(smoke):
    """Phase 17: a launch, copy or set call whose correlation id has no
    kernel, copy or set record in the trace is a record the profiler lost."""
    def ev(cat, corr, name="x"):
        return {"ph": "X", "cat": cat, "name": name, "ts": 0.0, "dur": 1.0,
                "args": {"correlation": corr}}

    events = [ev("cuda_runtime", 1, "cudaLaunchKernel"), ev("kernel", 1),
              ev("cuda_driver", 2, "cuLaunchKernel"),
              ev("cuda_runtime", 3, "cudaMemcpyAsync"), ev("gpu_memcpy", 3),
              ev("cuda_runtime", 4, "cudaMemsetAsync"),
              ev("cuda_runtime", 5, "cudaStreamSynchronize"),
              {"cat": "cpu_op", "name": "aten::add", "ts": 0.0}]
    assert smoke.lost_launches(events) == [2, 4]
    assert smoke.lost_launches(events[:2]) == []


def test_lost_where_locates_the_lost_calls(smoke):
    """Phase 17: the lost calls' indices in time order, offsets, names,
    threads and host ops."""
    def call(corr, ts, name="cudaLaunchKernel", tid=1):
        return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1.0,
                "tid": tid, "args": {"correlation": corr, "External id": corr}}

    def dev(corr):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": 0.0, "dur": 1.0,
                "args": {"correlation": corr}}

    events = [call(3, 3000.0), call(1, 1000.0, "cudaMemcpyAsync", tid=2), call(2, 2000.0),
              call(4, 4000.0), dev(3), dev(4),
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 900.0,
               "args": {"External id": 1}}]
    got = smoke.lost_where(events)
    assert got["lost"] == 2 and got["of"] == 4 and (got["first"], got["last"]) == (0, 1)
    assert got["from_first_ms"] == [0.0, 1.0] and got["to_last_ms"] == [2.0, 3.0]
    assert got["names"] == ["cudaLaunchKernel", "cudaMemcpyAsync"]
    assert got["tids"] == ["1", "2"] and got["all_tids"] == ["1", "2"]
    assert got["ops"] == ["None", "aten::mm"]
    assert smoke.lost_where(events[:1] + [dev(3)]) == {"lost": 0, "of": 1}


LAUNCH_OUTPUT = [
    (0.1, "[launch] membership: register host=node0 capacity=1"),
    (9.4, "===> Training"),
    (12.0, "--------Train Loss after Epoch 0 - 1.5 --------"),
    (12.1, "--------Val Loss after Epoch 0 - 2.5 --------"),
    (12.2, '[kernels] {"rank": 0, "attempt": 0, "epoch": 0, "window_attn_fwd": 144, '
           '"window_attn_bwd": 120, "flash_attn_fwd": 0, "flash_attn_dq": 0, '
           '"flash_attn_dkv": 0}'),
    (20.0, "[launch] world failed (rc=-9, class=outage), restart 1/1 in 0.1s"),
    (33.0, "===> Resumed portable checkpoint /x/epoch_0000 (resharded onto this run), from "
           "epoch 1 (recovery_mode=retry)"),
    (34.0, "===> Training"),
    (36.0, "--------Train Loss after Epoch 1 - 1.25 --------"),
    (36.1, "--------Val Loss after Epoch 1 - 2.0 --------"),
    (36.2, '[kernels] {"rank": 0, "attempt": 1, "epoch": 1, "window_attn_fwd": 144, '
           '"window_attn_bwd": 120, "flash_attn_fwd": 0, "flash_attn_dq": 0, '
           '"flash_attn_dkv": 0}'),
]


def test_parse_driver_run_reads_a_launcher_run(smoke):
    got = smoke.parse_driver_run(LAUNCH_OUTPUT)
    assert got["train"] == [(0, 1.5), (1, 1.25)] and got["val"] == [(0, 2.5), (1, 2.0)]
    assert sorted(got["kernels"]) == [0, 1]
    assert got["kernels"][1][-1]["window_attn_bwd"] == 120
    assert got["resumed"] == [LAUNCH_OUTPUT[6][1]] and got["restarts"] == [LAUNCH_OUTPUT[5][1]]
    assert got["training_at"] == [9.4, 34.0] and got["restart_at"] == [20.0]
    assert got["epochs_at"] == [12.1, 36.1]


def test_launch_env_drops_the_contract_and_stale_knobs(smoke, monkeypatch):
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("GRAFT_NUMERICS", "1")
    env = smoke.launch_env("/run/dir", GRAFT_FAULT_PLAN="{}")
    assert "RANK" not in env and "MASTER_PORT" not in env and "GRAFT_NUMERICS" not in env
    assert env["GRAFT_FAULT_PLAN"] == "{}" and env["TMPDIR"] == "/run/dir"
    assert env["PYTHONPATH"] == str(ROOT)


def test_timed_lines_shows_each_line_with_the_grandchildren(smoke, tmp_path):
    """Phase 18 (w): ``on_line`` sees each line as it arrives, while the
    command runs, and ``grandchildren`` finds the processes its children
    started (a rank's loader workers under the launcher)."""
    code = ("import subprocess, sys\n"
            "inner = 'import subprocess, sys, time; "
            "g = subprocess.Popen([sys.executable, \"-c\", \"import time; time.sleep(60)\"]); "
            "print(g.pid, flush=True); time.sleep(60)'\n"
            "c = subprocess.Popen([sys.executable, '-c', inner], stdout=subprocess.PIPE, "
            "text=True)\n"
            "print('grandchild', c.stdout.readline().strip(), flush=True)\n"
            "print('done', flush=True)\n")
    seen = []

    def on_line(line, pid):
        seen.append((line, [p for p, _ in smoke.grandchildren(pid)]))

    rc, lines, _ = smoke.timed_lines([sys.executable, "-c", code], str(tmp_path), dict(os.environ),
                                     timeout=30, on_line=on_line)
    assert rc == 0 and [ln for _, ln in lines] == [ln for ln, _ in seen]
    grandchild = int(seen[0][0].split()[1])
    assert seen[0][1] == [grandchild]


def test_graph_mismatch_is_relative_to_the_reference_runs_change(smoke):
    """Phase 19: the largest difference between the graphed and the eager
    parameters, and that over the largest change the eager run made."""
    start = [torch.zeros(3), torch.ones(2)]
    want = [torch.tensor([0.0, 2.0, 0.0]), torch.ones(2)]
    assert smoke.graph_mismatch(want, want, start) == (0.0, 0.0)
    got = [torch.tensor([0.0, 2.0, 1e-3]), torch.ones(2)]
    diff, rel = smoke.graph_mismatch(got, want, start)
    assert diff == pytest.approx(1e-3) and rel == pytest.approx(5e-4)


@pytest.mark.parametrize("loss_shift,param_shift,faults", [
    (0.0, 0.0, 0), (1e-6, 0.0, 0), (1e-3, 0.0, 1), (0.0, 1e-3, 1), (float("nan"), 0.0, 1)])
def test_graph_faults_hold_graphed_against_eager_at_the_tolerance(smoke, capsys, loss_shift,
                                                                  param_shift, faults):
    """Bitwise passes; a difference within ``GRAPH_TOL`` (f32: 1e-5 of the
    loss, of the eager run's largest change) passes and is printed; more,
    or a non-finite loss, is a fault."""
    start, want = [torch.zeros(4)], [torch.ones(4)]
    got = [want[0] + param_shift]
    out = smoke.graph_faults("case", ([1.0 + loss_shift, 0.5], [1.0, 0.5]), (got, want), start,
                             "float32")
    assert len(out) == faults
    said = capsys.readouterr().out
    assert ("bitwise equal" in said) == (loss_shift == 0.0 and param_shift == 0.0)


def _replay_trace(windows: int, k: int) -> list:
    """A trace of ``windows`` graph launches, each running K3-K5 twelve
    times a step for ``k`` steps, with the launches' correlation ids on
    the kernels (as CUPTI records a graph's kernels)."""
    events, t = [], 0.0
    for w in range(windows):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": t,
                       "dur": 5.0, "args": {"correlation": w}})
        for _ in range(12 * k):
            for name in ("flash_attn_fwd_kernel", "flash_attn_dq_kernel", "flash_attn_dkv_kernel"):
                events.append({"ph": "X", "cat": "kernel", "name": f"void {name}<bf16>(x)",
                               "ts": t, "dur": 1.0, "args": {"correlation": w}})
                t += 1.0
    return events


def test_replay_counts_read_graph_launches_and_kernels_a_step(smoke):
    """Phase 19: a traced window's graph launches and K1-K5 kernels a step,
    read from the device records (``observe.opcost``'s op table), and the
    busy ms a step; a graph's kernels carry its launch's correlation id,
    so no launch of the trace is lost."""
    events = _replay_trace(1, 4)
    got = smoke.replay_counts(events, 4)
    assert got["graph_launches"] == 0.25
    assert (got["K3"], got["K4"], got["K5"], got["K1"], got["K2"]) == (12, 12, 12, 0, 0)
    assert got["busy_ms"] == pytest.approx(144 * 1e-3 / 4) and got["lost"] == 0
    assert "collectives" not in got


@pytest.mark.parametrize("takes,want", [
    ([48], (1, [])), ([46, 48], (2, [])), ([46, 47, 48], (3, [])),
    ([46, 46, 46], (3, ["11.5"])), ([50], (1, ["12.5"]))])
def test_replay_traced_takes_a_lossy_trace_again(smoke, monkeypatch, capsys, takes, want):
    """Phase 19: a replay's trace that counts fewer K3 than the graph holds
    (48 over the window: lost device records) is printed and taken again,
    ``GRAPH_TAKES`` takes at most; the last take's counts are what
    ``graph_report`` checks, so a trace that never holds them all, or holds
    more, is a fault."""
    from pytorch_distributedtraining_tpu_torch.observe import profiling

    traces = []
    for n in takes:
        events = _replay_trace(1, 4)
        kept, k3 = [], 0
        for e in events:
            k3 += "flash_attn_fwd_kernel" in e["name"]
            if "flash_attn_fwd_kernel" not in e["name"] or k3 <= n:
                kept.append(e)
        for _ in range(n - 48):  # more K3 records than the graph holds
            kept.append({**kept[1], "ts": kept[-1]["ts"] + 1.0})
        traces.append(kept)
    calls = iter(traces)
    monkeypatch.setattr(profiling, "profile_call", lambda fn: (fn(), next(calls)))
    per_step = {"K3": 12, "K4": 12, "K5": 12}
    counts = smoke.replay_traced("case", lambda: None, 4, per_step)
    assert counts["takes"] == want[0] and counts["K4"] == counts["K5"] == 12
    said = capsys.readouterr().out
    assert said.count("traced again") == want[0] - 1
    eager = {"ms": 10.0, "peak": 1.0, "counts": {**counts, "busy_ms": 1.0}}
    graphed = {"ms": 5.0, "peak": 1.0, "counts": counts}
    _, faults = smoke.graph_report("case", "H100, 700 W", eager, graphed, per_step)
    assert [f.split("K3 ")[1].split(" ")[0] for f in faults] == want[1]


@pytest.mark.parametrize("takes,want", [([48], (1, [])), ([47, 48], (2, [])),
                                        ([47, 47, 47], (3, ["K1", "K2"])), ([49], (1, ["K1",
                                                                                      "K2"]))])
def test_traced_call_counts_device_records_and_retakes_a_short_take(smoke, monkeypatch, capsys,
                                                                    takes, want):
    """Phases 5, 6, 11, 12 and 15: K1/K2 counted from a traced call's device
    records (a graph's replay calls no wrapper); a take that counts fewer
    than expected is printed and taken again, ``GRAPH_TAKES`` takes at
    most, and ``kernel_faults`` holds the last take's counts exactly."""
    from pytorch_distributedtraining_tpu_torch.observe import profiling

    traces = iter([_k1k2_trace(1, n, 0) for n in takes])
    monkeypatch.setattr(profiling, "profile_call", lambda fn: (fn(), next(traces)))
    per_step = {"K1": 48, "K2": 48}
    got = smoke.traced_call(lambda: None, per_step)
    assert got["takes"] == want[0] and got["kernels"]["K1"] == takes[want[0] - 1]
    assert got["kernels"]["K3"] == 0 and got["nccl"] == 1
    assert capsys.readouterr().out.count("taken again") == want[0] - 1
    assert [f.split(" ")[1] for f in smoke.kernel_faults("case", got["kernels"], per_step)] \
        == want[1]


def test_capture_launches_count_the_warm_up_and_the_capture(smoke):
    """A program's kernels reach the wrappers once at each warm-up run and
    once inside its capture, never at a replay."""
    from pytorch_distributedtraining_tpu_torch.parallel import graph

    assert smoke.capture_launches(1, 48) == (graph.WARMUP + 1) * 48
    assert smoke.capture_launches(2, 24) == smoke.capture_launches(1, 48)
    assert smoke.capture_launches(0, 24) == 0


class _Graph:
    def __init__(self, pool):
        self._pool = pool

    def pool(self):
        return self._pool


def test_peaks_add_the_pools_of_every_graph(smoke, monkeypatch):
    """Phases 6, 11, 12 and 19: a facade holds a graph per program, each
    with its private pool; the peak adds every pool's segments once, and
    no other pool's."""
    segments = [{"segment_pool_id": (0, 1), "total_size": 2**30},
                {"segment_pool_id": (0, 1), "total_size": 2**29},
                {"segment_pool_id": (0, 2), "total_size": 2**28},
                {"segment_pool_id": (0, 3), "total_size": 2**27},
                {"segment_pool_id": None, "total_size": 2**26}]
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: segments)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 2**30)
    a, b = _Graph((0, 1)), _Graph((0, 2))
    assert smoke.pool_bytes(a, b) == 2**30 + 2**29 + 2**28
    assert smoke.pool_bytes(a, a) == 2**30 + 2**29
    assert smoke._peak_gib(lambda: None) == 1.0
    assert smoke._peak_gib(lambda: None, a, b) == 1.0 + 1.5 + 0.25

    class Runner:
        def __init__(self, graph):
            self.graph = graph

    stoke = type("Stoke", (), {})()
    stoke._graphs = {("window", ()): Runner(a), ("first", ()): Runner(b),
                     ("acc", ()): Runner(None)}
    assert smoke.facade_graphs(stoke) == [a, b]
    assert smoke.pools_gib(stoke) == 1.75


def test_graph_report_prints_an_untraced_eager_run_as_such(smoke, capsys):
    """Phase 19 (e) times its uncaptured twin without tracing it: the
    report prints its busy ms and idle share as not traced and still
    holds the replay's kernel counts exactly."""
    counts = {"graph_launches": 3.0, "busy_ms": 80.0, "lost": 0, "K1": 48, "K2": 47,
              "collectives": {"all-reduce": 2}, "takes": 1}
    row, faults = smoke.graph_report("case", "H100, 700 W", {"ms": 250.0, "peak": 5.0},
                                     {"ms": 80.5, "peak": 5.5, "counts": counts},
                                     {"K1": 48, "K2": 48})
    said = capsys.readouterr().out
    assert "device busy not traced / 80.00 ms" in said and "idle not traced / 0.006" in said
    assert "collectives read (observe.comms) eager not traced, replay" in said
    assert row["eager_busy_ms"] is None and row["eager_idle"] is None
    assert row["graphed_idle"] == pytest.approx(1 - 80.0 / 80.5)
    assert [f.split(": ")[1].split(" ")[0] for f in faults] == ["K2"]


@pytest.mark.parametrize("loss_shift,param_shift,faults", [
    (0.0, 0.0, 0), (1e-7, 0.0, 1), (0.0, 1e-7, 1)])
def test_graph_faults_exact_require_bitwise(smoke, capsys, loss_shift, param_shift, faults):
    """Phase 19 (f) holds every graphed program bitwise against its
    uncaptured twin: with ``exact`` a difference GRAPH_TOL would pass is a
    fault."""
    start, want = [torch.zeros(4)], [torch.ones(4)]
    got = [want[0] + param_shift]
    out = smoke.graph_faults("case", ([1.0 + loss_shift], [1.0]), (got, want), start,
                             "float32", exact=True)
    assert len(out) == faults
    assert all("bitwise expected" in f for f in out)


def test_layout_flags_build_zero3_and_a_ddp_model(smoke):
    """19 (f)'s two layouts: ``fairscale_fsdp`` with ``FairscaleFSDPConfig``
    (ZeRO-3), and DDP flags with the per-leaf chain (the wrapper)."""
    from pytorch_distributedtraining_tpu_torch.stoke import FairscaleFSDPConfig

    fsdp = smoke.layout_flags("fsdp")
    assert fsdp["fsdp"] and isinstance(fsdp["configs"][0], FairscaleFSDPConfig)
    assert smoke.layout_flags("ddp") == {"oss": False, "sddp": False, "fused_optimizer": False}
    assert {case[1] for case in smoke.LAYOUT_CASES} == {"fsdp", "ddp"}
    assert {case[3] for case in smoke.LAYOUT_CASES} == {("window",), ("first", "acc", "apply")}


def test_cold_counts_read_each_graph_and_match_two_rounds(smoke):
    """19 (f)'s cold programs: each graph read as (program, batch,
    captures, replays); two graphed rounds give one capture a program and
    signature, the forward program replayed twice a round (the handle
    read alone and the loss's)."""
    def graph(captures, replays):
        return type("G", (), {"captures": captures, "replays": replays})()

    b, n = smoke.BATCH, smoke.COLD_EVAL_N
    sig = lambda rows: (((rows, 32, 32, 3), torch.float32),)  # noqa: E731
    stoke = type("Stoke", (), {})()
    stoke._graphs = {("forward", sig(b)): graph(1, 4), ("loss", sig(b)): graph(1, 2),
                     ("eval_forward", sig(b)): graph(1, 2),
                     (("eval", ()), sig(b)): graph(1, 2), (("eval", ()), sig(n)): graph(1, 2)}
    assert smoke.cold_counts(stoke) == smoke.cold_expected(2)
    stoke._graphs[("loss", sig(b))] = graph(2, 2)  # a second capture of one signature
    assert smoke.cold_counts(stoke) != smoke.cold_expected(2)
