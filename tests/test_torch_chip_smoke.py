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
loss, parameter or moment in which two runs differ."""

import importlib.util
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
