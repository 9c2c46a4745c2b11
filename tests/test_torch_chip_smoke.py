"""``chip_smoke.py``'s build check, on the CPU: it reads ptxas's report and
the HMMA counts of the SASS, and fails unless every bf16/f16 flash body
(K3, K4, K5) runs on the tensor cores and every f32 body on the CUDA
cores, as ``ops.flash_attn.uses_tensor_cores`` says, and no flash kernel
spills."""

import importlib.util
from pathlib import Path

import pytest

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
    regs = {k: (128, 0) for k in KEYS}
    hmma = {k: 64 if k.split()[1] != "f32" else 0 for k in KEYS}
    return regs, hmma


def test_build_as_designed_has_no_faults(smoke):
    assert smoke.flash_build_faults(*_as_designed()) == []
    assert smoke.flash_build_faults(_as_designed()[0], None) == []


@pytest.mark.parametrize("fault", ["dq bf16 on cuda cores", "dq f16 on cuda cores",
                                   "fwd bf16 on cuda cores", "f32 on tensor cores", "spill",
                                   "spill without cuobjdump"])
def test_build_faults_are_found(smoke, fault):
    regs, hmma = _as_designed()
    if fault.endswith("on cuda cores"):
        key = fault.split(" on")[0] + " D=64"
        hmma[key] = 0
        want = [f"{key}: 0 HMMA"]
    elif fault == "f32 on tensor cores":
        hmma["dkv f32 D=32"] = 16
        want = ["dkv f32 D=32: 16 HMMA"]
    else:
        regs["dq f16 D=64"] = (255, 24)
        want = ["dq f16 D=64: 24 bytes spill stores"]
        if fault == "spill without cuobjdump":
            hmma = None
    assert smoke.flash_build_faults(regs, hmma) == want
