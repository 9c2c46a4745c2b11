"""The port's op-cost plane (``observe/opcost.py``) against the JAX package's
on the same inputs: trace loading (the newest run only, a ``.gz`` sibling,
a missing directory), ``calibrate`` with drift and dropped rows, the
calibration file both ways, ``collective_bandwidth`` on wires of equal
kinds, bytes and group sizes, and ``op_table``'s classes and collective
rows on the same ops in each package's naming (HLO op names on a TPU lane
for JAX, CUDA kernels and copies for the port). Then what is the port's
own: the host-collective table of a gloo trace, the refusal of an empty
capture, ``ingest_trace``, the analyze-plan hook read from the port's
module, the env twins ``GRAFT_OPCOST``/``GRAFT_CAPTURE`` against the JAX
facade's resolution, and the ``observe`` package's exports. Every
comparison is exact unless a test states a tolerance."""

from __future__ import annotations

import gzip
import json
import os
import sys
from types import SimpleNamespace

import pytest
import torch

from pytorch_distributedtraining_tpu.observe import opcost as jop
from pytorch_distributedtraining_tpu.stoke import facade as jfacade
from pytorch_distributedtraining_tpu_torch import observe
from pytorch_distributedtraining_tpu_torch.observe import capture as tcap
from pytorch_distributedtraining_tpu_torch.observe import comms
from pytorch_distributedtraining_tpu_torch.observe import opcost as top

torch.set_num_threads(1)
IMPLS = {"jax": jop, "port": top}


@pytest.fixture(autouse=True)
def _clean_gauges():
    """Both packages' gauges are process-wide: scrub them around each test."""
    for m in IMPLS.values():
        m.reset()
    yield
    for m in IMPLS.values():
        m.reset()


def _op(pid, tid, name, dur_us, **extra):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": 0, "dur": dur_us, **extra}


def _write_trace(trace_dir, events, run="run0", host="host0"):
    """One run's trace in JAX's layout: ``plugins/profile/<run>/<host>.trace.json.gz``."""
    d = os.path.join(trace_dir, "plugins", "profile", run)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{host}.trace.json.gz")
    with gzip.open(path, "wb") as fh:
        fh.write(json.dumps({"traceEvents": events}).encode())
    return path


# -- trace loading ------------------------------------------------------


@pytest.mark.parametrize("case", ["newest_run", "gz_sibling", "two_hosts"])
def test_load_trace_events_matches_jax(tmp_path, case):
    if case == "newest_run":
        _write_trace(str(tmp_path), [_op(2, 7, "old-op", 1.0)], run="r000")
        _write_trace(str(tmp_path), [_op(2, 7, "new-op", 2.0)], run="r001")
    elif case == "gz_sibling":
        d = tmp_path / "plugins" / "profile" / "r0"
        d.mkdir(parents=True)
        doc = json.dumps({"traceEvents": [_op(2, 7, "x", 1.0)]}).encode()
        (d / "h.trace.json").write_bytes(doc)
        with gzip.open(d / "h.trace.json.gz", "wb") as fh:
            fh.write(doc)
    else:
        _write_trace(str(tmp_path), [_op(1, 1, "a", 1.0)], run="r5", host="h0")
        _write_trace(str(tmp_path), [_op(1, 1, "b", 1.0)], run="r5", host="h1")
    got = {k: m.load_trace_events(str(tmp_path)) for k, m in IMPLS.items()}
    assert got["port"] == got["jax"]
    names = {e["name"] for e in got["port"][0]}
    assert names == {"newest_run": {"new-op"}, "gz_sibling": {"x"},
                     "two_hosts": {"a", "b"}}[case]


def test_load_trace_events_missing_dir_raises_in_both(tmp_path):
    for m in IMPLS.values():
        with pytest.raises(FileNotFoundError):
            m.load_trace_events(str(tmp_path / "absent"))


# -- calibration ----------------------------------------------------------

CALIB_MODELS = {
    "wire": {"analytic": 100.0, "measured": 300.0, "unit": "bytes"},
    "mfu_flops": {"analytic": 2.0, "measured": 1.0, "unit": "s"},
    "bubble": {"analytic": 0.25, "measured": 0.3, "unit": "fraction"},
    "zero": {"analytic": 0.0, "measured": 1.0},
    "missing": {"measured": 1.0},
    "negative-measured": {"analytic": 1.0, "measured": -1.0},
}


@pytest.mark.parametrize("previous", [None, {"wire": {"ratio": 2.0}, "bubble": {"ratio": 1.0}}])
def test_calibrate_matches_jax(previous):
    got = {k: m.calibrate(CALIB_MODELS, previous=previous) for k, m in IMPLS.items()}
    assert got["port"] == got["jax"]
    assert list(got["port"]) == ["wire", "mfu_flops", "bubble"]  # the rest are dropped
    assert top.runtime_stats["calibration"] == jop.runtime_stats["calibration"]
    assert top.rolling_gauges == jop.rolling_gauges
    if previous:
        assert got["port"]["wire"]["drift"] == pytest.approx(0.5)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_calibration_file_reads_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "sub" / "calibration.json")
    calib = IMPLS[writer].calibrate({"mfu_flops": {"analytic": 1.0, "measured": 2.0,
                                                   "unit": "s"}})
    IMPLS[writer].write_calibration(path, calib, meta={"metric": "img/s"})
    assert IMPLS[reader].load_calibration(path) == calib
    assert IMPLS[reader].load_calibration(str(tmp_path / "nope.json")) is None
    (tmp_path / "bad.json").write_text("{not json")
    assert IMPLS[reader].load_calibration(str(tmp_path / "bad.json")) is None


class _FakePlan:
    def __init__(self):
        self.reasons = []

    def mark_stale(self, reason):
        self.reasons.append(reason)


def test_drift_marks_the_ports_plan_stale_never_jaxs(monkeypatch):
    """The drift hook looks the plan module up under the port's name: the
    JAX package's plan, loaded in the same process, is never touched."""
    jax_plan, port_plan = _FakePlan(), _FakePlan()
    monkeypatch.setitem(sys.modules, "pytorch_distributedtraining_tpu.analyze.plan", jax_plan)
    top.calibrate({"wire": {"analytic": 1.0, "measured": 3.0}}, previous={"wire": {"ratio": 1.0}})
    assert jax_plan.reasons == []
    monkeypatch.setitem(sys.modules, "pytorch_distributedtraining_tpu_torch.analyze.plan",
                        port_plan)
    top.calibrate({"wire": {"analytic": 1.0, "measured": 3.0}}, previous={"wire": {"ratio": 1.0}})
    assert len(port_plan.reasons) == 1 and "wire:+2.000" in port_plan.reasons[0]
    assert jax_plan.reasons == []


# -- collective bandwidth -------------------------------------------------

# (collective rows, [(kind, elems, JAX replica_groups attribute, group size)],
# mesh axes, steps)
BANDWIDTH_CASES = {
    "axis_join": ([{"op": "all-reduce", "s": 1.0, "events": 2}],
                  [("all-reduce", 1000, "replica_groups={{0,1},{2,3}}", 2)],
                  {"dp": 2, "mp": 1}, 2),
    "single_axis_absorbs": ([{"op": "all-gather", "s": 0.1, "events": 1}],
                            [("all-gather", 500, "no groups", None)], {"fsdp": 8}, 1),
    "unmatched": ([{"op": "all-gather", "s": 0.1, "events": 1}],
                  [("all-gather", 500, "", None)], {"dp": 2, "fsdp": 4}, 1),
    "two_axes_split": ([{"op": "all-reduce", "s": 0.6, "events": 2}],
                       [("all-reduce", 1000, "replica_groups=[4,2]<=[8]", 2),
                        ("all-reduce", 3000, "replica_groups=[2,4]<=[8]", 4)],
                       {"dp": 2, "fsdp": 4}, 1),
    "no_seconds": ([], [("all-reduce", 1000, "replica_groups={{0,1}}", 2)], {"dp": 2}, 1),
}


@pytest.mark.parametrize("case", sorted(BANDWIDTH_CASES))
def test_collective_bandwidth_matches_jax(case):
    rows, wires, axes, steps = BANDWIDTH_CASES[case]
    jwires = [SimpleNamespace(kind=k, dtype="f32", elems=n, line=f"{k}(...) {attr}")
              for k, n, attr, _ in wires]
    twires = [comms.WireCollective(k, "f32", n, "", n, g) for k, n, _, g in wires]
    got_j = jop.collective_bandwidth({"collectives": rows}, jwires, axes, steps=steps)
    got_t = top.collective_bandwidth({"collectives": rows}, twires, axes, steps=steps)
    assert got_t == got_j
    assert top.runtime_stats == jop.runtime_stats
    assert top.rolling_gauges == jop.rolling_gauges


# -- op tables ------------------------------------------------------------

# (JAX HLO op on the device op lane, port device activity, cat, us)
SAME_OPS = [
    ("fusion.1", "void at::native::vectorized_elementwise_kernel<4, AddFunctor<float>>(int)",
     "kernel", 100.0),
    ("fusion.2", "void at::native::vectorized_elementwise_kernel<4, MulFunctor<float>>(int)",
     "kernel", 300.0),
    ("all-reduce.1", "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "kernel", 200.0),
    ("all-gather.2", "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "kernel", 50.0),
    ("reduce-scatter.3", "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(x)", "kernel", 40.0),
    ("copy.3", "Memcpy DtoD (Device -> Device)", "gpu_memcpy", 25.0),
    ("copy-start.4", "void at::native::elementwise_kernel<128, 2, direct_copy_kernel_cuda>(int)",
     "kernel", 5.0),
    ("infeed.1", "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 10.0),
    ("outfeed.2", "Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 7.0),
    ("custom-call.7", "void (anonymous namespace)::window_attn_fwd_kernel<float, 2, 16>(int)",
     "kernel", 60.0),
]


def _jax_events():
    return [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/host:CPU"}},
        {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "name": "thread_name", "pid": 2, "tid": 7, "args": {"name": "XLA Ops"}},
        *[_op(2, 7, name, us) for name, _, _, us in SAME_OPS],
        _op(1, 3, "host-side-op", 999.0),
    ]


def _port_events():
    return [
        *[_op(0, 7, name, us, cat=cat) for _, name, cat, us in SAME_OPS],
        _op(1, 3, "aten::add", 999.0, cat="cpu_op"),
        _op(1, 3, "cudaLaunchKernel", 3.0, cat="cuda_runtime"),
    ]


def test_op_table_classes_and_collective_rows_match_jax():
    j, t = jop.op_table(_jax_events()), top.op_table(_port_events())
    assert t["total_s"] == j["total_s"]
    assert t["classes"] == j["classes"]
    assert t["collectives"] == j["collectives"]
    # the op rows hold the same classes and times; the names are each package's
    assert sorted((r["class"], r["s"], r["share"]) for r in t["ops"]) == sorted(
        (r["class"], r["s"], r["share"]) for r in j["ops"])
    assert top.runtime_stats["tables_built"] == jop.runtime_stats["tables_built"] == 1


def test_op_table_groups_template_instantiations_and_counts_events():
    t = top.op_table(_port_events())
    rows = {r["op"]: r for r in t["ops"]}
    ew = rows["at::native::vectorized_elementwise_kernel"]
    assert ew["events"] == 2 and ew["s"] == pytest.approx(400e-6) and ew["class"] == "compute"
    assert rows["window_attn_fwd_kernel"]["events"] == 1
    assert rows["ncclDevKernel_AllReduce_Sum_f32_RING_LL"]["class"] == "collective"
    assert {r["op"]: r["events"] for r in t["collectives"]} == {
        "all-reduce": 1, "all-gather": 1, "reduce-scatter": 1}


@pytest.mark.parametrize("name,cls", [
    ("ncclDevKernel_SendRecv(x)", "collective"),
    ("Memcpy HtoD (Pinned -> Device)", "host-transfer"),
    ("Memcpy DtoH (Device -> Pageable)", "host-transfer"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("Memcpy PtoP (Device -> Device)", "copy"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>(x)", "copy"),
    ("Memset (Device)", "compute"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x16", "compute"),
    ("c10d::allreduce_", "collective"),
])
def test_op_class(name, cls):
    assert top.op_class(top.kernel_base(name)) == cls


def _gloo_events():
    """A gloo rank's trace: host ops only, no CUDA (shapes recorded)."""
    return [
        _op(1, 1, "c10d::allreduce_", 30.0, cat="cpu_op",
            args={"Input Dims": [[[1000]], [], [], [], [], []],
                  "Input type": ["TensorList", "", "", "", "Scalar", "Scalar"]}),
        _op(1, 1, "c10d::_reduce_scatter_base_", 20.0, cat="cpu_op",
            args={"Input Dims": [[500], [1000], [], [], [], []],
                  "Input type": ["float", "float", "", "", "Scalar", "Scalar"]}),
        _op(1, 1, "gloo:all_reduce", 29.0, cat="user_annotation"),
        _op(1, 1, "aten::mm", 500.0, cat="cpu_op"),
        _op(1, 1, "c10d::barrier", 5.0, cat="cpu_op"),
    ]


def test_op_table_of_a_gloo_trace_is_its_host_collectives():
    t = top.op_table(_gloo_events())
    assert t["classes"]["compute"] == {"seconds": 0.0, "events": 0}
    assert t["classes"]["collective"] == {"seconds": 50e-6, "events": 2}
    assert {r["op"]: r["events"] for r in t["collectives"]} == {"all-reduce": 1,
                                                                "reduce-scatter": 1}


def test_an_empty_capture_on_the_card_raises():
    """CUDA was traced (runtime calls) but CUPTI recorded no device work: an
    error, never a host-only table; ``require_device`` says so too."""
    with pytest.raises(RuntimeError, match="no device activity"):
        top.op_table([_op(1, 1, "cudaLaunchKernel", 3.0, cat="cuda_runtime")])
    with pytest.raises(RuntimeError, match="no device activity"):
        top.op_table(_gloo_events(), require_device=True)
    assert top.runtime_stats["tables_built"] == 0


def test_ingest_trace(tmp_path):
    events = _port_events() + [
        _op(1, 1, "record_param_comms", 1.0, cat="cpu_op",
            args={"Collective name": "allreduce", "dtype": "Float", "In msg nelems": 1000,
                  "Out msg nelems": 1000, "Group size": 2}),
    ]
    _write_trace(str(tmp_path), events)
    got = top.ingest_trace(str(tmp_path), mesh_axes={"dp": 2}, steps=3, device="cuda")
    assert got["steps"] == 3 and got["table"]["total_s"] > 0
    assert [(w.kind, w.dtype, w.elems, w.group_size) for w in got["wires"]] == [
        ("all-reduce", "f32", 1000, 2)]
    # 4000 bytes over the all-reduce row's 200 us
    assert got["bandwidth"]["dp"]["bytes_per_s"] == pytest.approx(4000 / 200e-6)
    assert top.runtime_stats["axis_bandwidth"]["dp"] == pytest.approx(4000 / 200e-6)
    assert top.ingest_trace(str(tmp_path / "empty")) is None
    no_mesh = top.ingest_trace(str(tmp_path))
    assert no_mesh["bandwidth"] is None


def test_one_rank_bandwidth_is_not_measured():
    """At one rank NCCL runs no kernel: the bytes are there, the seconds are
    0, so the rate is None (not measured), never 0 B/s."""
    wires = [comms.WireCollective("all-reduce", "f32", 1000, "", 1000, 1)]
    out = top.collective_bandwidth({"collectives": []}, wires, {"dp": 1, "fsdp": 1})
    assert out == {"?": {"bytes": 4000, "seconds": 0.0, "bytes_per_s": None}}
    assert top.runtime_stats["axis_bandwidth"] == {}


# -- env twins and the package ---------------------------------------------


@pytest.mark.parametrize("env", [None, "", "1", "0", "off", "yes", "no", "anything"])
@pytest.mark.parametrize("arg", [False, True])
def test_opcost_env_twin_matches_jax_facade(monkeypatch, env, arg):
    if env is None:
        monkeypatch.delenv("GRAFT_OPCOST", raising=False)
    else:
        monkeypatch.setenv("GRAFT_OPCOST", env)
    assert top.opcost_from_env(arg) == jfacade._opcost_from_env(SimpleNamespace(opcost=arg))


@pytest.mark.parametrize("env", [None, "", "1", "true", "0", "off", "/cap/dir"])
@pytest.mark.parametrize("arg,arg_dir", [(False, None), (True, "/cfg")])
def test_capture_env_twin_matches_jax_facade(monkeypatch, env, arg, arg_dir):
    if env is None:
        monkeypatch.delenv("GRAFT_CAPTURE", raising=False)
    else:
        monkeypatch.setenv("GRAFT_CAPTURE", env)
    want = jfacade._capture_from_env(SimpleNamespace(capture=arg, capture_dir=arg_dir))
    assert tcap.capture_from_env(arg, arg_dir) == want


def test_observe_package_exports():
    from pytorch_distributedtraining_tpu_torch.observe import profiling

    assert observe.OnDemandProfiler is tcap.OnDemandProfiler
    assert observe.calibrate is top.calibrate
    assert observe.load_trace_events is top.load_trace_events
    assert observe.op_table is top.op_table
    assert observe.collective_bandwidth is top.collective_bandwidth
    assert observe.profiler_trace is profiling.trace
    assert observe.StepTimer is profiling.StepTimer
    assert observe.TransferOverlapProbe is profiling.TransferOverlapProbe
    assert observe.comms is comms and observe.opcost is top and observe.capture is tcap
