"""The collective inventory of a traced step (``observe/comms.py``, the
counterpart of JAX's ``observe/hlo.py``) and ``TrainStep.comm_cost``.

On synthetic traces: the kinds of NCCL kernels, ``record_param_comms``
names and host ``c10d::`` ops, the records read from each, the audits
(``counts``, ``max_all_reduce_elems``, ``has_logical_reduce_scatter``,
``hop_bytes``) and the measured overlap audit. Then two gloo ranks, in the
manner of ``tests/test_torch_dist_step.py``: for one ``TrainStep`` of the
toy SwinIR under each of DDP, ZeRO-1, ZeRO-2 and ZeRO-3, the inventory of
``trace_comms`` holds the kinds JAX's ``tests/test_hlo_collectives.py``
asserts for that policy (DDP all-reduce only; ZeRO-1 all-reduce and
all-gather; ZeRO-2 a reduce-scatter and all-gather; ZeRO-3 more
all-gathers than ZeRO-2); its reduction bytes under the hop convention
equal ``comm_cost``'s (the loss's and the norm's one-element all-reduces
apart, which ``comm_cost`` does not count; under ZeRO-3, FSDP2's own
layout, see the test), and ``comm_cost`` equals JAX's on the same model at
a data axis of 2. The same launch arms the facade's capture
(``GRAFT_CAPTURE``/``GRAFT_OPCOST``): it fires once on an injected NaN and
lands an ingested table. Byte counts are exact."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import optax
import pytest

from pytorch_distributedtraining_tpu import parallel as jparallel
from pytorch_distributedtraining_tpu.models.swinir import SwinIR as JaxSwinIR
from pytorch_distributedtraining_tpu.runtime.mesh import MeshSpec, make_mesh
from pytorch_distributedtraining_tpu_torch.observe import comms
from test_torch_dist_workers import TOY, comms_worker, run_ranks, sr_batches

POLICIES = ("ddp", "zero1", "zero2", "zero3")
JAX_POLICIES = {"ddp": jparallel.DDP, "zero1": jparallel.ZeRO1, "zero2": jparallel.ZeRO2,
                "zero3": jparallel.ZeRO3}


def _ev(name, cat="cpu_op", ts=0.0, dur=1.0, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def _nccl(coll, dtype, n_in, n_out, group):
    return _ev("record_param_comms", **{"Collective name": coll, "dtype": dtype,
                                        "In msg nelems": n_in, "Out msg nelems": n_out,
                                        "Group size": group})


@pytest.mark.parametrize("name,kind", [
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "all-reduce"),
    ("ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL(x)", "reduce-scatter"),
    ("ncclDevKernel_AllGather_RING_LL(x)", "all-gather"),
    ("ncclDevKernel_SendRecv(x)", "collective-permute"),
    ("ncclDevKernel_Broadcast_RING_LL(x)", "collective-broadcast"),
    ("_allgather_base", "all-gather"),
    ("allgather_into_tensor_coalesced", "all-gather"),
    ("_reduce_scatter_base", "reduce-scatter"),
    ("all_to_all", "all-to-all"),
    ("c10d::allreduce_", "all-reduce"),
    ("c10d::alltoall_base_", "all-to-all"),
    ("c10d::recv_", "collective-permute"),
    ("c10d::barrier", None),
    ("void at::native::reduce_kernel<512, 1>(x)", None),
])
def test_collective_kind(name, kind):
    assert comms.collective_kind(name) == kind


def test_record_param_comms_win_over_host_ops():
    events = [
        _ev("c10d::allreduce_", **{"Input Dims": [[[8]]], "Input type": ["TensorList"]}),
        _nccl("allreduce", "Float", 1000, 1000, 4),
        _nccl("_allgather_base", "BFloat16", 250, 1000, 4),
        _nccl("_reduce_scatter_base", "Half", 1000, 250, 4),
        _nccl("barrier", "Float", 1, 1, 4),
    ]
    wires = comms.wire_inventory(events)
    assert [(w.kind, w.dtype, w.elems, w.in_elems, w.group_size) for w in wires] == [
        ("all-reduce", "f32", 1000, 1000, 4), ("all-gather", "bf16", 1000, 250, 4),
        ("reduce-scatter", "f16", 250, 1000, 4)]
    assert comms.counts(events) == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 1}
    assert comms.max_all_reduce_elems(events) == 1000
    assert comms.has_logical_reduce_scatter(events) and comms.has_logical_reduce_scatter(events, 250)
    assert not comms.has_logical_reduce_scatter(events, 251)
    # all-reduce 2 x 4000 B, reduce-scatter 1 x 2000 B in; the gather is no grad hop
    assert comms.hop_bytes(wires) == 2 * 4000 + 2000


def test_host_ops_when_no_record_param_comms():
    """Gloo's path: the op's recorded input shapes, the group size from an
    all-gather's or reduce-scatter's ratio and the caller's for an all-reduce."""
    events = [
        _ev("c10d::allreduce_", **{"Input Dims": [[[1000], [24]], [], []],
                                   "Input type": ["TensorList", "", ""]}),
        _ev("c10d::_allgather_base_", **{"Input Dims": [[2000], [1000], []],
                                         "Input type": ["float", "float", ""]}),
        _ev("c10d::_reduce_scatter_base_", **{"Input Dims": [[500], [1000], []],
                                              "Input type": ["c10::BFloat16", "", ""]}),
        _ev("c10d::allreduce_", **{"Input Dims": [[[]]], "Input type": ["TensorList"]}),
        _ev("gloo:all_reduce", cat="user_annotation"),
        _ev("c10d::barrier", **{"Input Dims": [[]], "Input type": [""]}),
    ]
    wires = comms.wire_inventory(events, group_size=2)
    assert [(w.kind, w.dtype, w.elems, w.in_elems, w.group_size) for w in wires] == [
        ("all-reduce", "", 1024, 1024, 2), ("all-gather", "f32", 2000, 1000, 2),
        ("reduce-scatter", "bf16", 500, 1000, 2), ("all-reduce", "", 1, 1, 2)]
    assert [op.max_elems for op in comms.collective_inventory(events)] == [1024, 2000, 500, 1]


def test_overlap_audit_measures_compute_beside_nccl():
    events = [
        _ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", "kernel", 100.0, 50.0, stream=20),
        _ev("ncclDevKernel_AllGather_RING_LL(x)", "kernel", 300.0, 40.0, stream=20),
        _ev("gemm_a", "kernel", 90.0, 30.0, stream=7),   # covers 100..120
        _ev("gemm_b", "kernel", 110.0, 20.0, stream=7),  # 120..130 more
        _ev("on_nccl_stream", "kernel", 140.0, 5.0, stream=20),  # same stream: no overlap
    ]
    audit = comms.overlap_audit(events)
    ar, ag = audit.findings
    assert (ar.kind, ar.overlapped_us, ar.share) == ("all-reduce", 30.0, 0.6)
    assert (ag.kind, ag.overlapped_us, ag.schedulable) == ("all-gather", 0.0, False)
    assert audit.blocking == (ag,) and not audit.ok and audit.total == 2
    assert not comms.collectives_schedulable(events)
    assert comms.collectives_schedulable(events[2:4])  # no collective: vacuously True


# -- two gloo ranks -----------------------------------------------------------------


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every policy's traced step and the facade's capture, from one launch
    of two ranks."""
    root = tmp_path_factory.mktemp("caps")
    ranks = run_ranks(comms_worker, 2, batch=sr_batches(1, n=4)[0], policies=list(POLICIES),
                      capture_dir=str(root), inject="conv_first.weight@1")
    return ranks, root


def _wires(rank: dict, policy: str) -> list:
    return [comms.WireCollective(k, d, n, "", i, g) for k, d, n, i, g in rank[policy]["wires"]]


@pytest.mark.parametrize("policy", POLICIES)
def test_each_policy_runs_the_collectives_jax_audits(world2, policy):
    ranks, _ = world2
    c = {}
    for w in _wires(ranks[0], policy):
        c[w.kind] = c.get(w.kind, 0) + 1
    largest = max(math.prod(s) for s in ranks[0][policy]["shapes"].values())  # one leaf
    ar = max((w.elems for w in _wires(ranks[0], policy) if w.kind == "all-reduce"), default=0)
    if policy == "ddp":
        assert ar >= largest and "all-gather" not in c and "reduce-scatter" not in c, c
    elif policy == "zero1":
        assert ar >= largest and c.get("all-gather", 0) >= 1 and "reduce-scatter" not in c, c
    elif policy == "zero2":
        assert c.get("reduce-scatter", 0) >= 1 and c.get("all-gather", 0) >= 1, c
    else:
        zero2 = sum(1 for w in _wires(ranks[0], "zero2") if w.kind == "all-gather")
        assert c.get("reduce-scatter", 0) >= 1 and c.get("all-gather", 0) > zero2, c
    assert all(w.group_size == 2 for w in _wires(ranks[0], policy))
    assert ranks[1][policy]["wires"] == ranks[0][policy]["wires"]


def _fsdp2_bytes(shapes: dict, world: int) -> int:
    """FSDP2's reduce-scatter input: every leaf once, its first dimension
    padded to a multiple of the world, in f32."""
    total = 0
    for s in shapes.values():
        rows = -(-s[0] // world) * world
        n = rows
        for d in s[1:]:
            n *= d
        total += 4 * n
    return total


@pytest.mark.parametrize("policy", POLICIES)
def test_reduction_bytes_equal_comm_cost(world2, policy):
    """The traced reductions under the hop convention against the analytic
    count; the one-element all-reduces (the loss's mean, the sharded norm's
    sum of squares) are not a gradient hop. ZeRO-3 runs on FSDP2, which
    reduce-scatters every leaf (small ones too, where JAX's layout keeps
    them whole at the all-reduce rate) padded along its first dimension."""
    ranks, _ = world2
    grads = [w for w in _wires(ranks[0], policy) if w.elems > 1]
    cost = ranks[0][policy]["comm_cost"]
    assert cost["axis_size"] == 2
    if policy == "zero3":
        assert comms.hop_bytes(grads) == _fsdp2_bytes(ranks[0][policy]["shapes"], 2)
        assert comms.hop_bytes(grads) < cost["wire_bytes"]
    else:
        assert comms.hop_bytes(grads) == cost["wire_bytes"]


@pytest.mark.parametrize("policy", ["ddp", "zero2", "zero3"])
def test_comm_cost_equals_jax(world2, policy):
    ranks, _ = world2
    pol = JAX_POLICIES[policy]()
    spec = MeshSpec.ddp(2) if policy == "ddp" else MeshSpec.zero(2)
    mesh = make_mesh(spec, devices=jax.devices()[:2])
    params = JaxSwinIR(**TOY).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]
    step = jparallel.TrainStep(lambda p, b, r, s: (0.0, {}), optax.sgd(1e-3), mesh, pol)
    want = step.comm_cost(params)
    got = ranks[0][policy]["comm_cost"]
    assert {k: got[k] for k in ("collective", "fp32_bytes", "wire_bytes", "axis_size")} == {
        k: want[k] for k in ("collective", "fp32_bytes", "wire_bytes", "axis_size")}


def test_facade_capture_fires_once_and_lands_a_table(world2):
    ranks, root = world2
    for r, rank in enumerate(ranks):
        f = rank["facade"]
        assert f["summary"]["captures"] == 1
        assert f["summary"]["last_trigger"]["source"] == "numerics"
        assert f["summary"]["capture_dirs"] == [str(root / f"rank{r}" / "capture-0-numerics")]
        assert f["tables_built"] == 1
        # three optimizer steps, one flat all-reduce each (FusedAdamW under DDP)
        assert f["table"]["collectives"][0]["op"] == "all-reduce"
        assert f["table"]["collectives"][0]["events"] == 3
        assert [k for k, _ in f["wires"]] == ["all-reduce"] * 3
        assert set(f["bandwidth"]) == {"dp"} and f["bandwidth"]["dp"]["bytes"] == sum(
            4 * n for _, n in f["wires"])
