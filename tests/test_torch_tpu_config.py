"""``stoke.TPUConfig``, the twin of the JAX package's, and how the facade
resolves it: field for field JAX's dataclass; the fields with a meaning on
the card resolved against their ``GRAFT_*`` env twins with JAX's
precedence (held case by case against the JAX facade's own resolvers);
each field that waits for another slice raising with that slice's name;
the facade's keyword arguments still working; ``dp`` and ``fsdp`` as the
mesh's widths over two gloo ranks.
"""

import dataclasses

import pytest
import torch

from pytorch_distributedtraining_tpu.stoke import config as jconfig
from pytorch_distributedtraining_tpu.stoke import facade as jfacade
from pytorch_distributedtraining_tpu_torch import stoke as tstoke
from pytorch_distributedtraining_tpu_torch.stoke import facade as tfacade
from test_torch_dist_workers import run_ranks, toy_swinir, tpu_config_mesh_worker

torch.set_num_threads(1)

ENV = ("GRAFT_TELEMETRY", "GRAFT_TRACE", "GRAFT_NUMERICS", "GRAFT_NUMERICS_ACTION",
       "GRAFT_OPCOST", "GRAFT_CAPTURE", "GRAFT_REMAT", "GRAFT_SERVE_SPEC_K", "GRAFT_SERVE_KV_WIRE")


@pytest.fixture
def clean_env(monkeypatch):
    for var in ENV:  # set then delete: the teardown removes what a case set
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)
    return monkeypatch


def _stoke(*configs, **kw):
    return tstoke.Stoke(model=toy_swinir(), optimizer=tstoke.StokeOptimizer("AdamW", {"lr": 1e-3}),
                        loss=lambda o, t: ((o - t) ** 2).mean(), batch_size_per_device=2,
                        configs=list(configs), device="cpu", **kw)


def test_fields_and_defaults_are_jaxs():
    got = [(f.name, f.default) for f in dataclasses.fields(tstoke.TPUConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(jconfig.TPUConfig)]
    assert got == want


CASES = [  # (TPUConfig fields, env)
    ({}, {}),
    (dict(telemetry=True, trace_dir="/tmp/t"), {}),
    (dict(telemetry=True), {"GRAFT_TELEMETRY": "0"}),
    ({}, {"GRAFT_TRACE": "/tmp/x.json"}),
    (dict(trace_dir="/tmp/a"), {"GRAFT_TRACE": "/tmp/b"}),
    (dict(numerics=True, numerics_action="rollback"), {}),
    (dict(numerics=True), {"GRAFT_NUMERICS": "off", "GRAFT_NUMERICS_ACTION": "degrade"}),
    ({}, {"GRAFT_NUMERICS": "1"}),
    (dict(opcost=True), {}),
    (dict(opcost=True), {"GRAFT_OPCOST": "no"}),
    (dict(capture=True, capture_dir="/tmp/c"), {}),
    ({}, {"GRAFT_CAPTURE": "/tmp/d"}),
    (dict(capture=True), {"GRAFT_CAPTURE": "false"}),
    (dict(remat="dots"), {"GRAFT_REMAT": "full"}),
    ({}, {"GRAFT_REMAT": "full"}),
    (dict(remat=True), {}),
]


@pytest.mark.parametrize("fields,env", CASES, ids=[str(i) for i in range(len(CASES))])
def test_env_twins_resolve_as_jaxs(clean_env, fields, env):
    for var, value in env.items():
        clean_env.setenv(var, value)
    jcfg = jconfig.TPUConfig(**fields)
    s = _stoke(tstoke.TPUConfig(**fields))
    assert (s.telemetry, s.trace_dir) == jfacade._telemetry_from_env(jcfg)
    numerics_on, action = jfacade._numerics_from_env(jcfg)
    assert (s.numerics_probe is not None) == numerics_on
    if numerics_on:
        assert s.numerics_watchdog.action == action
    assert s.opcost == jfacade._opcost_from_env(jcfg)
    capture_on, capture_dir = jfacade._capture_from_env(jcfg)
    assert (s.capture is not None) == capture_on
    if capture_on:
        assert s.capture.trace_dir == capture_dir or capture_dir is None
    assert s.policy.remat == jfacade._remat_from_env(jcfg.remat)
    if s.telemetry:
        from pytorch_distributedtraining_tpu_torch.observe import trace

        trace.disable()


SERVE = [({}, {}, {}), (dict(serve_spec_k=4), {}, {}), (dict(serve_spec_k=4), {"spec_k": 2}, {}),
         (dict(serve_spec_k=4), {}, {"GRAFT_SERVE_SPEC_K": "3"}), ({}, {"spec_k": 2}, {})]


@pytest.mark.parametrize("fields,overrides,env", SERVE, ids=[str(i) for i in range(len(SERVE))])
def test_serve_overrides_resolve_as_jaxs(clean_env, fields, overrides, env):
    for var, value in env.items():
        clean_env.setenv(var, value)
    got = tfacade._serve_fastpath_overrides(tstoke.TPUConfig(**fields), overrides)
    assert got == jfacade._serve_fastpath_overrides(jconfig.TPUConfig(**fields), overrides)


DEFERRED = [("tp", 2, "advanced-parallelism"), ("sp", 2, "advanced-parallelism"),
            ("pp", 2, "advanced-parallelism"), ("pp_schedule", "gpipe", "advanced-parallelism"),
            ("pp_micro", 4, "advanced-parallelism"), ("wire", "int8", "advanced-parallelism"),
            ("fp8", "e4m3", "fp8 matmul"), ("hier", True, "hierarchical-mesh"),
            ("serve_kv_wire", "int8_block", "quantized-KV"), ("plan", "plan.json", "analyze")]


@pytest.mark.parametrize("field,value,subject", DEFERRED, ids=[d[0] for d in DEFERRED])
def test_a_deferred_field_raises_naming_its_slice(field, value, subject):
    with pytest.raises(NotImplementedError, match=f"the {subject} slice"):
        _stoke(tstoke.TPUConfig(**{field: value}))


def test_dp_and_fsdp_both_above_one_wait_for_the_hierarchical_mesh():
    with pytest.raises(NotImplementedError, match="hierarchical-mesh slice"):
        tstoke.TPUConfig(dp=2, fsdp=2).check()


def test_keywords_keep_working_and_beat_the_config(clean_env):
    s = _stoke(opcost=True, numerics=True, numerics_action="rollback")
    assert s.opcost and s.numerics_watchdog.action == "rollback"
    s = _stoke(tstoke.TPUConfig(numerics=True, numerics_action="degrade"),
               numerics_action="rollback")
    assert s.numerics_watchdog.action == "rollback"
    s = _stoke(tstoke.TPUConfig(donate_state=False))
    assert s.tpu_config.donate_state is False  # recorded: the state updates in place anyway


def test_widths_must_match_the_run(clean_env):
    assert _stoke(tstoke.TPUConfig(dp=1)).mesh is None
    with pytest.raises(ValueError, match="spans 2 ranks"):
        _stoke(tstoke.TPUConfig(fsdp=2))


def test_dp_and_fsdp_set_the_mesh_over_two_ranks():
    got = run_ranks(tpu_config_mesh_worker, 2, cases=[
        dict(config=dict(dp=2)), dict(config=dict(fsdp=2), flags=dict(fairscale_oss=True)),
        dict(config={}, flags=dict(fairscale_oss=True))])
    assert got[0] == got[1] == [{"dp": 2}, {"fsdp": 2}, {"fsdp": 2}]
