"""The port's sharding rules, policies, remat and runtime refusals against
the JAX package's, in one process.

``leaf_spec`` and ``tree_specs`` answer case for case as JAX's do at axis
sizes 2, 4 and 8 (JAX's ``P(..., axis, ...)`` is the port's dimension,
``P()`` its None); at size 1 the port picks the dimension the rule picks
when every size divides, where JAX answers ``P()``. ``policy_from_flags``
builds the same dataclass with the same fields for every flag
combination, and ``resolve_remat`` canonicalises and refuses the same
spellings. ``apply_remat``'s ``"full"``, ``"dots"`` and ``"offload"``
give the gradients of no remat on the toy SwinIR (the same arithmetic,
recomputed: held bitwise), and ``"full"`` does recompute.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pytorch_distributedtraining_tpu.parallel import policy as jpolicy
from pytorch_distributedtraining_tpu.parallel import remat as jremat
from pytorch_distributedtraining_tpu.parallel import spec as jspec
from pytorch_distributedtraining_tpu.runtime import mesh as jmesh
from pytorch_distributedtraining_tpu_torch.parallel import policy as tpolicy
from pytorch_distributedtraining_tpu_torch.parallel import remat as tremat
from pytorch_distributedtraining_tpu_torch.parallel import spec as tspec
from pytorch_distributedtraining_tpu_torch.runtime import dist
from pytorch_distributedtraining_tpu_torch.runtime import mesh as tmesh
from test_torch_dist_workers import toy_swinir

SHAPES = [(), (7,), (1023,), (1024,), (4096,), (12, 96), (96, 12), (36, 12), (64, 64),
          (3, 3, 60, 60), (60, 60, 3, 3), (18, 18, 3, 3), (12, 18, 3, 3), (1, 4096),
          (4096, 1), (6, 6, 6, 6), (5, 7, 31), (50257, 768), (768, 2304), (0, 4096),
          (2, 2, 2, 2, 2, 2, 2, 2, 2, 2)]


def _jax_dim(p) -> int | None:
    """JAX's PartitionSpec as the port's answer: the sharded dim or None."""
    dims = [i for i, a in enumerate(tuple(p)) if a is not None]
    return dims[0] if dims else None


@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("min_size", [1, 1024])
def test_leaf_spec_matches_jax(size, min_size):
    for shape in SHAPES:
        want = _jax_dim(jspec.leaf_spec(shape, "fsdp", size, min_size))
        assert tspec.leaf_spec(shape, "fsdp", size, min_size) == want, shape


@pytest.mark.parametrize("size", [2, 4, 8])
def test_tree_specs_matches_jax(size):
    tree = {f"leaf{i}": jax.ShapeDtypeStruct(s, np.float32) for i, s in enumerate(SHAPES)}
    want = jspec.tree_specs(tree, "fsdp", size)
    got = tspec.tree_specs({k: v.shape for k, v in tree.items()}, "fsdp", size)
    assert got == {k: _jax_dim(p) for k, p in want.items()}


def test_leaf_spec_at_one_rank_picks_the_largest_dimension():
    for shape in SHAPES:
        numel = int(np.prod(shape, dtype=np.int64))
        assert jspec.leaf_spec(shape, "fsdp", 1) == jax.sharding.PartitionSpec()
        got = tspec.leaf_spec(shape, "fsdp", 1)
        sized = [i for i, d in enumerate(shape) if d > 0]
        if numel < 1024 or not sized:
            assert got is None, shape
        else:
            assert got == max(sized, key=lambda i: shape[i]), shape
            assert shape[got] == max(shape)


def test_shard_and_gather_layout_round_trips():
    t = torch.arange(2 * 6 * 4, dtype=torch.float32).reshape(2, 6, 4)
    shards = [tspec.shard(t, 1, r, 3) for r in range(3)]
    assert [tuple(s.shape) for s in shards] == [(2, 2, 4)] * 3
    assert torch.equal(torch.cat(shards, 1), t)
    rows = torch.stack([s.reshape(-1) for s in shards])
    assert torch.equal(tspec._rank_major(t, 1, 3), rows)
    assert torch.equal(tspec._from_rank_major(rows, 1, t.shape), t)


FLAGS = [(oss, sddp, fsdp) for oss in (False, True) for sddp in (False, True)
         for fsdp in (False, True)]


@pytest.mark.parametrize("distributed", [None, "ddp"])
@pytest.mark.parametrize("oss,sddp,fsdp", FLAGS)
def test_policy_from_flags_matches_jax(distributed, oss, sddp, fsdp):
    kw = dict(distributed=distributed, fairscale_oss=oss, fairscale_sddp=sddp,
              fairscale_fsdp=fsdp, remat="dots")
    got, want = tpolicy.policy_from_flags(**kw), jpolicy.policy_from_flags(**kw)
    assert type(got).__name__ == type(want).__name__ == got.name
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.remat_policy == want.remat_policy == "dots"


def test_policies_and_aliases_match_jax():
    for name in ("Policy", "DDP", "ZeRO1", "ZeRO2", "ZeRO3", "OSS", "ShardedDDP", "FSDP"):
        got, want = getattr(tpolicy, name)(), getattr(jpolicy, name)()
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert dataclasses.is_dataclass(got) and type(got).__dataclass_params__.frozen
    assert tpolicy.OSS is tpolicy.ZeRO1 and tpolicy.FSDP is tpolicy.ZeRO3
    # the offload flags build as JAX's do
    for name, kw in (("ZeRO3", dict(offload_opt_state=True)), ("Policy", dict(offload_params=True)),
                     ("ZeRO1", dict(offload_opt_state=True, offload_params=True))):
        got, want = getattr(tpolicy, name)(**kw), getattr(jpolicy, name)(**kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("remat", [None, False, True, "none", "FULL", " dots ", "names",
                                   "offload", "1", "on", "off", "", "bogus", "remat"])
def test_resolve_remat_matches_jax(remat):
    try:
        want = jremat.resolve_remat(remat)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tremat.resolve_remat(remat)
        assert str(got.value) == str(e)
    else:
        assert tremat.resolve_remat(remat) == want


def _grads(remat):
    model = toy_swinir()
    calls = []
    for layer in model.modules():
        if type(layer).__name__ == "SwinLayer":
            layer.register_forward_hook(lambda *a: calls.append(1))
    g = torch.Generator().manual_seed(1)
    x, y = torch.rand(2, 8, 8, 3, generator=g), torch.rand(2, 16, 16, 3, generator=g)

    def loss_fn(m, batch):
        return torch.mean((m(batch[0]) - batch[1]) ** 2), {}

    loss, _ = tremat.apply_remat(loss_fn, remat)(model, (x, y))
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}, len(calls)


def test_remat_gives_the_gradients_of_no_remat():
    want, forwards = _grads("none")
    assert forwards == 4
    # every policy runs each Swin layer's forward again in backward (names
    # and offload serve the tagged attention outputs from their saved copies)
    for remat, n_forwards in (("full", 8), ("dots", 8), ("names", 8), ("offload", 8)):
        got, n = _grads(remat)
        assert n == n_forwards, remat
        for name in want:
            torch.testing.assert_close(got[name], want[name], rtol=0, atol=0,
                                       msg=f"{remat} {name}")


def test_mesh_spec_and_helpers_match_jax():
    for spec in (tmesh.MeshSpec.ddp(4), tmesh.MeshSpec.zero(8), tmesh.MeshSpec(dp=2, tp=2)):
        want = jmesh.MeshSpec(**{k: getattr(spec, k) for k in ("dp", "fsdp", "tp", "sp", "ep",
                                                                "pp")})
        assert spec.shape() == want.shape() and spec.size == want.size
    for n in (1, 6, 7, 12, 64):
        assert tmesh.balanced_factors(n) == jmesh.balanced_factors(n)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.divisors_check(10, 4, "batch")


def test_mesh_and_group_refusals(monkeypatch):
    for axes in (dict(tp=2), dict(pp=2), dict(sp=2), dict(ep=2)):
        with pytest.raises(NotImplementedError, match="advanced-parallelism slice"):
            tmesh.make_mesh(**axes)
    with pytest.raises(NotImplementedError, match="hierarchical-mesh slice"):
        tmesh.make_mesh(dp=2, fsdp=2)
    with pytest.raises(RuntimeError, match="initialize"):
        tmesh.make_mesh(fsdp=1)
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    dist.initialize(device="cpu")  # no env: one process, no group
    assert not dist.is_initialized() and dist.world_size() == 1 and dist.rank() == 0
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(dist.find_free_port()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.initialize()  # cuda asked for, none here: fatal, never gloo
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="out of range"):
        dist.initialize(num_processes=2, process_id=2, device="cpu")
    assert 0 < dist.find_free_port() < 65536
