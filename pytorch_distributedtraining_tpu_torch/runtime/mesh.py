"""The device mesh: named axes over the process group's ranks.

Counterpart of ``pytorch_distributedtraining_tpu/runtime/mesh.py``. A
``MeshSpec`` sizes the axes; :func:`make_mesh` lays the world's ranks out
as a ``torch.distributed.device_mesh.DeviceMesh`` with the axes ``dp``
(data parallel: DDP replicates over it) and ``fsdp`` (the ZeRO axis: state
shards over it). ``MeshSpec.ddp(n)`` puts every rank on ``dp``,
``MeshSpec.zero(n)`` on ``fsdp``, as in JAX.

Only the data axes are ported: ``tp``, ``sp``, ``ep`` and ``pp`` above 1
raise (they wait for the advanced-parallelism slice), and so does a mesh
with both ``dp`` and ``fsdp`` above 1 (the hybrid mesh waits for the
hierarchical-mesh slice). The JAX module's hybrid-mesh helpers
(``make_hybrid_mesh``, ``slice_axis``, ``ici_data_axes``) and its
PartitionSpec helpers (``batch_spec``, ``stacked_batch_spec``) have no
counterpart: a batch here is each rank's own shard, drawn by
``data.DistributedSampler``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from . import dist

AXIS_ORDER = ("pp", "dp", "fsdp", "sp", "tp", "ep")
DATA_AXES = ("dp", "fsdp")


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Axes of size 1 are kept (named, free to resize)."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1
    axis_order: tuple = field(default=AXIS_ORDER)

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp * self.ep * self.pp

    def shape(self) -> dict:
        return {name: getattr(self, name) for name in self.axis_order}

    @staticmethod
    def ddp(n: int | None = None) -> "MeshSpec":
        """All ranks on the data axis: the DDP layout."""
        return MeshSpec(dp=n if n is not None else dist.world_size())

    @staticmethod
    def zero(n: int | None = None) -> "MeshSpec":
        """All ranks on the sharded-DP axis: the OSS/ShardedDDP/FSDP layout."""
        return MeshSpec(fsdp=n if n is not None else dist.world_size())


def make_mesh(spec: MeshSpec | None = None, *, device_type: str | None = None, **axes):
    """A ``DeviceMesh`` over the process group, ``make_mesh(fsdp=4)`` or
    ``make_mesh(MeshSpec.zero())``, with the dims ``("dp", "fsdp")``.
    ``device_type`` defaults to the group's: ``cuda`` under NCCL, ``cpu``
    under gloo. Needs :func:`dist.initialize` first."""
    from torch.distributed.device_mesh import init_device_mesh

    if spec is None:
        spec = MeshSpec(**axes)
    model_axes = {a: n for a, n in spec.shape().items() if a not in DATA_AXES and n > 1}
    if model_axes:
        raise NotImplementedError(
            f"mesh axes {model_axes}: tensor, sequence, expert and pipeline parallelism wait "
            "for the advanced-parallelism slice; the port has the data axes dp and fsdp")
    if spec.dp > 1 and spec.fsdp > 1:
        raise NotImplementedError(
            f"dp={spec.dp} x fsdp={spec.fsdp}: the hybrid mesh waits for the "
            "hierarchical-mesh slice; put every rank on one data axis")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call runtime.dist.initialize() "
                           "first (under torch.distributed.run, or with WORLD_SIZE and "
                           "MASTER_ADDR/MASTER_PORT set)")
    if spec.size != dist.world_size():
        raise ValueError(f"MeshSpec wants {spec.size} ranks ({spec.shape()}), the group has "
                         f"{dist.world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (spec.dp, spec.fsdp), mesh_dim_names=DATA_AXES)


def best_mesh(n: int | None = None, *, zero: bool = False):
    """The default mesh: every rank on one data axis."""
    return make_mesh(MeshSpec.zero(n) if zero else MeshSpec.ddp(n))


def mesh_axis_size(mesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def mesh_shape(mesh) -> dict:
    """``{axis: size}`` of a mesh (JAX's ``dict(mesh.shape)``)."""
    return {name: mesh_axis_size(mesh, name) for name in (mesh.mesh_dim_names or ())}


def data_axes(mesh) -> tuple:
    """Axes a global batch is split over: the sized data axes, else
    ``("dp",)`` as in JAX."""
    axes = tuple(a for a in DATA_AXES if mesh_axis_size(mesh, a) > 1)
    return axes or ("dp",)


def data_group(mesh):
    """The process group of the mesh's data axis: the group gradients are
    reduced over and ZeRO state shards over. At one rank, ``fsdp``'s group
    of one."""
    axes = tuple(a for a in DATA_AXES if mesh_axis_size(mesh, a) > 1)
    return mesh.get_group(axes[0] if axes else "fsdp")


def divisors_check(n: int, by: int, what: str) -> None:
    if n % by:
        raise ValueError(f"{what}={n} not divisible by mesh axis size {by}")


def balanced_factors(n: int) -> tuple:
    """Split n into (a, b), a*b == n and a <= b, as square as possible."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a
