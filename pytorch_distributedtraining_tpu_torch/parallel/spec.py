"""Per-leaf sharding rules and the collectives that move shards.

Counterpart of ``pytorch_distributedtraining_tpu/parallel/spec.py``. A
leaf shards *within* itself along one dimension, the same on every rank,
so a checkpoint gathered from any world size has the same layout:
:func:`leaf_spec` picks the largest dimension the axis size divides, for
leaves of at least ``min_size`` elements; smaller leaves stay whole on
every rank. JAX answers ``P()`` at an axis of size 1; the port picks the
dimension the rule picks when every size divides (1 divides all), so a
run on one GPU goes through the same sharded code and collectives as a
run on many, with the same numbers.

:class:`ShardPlan` is a rank's share of a parameter list: ZeRO-1/2 views
of each leaf's shard along its :func:`leaf_spec` dimension, or, under
FSDP2 (ZeRO-3), each ``DTensor``'s own local shard. A shard along a
dimension other than the first is a strided view; the collectives pack
shards rank-major into one contiguous buffer, so each step issues one
all-gather, one reduce-scatter or one all-reduce for the whole list.

Host offload (``host_offload_supported``, ``stream_to_device``,
``tree_shardings``) waits for the offload slice; the policies' offload
flags raise until then.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist


def shard_axis(mesh) -> str | None:
    """The mesh axis ZeRO state shards over: "fsdp" if sized, else "dp",
    None at one rank (or without a mesh), as in JAX."""
    if mesh is None:
        return None
    from ..runtime.mesh import mesh_axis_size

    for axis in ("fsdp", "dp"):
        if mesh_axis_size(mesh, axis) > 1:
            return axis
    return None


def leaf_spec(shape, axis_name: str | None, axis_size: int, min_size: int = 1024) -> int | None:
    """The dimension of ``shape`` to shard over an axis of ``axis_size``:
    the largest one it divides (the first of equals), or None for a leaf
    below ``min_size`` elements or with no such dimension. ``axis_name``
    is carried for parity with JAX's signature; the dimension alone
    decides the layout here."""
    shape = tuple(int(d) for d in shape)
    numel = 1
    for d in shape:
        numel *= d
    if numel < min_size:
        return None
    divisible = [i for i, d in enumerate(shape) if d > 0 and d % axis_size == 0]
    if not divisible:
        return None
    return max(divisible, key=lambda i: shape[i])


def tree_specs(tree, axis_name: str | None, axis_size: int, min_size: int = 1024) -> dict:
    """:func:`leaf_spec` of each leaf of a ``{name: tensor or shape}`` map
    (or of ``(name, tensor)`` pairs)."""
    items = tree.items() if isinstance(tree, dict) else tree
    return {name: leaf_spec(getattr(x, "shape", x), axis_name, axis_size, min_size)
            for name, x in items}


def shard(t: torch.Tensor, dim: int, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s shard of ``t`` along ``dim``: a view of ``t``."""
    k = t.shape[dim] // world
    return t.narrow(dim, rank * k, k)


def dim0_chunk(t: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s first-dimension chunk of ``t`` as FSDP2 lays it out
    (``torch.chunk``: ``ceil(n / world)`` rows a rank, the last ones
    shorter or empty); a view of ``t``."""
    chunks = t.chunk(world, dim=0)
    return chunks[rank] if rank < len(chunks) else t[:0]


def dim0_chunk_start(n: int, rank: int, world: int) -> int:
    """The first row of rank ``rank``'s :func:`dim0_chunk` of ``n`` rows."""
    return min(n, rank * -(-n // world)) if n else 0


def _rank_major(t: torch.Tensor, dim: int, world: int) -> torch.Tensor:
    """``t`` as ``[world, shard numel]``: row r is rank r's shard, flat."""
    k = t.shape[dim] // world
    return t.unflatten(dim, (world, k)).movedim(dim, 0).reshape(world, -1)


def _from_rank_major(rows: torch.Tensor, dim: int, shape) -> torch.Tensor:
    """Inverse of :func:`_rank_major`: ``[world, n]`` back to ``shape``."""
    world = rows.shape[0]
    local = list(shape)
    local[dim] //= world
    return rows.reshape(world, *local).movedim(0, dim).reshape(shape)


def _collective(*names):
    """The first of ``names`` this torch has: the newest spelling, then the
    older one that every supported torch keeps."""
    for name in names:
        fn = getattr(tdist, name, None)
        if fn is not None:
            return fn
    raise RuntimeError(f"torch.distributed has none of {names}")


def all_gather_flat(out: torch.Tensor, inp: torch.Tensor, group=None) -> None:
    """``out[r*n:(r+1)*n] = inp`` of rank r (``n = inp.numel()``)."""
    _collective("all_gather_single", "all_gather_into_tensor")(out, inp, group=group)


def reduce_scatter_flat(out: torch.Tensor, inp: torch.Tensor, group=None) -> None:
    """``out`` = the sum over ranks of ``inp[r*n:(r+1)*n]`` on rank r."""
    _collective("reduce_scatter_single", "reduce_scatter_tensor")(
        out, inp, op=tdist.ReduceOp.SUM, group=group)


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ranks in place (gloo has no AVG: divide after)."""
    tdist.all_reduce(t, op=tdist.ReduceOp.SUM, group=group)
    return t


def gather_tensor(local: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The whole leaf from every rank's ``local`` shard along ``dim``."""
    world = tdist.get_world_size(group)
    flat = local.reshape(-1)
    out = flat.new_empty(world * flat.numel())
    all_gather_flat(out, flat.contiguous(), group)
    shape = list(local.shape)
    shape[dim] *= world
    return _from_rank_major(out.view(world, -1), dim, shape)


def _flat_views(flat: torch.Tensor, shapes) -> list[torch.Tensor]:
    out, off = [], 0
    for shape in shapes:
        n = 1
        for d in shape:
            n *= d
        out.append(flat[off:off + n].view(shape))
        off += n
    return out


def all_reduce_tensors(tensors: list[torch.Tensor], group=None,
                       scale: float = 1.0) -> list[torch.Tensor]:
    """The sum over ranks of each of ``tensors``, times ``scale``: one
    all-reduce of their concatenation. Returns views of one new buffer."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_sum_(flat, group)
    if scale != 1.0:
        flat.mul_(scale)
    return _flat_views(flat, [t.shape for t in tensors])


def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # torch before 2.5
        from torch.distributed._tensor import DTensor
    return DTensor


def is_dtensor(t) -> bool:
    return isinstance(t, _dtensor_type())


class ShardPlan:
    """This rank's share of a parameter list.

    ``dims`` (ZeRO-1/2): one :func:`leaf_spec` dimension or None per leaf;
    a leaf with a dimension is held as this rank's shard along it, the
    others whole. ``dtensor=True`` (ZeRO-3 under FSDP2): every leaf is a
    ``DTensor`` and this rank's share is its local tensor. ``group`` is
    the process group the shards span.
    """

    def __init__(self, dims: list[int | None] | None = None, group=None, *,
                 dtensor: bool = False):
        if (dims is None) == (not dtensor):
            raise ValueError("a ShardPlan has per-leaf dims or dtensor=True, not both")
        self.dims = dims
        self.dtensor = dtensor
        self.group = group
        self.world = tdist.get_world_size(group)
        self.rank = tdist.get_rank(group)
        self._sharded_mask = None  # device bool [n_leaves], built at first use

    def sharded(self, i: int) -> bool:
        return self.dtensor or self.dims[i] is not None

    def local(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """This rank's shard of each leaf (views: an in-place update of one
        writes the leaf); whole leaves as they are."""
        if self.dtensor:
            return [t.to_local() if is_dtensor(t) else t for t in tensors]
        return [t if d is None else shard(t, d, self.rank, self.world)
                for t, d in zip(tensors, self.dims)]

    def piece(self, i: int, whole: torch.Tensor) -> torch.Tensor:
        """This rank's share of leaf ``i`` cut from ``whole``, the whole
        leaf (a view): its :func:`leaf_spec` shard, or under FSDP2 its
        first-dimension chunk; ``whole`` itself for an unsharded leaf."""
        if self.dtensor:
            return dim0_chunk(whole, self.rank, self.world)
        d = self.dims[i]
        return whole if d is None else shard(whole, d, self.rank, self.world)

    def index(self, i: int, param: torch.Tensor, local_shape) -> list | None:
        """Where this rank's share (``local_shape``) of leaf ``i``
        (``param``) lies in the whole leaf, as ``[[start, stop], ...]`` per
        dimension; None for a leaf that every rank holds whole."""
        shape = [int(n) for n in param.shape]
        if self.dtensor:
            if not is_dtensor(param):
                return None
            start = dim0_chunk_start(shape[0], self.rank, self.world)
            return [[start, start + int(local_shape[0])]] + [[0, n] for n in shape[1:]]
        d = self.dims[i]
        if d is None:
            return None
        k = shape[d] // self.world
        return [[self.rank * k, (self.rank + 1) * k] if j == d else [0, n]
                for j, n in enumerate(shape)]

    def norm_sq(self, sq: torch.Tensor) -> torch.Tensor:
        """The global sum of squares from each leaf's local one (``sq``,
        ``[n_leaves]``): shards summed over ranks, whole leaves once (on
        rank 0), in one all-reduce."""
        if not self.dtensor and self.rank != 0:
            if self._sharded_mask is None:
                self._sharded_mask = torch.tensor([d is not None for d in self.dims],
                                                  device=sq.device)
            sq = torch.where(self._sharded_mask, sq, torch.zeros_like(sq))
        return all_reduce_sum_(sq.sum(), self.group)

    def reduce_grads(self, grads: list[torch.Tensor], scatter: bool,
                     scale: float = 1.0) -> list[torch.Tensor]:
        """Each leaf's gradient summed over ranks, times ``scale``, as this
        rank's share: with ``scatter`` (ZeRO-2) sharded leaves by one
        reduce-scatter and whole ones by one all-reduce; without (ZeRO-1)
        everything by one all-reduce, then this rank's views."""
        if not scatter:
            return self.local(all_reduce_tensors(grads, self.group, scale))
        out: list = [None] * len(grads)
        idx = [i for i, d in enumerate(self.dims) if d is not None]
        if idx:
            send = torch.cat([_rank_major(grads[i], self.dims[i], self.world) for i in idx],
                             dim=1).reshape(-1)
            recv = send.new_empty(send.numel() // self.world)
            reduce_scatter_flat(recv, send, self.group)
            if scale != 1.0:
                recv.mul_(scale)
            shapes = [shard(grads[i], self.dims[i], 0, self.world).shape for i in idx]
            for i, v in zip(idx, _flat_views(recv, shapes)):
                out[i] = v
        whole = [i for i, d in enumerate(self.dims) if d is None]
        for i, v in zip(whole, all_reduce_tensors([grads[i] for i in whole], self.group,
                                                  scale)):
            out[i] = v
        return out

    @torch.no_grad()
    def gather_(self, params: list[torch.Tensor], steps: list[torch.Tensor] | None = None):
        """After an update of the local shards: refill each sharded leaf of
        ``params`` from every rank's shard, by one all-gather. With
        ``steps`` (each leaf's update in the wire dtype, shard-shaped),
        gather the steps instead and add them, upcast, to every leaf,
        whole leaves included; the local shards are then not yet updated.
        Under FSDP2 there is nothing to gather: the steps are added to the
        local shards."""
        if self.dtensor:
            if steps is not None:
                for p, s in zip(self.local(params), steps):
                    p.add_(s.to(p.dtype))
            return
        idx = [i for i, d in enumerate(self.dims) if d is not None]
        src = steps if steps is not None else self.local(params)
        if idx:
            send = torch.cat([src[i].reshape(-1) for i in idx])
            recv = send.new_empty(self.world * send.numel()).view(self.world, -1)
            all_gather_flat(recv.view(-1), send, self.group)
            off = 0
            for i in idx:
                n = src[i].numel()
                full = _from_rank_major(recv[:, off:off + n], self.dims[i], params[i].shape)
                if steps is None:
                    params[i].copy_(full)
                else:
                    params[i].add_(full.to(params[i].dtype))
                off += n
        if steps is not None:
            for i, d in enumerate(self.dims):
                if d is None:
                    params[i].add_(steps[i].to(params[i].dtype))

    def gather_state(self, params: list[torch.Tensor],
                     states: list[torch.Tensor | None]) -> list[torch.Tensor | None]:
        """Whole-leaf copies of per-shard state (moments, EMA), the layout
        of a run on one rank; a collective, so every rank calls it."""
        out = []
        for i, (p, s) in enumerate(zip(params, states)):
            if s is None or not self.sharded(i):
                out.append(s)
            elif self.dtensor:
                out.append(_dtensor_type().from_local(s, p.device_mesh, p.placements, shape=p.shape,
                                              stride=p.stride()).full_tensor())
            else:
                out.append(gather_tensor(s, self.dims[i], self.group))
        return out
