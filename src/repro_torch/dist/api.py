"""Mesh-axis vocabulary and the mesh helpers of the port (counterpart of
``repro.dist.api``, its mesh-independent part).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` built with
``init_device_mesh(device_type, shape, mesh_dim_names=...)`` over an
initialised process group, under the reference's axis names:

* ``POD``/``STAGE``/``DATA``/``MODEL``; ``BATCH_AXES = (POD, DATA)`` is
  the batch-dim prefix (the ``pod`` axis exists only on multi-pod
  meshes and is filtered automatically);
* :func:`mesh_axes` and :func:`mesh_ndev` read a mesh's axis names and
  rank count; :func:`mesh_position` is this rank's row of a device-major
  pool: a pool row belongs to the rank at that position of
  ``mesh.mesh.flatten()``, the row-major order of JAX's ``P(axes)`` over
  every axis combined;
* :func:`all_gather_rows` and :func:`all_reduce` are the collectives
  the port's mesh paths use: ``all_gather`` and ``all_reduce``, which
  both NCCL and gloo take on CUDA tensors (gloo's ``send``/``recv`` are
  documented for CPU tensors only, so the pipeline's
  :func:`stage_transfer` is an ``all_gather`` too). A gather puts each rank's
  shard at its flat-mesh position, not at its group rank (``new_group``
  sorts its ranks). A collective that refuses a tensor raises; nothing
  falls back to the CPU;
* :func:`clean_spec` fits a partition spec (a tuple of axis names per
  dim) to a mesh's axis sizes; :func:`path_key` and :func:`factor_axes`
  are the reference's, on the port's flat parameter paths;
* the megatron seams of tensor parallelism (``--model-parallel``), as
  ``torch.autograd.Function``s over a one-axis model submesh:
  :func:`fwd_psum` (all-reduce forward, identity backward: megatron's
  ``g``) and :func:`bwd_psum` (identity forward, all-reduce backward:
  its ``f``); :func:`psum_if_bound` and :func:`bwd_psum_if_bound` apply
  them only inside a :func:`hint_guard` that bound the axis to a
  submesh of several ranks, and are the identity elsewhere. The program
  enters the guard around its model calls (no global mesh, which a
  raise would leave bound). Both seams reduce in fp32 and count their
  traffic in :data:`SEAM_TRAFFIC`; :func:`in_hint_guard` says the
  guard is the pipeline's stage program (it bound ``stage``).

The spec functions also take a plain ``{axis: size}`` mapping for the
mesh, so layouts can be planned without a process group. The
reference's ``shard_hint`` and ``shard_like_params`` are not ported:
they are GSPMD sharding constraints, which mean nothing without a
partitioner; the port's tensor-parallel model code holds its slices and
reduces through the seams above.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

#: what the multi-rank paths still lack raises naming this (meshes with
#: other axes than stage, data and model: the production mesh's pod axis)
MULTI_GPU_ITEM = "ROADMAP Queue 1 item 9b"

POD = "pod"
STAGE = "stage"
DATA = "data"
MODEL = "model"

#: batch dims shard over the pure data-parallel axes (outer ``pod`` on
#: multi-pod meshes, inner ``data`` everywhere); the ``stage`` axis never
#: carries batch
BATCH_AXES: Tuple[str, ...] = (POD, DATA)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh, outer to inner (a mapping
    passes through)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_axes(mesh) -> Tuple[str, ...]:
    """Every axis name of ``mesh``, outer to inner: the combined-axis
    tuple the block-parallel solver shards its device-major pools over."""
    return tuple(axis_sizes(mesh))


def mesh_ndev(mesh) -> int:
    """Total device (rank) count of ``mesh``."""
    if isinstance(mesh, Mapping):
        return math.prod(mesh.values())
    return int(mesh.size())


def mesh_ranks(mesh) -> Tuple[int, ...]:
    """The global ranks of ``mesh`` in flat (row-major) mesh order."""
    return tuple(int(r) for r in mesh.mesh.flatten().tolist())


def mesh_position(mesh) -> int:
    """This rank's position in ``mesh.mesh.flatten()``: the row of every
    device-major pool it owns."""
    return mesh_ranks(mesh).index(dist.get_rank())


# process groups over the ranks of submeshes of several axes, by their
# sorted ranks (register_group); the side lane's, likewise
# (make_side_groups), and whether a side_lane block is being run
_GROUPS: dict = {}
_SIDE_GROUPS: dict = {}
_IN_SIDE: list = []


def register_group(ranks, group) -> None:
    """Record ``group`` as the process group over ``ranks`` (every rank
    made it with ``dist.new_group``), for :func:`mesh_group`'s submeshes
    of several axes."""
    _GROUPS[tuple(sorted(int(r) for r in ranks))] = group


def make_side_groups(grid: torch.Tensor) -> None:
    """Make the side lane's groups for a mesh whose ranks are ``grid``
    (its last two axes ``data`` and ``model``; every rank of the world
    calls, in one order): over the whole mesh, each ``(data, model)``
    slice of a leading ``stage`` axis, and each ``data`` column, the
    rank sets the distributed refresh gathers over. The side lane is
    the inverse refresh's on a side stream (``--async-inv``): groups of
    its own, so that its collectives never queue with the step's on one
    communicator."""
    subsets = [grid.flatten().tolist()]
    if grid.ndim == 3:
        subsets += [grid[s].flatten().tolist() for s in range(grid.shape[0])]
    cols = grid.reshape(-1, grid.shape[-2], grid.shape[-1])
    subsets += [cols[s, :, j].tolist() for s in range(cols.shape[0])
                for j in range(cols.shape[2])]
    seen = set()
    for sub in subsets:
        key = tuple(sorted(sub))
        if key not in seen:
            seen.add(key)
            _SIDE_GROUPS[key] = dist.new_group(sub)


@contextlib.contextmanager
def side_lane():
    """Inside the ``with`` body every collective of :func:`mesh_group`
    runs on the side lane's groups (:func:`make_side_groups`); a rank set
    it has no group for raises."""
    _IN_SIDE.append(True)
    try:
        yield
    finally:
        _IN_SIDE.pop()


def mesh_group(mesh):
    """The process group over every rank of ``mesh``: None (the default
    group) when the mesh spans the world, a one-axis submesh's own group
    (``mesh["data"]``, made with the mesh by every rank), or for a
    submesh of several axes the group :func:`register_group` recorded for
    its ranks (``runtime.elastic.elastic_mesh`` makes one for a mesh over
    part of the world and for each stage's ``(data, model)`` ranks).
    Inside :func:`side_lane`, the side lane's group over the ranks."""
    ranks = tuple(sorted(mesh_ranks(mesh)))
    if _IN_SIDE:
        if ranks not in _SIDE_GROUPS:
            raise ValueError(f"the side lane has no group over the ranks "
                             f"{ranks}")
        return _SIDE_GROUPS[ranks]
    if ranks == tuple(range(dist.get_world_size())):
        return None
    if mesh.mesh.ndim == 1:
        return mesh.get_group()
    if ranks in _GROUPS:
        return _GROUPS[ranks]
    raise ValueError(
        f"no process group for the ranks {ranks} of a submesh of several "
        f"axes; make one with dist.new_group on every rank and "
        f"register_group it, or reduce over a one-axis submesh")


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each), concatenated along
    dim 0 in flat-mesh order: rank ``mesh_ranks(mesh)[p]``'s rows land at
    position ``p``."""
    ranks = mesh_ranks(mesh)
    parts = [torch.empty_like(t) for _ in ranks]
    dist.all_gather(parts, t.contiguous(), group=mesh_group(mesh))
    by_rank = dict(zip(sorted(ranks), parts))     # group rank order
    return torch.cat([by_rank[r] for r in ranks])


def stage_transfer(fwd: torch.Tensor, bwd: torch.Tensor, mesh):
    """One tick's pipeline transfers over the one-axis ``stage`` submesh
    (the reference's ``lax.ppermute`` pair): every stage rank sends
    ``fwd`` (an activation, to the next stage) and ``bwd`` (a cotangent,
    to the previous one), zeros where it has none; returns ``(fwd from
    the previous stage, bwd from the next)``, None at the ends. One
    :func:`all_gather_rows` of both (the collective gloo and NCCL take on
    CUDA tensors); every stage rank takes part."""
    ranks = mesh_ranks(mesh)
    s = ranks.index(dist.get_rank())
    got = all_gather_rows(torch.stack([fwd, bwd]), mesh)
    prev = got[2 * (s - 1)] if s > 0 else None
    nxt = got[2 * (s + 1) + 1] if s + 1 < len(ranks) else None
    return prev, nxt


def all_reduce(t: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over every rank of ``mesh`` in place (``"sum"`` or
    ``"max"``); returns ``t``."""
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    dist.all_reduce(t, op=ops[op], group=mesh_group(mesh))
    return t


# the one-axis submeshes bound by the innermost hint_guard, by axis name
_BOUND: list = []

#: the seams' all-reduces and their fp32 bytes since the caller last
#: zeroed them (``SEAM_TRAFFIC.update(reductions=0, bytes=0)``)
SEAM_TRAFFIC = {"reductions": 0, "bytes": 0}


@contextlib.contextmanager
def hint_guard(axes: Optional[Mapping[str, Any]] = None):
    """Bind one-axis submeshes by axis name (``{MODEL: mesh["model"]}``)
    for the model code's seams inside the ``with`` body; the binding is
    dropped on the way out, a raise included. (The reference's guard
    records axis sizes inside a manual ``shard_map`` region; here the
    submesh itself is bound, since the collective needs its group.)"""
    _BOUND.append(dict(axes or {}))
    try:
        yield
    finally:
        _BOUND.pop()


def in_hint_guard() -> bool:
    """True inside a :func:`hint_guard` that bound the ``stage`` axis:
    the pipeline executor's stage program (``pipeline.schedule``), the
    counterpart of the reference's manual ``shard_map`` region, where the
    MoE layers route by its in-stage capacity rule (``models.moe``)."""
    return bool(_BOUND) and STAGE in _BOUND[-1]


def bound_axes() -> dict:
    """``{axis: size}`` bound by the innermost :func:`hint_guard` (empty
    outside one)."""
    return {a: mesh_ndev(m) for a, m in _BOUND[-1].items()} if _BOUND \
        else {}


def bound_mesh(axis: str):
    """The submesh the innermost :func:`hint_guard` bound to ``axis``,
    when it holds several ranks; else None."""
    mesh = _BOUND[-1].get(axis) if _BOUND else None
    return mesh if mesh is not None and mesh_ndev(mesh) > 1 else None


def _seam_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over ``mesh``'s ranks in fp32, in ``t``'s dtype (a new
    tensor)."""
    buf = t.to(torch.float32, copy=True)
    all_reduce(buf, mesh)
    SEAM_TRAFFIC["reductions"] += 1
    SEAM_TRAFFIC["bytes"] += 4 * buf.numel()
    return buf.to(t.dtype)


class _FwdPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _seam_reduce(x, mesh)

    @staticmethod
    def backward(ctx, ct):
        # the summed output is replicated, so its cotangent is too, and
        # each rank's partial enters it with coefficient 1
        return ct, None


class _BwdPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _seam_reduce(ct, ctx.mesh), None


def fwd_psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the ranks of the one-axis ``mesh``, with the
    identity as its backward: the reduction after a row-parallel
    product."""
    return _FwdPsum.apply(x, mesh)


def bwd_psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The identity, whose cotangent is summed over the ranks of
    ``mesh``: where a replicated activation fans into column-parallel
    slices, each of which gives only its part of the input cotangent."""
    return _BwdPsum.apply(x, mesh)


def psum_if_bound(x: torch.Tensor, axis: str) -> torch.Tensor:
    """:func:`fwd_psum` over the submesh bound to ``axis``
    (:func:`bound_mesh`), or the identity."""
    mesh = bound_mesh(axis)
    return x if mesh is None else fwd_psum(x, mesh)


def bwd_psum_if_bound(x: torch.Tensor, axis: str) -> torch.Tensor:
    """:func:`bwd_psum` over the submesh bound to ``axis``, or the
    identity."""
    mesh = bound_mesh(axis)
    return x if mesh is None else bwd_psum(x, mesh)


def _norm_entry(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def clean_spec(spec, shape, mesh) -> tuple:
    """A spec valid on ``mesh`` for an array of ``shape``: per dim, keep
    only the axis names the mesh has, then drop axes right to left until
    the dim divides by the remaining axes' product. A dim that does not
    divide degrades to replication (None); one axis stays a name, several
    a tuple, as the reference's ``PartitionSpec`` entries."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        names = tuple(a for a in _norm_entry(entry) if a in sizes)
        n = math.prod(sizes[a] for a in names)
        while names and dim % n:
            n //= sizes[names[-1]]
            names = names[:-1]
        if not names:
            out.append(None)
        elif len(names) == 1:
            out.append(names[0])
        else:
            out.append(names)
    return tuple(out)


def path_key(path) -> str:
    """Canonical string for a tree path: ``a/b/0/c``. Entries are strings
    or ints, or key objects with ``key``, ``idx`` or ``name``."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        else:
            parts.append(str(p))
    return "/".join(parts)


def factor_axes(name: str) -> Tuple[Optional[str], ...]:
    """Block axes of the factored linear ``name``: ``(*stack_axes,
    a_block_axis, g_block_axis)``, from the owning weight's partition
    spec, so that the gradient's (d_in, d_out) layout maps onto (A
    blocks, G blocks); MoE weights carry the expert dim on ``model`` as
    a stack axis."""
    from repro_torch.dist.sharding import _param_pspec

    if "moe/" in name:
        return tuple(_param_pspec(name, 4))[1:]
    return tuple(_param_pspec(name, 3))[-2:]
