"""Elastic re-meshing on a device loss (counterpart of
``repro.runtime.elastic``).

When ranks drop, the survivors re-form the largest mesh that keeps the
``model`` degree (tensor-parallel layouts and the K-FAC blocks follow
it) and the ``stage`` degree (the stage partition), with a power-of-two
``data`` axis so that the global batch still divides
(:func:`largest_mesh`). The last checkpoint, which holds the full state
whatever the mesh, is then restored and cut to each rank's new layout
(``runtime.TrainLoop``).

:func:`elastic_mesh` builds that mesh as a ``DeviceMesh`` over the
first ranks of the world. ``DeviceMesh`` makes its process groups with
``dist.new_group``, which every rank of the world must call: so every
rank calls :func:`elastic_mesh`, a rank that the mesh leaves out
included (it gets no coordinate, ``mesh.get_coordinate() is None``).

``DeviceLoss`` is the injected-fault stand-in used by tests and the
failure drill in ``launch.train --inject-failure-at``. A real lost
process cannot take part in the next mesh's groups: the port recovers it
by a restart of the whole group under ``torchrun --max-restarts``, which
resumes from the last checkpoint on the largest mesh of its world.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch


class DeviceLoss(RuntimeError):
    """Raised when part of the device pool is gone."""

    def __init__(self, lost: int, msg: str = ""):
        self.lost = lost
        super().__init__(msg or f"lost {lost} devices")


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def largest_mesh(n_devices: int, model: int, *, pp: int = 1) -> tuple:
    """Largest ``(data, model)`` shape, or with ``pp > 1`` ``(stage,
    data, model)``, with ``data`` a power of two. The ``model`` and
    ``stage`` degrees are kept across re-meshes; only ``data``
    shrinks."""
    if n_devices < model * pp:
        raise DeviceLoss(0, f"cannot keep model={model} x pp={pp} "
                            f"with {n_devices} devices")
    data = _pow2_floor(n_devices // (model * pp))
    if pp > 1:
        return (pp, data, model)
    return (data, model)


def elastic_mesh(model: int = 1, *, pp: int = 1,
                 ranks: Optional[Sequence[int]] = None, exclude: int = 0,
                 obs: Any = None, device_type: Optional[str] = None):
    """The largest healthy ``(data, model)`` DeviceMesh, or with ``pp >
    1`` the ``(stage, data, model)`` pipeline mesh, over the first
    ``prod(largest_mesh(...))`` of ``ranks`` (default the world's) once
    ``exclude`` ranks are dropped from their tail. Every rank of the
    world calls it (see the module's docstring). A mesh over part of the
    world gets a process group of its own, registered for
    ``dist.api.mesh_group``, and under ``pp`` each stage's ``(data,
    model)`` ranks one too; the side lane's groups
    (``dist.api.make_side_groups``) are made with them. ``device_type``
    defaults to ``"cuda"`` over an NCCL group and ``"cpu"`` otherwise
    (gloo, which moves CUDA tensors through the host). ``obs`` records
    every mesh formed: counter ``runtime_remesh_total`` and a ``remesh``
    event with its shape, ``n_devices`` and ``excluded``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.api import (DATA, MODEL, STAGE, make_side_groups,
                                      register_group)

    live = list(ranks if ranks is not None
                else range(dist.get_world_size()))
    if exclude:
        live = live[:len(live) - exclude]
    if not live:
        raise DeviceLoss(exclude, "no devices left")
    shape = largest_mesh(len(live), model, pp=pp)
    n = math.prod(shape)
    names = (STAGE, DATA, MODEL) if pp > 1 else (DATA, MODEL)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.tensor(live[:n], dtype=torch.int).reshape(shape)
    mesh = DeviceMesh(device_type, grid, mesh_dim_names=names)
    world = dist.get_world_size()
    # the groups over several axes, made by every rank in one order: the
    # whole mesh's (the default group when it spans the world), each
    # stage's (data, model) ranks
    subsets = [grid.flatten().tolist()]
    if pp > 1:
        subsets += [grid[s].flatten().tolist() for s in range(pp)]
    for sub in subsets:
        group = dist.new_group(sub) if len(sub) < world else None
        register_group(sub, group)
    # and the side lane's, for the refresh on a side stream
    make_side_groups(grid)
    if obs is not None and getattr(obs, "enabled", False):
        obs.counter("runtime_remesh_total",
                    "mesh (re-)formations, recoveries included").inc()
        obs.event("remesh", shape=dict(zip(names, shape)), n_devices=n,
                  excluded=exclude)
    return mesh


def in_mesh(mesh) -> bool:
    """Whether this rank holds a coordinate of ``mesh``."""
    return mesh.get_coordinate() is not None
