"""Device meshes over the process group (counterpart of
``repro.launch.mesh``, its development mesh).

:func:`make_dev_mesh` is the largest ``(data, model)`` mesh over the
initialised process group's world: every rank a device, ranks in
row-major order. Its one-axis submeshes give each rank its groups:
``mesh["model"]`` the ranks of its row (its model group, which the
tensor-parallel seams reduce over), ``mesh["data"]`` those of its column
(its data group, which the gradients and Grams reduce over).
:func:`make_pipeline_mesh` adds the ``stage`` axis of pipeline
parallelism (``--pp``) outside them. The reference's
``make_production_mesh`` (its 256- and 512-chip TPU pod layouts) waits
for ROADMAP Queue 1 item 9b.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.dist.api import DATA, MODEL, STAGE, register_group


def make_dev_mesh(model: int = 1, device_type: str | None = None):
    """The ``(data, model)`` DeviceMesh over the whole world, ``model``
    ranks to a model group. ``device_type`` defaults to ``"cuda"`` over
    an NCCL group and ``"cpu"`` otherwise (gloo, which moves CUDA tensors
    through the host, as when two ranks share one card)."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks not divisible by model={model}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=(DATA, MODEL))


def make_pipeline_mesh(pp: int, model: int = 1,
                       device_type: str | None = None):
    """The ``(stage, data, model)`` DeviceMesh over the whole world:
    ``stage`` the pipeline axis (``repro_torch.pipeline``), ``model`` the
    in-stage tensor and expert parallelism, the ranks left over
    data-parallel over the microbatch rows; the reference's divisibility
    errors. ``mesh["stage"]`` is a rank's pipeline (its ranks of every
    stage), ``mesh["data", "model"]`` its stage's ranks, whose process
    group this makes and registers (``dist.api.register_group``) for the
    stage's distributed refresh. ``device_type`` as in
    :func:`make_dev_mesh`."""
    n = dist.get_world_size()
    if pp < 1:
        raise ValueError(f"pp must be >= 1, got {pp}")
    if n % (pp * model):
        raise ValueError(
            f"{n} devices not divisible by pp={pp} * model={model}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (pp, n // (pp * model), model),
                            mesh_dim_names=(STAGE, DATA, MODEL))
    for s in range(pp):
        ranks = mesh.mesh[s].flatten().tolist()
        group = dist.new_group(ranks) if len(ranks) < n else None
        register_group(ranks, group)
    return mesh
