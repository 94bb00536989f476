"""Device meshes over the process group (counterpart of
``repro.launch.mesh``, its development mesh).

:func:`make_dev_mesh` is the largest ``(data, model)`` mesh over the
initialised process group's world: every rank a device, ranks in
row-major order. Its one-axis submeshes give each rank its groups:
``mesh["model"]`` the ranks of its row (its model group, which the
tensor-parallel seams reduce over), ``mesh["data"]`` those of its column
(its data group, which the gradients and Grams reduce over). The reference's ``make_production_mesh`` (its 256- and
512-chip TPU pod layouts) waits for ROADMAP Queue 1 item 9b, and
``make_pipeline_mesh`` for ``pipeline/`` (item 8's ``--pp``).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.dist.api import DATA, MODEL


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
