"""Device meshes over the process group (counterpart of
``repro.launch.mesh``, its development mesh).

:func:`make_dev_mesh` is the largest ``(data, model)`` mesh over the
initialised process group's world: every rank a device, ranks in
row-major order. Its one-axis submeshes give each rank its groups:
``mesh["model"]`` the ranks of its row (its model group, which the
tensor-parallel seams reduce over), ``mesh["data"]`` those of its column
(its data group, which the gradients and Grams reduce over).
:func:`make_pipeline_mesh` adds the ``stage`` axis of pipeline
parallelism (``--pp``) outside them. Both form their mesh through
``runtime.elastic.elastic_mesh``, the function a recovery re-forms the
mesh with: a world that is not a multiple of the model x stage group
takes the largest mesh (a power-of-two data axis), and the ranks left
over get no coordinate. The reference's ``make_production_mesh`` (its
256- and 512-chip TPU pod layouts) waits for ROADMAP Queue 1 item 9b.
"""

from __future__ import annotations

from typing import Any

from repro_torch.runtime.elastic import elastic_mesh


def make_dev_mesh(model: int = 1, device_type: str | None = None,
                  obs: Any = None):
    """The largest ``(data, model)`` DeviceMesh over the world, ``model``
    ranks to a model group (every rank calls). ``device_type`` defaults
    to ``"cuda"`` over an NCCL group and ``"cpu"`` otherwise (gloo,
    which moves CUDA tensors through the host, as when two ranks share
    one card); ``obs`` records the mesh (``elastic_mesh``)."""
    return elastic_mesh(model, device_type=device_type, obs=obs)


def make_pipeline_mesh(pp: int, model: int = 1,
                       device_type: str | None = None, obs: Any = None):
    """The largest ``(stage, data, model)`` DeviceMesh over the world:
    ``stage`` the pipeline axis (``repro_torch.pipeline``), ``model`` the
    in-stage tensor and expert parallelism, the ranks left over
    data-parallel over the microbatch rows. ``mesh["stage"]`` is a rank's
    pipeline (its ranks of every stage), ``mesh["data", "model"]`` its
    stage's ranks, whose process group ``elastic_mesh`` makes and
    registers (``dist.api.register_group``) for the stage's distributed
    refresh. ``device_type`` and ``obs`` as in :func:`make_dev_mesh`."""
    if pp < 1:
        raise ValueError(f"pp must be >= 1, got {pp}")
    return elastic_mesh(model, pp=pp, device_type=device_type, obs=obs)
