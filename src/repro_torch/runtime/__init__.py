"""Fault-tolerant training loop and elastic re-meshing (counterpart of
``repro.runtime``)."""

from repro_torch.runtime.elastic import (  # noqa: F401
    DeviceLoss,
    elastic_mesh,
    largest_mesh,
)
from repro_torch.runtime.loop import LoopConfig, TrainLoop  # noqa: F401
from repro_torch.runtime.watchdog import (  # noqa: F401
    StepDeadlineExceeded,
    StepWatchdog,
)
