"""Fault-tolerant training loop on one device (counterpart of
``repro.runtime``)."""

from repro_torch.runtime.elastic import DeviceLoss  # noqa: F401
from repro_torch.runtime.loop import LoopConfig, TrainLoop  # noqa: F401
from repro_torch.runtime.watchdog import (  # noqa: F401
    StepDeadlineExceeded,
    StepWatchdog,
)
