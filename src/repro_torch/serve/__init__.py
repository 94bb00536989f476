"""Continuous-batching serving on the contiguous slot pool (counterpart
of ``repro.serve``, without the block-paged pool and the prefix cache):
``serve.engine`` (scheduler, engine), ``serve.pool`` (slot writes),
``serve.sampling`` (on-device samplers)."""

from repro_torch.serve.engine import (
    EngineConfig,
    FinishedRequest,
    Request,
    Scheduler,
    ServeEngine,
    default_buckets,
    synthetic_trace,
)
from repro_torch.serve.pool import (
    UNWRITTEN_POS,
    empty_row_like,
    init_pool,
    reset_slot,
    slot_dim,
    write_slot,
)
from repro_torch.serve.sampling import make_sampler

__all__ = [
    "EngineConfig", "FinishedRequest", "Request", "Scheduler",
    "ServeEngine", "UNWRITTEN_POS", "default_buckets", "empty_row_like",
    "init_pool", "make_sampler", "reset_slot", "slot_dim",
    "synthetic_trace", "write_slot",
]
