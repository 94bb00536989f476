"""Continuous-batching serving (counterpart of ``repro.serve``):
``serve.engine`` (scheduler, engine on the contiguous slot pool, int8
residency), ``serve.pool`` (slot writes), ``serve.paged`` (the
block-paged pool, the shared-prefix cache and their engine),
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
from repro_torch.serve.paged import (
    BlockLedger,
    PagedConfig,
    PagedServeEngine,
    PrefixStore,
    init_paged_pool,
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
    "BlockLedger", "EngineConfig", "FinishedRequest", "PagedConfig",
    "PagedServeEngine", "PrefixStore", "Request", "Scheduler",
    "ServeEngine", "UNWRITTEN_POS", "default_buckets", "empty_row_like",
    "init_paged_pool", "init_pool", "make_sampler", "reset_slot", "slot_dim",
    "synthetic_trace", "write_slot",
]
