"""SOI inversion on one device (counterpart of ``repro.solve``).

  partition      FLOP-cost partitioner: every SOI block of every layer
                 pooled by block size and assigned to a device; the WU
                 plan that indexes every gradient tile into those pools
  block_solver   the plan's pooled inversion (the reference's local image
                 of its shard_map solver), bitwise the replicated one
  async_refresh  the staleness-tolerant double-buffered refresh on a side
                 CUDA stream (``AsyncInverseRefresher``) and the SMW
                 drift gate (``SMWRefresher``)
  smw            incremental SOI: rank-k Woodbury refresh of every cached
                 inverse, drift-monitored
  pdiv           recursive block-Schur inversion of blocks above a cap

The reference's ``fused_wu`` (the distributed INV->VMM program) waits for
the multi-GPU port.
"""

from repro_torch.solve.async_refresh import (  # noqa: F401
    AsyncInverseRefresher,
    SMWRefresher,
)
from repro_torch.solve.block_solver import invert_factor_tree  # noqa: F401
from repro_torch.solve.partition import (  # noqa: F401
    PdivEntry,
    Plan,
    WUPlan,
    inverse_block_flops,
    make_plan,
    make_wu_plan,
    pdiv_depth,
)
from repro_torch.solve.pdiv import pdiv_invert  # noqa: F401
from repro_torch.solve.smw import (  # noqa: F401
    SMWConfig,
    probe_drift,
    smw_refresh,
)
