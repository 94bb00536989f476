"""Block-parallel SOI inversion (counterpart of ``repro.solve``).

  partition      FLOP-cost partitioner: every SOI block of every layer
                 pooled by block size and assigned to a device; the WU
                 plan that indexes every gradient tile into those pools
  block_solver   the plan's pooled inversion: on a mesh each rank inverts
                 its own row of every pool and the shards are gathered;
                 without one the local image; bitwise the replicated one
  async_refresh  the staleness-tolerant double-buffered refresh on a side
                 CUDA stream (``AsyncInverseRefresher``) and the SMW
                 drift gate (``SMWRefresher``)
  smw            incremental SOI: rank-k Woodbury refresh of every cached
                 inverse, drift-monitored
  fused_wu       fused INV->VMM: each rank runs the WU products on the
                 blocks it just inverted, one gather routing the
                 intermediates to the G owners (the paper's VMM+INV fused
                 crossbar groups, Sec. V)
  pdiv           recursive block-Schur inversion of blocks above a cap,
                 its top stage pairs spread over a mesh
"""

from repro_torch.solve.async_refresh import (  # noqa: F401
    AsyncInverseRefresher,
    SMWRefresher,
)
from repro_torch.solve.block_solver import invert_factor_tree  # noqa: F401
from repro_torch.solve.fused_wu import (  # noqa: F401
    DEFAULT_DIST_MODE,
    refresh_and_precondition,
)
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
