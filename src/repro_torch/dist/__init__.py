"""The distributed layer on ``torch.distributed`` (counterpart of
``repro.dist``): the mesh-axis vocabulary, mesh helpers and the
collectives the mesh paths use (:mod:`repro_torch.dist.api`), the
name-pattern sharding rules as pure spec functions
(:mod:`repro_torch.dist.sharding`), int8 error-feedback gradient
compression (:mod:`repro_torch.dist.compression`), and a launcher of
function calls on the ranks of a fresh process group
(:mod:`repro_torch.dist.spawn`).

The image of RePAST's mapping scheme (paper Sec. IV/V): SOI factor blocks
spread over ranks as over INV crossbar groups (``solve.block_solver``,
``solve.fused_wu``).
"""

from repro_torch.dist import api, compression, sharding, spawn  # noqa: F401
