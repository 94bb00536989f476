"""repro_torch.lowp — the low-precision training mode (the training
half of ``repro.lowp``).

``--precision {fp32,hilo,int8}`` on ``repro_torch.launch.train`` (a
``KFACConfig.precision`` field) sets the precision of every WU product:
bf16 limb products ("hilo", also the ``fused_precond`` kernel's scheme)
or exact integer bit-sliced products ("int8": 24-bit codes composed
from 8-bit hardware slices, on the pooled ``lowp_einsum`` route). The
SOI inverse refresh is the composed hi/lo inversion in every mode.
Budget: >= 16 effective bits on the preconditioned update against fp32
(:func:`parity.update_parity`).
"""

from repro_torch.core.quantize import (  # noqa: F401
    PRECISIONS,
    hilo_einsum,
    int_slice_einsum,
    lowp_einsum,
    precision_kind,
)
from repro_torch.lowp.parity import (  # noqa: F401
    trajectory_parity,
    update_parity,
)

__all__ = [
    "PRECISIONS",
    "precision_kind",
    "lowp_einsum",
    "hilo_einsum",
    "int_slice_einsum",
    "update_parity",
    "trajectory_parity",
]
