"""repro_torch.lowp — the low-precision mode (counterpart of
``repro.lowp``).

* **Training.** ``--precision {fp32,hilo,int8}`` on
``repro_torch.launch.train`` (a ``KFACConfig.precision`` field) sets the precision of every WU product:
bf16 limb products ("hilo", also the ``fused_precond`` kernel's scheme)
or exact integer bit-sliced products ("int8": 24-bit codes composed
from 8-bit hardware slices, on the pooled ``lowp_einsum`` route). The
SOI inverse refresh is the composed hi/lo inversion in every mode.
Budget: >= 16 effective bits on the preconditioned update against fp32
(:func:`parity.update_parity`).
* **Serving.** ``--quant int8`` on ``repro_torch.launch.serve``: int8
weights (per-channel scales) and an int8 KV cache (per-position scales
in sibling pool leaves), dequantized in fp32 by each prefill and decode
chunk (:mod:`.serve_quant`); greedy parity with the fp32 engine on
decided margins (:func:`serve_parity.serve_greedy_parity`).
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
from repro_torch.lowp.serve_parity import (  # noqa: F401
    MARGIN_FLOOR,
    serve_greedy_parity,
    trained_params,
)
from repro_torch.lowp.serve_quant import (  # noqa: F401
    QTensor,
    dequantize_kv,
    dequantize_params,
    quantize_kv,
    quantize_params,
    requantize_kv,
    tree_bytes,
)

__all__ = [
    "PRECISIONS",
    "precision_kind",
    "lowp_einsum",
    "hilo_einsum",
    "int_slice_einsum",
    "update_parity",
    "trajectory_parity",
    "MARGIN_FLOOR",
    "serve_greedy_parity",
    "trained_params",
    "QTensor",
    "quantize_params",
    "dequantize_params",
    "quantize_kv",
    "dequantize_kv",
    "requantize_kv",
    "tree_bytes",
]
