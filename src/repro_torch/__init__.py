"""PyTorch/CUDA port of the RePAST reproduction (``repro``).

K-FAC second-order training with composed-precision SOI block
inversion, on one NVIDIA H100. The module layout mirrors ``repro``
so each module's counterpart is found under the same name. The two
TPU kernels on the training path, the SOI inverse
(``kernels.neumann_inv``) and the pooled weight update
(``kernels.fused_precond``), are hand-written CUDA kernels for
``sm_90a``, built at first use.

This package imports torch and numpy only; it never imports jax or
``repro``. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
