"""Hand-written Hopper kernels of the port (CUDA C++ for ``sm_90a``).

  neumann_inv     composed-precision SOI block inverse (INV)
  fused_precond   pooled two-sided WU product with the trust-region dot
  smw_update      rank-k Woodbury update of the cached inverses (--smw)
  bitslice_mm     fp32-accurate matrix product from hi/lo bf16 partials
  fused_gram_inv  activation Gram and its composed inverse (in one pass up
                  to 128; above, the Gram through device memory and
                  neumann_inv's large route)

The four with a block side or rank take the reference's whole domain, up
to 1024: up to 128 one CTA holds a block; above, batched hi/lo products
run over every block of a chunk with the state in a workspace, on TMA
and wgmma with operands stored split by their writer
(``csrc/hilo_tma.cuh``, :mod:`hilo_tma`). ``bitslice_mm`` takes any
shape.

Each has a plain PyTorch version in :mod:`ref`; :mod:`ops` dispatches by
device. Together they are every TPU kernel of ``repro.kernels``.
"""
