"""Hand-written Hopper kernels of the port (CUDA C++ for ``sm_90a``).

  neumann_inv     composed-precision SOI block inverse (INV)
  fused_precond   pooled two-sided WU product with the trust-region dot
  smw_update      rank-k Woodbury update of the cached inverses (--smw)
  bitslice_mm     fp32-accurate matrix product from hi/lo bf16 partials
  fused_gram_inv  activation Gram and its composed inverse in one pass

Each has a plain PyTorch version in :mod:`ref`; :mod:`ops` dispatches by
device. Together they are every TPU kernel of ``repro.kernels``.
"""
