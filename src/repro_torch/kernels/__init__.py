"""Hand-written Hopper kernels of the port (CUDA C++ for ``sm_90a``).

  neumann_inv     composed-precision SOI block inverse (INV)
  fused_precond   pooled two-sided WU product with the trust-region dot
  smw_update      rank-k Woodbury update of the cached inverses (--smw)

Each has a plain PyTorch version in :mod:`ref`; :mod:`ops` dispatches by
device. The TPU kernels ``bitslice_mm`` and ``fused_gram_inv`` are not
ported yet: no training path reaches them.
"""
