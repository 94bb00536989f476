"""Hand-written Hopper kernels of the port (CUDA C++ for ``sm_90a``).

  neumann_inv     composed-precision SOI block inverse (INV)
  fused_precond   pooled two-sided WU product with the trust-region dot

Each has a plain PyTorch version in :mod:`ref`; :mod:`ops` dispatches by
device. The TPU kernels ``bitslice_mm``, ``fused_gram_inv`` and
``smw_update`` are not ported yet.
"""
