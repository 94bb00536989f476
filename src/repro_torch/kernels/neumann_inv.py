"""SOI block inverse on Hopper: wrapper of ``csrc/neumann_inv.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.neumann_inv`` (the
VMEM-resident composed-precision inverse). The CUDA kernel runs one
block per CTA with the whole iteration in shared memory and registers;
its source states what bounds it and how the design answers that.

Unlike the TPU kernel, blocks are inverted on n as given: the TPU
padded n to a multiple of 128 with an identity tail, which changes
``X0`` for blocks whose norms are below 1. The plain version is
:func:`repro_torch.kernels.ref.neumann_inv_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.ref import _damping_vector

#: largest block side the kernel takes (one CTA holds the block on chip)
MAX_N = 128

LIB = CudaLibrary("neumann_inv", "neumann_inv.cu", {
    "neumann_inv_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]})


def neumann_inv(a: torch.Tensor, damping, *, ns_iters: int,
                taylor_terms: int, refine_steps: int) -> torch.Tensor:
    """``(a + damping I)^{-1}`` of (nb, n, n) fp32 CUDA blocks, n <= 128,
    with per-block (nb,) or scalar damping."""
    if not a.is_cuda:
        raise ValueError(f"neumann_inv kernel needs a CUDA tensor, got "
                         f"{a.device}")
    if a.dtype != torch.float32:
        raise ValueError(f"neumann_inv kernel takes float32, got {a.dtype}")
    if a.ndim != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"neumann_inv takes (nb, n, n) blocks, got "
                         f"{tuple(a.shape)}")
    nb, n, _ = a.shape
    if n > MAX_N:
        raise ValueError(
            f"neumann_inv kernel takes blocks of n <= {MAX_N}, got n={n}; "
            f"use --block-size <= {MAX_N}")
    if not a.is_contiguous():
        raise ValueError("neumann_inv kernel needs a contiguous tensor")
    if min(ns_iters, taylor_terms, refine_steps) < 0:
        raise ValueError("iteration counts must be >= 0")
    lam = _damping_vector(damping, nb, a.device).contiguous()
    out = torch.empty_like(a)
    if nb == 0:
        return out
    with torch.cuda.device(a.device):
        LIB.launch("neumann_inv_launch", a.data_ptr(), lam.data_ptr(),
                   out.data_ptr(), nb, n, ns_iters, taylor_terms,
                   refine_steps,
                   torch.cuda.current_stream(a.device).cuda_stream)
    return out
