"""Pooled two-sided WU on Hopper: wrapper of ``csrc/fused_precond.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.fused_precond``: per
gradient tile, ``out = hilo(hilo(A_inv, g), G_inv)`` with the
intermediate kept on chip, and the tile's trust-region dot
``sum(out * g)`` from the same pass. The CUDA source states what
bounds it and how the design answers that. The plain version is
:func:`repro_torch.kernels.ref.fused_precond_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary

#: largest tile side the kernel takes
MAX_B = 128

LIB = CudaLibrary("fused_precond", "fused_precond.cu", {
    "fused_precond_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]})


def fused_precond(a_inv: torch.Tensor, g: torch.Tensor,
                  g_inv: torch.Tensor):
    """``(out, dots)`` for (N, bi, bi), (N, bi, bo), (N, bo, bo) fp32
    CUDA tiles, bi, bo <= 128: (N, bi, bo) preconditioned tiles and
    (N,) per-tile ``sum(out * g)``."""
    for name, t in (("a_inv", a_inv), ("g", g), ("g_inv", g_inv)):
        if not t.is_cuda:
            raise ValueError(f"fused_precond kernel needs CUDA tensors; "
                             f"{name} is on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"fused_precond kernel takes float32; {name} "
                             f"is {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"fused_precond takes 3-d tile stacks; {name} "
                             f"has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_precond kernel needs contiguous "
                             f"tensors; {name} is not")
    n, bi, bo = g.shape
    if tuple(a_inv.shape) != (n, bi, bi) or tuple(g_inv.shape) != (n, bo, bo):
        raise ValueError(
            f"fused_precond shapes disagree: a_inv {tuple(a_inv.shape)}, "
            f"g {tuple(g.shape)}, g_inv {tuple(g_inv.shape)}")
    if bi > MAX_B or bo > MAX_B:
        raise ValueError(f"fused_precond kernel takes tiles of at most "
                         f"{MAX_B} x {MAX_B}, got {bi} x {bo}")
    if not (a_inv.device == g.device == g_inv.device):
        raise ValueError("fused_precond operands are on different devices")
    out = torch.empty_like(g)
    dots = torch.empty((n,), dtype=torch.float32, device=g.device)
    if n == 0:
        return out, dots
    with torch.cuda.device(g.device):
        LIB.launch("fused_precond_launch", a_inv.data_ptr(), g.data_ptr(),
                   g_inv.data_ptr(), out.data_ptr(), dots.data_ptr(), n,
                   bi, bo, torch.cuda.current_stream(g.device).cuda_stream)
    return out, dots
