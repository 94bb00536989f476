"""Pooled two-sided WU on Hopper: wrapper of ``csrc/fused_precond.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.fused_precond``: per
gradient tile, ``out = hilo(hilo(A_inv, g), G_inv)`` with the
intermediate kept on chip, and the tile's trust-region dot
``sum(out * g)`` from the same pass. With index arrays the inverse
blocks are read from their pools (tile t uses ``a_inv[a_src[t]]`` and
``g_inv[g_src[t]]``), so the caller never gathers a copy per tile. The
CUDA source states what bounds it and how the design answers that. The
plain version is :func:`repro_torch.kernels.ref.fused_precond_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary

#: largest tile side the kernel takes
MAX_B = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("fused_precond", "fused_precond.cu", {
    "fused_precond_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]})


def check_indices(a_inv: torch.Tensor, g_inv: torch.Tensor, n: int,
                  a_src, g_src) -> None:
    """Raise unless ``a_src``/``g_src`` are both None or both int32 (n,)
    tensors on the operands' device. The range is checked only for CPU
    tensors: on the card that would read the indices back (a device
    sync), so callers check it where the indices are still on the host
    (``solve.partition.make_wu_plan``)."""
    if a_src is None and g_src is None:
        return
    if a_src is None or g_src is None:
        raise ValueError("fused_precond takes both a_src and g_src or "
                         "neither")
    for name, idx, pool in (("a_src", a_src, a_inv), ("g_src", g_src, g_inv)):
        if idx.dtype != torch.int32:
            raise ValueError(f"fused_precond {name} must be int32, got "
                             f"{idx.dtype}")
        if tuple(idx.shape) != (n,):
            raise ValueError(f"fused_precond {name} must have shape ({n},) "
                             f"(one index a tile), got {tuple(idx.shape)}")
        if idx.device != pool.device:
            raise ValueError(f"fused_precond {name} is on {idx.device}, its "
                             f"pool on {pool.device}")
        if idx.device.type == "cpu" and n and (
                int(idx.min()) < 0 or int(idx.max()) >= pool.shape[0]):
            raise ValueError(f"fused_precond {name} indexes outside its pool "
                             f"of {pool.shape[0]} blocks")


def fused_precond(a_inv: torch.Tensor, g: torch.Tensor, g_inv: torch.Tensor,
                  a_src: torch.Tensor | None = None,
                  g_src: torch.Tensor | None = None):
    """``(out, dots)`` for (N, bi, bo) fp32 CUDA gradient tiles, bi, bo <=
    128: (N, bi, bo) preconditioned tiles and (N,) per-tile
    ``sum(out * g)``. Without indices ``a_inv`` and ``g_inv`` are the
    per-tile (N, bi, bi) and (N, bo, bo) blocks; with int32 (N,)
    ``a_src``/``g_src`` they are pools (Ma, bi, bi) and (Mg, bo, bo),
    indexed per tile (any order, repeats allowed, in range)."""
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
    indexed = a_src is not None or g_src is not None
    na, ng = (a_inv.shape[0], g_inv.shape[0]) if indexed else (n, n)
    if tuple(a_inv.shape) != (na, bi, bi) or \
            tuple(g_inv.shape) != (ng, bo, bo):
        raise ValueError(
            f"fused_precond shapes disagree: a_inv {tuple(a_inv.shape)}, "
            f"g {tuple(g.shape)}, g_inv {tuple(g_inv.shape)}")
    if bi > MAX_B or bo > MAX_B:
        raise ValueError(f"fused_precond kernel takes tiles of at most "
                         f"{MAX_B} x {MAX_B}, got {bi} x {bo}")
    if not (a_inv.device == g.device == g_inv.device):
        raise ValueError("fused_precond operands are on different devices")
    check_indices(a_inv, g_inv, n, a_src, g_src)
    if indexed and not (a_src.is_contiguous() and g_src.is_contiguous()):
        raise ValueError("fused_precond kernel needs contiguous indices")
    out = torch.empty_like(g)
    dots = torch.empty((n,), dtype=torch.float32, device=g.device)
    if n == 0:
        return out, dots
    with torch.cuda.device(g.device):
        LIB.launch("fused_precond_launch", a_inv.data_ptr(), g.data_ptr(),
                   g_inv.data_ptr(),
                   a_src.data_ptr() if indexed else None,
                   g_src.data_ptr() if indexed else None,
                   out.data_ptr(), dots.data_ptr(), n, bi, bo,
                   torch.cuda.current_stream(g.device).cuda_stream)
    return out, dots
