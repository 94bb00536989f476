"""Rank-k SMW inverse update on Hopper: wrapper of ``csrc/smw_update.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.smw_update``: per block,
``M = sym(inv)/decay``, ``Y = V M`` and ``S = Y V^T + I/c`` (pass 1), a
batched k x k ``torch.linalg.solve_ex`` for ``Z = S^-1 Y`` between the
passes (the TPU program solves between its two ``pallas_call``s the
same way), and ``out = M - Y^T Z`` (pass 2), every product hi/lo
bit-sliced. The CUDA source states what bounds it and how the design
answers that.

Unlike the TPU kernel, k and bs are not padded to 128, and pass 2
rebuilds ``M`` from ``inv`` instead of reading it back. The plain
version is :func:`repro_torch.kernels.ref.smw_update_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.ref import smw_scalars

#: largest block side and rank the kernel takes (one CTA holds a block)
MAX_N = 128

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary("smw_update", "smw_update.cu", {
    "smw_update_stats_launch": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _P],
    "smw_update_apply_launch": [_P, _P, _P, _P, _I, _I, _I, _F, _P]})


def _check(inv: torch.Tensor, v: torch.Tensor, v_name: str = "v") -> None:
    for name, t in (("inv", inv), (v_name, v)):
        if not t.is_cuda:
            raise ValueError(f"smw_update kernel needs CUDA tensors; {name} "
                             f"is on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"smw_update kernel takes float32; {name} is "
                             f"{t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"smw_update takes 3-d block stacks; {name} "
                             f"has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"smw_update kernel needs contiguous tensors; "
                             f"{name} is not")
    n, k, bs = v.shape
    if tuple(inv.shape) != (n, bs, bs):
        raise ValueError(f"smw_update shapes disagree: inv "
                         f"{tuple(inv.shape)}, v {tuple(v.shape)}")
    if not 1 <= bs <= MAX_N or not 1 <= k <= MAX_N:
        raise ValueError(
            f"smw_update kernel takes 1 <= bs, k <= {MAX_N}, got bs={bs}, "
            f"k={k}; use --block-size and --smw-rank <= {MAX_N}")
    if inv.device != v.device:
        raise ValueError("smw_update operands are on different devices")


def smw_stats(inv: torch.Tensor, v: torch.Tensor, *, decay: float,
              cscale: float):
    """Pass 1: ``(Y, S + I/c)``, (N, k, bs) and (N, k, k)."""
    _check(inv, v)
    n, k, bs = v.shape
    inv_decay, inv_c = smw_scalars(decay, cscale)
    y = torch.empty_like(v)
    s = torch.empty((n, k, k), dtype=torch.float32, device=v.device)
    if n:
        with torch.cuda.device(v.device):
            LIB.launch("smw_update_stats_launch", inv.data_ptr(),
                       v.data_ptr(), y.data_ptr(), s.data_ptr(), n, bs, k,
                       inv_decay, inv_c,
                       torch.cuda.current_stream(v.device).cuda_stream)
    return y, s


def smw_apply(inv: torch.Tensor, y: torch.Tensor, z: torch.Tensor, *,
              decay: float) -> torch.Tensor:
    """Pass 2: ``M - Y^T Z``, (N, bs, bs)."""
    if z.shape != y.shape:
        raise ValueError(f"smw_update: z {tuple(z.shape)} does not match "
                         f"y {tuple(y.shape)}")
    _check(inv, y, "y")
    _check(inv, z, "z")
    n, k, bs = y.shape
    inv_decay, _ = smw_scalars(decay, 1.0)
    out = torch.empty_like(inv)
    if n:
        with torch.cuda.device(inv.device):
            LIB.launch("smw_update_apply_launch", inv.data_ptr(),
                       y.data_ptr(), z.data_ptr(), out.data_ptr(), n, bs, k,
                       inv_decay,
                       torch.cuda.current_stream(inv.device).cuda_stream)
    return out


def smw_update(inv: torch.Tensor, v: torch.Tensor, *, decay: float,
               cscale: float) -> torch.Tensor:
    """(N, bs, bs) updated inverses of ``decay * F + cscale * V^T V``
    from the cached (N, bs, bs) fp32 CUDA inverses of ``F`` and the
    (N, k, bs) columns ``V``, bs, k <= 128. One call counts as two
    launches of the kernel, one per pass."""
    y, s = smw_stats(inv, v, decay=decay, cscale=cscale)
    # the batched solve returns each block column-major
    z = torch.linalg.solve_ex(s, y)[0].contiguous()
    return smw_apply(inv, y, z, decay=decay)
