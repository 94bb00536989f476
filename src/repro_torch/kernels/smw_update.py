"""Rank-k SMW inverse update on Hopper: wrapper of ``csrc/smw_update.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.smw_update``: per block,
``M = sym(inv)/decay``, ``Y = V M``, ``S = Y V^T + I/c``, ``Z = S^-1 Y``
and ``out = M - Y^T Z``, every product hi/lo bit-sliced, in one launch:
the TPU program solves the k x k system between its two
``pallas_call``s, the CUDA kernel inside the CTA (LU with partial
pivoting in fp32), so Y, S and Z never cross device memory. The CUDA
source states what bounds it and how the design answers that.

Unlike the TPU kernel, k and bs are not padded to 128. The plain
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
    "smw_update_launch": [_P, _P, _P, _I, _I, _I, _F, _F, _P]})


def _check(inv: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("inv", inv), ("v", v)):
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


def smw_update(inv: torch.Tensor, v: torch.Tensor, *, decay: float,
               cscale: float) -> torch.Tensor:
    """(N, bs, bs) updated inverses of ``decay * F + cscale * V^T V``
    from the cached (N, bs, bs) fp32 CUDA inverses of ``F`` and the
    (N, k, bs) columns ``V``, bs, k <= 128; one launch. A singular
    capacitance gives non-finite blocks (no host check, no sync)."""
    _check(inv, v)
    n, k, bs = v.shape
    inv_decay, inv_c = smw_scalars(decay, cscale)
    out = torch.empty_like(inv)
    if n:
        with torch.cuda.device(v.device):
            LIB.launch("smw_update_launch", inv.data_ptr(), v.data_ptr(),
                       out.data_ptr(), n, bs, k, inv_decay, inv_c,
                       torch.cuda.current_stream(v.device).cuda_stream)
    return out
