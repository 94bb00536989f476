"""Fused Gram accumulation and SOI block inverse on Hopper: wrapper of
``csrc/fused_gram_solve.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.fused_gram_solve``
(``fused_gram_inv``): per feature block of (T, nb, n) activations, the
hi/lo Gram ``a_i^T a_i / T`` accumulated on chip over the token tiles,
``lam_i = rel_damp * tr / n + 1e-8``, and the composed-precision inverse
of ``neumann_inv`` (the same device code), without the Gram ever going
to device memory. The CUDA source states what bounds it and how the
design answers that.

Unlike the TPU kernel, n is not padded to a multiple of 128 with a
``lam``-damped tail (the pad is block-diagonal with the same norms, so
the top-left inverse is the same) and T is not padded on the host. The
plain version is :func:`repro_torch.kernels.ref.fused_gram_inv_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaLibrary

#: largest block side the kernel takes (one CTA holds the block on chip)
MAX_N = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _I, _P]
#: input dtype -> C launch function
_ENTRY = {torch.float32: "fused_gram_inv_f32_launch",
          torch.bfloat16: "fused_gram_inv_bf16_launch"}

LIB = CudaLibrary("fused_gram_inv", "fused_gram_solve.cu",
                  {sym: _ARGS for sym in _ENTRY.values()})


def fused_gram_inv(a: torch.Tensor, *, rel_damp: float, ns_iters: int,
                   taylor_terms: int, refine_steps: int) -> torch.Tensor:
    """(nb, n, n) inverses of the damped per-block Grams of contiguous
    (T, nb, n) float32 or bfloat16 CUDA activations, n <= 128."""
    if not a.is_cuda:
        raise ValueError(f"fused_gram_inv kernel needs a CUDA tensor, got "
                         f"{a.device}")
    if a.dtype not in _ENTRY:
        raise ValueError(f"fused_gram_inv kernel takes float32 or bfloat16, "
                         f"got {a.dtype}")
    if a.ndim != 3:
        raise ValueError(f"fused_gram_inv takes (T, nb, n) activations, got "
                         f"{tuple(a.shape)}")
    t, nb, n = a.shape
    if n > MAX_N:
        raise ValueError(
            f"fused_gram_inv kernel takes blocks of n <= {MAX_N}, got n={n}; "
            f"larger blocks are queued (ROADMAP, Queue 2)")
    if not a.is_contiguous():
        raise ValueError("fused_gram_inv kernel needs a contiguous tensor")
    if t < 1:
        raise ValueError("fused_gram_inv needs at least one token")
    if min(ns_iters, taylor_terms, refine_steps) < 0:
        raise ValueError("iteration counts must be >= 0")
    out = torch.empty((nb, n, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        LIB.launch(_ENTRY[a.dtype], a.data_ptr(), out.data_ptr(), t, nb, n,
                   float(rel_damp), ns_iters, taylor_terms, refine_steps,
                   torch.cuda.current_stream(a.device).cuda_stream)
    return out
