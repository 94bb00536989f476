"""Fused Gram accumulation and SOI block inverse on Hopper: wrapper of
``csrc/fused_gram_solve.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.fused_gram_solve``
(``fused_gram_inv``) on its whole domain, n <= 1024: per feature block
of (T, nb, n) activations, the hi/lo Gram ``a_i^T a_i / T``,
``lam_i = rel_damp * tr / n + 1e-8``, and the composed-precision inverse
of ``neumann_inv``. Two routes:

* n <= :data:`ONE_CTA_N` (128): one CTA a block and one launch a call,
  the Gram accumulated on chip over the token tiles and inverted there
  (the same device code as ``neumann_inv``), never going to device
  memory.
* n of 129..:data:`MAX_N` (1024): the Gram no longer fits a CTA, so per
  chunk of blocks (:func:`gram_plan`) it goes to a workspace allocated
  here on the launches' stream: a split kernel stores each block's (T,
  n) activations as bf16 slices (hi and lo of fp32, hi alone of bf16),
  one batched hi/lo product on TMA and wgmma (``csrc/hilo_tma.cuh``,
  the left operand read as stored, T x n, depth T; three partials, or
  one for bf16), a finish kernel (``/ T``, the damping), then
  ``neumann_inv``'s large route on the chunk, writing the output.

The CUDA source states what bounds it and how the design answers that.

Unlike the TPU kernel, n is not padded to a multiple of 128 with a
``lam``-damped tail (the pad is block-diagonal with the same norms, so
the top-left inverse is the same) and T is not padded on the host. The
plain version is :func:`repro_torch.kernels.ref.fused_gram_inv_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import hilo_tma
from repro_torch.kernels import neumann_inv as _neumann_inv
from repro_torch.kernels.build import CudaLibrary

#: largest block side the kernels take (the reference's limit)
MAX_N = hilo_tma.MAX_SIDE
#: largest block side of the one-CTA route (one CTA holds the block)
ONE_CTA_N = 128
#: launches of one large-route chunk of this library: the activations'
#: split, the Gram product and the finish kernel (``neumann_inv``'s
#: launches come on top)
LARGE_LAUNCHES = 3

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_ARGS = [_P, _P, _I, _I, _I, _F, _I, _I, _I, _P]
#: input dtype -> C launch function
_ENTRY = {torch.float32: "fused_gram_inv_f32_launch",
          torch.bfloat16: "fused_gram_inv_bf16_launch"}

LIB = CudaLibrary("fused_gram_inv", "fused_gram_solve.cu", {
    **{sym: _ARGS for sym in _ENTRY.values()},
    "fused_gram_inv_split": [_P, _I, _L, _I, _I, _L, _L, _P, _P, _I, _P],
    "fused_gram_inv_gram": [ctypes.POINTER(hilo_tma.Params), _P],
    "fused_gram_inv_finish": [_P, _P, _I, _I, _I, _F, _P]})


def slices_of(dtype: torch.dtype) -> int:
    """Slices an activation is stored in: hi and lo of fp32, hi alone of
    bf16 (exact; its lo is zero)."""
    return 1 if dtype == torch.bfloat16 else 2


def block_bytes(t: int, n: int, slices: int) -> int:
    """Workspace bytes of one block on the large route: its activations'
    slices (T rows ``hilo_tma.slice_stride(n)`` apart), its fp32 Gram and
    its damping."""
    return 2 * slices * t * hilo_tma.slice_stride(n) + 4 * (n * n + 1)


def gram_plan(nb: int, n: int, t: int, slices: int,
              budget: int = hilo_tma.WORKSPACE_BYTES) -> list:
    """The large route's ``(b0, b1)`` chunks of blocks: each chunk's
    workspace (:func:`block_bytes` a block) stays under ``budget``
    (``neumann_inv``'s own chunks come on top)."""
    return hilo_tma.chunks(nb, block_bytes(t, n, slices), budget)


def expected_launches(shape, dtype: torch.dtype, *, ns_iters: int,
                      taylor_terms: int, refine_steps: int) -> dict:
    """Launches of one :func:`fused_gram_inv` call on activations of
    ``shape`` (T, nb, n) and ``dtype``, by library: this one's and
    ``neumann_inv``'s."""
    t, nb, n = shape
    if nb == 0:
        return {"fused_gram_inv": 0, "neumann_inv": 0}
    if n <= ONE_CTA_N:
        return {"fused_gram_inv": 1, "neumann_inv": 0}
    parts = gram_plan(nb, n, t, slices_of(dtype))
    return {"fused_gram_inv": LARGE_LAUNCHES * len(parts),
            "neumann_inv": sum(_neumann_inv.expected_launches(
                {n: [b1 - b0]}, ns_iters, taylor_terms, refine_steps)
                for b0, b1 in parts)}


def fused_gram_inv(a: torch.Tensor, *, rel_damp: float, ns_iters: int,
                   taylor_terms: int, refine_steps: int) -> torch.Tensor:
    """(nb, n, n) inverses of the damped per-block Grams of contiguous
    (T, nb, n) float32 or bfloat16 CUDA activations, n <= 1024, on the
    current stream: one launch up to 128, the large route's above
    (:func:`expected_launches`)."""
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
            f"fused_gram_inv kernel takes blocks of n <= {MAX_N} (the "
            f"reference's limit), got n={n}")
    if not a.is_contiguous():
        raise ValueError("fused_gram_inv kernel needs a contiguous tensor")
    if t < 1:
        raise ValueError("fused_gram_inv needs at least one token")
    if n > ONE_CTA_N and t > hilo_tma.MAX_DEPTH:
        raise ValueError(f"fused_gram_inv kernel takes at most "
                         f"{hilo_tma.MAX_DEPTH} tokens above n = "
                         f"{ONE_CTA_N}, got {t}")
    if min(ns_iters, taylor_terms, refine_steps) < 0:
        raise ValueError("iteration counts must be >= 0")
    out = torch.empty((nb, n, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if n <= ONE_CTA_N:
            LIB.launch(_ENTRY[a.dtype], a.data_ptr(), out.data_ptr(), t, nb,
                       n, float(rel_damp), ns_iters, taylor_terms,
                       refine_steps, stream, key=f"n{n}")
        else:
            _large(a, out, float(rel_damp),
                   dict(ns_iters=ns_iters, taylor_terms=taylor_terms,
                        refine_steps=refine_steps), stream)
    return out


def _large(a, out, rel_damp: float, counts: dict, stream) -> None:
    """The large route, chunk by chunk on ``stream``: the chunk's
    activations split into slices, its Grams and dampings into a
    workspace allocated on it (the current stream), then
    ``neumann_inv``'s large route into ``out``."""
    t, nb, n = a.shape
    bf16 = a.dtype == torch.bfloat16
    slices = slices_of(a.dtype)
    parts = gram_plan(nb, n, t, slices)
    most = max(b1 - b0 for b0, b1 in parts)
    ss = hilo_tma.slice_stride(n)
    # the slices first (each array a multiple of 16 bytes), then the Grams
    # and the dampings
    ws = torch.empty(most * block_bytes(t, n, slices), dtype=torch.uint8,
                     device=a.device)
    hi = ws.data_ptr()
    lo = hi + 2 * most * t * ss if not bf16 else None
    g0 = 2 * slices * most * t * ss
    key = f"n{n}"
    for b0, b1 in parts:
        cb = b1 - b0
        gram = ws[g0:g0 + 4 * cb * n * n].view(torch.float32).view(cb, n, n)
        lam = ws[g0 + 4 * most * n * n:g0 + 4 * (most * n * n + cb)].view(
            torch.float32)
        # block i's token t at a + (t nb + i) n: bstride n, rows nb n apart
        LIB.launch("fused_gram_inv_split", hilo_tma.elem_ptr(a, b0 * n),
                   int(bf16), cb, t, n, n, nb * n, hi, lo, ss, stream,
                   key=key)
        p = hilo_tma.Params(hi, lo, hi, lo, None,
                            hilo_tma.Out(gram.data_ptr(), None, None),
                            hilo_tma.Out(), n, n, ss, cb, hilo_tma.STORE)
        p.m, p.k, p.l_ld16, p.r_ld16 = n, t, ss, ss
        p.l_blocks = p.r_blocks = cb
        p.l_t = 1
        LIB.launch("fused_gram_inv_gram", ctypes.byref(p), stream, key=key)
        LIB.launch("fused_gram_inv_finish", gram.data_ptr(), lam.data_ptr(),
                   cb, n, t, rel_damp, stream, key=key)
        _neumann_inv.neumann_inv_grouped([gram], [lam], out=[out[b0:b1]],
                                         **counts)
