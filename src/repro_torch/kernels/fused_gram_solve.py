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
  here on the launches' stream: one batched hi/lo product of
  ``csrc/hilo_bmm.cuh`` (the activations read transposed, bf16 as they
  are), a finish kernel (``/ T``, the damping), then ``neumann_inv``'s
  large route on the chunk, writing the output.

The CUDA source states what bounds it and how the design answers that.

Unlike the TPU kernel, n is not padded to a multiple of 128 with a
``lam``-damped tail (the pad is block-diagonal with the same norms, so
the top-left inverse is the same) and T is not padded on the host. The
plain version is :func:`repro_torch.kernels.ref.fused_gram_inv_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import hilo_bmm
from repro_torch.kernels import neumann_inv as _neumann_inv
from repro_torch.kernels.build import CudaLibrary

#: largest block side the kernels take (the reference's limit)
MAX_N = hilo_bmm.MAX_SIDE
#: largest block side of the one-CTA route (one CTA holds the block)
ONE_CTA_N = 128
#: launches of one large-route chunk of this library: the Gram product and
#: the finish kernel (``neumann_inv``'s launches come on top)
LARGE_LAUNCHES = 2

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _I, _I, _I, _F, _I, _I, _I, _P]
#: input dtype -> C launch function
_ENTRY = {torch.float32: "fused_gram_inv_f32_launch",
          torch.bfloat16: "fused_gram_inv_bf16_launch"}

LIB = CudaLibrary("fused_gram_inv", "fused_gram_solve.cu", {
    **{sym: _ARGS for sym in _ENTRY.values()},
    "fused_gram_inv_gram": [ctypes.POINTER(hilo_bmm.Params), _I, _P],
    "fused_gram_inv_finish": [_P, _P, _I, _I, _I, _F, _P]})


def gram_plan(nb: int, n: int,
              budget: int = hilo_bmm.WORKSPACE_BYTES) -> list:
    """The large route's ``(b0, b1)`` chunks of blocks: each chunk's
    Grams ((chunk, n, n) fp32) and dampings stay under ``budget``
    (``neumann_inv``'s own chunks come on top)."""
    return hilo_bmm.chunks(nb, 4 * (n * n + 1), budget)


def expected_launches(nb: int, n: int, *, ns_iters: int, taylor_terms: int,
                      refine_steps: int) -> dict:
    """Launches of one :func:`fused_gram_inv` call on ``nb`` blocks of
    side ``n``, by library: this one's and ``neumann_inv``'s."""
    if nb == 0:
        return {"fused_gram_inv": 0, "neumann_inv": 0}
    if n <= ONE_CTA_N:
        return {"fused_gram_inv": 1, "neumann_inv": 0}
    parts = gram_plan(nb, n)
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
    """The large route, chunk by chunk on ``stream``: the chunk's Grams
    and dampings into a workspace allocated on it (the current stream),
    then ``neumann_inv``'s large route into ``out``."""
    t, nb, n = a.shape
    parts = gram_plan(nb, n)
    most = max(b1 - b0 for b0, b1 in parts)
    ws = torch.empty(most * (n * n + 1), dtype=torch.float32,
                     device=a.device)
    key = f"n{n}"
    for b0, b1 in parts:
        cb = b1 - b0
        gram = ws[:cb * n * n].view(cb, n, n)
        lam = ws[most * n * n:most * n * n + cb]
        # block i at a + i n, rows (tokens) nb n apart: read transposed on
        # the left (n x T), as it is on the right (T x n)
        act = hilo_bmm.operand(hilo_bmm.elem_ptr(a, b0 * n), n, nb * n)
        p = hilo_bmm.params(act, act, gram.data_ptr(), n * n, n, n, n, t,
                            cb)
        LIB.launch("fused_gram_inv_gram", ctypes.byref(p),
                   int(a.dtype == torch.bfloat16), stream, key=key)
        LIB.launch("fused_gram_inv_finish", gram.data_ptr(), lam.data_ptr(),
                   cb, n, t, rel_damp, stream, key=key)
        _neumann_inv.neumann_inv_grouped([gram], [lam], out=[out[b0:b1]],
                                         **counts)
