"""Public kernel entry points: dispatch by the tensors' device.

A tensor on the CPU takes the kernel's plain PyTorch version
(:mod:`repro_torch.kernels.ref`); a CUDA tensor launches the hand-written
Hopper kernel (built at first use, :mod:`repro_torch.kernels.build`) or
raises. There is no fallback from the card to the plain version.

This is the wiring ``repro.kernels.ops`` describes for the TPU: the
K-FAC INV stage (``core.kfac.invert_blocks_grouped``) inverts every
factor leaf through one :func:`neumann_inv_grouped` call (one launch a
block side up to 128, the large route's sequence above), the pooled WU
stage
(``core.kfac.precondition_pooled``) runs :func:`fused_precond`, the
incremental SOI refresh (``solve.smw.smw_update_flat`` with
``SMWConfig.use_kernel``) updates through :func:`smw_update` (one launch a
call up to 128, the large route's sequence above), and the
composed-precision inversion library applies its inverses with
:func:`bitslice_mm` (``core.precision_inv.mxu_inv_apply``) and inverts
fresh activation Grams with :func:`fused_gram_inv`, which callers reach
here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bitslice_mm as _bitslice_mm
from repro_torch.kernels import build, ref
from repro_torch.kernels import fused_gram_solve as _fused_gram_solve
from repro_torch.kernels import fused_precond as _fused_precond
from repro_torch.kernels import neumann_inv as _neumann_inv
from repro_torch.kernels import smw_update as _smw_update

__all__ = ["neumann_inv", "neumann_inv_grouped", "fused_precond",
           "smw_update", "bitslice_mm", "fused_gram_inv", "LIBRARIES",
           "build_all", "launch_counts", "launch_streams", "launch_keys",
           "launch_items", "reset_launch_counts"]

#: kernel name -> its CUDA library (launch counters live on these)
LIBRARIES = {
    "neumann_inv": _neumann_inv.LIB,
    "fused_precond": _fused_precond.LIB,
    "smw_update": _smw_update.LIB,
    "bitslice_mm": _bitslice_mm.LIB,
    "fused_gram_inv": _fused_gram_solve.LIB,
}


def _route(*tensors: torch.Tensor) -> str:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"kernel operands must all be on the CPU or all on "
                     f"CUDA, got {sorted(kinds)}")


def neumann_inv(a: torch.Tensor, damping, *, ns_iters: int = 14,
                taylor_terms: int = 4, refine_steps: int = 1) -> torch.Tensor:
    """Composed-precision inverse of ``a + damping I``, (nb, n, n)."""
    kw = dict(ns_iters=ns_iters, taylor_terms=taylor_terms,
              refine_steps=refine_steps)
    if _route(a) == "cpu":
        return ref.neumann_inv_ref(a, damping, **kw)
    return _neumann_inv.neumann_inv(a, damping, **kw)


def neumann_inv_grouped(blocks, dampings, *, ns_iters: int = 14,
                        taylor_terms: int = 4, refine_steps: int = 1,
                        out=None) -> list:
    """:func:`neumann_inv` of each (nb_i, n_i, n_i) leaf with its (nb_i,)
    or scalar damping: on CUDA one launch for each block side up to 128
    (up to 32 leaves a launch) and the large route's launches above
    (``kernels.neumann_inv.expected_launches``), each block computed as
    in a call on its leaf alone. ``out``: one preallocated contiguous fp32 buffer per leaf,
    shaped like it, that receives the inverses and is returned (a
    refresh writes into the inverse tree it retires)."""
    if len(blocks) != len(dampings):
        raise ValueError(f"{len(blocks)} leaves but {len(dampings)} "
                         f"dampings")
    if out is not None and len(out) != len(blocks):
        raise ValueError(f"{len(blocks)} leaves but {len(out)} outputs")
    if not blocks:
        return []
    kw = dict(ns_iters=ns_iters, taylor_terms=taylor_terms,
              refine_steps=refine_steps)
    if _route(*blocks) == "cpu":
        invs = [ref.neumann_inv_ref(a, d, **kw)
                for a, d in zip(blocks, dampings)]
        if out is None:
            return invs
        _neumann_inv.check_out(blocks, out)
        for o, inv in zip(out, invs):
            o.copy_(inv)
        return list(out)
    return _neumann_inv.neumann_inv_grouped(blocks, dampings, out=out, **kw)


def fused_precond(a_inv: torch.Tensor, g: torch.Tensor,
                  g_inv: torch.Tensor, a_src: torch.Tensor | None = None,
                  g_src: torch.Tensor | None = None):
    """Pooled ``A_inv @ g @ G_inv`` (hi/lo) and per-tile TR dots; with
    int32 ``a_src``/``g_src`` the inverses are pools indexed per tile."""
    if _route(a_inv, g, g_inv) == "cpu":
        _fused_precond.check_indices(a_inv, g_inv, g.shape[0], a_src, g_src)
        return ref.fused_precond_ref(a_inv, g, g_inv, a_src, g_src)
    return _fused_precond.fused_precond(a_inv, g, g_inv, a_src, g_src)


def smw_update(inv: torch.Tensor, v: torch.Tensor, *, decay: float,
               cscale: float) -> torch.Tensor:
    """Rank-k Woodbury update of (N, bs, bs) cached inverses with
    (N, k, bs) columns: inverses of ``decay * F + cscale * V^T V``, bs
    and k up to 1024 (the reference's limit): on CUDA one launch a call
    up to 128, the large route's launches above
    (``kernels.smw_update.expected_launches``)."""
    if _route(inv, v) == "cpu":
        return ref.smw_update_ref(inv, v, decay=decay, cscale=cscale)
    return _smw_update.smw_update(inv, v, decay=decay, cscale=cscale)


def bitslice_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32-accurate ``a @ b`` of (M, K) and (K, N) matrices from three
    hi/lo bf16 partial products (fp32, fp16 or bf16 inputs)."""
    if _route(a, b) == "cpu":
        return ref.bitslice_mm_ref(a, b)
    return _bitslice_mm.bitslice_mm(a, b)


def fused_gram_inv(a: torch.Tensor, *, rel_damp: float = 0.03,
                   ns_iters: int = 14, taylor_terms: int = 4,
                   refine_steps: int = 1) -> torch.Tensor:
    """(nb, n, n) inverses of ``a_i^T a_i / T + lam_i I`` for (T, nb, n)
    activations, ``lam_i = rel_damp * tr / n + 1e-8``, the Gram formed
    from hi/lo partial products, n up to 1024: on CUDA up to 128 one
    launch that never stores the Gram; above, the Gram in a workspace and
    ``neumann_inv``'s large route
    (``kernels.fused_gram_solve.expected_launches``)."""
    kw = dict(rel_damp=rel_damp, ns_iters=ns_iters,
              taylor_terms=taylor_terms, refine_steps=refine_steps)
    if _route(a) == "cpu":
        return ref.fused_gram_inv_ref(a, **kw)
    return _fused_gram_solve.fused_gram_inv(a, **kw)


def build_all() -> float:
    """Build every kernel now (in parallel); returns the wall seconds."""
    return build.build_all(list(LIBRARIES.values()))


def launch_counts() -> dict:
    return {name: lib.launches for name, lib in LIBRARIES.items()}


def launch_streams() -> dict:
    """kernel name -> {CUDA stream handle: launches on it}."""
    return {name: dict(lib.stream_launches)
            for name, lib in LIBRARIES.items()}


def launch_keys() -> dict:
    """kernel name -> {label: launches}: ``neumann_inv`` and
    ``fused_gram_inv`` by block side (``"n256"``), ``fused_precond`` by
    tile shape (``"256x176"``), ``smw_update`` by block side and rank
    (``"bs256k64"``)."""
    return {name: dict(lib.key_launches) for name, lib in LIBRARIES.items()}


def launch_items() -> dict:
    """kernel name -> {label: items its launches covered}: ``neumann_inv``
    the blocks it inverted, by block side (``"n128"``)."""
    return {name: dict(lib.key_items) for name, lib in LIBRARIES.items()}


def reset_launch_counts() -> None:
    for lib in LIBRARIES.values():
        lib.launches = 0
        lib.stream_launches.clear()
        lib.key_launches.clear()
        lib.key_items.clear()
