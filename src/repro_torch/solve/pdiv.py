"""Divide-and-conquer inversion of oversized factor blocks (counterpart
of ``repro.solve.pdiv``, single device).

A block above the pool cap is split by the 2-way recursive block-Schur
identity, damping folded up front (``D = F + lam I``)::

    D = [[A11, A12], [A21, A22]]
    X11 = A11^-1            X22 = A22^-1                  (stage 1: a pair)
    S1  = A11 - A12 X22 A21 S2  = A22 - A21 X11 A12       (bridge)
    Y1  = S1^-1             Y2  = S2^-1                   (stage 2: a pair)
    D^-1 = [[Y1, -X11 A12 Y2], [-X22 A21 Y1, Y2]]

Each stage is a pair of independent inversions of half the size, so with
``depth`` levels every sub-inversion is of size ``n / 2^depth``: a block
of 256 at depth 1 runs on the ``neumann_inv`` kernel, which takes
``n <= 128``. The sub-inversions go through ``kfac.invert_blocks_flat``
at zero damping, the primitive every other path inverts with.

Unlike the reference, which inverts one block at a time, a call takes a
batch of blocks, and each stage inverts the pair's halves of every block
in one grouped call (the blocks are computed independently). The bridge
products are fp32 ``torch.matmul`` with TF32 off, as the reference's are
plain fp32 einsums. The reference's ``mesh`` spreads each stage's pair
over devices; the port has no mesh yet.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core.kfac import KFACConfig, invert_blocks_flat

__all__ = ["pdiv_invert"]


@contextlib.contextmanager
def _fp32_matmul():
    """Full-fp32 products for the block, whatever the caller's TF32
    setting."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _pair(p: torch.Tensor, q: torch.Tensor, cfg: KFACConfig, depth: int):
    """Invert two (B, h, h) batches as one batch of 2B blocks."""
    both = _pdiv_local(torch.cat([p, q]), cfg, depth)
    return both[:p.shape[0]], both[p.shape[0]:]


def _pdiv_local(d: torch.Tensor, cfg: KFACConfig, depth: int) -> torch.Tensor:
    """(B, n, n) damped blocks -> their inverses, ``depth`` levels down."""
    if depth <= 0:
        return invert_blocks_flat(
            d, torch.zeros(d.shape[0], dtype=d.dtype, device=d.device), cfg)
    n = d.shape[-1]
    if n % 2:
        raise ValueError(
            f"pdiv needs an even block size to split, got {n}; factor "
            "blocks from soi.block_size_for are powers of two")
    h = n // 2
    a11, a12 = d[:, :h, :h], d[:, :h, h:]
    a21, a22 = d[:, h:, :h], d[:, h:, h:]
    x11, x22 = _pair(a11, a22, cfg, depth - 1)
    u12 = torch.matmul(x11, a12)
    u21 = torch.matmul(x22, a21)
    s1 = a11 - torch.matmul(a12, u21)
    s2 = a22 - torch.matmul(a21, u12)
    y1, y2 = _pair(s1, s2, cfg, depth - 1)
    b12 = -torch.matmul(u12, y2)
    b21 = -torch.matmul(u21, y1)
    return torch.cat([torch.cat([y1, b12], dim=-1),
                      torch.cat([b21, y2], dim=-1)], dim=-2)


def pdiv_invert(block: torch.Tensor, lam, cfg: KFACConfig, *,
                depth: int = 1, mesh=None) -> torch.Tensor:
    """Invert damped ``(n, n)`` factor blocks, or a ``(B, n, n)`` batch
    of them, by recursive block-Schur.

    ``lam``: the Tikhonov shift, a scalar or one per block, folded in
    first, so every sub-problem is a plain inversion. ``depth=0`` is a
    single ``invert_blocks_flat`` call. ``mesh`` must be None: the
    distributed stage pairs wait for the multi-GPU port."""
    if mesh is not None:
        raise NotImplementedError(
            "pdiv_invert(mesh=...) spreads the stage pairs over devices; "
            "the port runs on one device (multi-GPU is ROADMAP Queue 1 "
            "item 8)")
    single = block.ndim == 2
    blocks = block[None] if single else block
    nb, n = blocks.shape[0], blocks.shape[-1]
    lam = torch.as_tensor(lam, dtype=torch.float32, device=blocks.device)
    lam = lam.reshape(-1).expand(nb) if lam.numel() == 1 else lam.reshape(nb)
    eye = torch.eye(n, dtype=torch.float32, device=blocks.device)
    d = blocks.to(torch.float32) + lam[:, None, None] * eye
    with _fp32_matmul():
        out = _pdiv_local(d, cfg, depth)
    return out[0] if single else out
