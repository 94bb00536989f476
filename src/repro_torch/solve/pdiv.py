"""Divide-and-conquer inversion of oversized factor blocks (counterpart
of ``repro.solve.pdiv``).

A block above the pool cap is split by the 2-way recursive block-Schur
identity, damping folded up front (``D = F + lam I``)::

    D = [[A11, A12], [A21, A22]]
    X11 = A11^-1            X22 = A22^-1                  (stage 1: a pair)
    S1  = A11 - A12 X22 A21 S2  = A22 - A21 X11 A12       (bridge)
    Y1  = S1^-1             Y2  = S2^-1                   (stage 2: a pair)
    D^-1 = [[Y1, -X11 A12 Y2], [-X22 A21 Y1, Y2]]

Each stage is a pair of independent inversions of half the size, so with
``depth`` levels every sub-inversion is of size ``n / 2^depth``: a block
of 256 at depth 1 runs on ``neumann_inv``'s one-CTA route (``n <=
128``); without pdiv the kernel takes blocks up to 1024 whole, on its
large route. The sub-inversions go through ``kfac.invert_blocks_flat``
at zero damping, the primitive every other path inverts with.

Unlike the reference, which inverts one block at a time, a call takes a
batch of blocks, and each stage inverts the pair's halves of every block
in one grouped call (the blocks are computed independently). The bridge
products are fp32 ``torch.matmul`` with TF32 off, as the reference's are
plain fp32 einsums. With a ``mesh`` the top level's stage pairs are
spread over its ranks, as in the reference: the pair's two members go to
the ranks at flat-mesh positions 0 and 1, the others invert an identity
pad of the same shape, and one gather brings both back; the levels below
run locally on each rank. The result is bitwise the local run's on the
CPU (each sub-inversion and each product is computed per block).
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core.kfac import KFACConfig, invert_blocks_flat
from repro_torch.dist.api import all_gather_rows, mesh_ndev, mesh_position

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


def _dist_pair(mesh):
    """A stage runner spreading a pair over the mesh: the rank at flat
    position 0 inverts ``p``, the one at 1 ``q``, every other rank an
    identity pad, each with the local recursion; one gather."""
    pos = mesh_position(mesh)

    def run(p: torch.Tensor, q: torch.Tensor, cfg: KFACConfig, depth: int):
        if pos < 2:
            mine = (p, q)[pos]
        else:
            mine = torch.eye(p.shape[-1], dtype=p.dtype,
                             device=p.device).expand_as(p)
        inv = _pdiv_local(mine.contiguous(), cfg, depth)
        got = all_gather_rows(inv[None], mesh)
        return got[0], got[1]

    return run


def _schur(d: torch.Tensor, cfg: KFACConfig, depth: int, run_pair):
    """One block-Schur level of (B, n, n) damped blocks; ``run_pair(p, q,
    cfg, depth - 1)`` inverts the two halves of each stage."""
    n = d.shape[-1]
    if n % 2:
        raise ValueError(
            f"pdiv needs an even block size to split, got {n}; factor "
            "blocks from soi.block_size_for are powers of two")
    h = n // 2
    a11, a12 = d[:, :h, :h], d[:, :h, h:]
    a21, a22 = d[:, h:, :h], d[:, h:, h:]
    x11, x22 = run_pair(a11, a22, cfg, depth - 1)
    u12 = torch.matmul(x11, a12)
    u21 = torch.matmul(x22, a21)
    s1 = a11 - torch.matmul(a12, u21)
    s2 = a22 - torch.matmul(a21, u12)
    y1, y2 = run_pair(s1, s2, cfg, depth - 1)
    b12 = -torch.matmul(u12, y2)
    b21 = -torch.matmul(u21, y1)
    return torch.cat([torch.cat([y1, b12], dim=-1),
                      torch.cat([b21, y2], dim=-1)], dim=-2)


def _pdiv_local(d: torch.Tensor, cfg: KFACConfig, depth: int) -> torch.Tensor:
    """(B, n, n) damped blocks -> their inverses, ``depth`` levels down."""
    if depth <= 0:
        return invert_blocks_flat(
            d, torch.zeros(d.shape[0], dtype=d.dtype, device=d.device), cfg)
    return _schur(d, cfg, depth, _pair)


def pdiv_invert(block: torch.Tensor, lam, cfg: KFACConfig, *,
                depth: int = 1, mesh=None) -> torch.Tensor:
    """Invert damped ``(n, n)`` factor blocks, or a ``(B, n, n)`` batch
    of them, by recursive block-Schur.

    ``lam``: the Tikhonov shift, a scalar or one per block, folded in
    first, so every sub-problem is a plain inversion. ``depth=0`` is a
    single ``invert_blocks_flat`` call. ``mesh``: a DeviceMesh whose
    ranks all call with the same blocks; the top level's stage pairs are
    spread over it (a mesh of one rank runs locally)."""
    single = block.ndim == 2
    blocks = block[None] if single else block
    nb, n = blocks.shape[0], blocks.shape[-1]
    lam = torch.as_tensor(lam, dtype=torch.float32, device=blocks.device)
    lam = lam.reshape(-1).expand(nb) if lam.numel() == 1 else lam.reshape(nb)
    eye = torch.eye(n, dtype=torch.float32, device=blocks.device)
    d = blocks.to(torch.float32) + lam[:, None, None] * eye
    with _fp32_matmul():
        if mesh is None or mesh_ndev(mesh) <= 1 or depth <= 0:
            out = _pdiv_local(d, cfg, depth)
        else:
            out = _schur(d, cfg, depth, _dist_pair(mesh))
    return out[0] if single else out
