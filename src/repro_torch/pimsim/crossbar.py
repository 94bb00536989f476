"""Crossbar-level cycle models (paper Eqn. 10 / 14 and the ISAAC-style
bit-serial VMM pipeline)."""

from __future__ import annotations

import math

from repro_torch.pimsim.arch import RePASTConfig


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def vmm_cycles(cfg: RePASTConfig, q_in: int | None = None) -> int:
    """Cycles for one vector pass through a VMM crossbar group: inputs are
    bit-serial at DAC resolution (matrix bit-slices run in parallel
    crossbars; partial sums merge in the S+A units)."""
    q_in = cfg.q_bits if q_in is None else q_in
    return ceil_div(q_in, cfg.dac_bits)


def inv_cycles(cfg: RePASTConfig) -> int:
    """Paper Eqn. 10: one high-precision matrix-inversion *vector* solve.

    N (2 ceil(Qb/Rdac) ceil(Qx/Radc) + ceil(Qx/Rdac))
    """
    loops_b = ceil_div(cfg.q_bits, cfg.dac_bits)
    loops_x = ceil_div(cfg.q_bits, cfg.adc_bits)
    return cfg.n_taylor * (2 * loops_b * loops_x
                           + ceil_div(cfg.q_bits, cfg.dac_bits))


def inv_fused_cycles(cfg: RePASTConfig) -> int:
    """Paper Eqn. 14: fused MM+INV variant (one extra VMM per Loop-A
    iteration for the second Eqn.-13 term)."""
    loops_b = ceil_div(cfg.q_bits, cfg.dac_bits)
    loops_x = ceil_div(cfg.q_bits, cfg.adc_bits)
    return cfg.n_taylor * (2 * loops_b * loops_x
                           + 2 * ceil_div(cfg.q_bits, cfg.dac_bits))


def xbars_for_matrix(cfg: RePASTConfig, m: int, n: int) -> int:
    """Crossbars needed to hold an m x n matrix at Q_A bits (bit slices
    across cells within a crossbar pair; sign handled differentially)."""
    per_xbar = cfg.xbar
    slices = ceil_div(cfg.q_bits, cfg.cell_bits) // 2  # hi-half on INV side
    return ceil_div(m, per_xbar) * ceil_div(n, per_xbar) * max(slices, 1)


def inv_group_xbars(cfg: RePASTConfig, block: int) -> int:
    """INV crossbars combined for a block x block inversion (Sec. IV-A)."""
    g = ceil_div(block, cfg.xbar)
    return g * g


def write_cycles(cfg: RePASTConfig, m: int, n: int) -> int:
    """Program an m x n matrix: row-parallel within a crossbar, crossbars
    programmed in parallel across sub-tiles => one crossbar's row count."""
    return cfg.xbar


def vmm_energy(cfg: RePASTConfig, m: int, n: int, n_vecs: int,
               q_in: int | None = None) -> float:
    """Energy (nJ) for n_vecs vector passes through an m x n matrix."""
    ops = ceil_div(m, cfg.xbar) * ceil_div(n, cfg.xbar)
    return n_vecs * vmm_cycles(cfg, q_in) * ops * cfg.e_vmm_op()


def inv_energy(cfg: RePASTConfig, block: int, n_vecs: int,
               fused: bool = False) -> float:
    """Energy (nJ) for n_vecs high-precision solves on a block.

    Columns stream through the three-loop pipeline: the first solve pays
    the full Eqn. 10/14 latency, each further column one DAC interval of
    group activity."""
    lat = inv_fused_cycles(cfg) if fused else inv_cycles(cfg)
    ii = ceil_div(cfg.q_bits, cfg.dac_bits)
    cycles = lat + max(n_vecs - 1, 0) * ii
    return cycles * cfg.e_inv_op(inv_group_xbars(cfg, block))
