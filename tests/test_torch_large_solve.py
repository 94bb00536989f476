"""``smw_update`` and ``fused_gram_inv`` above 128 (bs, k and n of
129..1024): their large routes, held on the CPU as far as the CPU reaches
them.

The CUDA routes themselves run only on the card (tests/test_torch_cuda.py,
``chip_smoke.py`` phase ``large_blocks`` (d)-(f)). Here:

  * the plain versions, which the card holds the routes to, against the
    reference's Pallas kernels in interpret mode at (2, 64, 256),
    (2, 64, 176) (the Pallas kernel pads 176 to 256 and k to 128, exact
    for Woodbury) and (1, 256, 256), and against its fp32 oracle
    ``exact_smw_update`` at (1, 129, 384); ``fused_gram_inv_ref`` against
    the Pallas ``fused_gram_inv`` at n = 256 and 176 (padded to 256 with
    a lam-damped tail, which leaves the top-left inverse as it is), fp32
    and bf16, T = 512;
  * the routes' schedules run by a plain emulation of each kernel (the
    splits, each product's partials from its operands' stored slices, as
    stored or transposed, the one partial of bf16 activations,
    ``solve_ex`` for the solve, the finish's division and damping),
    bitwise ``smw_update_ref`` and ``fused_gram_inv_ref``, for k <= 128
    (the slab solve) and k > 128 (the blocked LU); every reader finds
    the forms it reads written earlier, and no product writes an operand
    it reads; the wrappers' own launches, each kernel emulated on CPU
    memory from the raw arguments it gets (addresses, strides,
    ``hilo_tma.Params``), bitwise the same, in chunks too;
  * the blocked LU's launches (panel, update, back substitution) emulated
    kernel by kernel in their own order of operations, against an
    unblocked emulation of ``lu_solve``'s rules: bitwise in fp32 at k of
    129, 160, 200 (a ragged last panel), 256 and 1024, pivots too; within
    1e-10 of ``torch.linalg.solve`` in float64 with
    ``torch.linalg.lu_factor``'s pivots; non-finite on an exactly
    singular S (two equal rows, 1/c = 0);
  * the plans and chunks as pure functions, and ``expected_launches``;
  * a 2-step ``KFACProgram(smw=True)`` trajectory at block 256 on the
    narrow model (sides 256 and 176) against the reference's.

Every test runs on one intra-op thread (``_torch_families.one_thread``),
as the other files that import it do: once another file's fixture has
set the thread count down and back, this build's threaded MKL LAPACK
(``solve_ex`` of a 200 x 200 block, as k > 128 needs) hangs in the same
process.

Tolerances and why:
  * plain ``smw_update`` vs the Pallas kernel: 1e-5 of the largest entry
    (tests/test_torch_smw.py: the exact bf16 partial products summed in
    another order, LAPACK solves of different frameworks); vs the fp32
    oracle the reference's own atol/rtol 5e-3 (tests/test_smw.py).
  * plain ``fused_gram_inv`` vs the Pallas kernel: atol 2e-4, the
    reference's own (tests/test_torch_kernels.py at 128).
  * the trajectory: tests/test_torch_smw.py's (losses rtol 1e-5, drifts
    rtol 2e-3, the fallback flags equal, final weights within 1% of each
    leaf's largest entry): the reference's ``--smw`` runs the fp32 einsum
    update, the port's the kernel route's hi/lo plain version.
"""

from __future__ import annotations

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.data import SyntheticTokens as JTokens
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.core.quantize import hilo_matmul, split_hi_lo_bf16
from repro_torch.kernels import fused_gram_solve as t_gram
from repro_torch.kernels import hilo_tma
from repro_torch.kernels import neumann_inv as t_neumann_inv
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import smw_update as t_smw
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm

from _torch_families import narrow, one_thread  # noqa: F401 (autouse)

KW = dict(ns_iters=20, taylor_terms=4, refine_steps=2)   # KFACConfig counts


def _rel_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / np.max(np.abs(want)))


def _smw_case(seed, n, k, bs, scale):
    """Cached inverses of damped factor-like blocks (the Gram of 4*bs
    columns at ``scale``, Tikhonov-damped as K-FAC does) and new
    columns at the same scale (tests/test_torch_smw.py's)."""
    r = np.random.default_rng(seed)
    v0 = r.standard_normal((n, 4 * bs, bs)) * scale
    f = np.einsum("ntb,ntc->nbc", v0, v0) / (4 * bs)
    lam = 0.03 * np.trace(f, axis1=1, axis2=2) / bs + 1e-8
    inv = np.linalg.inv(f + lam[:, None, None] * np.eye(bs))
    v = r.standard_normal((n, k, bs)) * scale
    return inv.astype(np.float32), v.astype(np.float32)


# ---------------------------------------------------------------------------
# the plain versions against the reference above 128
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,bs", [(2, 64, 256), (2, 64, 176),
                                    (1, 256, 256)])
def test_smw_update_plain_matches_pallas_kernel_above_128(n, k, bs):
    inv, v = _smw_case(n + k + bs, n, k, bs, 1.0)
    kw = dict(decay=0.95, cscale=0.05)
    got = tref.smw_update_ref(torch.from_numpy(inv), torch.from_numpy(v),
                              **kw).numpy()
    kernel = jops.smw_update(jnp.asarray(inv), jnp.asarray(v), **kw)
    assert got.shape == (n, bs, bs)
    assert _rel_err(got, kernel) <= 1e-5


def test_smw_update_plain_matches_exact_oracle_at_rank_129():
    inv, v = _smw_case(5, 1, 129, 384, 1.0)
    kw = dict(decay=0.95, cscale=0.05 / 2048)
    got = tref.smw_update_ref(torch.from_numpy(inv), torch.from_numpy(v),
                              **kw).numpy()
    oracle = np.asarray(jref.exact_smw_update(jnp.asarray(inv),
                                              jnp.asarray(v), **kw))
    np.testing.assert_allclose(got, oracle, atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [256, 176])
def test_fused_gram_inv_plain_matches_pallas_kernel_above_128(n, dtype):
    r = np.random.default_rng(n)
    a = jnp.asarray(r.standard_normal((512, 2, n)), jnp.dtype(dtype))
    ta = torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
    kw = dict(rel_damp=0.05, **KW)
    got = ops.fused_gram_inv(ta, **kw)
    assert got.shape == (2, n, n)
    np.testing.assert_allclose(got.numpy(), jops.fused_gram_inv(a, **kw),
                               rtol=0, atol=2e-4)


# ---------------------------------------------------------------------------
# the large routes' schedules, run by a plain emulation of their kernels
# ---------------------------------------------------------------------------

def _mm(x, y):
    """bf16 x bf16 with fp32 accumulation (the plain version's partial)."""
    return torch.matmul(x.to(torch.float32), y.to(torch.float32))


def _partials(left, right):
    """A product's partials from its operands' (hi, lo) slices, in the
    kernel's (and the plain version's) order: L_H R_H + L_H R_L +
    L_L R_H, or L_H R_H alone where both lo slices are missing (bf16
    activations)."""
    (lh, ll), (rh, rl) = left, right
    if ll is None and rl is None:
        return _mm(lh, rh)
    return _mm(lh, rh) + _mm(lh, rl) + _mm(ll, rh)


def _smw_emulate(inv, v, *, decay, cscale):
    """The large route on the CPU, :func:`smw_schedule`'s kernels in
    order over each value's stored forms (fp32, and the hi and lo slices
    split as their writer stores them): the prep kernel's M and V's
    slices, each product's partials from its operands' slices (read
    transposed where stored so) and its epilogue (NEG_ACC: ``E + -acc``),
    the solve as ``solve_ex`` (the slab and the blocked LU both solve
    (S + I/c) Z = Y, the diagonal term added as ``acc + 1/c``; it stands
    in at the solve's last launch, which stores Z's forms). A read of a
    form not yet written fails."""
    inv_decay, inv_c = tref.smw_scalars(decay, cscale)
    k = v.shape[-2]
    mem = {("inv", "f32"): inv, ("v", "f32"): v}

    def store(buf, forms, value):
        hi, lo = split_hi_lo_bf16(value)
        for f, x in (("f32", value), ("hi", hi), ("lo", lo)):
            if f in forms:
                mem[(buf, f)] = x

    for x in t_smw.smw_schedule(k):
        if x.kind == t_smw.PREP:
            (src, _), (vsrc, _) = x.reads
            (dst, forms), (vdst, vforms) = x.writes
            m = mem[(src, "f32")]
            store(dst, forms, (m + m.transpose(-1, -2)) * inv_decay)
            store(vdst, vforms, mem[(vsrc, "f32")])
        elif x.kind == t_smw.PRODUCT:
            (left, _), (right, _), *e = x.reads
            ((c, forms),) = x.writes

            def slices(buf, t):
                return tuple(mem[(buf, f)].transpose(-1, -2) if t
                             else mem[(buf, f)] for f in ("hi", "lo"))

            acc = _partials(slices(left, x.lt), slices(right, x.rt))
            if x.epi == hilo_tma.STORE:
                store(c, forms, acc)
            elif x.epi == hilo_tma.NEG_ACC:
                store(c, forms, mem[(e[0][0], "f32")] + -acc)
            else:
                raise AssertionError(f"epilogue {x.epi} in the update")
        else:
            kind = x.solve[0]
            assert (kind == "slab") == (k <= 128)
            if kind in ("slab", "back"):
                eye = torch.eye(k, dtype=torch.float32)
                ((z, forms),) = x.writes
                store(z, forms, torch.linalg.solve_ex(
                    mem[("s", "f32")] + eye * inv_c, mem[("y", "f32")])[0])
    return mem[("out", "f32")]


def _first_largest(col):
    """lu_solve's pivot rule: the first largest |x| (NaN never taken;
    the first row if every entry is NaN)."""
    a = col.abs()
    a = torch.where(torch.isnan(a), torch.full_like(a, -1.0), a)
    return int(torch.argmax(a))   # the first of equal maxima


def _lu_unblocked(s, y, inv_c):
    """Z = (S + I/c)^-1 Y by lu_solve's rules, a column at a time: the
    pivot by :func:`_first_largest`, rows swapped, multipliers
    ``x * (1 / pivot)``, each step's update ``x - l * u`` over [S | Z];
    then back substitution ``z_i - u_ij * z_j`` for descending j, then
    ``z_j / u_jj``. Returns (Z, pivots)."""
    k = s.shape[0]
    a, z = s.clone(), y.clone()
    a.diagonal().add_(inv_c)
    one = torch.ones((), dtype=s.dtype)
    piv = []
    for j in range(k):
        p = j + _first_largest(a[j:, j])
        piv.append(p)
        a[[j, p]], z[[j, p]] = a[[p, j]], z[[p, j]]
        r = one / a[j, j]
        lcol = a[j + 1:, j:j + 1] * r
        a[j + 1:, j:j + 1] = lcol
        a[j + 1:, j + 1:] = a[j + 1:, j + 1:] - lcol * a[j:j + 1, j + 1:]
        z[j + 1:] = z[j + 1:] - lcol * z[j:j + 1]
    for j in range(k - 1, -1, -1):
        z[j] = z[j] / a[j, j]
        z[:j] = z[:j] - a[:j, j:j + 1] * z[j:j + 1]
    return z, piv


def _lu_blocked(s, y, inv_c):
    """The same solve by the blocked LU's launches (the solve steps of
    :func:`smw_schedule`), each kernel emulated on the CPU with its own
    order of operations: ``panel`` factors rows j0..k-1 of its columns
    (rows swapped whole inside the panel, the rank-1 updates of the
    panel's columns) and records each row's source; ``update`` gathers
    the columns right of it by those sources, solves U12 = L11^-1 A12 row
    by row (``x - l * u`` for ascending t) and updates A22 as w
    sequential rank-1 steps (``acc - l[:, t:t+1] * u[t:t+1, :]``);
    ``back`` solves each panel's diagonal block from the last (``z_i -
    u_ij z_j`` for descending j, then ``z_j / u_jj``), then the rows
    above it for its columns in descending order. The first panel adds
    1/c to the diagonal and its update reads Y. Returns (Z, pivots)."""
    k, bs = y.shape
    a = s.clone()
    z = torch.empty_like(y)
    one = torch.ones((), dtype=s.dtype)
    src = list(range(k))
    piv = []
    for step in t_smw.smw_schedule(k):
        if step.kind != t_smw.SOLVE:
            continue
        (kind, j0, j1), reads = step.solve, [b for b, _ in step.reads]
        if kind == "panel":
            if j0 == 0:
                a.diagonal().add_(inv_c)
            blk = a[j0:, j0:j1].clone()
            order = list(range(j0, k))
            for t in range(j1 - j0):
                p = t + _first_largest(blk[t:, t])
                piv.append(j0 + p)
                blk[[t, p]] = blk[[p, t]]
                order[t], order[p] = order[p], order[t]
                r = one / blk[t, t]
                lcol = blk[t + 1:, t:t + 1] * r
                blk[t + 1:, t:t + 1] = lcol
                blk[t + 1:, t + 1:] = blk[t + 1:, t + 1:] \
                    - lcol * blk[t:t + 1, t + 1:]
            a[j0:, j0:j1] = blk
            src[j0:] = order
            # what the update kernel's gather relies on: a row below the
            # panel that moved took one of the panel's rows
            assert all(j0 <= order[r - j0] < j1 for r in range(j1, k)
                       if order[r - j0] != r)
        elif kind == "update":
            rhs = torch.cat([a[:, j1:], y if "y" in reads else z], dim=1)
            rhs[j0:] = rhs[src[j0:]].clone()
            for t in range(j1 - j0):
                for q in range(t):
                    rhs[j0 + t] = rhs[j0 + t] - a[j0 + t, j0 + q] \
                        * rhs[j0 + q]
            for t in range(j1 - j0):
                rhs[j1:] = rhs[j1:] - a[j1:, j0 + t:j0 + t + 1] \
                    * rhs[j0 + t:j0 + t + 1]
            a[:, j1:], z = rhs[:, :k - j1], rhs[:, k - j1:].clone()
        else:
            for q0 in range((k - 1) // t_smw.PANEL * t_smw.PANEL, -1,
                            -t_smw.PANEL):
                q1 = min(q0 + t_smw.PANEL, k)
                for j in range(q1 - 1, q0 - 1, -1):
                    z[j] = z[j] / a[j, j]
                    z[q0:j] = z[q0:j] - a[q0:j, j:j + 1] * z[j:j + 1]
                for j in range(q1 - 1, q0 - 1, -1):
                    z[:q0] = z[:q0] - a[:q0, j:j + 1] * z[j:j + 1]
    return z, piv


def _capacitance(seed, k, bs, dtype, singular=False):
    """S = Y V^T and Y = V M as the route computes them (hilo_matmul of
    the damped case at unit scale), 1/c as the A side's at 2048 tokens;
    ``singular``: rows 2 and 5 of V equal and 1/c = 0, so S has two
    equal rows and is exactly singular."""
    inv, v = _smw_case(seed, 1, k, bs, 1.0)
    if singular:
        v[:, 5] = v[:, 2]
    inv_decay, inv_c = tref.smw_scalars(0.95, float("inf") if singular
                                        else 0.05 / 2048)
    inv, v = torch.from_numpy(inv[0]), torch.from_numpy(v[0])
    m = (inv + inv.T) * inv_decay
    y = hilo_matmul(v, m)
    s = hilo_matmul(y, v.T)
    return s.to(dtype), y.to(dtype), inv_c


LU_CASES = [(129, 8), (160, 16), (200, 24), (256, 40), (1024, 6)]


@pytest.mark.parametrize("k,bs", LU_CASES)
def test_blocked_lu_is_the_unblocked_elimination_bitwise(k, bs):
    """fp32: every entry of Z goes through the same operations in the
    same order in the blocked schedule as in lu_solve's unblocked
    elimination, wherever the panel boundaries fall (200 = 6 panels and
    a ragged 8), so the two are bitwise equal, pivots too."""
    s, y, inv_c = _capacitance(k + bs, k, bs, torch.float32)
    z_b, piv_b = _lu_blocked(s, y, inv_c)
    z_u, piv_u = _lu_unblocked(s, y, inv_c)
    assert piv_b == piv_u
    assert torch.isfinite(z_b).all()
    assert torch.equal(z_b, z_u)


@pytest.mark.parametrize("k,bs", LU_CASES)
def test_blocked_lu_float64_matches_linalg(k, bs):
    """float64: the blocked schedule solves the system (within 1e-10 of
    ``torch.linalg.solve``, relative to Z's largest entry) with LAPACK's
    pivots (``torch.linalg.lu_factor``'s, which are 1-based)."""
    s, y, inv_c = _capacitance(k + bs, k, bs, torch.float64)
    z, piv = _lu_blocked(s, y, inv_c)
    sc = s + torch.eye(k, dtype=torch.float64) * inv_c
    want = torch.linalg.solve(sc, y)
    assert float((z - want).abs().max()) <= 1e-10 * float(want.abs().max())
    _, lapack = torch.linalg.lu_factor(sc)
    assert piv == [int(p) - 1 for p in lapack]


@pytest.mark.parametrize("k", [160, 200])
def test_blocked_lu_singular_capacitance_is_non_finite(k):
    """Two equal rows of V and 1/c = 0: S is exactly singular, an exact
    zero pivot turns up, and both emulations give a non-finite Z, bitwise
    alike up to the NaNs (the SMW gate's fallback signal)."""
    s, y, inv_c = _capacitance(k, k, 12, torch.float32, singular=True)
    assert inv_c == 0.0 and torch.equal(s[2], s[5])
    z_b, piv_b = _lu_blocked(s, y, inv_c)
    z_u, piv_u = _lu_unblocked(s, y, inv_c)
    assert not torch.isfinite(z_b).all() and not torch.isfinite(z_u).all()
    assert piv_b == piv_u
    assert torch.equal(torch.nan_to_num(z_b), torch.nan_to_num(z_u))


def test_lu_schedule_covers_every_column_once():
    """Panels of PANEL columns in order, the last one ragged, two
    launches a panel and one back substitution: fewer than 3 launches a
    panel, 65 at k 1024."""
    for k in (1, 31, 32, 33, 129, 200, 1000, 1024):
        steps = t_smw.lu_schedule(k)
        assert steps[-1] == ("back", 0, k)
        panels = [(j0, j1) for kind, j0, j1 in steps if kind == "panel"]
        assert [kind for kind, _, _ in steps[:-1]] == \
            ["panel", "update"] * len(panels)
        assert panels[0][0] == 0 and panels[-1][1] == k
        assert all(b == c for (_, b), (c, _) in zip(panels, panels[1:]))
        assert all(j1 - j0 == t_smw.PANEL for j0, j1 in panels[:-1])
        assert 0 < panels[-1][1] - panels[-1][0] <= t_smw.PANEL
    assert len(t_smw.lu_schedule(1024)) == 65


@pytest.mark.parametrize("n,k,bs,scale", [(3, 64, 176, 1.0),
                                          (2, 128, 256, 3e-4),
                                          (2, 129, 176, 1.0),
                                          (2, 200, 96, 1.0)])
def test_smw_schedule_emulated_is_the_plain_version(n, k, bs, scale):
    inv, v = (torch.from_numpy(x) for x in _smw_case(k + bs, n, k, bs,
                                                     scale))
    kw = dict(decay=0.95, cscale=0.05)
    assert torch.equal(_smw_emulate(inv, v, **kw),
                       tref.smw_update_ref(inv, v, **kw))


@pytest.mark.parametrize("k", [64, 128, 129, 200, 1024])
def test_smw_schedule_never_overwrites_what_a_product_reads(k):
    """Every kernel reads only forms the caller gave or an earlier kernel
    wrote: slices for a product's operands, fp32 for an epilogue's E and
    the solve; no product writes a buffer it reads (other CTAs still read
    it); the prep stores M's forms and V's slices; the solve's launches
    make Z from S and Y in fp32 (the LU factors S in place and records
    its row sources, which no later product reads), its last launch
    stores Z's slices too, and the last product writes the output; every
    workspace form written has its array in the layout, and the layout
    holds nothing else."""
    steps = t_smw.smw_schedule(k)
    written = {("inv", "f32"), ("v", "f32")}
    for i, x in enumerate(steps):
        reads = {(b, f) for b, forms in x.reads for f in forms}
        assert reads <= written, (x, reads - written)
        if x.kind == t_smw.PRODUCT:
            (left, lf), (right, rf), *e = x.reads
            assert lf == rf == ("hi", "lo")
            assert all(forms == ("f32",) for _, forms in e)
            assert len(e) == (x.epi == hilo_tma.NEG_ACC)
            ((c, _),) = x.writes
            assert c not in (left, right, *(b for b, _ in e), "inv", "v")
        elif x.kind == t_smw.SOLVE:
            last = x is [st for st in steps if st.kind == t_smw.SOLVE][-1]
            assert all(forms in (("f32",), ("i32",)) for _, forms in
                       x.reads + (() if last else x.writes))
            assert not last or x.writes == (("z", ("f32", "hi", "lo")),)
            outs = {b for b, _ in x.writes}
            assert "y" not in outs and {"inv", "v", "m"}.isdisjoint(outs)
            assert all(st.kind == t_smw.SOLVE or not {"s", "piv"} & {
                b for b, _ in st.reads} for st in steps[i + 1:])
        else:
            assert i == 0 and x.kind == t_smw.PREP
            assert x.reads == (("inv", ("f32",)), ("v", ("f32",)))
            assert x.writes == (("m", ("f32", "hi", "lo")),
                                ("v", ("hi", "lo")))
        written |= {(b, f) for b, forms in x.writes for f in forms}
    assert steps[-1].writes == (("out", ("f32",)),)
    last_solve = max(i for i, x in enumerate(steps) if x.kind == t_smw.SOLVE)
    assert [x.kind for x in steps[last_solve + 1:]] == [t_smw.PRODUCT]
    names = {b for x in steps for b, _ in x.reads + x.writes}
    assert names <= set(t_smw.buffer_shapes(8, 8))
    ws = written - {("inv", "f32"), ("v", "f32"), ("out", "f32")}
    assert set(t_smw.layout(8, k)) == ws
    assert len(t_smw.layout(8, k)) == len(ws)


def _gram_emulate(a, *, rel_damp, **counts):
    """The large Gram route on the CPU: the split (each block's (T, n)
    activations as hi and lo slices, hi alone for bf16), the product (the
    left operand the block's slices read as stored, T x n, transposed;
    the right the same slices; three partials, or L_H R_H alone for
    bf16), the finish kernel's division and damping, then neumann_inv's
    large route (bitwise ``neumann_inv_ref``:
    tests/test_torch_large_blocks.py)."""
    t = a.shape[0]
    blocks = a.movedim(1, 0)                     # (nb, T, n)
    if a.dtype == torch.bfloat16:
        hi, lo = blocks, None
    else:
        hi, lo = split_hi_lo_bf16(blocks)
    tr = [None if x is None else x.transpose(-1, -2) for x in (hi, lo)]
    gram = _partials(tr, (hi, lo)) / t
    lam = tref._gram_damping(gram, rel_damp)
    return tref.neumann_inv_ref(gram, lam, **counts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,nb,n", [(300, 2, 176), (128, 1, 256),
                                    (90, 3, 130)])
def test_gram_route_emulated_is_the_plain_version(t, nb, n, dtype):
    a = torch.from_numpy(np.random.default_rng(t + n).standard_normal(
        (t, nb, n)).astype(np.float32)).to(dtype)
    assert torch.equal(_gram_emulate(a, rel_damp=0.05, **KW),
                       tref.fused_gram_inv_ref(a, rel_damp=0.05, **KW))


# ---------------------------------------------------------------------------
# the wrappers' launches, each kernel emulated from its raw arguments
# ---------------------------------------------------------------------------

def _view(addr, dtype, count):
    """A flat tensor of ``count`` entries of ``dtype`` at a CPU address."""
    ctype = {torch.float32: ctypes.c_float, torch.int32: ctypes.c_int32,
             torch.bfloat16: ctypes.c_int16}[dtype]
    raw = np.ctypeslib.as_array((ctype * count).from_address(addr))
    return torch.from_numpy(raw).view(dtype)


def _blocks(addr, dtype, blocks, rows, cols, ld, bstride=None):
    """A (blocks, rows, cols) view of blocks ``bstride`` entries apart
    (default rows x ld), rows ``ld`` apart, at ``addr``."""
    bstride = rows * ld if bstride is None else bstride
    flat = _view(addr, dtype, (blocks - 1) * bstride + (rows - 1) * ld
                 + cols)
    return flat.as_strided((blocks, rows, cols), (bstride, ld, 1))


def _put(o, blocks, rows, cols, ld32, ld16, value):
    """An epilogue's (or the prep kernel's) stores of ``value`` in the
    forms ``o`` (a ``hilo_tma.Out``) asks for."""
    hi, lo = split_hi_lo_bf16(value)
    for addr, dtype, v, ld in ((o.f32, torch.float32, value, ld32),
                               (o.hi, torch.bfloat16, hi, ld16),
                               (o.lo, torch.bfloat16, lo, ld16)):
        if addr:
            _blocks(addr, dtype, blocks, rows, cols, ld).copy_(v)


def _product_from_params(p):
    """``htma::launch`` on CPU memory from its ``Params``: the operands'
    slices as stored (transposed where ``l_t``/``r_t`` say), the
    partials, the epilogue (STORE or NEG_ACC) into C's and F's forms."""
    m, k, n = p.m or p.n, p.k or p.n, p.n
    assert not (p.l_idx or p.r_idx or p.part)

    def operand(hi, lo, rows, cols, ld, blocks, t):
        got = [None if a is None else
               _blocks(a, torch.bfloat16, blocks, rows, cols, ld)[:p.batch]
               for a in (hi, lo)]
        return [None if x is None else (x.transpose(-1, -2) if t else x)
                for x in got]

    assert all(a is None or a % 16 == 0
               for a in (p.l_hi, p.l_lo, p.r_hi, p.r_lo))
    left = operand(p.l_hi, p.l_lo, *((k, m) if p.l_t else (m, k)),
                   p.l_ld16, p.l_blocks or p.batch, p.l_t)
    right = operand(p.r_hi, p.r_lo, *((n, k) if p.r_t else (k, n)),
                    p.r_ld16, p.r_blocks or p.batch, p.r_t)
    acc = _partials(left, right)
    if p.epi == hilo_tma.STORE:
        _put(p.c, p.batch, m, n, p.ld32, p.ld16, acc)
    else:
        assert p.epi == hilo_tma.NEG_ACC
        e = _blocks(p.e, torch.float32, p.batch, m, n, p.ld32)
        _put(p.c, p.batch, m, n, p.ld32, p.ld16, -acc)
        _put(p.f, p.batch, m, n, p.ld32, p.ld16, e + -acc)


class _Card:
    """The large routes' kernels of ``smw_update`` and ``fused_gram_inv``,
    run on CPU memory from their arguments as the C entries get them;
    records the launches. The LU's launches stand in by ``solve_ex`` at
    its first update (S is still as the products wrote it: the panels
    here do nothing), as :func:`_smw_emulate` does."""

    def __init__(self):
        self.calls = []

    def launch(self, entry, *args, key=None):
        self.calls.append((entry, key))
        getattr(self, entry)(*args)

    def smw_update_prep(self, inv, ref, v, vh, vl, nb, bs, k, ld32, ld16,
                        inv_decay, stream):
        assert ld16 % 8 == 0 and ld16 >= bs and vh % 16 == vl % 16 == 0
        a = _blocks(inv, torch.float32, nb, bs, bs, bs)
        _put(ref._obj, nb, bs, bs, ld32, ld16,
             (a + a.transpose(-1, -2)) * inv_decay)
        _put(hilo_tma.Out(None, vh, vl), nb, k, bs, 0, ld16,
             _blocks(v, torch.float32, nb, k, bs, bs))

    def smw_update_product(self, ref, stream):
        assert ref._obj.epi in (hilo_tma.STORE, hilo_tma.NEG_ACC)
        _product_from_params(ref._obj)

    def _solve(self, s, lds, y, z, ldy, nb, k, bs, inv_c):
        sm = _blocks(s, torch.float32, nb, k, k, lds)
        ym = _blocks(y, torch.float32, nb, k, bs, ldy)
        eye = torch.eye(k, dtype=torch.float32)
        _blocks(z, torch.float32, nb, k, bs, ldy).copy_(
            torch.linalg.solve_ex(sm + eye * inv_c, ym)[0])

    def _z_slices(self, z, ldy, nb, k, bs, zh, zl, ld16):
        """The last solve launch's stores of Z's slices."""
        assert zh and zl and ld16 >= bs
        _put(hilo_tma.Out(None, zh, zl), nb, k, bs, 0, ld16,
             _blocks(z, torch.float32, nb, k, bs, ldy))

    def smw_update_solve_slab(self, s, lds, y, z, ldy, nb, k, bs, inv_c,
                              zh, zl, ld16, stream):
        assert k <= 128
        self._solve(s, lds, y, z, ldy, nb, k, bs, inv_c)
        self._z_slices(z, ldy, nb, k, bs, zh, zl, ld16)

    def smw_update_lu_panel(self, s, lds, piv, ldp, nb, k, j0, inv_c,
                            stream):
        assert k > 128 and lds % 4 == 0 and ldp >= k

    def smw_update_lu_update(self, s, lds, y, z, ldy, piv, ldp, nb, k, bs,
                             j0, inv_c, stream):
        if j0 == 0:
            self._solve(s, lds, y, z, ldy, nb, k, bs, inv_c)

    def smw_update_lu_back(self, s, lds, z, ldy, nb, k, bs, zh, zl, ld16,
                           stream):
        self._z_slices(z, ldy, nb, k, bs, zh, zl, ld16)

    def fused_gram_inv_split(self, src, bf16_in, blocks, rows, cols,
                             bstride, ld, hi, lo, ld16, stream):
        a = _blocks(src, torch.bfloat16 if bf16_in else torch.float32,
                    blocks, rows, cols, ld, bstride)
        if bf16_in:
            assert lo is None
            _blocks(hi, torch.bfloat16, blocks, rows, cols, ld16).copy_(a)
        else:
            _put(hilo_tma.Out(None, hi, lo), blocks, rows, cols, 0, ld16, a)

    def fused_gram_inv_gram(self, ref, stream):
        p = ref._obj
        assert p.epi == hilo_tma.STORE and p.l_t and not p.r_t
        _product_from_params(p)

    def fused_gram_inv_finish(self, g, lam, nb, n, t, rel_damp, stream):
        gram = _blocks(g, torch.float32, nb, n, n, n)
        gram.copy_(gram / t)
        _view(lam, torch.float32, nb).copy_(
            tref._gram_damping(gram, rel_damp))


@pytest.mark.parametrize("n,k,bs", [(3, 64, 176), (2, 129, 130),
                                    (2, 200, 96), (2, 40, 256)])
@pytest.mark.parametrize("budget_blocks", [None, 1])
def test_smw_wrapper_launches_emulated_are_the_plain_version(
        n, k, bs, budget_blocks, monkeypatch):
    """``_large`` on CPU tensors, every kernel emulated from the
    addresses, strides and ``hilo_tma.Params`` it passes: bitwise the
    plain version, in one chunk and a block a chunk, the launches those
    of ``expected_launches``, all keyed by the shape."""
    inv, v = (torch.from_numpy(x) for x in _smw_case(k + bs, n, k, bs,
                                                     1.0))
    if budget_blocks:
        plan = t_smw.smw_plan
        monkeypatch.setattr(t_smw, "smw_plan", lambda nb, b, kk: plan(
            nb, b, kk, budget=budget_blocks * t_smw.block_bytes(b, kk)))
    card = _Card()
    monkeypatch.setattr(t_smw.LIB, "launch", card.launch)
    kw = dict(decay=0.95, cscale=0.05)
    inv_decay, inv_c = tref.smw_scalars(**kw)
    out = torch.full_like(inv, float("nan"))
    t_smw._large(inv, v, out, inv_decay, inv_c, 0, t_smw.launch_key(bs, k))
    assert torch.equal(out, tref.smw_update_ref(inv, v, **kw))
    assert len(card.calls) == t_smw.expected_launches(bs, k, n)
    assert {key for _, key in card.calls} == {t_smw.launch_key(bs, k)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,nb,n,budget_blocks", [(300, 3, 176, None),
                                                  (90, 3, 130, 2),
                                                  (40, 2, 129, 1)])
def test_gram_wrapper_launches_emulated_are_the_plain_version(
        t, nb, n, budget_blocks, dtype, monkeypatch):
    """``_large`` on CPU activations (fp32 and bf16), the split, the Gram
    and the finish emulated from their raw arguments, ``neumann_inv``'s
    route by its plain version: bitwise ``fused_gram_inv_ref``, the
    launches those of ``expected_launches``, keyed by the side."""
    a = torch.from_numpy(np.random.default_rng(t + n).standard_normal(
        (t, nb, n)).astype(np.float32)).to(dtype)
    if budget_blocks:
        plan = t_gram.gram_plan
        monkeypatch.setattr(t_gram, "gram_plan", lambda b, s, tt, sl: plan(
            b, s, tt, sl, budget=budget_blocks * t_gram.block_bytes(
                tt, s, sl)))
    card = _Card()
    monkeypatch.setattr(t_gram.LIB, "launch", card.launch)

    def inverse(blocks, lams, *, out, **counts):
        out[0].copy_(tref.neumann_inv_ref(blocks[0], lams[0], **counts))

    monkeypatch.setattr(t_gram._neumann_inv, "neumann_inv_grouped", inverse)
    out = torch.full((nb, n, n), float("nan"))
    t_gram._large(a, out, 0.05, KW, 0)
    assert torch.equal(out, tref.fused_gram_inv_ref(a, rel_damp=0.05, **KW))
    want = t_gram.expected_launches(a.shape, dtype, **KW)
    assert len(card.calls) == want["fused_gram_inv"]
    assert {key for _, key in card.calls} == {f"n{n}"}


# ---------------------------------------------------------------------------
# plans, chunks and launches (pure functions)
# ---------------------------------------------------------------------------

def _smw_block_bytes(bs, k):
    """A block's workspace: M's fp32 (unpadded rows) and slices, V's
    slices, Y's and Z's fp32 and slices, S's fp32, above k 128 the LU's
    row sources."""
    ss, rs = hilo_tma.slice_stride, hilo_tma.row_stride
    return (4 * bs * bs + 4 * bs * ss(bs) + 4 * k * ss(bs)
            + 2 * (4 * k * rs(bs) + 4 * k * ss(bs)) + 4 * k * rs(k)
            + (4 * rs(k) if k > 128 else 0))


def test_smw_plan_and_expected_launches():
    for bs, k in ((176, 64), (130, 129), (256, 256), (96, 200),
                  (1024, 1024)):
        assert t_smw.block_bytes(bs, k) == _smw_block_bytes(bs, k)
    assert t_smw.block_bytes(176, 64) == 4 * 176 * 176 * 2 + \
        64 * 176 * (4 + 2 * (4 + 4)) + 4 * 64 * 64
    # above k 128 the LU's row sources, k int32 (a row of 132) a block
    assert t_smw.block_bytes(130, 129) == 4 * 130 * 130 + 4 * 130 * 136 + \
        4 * 129 * 136 + 2 * (4 * 129 * 132 + 4 * 129 * 136) + \
        4 * 129 * 132 + 4 * 132
    assert t_smw.block_bytes(1024, 1024) == 4 * 8 * 1024 * 1024 + 4 * 1024
    # the main path at block 256: one chunk a side at rank 64, two at
    # rank 256 (2.1 MB and 1.4 MB a block)
    assert t_smw.smw_plan(768, 256, 64) == [(0, 768)]
    assert t_smw.smw_plan(1152, 176, 64) == [(0, 1152)]
    assert t_smw.smw_plan(768, 256, 256) == [(0, 384), (384, 768)]
    assert t_smw.smw_plan(1152, 176, 256) == [(0, 576), (576, 1152)]
    # 1024 x 1024: 32 MiB and 4 KiB a block, 31 under 1 GiB: seven
    # chunks of 28 (the last 24)
    parts = t_smw.smw_plan(192, 1024, 1024)
    assert parts == [(b, min(b + 28, 192)) for b in range(0, 192, 28)]
    for nb, bs, k in ((192, 1024, 1024), (5000, 256, 256), (7, 129, 64)):
        parts = t_smw.smw_plan(nb, bs, k)
        assert parts[0][0] == 0 and parts[-1][1] == nb
        assert all(b1 == c0 for (_, b1), (c0, _) in zip(parts, parts[1:]))
        assert max(b1 - b0 for b0, b1 in parts) * \
            t_smw.block_bytes(bs, k) <= hilo_tma.WORKSPACE_BYTES
    assert t_smw.smw_plan(5, 256, 64, budget=1) == \
        [(b, b + 1) for b in range(5)]
    assert t_smw.expected_launches(128, 64, 528) == 1
    assert t_smw.expected_launches(128, 128, 528) == 1
    # the prep (with V's split), 2 products, the slab solve (storing Z's
    # slices too), the last product
    assert t_smw.expected_launches(256, 64, 768) == 5
    # above k 128 two launches a panel of 32 and the back substitution
    assert t_smw.expected_launches(128, 129, 3) == 4 + 2 * 5 + 1
    assert t_smw.expected_launches(256, 256, 768) == 2 * (4 + 2 * 8 + 1)
    assert t_smw.expected_launches(176, 256, 1152) == 2 * 21
    assert t_smw.expected_launches(1024, 1000, 2) == 4 + 2 * 32 + 1
    assert t_smw.expected_launches(1024, 1024, 192) == 7 * 69
    assert t_smw.expected_launches(256, 64, 0) == 0
    assert [x.solve[0] for x in t_smw.smw_schedule(128)
            if x.kind == t_smw.SOLVE] == ["slab"]
    assert [x.solve[0] for x in t_smw.smw_schedule(129)
            if x.kind == t_smw.SOLVE] == ["panel", "update"] * 5 + ["back"]
    assert t_smw.launch_key(176, 64) == "bs176k64"


def test_gram_plan_and_expected_launches():
    ss = hilo_tma.slice_stride
    # a block's activations as slices (hi and lo; hi alone for bf16), its
    # Gram and its damping
    assert t_gram.block_bytes(2048, 176, 2) == \
        2 * 2 * 2048 * 176 + 4 * (176 * 176 + 1)
    assert t_gram.block_bytes(300, 129, 1) == \
        2 * 300 * ss(129) + 4 * (129 * 129 + 1)
    assert t_gram.gram_plan(384, 176, 2048, 2) == [(0, 384)]
    assert t_gram.gram_plan(1152, 176, 2048, 2) == [(0, 576), (576, 1152)]
    assert t_gram.gram_plan(1152, 176, 2048, 1) == [(0, 1152)]
    parts = t_gram.gram_plan(600, 1024, 2048, 2)
    assert parts[0][0] == 0 and parts[-1][1] == 600
    assert max(b1 - b0 for b0, b1 in parts) * \
        t_gram.block_bytes(2048, 1024, 2) <= hilo_tma.WORKSPACE_BYTES
    per = t_neumann_inv.launches_per_chunk(**KW)
    f32, b16 = torch.float32, torch.bfloat16
    # 1152 blocks of 176, fp32: two Gram chunks of 576 (a split, the Gram
    # and the finish each), neumann_inv's one chunk a Gram chunk
    assert t_gram.expected_launches((2048, 1152, 176), f32, **KW) == \
        {"fused_gram_inv": 6, "neumann_inv": 2 * per}
    # bf16: one Gram chunk, neumann_inv's 2 chunks of 576
    assert t_gram.expected_launches((2048, 1152, 176), b16, **KW) == \
        {"fused_gram_inv": 3, "neumann_inv": 2 * per}
    # 192 blocks of 1024, fp32: three Gram chunks of 64, neumann_inv's 2
    # chunks of 32 in each
    assert t_gram.expected_launches((2048, 192, 1024), f32, **KW) == \
        {"fused_gram_inv": 9, "neumann_inv": 6 * per}
    assert t_gram.expected_launches((2048, 528, 128), f32, **KW) == \
        {"fused_gram_inv": 1, "neumann_inv": 0}
    assert t_gram.expected_launches((2048, 0, 256), b16, **KW) == \
        {"fused_gram_inv": 0, "neumann_inv": 0}
    assert t_gram.slices_of(f32) == 2 and t_gram.slices_of(b16) == 1


def test_route_limits_are_the_references():
    """Both wrappers take sides and ranks up to the reference's 1024 and
    switch to the large route above 128; a CPU tensor is refused by the
    CUDA wrappers whatever its size (the card tests check the refusal
    above 1024 on CUDA)."""
    assert t_smw.MAX_N == t_gram.MAX_N == 1024
    assert t_smw.ONE_CTA_N == t_gram.ONE_CTA_N == 128
    with pytest.raises(ValueError, match="CUDA"):
        t_smw.smw_update(torch.zeros(1, 300, 300), torch.zeros(1, 200, 300),
                         decay=0.95, cscale=0.05)
    with pytest.raises(ValueError, match="CUDA"):
        t_gram.fused_gram_inv(torch.zeros(4, 1, 300), rel_damp=0.05, **KW)
    # the update's correction, out = M - Y^T Z, is NEG_ACC writing F
    # alone (E + -acc: one rounding, as E - acc)
    assert t_smw.smw_schedule(64)[-1].epi == hilo_tma.NEG_ACC


# ---------------------------------------------------------------------------
# a --smw trajectory at block 256
# ---------------------------------------------------------------------------

def test_smw_block_256_trajectory_matches_reference():
    """2 steps of ``KFACProgram(smw=True)`` at block 256 against the
    reference's on a 1-device Auto mesh: step 0 seeds the inverses (a
    full inversion), step 1 updates them by Woodbury on both sides (256
    and 176), the port through the kernel route's plain version."""
    from repro.launch.train import KFACProgram as JProgram

    b, t, n_steps, budget, rank = 2, 32, 2, 0.05, 16
    jcfg = narrow(get_smoke_config("qwen1.5-0.5b"))
    tcfg = narrow(t_get_smoke_config("qwen1.5-0.5b"))
    common = dict(block_size=256, stats_batch=b, stats_seq=t)
    ds = JTokens(jcfg.vocab, t, b, seed=0)
    batches = [ds.batch_slice(i, 0, b) for i in range(n_steps)]

    jprog = JProgram(jcfg, JKFACConfig(**common), seed=0, smw=True,
                     smw_drift_budget=budget, smw_rank=rank)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    j_hist = []
    with jax.set_mesh(mesh):
        jstate = jprog.init_state(mesh)
        params = jax.device_get(jstate.params)
        jstep = jprog.make_step(mesh)
        for toks in batches:
            jstate, m = jstep(jstate, {"tokens": jnp.asarray(toks)})
            j_hist.append((float(m["loss"]), float(m["smw_drift"]),
                           float(m["smw_fallback"])))
        j_params = convert._flatten(jax.device_get(jstate.params))

    tprog = ttrain.KFACProgram(tcfg, tkfac.KFACConfig(**common),
                               device="cpu", smw=True,
                               smw_drift_budget=budget, smw_rank=rank)
    tparams = convert.params_from_jax(params, device="cpu")
    state = tsteps.TrainState(tparams, tkfac.init(
        tparams, tlm.kfac_specs(tcfg), tprog.kcfg))
    sides = {f.shape[-1] for d in state.kfac.factors.values()
             for f in d.values()}
    assert sides == {256, 176}
    step_fn = tprog.make_step(state)
    t_hist = []
    for toks in batches:
        state, m = step_fn(state, {"tokens": torch.from_numpy(toks)})
        t_hist.append((float(m["loss"]), float(m["smw_drift"]),
                       m["smw_fallback"]))
    assert [h[2] for h in t_hist] == [h[2] for h in j_hist] == [1.0, 0.0]
    np.testing.assert_allclose([h[0] for h in t_hist],
                               [h[0] for h in j_hist], rtol=1e-5)
    np.testing.assert_allclose([h[1] for h in t_hist],
                               [h[1] for h in j_hist], rtol=2e-3)
    for k, v in j_params.items():
        err = np.max(np.abs(state.params[k].numpy() - v))
        assert err <= 1e-2 * np.max(np.abs(v)), (k, err)
