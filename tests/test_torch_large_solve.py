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
  * the routes' schedules run by a plain emulation of each kernel
    (``hilo_matmul`` for each product, ``solve_ex`` for the solve, the
    finish's division and damping), bitwise ``smw_update_ref`` and
    ``fused_gram_inv_ref``, for k <= 128 (the slab solve) and k > 128
    (the blocked LU); no product writes an operand it reads;
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
from repro_torch.core.quantize import hilo_matmul
from repro_torch.kernels import fused_gram_solve as t_gram
from repro_torch.kernels import hilo_bmm
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

def _smw_emulate(inv, v, *, decay, cscale):
    """The large route on the CPU: the prep kernel's M, each product's
    partials and epilogue, the solve as ``solve_ex`` (the slab and the
    blocked LU both solve (S + I/c) Z = Y, the diagonal term added as
    ``acc + 1/c``; it stands in at the solve's last launch), in
    :func:`smw_schedule`'s order."""
    inv_decay, inv_c = tref.smw_scalars(decay, cscale)
    k = v.shape[-2]
    buf = {"inv": inv, "v": v}
    for step in t_smw.smw_schedule(k):
        if step[0] == "prep":
            _, src, dst = step
            buf[dst] = (buf[src] + buf[src].transpose(-1, -2)) * inv_decay
        elif step[0] == "product":
            _, mode, epi, lft, lt, rgt, rt, c, e = step
            assert mode == hilo_bmm.FULL
            left = buf[lft].transpose(-1, -2) if lt else buf[lft]
            right = buf[rgt].transpose(-1, -2) if rt else buf[rgt]
            acc = hilo_matmul(left, right)
            if epi == hilo_bmm.STORE:
                buf[c] = acc
            elif epi == hilo_bmm.SUB:
                buf[c] = buf[e] - acc
            else:
                raise AssertionError(f"epilogue {epi} in the update")
        else:
            _, kind, _, _, _, _ = step
            assert (kind == "slab") == (k <= 128)
            if kind in ("slab", "back"):
                eye = torch.eye(k, dtype=torch.float32)
                buf["z"] = torch.linalg.solve_ex(buf["s"] + eye * inv_c,
                                                 buf["y"])[0]
    return buf["out"]


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
        if step[0] != "solve":
            continue
        _, kind, j0, j1, reads, _ = step
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
    """Every kernel reads only what the caller gave or an earlier kernel
    wrote; no product writes an operand it reads (other CTAs still read
    it); the solve's launches make Z from S and Y (the LU factors S in
    place and records its row sources, which no later product reads)
    and the last product writes the output."""
    steps = t_smw.smw_schedule(k)
    written = {"inv", "v"}
    for i, step in enumerate(steps):
        if step[0] == "prep":
            _, src, dst = step
            assert src in written and dst != src
            written.add(dst)
        elif step[0] == "product":
            _, _, _, lft, _, rgt, _, c, e = step
            assert {lft, rgt} <= written and (e is None or e in written)
            assert c not in (lft, rgt, e, "inv", "v")
            written.add(c)
        else:
            _, kind, j0, j1, reads, writes = step
            assert set(reads) <= written
            assert "y" not in writes and {"inv", "v", "m"}.isdisjoint(writes)
            assert all(st[0] == "solve" or not {"s", "piv"} & set(st[3:9])
                       for st in steps[i + 1:])
            written.update(writes)
    assert steps[-1][7] == "out"
    names = {c for st in steps if st[0] != "solve" for c in st[1:]
             if isinstance(c, str)}
    names |= {c for st in steps if st[0] == "solve" for c in st[4] + st[5]}
    assert names <= set(t_smw.buffer_shapes(8, 8))
    assert set(t_smw.BUFFERS) - ({"piv"} if k <= 128 else set()) <= written


def _gram_emulate(a, *, rel_damp, **counts):
    """The large Gram route on the CPU: the product (block i of the fp32
    upcast read transposed on the left, as it is on the right), the
    finish kernel's division and damping, then neumann_inv's large
    route (bitwise ``neumann_inv_ref``:
    tests/test_torch_large_blocks.py)."""
    t = a.shape[0]
    blocks = a.to(torch.float32).movedim(1, 0)   # (nb, T, n)
    gram = hilo_matmul(blocks.transpose(-1, -2), blocks) / t
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
# plans, chunks and launches (pure functions)
# ---------------------------------------------------------------------------

def test_smw_plan_and_expected_launches():
    assert t_smw.block_bytes(176, 64) == 4 * (176 * 176 + 2 * 64 * 176
                                              + 64 * 64)
    # above k 128 the LU's row sources, k int32 (a row of 132) a block
    assert t_smw.block_bytes(130, 129) == 4 * (130 * 132 + 2 * 129 * 132
                                               + 129 * 132 + 132)
    assert t_smw.block_bytes(1024, 1024) == 4 * (4 * 1024 * 1024 + 1024)
    # the main path at block 256, rank 64 and 256: one chunk a side
    assert t_smw.smw_plan(768, 256, 64) == [(0, 768)]
    assert t_smw.smw_plan(1152, 176, 64) == [(0, 1152)]
    assert t_smw.smw_plan(768, 256, 256) == [(0, 768)]
    assert t_smw.smw_plan(1152, 176, 256) == [(0, 1152)]
    # 1024 x 1024: 16 MiB and 4 KiB a block, 63 under 1 GiB: four
    # chunks of 48
    parts = t_smw.smw_plan(192, 1024, 1024)
    assert parts == [(0, 48), (48, 96), (96, 144), (144, 192)]
    for nb, bs, k in ((192, 1024, 1024), (5000, 256, 256), (7, 129, 64)):
        parts = t_smw.smw_plan(nb, bs, k)
        assert parts[0][0] == 0 and parts[-1][1] == nb
        assert all(b1 == c0 for (_, b1), (c0, _) in zip(parts, parts[1:]))
        assert max(b1 - b0 for b0, b1 in parts) * \
            t_smw.block_bytes(bs, k) <= hilo_bmm.WORKSPACE_BYTES
    assert t_smw.smw_plan(5, 256, 64, budget=1) == \
        [(b, b + 1) for b in range(5)]
    assert t_smw.expected_launches(128, 64, 528) == 1
    assert t_smw.expected_launches(128, 128, 528) == 1
    # prep, 2 products, the slab solve, the last product
    assert t_smw.expected_launches(256, 64, 768) == 5
    # above k 128 two launches a panel of 32 and the back substitution
    assert t_smw.expected_launches(128, 129, 3) == 4 + 2 * 5 + 1
    assert t_smw.expected_launches(256, 256, 768) == 4 + 2 * 8 + 1
    assert t_smw.expected_launches(176, 256, 1152) == 21
    assert t_smw.expected_launches(1024, 1000, 2) == 4 + 2 * 32 + 1
    assert t_smw.expected_launches(1024, 1024, 192) == 4 * 69
    assert t_smw.expected_launches(256, 64, 0) == 0
    assert [s[1] for s in t_smw.smw_schedule(128) if s[0] == "solve"] == \
        ["slab"]
    assert [s[1] for s in t_smw.smw_schedule(129) if s[0] == "solve"] == \
        ["panel", "update"] * 5 + ["back"]
    assert t_smw.launch_key(176, 64) == "bs176k64"


def test_gram_plan_and_expected_launches():
    assert t_gram.gram_plan(1152, 176) == [(0, 1152)]
    parts = t_gram.gram_plan(600, 1024)
    assert parts[0][0] == 0 and parts[-1][1] == 600
    assert max(b1 - b0 for b0, b1 in parts) * 4 * (1024 * 1024 + 1) <= \
        hilo_bmm.WORKSPACE_BYTES
    per = t_neumann_inv.launches_per_chunk(**KW)
    # 1152 blocks of 176: one Gram chunk, neumann_inv's 2 chunks of 576
    assert t_gram.expected_launches(1152, 176, **KW) == \
        {"fused_gram_inv": 2, "neumann_inv": 2 * per}
    # 192 blocks of 1024: one Gram chunk, neumann_inv's 6 chunks of 32
    assert t_gram.expected_launches(192, 1024, **KW) == \
        {"fused_gram_inv": 2, "neumann_inv": 6 * per}
    assert t_gram.expected_launches(528, 128, **KW) == \
        {"fused_gram_inv": 1, "neumann_inv": 0}
    assert t_gram.expected_launches(0, 256, **KW) == \
        {"fused_gram_inv": 0, "neumann_inv": 0}


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
    assert hilo_bmm.SUB == 6


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
