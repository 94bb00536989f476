"""repro_torch.core.precision_inv against the JAX reference's
``repro.core.precision_inv``: the numpy circuit model (Loop A/x/b, the
fused MM-INV, the quantized problem) bitwise, the ``CircuitConfig``
cycle model exactly, and ``mxu_inv_apply`` (composed inverse, then
``bitslice_mm``) at the composed inverse's cross-framework tolerance,
5e-5 relative to the largest entry (``tests/test_torch_kernels.py``
states why it is not the 1e-5 that holds within one framework).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from _torch_families import one_thread  # noqa: F401 (autouse)

from repro.core import precision_inv as jpi
from repro.core import quantize as jq
from repro_torch.core import precision_inv as tpi
from repro_torch.core import quantize as tq
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

#: the Fig. 5 toy of examples/precision_inv_demo.py
TOY = dict(q_a=8, q_b=4, q_x=4, r_dac=2, r_adc=2, r_c=4, k=1, n_taylor=4)


def _damped_gram(rng, n, aspect=4, damp=0.1):
    a = rng.standard_normal((n, aspect * n)) / np.sqrt(aspect * n)
    A = a @ a.T
    lam = damp * np.trace(A) / n
    return A + lam * np.eye(n), lam


def _demo_block(rng, n, ridge=None):
    m = rng.standard_normal((n, n))
    A = m @ m.T / n
    if ridge is None:
        A += 0.03 * np.trace(A) / n * np.eye(n)
    else:
        A += ridge * np.eye(n)
    return A, rng.standard_normal(n)


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# CircuitConfig
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, TOY, dict(n_taylor=26),
                                dict(q_x=12, r_adc=5, r_dac=3, k=3)])
def test_circuit_config_matches_reference(kw):
    t, j = tq.CircuitConfig(**kw), jq.CircuitConfig(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for attr in ("hi_bits", "loops_x", "loops_b"):
        assert getattr(t, attr) == getattr(j, attr)
    assert t.cycles_inv() == j.cycles_inv()
    assert t.cycles_inv_fused() == j.cycles_inv_fused()
    assert tpi.CircuitConfig is tq.CircuitConfig


def test_cycle_model():
    cfg = tq.CircuitConfig()
    # Eqn 10: N(2*ceil(Qb/Rdac)*ceil(Qx/Radc) + ceil(Qx/Rdac)); Eqn 14
    assert cfg.cycles_inv() == 18 * (2 * 4 * 2 + 4)
    assert cfg.cycles_inv_fused() == 18 * (2 * 4 * 2 + 2 * 4)


# ---------------------------------------------------------------------------
# The circuit model, bitwise
# ---------------------------------------------------------------------------

def test_fig5_toy_is_bitwise_the_reference():
    rng = np.random.default_rng(1)
    A, b = _demo_block(rng, 8, ridge=0.3)
    t_cfg, j_cfg = tq.CircuitConfig(**TOY), jq.CircuitConfig(**TOY)
    for got, want in zip(tpi.quantize_problem(A, b, t_cfg),
                         jpi.quantize_problem(A, b, j_cfg)):
        _same(got, want)
    x = tpi.faithful_inv_apply(A, b, t_cfg)
    _same(x, jpi.faithful_inv_apply(A, b, j_cfg))
    aq, bq = tpi.quantize_problem(A, b, t_cfg)
    assert tpi.achieved_bits(x, np.linalg.solve(aq, bq)) == \
        jpi.achieved_bits(x, np.linalg.solve(aq, bq))


def test_production_config_with_trace_is_bitwise_the_reference():
    rng = np.random.default_rng(2)
    A, b = _demo_block(rng, 128)
    x, trace = tpi.faithful_inv_apply(A, b, tq.CircuitConfig(),
                                      return_trace=True)
    jx, jtrace = jpi.faithful_inv_apply(A, b, jq.CircuitConfig(),
                                        return_trace=True)
    _same(x, jx)
    assert len(trace) == len(jtrace) == 18
    for t, j in zip(trace, jtrace):
        _same(t, j)
    aq, bq = tpi.quantize_problem(A, b)
    assert tpi.achieved_bits(x, np.linalg.solve(aq, bq)) >= 16.0


def test_matrix_rhs_is_bitwise_the_reference():
    rng = np.random.default_rng(3)
    A, _ = _damped_gram(rng, 128)
    B = rng.standard_normal((128, 8))
    X = tpi.faithful_inv_apply(A, B, tq.CircuitConfig())
    _same(X, jpi.faithful_inv_apply(A, B, jq.CircuitConfig()))
    aq, bq = tpi.quantize_problem(A, B)
    assert tpi.achieved_bits(X, np.linalg.solve(aq, bq)) >= 14.0


def test_saturating_rhs_is_bitwise_the_reference():
    rng = np.random.default_rng(11)
    A, _ = _damped_gram(rng, 64)
    b = rng.standard_normal(64)
    b[0] = -np.max(np.abs(b)) * 4   # dominates the DAC range: code -2**q_b
    x = tpi.faithful_inv_apply(A, b, tq.CircuitConfig())
    _same(x, jpi.faithful_inv_apply(A, b, jq.CircuitConfig()))
    aq, bq = tpi.quantize_problem(A, b)
    assert tpi.achieved_bits(x, np.linalg.solve(aq, bq)) >= 13.0


def test_loop_b_saturated_rhs_keeps_the_symmetric_clip():
    cfg = tq.CircuitConfig()
    lu = sla.lu_factor(np.eye(16))
    r = np.zeros(16)
    r[0] = -1.0     # rhs_scale 1.0: code -2**q_b before the clip
    x = tpi._loop_b_solve(lu, r, cfg, 1.0)
    _same(x, jpi._loop_b_solve(lu, r, jq.CircuitConfig(), 1.0))
    assert abs(x[0] + (1.0 - 2.0 ** -cfg.q_b)) < 2.0 ** -12
    assert np.all(x[1:] == 0.0)


def test_fused_gram_circuit_is_bitwise_the_reference():
    rng = np.random.default_rng(5)
    n = 128
    a = rng.standard_normal((n, 4 * n)) / np.sqrt(4 * n)
    A = a @ a.T
    lam = 0.1 * np.trace(A) / n
    b = rng.standard_normal(n)
    x = tpi.faithful_fused_gram_inv_apply(a, b, lam, tq.CircuitConfig())
    _same(x, jpi.faithful_fused_gram_inv_apply(a, b, lam,
                                               jq.CircuitConfig()))
    x_ref = np.linalg.solve(A + lam * np.eye(n), b)
    assert tpi.achieved_bits(x, x_ref) >= 12.0


def test_quickstart_circuit_reaches_16_bits():
    """examples/quickstart.py's block (n = 256, seed 0) at n_taylor=26."""
    rng = np.random.default_rng(0)
    n = 256
    m = rng.standard_normal((n, n))
    A = m @ m.T / n
    A += 0.03 * np.trace(A) / n * np.eye(n)
    b = rng.standard_normal(n)
    cfg = tq.CircuitConfig(n_taylor=26)
    x = tpi.faithful_inv_apply(A, b, cfg)
    _same(x, jpi.faithful_inv_apply(A, b, jq.CircuitConfig(n_taylor=26)))
    aq, bq = tpi.quantize_problem(A, b, cfg)
    assert tpi.achieved_bits(x, np.linalg.solve(aq, bq)) >= 16.0


def test_achieved_bits_matches_reference():
    x = np.array([1.0, 2.0, -3.0])
    for y in (x, x + 1e-3, x * 0.5, np.zeros(3)):
        assert tpi.achieved_bits(y, x) == jpi.achieved_bits(y, x)
    assert tpi.achieved_bits(x, x) == 64.0


# ---------------------------------------------------------------------------
# mxu_inv_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(128, 16), (64, 64), (96, 1)])
def test_mxu_inv_apply_matches_reference(n, m):
    rng = np.random.default_rng(8 + n)
    A, lam = _damped_gram(rng, n, damp=0.1)
    a32 = (A - lam * np.eye(n)).astype(np.float32)
    B = rng.standard_normal((n, m)).astype(np.float32)
    kw = dict(ns_iters=20, taylor_terms=4, refine_steps=2)
    got = tpi.mxu_inv_apply(torch.from_numpy(a32), torch.from_numpy(B),
                            lam, **kw).numpy()
    want = np.asarray(jpi.mxu_inv_apply(jnp.asarray(a32), jnp.asarray(B),
                                        lam, **kw))
    assert got.shape == want.shape == (n, m)
    assert np.max(np.abs(got - want)) <= 5e-5 * np.max(np.abs(want))
    x_ref = np.linalg.solve(A, B)
    assert np.max(np.abs(got - x_ref)) / np.max(np.abs(x_ref)) < 2.0 ** -10


def test_mxu_inv_apply_product_is_the_plain_bitslice_mm():
    """On CPU tensors the product is bitwise the plain ``bitslice_mm``
    of the composed inverse, and launches nothing."""
    rng = np.random.default_rng(4)
    A, lam = _damped_gram(rng, 64)
    a = torch.from_numpy(A.astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    ops.reset_launch_counts()
    got = tpi.mxu_inv_apply(a, b.to(torch.bfloat16), 0.0, ns_iters=16)
    m = tpi.composed_inverse(a, 0.0, ns_iters=16)
    torch.testing.assert_close(
        got, tref.bitslice_mm_ref(m, b.to(torch.bfloat16)), rtol=0, atol=0)
    assert ops.launch_counts()["bitslice_mm"] == 0


def test_quickstart_composed_inverse_beats_bf16():
    """examples/quickstart.py's tensor-core route: the port's composed
    inverse gains more than 4 bits over the bare bf16 primitive, and as
    many as the reference's."""
    rng = np.random.default_rng(0)
    n = 256
    m = rng.standard_normal((n, n))
    A = m @ m.T / n
    A += 0.03 * np.trace(A) / n * np.eye(n)
    b = rng.standard_normal(n)
    x_ref = np.linalg.solve(A, b)
    a_bf16 = torch.from_numpy(A).to(torch.bfloat16).to(torch.float64)
    bits_low = tpi.achieved_bits(np.linalg.solve(a_bf16.numpy(), b), x_ref)
    kw = dict(ns_iters=20, taylor_terms=4, refine_steps=2)
    M = tpi.composed_inverse(torch.from_numpy(A.astype(np.float32)), 0.0,
                             **kw).numpy()
    bits = tpi.achieved_bits(M @ b, x_ref)
    jM = np.asarray(jpi.composed_inverse(jnp.asarray(A, jnp.float32), 0.0,
                                         **kw))
    assert bits > bits_low + 4
    assert abs(bits - tpi.achieved_bits(jM @ b, x_ref)) < 1.0
