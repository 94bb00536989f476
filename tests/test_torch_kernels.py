"""repro_torch kernels: the plain versions against the JAX reference's
oracles and Pallas kernels (interpret mode), and the device dispatch.
The CUDA kernels themselves are held to the plain versions on the card
by tests/test_torch_cuda.py.

Tolerances and why:
  * neumann_inv plain vs ``ref.neumann_inv_ref``: 5e-5 relative to the
    largest entry. ``tests/test_kernels.py`` holds the Pallas kernel to
    that oracle at atol 1e-5, but there both run XLA's fp32 matmul;
    across frameworks the exact bf16 partial products are summed in
    another order, and the 127 chained products carry that difference
    to the algorithm's own error against the exact inverse (measured:
    up to 2.1e-5 relative between the frameworks, ~5e-5 for either
    against float64 ``inv``). ``composed_inverse`` likewise.
  * neumann_inv plain vs the Pallas kernel: only at n = 128, where the
    kernel does not pad; 5e-5 relative for the same reason.
  * fused_precond plain vs ``ref.fused_precond_ref``: 1e-5 relative
    (summation order); vs ``exact_two_sided`` below 1e-4 relative, the
    bound ``tests/test_wu_fusion.py`` puts on the kernel.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision_inv as jpi
from repro.kernels import fused_precond as j_fused_precond
from repro.kernels import neumann_inv as j_neumann_inv
from repro.kernels import ref as jref
from repro_torch.core import precision_inv as tpi
from repro_torch.kernels import fused_precond as t_fused_precond
from repro_torch.kernels import neumann_inv as t_neumann_inv
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

KW = dict(ns_iters=20, taylor_terms=4, refine_steps=2)   # KFACConfig counts


def _spd(r, nb, n):
    m = r.standard_normal((nb, n, n)).astype(np.float32)
    return (np.einsum("bij,bkj->bik", m, m) / n
            + 1e-3 * np.eye(n, dtype=np.float32))


def _damped(seed, nb, n):
    r = np.random.default_rng(seed)
    a = _spd(r, nb, n)
    damp = (0.03 * np.trace(a, axis1=1, axis2=2) / n).astype(np.float32)
    return a, damp


def _tiles(seed, n, bi, bo):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(s).astype(np.float32)
                 for s in ((n, bi, bi), (n, bi, bo), (n, bo, bo)))


def _assert_rel(got, want, tol):
    """max |got - want| <= tol * max |want|."""
    want = np.asarray(want)
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# neumann_inv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb,n", [(1, 128), (3, 96), (2, 130), (4, 64),
                                  (2, 32)])
def test_neumann_inv_plain_matches_reference_oracle(nb, n):
    a, damp = _damped(nb * 1000 + n, nb, n)
    got = tref.neumann_inv_ref(torch.from_numpy(a), torch.from_numpy(damp),
                               **KW)
    want = jref.neumann_inv_ref(jnp.asarray(a), jnp.asarray(damp), **KW)
    _assert_rel(got.numpy(), want, 5e-5)


def test_neumann_inv_plain_matches_pallas_kernel_at_128():
    a, damp = _damped(5, 2, 128)
    got = tref.neumann_inv_ref(torch.from_numpy(a), torch.from_numpy(damp),
                               **KW)
    want = j_neumann_inv(jnp.asarray(a), jnp.asarray(damp), **KW)
    _assert_rel(got.numpy(), want, 5e-5)


def test_neumann_inv_scalar_damping_broadcasts():
    a, _ = _damped(6, 3, 32)
    ta = torch.from_numpy(a)
    got = tref.neumann_inv_ref(ta, 0.1, **KW)
    vec = tref.neumann_inv_ref(ta, torch.full((3,), 0.1), **KW)
    torch.testing.assert_close(got, vec, rtol=0, atol=0)
    with pytest.raises(ValueError, match="damping"):
        tref.neumann_inv_ref(ta, torch.ones(2), **KW)


@pytest.mark.parametrize("taylor", [4, 1])
def test_composed_inverse_matches_reference(taylor):
    a, damp = _damped(7, 3, 64)
    got = tpi.composed_inverse(torch.from_numpy(a), torch.from_numpy(damp),
                               ns_iters=20, taylor_terms=taylor,
                               refine_steps=2)
    want = np.stack([np.asarray(jpi.composed_inverse(
        jnp.asarray(a[i]), float(damp[i]), ns_iters=20, taylor_terms=taylor,
        refine_steps=2)) for i in range(3)])
    _assert_rel(got.numpy(), want, 5e-5)


def test_neumann_inv_is_accurate_inverse():
    """The algorithm (not a port artefact): at the paper's damping the
    hi/lo ladder reaches ~2^-14 relative, as the reference's own test
    states."""
    a, damp = _damped(11, 2, 128)
    got = tref.neumann_inv_ref(torch.from_numpy(a), torch.from_numpy(damp),
                               ns_iters=20, taylor_terms=5, refine_steps=2)
    ad = a + damp[:, None, None] * np.eye(128, dtype=np.float32)
    exact = np.linalg.inv(ad.astype(np.float64))
    rel = np.max(np.abs(got.numpy() - exact)) / np.max(np.abs(exact))
    assert rel < 2.0 ** -13


# ---------------------------------------------------------------------------
# fused_precond
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 16, 8), (3, 128, 64), (2, 130, 200),
                                   (4, 128, 128)])
def test_fused_precond_plain_matches_reference(shape):
    a, g, gi = _tiles(0, *shape)
    out, dots = tref.fused_precond_ref(torch.from_numpy(a),
                                       torch.from_numpy(g),
                                       torch.from_numpy(gi))
    want_out, want_dots = jref.fused_precond_ref(
        jnp.asarray(a), jnp.asarray(g), jnp.asarray(gi))
    _assert_rel(out.numpy(), want_out, 1e-5)
    np.testing.assert_allclose(dots.numpy(), np.asarray(want_dots),
                               rtol=1e-4, atol=1e-2)
    ex = np.asarray(jref.exact_two_sided(jnp.asarray(a), jnp.asarray(g),
                                         jnp.asarray(gi)))
    assert np.max(np.abs(out.numpy() - ex)) / np.max(np.abs(ex)) < 1e-4
    np.testing.assert_allclose(
        tref.exact_two_sided(torch.from_numpy(a), torch.from_numpy(g),
                             torch.from_numpy(gi)).numpy(),
        ex, rtol=1e-5, atol=1e-3)


def test_fused_precond_plain_matches_pallas_kernel():
    a, g, gi = _tiles(1, 3, 128, 128)
    out, dots = tref.fused_precond_ref(torch.from_numpy(a),
                                       torch.from_numpy(g),
                                       torch.from_numpy(gi))
    want_out, want_dots = j_fused_precond(jnp.asarray(a), jnp.asarray(g),
                                          jnp.asarray(gi))
    _assert_rel(out.numpy(), want_out, 1e-5)
    np.testing.assert_allclose(dots.numpy(), np.asarray(want_dots),
                               rtol=1e-4, atol=1e-2)


def test_fused_precond_dot_is_trust_region_mass():
    a, g, gi = (torch.from_numpy(x) for x in _tiles(2, 4, 16, 16))
    out, dots = tref.fused_precond_ref(a, g, gi)
    torch.testing.assert_close(dots, (out * g).sum(dim=(-2, -1)),
                               rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# dispatch and wrappers
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    ops.reset_launch_counts()
    a, damp = _damped(3, 2, 32)
    ta, td = torch.from_numpy(a), torch.from_numpy(damp)
    torch.testing.assert_close(ops.neumann_inv(ta, td, **KW),
                               tref.neumann_inv_ref(ta, td, **KW),
                               rtol=0, atol=0)
    x = tuple(torch.from_numpy(v) for v in _tiles(4, 3, 32, 16))
    for got, want in zip(ops.fused_precond(*x), tref.fused_precond_ref(*x)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    inv = torch.linalg.inv(ta + 0.1 * torch.eye(32))
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 4, 32)).astype(np.float32))
    torch.testing.assert_close(
        ops.smw_update(inv, v, decay=0.95, cscale=0.05),
        tref.smw_update_ref(inv, v, decay=0.95, cscale=0.05),
        rtol=0, atol=0)
    assert ops.launch_counts() == {"neumann_inv": 0, "fused_precond": 0,
                                   "smw_update": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    a, damp = _damped(3, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        t_neumann_inv.neumann_inv(torch.from_numpy(a), torch.from_numpy(damp),
                                  **KW)
    x = tuple(torch.from_numpy(v) for v in _tiles(4, 3, 32, 16))
    with pytest.raises(ValueError, match="CUDA"):
        t_fused_precond.fused_precond(*x)


def test_mixed_devices_are_refused():
    x = tuple(torch.from_numpy(v) for v in _tiles(4, 3, 32, 16))
    with pytest.raises(ValueError, match="all on"):
        ops.fused_precond(x[0], x[1].to("meta"), x[2])


def test_build_names_carry_a_source_digest():
    for lib in ops.LIBRARIES.values():
        assert lib.source.exists()
        assert lib.path.name.startswith(f"lib{lib.name}-")
