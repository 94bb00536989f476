"""repro_torch precision primitives against the JAX reference
(``repro.core.quantize``) on the same numpy inputs.

Tolerances: the hi/lo split is pinned bitwise (both round to nearest
even); products use ``tests/test_kernels.py``'s atol 1e-4, since the two
frameworks accumulate the exact bf16 partial products in different
orders.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro_torch.core import quantize as tq


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _inputs(seed, shape):
    r = np.random.default_rng(seed)
    x = (r.standard_normal(shape) * 10.0 ** r.integers(-6, 6, shape)).astype(
        np.float32)
    x.flat[:4] = [0.0, -0.0, 1e-30, 3.0e38]
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_hi_lo_bitwise(seed):
    x = _inputs(seed, (64, 48))
    jh, jl = jq.split_hi_lo_bf16(jnp.asarray(x))
    th, tl = tq.split_hi_lo_bf16(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(th), _bits(jh))
    np.testing.assert_array_equal(_bits(tl), _bits(jl))


def test_split_limbs_bitwise():
    x = _inputs(3, (32, 32))
    for a, b in zip(tq.split_limbs_bf16(torch.from_numpy(x)),
                    jq.split_limbs_bf16(jnp.asarray(x))):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("m,k,n", [(64, 48, 32), (128, 128, 128),
                                   (3, 200, 7)])
def test_hilo_matmul_matches_reference(m, k, n):
    r = np.random.default_rng(m + k + n)
    a = r.standard_normal((m, k)).astype(np.float32)
    b = r.standard_normal((k, n)).astype(np.float32)
    got = tq.hilo_matmul(torch.from_numpy(a), torch.from_numpy(b))
    want = jq.hilo_matmul(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_hilo_matmul_exact_lhs_matches_reference():
    r = np.random.default_rng(7)
    a16 = jnp.asarray(r.standard_normal((96, 64)), jnp.bfloat16)
    b = r.standard_normal((64, 80)).astype(np.float32)
    a_np = np.array(a16.astype(jnp.float32))
    got = tq.hilo_matmul_exact_lhs(
        torch.from_numpy(a_np).to(torch.bfloat16), torch.from_numpy(b))
    want = jq.hilo_matmul_exact_lhs(a16, jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("precision", ["fp32", "hilo"])
def test_lowp_einsum_matches_reference(precision):
    r = np.random.default_rng(11)
    a = r.standard_normal((5, 32, 24)).astype(np.float32)
    b = r.standard_normal((5, 24, 16)).astype(np.float32)
    spec = "nab,nbc->nac"
    got = tq.lowp_einsum(spec, torch.from_numpy(a), torch.from_numpy(b),
                         precision=precision)
    want = jq.lowp_einsum(spec, jnp.asarray(a), jnp.asarray(b),
                          precision=precision)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_precision_kind_rejects_unported_modes():
    """Every mode of the reference is ported (the integer-sliced ones
    too); a mode neither package has raises."""
    assert tq.precision_kind(None) == "fp32"
    assert tq.precision_kind("hilo") == "hilo"
    assert tq.precision_kind("int8") == (24, 8)
    for bad in ("bf16", "fp8", "int8b16"):
        with pytest.raises(ValueError, match="precision"):
            tq.precision_kind(bad)
