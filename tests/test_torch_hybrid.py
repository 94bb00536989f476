"""repro_torch's hybrid family (recurrentgemma-9b's smoke config: one
pattern unit of rec, rec and local attention, then a one-layer tail)
against the JAX reference on converted weights: windowed attention and
the RG-LRU mixer alone, loss, logits and every gradient in fp32 and
bf16, the K-FAC statistics of the unit stack and of the unstacked tail,
and a 4-step K-FAC trajectory through ``launch.train.run``.

The port scans the RG-LRU recurrence in chunks (``layers.linear_scan``)
where the reference runs ``jax.lax.associative_scan``, so sums run in
another order. Where that shows, the dense family's tolerances
(``tests/_torch_families.py``) are loosened, measured in brackets:
  * fp32 gradients: atol 5e-6 instead of 1e-6 (1.7e-6 beyond rtol, on
    embedding entries of a leaf whose largest entry is 1.42; 2.5e-6
    with a scan stepped through time).
  * stats factors: atol 3e-6 of the factor's largest entry instead of
    1e-6 (0.98e-6 of it beyond rtol, on ``mlp/wg``'s G; 1.2e-6 on
    ``rec/out``'s G with the stepped scan: their tap gradients come back
    through the recurrence).
  * bf16 gradients of ``rec/lam``: 10% of the leaf's largest entry
    instead of 5% (5.2%): every channel's gradient sums the decay's
    derivative over all tokens through bf16-rounded gates, and the
    reference's own bf16 and fp32 gradients of that leaf are 4% apart.
The mixers alone: rtol 1e-5 with atol 1e-6 in fp32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_families as fam
from _torch_families import one_thread  # noqa: F401 (autouse)
from repro.configs import get_config
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import soi
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import rglru as trglru

ARCH = "recurrentgemma-9b"


def test_windowed_attention_matches_reference():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 80, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 80, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, 80, 1, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(80, dtype=np.int32), (2, 80))
    for chunk in (0, 64):
        want = jlayers.attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                 window=32, chunk=chunk)
        got = tlayers.attention(*map(torch.from_numpy, (q, k, v)),
                                torch.from_numpy(pos.copy()),
                                torch.from_numpy(pos.copy()),
                                chunk=chunk, window=32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_rglru_mixer_matches_reference():
    jcfg, tcfg = fam.cfgs(ARCH)
    p = jax.device_get(jrglru.init_rglru(jcfg, jax.random.PRNGKey(5)))
    x = np.random.default_rng(6).standard_normal(
        (2, 40, jcfg.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p, x: jrglru.rglru_mixer(
        jcfg, p, x, None, "r"))(p, jnp.asarray(x))
    got, _ = trglru.rglru_mixer(tcfg, {k: torch.from_numpy(np.array(v))
                                    for k, v in p.items()},
                             torch.from_numpy(x), None, "r")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_loss_logits_and_grads_match_reference_fp32():
    # the reference jitted as a whole: op by op its unit scan takes
    # half a minute to compile here
    fam.check_fp32(ARCH, grad_atol=5e-6, compiled=True)


def test_loss_logits_and_grads_match_reference_bf16():
    fam.check_bf16(ARCH, grad_rel={"rec/lam": 0.10}, compiled_fp32=True)


def test_stats_factors_match_reference():
    """The unit stack's factors carry the (n_units,) stack, the tail's
    none."""
    state = fam.check_stats(ARCH, atol_rel=3e-6)
    f = state.kfac.factors
    assert f["units/sub0/rec/w_a"]["A"].ndim == 4
    assert f["tail/sub0/rec/w_a"]["A"].ndim == 3
    assert f["units/sub2/attn/wq"]["A"].shape[0] == 1


def test_four_step_trajectory_matches_reference():
    fam.check_trajectory(ARCH)


def test_kfac_specs_match_reference_full_width():
    """recurrentgemma-9b: 12 units of (rec, rec, local) and a tail of
    (rec, rec) without a stack dim, as in the reference."""
    jcfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    jspecs, tspecs = fam.jlm.kfac_specs(jcfg), tlm.kfac_specs(tcfg)
    assert {k: (s.d_in, s.d_out, s.stack, s.share_a_with)
            for k, s in tspecs.items()} == \
        {k: (s.d_in, s.d_out, s.stack, s.share_a_with)
         for k, s in jspecs.items()}
    assert tspecs["units/sub2/attn/wq"].stack == (12,)
    assert tspecs["tail/sub1/rec/out"].stack == ()
    assert soi.factor_shapes(tspecs["tail/sub1/mlp/wd"], 128)["A"] == \
        (96, 128, 128)
