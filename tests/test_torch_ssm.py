"""repro_torch's SSM family (falcon-mamba-7b at smoke size) against the
JAX reference on converted weights: the Mamba mixer alone, loss, logits
and every gradient in fp32 and bf16, the K-FAC statistics, and a 4-step
K-FAC trajectory through ``launch.train.run``; with the registry's
decoder archs and the families' parameter shapes.

The port scans in two levels over chunks of steps
(``layers.linear_scan``) where the reference runs
``jax.lax.associative_scan``: the sums run in another order. The dense
family's tolerances (``tests/_torch_families.py``) hold as they are;
the mixer alone is held to rtol 1e-5 with atol 1e-6 in fp32, and the
scan to the recurrence in float64 at the same tolerance (its fp32
gradients at rtol 1e-4 with atol 1e-5: they sum over the chunks'
products).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fam
from _torch_families import one_thread  # noqa: F401 (autouse)
from repro.configs import get_config
from repro.core import soi as jsoi
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config as t_get_config
from repro_torch.core import soi
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm

ARCH = "falcon-mamba-7b"
DECODER_ARCHS = [a for a in ARCHS if a != "whisper-tiny"]


def test_mamba_mixer_matches_reference():
    jcfg, tcfg = fam.cfgs(ARCH)
    p = jax.device_get(jssm.init_mamba(jcfg, jax.random.PRNGKey(5)))
    x = np.random.default_rng(6).standard_normal(
        (2, 40, jcfg.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p, x: jssm.mamba_mixer(
        jcfg, p, x, None, "m"))(p, jnp.asarray(x))
    got, _ = tssm.mamba_mixer(tcfg, {k: torch.from_numpy(np.array(v))
                                  for k, v in p.items()},
                           torch.from_numpy(x), None, "m")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("T,state", [(9, (3, 4)), (40, (3, 4)),
                                     (48, (3, 4)), (40, (5,))])
def test_linear_scan_is_the_recurrence(T, state):
    """The chunked scan (one chunk, a padded last chunk, whole chunks;
    Mamba's (D, n) state and RG-LRU's (D,)) against the recurrence
    written out in float64, values and gradients."""
    g = torch.Generator().manual_seed(T + len(state))
    decay = torch.rand((2, T) + state, generator=g).requires_grad_()
    inp = torch.randn((2, T) + state, generator=g).requires_grad_()
    h = torch.zeros((2,) + state, dtype=torch.float64)
    want = []
    for t in range(T):
        h = decay[:, t].double() * h + inp[:, t].double()
        want.append(h)
    want = torch.stack(want, 1)
    got = tlayers.linear_scan(decay, inp)
    np.testing.assert_allclose(got.detach().numpy(),
                               want.detach().numpy(), rtol=1e-5, atol=1e-6)
    w = torch.randn(want.shape, generator=g, dtype=torch.float64)
    g_got = torch.autograd.grad((got.double() * w).sum(), (decay, inp))
    g_want = torch.autograd.grad((want * w).sum(), (decay, inp))
    for a, b in zip(g_got, g_want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_loss_logits_and_grads_match_reference_fp32():
    fam.check_fp32(ARCH)


def test_loss_logits_and_grads_match_reference_bf16():
    fam.check_bf16(ARCH)


def test_stats_factors_match_reference():
    fam.check_stats(ARCH)


def test_four_step_trajectory_matches_reference():
    fam.check_trajectory(ARCH)


def test_x_proj_factor_has_a_padded_last_block():
    """At the published widths x_proj's output is dt_rank + 2 n = 288:
    its G factor is three 128-blocks, the last one padded, as in the
    reference."""
    jcfg, tcfg = get_config(ARCH), t_get_config(ARCH)
    spec = tlm.kfac_specs(tcfg)["layers/mamba/x_proj"]
    assert spec.d_out == 288
    shapes = soi.factor_shapes(spec, 128)
    assert shapes["G"] == (64, 3, 128, 128)
    jspecs = fam.jlm.kfac_specs(jcfg)
    assert {k: soi.factor_shapes(s, 128) for k, s in
            tlm.kfac_specs(tcfg).items()} == \
        {k: jsoi.factor_shapes(s, 128) for k, s in jspecs.items()}


def test_registry_runs_every_decoder_arch():
    from repro_torch.configs import get_smoke_config
    for arch in DECODER_ARCHS:
        assert t_get_config(arch).name == get_config(arch).name
        assert get_smoke_config(arch).family == get_config(arch).family
    assert t_get_config("whisper-tiny").name == \
        get_config("whisper-tiny").name


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_init_shapes_match_reference(arch):
    """The port's own init lays out the reference's tree (flattened), in
    fp32, at smoke size."""
    jcfg, tcfg = fam.cfgs(arch, "bfloat16")
    jparams = convert._flatten(jax.eval_shape(
        lambda: fam.jlm.init(jcfg, jax.random.PRNGKey(0))))
    tparams = tlm.init(tcfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert {k: tuple(v.shape) for k, v in tparams.items()} == \
        {k: tuple(v.shape) for k, v in jparams.items()}
    assert all(v.dtype == torch.float32 for v in tparams.values())
