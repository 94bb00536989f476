"""repro_torch's VLM family (qwen2-vl-7b's smoke config: M-RoPE and
the stubbed vision frontend) against the JAX reference on converted
weights, with ``img_embeds`` and (3, B, T) M-RoPE positions and without
them (the reference's CLI feeds tokens only): M-RoPE alone, loss,
logits and every gradient in fp32 and bf16, the K-FAC statistics on the
subsampled image rows and positions, gradient accumulation over
microbatches that split the positions on their batch dim, and a 4-step
K-FAC trajectory through ``launch.train.run``.

Tolerances are the dense family's (``tests/_torch_families.py``);
M-RoPE alone rtol 1e-5 with atol 1e-6. Gradient accumulation is held
as in ``tests/test_torch_train.py``: loss and grad norm rtol 1e-5, the
weights atol 3e-5 (1e-3 of the learning rate), except that Adam's
entries with rounding-level gradients are held within 2 lr a step
(``_torch_families.check_params``; measured: one ``lm_head`` entry of
16384 lands 8.1e-5 away).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fam
from _torch_families import one_thread  # noqa: F401 (autouse)
from repro.core import kfac as jkfac
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.core import kfac as tkfac
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

ARCH = "qwen2-vl-7b"
EXTRAS = [True, False]


def test_mrope_matches_reference():
    jcfg, _ = fam.cfgs(ARCH)
    x = np.random.default_rng(0).standard_normal(
        (2, 40, 4, 16)).astype(np.float32)
    pos = fam.vlm_extras(jcfg, 2, 40, seed=0)["positions"]
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              jcfg.mrope_sections)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e6, jcfg.mrope_sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("extras", EXTRAS)
def test_loss_logits_and_grads_match_reference_fp32(extras):
    fam.check_fp32(ARCH, extras=extras)


@pytest.mark.parametrize("extras", EXTRAS)
def test_loss_logits_and_grads_match_reference_bf16(extras):
    fam.check_bf16(ARCH, extras=extras)


def test_stats_factors_match_reference():
    fam.check_stats(ARCH, extras=True)


def test_stats_subsample_keeps_image_rows_and_positions():
    """The SU's subsample of a (3, B, T) position batch: the first
    ``stats_batch`` rows and ``stats_seq`` tokens of every stream."""
    from repro_torch.launch import train as ttrain

    _, tcfg = fam.cfgs(ARCH)
    prog = ttrain.KFACProgram(tcfg, tkfac.KFACConfig(
        block_size=32, stats_batch=1, stats_seq=16, stats_every=1,
        inv_every=1), device="cpu")
    seen = []
    state = prog.init_state()
    orig = tsteps.make_stats_step

    def spy(cfg, kcfg, **kw):
        step = orig(cfg, kcfg, **kw)

        def wrapped(st, batch, *share):
            seen.append({k: tuple(v.shape) for k, v in batch.items()})
            return step(st, batch, *share)
        return wrapped

    tsteps.make_stats_step = spy
    try:
        step_fn = prog.make_step(state)
    finally:
        tsteps.make_stats_step = orig
    b = {"tokens": torch.zeros((2, 32), dtype=torch.int32),
         **{k: torch.from_numpy(v) for k, v in
            fam.vlm_extras(tcfg, 2, 32, seed=0).items()}}
    step_fn(state, b)
    assert seen == [{"tokens": (1, 16), "img_embeds": (1, 8, 32),
                     "positions": (3, 1, 16)}]


def test_train_step_with_grad_accumulation_matches_reference():
    """``train_accum=2`` with image embeddings and M-RoPE positions: the
    microbatches take rows of every leaf, positions on their second
    dim."""
    jcfg, tcfg = fam.cfgs(ARCH, train_accum=2)
    params = jax.device_get(fam.jlm.init(jcfg, jax.random.PRNGKey(1)))
    b = {"tokens": fam.JTokens(jcfg.vocab, 16, 4, seed=2).batch_slice(
        0, 0, 4), **fam.vlm_extras(jcfg, 4, 16, seed=2)}
    jk = JKFACConfig(block_size=32)
    js = jsteps.TrainState(params, jkfac.init(
        params, fam.jlm.kfac_specs(jcfg), jk))
    js, jm = jax.jit(jsteps.make_train_step(jcfg, jk))(js, fam.jbatch(b))
    tparams = convert.params_from_jax(params, device="cpu")
    tk = tkfac.KFACConfig(block_size=32)
    ts = tsteps.TrainState(tparams, tkfac.init(
        tparams, tlm.kfac_specs(tcfg), tk))
    ts, tm = tsteps.make_train_step(
        tcfg, tk, wu_plan=tsteps.make_wu_plan_for(tcfg, ts),
        use_kernel=True)(ts, fam.tbatch(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    fam.check_params(ts, js, tlm.kfac_specs(tcfg), lr=jk.lr, n_steps=1,
                     bound=lambda v: 3e-5)


@pytest.mark.parametrize("extras", EXTRAS)
def test_four_step_trajectory_matches_reference(extras):
    fam.check_trajectory(ARCH, extras=extras)


def test_batch_rows_split_positions_on_their_batch_dim():
    b = {"tokens": torch.arange(12).reshape(4, 3),
         "positions": torch.arange(36).reshape(3, 4, 3)}
    part = tsteps.batch_rows(b, 2, 4)
    assert torch.equal(part["tokens"], b["tokens"][2:4])
    assert torch.equal(part["positions"], b["positions"][:, 2:4])
