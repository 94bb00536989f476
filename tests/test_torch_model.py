"""repro_torch dense model against the JAX reference (``repro.models.lm``)
on converted weights: logits, loss, every parameter gradient, and the
K-FAC statistics pass (A and G Grams through taps).

The smoke config (2 layers, d=64, soi_block=32) runs at seq 80, above
its attn_chunk of 64, so the chunked attention path with its padded
tail chunk is exercised too.

Tolerances and why:
  * float32 (where the point is the algorithm): rtol 1e-5 with atol
    1e-5 on logits and loss, atol 1e-6 on gradients — only the fp32
    summation order differs (measured: logits 6e-7, grads <= 2e-7).
  * bfloat16 compute (the config's default dtype): loss rtol 1e-4,
    logits atol 0.03, gradients within 5% of each leaf's largest
    entry. The two frameworks round to bf16 at different points of the
    backward pass (one bf16 ulp is 0.4%), measured: loss 3e-5 relative,
    logits 8e-3, gradients <= 1.3% of the leaf scale. qwen2.5-32b's head
    is untied (d^-1/2 weights against 0.02 embeddings), which makes its
    loss 10-300x more sensitive to bf16 rounding: the reference's own
    bf16 loss is 3.5e-4 from its fp32 loss there (9.5e-7 on qwen1.5),
    and the port's 1.7e-4 from the reference's (measured); its logits
    are ~7x larger, and the port's differ by up to 0.044. So the bf16
    loss and logits are held to 1e-4 and 0.03, or to the reference's
    own bf16-to-fp32 gap where that is larger.
  * stats Grams (float32): rtol 1e-4 with atol 1e-6 of the factor's
    largest entry; the G side squares tap gradients, doubling their
    relative difference.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import one_thread  # noqa: F401 (autouse)

from repro.configs import get_smoke_config
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.core import kfac as jkfac
from repro.data import SyntheticTokens
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm

ARCH = "qwen1.5-0.5b"
# the dense archs the port runs: MHA (qwen1.5), GQA with 2 kv heads of 4
# at smoke size (the other three; qwen2's smoke d_model 56 is not a
# multiple of its soi_block 32)
ARCHS = ["qwen1.5-0.5b", "qwen2-0.5b", "llama3.2-1b", "qwen2.5-32b"]


def _cfgs(dtype, arch=ARCH):
    return (dataclasses.replace(get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(t_get_smoke_config(arch), dtype=dtype))


def _inputs(cfg, seq=80, batch=2):
    params = jax.device_get(jlm.init(cfg, jax.random.PRNGKey(0)))
    toks = SyntheticTokens(cfg.vocab, seq, batch, seed=1).batch_slice(
        0, 0, batch)
    return params, toks


def _reference(cfg, params, toks):
    jb = {"tokens": jnp.asarray(toks)}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jlm.loss_fn(cfg, p, jb), has_aux=True)(params)
    logits, _, _ = jlm.forward(cfg, params, jb, train=True)
    return (float(loss), np.asarray(logits, np.float32),
            convert._flatten(jax.device_get(grads)))


def _port(cfg, params, toks):
    tp = {k: v.requires_grad_() for k, v in
          convert.params_from_jax(params, device="cpu").items()}
    tb = {"tokens": torch.from_numpy(toks)}
    loss, _ = tlm.loss_fn(cfg, tp, tb)
    grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    with torch.no_grad():
        logits, _ = tlm.forward(cfg, tp, tb)
    return float(loss.detach()), logits.numpy(), grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_logits_and_grads_match_reference_fp32(arch):
    jcfg, tcfg = _cfgs("float32", arch)
    params, toks = _inputs(jcfg)
    jl, jlog, jg = _reference(jcfg, params, toks)
    tl, tlog, tg = _port(tcfg, params, toks)
    assert tlog.shape == jlog.shape
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlog, jlog, rtol=1e-5, atol=1e-5)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), jg[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_logits_and_grads_match_reference_bf16(arch):
    jcfg, tcfg = _cfgs("bfloat16", arch)
    params, toks = _inputs(jcfg)
    jl, jlog, jg = _reference(jcfg, params, toks)
    tl, tlog, tg = _port(tcfg, params, toks)
    # the reference's own bf16 rounding: its fp32 loss and logits
    jcfg32 = _cfgs("float32", arch)[0]
    jb = {"tokens": jnp.asarray(toks)}
    jl32 = float(jlm.loss_fn(jcfg32, params, jb)[0])
    jlog32 = np.asarray(jlm.forward(jcfg32, params, jb, train=True)[0])
    np.testing.assert_allclose(tl, jl, rtol=max(1e-4, abs(jl - jl32) / jl))
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=max(
        0.03, float(np.max(np.abs(jlog - jlog32)))))
    for k in jg:
        want = np.asarray(jg[k], np.float32)
        err = np.max(np.abs(tg[k].numpy() - want))
        assert err <= 0.05 * np.max(np.abs(want)), (k, err)


@pytest.mark.parametrize("model_soi_block,arch",
                         [(32, a) for a in ARCHS] + [(64, ARCH)])
def test_stats_grams_match_reference(model_soi_block, arch):
    """At 64 the config's soi_block exceeds the K-FAC block size (32),
    as the full qwen1.5-0.5b (1024) does at --block-size 128: the
    reference's stats step fails there on mismatched Gram shapes, so
    its Grams are taken from the config at 32, which the port must
    reproduce."""
    jcfg, tcfg = _cfgs("float32", arch)
    tcfg = dataclasses.replace(tcfg, soi_block=model_soi_block)
    params, toks = _inputs(jcfg, seq=32)
    kj = JKFACConfig(block_size=jcfg.soi_block)
    kt = tkfac.KFACConfig(block_size=jcfg.soi_block)
    jstate = jsteps.TrainState(params, jkfac.init(
        params, jlm.kfac_specs(jcfg), kj))
    jstate, jm = jax.jit(jsteps.make_stats_step(jcfg, kj))(
        jstate, {"tokens": jnp.asarray(toks)})
    tparams = convert.params_from_jax(params, device="cpu")
    tstate = tsteps.TrainState(tparams, tkfac.init(
        tparams, tlm.kfac_specs(tcfg), kt))
    tstate, tm = tsteps.make_stats_step(tcfg, kt)(
        tstate, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tm["stats_loss"]),
                               float(jm["stats_loss"]), rtol=1e-5)
    want = jax.device_get(jstate.kfac.factors)
    got = tstate.kfac.factors
    assert {n: sorted(d) for n, d in got.items()} == \
        {n: sorted(d) for n, d in want.items()}
    for n, d in want.items():
        for side, v in d.items():
            v = np.asarray(v)
            assert got[n][side].shape == v.shape
            np.testing.assert_allclose(
                got[n][side].numpy(), v, rtol=1e-4,
                atol=1e-6 * np.max(np.abs(v)), err_msg=f"{n}/{side}")


def test_kfac_specs_and_init_shapes_match_reference():
    jcfg, tcfg = _cfgs("bfloat16")
    jparams = convert._flatten(jax.eval_shape(
        lambda: jlm.init(jcfg, jax.random.PRNGKey(0))))
    gen = torch.Generator().manual_seed(0)
    tparams = tlm.init(tcfg, generator=gen, device="cpu")
    assert {k: tuple(v.shape) for k, v in tparams.items()} == \
        {k: tuple(v.shape) for k, v in jparams.items()}
    assert all(v.dtype == torch.float32 for v in tparams.values())
    # same distributions: N(0, d^-1/2) projections, zero norms and biases
    d = tcfg.d_model
    assert abs(float(tparams["layers/attn/wq"].std()) - d ** -0.5) < 0.01
    assert float(tparams["layers/attn/bq"].abs().max()) == 0.0
    assert abs(float(tparams["embed"].std()) - 0.02) < 0.002


def test_init_is_reproducible_from_the_seed():
    _, tcfg = _cfgs("bfloat16")
    a = tlm.init(tcfg, generator=torch.Generator().manual_seed(3),
                 device="cpu")
    b = tlm.init(tcfg, generator=torch.Generator().manual_seed(3),
                 device="cpu")
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_unported_family_raises(monkeypatch):
    """Every id is ported now (whisper-tiny through models.whisper); the
    registry's error path for a family still to port stays, as does the
    one for an unknown id, and models.lm refuses the audio family."""
    from repro_torch.configs import get_config, registry
    assert registry.UNPORTED == {}
    assert get_config("whisper-tiny").family == "audio"
    monkeypatch.setitem(registry.UNPORTED, "whisper-tiny", "audio")
    with pytest.raises(NotImplementedError, match="audio"):
        get_config("whisper-tiny")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-huge")
    audio_like = dataclasses.replace(t_get_smoke_config(ARCH),
                                     family="audio")
    with pytest.raises(NotImplementedError, match="audio"):
        tlm.kfac_specs(audio_like)
