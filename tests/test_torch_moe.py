"""repro_torch's MoE family (moonshot-v1-16b-a3b, phi3.5-moe-42b-a6.6b
at smoke size) against the JAX reference on converted weights: the
routing decisions first, then capacity and drop, the MoE FFN, loss,
logits and every gradient in fp32 and bf16, the K-FAC statistics with
the experts' ``(L, e)`` stack over capacity tokens, and a 4-step K-FAC
trajectory through ``launch.train.run``.

Tolerances are those of ``tests/_torch_families.py`` (the dense
family's) except:
  * routing: ``eid``, ``keep`` and ``safe_pos`` equal, the gates to
    rtol 1e-6 (one softmax and one division apart).
  * the MoE FFN alone at a capacity that drops: fp32 rtol 1e-5 with
    atol 1e-6; bf16 atol 2 bf16 ulps of the output's largest entry (the
    experts' products sum in another order before the one rounding to
    bf16; the combine then adds the same bf16 terms in the same order).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fam
from _torch_families import one_thread  # noqa: F401 (autouse)
from repro.configs import get_config
from repro.core import soi as jsoi
from repro.models import moe as jmoe
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import soi
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

ARCHS = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _reference_routing(cfg, router, xf, n_slots):
    """The reference's routing and capacity assignment
    (``repro.models.moe.moe_ffn``'s portable path)."""
    gate, eid = jmoe._routing(cfg, router, xf, xf.dtype)
    return [np.asarray(x) for x in _routing_jnp(cfg, gate, eid, n_slots)]


def _routing_jnp(cfg, gate, eid, n_slots):
    """``moe_ffn``'s capacity assignment of the reference's top-k."""
    flat_eid = eid.reshape(-1)
    onehot = jax.nn.one_hot(flat_eid, cfg.n_experts, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - 1
    pos = jnp.take_along_axis(pos, flat_eid[:, None], axis=1)[:, 0]
    keep = pos < n_slots
    safe_pos = jnp.where(keep, pos, n_slots)
    return gate.reshape(-1), flat_eid, keep, safe_pos


def _moe_inputs(cfg, nt, seed):
    rng = np.random.default_rng(seed)
    router = (rng.standard_normal((cfg.d_model, cfg.n_experts))
              * cfg.d_model ** -0.5).astype(np.float32)
    xf = rng.standard_normal((nt, cfg.d_model)).astype(np.float32)
    return router, xf


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_decisions_match_reference(arch, dtype):
    """Top-k experts, kept pairs and slots equal the reference's on the
    same tokens, at the config's capacity and at one that drops."""
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = fam.cfgs(arch, dtype)
    nt = 160
    router, xf = _moe_inputs(jcfg, nt, seed=3)
    jx = jnp.asarray(xf).astype(jdt)
    tx = torch.from_numpy(xf).to(tdt)
    full = tmoe.capacity(tcfg, nt)
    assert full == jmoe.capacity(jcfg, nt)
    for n_slots in (full, 8):
        want = _reference_routing(jcfg, jnp.asarray(router), jx, n_slots)
        got = [t.numpy() for t in tmoe.route(tcfg, torch.from_numpy(router),
                                             tx, n_slots)]
        for name, g, w in zip(("eid", "keep", "safe_pos"), got[1:],
                              want[1:]):
            np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert not want[2].all(), "8 slots must drop pairs"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_routing_matches_reference(arch, dtype, monkeypatch):
    """Inside the whole model, before any number is compared: every
    layer's ``eid``, ``keep`` and ``safe_pos`` equal the reference's,
    each computed in its own program from its own layer inputs (the
    reference compiled as the bf16 parity check compiles it)."""
    jcfg, tcfg = fam.cfgs(arch, dtype)
    params, b = fam.inputs(jcfg)
    seen_j, seen_t = [], []
    orig_ffn, orig_route = jmoe.moe_ffn, tmoe.route

    def spy_ffn(cfg, p, x, ctx, prefix):
        nt = x.shape[0] * x.shape[1]
        flat = x.reshape(nt, x.shape[-1])
        gate, eid = jmoe._routing(cfg, p["router"], flat, x.dtype)
        _, eid, keep, safe = (jnp.asarray(v) for v in _routing_jnp(
            cfg, gate, eid, jmoe.capacity(cfg, nt)))
        jax.debug.callback(
            lambda *a: seen_j.append([np.asarray(v) for v in a]),
            eid, keep, safe, ordered=True)
        return orig_ffn(cfg, p, x, ctx, prefix)

    def spy_route(cfg, router, xf, n_slots):
        out = orig_route(cfg, router, xf, n_slots)
        seen_t.append([t.numpy() for t in out[1:]])
        return out

    monkeypatch.setattr(jmoe, "moe_ffn", spy_ffn)
    monkeypatch.setattr(tmoe, "route", spy_route)
    jb = fam.jbatch(b)
    jax.jit(lambda p: fam.jlm.loss_fn(jcfg, p, jb)[0]).lower(
        params).compile(
            compiler_options={"xla_allow_excess_precision": False})(params)
    jax.effects_barrier()
    with torch.no_grad():
        tlm.loss_fn(tcfg, fam.convert.params_from_jax(params, device="cpu"),
                    fam.tbatch(b))
    assert len(seen_j) == len(seen_t) == jcfg.n_layers
    for layer, (j, t) in enumerate(zip(seen_j, seen_t)):
        for name, w, g in zip(("eid", "keep", "safe_pos"), j, t):
            np.testing.assert_array_equal(g, w, err_msg=f"{layer} {name}")


def test_capacity_matches_reference():
    for arch in ARCHS:
        for jcfg, tcfg in ((get_config(arch), t_get_config(arch)),
                           fam.cfgs(arch)):
            for n in (1, 7, 64, 160, 512, 2048, 4096):
                assert tmoe.capacity(tcfg, n) == jmoe.capacity(jcfg, n)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_with_drops_matches_reference(arch, dtype):
    """The whole FFN at capacity factor 0.5, where pairs are dropped:
    dispatch into (E, C, D), the stacked experts, the combine."""
    jdt, tdt = DTYPES[dtype]
    jcfg, tcfg = fam.cfgs(arch, dtype, capacity_factor=0.5)
    params = jax.device_get(jmoe.init_moe(jcfg, jax.random.PRNGKey(2)))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    with jax.disable_jit():
        want = jmoe.moe_ffn(jcfg, params, jx, None, "layers/moe")
    want = np.asarray(want.astype(jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    got = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x).to(tdt), None,
                       "layers/moe").to(torch.float32).numpy()
    C = tmoe.capacity(tcfg, 80)
    keep = tmoe.route(tcfg, tp["router"],
                      torch.from_numpy(x).to(tdt).reshape(80, -1), C)[2]
    assert not bool(keep.all()), "capacity factor 0.5 must drop pairs"
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        ulp = 2.0 ** -7 * np.max(np.abs(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp)


def test_combine_is_bitwise_reproducible():
    """No atomics on the combine: two runs give the same bits."""
    _, tcfg = fam.cfgs(ARCHS[0], "bfloat16")
    p = tlm.init(tcfg, generator=torch.Generator().manual_seed(0),
                 device="cpu")
    toks = torch.randint(0, tcfg.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    a, _ = tlm.forward(tcfg, p, {"tokens": toks})
    b, _ = tlm.forward(tcfg, p, {"tokens": toks})
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_logits_and_grads_match_reference_fp32(arch):
    fam.check_fp32(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_logits_and_grads_match_reference_bf16(arch):
    fam.check_bf16(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_stats_factors_match_reference(arch):
    """The experts' factors are (L, e, nb, bs, bs), their Grams taken
    over the capacity buffers (cap_tokens taps)."""
    state = fam.check_stats(arch)
    jcfg, _ = fam.cfgs(arch)
    L, e = jcfg.n_layers, jcfg.n_experts
    assert state.kfac.factors["layers/moe/wg"]["A"].shape[:2] == (L, e)
    assert "A" not in state.kfac.factors["layers/moe/wu"]


def test_kfac_specs_and_taps_match_reference_full_width():
    """Shapes only, at the published widths: the specs, their factor
    shapes at block 128 and the taps of an 8 x 256 stats batch."""
    for arch in ARCHS:
        jcfg, tcfg = get_config(arch), t_get_config(arch)
        jspecs, tspecs = fam.jlm.kfac_specs(jcfg), tlm.kfac_specs(tcfg)
        assert sorted(jspecs) == sorted(tspecs)
        for k, s in jspecs.items():
            assert dataclasses.asdict(s) == dataclasses.asdict(tspecs[k])
            assert soi.factor_shapes(tspecs[k], 128) == \
                jsoi.factor_shapes(s, 128)
        jt = jax.eval_shape(lambda: fam.jlm.build_taps(jcfg, jspecs, 2048))
        tt = tlm.build_taps(tcfg, tspecs, 2048, device="meta")
        assert {k: tuple(v.shape) for k, v in tt.items()} == \
            {k: tuple(v.shape) for k, v in jt.items()}


def test_four_step_trajectory_matches_reference():
    fam.check_trajectory(ARCHS[0])
