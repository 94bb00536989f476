"""The integer half of repro_torch's precision library and the
low-precision training mode against the JAX reference
(``repro.core.quantize``, ``repro.core.kfac``, ``repro.lowp``) on the
same numpy inputs and converted weights.

Tolerances and why:
  * codes, slices, hi/lo fixed-point splits and reconstructions:
    bitwise (the same elementwise fp32 operations in the same order);
  * ``int_slice_einsum`` and ``lowp_einsum("int8")``: bitwise. Every
    slice product is an fp32 einsum of small integers whose sums stay
    under 2**24 (here at most 64 * 255**2), so both frameworks compute
    them exactly, and the shift-adds run in the same order;
  * the per-leaf int8 WU (``precondition`` without a plan) is bitwise
    for the same reason; the pooled int8 WU quantizes each pool on its
    own amax scale, and the port pools every tile of a ``(bi, bo)``
    group where the reference concatenates same-geometry leaves, so the
    scales differ: held to 2**-14 of the leaf's largest entry (int8
    keeps ~17 bits against fp32 on either route; measured 9.3e-6);
  * ``update_parity``: the reference's budget, >= 16 bits
    (``tests/test_lowp.py``).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import kfac as jkfac
from repro.core import quantize as jq
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.data import SyntheticTokens as JTokens
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.core import quantize as tq
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.lowp import parity as tparity
from repro_torch.models import lm as tlm

ARCH = "qwen1.5-0.5b"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and torch's per-process pool of one thread a core oversubscribes
    the cores many times over (the smoke-size products gain nothing from
    it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, shape, scale=1.0):
    r = np.random.default_rng(seed)
    x = (r.standard_normal(shape) * scale).astype(np.float32)
    x.flat[:3] = [0.0, -scale * 4.0, scale * 4.0]   # the amax, both signs
    return x


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("bits", [4, 8, 24])
def test_codes_and_fixed_point_bitwise(bits):
    x = _x(bits, (32, 48), scale=3.0)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    ts, js = tq.amax_scale(tx), jq.amax_scale(jx)
    _eq(ts, js)
    _eq(tq.amax_scale(tx, dim=-1), jq.amax_scale(jx, axis=-1))
    _eq(tq.amax_scale(torch.zeros(3)), jq.amax_scale(jnp.zeros(3)))
    codes = tq.quantize_int(tx, bits, ts)
    _eq(codes, jq.quantize_int(jx, bits, js))
    # the symmetric clip: the saturated negative input keeps its code
    assert float(codes.min()) == -(2.0 ** bits - 1)
    _eq(tq.quantize_fixed(tx, bits, ts), jq.quantize_fixed(jx, bits, js))
    th, tl = tq.split_hi_lo_fixed(tx, bits, bits // 2, ts)
    jh, jl = jq.split_hi_lo_fixed(jx, bits, bits // 2, js)
    _eq(th, jh)
    _eq(tl, jl)


@pytest.mark.parametrize("total,sl", [(24, 8), (16, 4), (8, 8), (7, 3)])
def test_bit_slices_and_reconstruction_bitwise(total, sl):
    x = _x(total + sl, (40, 24), scale=0.5)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    ts, js = tq.amax_scale(tx), jq.amax_scale(jx)
    t_sl = tq.bit_slices_fixed(tx, total, sl, ts)
    j_sl = jq.bit_slices_fixed(jx, total, sl, js)
    assert len(t_sl) == len(j_sl) == -(-total // sl)
    for a, b in zip(t_sl, j_sl):
        _eq(a, b)
        assert float(a.abs().max()) < 2.0 ** sl
    back = tq.reconstruct_slices(t_sl, total, sl, ts)
    _eq(back, jq.reconstruct_slices(j_sl, total, sl, js))
    _eq(back, tq.quantize_fixed(tx, total, ts))


def test_precision_kind_parses_as_the_reference():
    for spec in ("fp32", None, "hilo", "int8", "int16b4", "int24b8",
                 "int4b4"):
        assert tq.precision_kind(spec) == jq.precision_kind(spec)
    assert tq.PRECISIONS == jq.PRECISIONS
    for bad in ("int8b16", "int0b0", "bf16", "int"):
        with pytest.raises(ValueError):
            tq.precision_kind(bad)
        with pytest.raises(ValueError):
            jq.precision_kind(bad)


@pytest.mark.parametrize("precision", ["int8", "int16b4", "int12b3"])
def test_int_slice_einsum_bitwise(precision):
    a = _x(1, (6, 64, 48), scale=2.0)
    b = _x(2, (6, 48, 32), scale=1e-3)
    spec = "nab,nbc->nac"
    total, sl = tq.precision_kind(precision)
    got = tq.int_slice_einsum(spec, torch.from_numpy(a), torch.from_numpy(b),
                              total_bits=total, slice_bits=sl)
    want = jq.int_slice_einsum(spec, jnp.asarray(a), jnp.asarray(b),
                               total_bits=total, slice_bits=sl)
    _eq(got, want)
    lp = tq.lowp_einsum(spec, torch.from_numpy(a), torch.from_numpy(b),
                        precision=precision)
    _eq(lp, jq.lowp_einsum(spec, jnp.asarray(a), jnp.asarray(b),
                           precision=precision))
    # and the quantization alone sets the error against fp32
    exact = np.einsum(spec, a.astype(np.float64), b.astype(np.float64))
    rel = np.max(np.abs(lp.numpy() - exact)) / np.max(np.abs(exact))
    assert rel < 2.0 ** (-total + 8)


@pytest.fixture(scope="module")
def warm():
    """The reference's warm state (stats pass + inverse refresh) on
    fp32 smoke weights, its gradient on the same batch, and both
    converted to the port."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(t_get_smoke_config(ARCH), dtype="float32")
    kc = dict(block_size=min(64, cfg.soi_block), stats_batch=4,
              stats_seq=32, stats_every=1, inv_every=1)
    jk = JKFACConfig(**kc)
    params = jlm.init(cfg, jax.random.PRNGKey(0))
    batch = {"tokens": jnp.asarray(
        JTokens(cfg.vocab, 32, 4, seed=0).batch_slice(0, 0, 4))}
    js = jsteps.TrainState(params, jkfac.init(params, jlm.kfac_specs(cfg),
                                              jk))
    js, _ = jax.jit(jsteps.make_stats_step(cfg, jk))(js, batch)
    js = jax.jit(jsteps.make_inv_step(cfg, jk))(js)
    grads = jax.grad(lambda p: jlm.loss_fn(cfg, p, batch)[0])(js.params)
    tk = tkfac.KFACConfig(**kc)
    tparams = convert.params_from_jax(jax.device_get(js.params),
                                      device="cpu")
    tstate = tsteps.TrainState(tparams, tkfac.init(
        tparams, tlm.kfac_specs(tcfg), tk))
    tstate.kfac.inverses = convert.blocks_from_jax(
        jax.device_get(js.kfac.inverses), device="cpu")
    tgrads = convert.params_from_jax(jax.device_get(grads), device="cpu")
    return dict(cfg=cfg, tcfg=tcfg, jk=jk, tk=tk, js=js, grads=grads,
                tstate=tstate, tgrads=tgrads)


@pytest.mark.parametrize("pooled", [False, True])
def test_int8_precondition_matches_reference(warm, pooled):
    cfg, tcfg = warm["cfg"], warm["tcfg"]
    jk = dataclasses.replace(warm["jk"], precision="int8")
    tk = dataclasses.replace(warm["tk"], precision="int8")
    j_plan = jsteps.make_wu_plan_for(cfg, jk) if pooled else None
    t_plan = tsteps.make_wu_plan_for(tcfg, warm["tstate"]) if pooled \
        else None
    want = convert._flatten(jax.device_get(jax.jit(
        lambda g: jkfac.precondition(g, warm["js"].kfac,
                                     jlm.kfac_specs(cfg), jk,
                                     wu_plan=j_plan))(warm["grads"])))
    got = tkfac.precondition(warm["tgrads"], warm["tstate"].kfac,
                             tlm.kfac_specs(tcfg), tk, wu_plan=t_plan)
    specs = tlm.kfac_specs(tcfg)
    for name, v in want.items():
        g = got[name].numpy()
        if name not in specs or not pooled:
            np.testing.assert_array_equal(g, v, err_msg=name)
        else:
            err = np.max(np.abs(g - v))
            assert err <= 2.0 ** -14 * np.max(np.abs(v)), (name, err)


def test_kernel_route_refuses_integer_precisions(warm):
    cfg, tcfg = warm["cfg"], warm["tcfg"]
    plan = tsteps.make_wu_plan_for(tcfg, warm["tstate"])
    j_plan = jsteps.make_wu_plan_for(cfg, warm["jk"])
    for p in ("int8", "int16b4"):
        with pytest.raises(ValueError, match="use_kernel"):
            tkfac.precondition(
                warm["tgrads"], warm["tstate"].kfac, tlm.kfac_specs(tcfg),
                dataclasses.replace(warm["tk"], precision=p),
                wu_plan=plan, use_kernel=True)
        with pytest.raises(ValueError, match="use_kernel"):
            jkfac.precondition(
                warm["grads"], warm["js"].kfac, jlm.kfac_specs(cfg),
                dataclasses.replace(warm["jk"], precision=p),
                wu_plan=j_plan, use_kernel=True)
    # fp32 and hilo take the kernel route
    for p in ("fp32", "hilo"):
        tkfac.precondition(
            warm["tgrads"], warm["tstate"].kfac, tlm.kfac_specs(tcfg),
            dataclasses.replace(warm["tk"], precision=p), wu_plan=plan,
            use_kernel=True)


@pytest.mark.parametrize("precision", ["hilo", "int8"])
def test_update_parity_meets_sixteen_bits(precision):
    r = tparity.update_parity(precision, device="cpu")
    assert r["precision"] == precision
    assert r["min_bits"] >= 16.0, r["per_leaf"]
    assert r["mean_bits"] >= r["min_bits"]


def test_trajectory_parity_runs_the_cadence():
    r = tparity.trajectory_parity("int8", steps=2, device="cpu")
    assert len(r["bits"]) == len(r["loss_lowp"]) == 2
    assert all(math.isfinite(x) for x in r["loss_lowp"] + r["loss_fp32"])
    # the first step starts from the same warm state: its loss is equal
    assert r["loss_lowp"][0] == r["loss_fp32"][0]
    assert r["bits"][0] >= 16.0


@pytest.mark.parametrize("precision,fused,route", [
    ("fp32", True, "fused_precond"), ("hilo", True, "fused_precond"),
    ("int8", True, "einsum"), ("int8", False, "per_leaf")])
def test_program_wu_route(precision, fused, route):
    prog = ttrain.KFACProgram(
        t_get_smoke_config(ARCH),
        tkfac.KFACConfig(block_size=32, precision=precision),
        device="cpu", fused_wu=fused)
    assert prog.wu_route == route
    with pytest.raises(ValueError):
        ttrain.KFACProgram(t_get_smoke_config(ARCH),
                           tkfac.KFACConfig(precision="int2b4"),
                           device="cpu")


def test_cli_int8_takes_the_einsum_route():
    ops.reset_launch_counts()
    s = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--steps", "2", "--batch", "2", "--seq", "16",
                     "--stats-every", "1", "--inv-every", "1",
                     "--precision", "int8"])
    assert s["wu_route"] == "einsum" and s["precision"] == "int8"
    assert len(s["losses"]) == 2
    assert all(math.isfinite(x) for x in s["losses"])
    assert all("wu" in h["phase_s"] for h in s["history"])
