"""Shared parity checks of the port's model families (moe, ssm,
hybrid, vlm; whisper's trajectory) against the JAX reference, used by
``tests/test_torch_{moe,ssm,hybrid,vlm,whisper}.py``. Weights come from the
reference's ``init`` and cross through ``repro_torch.convert``; batches
are made from a seed with numpy.

Tolerances are the dense family's (``tests/test_torch_model.py``,
``tests/test_torch_train.py``); a family file states where it needs
another and why:
  * fp32 loss and logits rtol 1e-5, atol 1e-5; gradients rtol 1e-5,
    atol 1e-6 (summation order only).
  * bf16: loss rtol 1e-4 and logits atol 0.03, or the reference's own
    bf16-to-fp32 gap where that is larger; gradients within 5% of each
    leaf's largest entry.
  * stats factors rtol 1e-4 with atol 1e-6 of the factor's largest
    entry.
  * the 4-step K-FAC trajectory: losses rtol 1e-5; the port's inverses
    within 1e-3 of the largest entry of the reference's composed
    inverse of the port's own factors, and within 1% of the reference
    run's, or 1.05 times as far as the reference's inverse moves
    between the two runs' factors; final weights within 1% of each
    leaf's largest entry. On the Adam-updated leaves also the first
    moment within 1% of its largest entry, and there the weights'
    entries with rounding-level gradients (|mu| under 1e-3 of the
    leaf's largest) are held within 2 lr a step instead:
    Adam normalises such a gradient to a full step, and its sign is
    rounding (measured on moonshot-smoke: one embedding entry whose
    first moment is 2e-5 of the leaf's largest flips sign and lands
    0.07 away, while the leaf's first moment agrees to 3e-4).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.core import kfac as jkfac
from repro.data import SyntheticTokens as JTokens
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.data import SyntheticTokens as TTokens
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (a family file imports this fixture): the
    suite runs several test processes at once, and the smoke-size
    products gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch, dtype="float32", **over):
    """The reference's and the port's smoke configs of ``arch``."""
    return (dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over),
            dataclasses.replace(t_get_smoke_config(arch), dtype=dtype,
                                **over))


def vlm_extras(cfg, batch: int, seq: int, seed: int) -> dict:
    """``img_embeds`` (B, n_img, vision_dim) from the seed and M-RoPE
    positions (3, B, T): the image tokens on a (temporal 0, row, column)
    grid, the text after them counting on from the grid's extent in all
    three streams."""
    rng = np.random.default_rng(seed)
    n_img = cfg.n_img_tokens
    img = rng.standard_normal((batch, n_img, cfg.vision_dim)) \
        .astype(np.float32)
    side = int(np.ceil(np.sqrt(n_img)))
    i = np.arange(n_img)
    grid = np.stack([np.zeros_like(i), i // side, i % side])
    text = side + np.arange(seq - n_img)
    pos = np.concatenate([grid, np.stack([text] * 3)], axis=1)
    pos = np.broadcast_to(pos[:, None, :], (3, batch, seq))
    return {"img_embeds": img, "positions": pos.astype(np.int32).copy()}


def inputs(cfg, seq=80, batch=2, seed=1, extras=False):
    """Reference weights (numpy) and a numpy batch."""
    params = jax.device_get(jlm.init(cfg, jax.random.PRNGKey(0)))
    b = {"tokens": JTokens(cfg.vocab, seq, batch, seed=seed).batch_slice(
        0, 0, batch)}
    if extras:
        b.update(vlm_extras(cfg, batch, seq, seed))
    return params, b


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@functools.lru_cache(maxsize=8)
def reference(cfg, seq, extras, compiled=False):
    """The reference's loss, fp32 logits and gradients on
    :func:`inputs`, from one pass (``loss_fn`` is ``loss_from_logits``
    of this ``forward``), not jitted as a whole, as
    ``tests/test_torch_model.py`` runs it. ``compiled`` jits it as a
    whole, with XLA's ``xla_allow_excess_precision`` off, so that every
    bf16 intermediate rounds where the reference's code says (see
    :func:`check_bf16`). Cached: a bf16 check reuses the fp32 pass."""
    params, b = inputs(cfg, seq=seq, extras=extras)
    jb = jbatch(b)

    def loss_and_logits(p):
        logits, _, _ = jlm.forward(cfg, p, jb, train=True)
        return jlm.loss_from_logits(cfg, logits, jb), logits

    fn = jax.value_and_grad(loss_and_logits, has_aux=True)
    if compiled:
        fn = jax.jit(fn).lower(params).compile(
            compiler_options={"xla_allow_excess_precision": False})
    (loss, logits), grads = fn(params)
    return (float(loss), np.asarray(logits, np.float32),
            convert._flatten(jax.device_get(grads)))


def port(cfg, params, b):
    tp = {k: v.requires_grad_() for k, v in
          convert.params_from_jax(params, device="cpu").items()}
    tb = tbatch(b)
    loss, _ = tlm.loss_fn(cfg, tp, tb)
    grads = torch.autograd.grad(loss, list(tp.values()), allow_unused=True)
    grads = {k: (torch.zeros_like(p) if g is None else g)
             for (k, p), g in zip(tp.items(), grads)}
    with torch.no_grad():
        logits, _ = tlm.forward(cfg, tp, tb)
    return float(loss.detach()), logits.numpy(), grads


def check_fp32(arch, *, seq=80, extras=False, grad_atol=1e-6,
               compiled=False, **over):
    jcfg, tcfg = cfgs(arch, "float32", **over)
    params, b = inputs(jcfg, seq=seq, extras=extras)
    jl, jlog, jg = reference(jcfg, seq, extras, compiled)
    tl, tlog, tg = port(tcfg, params, b)
    assert tlog.shape == jlog.shape
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlog, jlog, rtol=1e-5, atol=1e-5)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), jg[k], rtol=1e-5,
                                   atol=grad_atol, err_msg=k)


def check_bf16(arch, *, seq=80, extras=False, grad_rel=None,
               compiled_fp32=False, **over):
    """bf16 parity against the reference compiled without XLA's excess
    precision: by default XLA's fusion keeps some of the reference's
    bf16 intermediates in fp32, and on the MoE smoke configs that flips
    top-k choices (the two builds' logits differ by up to 1.7,
    measured); without it the reference rounds where its code says, as
    it does run op by op (the same bits on moonshot-smoke, measured).
    ``grad_rel`` maps a leaf (its path after the layer group) to a
    looser gradient bound than 5%; ``compiled_fp32`` is how the fp32
    pass that sets the reference's own bf16 gap ran (as in
    :func:`check_fp32`)."""
    jcfg, tcfg = cfgs(arch, "bfloat16", **over)
    params, b = inputs(jcfg, seq=seq, extras=extras)
    jl, jlog, jg = reference(jcfg, seq, extras, True)
    tl, tlog, tg = port(tcfg, params, b)
    # the reference's own bf16 rounding: its fp32 loss and logits
    jcfg32 = cfgs(arch, "float32", **over)[0]
    jl32, jlog32, _ = reference(jcfg32, seq, extras, compiled_fp32)
    np.testing.assert_allclose(tl, jl, rtol=max(1e-4, abs(jl - jl32) / jl))
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=max(
        0.03, float(np.max(np.abs(jlog - jlog32)))))
    assert sorted(tg) == sorted(jg)
    for k in jg:
        want = np.asarray(jg[k], np.float32)
        err = np.max(np.abs(tg[k].numpy() - want))
        rel = (grad_rel or {}).get(k.split("/", 2)[-1], 0.05)
        assert err <= rel * np.max(np.abs(want)), (k, err)


def check_stats(arch, *, seq=32, extras=False, atol_rel=1e-6, **over):
    """One stats step of each package from the same weights and batch:
    every factor leaf (the A Grams stacked like the taps, cap_tokens
    taps at the expert capacity)."""
    jcfg, tcfg = cfgs(arch, "float32", **over)
    params, b = inputs(jcfg, seq=seq, extras=extras)
    kj = JKFACConfig(block_size=jcfg.soi_block)
    kt = tkfac.KFACConfig(block_size=jcfg.soi_block)
    jstate = jsteps.TrainState(params, jkfac.init(
        params, jlm.kfac_specs(jcfg), kj))
    jstate, jm = jax.jit(jsteps.make_stats_step(jcfg, kj))(jstate, jbatch(b))
    tparams = convert.params_from_jax(params, device="cpu")
    tstate = tsteps.TrainState(tparams, tkfac.init(
        tparams, tlm.kfac_specs(tcfg), kt))
    tstate, tm = tsteps.make_stats_step(tcfg, kt)(tstate, tbatch(b))
    np.testing.assert_allclose(float(tm["stats_loss"]),
                               float(jm["stats_loss"]), rtol=1e-5)
    want = jax.device_get(jstate.kfac.factors)
    got = tstate.kfac.factors
    assert {n: sorted(d) for n, d in got.items()} == \
        {n: sorted(d) for n, d in want.items()}
    for n, d in want.items():
        for side, v in d.items():
            v = np.asarray(v)
            assert got[n][side].shape == v.shape, (n, side)
            np.testing.assert_allclose(
                got[n][side].numpy(), v, rtol=1e-4,
                atol=atol_rel * np.max(np.abs(v)), err_msg=f"{n}/{side}")
    return tstate


def check_params(t_state, j_state, specs, *, lr, n_steps, bound,
                 mu_rtol=1e-2):
    """The port's weights after ``n_steps`` against the reference's:
    each leaf within ``bound(reference leaf)``. On an Adam leaf the
    first moment is held too, within ``mu_rtol`` (1%) of its largest
    entry (it is linear in the gradients), and the weights' entries
    whose gradients are rounding-level (|mu| under 1e-3 of the leaf's largest) within
    2 lr a step instead: Adam's step lr * mu / (sqrt(nu) + eps) is about
    lr whatever the gradient's size, and there its sign is rounding, so
    the two runs can step apart."""
    j_mu = convert._flatten(jax.device_get(j_state.kfac.adam_mu))
    for k, v in convert._flatten(jax.device_get(j_state.params)).items():
        err = np.abs(t_state.params[k].numpy() - v)
        if k in specs:
            assert err.max() <= bound(v), (k, err.max())
            continue
        mu = j_mu[k]
        mu_err = np.max(np.abs(t_state.kfac.adam_mu[k].numpy() - mu))
        assert mu_err <= mu_rtol * np.max(np.abs(mu)), (k, "adam_mu", mu_err)
        tiny = np.abs(mu) <= 1e-3 * np.max(np.abs(mu))
        assert np.max(err, where=~tiny, initial=0.0) <= bound(v), \
            (k, err.max())
        assert np.max(err, where=tiny, initial=0.0) <= 2 * lr * n_steps, \
            (k, "rounding-level entries", err.max())


class ConvertedProgram(ttrain.KFACProgram):
    """The port's K-FAC program starting from given (converted)
    weights instead of its own seeded init."""

    params: dict = None

    def init_state(self):
        params = {k: v.clone() for k, v in self.params.items()}
        return tsteps.TrainState(params, tkfac.init(
            params, tsteps.kfac_specs(self.cfg), self.kcfg))


class WithExtras:
    """A token dataset plus the VLM keys of :func:`vlm_extras`, the same
    for every step (the reference's CLI feeds tokens only)."""

    def __init__(self, ds, extras):
        self.ds, self.extras = ds, extras

    def batch(self, cursor, *, device):
        out = self.ds.batch(cursor, device=device)
        out.update({k: torch.from_numpy(v).to(device)
                    for k, v in self.extras.items()})
        return out


def check_trajectory(arch, *, n_steps=4, b=2, t=32, extras=False,
                     param_rtol=1e-2, more=None, **over):
    """4 K-FAC steps of ``launch.train.run`` (the port's main path: the
    neumann_inv and fused_precond routes, their plain versions here)
    against the reference's ``KFACProgram`` on a 1-device mesh with Auto
    axes, from the same weights and batches, stats and refresh every 2
    steps. ``more``: numpy batch keys added to every step (default: the
    VLM's :func:`vlm_extras` with ``extras``). Returns the port's
    history and final state."""
    from repro.launch.train import KFACProgram as JProgram

    jcfg, tcfg = cfgs(arch, "float32", **over)
    common = dict(stats_every=2, inv_every=2,
                  block_size=min(128, jcfg.soi_block), stats_batch=b,
                  stats_seq=t)
    ds = JTokens(jcfg.vocab, t, b, seed=0)
    if more is None:
        more = vlm_extras(jcfg, b, t, seed=0) if extras else {}
    kj = JKFACConfig(**common)
    jprog = JProgram(jcfg, kj, seed=0)
    # a 1-device (data, model) mesh with Auto axes, as the reference's
    # production meshes have
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    j_losses = []
    with jax.set_mesh(mesh):
        jstate = jprog.init_state(mesh)
        params = jax.device_get(jstate.params)
        jstep = jprog.make_step(mesh)
        for i in range(n_steps):
            jb = {"tokens": jnp.asarray(ds.batch_slice(i, 0, b)),
                  **{k: jnp.asarray(v) for k, v in more.items()}}
            jstate, m = jstep(jstate, jb)
            j_losses.append(float(m["loss"]))
        j_state = jax.device_get(jstate)
    # the reference's per-leaf refresh primitive (bitwise its whole-tree
    # refresh per block), jitted per leaf shape: a whole-tree jit of a
    # many-leaf model compiles for tens of seconds
    invert_leaf = jax.jit(jkfac._invert_blocks, static_argnums=1)

    tprog = ConvertedProgram(tcfg, tkfac.KFACConfig(**common), device="cpu")
    tprog.params = convert.params_from_jax(params, device="cpu")
    tds = TTokens(tcfg.vocab, t, b, seed=0)
    state, hist = ttrain.run(tprog, WithExtras(tds, more) if more else tds,
                             n_steps)
    assert [sorted(h["phase_s"]) for h in hist] == [
        ["inv", "stats", "train", "wu"], ["train", "wu"]] * (n_steps // 2)
    assert state.kfac.step == int(j_state.kfac.step) == n_steps
    np.testing.assert_allclose([h["loss"] for h in hist], j_losses,
                               rtol=1e-5)
    j_of_t = {n: {s + "_inv": np.asarray(invert_leaf(jnp.asarray(
        f.numpy()), kj)) for s, f in d.items()}
        for n, d in state.kfac.factors.items()}
    for n, d in j_state.kfac.inverses.items():
        for side, v in d.items():
            got = state.kfac.inverses[n][side].numpy()
            scale = np.max(np.abs(v))
            own = np.max(np.abs(got - j_of_t[n][side]))
            assert own <= 1e-3 * scale, (n, side, own)
            err = np.max(np.abs(got - v))
            moved = np.max(np.abs(j_of_t[n][side] - v))
            assert err <= max(1e-2 * scale, 1.05 * moved), (n, side, err)
    check_params(state, j_state, tsteps.kfac_specs(tcfg), lr=kj.lr,
                 n_steps=n_steps,
                 bound=lambda v: param_rtol * np.max(np.abs(v)),
                 mu_rtol=max(1e-2, param_rtol))
    return hist, state
