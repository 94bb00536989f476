"""repro_torch's whisper (the audio encoder-decoder, whisper-tiny's smoke
config) against the JAX reference on converted weights and numpy
inputs from a seed: loss, logits and every gradient in fp32 and bf16,
the K-FAC statistics with the per-name taps (encoder and cross-attention
taps over the frames), a 4-step K-FAC trajectory through
``launch.train.run``, prefill and decode against the full decoder and
against the reference's serving functions, and the cache's slot ops.

Tolerances are the dense family's (``tests/_torch_families.py``): fp32
loss and logits rtol 1e-5 with atol 1e-5, gradients rtol 1e-5 with atol
1e-6; bf16 loss rtol 1e-4 and logits atol 0.03 (or the reference's own
bf16-to-fp32 gap), gradients 5% of each leaf's largest entry; stats
factors rtol 1e-4 with atol 1e-6 of the largest entry; the trajectory's
bounds as ``check_trajectory`` states them, but the final weights and
Adam moments within 10% (see the test: the reference's own trajectory is
that sensitive). Serving in fp32: logits
within 1e-5 of the reference's prefill and decode steps (atol 1e-5),
and of the port's own full decode (the reference's own test holds its
cached path to 2e-2; the port's cache adds no rounding in fp32); caches
within 1e-5. The sinusoid within 1e-5 (sines of fp32 angles up to 40
rad, whose ulp is 4e-6; measured 3.8e-6), LayerNorm rtol 1e-5 with atol
1e-6.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fam
from _torch_families import one_thread  # noqa: F401 (autouse)
from repro.configs import get_smoke_config
from repro.core import kfac as jkfac
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.dist.api import path_key
from repro.launch import steps as jsteps
from repro.models import whisper as jw
from repro.serve import pool as jpool
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.core import soi
from repro_torch.launch import steps as tsteps
from repro_torch.models import whisper as tw
from repro_torch.serve import pool as tpool

ARCH = "whisper-tiny"


def cfgs(dtype="float32"):
    return (dataclasses.replace(get_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(t_get_smoke_config(ARCH), dtype=dtype))


def inputs(cfg, *, b=2, t=24, te=20, seed=1):
    params = jax.device_get(jw.init(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32),
             "enc_embeds": rng.standard_normal(
                 (b, te, cfg.d_model)).astype(np.float32)}
    return params, batch


@functools.lru_cache(maxsize=4)
def reference(dtype, compiled=False):
    """Loss, fp32 logits and gradients of the reference's
    ``encode``/``decode``/``loss_from_logits`` (``loss_fn``'s pass) on
    :func:`inputs`, jitted as a whole with ``compiled`` (without XLA's
    excess precision, see ``_torch_families.check_bf16``). Cached: the
    bf16 test reuses the fp32 pass."""
    cfg = cfgs(dtype)[0]
    params, b = inputs(cfg)
    jb = fam.jbatch(b)

    def loss_and_logits(p):
        enc, _ = jw.encode(cfg, p, jb["enc_embeds"])
        logits, _, _ = jw.decode(cfg, p, jb["tokens"], enc)
        return jw.loss_from_logits(cfg, logits, jb), logits

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
    tb = fam.tbatch(b)
    enc, _ = tw.encode(cfg, tp, tb["enc_embeds"])
    logits, _ = tw.decode(cfg, tp, tb["tokens"], enc)
    loss = tw.loss_from_logits(cfg, logits, tb)
    grads = torch.autograd.grad(loss, list(tp.values()))
    return (float(loss.detach()), logits.detach().numpy(),
            dict(zip(tp, grads)))


def test_init_and_specs_match_reference():
    """The port's own init lays out the reference's tree, and the K-FAC
    registry and factor shapes are the reference's, shared A factors
    (self-attention wk/wv on wq, cross wv on cross wk) included."""
    jcfg, tcfg = cfgs()
    jp = convert._flatten(jax.device_get(jw.init(jcfg,
                                                 jax.random.PRNGKey(0))))
    tp = tw.init(tcfg, generator=torch.Generator().manual_seed(0),
                 device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in tp.values())
    for name in ("enc/ln1/w", "dec_ln_f/w"):
        assert torch.all(tp[name] == 1.0)
    jspecs, tspecs = jw.kfac_specs(jcfg), tw.kfac_specs(tcfg)
    assert list(tspecs) == list(jspecs)
    for k, s in jspecs.items():
        t = tspecs[k]
        assert (t.d_in, t.d_out, t.stack, t.share_a_with) == \
            (s.d_in, s.d_out, s.stack, s.share_a_with), k
    assert tspecs["dec/cross/wv"].share_a_with == "dec/cross/wk"
    assert tspecs["dec/cross/wk"].share_a_with is None


def test_loss_logits_and_grads_match_reference_fp32():
    jcfg, tcfg = cfgs("float32")
    params, b = inputs(jcfg)
    jl, jlog, jg = reference("float32", compiled=True)
    tl, tlog, tg = port(tcfg, params, b)
    assert tlog.shape == jlog.shape == (2, 24, 256)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlog, jlog, rtol=1e-5, atol=1e-5)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), jg[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_loss_logits_and_grads_match_reference_bf16():
    """bf16, against the reference compiled without XLA's excess
    precision (``_torch_families.check_bf16``)."""
    jcfg, tcfg = cfgs("bfloat16")
    params, b = inputs(jcfg)
    jl, jlog, jg = reference("bfloat16", compiled=True)
    tl, tlog, tg = port(tcfg, params, b)
    jl32, jlog32, _ = reference("float32", compiled=True)
    np.testing.assert_allclose(tl, jl, rtol=max(1e-4, abs(jl - jl32) / jl))
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=max(
        0.03, float(np.max(np.abs(jlog - jlog32)))))
    for k in jg:
        want = np.asarray(jg[k], np.float32)
        err = np.max(np.abs(tg[k].numpy() - want))
        assert err <= 0.05 * np.max(np.abs(want)), (k, err)


def test_sinusoid_and_layer_norm_match_reference():
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers

    pos = np.arange(40, dtype=np.int32).reshape(2, 20)
    np.testing.assert_allclose(
        tw._sinusoid(torch.from_numpy(pos), 64).numpy(),
        np.asarray(jw._sinusoid(jnp.asarray(pos), 64)), rtol=0,
        atol=1e-5)
    rng = np.random.default_rng(2)
    x, w, bias = (rng.standard_normal(s).astype(np.float32)
                  for s in ((3, 5, 64), (64,), (64,)))
    np.testing.assert_allclose(
        tlayers.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(bias)).numpy(),
        np.asarray(jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(bias))),
        rtol=1e-5, atol=1e-6)


def _stats_states(jcfg, tcfg, params, bs):
    kj, kt = JKFACConfig(block_size=bs), tkfac.KFACConfig(block_size=bs)
    jstate = jsteps.TrainState(params, jkfac.init(
        params, jw.kfac_specs(jcfg), kj))
    tparams = convert.params_from_jax(params, device="cpu")
    tstate = tsteps.TrainState(tparams, tkfac.init(
        tparams, tw.kfac_specs(tcfg), kt))
    return kj, kt, jstate, tstate


def _check_factors(got, want):
    assert {n: sorted(d) for n, d in got.items()} == \
        {n: sorted(d) for n, d in want.items()}
    for n, d in want.items():
        for side, v in d.items():
            v = np.asarray(v)
            assert got[n][side].shape == v.shape, (n, side)
            np.testing.assert_allclose(
                got[n][side].numpy(), v, rtol=1e-4,
                atol=1e-6 * np.max(np.abs(v)), err_msg=f"{n}/{side}")


def test_stats_factors_match_reference():
    """One stats step where the reference's taps are right (frames ==
    tokens: it sizes every ``dec/`` tap by the tokens)."""
    jcfg, tcfg = cfgs()
    params, b = inputs(jcfg, t=32, te=32)
    kj, kt, jstate, tstate = _stats_states(jcfg, tcfg, params, 32)
    jstate, jm = jax.jit(jsteps.make_stats_step(jcfg, kj))(
        jstate, fam.jbatch(b))
    tstate, tm = tsteps.make_stats_step(tcfg, kt)(tstate, fam.tbatch(b))
    np.testing.assert_allclose(float(tm["stats_loss"]),
                               float(jm["stats_loss"]), rtol=1e-5)
    _check_factors(tstate.kfac.factors,
                   jax.device_get(jstate.kfac.factors))


def test_stats_taps_over_frames_where_reference_fails():
    """Frames != tokens (here 40 frames, 24 tokens, as a stats
    subsample of tokens shorter than its frames gives): the reference's
    ``_build_taps`` sizes the cross-attention's ``wk``/``wv`` taps by the
    tokens, so its stats step fails; the port sizes them by the frames.
    Held to the reference's own ``kfac.stats_grams`` given taps of the
    right sizes (its fault is in the taps only)."""
    jcfg, tcfg = cfgs()
    params, b = inputs(jcfg, t=24, te=40)
    kj, kt, jstate, tstate = _stats_states(jcfg, tcfg, params, 32)
    with pytest.raises(TypeError):
        jsteps.make_stats_step(jcfg, kj)(jstate, fam.jbatch(b))
    tstate, tm = tsteps.make_stats_step(tcfg, kt)(tstate, fam.tbatch(b))
    ttaps = tsteps.build_taps(tcfg, tw.kfac_specs(tcfg), fam.tbatch(b))
    assert ttaps["dec/cross/wk"].shape == (2, 2 * 40, 64)
    assert ttaps["dec/cross/wv"].shape == (2, 2 * 40, 64)
    assert ttaps["dec/cross/wq"].shape == (2, 2 * 24, 64)
    assert ttaps["enc/attn/wq"].shape == (2, 2 * 40, 64)

    specs = jw.kfac_specs(jcfg)
    jtaps = {n: jnp.zeros(tuple(t.shape), jnp.float32)
             for n, t in ttaps.items()}

    def loss_with_taps(p, tp, bt):
        return jw.loss_fn(jcfg, p, bt, taps=tp, collect=True)

    a, g, loss = jax.jit(lambda p, tp, bt: jkfac.stats_grams(
        loss_with_taps, p, tp, bt, specs, 32))(params, jtaps, fam.jbatch(b))
    want = jax.device_get(jkfac.update_factors(jstate.kfac, a, g,
                                               kj).factors)
    np.testing.assert_allclose(float(tm["stats_loss"]), float(loss),
                               rtol=1e-5)
    _check_factors(tstate.kfac.factors, want)


def test_four_step_trajectory_matches_reference():
    """4 K-FAC steps of the port's ``launch.train.run`` against the
    reference's ``KFACProgram``, each step with the same seeded frames
    (frames == tokens, where the reference's taps are right): losses
    rtol 1e-5 and the inverses as for every family; the final weights
    and Adam's first moments within 10% of each leaf's largest entry.
    This smoke model's trajectory amplifies rounding after its second
    refresh: the
    reference itself ends 22-37% apart on the six most moved factored
    leaves when its initial weights change by 2^-22 relative (measured),
    and the port ends within 6.4% (dec/mlp/w2; within 0.3% after 2
    steps), its first moments within 1.4% (0.085% after 2 steps)."""
    jcfg, _ = cfgs()
    frames = np.random.default_rng(0).standard_normal(
        (2, jsteps.enc_len_for(jcfg, 32), jcfg.d_model)).astype(np.float32)
    hist, state = fam.check_trajectory(ARCH, more={"enc_embeds": frames},
                                       param_rtol=0.1)
    assert len(hist) == 4
    assert state.kfac.factors["dec/cross/wk"]["A"].shape == (2, 2, 32, 32)


def test_microbatch_split_keeps_frames():
    """``train_accum`` splits ``enc_embeds`` with the token rows: the
    2-microbatch step equals the reference's."""
    jcfg, tcfg = cfgs()
    jcfg = dataclasses.replace(jcfg, train_accum=2)
    tcfg = dataclasses.replace(tcfg, train_accum=2)
    params, b = inputs(jcfg, b=4, t=16, te=16, seed=3)
    jk, tk = JKFACConfig(block_size=32), tkfac.KFACConfig(block_size=32)
    js = jsteps.TrainState(params, jkfac.init(params, jw.kfac_specs(jcfg),
                                              jk))
    js, jm = jax.jit(jsteps.make_train_step(jcfg, jk))(js, fam.jbatch(b))
    tparams = convert.params_from_jax(params, device="cpu")
    ts = tsteps.TrainState(tparams, tkfac.init(tparams,
                                               tw.kfac_specs(tcfg), tk))
    ts, tm = tsteps.make_train_step(
        tcfg, tk, wu_plan=tsteps.make_wu_plan_for(tcfg, ts),
        use_kernel=True)(ts, fam.tbatch(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    fam.check_params(ts, js, tw.kfac_specs(tcfg), lr=jk.lr, n_steps=1,
                     bound=lambda v: 3e-5)


def test_stats_subsample_keeps_all_frames():
    """The SU's subsample takes ``stats_batch`` rows of the frames, all
    of them (the reference's), beside ``stats_seq`` tokens."""
    from repro_torch.launch import train as ttrain

    _, tcfg = cfgs()
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
    _, b = inputs(tcfg, t=32, te=32)
    step_fn(state, fam.tbatch(b))
    assert seen == [{"tokens": (1, 16), "enc_embeds": (1, 32, 64)}]


def test_training_cli_refuses_whisper():
    """The CLI's synthetic stream makes no frames (nor does the
    reference's): it says so instead of failing in the model."""
    from repro_torch.launch import train as ttrain

    with pytest.raises(ValueError, match="enc_embeds"):
        ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--steps", "1"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_whisper_prefill_decode():
    """Prefill of half the tokens, then decode steps, against the
    port's full decoder (as ``tests/test_archs.py`` holds the
    reference's), and each step's logits and the final cache against
    the reference's ``prefill``/``decode_step``, in fp32."""
    jcfg, tcfg = cfgs()
    params, b = inputs(jcfg, b=2, t=32, te=32)
    tp = convert.params_from_jax(params, device="cpu")
    tb = fam.tbatch(b)
    enc, _ = tw.encode(tcfg, tp, tb["enc_embeds"])
    full, _ = tw.decode(tcfg, tp, tb["tokens"], enc)
    t0, T = 16, 32
    tcache = tw.init_cache(tcfg, 2, T + 4, T, dtype=torch.float32,
                           device="cpu")
    jcache = jw.init_cache(jcfg, 2, T + 4, T, dtype=jnp.float32)
    tl, tcache = tw.prefill(tcfg, tp, {"enc_embeds": tb["enc_embeds"],
                                       "tokens": tb["tokens"][:, :t0]},
                            tcache)
    jl, jcache = jw.prefill(jcfg, params, {
        "enc_embeds": jnp.asarray(b["enc_embeds"]),
        "tokens": jnp.asarray(b["tokens"][:, :t0])}, jcache)
    np.testing.assert_allclose(tl.numpy(), full[:, t0 - 1].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for i in range(t0, t0 + 4):
        tl, tcache = tw.decode_step(tcfg, tp, tb["tokens"][:, i:i + 1],
                                    tcache)
        jl, jcache = jw.decode_step(jcfg, params,
                                    jnp.asarray(b["tokens"][:, i:i + 1]),
                                    jcache)
        np.testing.assert_allclose(tl.numpy(), full[:, i].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
    assert tcache["idx"] == int(jcache["idx"]) == t0 + 4
    want = {path_key(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jcache)[0]}
    got = convert.cache_to_jax(tcache)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_whisper_right_padded_prefill_matches_exact():
    """A bucket-padded prompt with ``length``: the logits at the last
    real token and the cache's live columns are the exact prompt's."""
    _, tcfg = cfgs()
    params, b = inputs(cfgs()[0], b=1, t=16, te=12)
    tp = convert.params_from_jax(params, device="cpu")
    tb = fam.tbatch(b)
    n = 11
    exact = tw.init_cache(tcfg, 1, 16, 12, dtype=torch.float32,
                          device="cpu")
    le, exact = tw.prefill(tcfg, tp, {"enc_embeds": tb["enc_embeds"],
                                      "tokens": tb["tokens"][:, :n]}, exact)
    padded = tw.init_cache(tcfg, 1, 16, 12, dtype=torch.float32,
                           device="cpu")
    lp, padded = tw.prefill(tcfg, tp, tb, padded,
                            length=torch.tensor([n]))
    np.testing.assert_allclose(lp.numpy(), le.numpy(), rtol=1e-5, atol=1e-5)
    for k in ("layers/self/k", "layers/self/v"):
        np.testing.assert_allclose(padded[k][:, :, :n].numpy(),
                                   exact[k][:, :, :n].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_pool_write_reset_whisper_cache():
    """The slot ops on whisper's cache (self KV and the precomputed
    cross KV), as ``tests/test_serve_engine.py`` checks the reference's,
    and the written pool against the reference's on the same prefill."""
    jcfg, tcfg = cfgs()
    S, enc_len, slots = 12, 6, 2
    params = jax.device_get(jw.init(jcfg, jax.random.PRNGKey(0)))
    tp = convert.params_from_jax(params, device="cpu")
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab, size=4).astype(np.int32)
    frames = np.ones((1, enc_len, jcfg.d_model), np.float32)

    pool = tpool.init_pool(tcfg, slots, S, enc_len=enc_len, device="cpu")
    row = tw.init_cache(tcfg, 1, S, enc_len, device="cpu")
    _, row = tw.prefill(tcfg, tp, {"tokens": torch.from_numpy(prompt[None]),
                                   "enc_embeds": torch.from_numpy(frames)},
                        row, length=torch.tensor([4]))
    pool = tw.cache_write_slot(pool, 0, row, 4)
    assert int(pool["idx"][0]) == 4
    ck = pool["layers/cross_k"]                 # (L, B, enc, h, hd)
    assert ck[:, 0].abs().max() > 0
    assert torch.all(ck[:, 1] == 0)

    jp = jpool.init_pool(jcfg, slots, S, enc_len=enc_len)
    jrow = jw.init_cache(jcfg, 1, S, enc_len)
    _, jrow = jw.prefill(jcfg, params, {
        "tokens": jnp.asarray(prompt[None]),
        "enc_embeds": jnp.asarray(frames)}, jrow, length=jnp.asarray([4]))
    jp = jw.cache_write_slot(jp, 0, jrow, 4)
    want = {path_key(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = convert.cache_to_jax(pool)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        # one bf16 rounding of values that agree to fp32 rounding
        np.testing.assert_allclose(got[k].astype(np.float32), v, rtol=1e-2,
                                   atol=1e-2, err_msg=k)
        assert np.array_equal(got[k].astype(np.float32) == 0, v == 0), k

    pool = tw.cache_reset_slot(pool, 0)
    assert int(pool["idx"][0]) == 0
    assert torch.all(pool["layers/cross_k"][:, 0] == 0)
    assert torch.all(pool["layers/self/pos"][:, 0] == tpool.UNWRITTEN_POS)


def test_serve_cli_whisper_static():
    """``--arch whisper-tiny`` serves on the static path (the engine
    takes token-only prompts), as the reference's CLI routes it."""
    from repro_torch.launch import serve as tserve

    summary, out = tserve.main(["--arch", ARCH, "--smoke", "--device",
                                "cpu", "--batch", "2", "--prompt-len",
                                "4", "--gen", "5"])
    assert summary["mode"] == "static"
    assert out.shape == (2, 5)
    assert ((0 <= out) & (out < 256)).all()


def test_kfac_factor_shapes_at_published_widths():
    """whisper-tiny's leaves at block 128: d 384 = 3 blocks, d_ff 1536 =
    12, over (4,) stacks; 27 factor leaves, one neumann_inv launch a
    refresh."""
    from repro_torch.configs import get_config

    specs = tw.kfac_specs(get_config(ARCH))
    shapes = {n: soi.factor_shapes(s, 128) for n, s in specs.items()}
    assert shapes["enc/mlp/w1"] == {"A": (4, 3, 128, 128),
                                    "G": (4, 12, 128, 128)}
    assert shapes["dec/cross/wv"] == {"G": (4, 3, 128, 128)}
    assert sum(len(d) for d in shapes.values()) == 27
