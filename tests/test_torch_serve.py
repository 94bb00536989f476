"""repro_torch's serving path against the JAX reference, at smoke size on
the CPU: the cache writes (``layers.kv_cache_update``/
``pos_cache_update``), ``prefill``/``decode_step`` of the dense, moe,
ssm and hybrid families (right-padded prefill with ``length`` too), the
slot pool, the sampler, the scheduler, ``ServeEngine`` and the serving
CLI. Tests with a counterpart in ``tests/test_serve_engine.py`` carry
its name.

Tolerances: logits and caches within 1e-5 (atol; rtol 1e-5) of the
reference's in fp32, where both sum in fp32 in the same order but for
the scans (``layers.linear_scan`` against ``associative_scan``) and
matmul blocking; a pool's bf16 KV leaves within one bf16 rounding of
those values (rtol 1e-2, atol 1e-6), its zeros and positions exact. The
engine against the static path, greedy, token for token (bitwise
tokens, as the reference's own test holds it), and against the
reference's engine on the same weights, token for token in fp32. The
sampler's random draws come from a ``torch.Generator`` and cannot
match ``jax.random``'s: its support and its repeatability are held,
not its values.
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
from repro.configs import get_smoke_config
from repro.dist.api import path_key
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.serve import engine as jengine
from repro.serve import pool as jpool
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tlayers
from repro_torch.serve import (
    EngineConfig,
    Request,
    Scheduler,
    ServeEngine,
    UNWRITTEN_POS,
    default_buckets,
    empty_row_like,
    init_pool,
    make_sampler,
    reset_slot,
    synthetic_trace,
    write_slot,
)

FAMILIES = ["qwen2-0.5b", "moonshot-v1-16b-a3b", "falcon-mamba-7b",
            "recurrentgemma-9b"]


def cfgs(arch, dtype=None):
    j, t = get_smoke_config(arch), t_get_smoke_config(arch)
    if dtype:
        j, t = (dataclasses.replace(j, dtype=dtype),
                dataclasses.replace(t, dtype=dtype))
    return j, t


def _params(arch, dtype=None, seed=0):
    """The reference's weights (numpy) and the port's copy."""
    jcfg, tcfg = cfgs(arch, dtype)
    mod = jsteps.model_module(jcfg)
    params = jax.device_get(mod.init(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, tcfg, params, convert.params_from_jax(params,
                                                       device="cpu")


def _prompt(vocab, n, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, size=n).astype(np.int32)


def _jfns(jcfg):
    """The reference's prefill and decode step, jitted (op by op its
    scans take seconds a call here)."""
    jm = jsteps.model_module(jcfg)
    prefill = jax.jit(lambda p, b, c, n: jm.prefill(jcfg, p, b, c,
                                                    length=n))
    decode = jax.jit(lambda p, t, c: jm.decode_step(jcfg, p, t, c))
    return prefill, decode


def _flat(tree):
    return {path_key(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check_cache(tcache, jcache, rtol=1e-5, atol=1e-5):
    want, got = _flat(jcache), convert.cache_to_jax(tcache)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float32), v,
                                   rtol=rtol, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# cache writes
# ---------------------------------------------------------------------------

def _kv(seed, B=3, S=8, t=1):
    rng = np.random.default_rng(seed)
    ck = rng.standard_normal((B, S, 2, 4)).astype(np.float32)
    cv = rng.standard_normal((B, S, 2, 4)).astype(np.float32)
    k = rng.standard_normal((B, t, 2, 4)).astype(np.float32)
    v = rng.standard_normal((B, t, 2, 4)).astype(np.float32)
    pos = np.full((B, S), UNWRITTEN_POS, np.int32)
    qp = np.arange(t, dtype=np.int32)[None].repeat(B, 0) + 3
    return ck, cv, k, v, pos, qp


@pytest.mark.parametrize("idx", [0, 3, np.array([2, 7, 5], np.int32)])
def test_cache_update_matches_reference(idx):
    """A scalar column (every row; 3 columns at once), and a (B,) vector
    of per-row columns: the port's in-place writes against the
    reference's, bitwise."""
    t = 1 if np.ndim(idx) else 3
    ck, cv, k, v, pos, qp = _kv(0, t=t)
    jk, jv = jlayers.kv_cache_update(*map(jnp.asarray, (ck, cv, k, v)),
                                     jnp.asarray(idx))
    jp = jlayers.pos_cache_update(jnp.asarray(pos), jnp.asarray(qp),
                                  jnp.asarray(idx))
    tidx = torch.from_numpy(idx) if np.ndim(idx) else idx
    tk, tv = tlayers.kv_cache_update(*map(torch.from_numpy, (ck, cv, k, v)),
                                     tidx)
    tp = tlayers.pos_cache_update(torch.from_numpy(pos),
                                  torch.from_numpy(qp), tidx)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_cache_update_idle_slot_divert_untouched():
    """A row whose column is at or past the cache's edge (the engine's
    idle slots, sent to ``max_len``) writes nothing: its row stays
    bitwise what it was, as the reference's dropping scatter leaves it;
    the others are written."""
    ck, cv, k, v, pos, qp = _kv(1)
    idx = np.array([8, 4, 11], np.int32)
    tk, tv, tpos = (torch.from_numpy(x.copy()) for x in (ck, cv, pos))
    tlayers.kv_cache_update(tk, tv, torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(idx))
    tlayers.pos_cache_update(tpos, torch.from_numpy(qp),
                             torch.from_numpy(idx))
    for r in (0, 2):
        assert torch.equal(tk[r], torch.from_numpy(ck[r]))
        assert torch.equal(tv[r], torch.from_numpy(cv[r]))
        assert torch.equal(tpos[r], torch.from_numpy(pos[r]))
    assert torch.equal(tk[1, 4], torch.from_numpy(k[1, 0]))
    assert int(tpos[1, 4]) == 3
    jk, _ = jlayers.kv_cache_update(*map(jnp.asarray, (ck, cv, k, v)),
                                    jnp.asarray(idx))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_cache_update_refuses_overrun():
    """A scalar write that would run past the last column raises; the
    reference's ``dynamic_update_slice`` would clamp its start and write
    the tokens earlier in the cache."""
    ck, cv, k, v, _, _ = _kv(2, t=3)
    with pytest.raises(ValueError, match="overruns"):
        tlayers.kv_cache_update(*map(torch.from_numpy, (ck, cv, k, v)), 6)


def test_causal_conv1d_state_matches_reference():
    """The decode form (carried state) and the right-padded prefill's
    state at ``length``."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 5)).astype(np.float32)
    w = rng.standard_normal((5, 4)).astype(np.float32)
    st = rng.standard_normal((2, 3, 5)).astype(np.float32)
    length = np.array([4, 6], np.int32)
    for kw in ({"state": st}, {"length": length},
               {"state": st, "length": length}):
        jo, js = jlayers.causal_conv1d(
            jnp.asarray(x), jnp.asarray(w),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        to, ts = tlayers.causal_conv1d(
            torch.from_numpy(x), torch.from_numpy(w),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_match_reference(arch):
    """fp32: a prefill then three decode steps; each step's logits and
    the final cache against the reference's."""
    jcfg, tcfg, params, tp = _params(arch, "float32")
    jm, tm = jsteps.model_module(jcfg), tsteps.model_module(tcfg)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab, (2, 11)).astype(np.int32)
    jprefill, jdecode = _jfns(jcfg)
    jc = jm.init_cache(jcfg, 2, 20, dtype=jnp.float32)
    tc = tm.init_cache(tcfg, 2, 20, torch.float32, device="cpu")
    jl, jc = jprefill(params, {"tokens": jnp.asarray(toks)}, jc, None)
    with torch.no_grad():
        tl, tc = tm.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                            tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        for i in range(3):
            t = toks[:, i:i + 1]
            jl, jc = jdecode(params, jnp.asarray(t), jc)
            tl, tc = tm.decode_step(tcfg, tp, torch.from_numpy(t), tc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=1e-5, atol=1e-5)
    assert tc["idx"] == int(jc["idx"]) == 14
    _check_cache(tc, jc)


@pytest.mark.parametrize("arch", FAMILIES)
def test_right_padded_prefill_matches_reference(arch):
    """A prompt right-padded to a bucket with per-row ``length``: logits
    at the last real token and the cache (the recurrent states taken at
    ``length - 1``) against the reference's."""
    jcfg, tcfg, params, tp = _params(arch, "float32")
    jm, tm = jsteps.model_module(jcfg), tsteps.model_module(tcfg)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab, (2, 16)).astype(np.int32)
    length = np.array([11, 16], np.int32)
    jl, jc = _jfns(jcfg)[0](params, {"tokens": jnp.asarray(toks)},
                            jm.init_cache(jcfg, 2, 24, dtype=jnp.float32),
                            jnp.asarray(length))
    with torch.no_grad():
        tl, tc = tm.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(tcfg, 2, 24, torch.float32,
                                          device="cpu"),
                            length=torch.from_numpy(length))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    _check_cache(tc, jc)


def test_hybrid_prefill_longer_than_ring_matches_reference():
    """The hybrid's windowed layers keep ``min(seq_len, window)``
    columns; a prompt longer than the ring attends within itself and
    stores its last S tokens rolled to their ring columns."""
    jcfg, tcfg, params, tp = _params("recurrentgemma-9b", "float32")
    jm, tm = jsteps.model_module(jcfg), tsteps.model_module(tcfg)
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab, (1, 40)).astype(np.int32)
    jprefill, jdecode = _jfns(jcfg)
    jc = jm.init_cache(jcfg, 1, 48, dtype=jnp.float32)
    tc = tm.init_cache(tcfg, 1, 48, torch.float32, device="cpu")
    assert tc["units/sub2/k"].shape[2] == jcfg.window == 32
    jl, jc = jprefill(params, {"tokens": jnp.asarray(toks)}, jc, None)
    with torch.no_grad():
        tl, tc = tm.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                            tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        jl, jc = jdecode(params, jnp.asarray(toks[:, :1]), jc)
        tl, tc = tm.decode_step(tcfg, tp, torch.from_numpy(toks[:, :1]),
                                tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    _check_cache(tc, jc)


def test_ssm_right_padded_prefill_state_exact():
    """A right-padded ssm prefill's state equals the exact-length
    prefill's, bitwise, and so do the logits (the reference's regression
    test for its padded-prefill state bug)."""
    _, tcfg, _, tp = _params("falcon-mamba-7b")
    tm = tsteps.model_module(tcfg)
    tp_len, bucket = 11, 16
    prompt = _prompt(tcfg.vocab, tp_len, seed=12)
    padded_toks = np.zeros((1, bucket), np.int32)
    padded_toks[0, :tp_len] = prompt
    with torch.no_grad():
        lg_e, exact = tm.prefill(
            tcfg, tp, {"tokens": torch.from_numpy(prompt[None])},
            tm.init_cache(tcfg, 1, 32, device="cpu"),
            length=torch.tensor([tp_len]))
        lg_p, padded = tm.prefill(
            tcfg, tp, {"tokens": torch.from_numpy(padded_toks)},
            tm.init_cache(tcfg, 1, 32, device="cpu"),
            length=torch.tensor([tp_len]))
    assert torch.equal(lg_e, lg_p)
    for k in ("layers/h", "layers/conv"):
        assert torch.equal(exact[k], padded[k]), k


# ---------------------------------------------------------------------------
# slot pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b"])
def test_pool_write_and_reset_slot(arch):
    """A padded prefill row into slot 1 of 3, then its reset, against
    the reference's pool after the same operations (fp32 compute, the
    pool's bf16 KV within one bf16 rounding: rtol 1e-2)."""
    jcfg, tcfg, params, tp = _params(arch, "float32")
    jm, tm = jsteps.model_module(jcfg), tsteps.model_module(tcfg)
    S, slots, length = 16, 3, 5
    toks = _prompt(jcfg.vocab, 8)[None]
    pool = init_pool(tcfg, slots, S, device="cpu")
    assert pool["idx"].shape == (slots,)
    with torch.no_grad():
        _, row = tm.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                            tm.init_cache(tcfg, 1, S, device="cpu"),
                            length=torch.tensor([length]))
    pool = write_slot(pool, 1, row, length)
    jp = jpool.init_pool(jcfg, slots, S)
    _, jrow = jm.prefill(jcfg, params, {"tokens": jnp.asarray(toks)},
                         jm.init_cache(jcfg, 1, S),
                         length=jnp.asarray([length]))
    jp = jpool.write_slot(jp, 1, jrow, length)
    assert int(pool["idx"][1]) == length and int(pool["idx"][0]) == 0
    # bf16 leaves: one rounding of values that agree to fp32 rounding
    _check_cache(pool, jp, rtol=1e-2, atol=1e-6)
    if tcfg.family == "dense":
        pos = pool["layers/pos"]
        assert torch.all(pos[:, 1, :length] == torch.arange(length))
        assert torch.all(pos[:, 1, length:] == UNWRITTEN_POS)
        assert torch.all(pos[:, 0] == UNWRITTEN_POS)
        assert torch.all(pool["layers/k"][:, 0] == 0)
    pool = reset_slot(pool, 1)
    jp = jpool.reset_slot(jp, 1)
    assert int(pool["idx"][1]) == 0
    _check_cache(pool, jp, rtol=0, atol=0)
    for k, v in pool.items():
        if k != "idx" and k.rsplit("/", 1)[-1] != "pos":
            assert torch.all(v[:, 1] == 0), k


def test_empty_row_like_matches_fresh_cache():
    jcfg, tcfg = cfgs("qwen2-0.5b")
    pool = init_pool(tcfg, 2, 8, device="cpu")
    row = empty_row_like(pool)
    assert row["idx"] == 0
    assert row["layers/k"].shape[1] == 1
    assert torch.all(row["layers/pos"] == UNWRITTEN_POS)
    fresh = tsteps.model_module(tcfg).init_cache(tcfg, 1, 8, device="cpu")
    assert sorted(row) == sorted(fresh)
    for k in fresh:
        if k != "idx":
            assert torch.equal(row[k], fresh[k]), k
    want = _flat(jpool.empty_row_like(jpool.init_pool(jcfg, 2, 8)))
    got = convert.cache_to_jax(row)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


def test_slot_dim_follows_the_flat_keys():
    """Layer-stacked leaves carry the slot dim second, the hybrid's
    tail and ``idx`` first: the same dims the reference's rule finds on
    its tree paths (its state tuples' ``0``/``1`` are the port's
    ``h``/``conv``)."""
    from repro_torch.serve.pool import slot_dim

    for arch in FAMILIES:
        jcfg, tcfg = cfgs(arch)
        want = {path_key(p): jpool.slot_dim(path_key(p), v.ndim)
                for p, v in jax.tree_util.tree_flatten_with_path(
                    jpool.init_pool(jcfg, 3, 8))[0]}
        got = {k: slot_dim(k) for k in init_pool(tcfg, 3, 8, device="cpu")}
        renamed = {k.replace("/h", "/0").replace("/conv", "/1"): d
                   for k, d in got.items()}
        assert renamed == want, arch


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_sampler_greedy_and_topk():
    logits = torch.tensor([[0.0, 5.0, 1.0, -2.0]] * 3)
    gen = torch.Generator().manual_seed(0)
    assert torch.all(make_sampler("greedy")(logits, gen) == 1)
    assert make_sampler("greedy")(logits).dtype == torch.int32
    # top_k=1 is greedy whatever the temperature
    tk = make_sampler("top_k", temperature=5.0, top_k=1)
    assert torch.all(tk(logits, gen) == 1)
    # top_k=2 only ever emits the two best ids
    tk2 = make_sampler("top_k", temperature=2.0, top_k=2)
    for s in range(5):
        got = tk2(logits, torch.Generator().manual_seed(s))
        assert set(got.tolist()) <= {1, 2}


def test_sampler_greedy_first_index_on_ties():
    """argmax takes the first of tied maxima, as ``jnp.argmax`` does."""
    logits = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]],
                      np.float32)
    want = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    got = make_sampler("greedy")(torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampler_rejects_bad_args():
    with pytest.raises(ValueError):
        make_sampler("nucleus")
    with pytest.raises(ValueError):
        make_sampler("temperature", temperature=0.0)
    with pytest.raises(ValueError):
        make_sampler("top_k", top_k=0)


def test_sampler_topk_tied_logits_regression():
    """Four ids tied at the max and top_k=2: only the two ids
    ``lax.top_k`` ranks first (the lower indices) may be drawn, and
    both are."""
    logits = np.array([[3.0, 3.0, 3.0, 3.0, 0.0, -1.0]], np.float32)
    _, idx = jax.lax.top_k(jnp.asarray(logits), 2)
    allowed = set(np.asarray(idx[0]).tolist())
    assert len(allowed) == 2
    tk = make_sampler("top_k", temperature=1.0, top_k=2)
    seen = {int(tk(torch.from_numpy(logits),
                   torch.Generator().manual_seed(s))[0])
            for s in range(64)}
    assert seen <= allowed
    assert len(seen) == 2


def test_sampler_topk_ties_below_threshold():
    """k=3 with five ids sharing the 3rd-best value samples only the
    ids ``lax.top_k`` keeps."""
    logits = np.array([[5.0, 4.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0]],
                      np.float32)
    _, idx = jax.lax.top_k(jnp.asarray(logits), 3)
    allowed = set(np.asarray(idx[0]).tolist())
    tk = make_sampler("top_k", temperature=2.0, top_k=3)
    for s in range(48):
        assert int(tk(torch.from_numpy(logits),
                      torch.Generator().manual_seed(s))[0]) in allowed


def test_sampler_temperature_support_and_repeatability():
    """Draws from the full distribution reach every id with mass, none
    with -1e30 (a padded vocabulary column), and repeat for a seed."""
    logits = torch.tensor([[0.0, 0.5, -1e30, 0.2]] * 4)
    s = make_sampler("temperature", temperature=1.0)
    draws = [s(logits, torch.Generator().manual_seed(i)) for i in range(32)]
    seen = set(torch.cat(draws).tolist())
    assert seen == {0, 1, 3}
    again = [s(logits, torch.Generator().manual_seed(i)) for i in range(32)]
    assert all(torch.equal(a, b) for a, b in zip(draws, again))


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def test_default_buckets_cover_max_len():
    assert default_buckets(96) == jengine.default_buckets(96) \
        == (16, 32, 64, 96)
    assert default_buckets(64) == (16, 32, 64)


def test_scheduler_bucket_rounding():
    s = Scheduler(2, (16, 32, 64))
    assert s.bucket_for(1) == 16
    assert s.bucket_for(16) == 16
    assert s.bucket_for(17) == 32
    assert s.bucket_for(100) == 100          # beyond the largest: exact
    exact = Scheduler(2, (16, 32), exact=True)
    assert exact.bucket_for(17) == 17        # the hybrid family


def test_scheduler_admission_and_reuse():
    s = Scheduler(2, (16,))
    for i in range(5):
        s.submit(Request(i, np.zeros(4, np.int32)))
    got = s.admit()
    assert [r.rid for _, r in got] == [0, 1]
    assert s.admit() == []                   # no free slot
    assert s.n_queued == 3
    slot0 = got[0][0]
    s.release(slot0)
    got2 = s.admit()
    assert len(got2) == 1
    assert got2[0][0] == slot0               # the freed slot is reused
    assert got2[0][1].rid == 2               # FIFO


def test_synthetic_trace_is_the_reference_trace():
    reqs, arr = synthetic_trace(256, 7, 24, 8, 2, seed=3)
    jreqs, jarr = jengine.synthetic_trace(256, 7, 24, 8, 2, seed=3)
    assert arr == jarr
    for r, j in zip(reqs, jreqs):
        assert r.rid == j.rid and r.max_new_tokens == j.max_new_tokens
        np.testing.assert_array_equal(r.prompt, j.prompt)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _static_greedy(cfg, params, prompt, gen):
    """The fixed-batch greedy decode of one prompt."""
    mod = tsteps.model_module(cfg)
    with torch.no_grad():
        cache = mod.init_cache(cfg, 1, len(prompt) + gen, device="cpu")
        logits, cache = mod.prefill(
            cfg, params, {"tokens": torch.from_numpy(prompt[None])}, cache)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out = [int(tok)]
        for _ in range(gen - 1):
            logits, cache = mod.decode_step(cfg, params, tok, cache)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out.append(int(tok))
    return out


@pytest.mark.parametrize("bucket", [16, 32])
def test_engine_matches_static_greedy(bucket):
    """The slot pool's decode (vector idx, per-row writes, bucketed and
    padded prefill) gives the static path's tokens; an empty slot rides
    along."""
    _, tcfg, _, tp = _params("qwen2-0.5b")
    prompt, gen = _prompt(tcfg.vocab, 16, seed=1), 8
    ref = _static_greedy(tcfg, tp, prompt, gen)
    eng = ServeEngine(tcfg, tp, EngineConfig(
        max_slots=2, max_len=48, decode_chunk=3, buckets=(bucket,)))
    out = eng.run([Request(0, prompt, max_new_tokens=gen)])
    assert out[0].tokens == ref
    assert out[0].finish_reason == "length"


def test_engine_mixed_length_trace_with_slot_reuse():
    """More requests than slots, staggered arrivals, mixed lengths:
    every request gets exactly its budget, slots are reused, and each
    request's tokens are the static path's."""
    _, tcfg, _, tp = _params("qwen2-0.5b")
    rng = np.random.default_rng(3)
    reqs = [Request(i, rng.integers(0, tcfg.vocab, size=tp_).astype(
        np.int32), max_new_tokens=g) for i, (tp_, g) in enumerate(
        [(5, 6), (12, 3), (20, 7), (7, 1), (30, 5), (3, 4)])]
    eng = ServeEngine(tcfg, tp, EngineConfig(max_slots=2, max_len=64,
                                             decode_chunk=4))
    out = eng.run(reqs, arrivals=[0, 0, 1, 2, 3, 4])
    assert sorted(out) == list(range(6))
    for r in reqs:
        assert len(out[r.rid].tokens) == r.max_new_tokens
        assert out[r.rid].finish_reason == "length"
        assert out[r.rid].tokens == _static_greedy(tcfg, tp, r.prompt,
                                                   r.max_new_tokens)
    assert eng.stats["prefills"] == 6
    assert eng.scheduler.n_free == 2
    assert eng.n_active == 0


def test_engine_eos_termination():
    """A request whose EOS is the first new token it emits after its
    first (from a decode step, not the prefill) stops there; the
    co-resident request is unaffected. (Of the two requests, the one
    whose free run has such a token takes the EOS: a random smoke model
    can repeat one token throughout.)"""
    _, tcfg, _, tp = _params("qwen2-0.5b")
    prompts = [_prompt(tcfg.vocab, 10, seed=4), _prompt(tcfg.vocab, 9, seed=5)]
    ecfg = EngineConfig(max_slots=2, max_len=32, decode_chunk=2)
    free_run = ServeEngine(tcfg, tp, ecfg).run(
        [Request(i, p, max_new_tokens=6) for i, p in enumerate(prompts)])
    r, j = next((r, j) for r in (0, 1) for j in range(1, 6)
                if free_run[r].tokens[j] not in free_run[r].tokens[:j])
    eos = free_run[r].tokens[j]
    out = ServeEngine(tcfg, tp, ecfg).run(
        [Request(i, p, max_new_tokens=6, eos_id=int(eos) if i == r else -1)
         for i, p in enumerate(prompts)])
    assert out[r].finish_reason == "eos"
    assert out[r].tokens == free_run[r].tokens[:j + 1]
    assert out[1 - r].tokens == free_run[1 - r].tokens
    assert out[1 - r].finish_reason == "length"


def test_engine_decode_is_single_program():
    """N tokens take ceil((N - 1) / chunk) decode chunks, each one host
    read."""
    _, tcfg, _, tp = _params("qwen2-0.5b")
    eng = ServeEngine(tcfg, tp, EngineConfig(max_slots=1, max_len=32,
                                             decode_chunk=5))
    out = eng.run([Request(0, _prompt(tcfg.vocab, 8), max_new_tokens=11)])
    assert len(out[0].tokens) == 11
    assert eng.stats["decode_chunks"] == 2


def test_engine_idle_slots_untouched():
    """Through a decode chunk, an idle dense slot's cache columns stay
    bitwise as they were (its writes are diverted past the edge)."""
    _, tcfg, _, tp = _params("qwen2-0.5b")
    eng = ServeEngine(tcfg, tp, EngineConfig(max_slots=2, max_len=32,
                                             decode_chunk=4))
    eng.submit(Request(0, _prompt(tcfg.vocab, 6), max_new_tokens=9))
    eng._do_admissions()
    before = {k: v.clone() for k, v in eng._pool.items() if k != "idx"}
    slot = 1 - next(iter(eng._slots))
    with torch.no_grad():
        eng.decode_chunk()
    for k, v in before.items():
        assert torch.equal(eng._pool[k][:, slot], v[:, slot]), k
        assert not torch.equal(eng._pool[k], v), k


def test_engine_validates_requests():
    jcfg, tcfg, _, tp = _params("qwen2-0.5b")
    eng = ServeEngine(tcfg, tp, EngineConfig(max_slots=1, max_len=16))
    with pytest.raises(ValueError):
        eng.submit(Request(0, _prompt(tcfg.vocab, 12), max_new_tokens=8))
    with pytest.raises(ValueError):
        eng.submit(Request(0, _prompt(tcfg.vocab, 4), max_new_tokens=0))
    with pytest.raises(NotImplementedError):
        ServeEngine(t_get_smoke_config("whisper-tiny"), tp, EngineConfig())
    with pytest.raises(NotImplementedError, match="serve_quant"):
        ServeEngine(tcfg, tp, EngineConfig(quant="int8"))
    with pytest.raises(ValueError):
        ServeEngine(tcfg, tp, EngineConfig(quant="int4"))
    with pytest.raises(NotImplementedError, match="item 8"):
        ServeEngine(tcfg, tp, EngineConfig(), mesh=object())


def test_engine_hybrid_family_matches_static():
    """The hybrid (RG-LRU states, windowed ring) through the pool."""
    _, tcfg, _, tp = _params("recurrentgemma-9b")
    prompt, gen = _prompt(tcfg.vocab, 7, seed=8), 5
    ref = _static_greedy(tcfg, tp, prompt, gen)
    eng = ServeEngine(tcfg, tp, EngineConfig(max_slots=2, max_len=12,
                                             decode_chunk=2))
    assert eng.scheduler.exact
    out = eng.run([Request(0, prompt, max_new_tokens=gen),
                   Request(1, _prompt(tcfg.vocab, 5, seed=9),
                           max_new_tokens=3)])
    assert out[0].tokens == ref
    assert len(out[1].tokens) == 3


def test_engine_recurrent_family_ssm():
    """ssm prompts take the padded buckets (the state is taken at the
    real boundary): an 11-token prompt in the 16 bucket matches the
    exact static path."""
    _, tcfg, _, tp = _params("falcon-mamba-7b")
    prompt, gen = _prompt(tcfg.vocab, 11, seed=6), 5
    ref = _static_greedy(tcfg, tp, prompt, gen)
    eng = ServeEngine(tcfg, tp, EngineConfig(max_slots=2, max_len=32,
                                             decode_chunk=2, buckets=(16,)))
    assert not eng.scheduler.exact
    assert eng.scheduler.bucket_for(len(prompt)) == 16
    out = eng.run([Request(0, prompt, max_new_tokens=gen),
                   Request(1, _prompt(tcfg.vocab, 7, seed=7),
                           max_new_tokens=3)])
    assert out[0].tokens == ref
    assert len(out[1].tokens) == 3


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b"])
def test_engine_matches_reference_engine(arch):
    """The port's engine and the reference's (``mesh=None``) on the same
    weights and trace, greedy, fp32: the same tokens for every request."""
    jcfg, tcfg, params, tp = _params(arch, "float32")
    reqs, arrivals = synthetic_trace(jcfg.vocab, 5, 20, 6, 2, seed=1)
    ecfg = dict(max_slots=2, max_len=32, decode_chunk=3)
    want = jengine.ServeEngine(jcfg, params,
                               jengine.EngineConfig(**ecfg)).run(
        [jengine.Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs],
        arrivals=arrivals)
    got = ServeEngine(tcfg, tp, EngineConfig(**ecfg)).run(reqs, arrivals)
    assert {k: v.tokens for k, v in got.items()} == \
        {k: v.tokens for k, v in want.items()}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("static", [False, True])
def test_serve_cli_runs_on_cpu(static):
    from repro_torch.launch import serve as tserve

    args = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
            "--prompt-len", "12", "--gen", "4"]
    if static:
        summary, out = tserve.main(args + ["--static", "--batch", "2"])
        assert summary["mode"] == "static" and out.shape == (2, 4)
    else:
        summary, done = tserve.main(args + ["--requests", "3",
                                            "--max-slots", "2"])
        assert summary["mode"] == "engine" and summary["requests"] == 3
        assert summary["generated_tokens"] == sum(
            len(f.tokens) for f in done.values())
        assert summary["resident_bytes"]["pool"] > 0


@pytest.mark.parametrize("flags,item", [
    (["--paged"], "item 7"), (["--prefix-cache"], "item 7"),
    (["--quant", "int8"], "serve_quant"),
    (["--model-parallel", "2"], "item 8")])
def test_serve_cli_refuses_unported(flags, item):
    from repro_torch.launch import serve as tserve

    with pytest.raises(NotImplementedError, match=item):
        tserve.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu"]
                    + flags)


def test_serve_cli_defaults_to_cuda():
    from repro_torch.launch import serve as tserve

    assert tserve.build_parser().parse_args(["--arch", "x"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.main(["--arch", "qwen2-0.5b", "--smoke"])
