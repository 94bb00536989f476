"""repro_torch's block-paged KV pool, shared-prefix cache and int8 serving
against the JAX reference, at smoke size on the CPU: the paged cache
reads and writes (``layers.paged_kv_read``/``paged_kv_write``), the pool
ops (``paged_write_slot``, ``grow_tables``, ``release_slot_blocks``,
``push_blocks``), a paged ``decode_step``, ``PagedServeEngine`` against
the port's slot engine and the reference's paged engine, the int8
engines, and ``lowp.serve_parity``. Tests with a counterpart in
``tests/test_paged.py`` or ``tests/test_serve_engine.py`` carry its name
(the model-parallel ones are multi-GPU work).

Tolerances: the cache ops, block tables, free stacks and lengths
bitwise (the same values move; unmapped entries read 0 and
``UNWRITTEN_POS``); a paged decode step's logits and caches within 1e-5
of the reference's in fp32 (its matmul blocking); the engines' greedy
tokens equal, token for token (paged against slot, as the reference's
own tests hold them, and port against reference in fp32), with the
pools' positions and bookkeeping bitwise and their k/v within 1e-2 of a
leaf's largest entry (fp32 values stored in bf16: a value on a rounding
boundary rounds the other way and the next layer carries it; int8 codes
move by one step of 127 the same way; measured up to 0.2% and 0.8%);
the int8 margin contract as the
reference states it (every request whose fp32 margin clears
``MARGIN_FLOOR`` matches, at least two such requests);
``trained_params`` in fp32 within 1e-4 of the reference's weights (30
SGD steps at lr 0.3 carry the fp32 rounding of two frameworks).
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
from repro.dist.api import path_key
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.serve import engine as jengine
from repro.serve import paged as jpaged
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.launch import steps as tsteps
from repro_torch.lowp import serve_quant
from repro_torch.lowp.serve_parity import (MARGIN_FLOOR, greedy_margin,
                                           serve_greedy_parity,
                                           trained_params)
from repro_torch.models import layers as tlayers
from repro_torch.serve import (
    EngineConfig,
    PagedConfig,
    PagedServeEngine,
    Request,
    ServeEngine,
    UNWRITTEN_POS,
    synthetic_trace,
)
from repro_torch.serve import paged as tpaged
from repro_torch.serve.paged import init_paged_pool

ARCH = "qwen2-0.5b"


def _params(arch=ARCH, dtype=None, seed=0):
    """The reference's config, weights (numpy) and the port's copies."""
    jcfg, tcfg = get_smoke_config(arch), t_get_smoke_config(arch)
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
    params = jax.device_get(jsteps.model_module(jcfg).init(
        jcfg, jax.random.PRNGKey(seed)))
    return jcfg, tcfg, params, convert.params_from_jax(params, device="cpu")


def _prompt(vocab, n, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, size=n).astype(np.int32)


def _ledger_matches_device(eng) -> bool:
    led, pool = eng._ledger, eng._pool
    return (int(pool["free_top"]) == led.top
            and np.array_equal(pool["table"].numpy(), led.table)
            and np.array_equal(pool["n_mapped"].numpy(), led.n_mapped)
            and np.array_equal(pool["free"].numpy(), led.free))


def _run(eng, reqs, arrivals=None):
    with torch.no_grad():
        return eng.run(reqs, arrivals)


def _tokens(out):
    return {rid: f.tokens for rid, f in out.items()}


def _jreqs(reqs):
    return [jengine.Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs]


def _flat(tree):
    return {path_key(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# paged cache reads and writes
# ---------------------------------------------------------------------------

def _block_pool(seed, n_blocks=4, bl=4, kv=2, hd=3):
    rng = np.random.default_rng(seed)
    ck = rng.standard_normal((n_blocks, bl, kv, hd)).astype(np.float32)
    cv = rng.standard_normal((n_blocks, bl, kv, hd)).astype(np.float32)
    cp = rng.integers(0, 50, (n_blocks, bl)).astype(np.int32)
    return ck, cv, cp


# rows: mapped, idle with an all-unmapped table and idx past it (its
# clamped target is block 3, column 0: row 1's live target), unmapped
# entry at idx, live in its second block
_TABLE = np.array([[2, 4, 4], [3, 1, 4], [4, 4, 4], [0, 4, 4],
                   [1, 0, 2]], np.int32)
_IDX = np.array([1, 0, 12, 6, 9], np.int32)


def test_paged_kv_read_matches_reference():
    """Unmapped entries read k/v 0 and positions UNWRITTEN_POS whatever
    block the clamp lands on; mapped ones the block's values; bitwise."""
    ck, cv, cp = _block_pool(1)
    got = tlayers.paged_kv_read(*map(torch.from_numpy, (ck, cv, cp)),
                                torch.from_numpy(_TABLE))
    want = jlayers.paged_kv_read(ck, cv, cp, jnp.asarray(_TABLE))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[2][2] == UNWRITTEN_POS).all() and (got[0][2] == 0).all()


def test_paged_kv_write_matches_reference():
    """A row at an unmapped entry, a row past the table and a live row
    whose target the dropped rows' clamped indices share: only the live
    rows write, bitwise the reference's drop-mode scatter."""
    ck, cv, cp = _block_pool(2)
    rng = np.random.default_rng(3)
    k = rng.standard_normal((5, 1, 2, 3)).astype(np.float32)
    v = rng.standard_normal((5, 1, 2, 3)).astype(np.float32)
    qp = (_IDX[:, None] + 100).astype(np.int32)
    got = tlayers.paged_kv_write(
        *map(torch.from_numpy, (ck.copy(), cv.copy(), cp.copy(), _TABLE,
                                k, v, qp, _IDX)))
    want = jlayers.paged_kv_write(*map(jnp.asarray, (ck, cv, cp, _TABLE, k,
                                                     v, qp, _IDX)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # row 1's write landed at block 3, column 0
    np.testing.assert_array_equal(got[0][3, 0].numpy(), k[1, 0])
    # no live row: every row writes one old value back, nothing moves
    idle = np.full_like(_IDX, 12)
    got = tlayers.paged_kv_write(
        *map(torch.from_numpy, (ck.copy(), cv.copy(), cp.copy(), _TABLE,
                                k, v, qp, idle)))
    for g, before in zip(got, (ck, cv, cp)):
        np.testing.assert_array_equal(g.numpy(), before)


# ---------------------------------------------------------------------------
# pool ops
# ---------------------------------------------------------------------------

def _row(cfg, max_len, seed):
    """A one-slot prefill row of random k/v and positions 0..S-1, in
    both layouts."""
    rng = np.random.default_rng(seed)
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    k = rng.standard_normal((L, 1, max_len, kv, hd)).astype(np.float32)
    v = rng.standard_normal((L, 1, max_len, kv, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(max_len, dtype=np.int32),
                          (L, 1, max_len)).copy()
    jrow = {"layers": {"k": jnp.asarray(k, jnp.bfloat16),
                       "v": jnp.asarray(v, jnp.bfloat16),
                       "pos": jnp.asarray(pos)}, "idx": jnp.asarray(max_len)}
    trow = {"layers/k": torch.from_numpy(k).to(torch.bfloat16),
            "layers/v": torch.from_numpy(v).to(torch.bfloat16),
            "layers/pos": torch.from_numpy(pos), "idx": max_len}
    return jrow, trow


def _check_pool(tpool, jpool):
    want = {**{f"layers/{k}": v for k, v in
               _flat(jpool["cache"]["layers"]).items()},
            **{k: np.asarray(jpool[k]) for k in tpaged.BOOKKEEPING}}
    assert sorted(want) == sorted(tpool)
    for key, w in want.items():
        np.testing.assert_array_equal(
            tpool[key].to(torch.float32).numpy(), np.asarray(w, np.float32),
            err_msg=key)


def test_paged_pool_ops_match_reference():
    """Two admissions (the second sharing the first's head block), a
    table growth, a release keeping the shared block, and a push of it:
    the cache, tables, lengths and free stack bitwise after each op."""
    jcfg, tcfg = get_smoke_config(ARCH), t_get_smoke_config(ARCH)
    max_len, bl, nb = 48, 16, 7
    jp = jpaged.init_paged_pool(jcfg, 3, max_len, bl, nb)
    tp = init_paged_pool(tcfg, 3, max_len, bl, nb, device="cpu")
    _check_pool(tp, jp)
    sent = np.full(3, nb, np.int32)
    j1, t1 = _row(jcfg, max_len, 1)
    jp = jpaged.paged_write_slot(jp, 1, j1, 21, jnp.asarray(sent), 0, 2)
    tpaged.paged_write_slot(tp, 1, t1, 21, sent, 0, 2)
    _check_pool(tp, jp)
    head = int(tp["table"][1, 0])
    shared = np.array([head, nb, nb], np.int32)
    j2, t2 = _row(jcfg, max_len, 2)
    jp = jpaged.paged_write_slot(jp, 0, j2, 33, jnp.asarray(shared), 1, 3)
    tpaged.paged_write_slot(tp, 0, t2, 33, shared, 1, 3)
    _check_pool(tp, jp)
    active = np.array([True, True, False])
    jp = jpaged.grow_tables(jp, jnp.asarray(active), 12)
    tpaged.grow_tables(tp, torch.from_numpy(active), 12)
    _check_pool(tp, jp)
    # slot 0 goes; its head block is still slot 1's
    mask = np.array([False, True, True])
    jp = jpaged.release_slot_blocks(jp, 0, jnp.asarray(mask))
    tpaged.release_slot_blocks(tp, 0, mask)
    _check_pool(tp, jp)
    mask = np.array([False, True, True])
    jp = jpaged.release_slot_blocks(jp, 1, jnp.asarray(mask))
    tpaged.release_slot_blocks(tp, 1, mask)
    _check_pool(tp, jp)
    ids, valid = np.array([head, nb], np.int32), np.array([True, True])
    jp = jpaged.push_blocks(jp, jnp.asarray(ids), jnp.asarray(valid))
    tpaged.push_blocks(tp, ids, valid)
    _check_pool(tp, jp)
    assert int(tp["free_top"]) == nb
    assert (tp["layers/pos"] == UNWRITTEN_POS).all()


def test_decode_step_with_table_matches_reference():
    """fp32: a paged decode step over a hand-built table (a slot in its
    second block, an idle slot at max_len, an unmapped slot) against the
    reference's: logits and the block pool's leaves within 1e-5."""
    jcfg, tcfg, params, tp = _params(dtype="float32")
    jm, tm = jsteps.model_module(jcfg), tsteps.model_module(tcfg)
    rng = np.random.default_rng(4)
    nb, bl = 6, 8
    jcache = jm.init_cache(jcfg, nb, bl)
    L, kv, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.hd
    k = rng.standard_normal((L, nb, bl, kv, hd)).astype(np.float32)
    v = rng.standard_normal((L, nb, bl, kv, hd)).astype(np.float32)
    pos = np.full((L, nb, bl), UNWRITTEN_POS, np.int32)
    pos[:, 2], pos[:, 0, :3] = np.arange(8), np.arange(8, 11)
    table = np.array([[2, 0, nb], [nb, nb, nb], [1, nb, nb]], np.int32)
    idx = np.array([11, 24, 3], np.int32)
    tok = rng.integers(0, jcfg.vocab, (3, 1)).astype(np.int32)
    jcache = {"layers": {"k": jnp.asarray(k), "v": jnp.asarray(v),
                         "pos": jnp.asarray(pos)},
              "idx": jnp.asarray(idx), "table": jnp.asarray(table)}
    want, jnew = jm.decode_step(jcfg, params, jnp.asarray(tok), jcache)
    tcache = {"layers/k": torch.from_numpy(k.copy()),
              "layers/v": torch.from_numpy(v.copy()),
              "layers/pos": torch.from_numpy(pos.copy()),
              "idx": torch.from_numpy(idx), "table": torch.from_numpy(table)}
    with torch.no_grad():
        got, tnew = tm.decode_step(tcfg, tp, torch.from_numpy(tok), tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for key, w in _flat(jnew["layers"]).items():
        np.testing.assert_allclose(tnew[f"layers/{key}"].numpy(), w,
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(tnew["table"].numpy(), table)
    with pytest.raises(NotImplementedError, match="decode-only"):
        tm.forward(tcfg, tp,
                   {"tokens": torch.zeros((3, 2), dtype=torch.int32)},
                   cache=tcache)


# ---------------------------------------------------------------------------
# tests/test_paged.py counterparts
# ---------------------------------------------------------------------------

def test_paged_pool_layout():
    cfg = t_get_smoke_config(ARCH)
    pool = init_paged_pool(cfg, max_slots=3, max_len=64, block_len=16,
                           n_blocks=8, device="cpu")
    assert pool["layers/k"].shape[:3] == (cfg.n_layers, 8, 16)
    assert pool["table"].shape == (3, 4)
    assert (pool["table"] == 8).all()
    assert int(pool["free_top"]) == 8
    assert (pool["layers/pos"] == UNWRITTEN_POS).all()


def test_paged_validates_config():
    cfg = t_get_smoke_config(ARCH)
    with pytest.raises(ValueError):
        init_paged_pool(cfg, 2, 60, 16, 8, device="cpu")
    with pytest.raises(ValueError):
        init_paged_pool(cfg, 2, 64, 16, 3, device="cpu")
    with pytest.raises(ValueError):
        init_paged_pool(cfg, 2, 64, 0, 8, device="cpu")


def test_paged_rejects_recurrent_families():
    for arch in ("falcon-mamba-7b", "recurrentgemma-9b"):
        _, tcfg, _, tp = _params(arch)
        with pytest.raises(NotImplementedError, match="slot engine"):
            PagedServeEngine(tcfg, tp, PagedConfig(
                max_slots=2, max_len=32, block_len=16))


def test_paged_matches_slot_greedy_trace():
    """The full-capacity paged engine gives the slot engine's tokens on
    a mixed-length trace with slot reuse (bf16 caches)."""
    _, tcfg, _, tp = _params()
    reqs, arr = synthetic_trace(tcfg.vocab, 8, 24, 10, 3, seed=1)
    out_s = _run(ServeEngine(tcfg, tp, EngineConfig(
        max_slots=3, max_len=64, decode_chunk=4)), reqs, arr)
    paged = PagedServeEngine(tcfg, tp, PagedConfig(
        max_slots=3, max_len=64, decode_chunk=4, block_len=16))
    out_p = _run(paged, reqs, arr)
    assert _tokens(out_p) == _tokens(out_s)
    assert _ledger_matches_device(paged)


def test_paged_undersubscribed_matches_slot():
    """Fewer blocks than the slots would take: growth backpressure
    (preemption, resumption) leaves every stream token-exact."""
    _, tcfg, _, tp = _params()
    reqs, arr = synthetic_trace(tcfg.vocab, 8, 24, 10, 4, seed=1)
    out_s = _run(ServeEngine(tcfg, tp, EngineConfig(
        max_slots=4, max_len=64, decode_chunk=4)), reqs, arr)
    paged = PagedServeEngine(tcfg, tp, PagedConfig(
        max_slots=4, max_len=64, decode_chunk=4, block_len=16,
        n_blocks=7))
    out_p = _run(paged, reqs, arr)
    assert _tokens(out_p) == _tokens(out_s)
    assert paged.stats["preemptions"] >= 1
    assert _ledger_matches_device(paged)


def test_paged_int8_margin_parity():
    """Paged + int8 (codes in the block layout, dirty-block requant)
    matches the slot int8 engine on every margin-decided greedy request
    of a briefly trained checkpoint."""
    cfg = t_get_smoke_config(ARCH)
    params, ds = trained_params(cfg, steps=30, device="cpu")
    reqs = [Request(i, ds.batch_slice(100 + i, 0, 1)[0, :12].astype(
        np.int32), max_new_tokens=8) for i in range(6)]
    arr = list(np.arange(6) // 2)
    out_s = _run(ServeEngine(cfg, params, EngineConfig(
        max_slots=2, max_len=48, decode_chunk=3, buckets=(16,),
        quant="int8")), reqs, arr)
    out_p = _run(PagedServeEngine(cfg, params, PagedConfig(
        max_slots=2, max_len=48, decode_chunk=3, buckets=(16,),
        quant="int8", block_len=16, n_blocks=6)), reqs, arr)
    decided = 0
    for r in reqs:
        a, b = out_s[r.rid].tokens, out_p[r.rid].tokens
        if greedy_margin(cfg, params, r.prompt, a) >= MARGIN_FLOOR:
            decided += 1
            assert a == b, f"rid {r.rid}: decided request diverged"
    assert decided >= 2


def test_block_free_reuse_and_pos_reset():
    _, tcfg, _, tp = _params()
    reqs, arr = synthetic_trace(tcfg.vocab, 6, 20, 8, 2, seed=2)
    eng = PagedServeEngine(tcfg, tp, PagedConfig(
        max_slots=2, max_len=64, decode_chunk=4, block_len=16))
    _run(eng, reqs, arr)
    led = eng._ledger
    assert led.top == led.n_blocks
    assert np.all(led.refcount == 0)
    assert np.all(led.table == led.n_blocks)
    assert _ledger_matches_device(eng)
    assert (eng._pool["layers/pos"] == UNWRITTEN_POS).all()
    assert sorted(eng._pool["free"].tolist()) == list(range(led.n_blocks))


def test_ledger_mirrors_device_mid_flight():
    _, tcfg, _, tp = _params()
    eng = PagedServeEngine(tcfg, tp, PagedConfig(
        max_slots=2, max_len=64, decode_chunk=4, block_len=16))
    for i in range(4):
        eng.submit(Request(i, _prompt(tcfg.vocab, 20, seed=i),
                           max_new_tokens=9))
    with torch.no_grad():
        for _ in range(3):
            eng.step()
            assert _ledger_matches_device(eng)
    assert eng._ledger.top < eng._ledger.n_blocks


def _prefix_trace(vocab, n, sys_len, sfx_len, gen, seed=7):
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, sys_len).astype(np.int32)
    reqs = [Request(i, np.concatenate(
        [sys_p, rng.integers(0, vocab, sfx_len).astype(np.int32)]),
        max_new_tokens=gen) for i in range(n)]
    return reqs, [i // 2 for i in range(n)]


def test_prefix_cache_hits_skip_prefill_and_match():
    """Requests sharing a 32-token system prompt map its blocks by
    reference and prefill only their suffix: fewer prefill tokens, the
    slot engine's tokens, and only the store's blocks held after."""
    _, tcfg, _, tp = _params()
    reqs, arr = _prefix_trace(tcfg.vocab, 6, 32, 6, 6)
    base = ServeEngine(tcfg, tp, EngineConfig(
        max_slots=2, max_len=64, decode_chunk=4))
    out_b = _run(base, reqs, arr)
    eng = PagedServeEngine(tcfg, tp, PagedConfig(
        max_slots=2, max_len=64, decode_chunk=4, block_len=16,
        prefix_cache=True))
    out_p = _run(eng, reqs, arr)
    assert _tokens(out_p) == _tokens(out_b)
    assert eng.stats["prefix_hits"] == 5
    assert eng.stats["prefix_hit_tokens"] == 5 * 32
    assert base.stats["prefill_tokens"] >= 2 * eng.stats["prefill_tokens"]
    led = eng._ledger
    assert len(eng._store) == 2
    assert led.top == led.n_blocks - 2
    assert int(eng._pool["free_top"]) == led.top


def test_prefix_store_register_only_full_blocks():
    _, tcfg, _, tp = _params()
    prompt = np.random.default_rng(3).integers(
        0, tcfg.vocab, 21).astype(np.int32)
    eng = PagedServeEngine(tcfg, tp, PagedConfig(
        max_slots=2, max_len=64, decode_chunk=4, block_len=16,
        prefix_cache=True))
    _run(eng, [Request(0, prompt, max_new_tokens=4)])
    assert len(eng._store) == 1


def test_admission_blocks_until_blocks_free():
    """A free slot alone does not admit: a 2-block request waits behind a
    3-block resident on a 4-block pool, then runs to completion."""
    _, tcfg, _, tp = _params()
    eng = PagedServeEngine(tcfg, tp, PagedConfig(
        max_slots=2, max_len=64, decode_chunk=4, block_len=16, n_blocks=4))
    eng.submit(Request(0, _prompt(tcfg.vocab, 40, seed=1),
                       max_new_tokens=16))
    out = {}
    with torch.no_grad():
        eng.step()
        assert eng.n_active == 1 and eng.free_blocks == 1
        eng.submit(Request(1, _prompt(tcfg.vocab, 20, seed=2),
                           max_new_tokens=4))
        eng.step()
        assert eng.scheduler.n_queued == 1
        assert eng.n_active <= 1
        for _ in range(30):
            for fin in eng.step():
                out[fin.rid] = fin
            if len(out) == 2:
                break
    assert sorted(out) == [0, 1]
    assert len(out[1].tokens) == 4
    assert _ledger_matches_device(eng)


def test_store_eviction_yields_blocks_for_admission():
    """Three distinct 38-token prompts through one slot of a 5-block
    pool: the third admission evicts the oldest prefix entries."""
    _, tcfg, _, tp = _params()
    rng = np.random.default_rng(11)
    reqs = [Request(i, rng.integers(0, tcfg.vocab, 38).astype(np.int32),
                    max_new_tokens=5) for i in range(3)]
    eng = PagedServeEngine(tcfg, tp, PagedConfig(
        max_slots=1, max_len=64, decode_chunk=4, block_len=16,
        n_blocks=5, prefix_cache=True))
    out = _run(eng, reqs, [0, 1, 2])
    assert sorted(out) == [0, 1, 2]
    assert all(len(out[i].tokens) == 5 for i in range(3))
    assert eng.stats["evictions"] >= 1
    assert _ledger_matches_device(eng)


# ---------------------------------------------------------------------------
# engines against the reference's
# ---------------------------------------------------------------------------

def _check_engine_pools(tpool, jpool, quant):
    """Positions and bookkeeping bitwise; k/v (bf16 storage of fp32
    values) within 1e-2 of the leaf's largest entry, or int8 codes and
    scales likewise."""
    jflat = _flat(jpool)
    if "cache" in jpool:
        jflat = {k.split("/", 1)[1] if k.startswith("cache/") else k: v
                 for k, v in jflat.items()}
    assert sorted(jflat) == sorted(tpool)
    for key, w in jflat.items():
        g = tpool[key].to(torch.float32).numpy()
        w = np.asarray(w, np.float32)
        base = key.rsplit("/", 1)[-1]
        if base in ("k", "v", "k_scale", "v_scale"):
            d = np.abs(g - w)
            assert d.max() <= 1e-2 * np.abs(w).max(), key
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("variant", [
    {}, {"n_blocks": 7}, {"prefix_cache": True}])
def test_paged_engine_matches_reference_engine(variant, quant):
    """The port's PagedServeEngine and the reference's on the same
    weights and trace, fp32 greedy: the same tokens, the same stats
    (preemptions, prefix hits, evictions, prefill tokens), the pools as
    :func:`_check_engine_pools` holds them. The full pool, an
    undersubscribed one (preemptions) and the prefix cache (on a trace
    with a shared 32-token head)."""
    jcfg, tcfg, params, tp = _params(dtype="float32")
    if variant.get("prefix_cache"):
        reqs, arr = _prefix_trace(tcfg.vocab, 6, 32, 6, 6)
    else:
        reqs, arr = synthetic_trace(tcfg.vocab, 8, 24, 10, 4, seed=1)
    ecfg = dict(max_slots=4, max_len=64, decode_chunk=4, block_len=16,
                quant=quant, **variant)
    want_eng = jpaged.PagedServeEngine(jcfg, params,
                                       jpaged.PagedConfig(**ecfg))
    want = want_eng.run(_jreqs(reqs), arr)
    eng = PagedServeEngine(tcfg, tp, PagedConfig(**ecfg))
    got = _run(eng, reqs, arr)
    assert _tokens(got) == _tokens(want)
    for key in ("preemptions", "prefix_hits", "prefix_hit_tokens",
                "evictions", "prefill_tokens", "decode_chunks"):
        assert eng.stats[key] == want_eng.stats[key], key
    if variant.get("n_blocks"):
        assert eng.stats["preemptions"] >= 1
    if variant.get("prefix_cache"):
        assert eng.stats["prefix_hits"] == 5
    _check_engine_pools(eng._pool, want_eng._pool, quant == "int8")


def test_int8_slot_engine_matches_reference_engine():
    """The int8 slot engine against the reference's on the same weights
    (fp32 greedy): tokens equal, resident bytes equal, the pools as
    :func:`_check_engine_pools` holds them."""
    jcfg, tcfg, params, tp = _params(dtype="float32")
    reqs, arr = synthetic_trace(jcfg.vocab, 5, 20, 6, 2, seed=1)
    ecfg = dict(max_slots=2, max_len=32, decode_chunk=3, quant="int8")
    want_eng = jengine.ServeEngine(jcfg, params, jengine.EngineConfig(**ecfg))
    want = want_eng.run(_jreqs(reqs), arrivals=arr)
    eng = ServeEngine(tcfg, tp, EngineConfig(**ecfg))
    got = _run(eng, reqs, arr)
    assert _tokens(got) == _tokens(want)
    assert eng.resident_bytes() == want_eng.resident_bytes()
    _check_engine_pools(eng._pool, want_eng._pool, True)


def test_engine_int8_quantized_residency():
    """quant='int8' keeps int8 resident state: QTensor weight leaves and
    int8 KV codes with fp32 scale siblings; it serves a trace; an
    unknown mode raises."""
    _, tcfg, _, tp = _params()
    eng = ServeEngine(tcfg, tp, EngineConfig(
        max_slots=2, max_len=32, decode_chunk=2, quant="int8"))
    qleaves = [p for p in eng.params.values()
               if isinstance(p, serve_quant.QTensor)]
    assert qleaves and all(p.q.dtype == torch.int8 for p in qleaves)
    kv = [k for k in eng._pool if k.rsplit("/", 1)[-1] in ("k", "v")]
    assert kv
    for k in kv:
        assert eng._pool[k].dtype == torch.int8
        assert eng._pool[k + "_scale"].dtype == torch.float32
    out = _run(eng, [Request(0, _prompt(tcfg.vocab, 9, seed=3),
                             max_new_tokens=4)])
    assert len(out[0].tokens) == 4
    with pytest.raises(ValueError):
        ServeEngine(tcfg, tp, EngineConfig(quant="int4"))


def test_engine_int8_greedy_parity_and_memory():
    """The serving parity harness at its smoke config: every
    margin-decided request matches the fp32 engine, at least two are
    decided, and the resident memory drops (weights over 2x, the pool
    over 1.3x)."""
    r = serve_greedy_parity(train_steps=30, device="cpu")
    assert r["decided_total"] >= 2, r
    assert r["decided_matched"] == r["decided_total"], r
    assert r["matched"] >= r["total"] - 2, r
    assert r["param_reduction"] > 2.0, r
    assert r["pool_reduction"] > 1.3, r


def test_trained_params_match_reference():
    """``trained_params`` from the reference's initial weights against
    the reference's own, in fp32: 30 steps of SGD on the same synthetic
    batches land within 1e-4 of its weights (max abs, relative to each
    leaf's largest entry; measured ~1.5e-5). (In bf16 the two
    frameworks' roundings part at the first step, 4e-4 on the
    embedding, and lr 0.3 grows the gap to 30% in 30 steps.)"""
    from repro.lowp import serve_parity as jsp

    jcfg, tcfg, params, tp = _params(dtype="float32")
    want, _ = jsp.trained_params(jcfg, steps=30)
    got, ds = trained_params(tcfg, steps=30, device="cpu", params=tp)
    assert ds.batch_slice(3, 0, 2).shape == (2, 32)
    for key, w in _flat(jax.device_get(want)).items():
        g = got[key].numpy()
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), key


def test_all_at_once_admission_serves_every_request_where_reference_drops():
    """Eight requests offered at once to eight slots on a 5-block pool
    (two blocks each): the port admits one at a time against the
    ledger's free count and serves all eight. The reference's
    ``Scheduler.admit`` pops every pair the slots allow against the same
    free count; the third cannot be placed, goes back, and the five
    popped after it are lost (it returns three requests)."""
    jcfg, tcfg, params, tp = _params()
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, tcfg.vocab, 20).astype(np.int32),
                    max_new_tokens=8) for i in range(8)]
    ecfg = dict(max_slots=8, max_len=64, decode_chunk=4, block_len=16,
                n_blocks=5)
    eng = PagedServeEngine(tcfg, tp, PagedConfig(**ecfg))
    out = _run(eng, reqs)
    assert sorted(out) == list(range(8))
    assert all(len(f.tokens) == 8 for f in out.values())
    assert _ledger_matches_device(eng)
    want = jpaged.PagedServeEngine(jcfg, params, jpaged.PagedConfig(**ecfg))
    assert sorted(want.run(_jreqs(reqs))) == [0, 1, 2]


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_paged_captured_chunk_bitwise_op_by_op(quant, prefix_cache,
                                               monkeypatch):
    """The paged engine's greedy chunk (table growth, the paged step, the
    dirty-block requant) runs as one captured program: over a trace
    that shares a prefix and frees and maps blocks between chunks, its
    tokens, pool and block tables are bitwise the chunk's op by op."""
    from repro_torch.serve import engine as tengine

    _, tcfg, _, tp = _params()
    ecfg = PagedConfig(max_slots=3, max_len=48, decode_chunk=4,
                       block_len=8, quant=quant, prefix_cache=prefix_cache)
    rng = np.random.default_rng(5)
    head = rng.integers(0, tcfg.vocab, size=16).astype(np.int32)
    reqs = [Request(i, np.concatenate([head, rng.integers(
        0, tcfg.vocab, size=4 + i).astype(np.int32)]),
        max_new_tokens=6 + i % 5) for i in range(8)]

    def drive():
        eng = PagedServeEngine(tcfg, tp, ecfg)
        with torch.no_grad():
            done = eng.run(reqs, arrivals=[i // 2 for i in range(8)])
        return ({rid: f.tokens for rid, f in done.items()},
                {k: v.clone() for k, v in eng._pool.items()}, eng)

    toks, pool, eng = drive()
    assert eng._program != eng._chunk_program
    monkeypatch.setattr(tengine, "_capture", lambda fn, state, n: fn)
    want_toks, want_pool, eng = drive()
    assert eng._program == eng._chunk_program
    assert (eng.stats["prefix_hits"] > 0) == prefix_cache
    assert toks == want_toks
    assert all(len(t) == r.max_new_tokens
               for t, r in zip((toks[r.rid] for r in reqs), reqs))
    assert sorted(pool) == sorted(want_pool)
    for k, v in want_pool.items():
        assert torch.equal(pool[k], v), k
