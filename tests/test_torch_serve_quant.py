"""repro_torch.lowp.serve_quant against repro.lowp.serve_quant, at smoke
size on the CPU: the int8 codes and fp32 scales of weights and KV caches,
the round trips, the dirty-masked requantization and the byte counts.
Tests with a counterpart in ``tests/test_lowp.py`` (``TestServeQuant``)
carry its name.

Tolerances: codes and scales bitwise to the reference's on the same
inputs (both divide and round in IEEE fp32, half to even); a dequantized
tensor bitwise the reference's; the dequantization error within half a
quantization step (the reference's own bound).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import one_thread  # noqa: F401 (autouse)
from repro.configs import get_smoke_config
from repro.dist.api import path_key
from repro.launch import steps as jsteps
from repro.lowp import serve_quant as jsq
from repro_torch import convert
from repro_torch.lowp import serve_quant as tsq
from repro_torch.lowp.serve_quant import QTensor


def _np(x):
    return np.asarray(x.numpy() if torch.is_tensor(x) else x)


def _kv_pool(seed):
    """A slot pool's KV leaves in both layouts: bf16 k/v (2, 3, 4, 8, 5),
    int32 positions, per-slot idx."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((2, 3, 4, 8, 5)).astype(np.float32)
    v = rng.standard_normal((2, 3, 4, 8, 5)).astype(np.float32)
    jpool = {"layers": {"k": jnp.asarray(k, jnp.bfloat16),
                        "v": jnp.asarray(v, jnp.bfloat16),
                        "pos": jnp.zeros((3, 8), jnp.int32)},
             "idx": jnp.zeros((3,), jnp.int32)}
    tpool = {"layers/k": torch.from_numpy(k).to(torch.bfloat16),
             "layers/v": torch.from_numpy(v).to(torch.bfloat16),
             "layers/pos": torch.zeros((3, 8), dtype=torch.int32),
             "idx": torch.zeros((3,), dtype=torch.int32)}
    return jpool, tpool


def _check_kv(tpool, jpool):
    flat = {path_key(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jpool)[0]}
    assert sorted(flat) == sorted(tpool)
    for key, want in flat.items():
        got = tpool[key]
        assert str(got.dtype).split(".")[-1] == str(want.dtype), key
        np.testing.assert_array_equal(
            _np(got.to(torch.float32)), np.asarray(want, np.float32),
            err_msg=key)


# ---------------------------------------------------------------------------
# TestServeQuant counterparts
# ---------------------------------------------------------------------------

def test_qtensor_roundtrip_codes():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    qt = tsq._encode(torch.from_numpy(w), axis=-2)
    assert qt.q.dtype == torch.int8
    want = jsq._encode(jnp.asarray(w), axis=-2)
    np.testing.assert_array_equal(_np(qt.q), np.asarray(want.q))
    np.testing.assert_array_equal(_np(qt.scale), np.asarray(want.scale))
    w2 = qt.q.to(torch.float32) * qt.scale
    qt2 = tsq._encode(w2, axis=-2)
    np.testing.assert_array_equal(_np(qt.q), _np(qt2.q))
    step = _np(qt.scale)
    assert np.all(np.abs(_np(w2) - w) <= step / 2 + 1e-7)


def test_quantize_params_skips_embed_and_vectors():
    params = {"embed": torch.ones((8, 4)), "layers/wq": torch.ones((4, 4)),
              "layers/ln1": torch.ones((4,))}
    q = tsq.quantize_params(params)
    assert not isinstance(q["embed"], QTensor)
    assert not isinstance(q["layers/ln1"], QTensor)
    assert isinstance(q["layers/wq"], QTensor)
    d = tsq.dequantize_params(q)
    np.testing.assert_allclose(_np(d["layers/wq"]), np.ones((4, 4)),
                               atol=1e-6)


def test_zero_leaf_safe():
    q = tsq.quantize_params({"w": torch.zeros((4, 4))})
    np.testing.assert_array_equal(_np(q["w"].scale),
                                  np.full((1, 4), np.float32(1.0) / 127))
    d = tsq.dequantize_params(q)
    np.testing.assert_array_equal(_np(d["w"]), np.zeros((4, 4)))


def test_kv_roundtrip_and_code_stability():
    jpool, tpool = _kv_pool(6)
    q = tsq.quantize_kv(tpool)
    assert q["layers/k"].dtype == torch.int8
    assert q["layers/k_scale"].shape == (2, 3, 4, 8)
    assert q["layers/pos"].dtype == torch.int32
    _check_kv(q, jsq.quantize_kv(jpool))
    f = tsq.dequantize_kv(q)
    assert "layers/k_scale" not in f
    _check_kv(f, jsq.dequantize_kv(jsq.quantize_kv(jpool)))
    q2 = tsq.requantize_kv(f, like=q)
    for leaf in ("layers/k", "layers/v", "layers/k_scale", "layers/v_scale"):
        assert torch.equal(q2[leaf], q[leaf]), leaf
    assert q2["layers/pos"].dtype == torch.int32
    same = tsq.dequantize_kv(tpool)
    assert same["layers/k"] is tpool["layers/k"]


def test_requantize_dirty_mask_pins_clean_entries():
    """Entries of axis 1 outside ``dirty`` keep their codes and scales
    bitwise from the resident pool though every float entry moved;
    dirty entries are a fresh encode; both as the reference's."""
    jpool, tpool = _kv_pool(7)
    q = tsq.quantize_kv(tpool)
    bump = dict(tpool, **{"layers/k": tpool["layers/k"] * 1.5,
                          "layers/v": tpool["layers/v"] * 1.5})
    dirty = torch.tensor([False, True, False])
    q2 = tsq.requantize_kv(bump, like=q, dirty=dirty)
    q_full = tsq.quantize_kv(bump)
    jq = jsq.quantize_kv(jpool)
    jbump = {"layers": dict(
        jpool["layers"], k=jpool["layers"]["k"] * jnp.bfloat16(1.5),
        v=jpool["layers"]["v"] * jnp.bfloat16(1.5)), "idx": jpool["idx"]}
    _check_kv(q2, jsq.requantize_kv(jbump, like=jq,
                                    dirty=jnp.asarray([False, True, False])))
    for leaf in ("layers/k", "layers/v", "layers/k_scale", "layers/v_scale"):
        new = q2[leaf]
        assert torch.equal(new[:, [0, 2]], q[leaf][:, [0, 2]]), leaf
        assert torch.equal(new[:, 1], q_full[leaf][:, 1]), leaf


def test_tree_bytes():
    t = {"a": torch.zeros((4, 4), dtype=torch.float32),
         "b": QTensor(torch.zeros((4, 4), dtype=torch.int8),
                      torch.zeros((1, 4), dtype=torch.float32))}
    assert tsq.tree_bytes(t) == 64 + 16 + 16


# ---------------------------------------------------------------------------
# on a model's weights and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "moonshot-v1-16b-a3b"])
def test_quantize_params_matches_reference(arch):
    """Every leaf of a smoke model: the same leaves quantized (the
    embedding and vectors kept), codes and scales bitwise, the
    dequantized weights bitwise, the byte count equal."""
    cfg = get_smoke_config(arch)
    params = jax.device_get(jsteps.model_module(cfg).init(
        cfg, jax.random.PRNGKey(0)))
    tp = convert.params_from_jax(params, device="cpu")
    got = tsq.quantize_params(tp)
    want = jsq.quantize_params(params)
    flat = {path_key(p): v for p, v in jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jsq.QTensor))[0]}
    assert sorted(flat) == sorted(got)
    n_q = 0
    for key, w in flat.items():
        g = got[key]
        assert isinstance(g, QTensor) == isinstance(w, jsq.QTensor), key
        if isinstance(g, QTensor):
            n_q += 1
            np.testing.assert_array_equal(_np(g.q), np.asarray(w.q), key)
            np.testing.assert_array_equal(_np(g.scale), np.asarray(w.scale),
                                          key)
        else:
            assert g is tp[key], key
    assert n_q and not isinstance(got["embed"], QTensor)
    deq = tsq.dequantize_params(got)
    want_deq = convert.params_from_jax(
        jax.device_get(jsq.dequantize_params(want)), device="cpu")
    for key, w in want_deq.items():
        assert torch.equal(deq[key], w), key
    assert tsq.tree_bytes(got) == jsq.tree_bytes(want)


def test_quantize_kv_matches_reference_on_a_prefilled_cache():
    """A prefilled smoke cache (bf16 k/v): codes and scales bitwise to
    the reference's, positions untouched."""
    from repro_torch.launch import steps as tsteps
    from repro_torch.configs import get_smoke_config as t_get_smoke_config

    jcfg = get_smoke_config("qwen2-0.5b")
    tcfg = t_get_smoke_config("qwen2-0.5b")
    jm = jsteps.model_module(jcfg)
    params = jax.device_get(jm.init(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab, (2, 11)).astype(np.int32)
    _, jcache = jm.prefill(jcfg, params, {"tokens": jnp.asarray(toks)},
                           jm.init_cache(jcfg, 2, 16))
    tm = tsteps.model_module(tcfg)
    with torch.no_grad():
        _, tcache = tm.prefill(
            tcfg, convert.params_from_jax(params, device="cpu"),
            {"tokens": torch.from_numpy(toks)},
            tm.init_cache(tcfg, 2, 16, device="cpu"))
    # the same cache values in: the reference's own, carried across
    tin = {k: v for k, v in tcache.items() if k != "idx"}
    flat = {path_key(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jcache["layers"])[0]}
    for key, v in flat.items():
        tin[f"layers/{key}"] = torch.from_numpy(
            np.asarray(v, np.float32)).to(tin[f"layers/{key}"].dtype)
    got = tsq.quantize_kv(tin)
    want = jsq.quantize_kv({"layers": jcache["layers"]})
    _check_kv(got, want)
    assert tsq.tree_bytes(got) == jsq.tree_bytes(want)
