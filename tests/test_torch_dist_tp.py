"""Tensor parallelism (``--model-parallel``): ``dist.sharding``'s slicing
rule against the reference's, the megatron seams of ``dist.api`` on gloo
ranks, and the sliced model's loss and gradients against the JAX
reference's one-device ``loss_fn`` and the port's one rank.

Ranks are spawned once per world size (``tests/_torch_dist_ranks``):
world 2 runs the seams and the dense, vlm and hybrid smoke configs at
``(data 1, model 2)``, world 4 the dense one at ``(data 2, model 2)``.

At K-FAC block 32 the smoke configs take every case of the rule: dense
smoke (qwen1.5-0.5b: 4 heads, 4 kv heads, d_ff 128) slices attention and
MLP; vlm smoke (qwen2-vl-7b) slices only its MLP, since its k/v are
2 x 16 = 32 wide, 16 a rank, under one block; hybrid smoke
(recurrentgemma-9b) slices nothing: 1 kv head, and a local d_ff of 48
is not whole blocks of 32.

Tolerances and why:
  * the rule, the seams' values and traffic: equal (host arithmetic,
    and sums of small integers in fp32);
  * loss and every gathered gradient against the reference on the
    same (converted) weights: each family's fp32 tolerances (loss rtol
    1e-5 with atol 1e-5, gradients rtol 1e-5 with atol 1e-6, the
    hybrid's atol 5e-6 as in ``tests/test_torch_hybrid.py``);
  * against the port's one rank: loss rtol 1e-5, each gradient within
    1e-5 of its leaf's largest entry. The slices change only the fp32
    summation order of the row-parallel outputs (two partial sums
    added) and of the input cotangents.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks_mod
from _torch_families import cfgs, vlm_extras
from repro.configs import ARCHS, get_config, get_smoke_config
from repro.models import lm as jlm
from repro.pipeline.schedule import _model_spec_dim
from repro_torch import convert
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.dist import sharding
from repro_torch.dist.spawn import run_ranks
from repro_torch.launch import steps as tsteps

#: (arch, vlm extras, gradient atol against the reference): the
#: families whose layers run the sliced blocks, at their own files' fp32
#: tolerances (tests/test_torch_model.py, test_torch_vlm.py,
#: test_torch_hybrid.py)
FAMILIES = [("qwen1.5-0.5b", False, 1e-6), ("qwen2-vl-7b", True, 1e-6),
            ("recurrentgemma-9b", False, 5e-6)]
SEQ = 80

#: where the block gate refuses a slice the reference's rule makes, at
#: the CLI's block (min(128, soi_block)): (arch, size, mp) -> {group:
#: why}. A rank's share of that width is not whole blocks of the full
#: width's block size, so a factor block would straddle two ranks
GATED = {
    ("moonshot-v1-16b-a3b", "smoke", 4): {
        "attn": "q 64: 16 a rank, blocks of 32"},
    ("phi3.5-moe-42b-a6.6b", "smoke", 2): {
        "attn": "kv 32: 16 a rank, blocks of 32"},
    ("recurrentgemma-9b", "smoke", 2): {
        "mlp": "ff 96: 48 a rank, blocks of 32"},
    ("recurrentgemma-9b", "smoke", 4): {
        "mlp": "ff 96: 24 a rank, blocks of 32"},
    ("qwen2.5-32b", "smoke", 2): {"attn": "kv 32: 16 a rank, blocks of 32"},
    ("llama3.2-1b", "smoke", 2): {"attn": "kv 32: 16 a rank, blocks of 32"},
    ("qwen1.5-0.5b", "smoke", 4): {"attn": "q 64: 16 a rank, blocks of 32"},
    ("qwen1.5-0.5b", "full", 4): {
        "mlp": "ff 2816: 704 a rank, blocks of 128"},
    ("qwen2-0.5b", "smoke", 2): {"attn": "q 56: 28 a rank, blocks of 32"},
    ("qwen2-0.5b", "full", 2): {
        "attn": "q 896: 448 a rank, blocks of 128"},
    ("qwen2-0.5b", "full", 4): {
        "mlp": "ff 4864: 1216 a rank, blocks of 128"},
    ("qwen2-vl-7b", "smoke", 2): {"attn": "kv 32: 16 a rank, blocks of 32"},
}


def _group(path):
    return "attn" if "/attn/" in path else "mlp"


def _widths(cfg):
    return {"q": cfg.n_heads * cfg.hd, "kv": cfg.n_kv_heads * cfg.hd,
            "ff": cfg.d_ff}


def _gate_reason(cfg, path, mp, bs):
    """Why the block gate refuses ``path`` where the reference slices it:
    the first width whose share is not whole blocks."""
    from repro_torch.core import soi

    kinds = ("q", "kv") if "attn" in path.split("/") else ("ff",)
    for kind in kinds:
        w = _widths(cfg)[kind]
        blk = soi.block_size_for(w, bs)
        if (w // mp) % blk:
            return f"{kind} {w}: {w // mp} a rank, blocks of {blk}"
    return None


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_spec_dim_is_the_references_with_a_block_gate(arch, size, mp):
    """Every leaf: the reference's dim, except where a rank's share would
    not be whole K-FAC blocks of the full leaf's block size (listed with
    the reason); a gated family slices all its attention leaves or
    none."""
    jcfg = (get_smoke_config if size == "smoke" else get_config)(arch)
    tcfg = (t_get_smoke_config if size == "smoke" else t_get_config)(arch)
    bs = min(128, tcfg.soi_block)
    shapes = tsteps.init_params(tcfg, generator=None, device="meta")
    gated = {}
    for path, v in shapes.items():
        want = _model_spec_dim(jcfg, path, v.ndim, mp)
        got = sharding.model_spec_dim(tcfg, path, v.ndim, mp, bs)
        if got != want:
            assert got is None, path
            reason = _gate_reason(tcfg, path, mp, bs)
            assert reason is not None, path
            gated[path] = reason
    want_gated = GATED.get((arch, size, mp), {})
    assert {_group(p) for p in gated} == set(want_gated)
    assert all(r == want_gated[_group(p)] for p, r in gated.items())
    # q/k/v/wo (and the MLP's three) slice together or not at all
    for group in ("attn", "mlp"):
        dims = {p.rsplit("/", 1)[-1]: sharding.model_spec_dim(
            tcfg, p, v.ndim, mp, bs) for p, v in shapes.items()
            if f"/{group}/" in p and p.rsplit("/", 1)[-1] in
            ("wq", "wk", "wv", "wo", "wg", "wu", "wd")}
        assert len({d is None for d in dims.values()}) <= 1, dims


def _case(arch, extras):
    """The port's seed-0 fp32 smoke weights (a flat numpy dict) and a
    batch of 2 x SEQ tokens (the vlm's with image rows and M-RoPE
    positions)."""
    _, tcfg = cfgs(arch, "float32")
    params = tsteps.init_params(
        tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    b = {"tokens": SyntheticTokens(tcfg.vocab, SEQ, 2, seed=1).batch_slice(
        0, 0, 2)}
    if extras:
        b.update(vlm_extras(tcfg, 2, SEQ, 1))
    return arch, {k: v.numpy() for k, v in params.items()}, b


def _reference(arch, params, b):
    """The reference's one-device loss and gradients (jitted) on the
    converted weights."""
    jcfg, _ = cfgs(arch, "float32")
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, jb), has_aux=True))
    (loss, _), grads = fn(convert.params_to_jax(
        {k: torch.from_numpy(v) for k, v in params.items()}))
    return float(loss), convert._flatten(jax.device_get(grads))


def _one_rank(arch, params, b):
    _, tcfg = cfgs(arch, "float32")
    loss, grads = tsteps._grads(tcfg, {k: torch.from_numpy(v)
                                       for k, v in params.items()},
                                {k: torch.from_numpy(np.asarray(v))
                                 for k, v in b.items()})
    return float(loss), {k: v.numpy() for k, v in grads.items()}


@pytest.fixture(scope="module")
def world2():
    """World 2, mesh (1, 2): the seams, then every family's case."""
    cases = [_case(a, x) for a, x, _ in FAMILIES]
    return cases, run_ranks(ranks_mod.tp_world2_rank, 2, args=(cases,),
                            timeout=300)


@pytest.fixture(scope="module")
def world4():
    """World 4, mesh (2, 2): the dense case."""
    cases = [_case(*FAMILIES[0][:2])]
    res = run_ranks(ranks_mod.tp_model_rank, 4, args=((2, 2), cases),
                    timeout=300)
    return cases, [{"models": r} for r in res]


def test_seams_forward_and_backward(world2):
    _, res = world2
    for r in res:
        assert r["seams"] == dict.fromkeys(r["seams"], True), r["seams"]
    assert len(res[0]["seams"]) == 10


#: the leaves each family's smoke config slices at block 32 (module doc)
SLICED = {
    "qwen1.5-0.5b": {"layers/attn/wq": 2, "layers/attn/wk": 2,
                     "layers/attn/wv": 2, "layers/attn/wo": 1,
                     "layers/attn/bq": 1, "layers/attn/bk": 1,
                     "layers/attn/bv": 1, "layers/mlp/wg": 2,
                     "layers/mlp/wu": 2, "layers/mlp/wd": 1},
    "qwen2-vl-7b": {"layers/mlp/wg": 2, "layers/mlp/wu": 2,
                    "layers/mlp/wd": 1},
    "recurrentgemma-9b": {},
}


@pytest.mark.parametrize("mesh,index", [("1x2", 0), ("1x2", 1),
                                        ("1x2", 2), ("2x2", 0)])
def test_sliced_model_matches_reference_and_one_rank(request, mesh, index):
    """Loss and every gradient, gathered over the model ranks (and
    reduced over the data ranks at (2, 2)), against the reference's
    one-device pass on the same weights and the port's one rank; the
    loss the same on every rank; each sliced leaf a slice on its rank."""
    cases, res = request.getfixturevalue(
        "world2" if mesh == "1x2" else "world4")
    arch, params, b = cases[index]
    got = [r["models"][index] for r in res]
    assert all(g["loss"] == got[0]["loss"] for g in got)
    assert all(g["sliced_only"] for g in got)
    assert got[0]["dims"] == SLICED[arch]
    jl, jg = _reference(arch, params, b)
    tl, tg = _one_rank(arch, params, b)
    loss, grads = got[0]["loss"], got[0]["grads"]
    np.testing.assert_allclose(loss, jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss, tl, rtol=1e-5)
    assert sorted(grads) == sorted(jg)
    atol = FAMILIES[index][2]
    for k, v in grads.items():
        np.testing.assert_allclose(v, jg[k], rtol=1e-5, atol=atol,
                                   err_msg=k)
        assert np.max(np.abs(v - tg[k])) <= 1e-5 * np.max(np.abs(tg[k])), k
