"""repro_torch.dist (api, sharding, compression), data.make_global_batch
and launch.mesh against the JAX reference.

The spec functions run here on ``{axis: size}`` meshes and, on spawned
gloo ranks, on real DeviceMeshes (one module fixture, world 4, meshes
(4,) and (2, 2); ``tests/_torch_dist_ranks.rules_rank``); the reference
runs on ``AbstractMesh``es of the same shapes.

Tolerances and why:
  * specs, mesh helpers, plans of rows: equal (host arithmetic on names
    and shapes);
  * the int8 codec and the one-rank compressed round trip: bitwise
    (``round`` is round-half-to-even in both, the scale's division is
    one fp32 operation);
  * the compressed mean across ranks: every element within ``s / 127``
    of the exact mean (``s`` the shared scale), the bound of the
    reference's property tests, and the same on every rank; over 8
    steps of error feedback on fixed gradients the summed means within
    one quantization step of the summed true means
    (``test_data_dist.py::test_error_feedback_recovers_mean``'s
    invariant).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_dist_ranks as ranks_mod
from repro.configs import ARCHS, get_smoke_config
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.data import SyntheticTokens as JTokens
from repro.dist import api as japi
from repro.dist import compression as jcomp
from repro.dist import sharding as jsh
from repro.launch import steps as jsteps
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.dist import api, compression, sharding
from repro_torch.dist.spawn import run_ranks
from repro_torch.launch import steps as tsteps

MESHES = [{"data": 4}, {"data": 2, "model": 2}]
WORLD = 4
BS = 32


def _amesh(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _spec(named):
    return tuple(named.spec)


@pytest.fixture(scope="module")
def ranks():
    r = np.random.default_rng(7)
    g = r.standard_normal((WORLD, 6, 5)).astype(np.float32) \
        * np.array([1.0, 3.0, 0.5, 2.0], np.float32)[:, None, None]
    return g, run_ranks(ranks_mod.rules_rank, WORLD,
                        args=("qwen2-0.5b", g))


@pytest.mark.parametrize("sizes", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_kfac_specs_match_reference(arch, sizes):
    jcfg, tcfg = get_smoke_config(arch), t_get_smoke_config(arch)
    kcfg = dict(block_size=min(BS, jcfg.soi_block))
    ab = jsteps.abstract_train_state(jcfg, JKFACConfig(**kcfg))
    mesh = _amesh(sizes)
    params = tsteps.init_params(tcfg, generator=None, device="meta")
    want = {japi.path_key(p): _spec(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jsh.param_sharding(ab.params, mesh))[0]}
    assert sharding.param_sharding(params, sizes) == want
    kst = tkfac.init(params, tsteps.kfac_specs(tcfg),
                     tkfac.KFACConfig(**kcfg))
    got = sharding.kfac_sharding(kst, params, sizes)
    jk = jsh.kfac_sharding(ab.kfac, ab.params, mesh)
    assert got.step == _spec(jk.step) == ()
    for field in ("factors", "inverses"):
        want = {n: {k: _spec(v) for k, v in d.items()}
                for n, d in getattr(jk, field).items()}
        assert getattr(got, field) == want, field
    for field in ("momentum", "adam_mu", "adam_nu"):
        want = {japi.path_key(p): _spec(s) for p, s in
                jax.tree_util.tree_flatten_with_path(getattr(jk, field))[0]}
        mine = getattr(got, field)
        # the port keeps each moment on its update path only; the
        # reference's other leaves are zero-size placeholders
        assert mine == {k: want[k] for k in mine}, field
        assert all(want[k] == (None,) for k in set(want) - set(mine))


@pytest.mark.parametrize("sizes", MESHES, ids=str)
def test_batch_pool_and_helpers_match_reference(sizes):
    mesh = _amesh(sizes)
    batch = {"tokens": np.empty((8, 16)), "positions": np.empty((3, 8, 16)),
             "img_embeds": np.empty((8, 4, 32)), "odd": np.empty((3, 2))}
    want = {k: _spec(v) for k, v in jsh.batch_sharding(
        {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
         for k, v in batch.items()}, mesh).items()}
    assert sharding.batch_sharding(batch, sizes) == want
    assert sharding.solve_pool_sharding(sizes) == _spec(
        jsh.solve_pool_sharding(mesh))
    assert api.mesh_axes(sizes) == japi.mesh_axes(mesh)
    assert api.mesh_ndev(sizes) == japi.mesh_ndev(mesh)
    for spec, shape in (((("pod", "data"), "model"), (8, 6)),
                        ((("data", "model"), None), (6, 3)),
                        (("model", "stage"), (4, 4)),
                        ((None, ("data", "model")), (2, 8))):
        assert api.clean_spec(spec, shape, sizes) == tuple(
            japi.clean_spec(spec, shape, mesh))
    for name in ("layers/attn/wq", "layers/attn/wo", "layers/moe/wg",
                 "layers/moe/wd", "embed", "lm_head", "units/rglru/in_x"):
        assert api.factor_axes(name) == japi.factor_axes(name), name
    assert (api.POD, api.STAGE, api.DATA, api.MODEL, api.BATCH_AXES) == (
        japi.POD, japi.STAGE, japi.DATA, japi.MODEL, japi.BATCH_AXES)
    paths = jax.tree_util.tree_flatten_with_path(
        {"a": {"b": [1, {"c": 2}]}})[0]
    assert [api.path_key(p) for p, _ in paths] == \
        [japi.path_key(p) for p, _ in paths] == ["a/b/0", "a/b/1/c"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_bitwise_reference(seed):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((64, 33)) * 10 ** r.uniform(-3, 3)).astype(
        np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 0.0]            # exact halves of a step
    s = np.float32(np.max(np.abs(x)))
    q = compression.quantize_code(torch.from_numpy(x), s)
    jq = np.asarray(jcomp.quantize_code(jnp.asarray(x), s))
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(
        compression.dequantize_code(q, s).numpy(),
        np.asarray(jcomp.dequantize_code(jnp.asarray(jq), s)))
    e = (r.standard_normal(x.shape) * 0.01).astype(np.float32)
    mean, err = compression.compressed_psum(torch.from_numpy(x),
                                            torch.from_numpy(e))
    jmean, jerr = jcomp.compressed_psum(jnp.asarray(x), jnp.asarray(e), ())
    np.testing.assert_array_equal(mean.numpy(), np.asarray(jmean))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    tree = {"w": torch.from_numpy(x)}
    errs = compression.init_error_buffers(tree)
    means, _ = compression.compressed_allreduce_tree(tree, errs, None,
                                                     ("pod",))
    np.testing.assert_array_equal(means["w"].numpy(), np.asarray(
        jcomp.dequantize_code(jcomp.quantize_code(jnp.asarray(x), s), s)))


def test_make_global_batch_rows_match_reference_batch_slice(ranks):
    _, res = ranks
    want = JTokens(1000, 12, 8, seed=3).batch_slice(2, 0, 8)
    for shape, split in (((WORLD,), WORLD), ((2, WORLD // 2), 2)):
        rows = [r[shape]["tokens"] for r in res]
        per = 8 // split
        for rank, got in enumerate(rows):
            shard = rank if split == WORLD else res[rank][shape]["coord"][0]
            np.testing.assert_array_equal(
                got, want[shard * per:(shard + 1) * per])
    # host_slice is the reference's per-host slice
    from repro_torch.data import SyntheticTokens as TTokens
    for rank in range(WORLD):
        np.testing.assert_array_equal(
            TTokens(1000, 12, 8, seed=3).host_slice(2, rank, WORLD),
            want[2 * rank:2 * rank + 2])


def test_mesh_helpers_and_specs_on_device_meshes(ranks):
    _, res = ranks
    params = tsteps.init_params(t_get_smoke_config("qwen2-0.5b"),
                                generator=None, device="meta")
    for shape, sizes in (((WORLD,), {"data": WORLD}),
                         ((2, WORLD // 2), {"data": 2, "model": 2})):
        for rank, r in enumerate(res):
            got = r[shape]
            assert got["axes"] == tuple(sizes) and got["sizes"] == sizes
            assert got["ndev"] == WORLD
            assert got["ranks"] == tuple(range(WORLD))
            assert got["position"] == rank
            assert got["specs"] == sharding.param_sharding(params, sizes)
            assert got["pool"] == sharding.solve_pool_sharding(sizes)
    assert all(r["dev_mesh"] == (("data", "model"), {"data": 2, "model": 2})
               for r in res)
    # the trainer takes the model axis: each rank its position in its
    # model group, a data group of 2 (rank r at mesh (r // 2, r % 2))
    assert [r["model_axis"] for r in res] == [(2, r % 2, 2)
                                              for r in range(WORLD)]
    # moe is taken too: the router replicated, the experts on dim 1 of
    # (L, E, ...)
    assert all(r["moe_axis"] == (2, [1, None]) for r in res)


def test_compressed_mean_across_ranks(ranks):
    g, res = ranks
    exact = g.mean(axis=0)
    for r in res:
        np.testing.assert_array_equal(r["means"], res[0]["means"])
    # step 1: within s / 127 of the exact mean, s the max over ranks
    s = np.max(np.abs(g))
    assert np.max(np.abs(res[0]["means"][0] - exact)) <= s / 127
    # error feedback: 8 steps on fixed gradients, within one step
    total = res[0]["means"].sum(axis=0)
    step = max(np.max(np.abs(g[i] + r["err"])) for i, r in enumerate(res)) \
        / 127
    assert np.max(np.abs(total - 8 * exact)) <= step * (1 + 1e-5)
    # over the data axis of the (2, 2) mesh: ranks {0, 2} and {1, 3}
    for rank, r in enumerate(res):
        pair = g[[rank % 2, rank % 2 + 2]]
        sp = np.max(np.abs(pair))
        assert np.max(np.abs(r["tree_data_axis"] - pair.mean(0))) <= sp / 127
