"""Rank bodies of the port's multi-rank CPU tests, run by
``repro_torch.dist.spawn.run_ranks`` on gloo ranks.

Each function runs on every rank of a fresh process group and returns
plain host objects (numpy arrays, flags) for the test process to hold to
the JAX reference, which runs there on one CPU device. This module
imports neither jax nor the reference, so the spawned ranks do not
either.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

#: the composed inverse's counts of the solver tests (the reference's
#: benchmarks/dist_inverse.py probe's: fewer than K-FAC's 20/4/2, which
#: tests/test_torch_solve.py runs, so that each spawned rank stays short)
KW = dict(ns_iters=8, taylor_terms=3, refine_steps=1)


def spd(r, shape):
    bs = shape[-1]
    a = r.standard_normal(shape[:-1] + (2 * bs,)).astype(np.float32)
    return np.einsum("...ij,...kj->...ik", a, a) / (2 * bs)


def mixed_factors(seed=0, big=False):
    """Mixed block sizes, stack dims and G-only (shared-A) leaves, as
    ``tests/test_torch_solve.py``'s; ``big`` adds leaves of 64 and 128
    for the pdiv cap."""
    r = np.random.default_rng(seed)
    f = {"layers/attn/wq": {"A": spd(r, (3, 2, 32, 32)),
                            "G": spd(r, (3, 1, 48, 48))},
         "layers/mlp/wg": {"A": spd(r, (3, 1, 32, 32)),
                           "G": spd(r, (3, 4, 16, 16))},
         "layers/attn/wk": {"G": spd(r, (3, 1, 48, 48))},
         "embed": {"G": spd(r, (1, 48, 48))}}
    if big:
        f["big"] = {"A": spd(r, (1, 128, 128)), "G": spd(r, (2, 64, 64))}
    return f


def model_factors(specs, bs, seed=0):
    """Random SPD factors of a model's factor shapes (sorted names, A
    before G), as numpy."""
    from repro_torch.core import soi

    r = np.random.default_rng(seed)
    out = {}
    for name in sorted(specs):
        shapes = soi.factor_shapes(specs[name], bs)
        out[name] = {side: spd(r, tuple(shapes[side]))
                     for side in sorted(shapes)}
    return out


def torch_tree(tree):
    return {n: {s: torch.from_numpy(np.ascontiguousarray(v))
                for s, v in d.items()} for n, d in tree.items()}


def numpy_tree(tree):
    return {n: {s: v.detach().cpu().numpy() for s, v in d.items()}
            for n, d in tree.items()}


def bitwise(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(bitwise(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(bitwise, a, b))
    return bool(torch.equal(a, b))


def make_mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    names = ("data",) if len(shape) == 1 else ("data", "model")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


# ---------------------------------------------------------------------------
# tests/test_torch_dist_solve.py
# ---------------------------------------------------------------------------

def solve_rank(rank, world, mesh_shape, arch, bs, grads_np):
    """The solver's mesh paths on one rank, each held bitwise to the
    local path here; rank 0's results come back for the reference."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.kfac import KFACConfig
    from repro_torch.dist.api import mesh_position
    from repro_torch.launch import steps as steps_mod
    from repro_torch.solve import (invert_factor_tree, make_plan,
                                   make_wu_plan, pdiv_invert,
                                   refresh_and_precondition)

    cfg = KFACConfig(**KW)
    mesh = make_mesh(mesh_shape)
    pos = mesh_position(mesh)
    flags, out = {}, {}

    tf = torch_tree(mixed_factors(0))
    plan = make_plan(tf, world, cfg)
    got = invert_factor_tree(tf, cfg, mesh=mesh, plan=plan)
    flags["tree_vs_pooled"] = bitwise(got, invert_factor_tree(tf, cfg,
                                                              plan=plan))
    flags["tree_vs_replicated"] = bitwise(got, invert_factor_tree(tf, cfg))
    flags["tree_order"] = list(got) == list(tf)
    bufs = {n: {k: torch.zeros_like(v) for k, v in d.items()}
            for n, d in got.items()}
    into = invert_factor_tree(tf, cfg, mesh=mesh, plan=plan, out=bufs)
    flags["tree_out"] = bitwise(into, got) and all(
        into[n][k] is bufs[n][k] for n in bufs for k in bufs[n])
    flags["blocks"] = plan.device_blocks[pos] == sum(
        int((g.slots[pos] >= 0).sum()) for g in plan.groups)
    out["tree"] = numpy_tree(got)
    try:
        invert_factor_tree(tf, cfg, mesh=mesh,
                           plan=make_plan(tf, world + 1, cfg))
        flags["wrong_plan_raises"] = False
    except ValueError:
        flags["wrong_plan_raises"] = True

    # the pdiv sub-schedule (cap 48: the 64- and 128-blocks) and
    # pdiv_invert at depths 1 and 2
    tb = torch_tree(mixed_factors(1, big=True))
    pplan = make_plan(tb, world, cfg, pdiv_cap_bs=48)
    got = invert_factor_tree(tb, cfg, mesh=mesh, plan=pplan)
    flags["pdiv_tree"] = bitwise(got, invert_factor_tree(tb, cfg,
                                                         plan=pplan))
    out["pdiv_tree"] = numpy_tree(got)
    r = np.random.default_rng(5)
    blocks = torch.from_numpy(spd(r, (3, 64, 64)))
    lam = 0.03 * torch.diagonal(blocks, dim1=1, dim2=2).mean(-1)
    for depth in (1, 2):
        got = pdiv_invert(blocks, lam, cfg, depth=depth, mesh=mesh)
        flags[f"pdiv_{depth}"] = bool(torch.equal(
            got, pdiv_invert(blocks, lam, cfg, depth=depth)))
        out[f"pdiv_{depth}"] = got.numpy()

    # the fused INV->VMM program on a smoke model's factors, both modes
    specs = steps_mod.kfac_specs(get_smoke_config(arch))
    mf = torch_tree(model_factors(specs, bs, seed=2))
    grads = {k: torch.from_numpy(v) for k, v in grads_np.items()}
    wu = make_wu_plan(specs, mf, cfg, ndev=world)
    inv0, pre0 = refresh_and_precondition(
        mf, grads, cfg, make_wu_plan(specs, mf, cfg))
    for mode in ("gather", "owner"):
        inv, pre = refresh_and_precondition(mf, grads, cfg, wu, mesh=mesh,
                                            mode=mode)
        flags[f"fused_{mode}_inv"] = bitwise(inv, inv0)
        flags[f"fused_{mode}_pre"] = bitwise(pre, pre0)
        out[f"fused_{mode}"] = (numpy_tree(inv),
                                {k: v.numpy() for k, v in pre.items()})
    try:
        refresh_and_precondition(mf, grads, cfg,
                                 make_wu_plan(specs, mf, cfg,
                                              ndev=world + 1), mesh=mesh)
        flags["fused_wrong_plan_raises"] = False
    except ValueError:
        flags["fused_wrong_plan_raises"] = True
    return {"flags": flags, "out": out if rank == 0 else None}


# ---------------------------------------------------------------------------
# tests/test_torch_dist_rules.py
# ---------------------------------------------------------------------------

def rules_rank(rank, world, arch, g_np):
    """Mesh helpers, this rank's batch rows, the specs on a real
    DeviceMesh and the compressed mean with error feedback, on meshes
    (world,) and (2, world / 2)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import (DataCursor, SyntheticTokens,
                                           make_global_batch)
    from repro_torch.dist import api, compression, sharding
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_dev_mesh

    res = {}
    params = steps_mod.init_params(get_smoke_config(arch), generator=None,
                                   device="meta")
    ds = SyntheticTokens(1000, 12, 8, seed=3)
    for shape in ((world,), (2, world // 2)):
        mesh = make_mesh(shape)
        rows = make_global_batch(ds, DataCursor(2), mesh, device="cpu")
        res[shape] = {
            "axes": api.mesh_axes(mesh), "ndev": api.mesh_ndev(mesh),
            "sizes": api.axis_sizes(mesh), "ranks": api.mesh_ranks(mesh),
            "position": api.mesh_position(mesh),
            "coord": tuple(mesh.get_coordinate()),
            "tokens": rows["tokens"].numpy(),
            "specs": sharding.param_sharding(params, mesh),
            "pool": sharding.solve_pool_sharding(mesh)}
    dev_mesh = make_dev_mesh(model=2)
    res["dev_mesh"] = (api.mesh_axes(dev_mesh), api.axis_sizes(dev_mesh))
    # a trainer on a mesh with a model axis of several ranks takes it
    # (tensor parallelism), moe too (expert parallelism: the experts'
    # leaves sliced on their expert dim)
    from repro_torch.core.kfac import KFACConfig
    from repro_torch.launch.train import KFACProgram
    program = KFACProgram(get_smoke_config(arch), KFACConfig(block_size=32),
                          device="cpu", mesh=dev_mesh)
    res["model_axis"] = (program.model_parallel, program.shards.rank,
                         api.mesh_ndev(program.data_mesh))
    moe = KFACProgram(get_smoke_config("moonshot-v1-16b-a3b"),
                      KFACConfig(block_size=32), device="cpu", mesh=dev_mesh)
    res["moe_axis"] = (moe.model_parallel, sorted(
        {d for k, d in moe.shards.dims.items() if "/moe/" in k},
        key=str))
    # compressed means of each rank's own gradient, with error feedback
    mesh = make_mesh((world,))
    g = torch.from_numpy(g_np[rank])
    err = torch.zeros_like(g)
    means = []
    for _ in range(8):
        mean, err = compression.compressed_psum(g, err, mesh)
        means.append(mean.numpy())
    res["means"], res["err"] = np.stack(means), err.numpy()
    tree, errs = compression.compressed_allreduce_tree(
        {"a": {"b": g}}, {"a": {"b": torch.zeros_like(g)}},
        make_mesh((2, world // 2)), ("pod", "data"))
    res["tree_data_axis"] = tree["a"]["b"].numpy()
    return res


# ---------------------------------------------------------------------------
# tests/test_torch_dist_train.py
# ---------------------------------------------------------------------------

def train_rank(rank, world, arch, params_np, n_steps, common, dist_inv):
    """``KFACProgram(mesh=)`` for ``n_steps`` on the given weights (fp32
    compute), each rank on its rows of the synthetic batches: the losses,
    each phase's keys, a params digest and rank 0's final state."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import kfac
    from repro_torch.data import DataCursor, SyntheticTokens
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_dev_mesh

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    mesh = make_dev_mesh()
    program = train_mod.KFACProgram(cfg, kfac.KFACConfig(**common),
                                    device="cpu", mesh=mesh,
                                    dist_inv=dist_inv)
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    state = steps_mod.TrainState(params, kfac.init(
        params, steps_mod.kfac_specs(cfg), program.kcfg))
    step_fn = program.make_step(state)
    ds = SyntheticTokens(cfg.vocab, common["stats_seq"],
                         common["stats_batch"], seed=0)
    cursor, losses, phases = DataCursor(), [], []
    for _ in range(n_steps):
        state, m = step_fn(state, make_global_batch(ds, cursor, mesh,
                                                    device="cpu"))
        cursor = cursor.advance()
        losses.append(float(m["loss"]))
        phases.append(sorted(m["phase_s"]))
    return {"losses": losses, "phases": phases,
            "digest": train_mod.params_digest(state.params),
            "params": ({k: v.numpy() for k, v in state.params.items()}
                       if rank == 0 else None),
            "inverses": (numpy_tree(state.kfac.inverses) if rank == 0
                         else None),
            "factors": (numpy_tree(state.kfac.factors) if rank == 0
                        else None)}


def recovery_rank(rank, world, arch, ckpt_dir, common, n_steps, fail_rank,
                  fail_at, inside):
    """``runtime.TrainLoop`` over ``KFACProgram(mesh=)`` for ``n_steps``
    (seed-0 weights, fp32 compute) with a DeviceLoss raised on rank
    ``fail_rank`` alone at step ``fail_at``: from the ``inject`` hook
    (``inside`` false; checkpoints every 2 steps into ``ckpt_dir``), or
    inside that rank's step, before its collectives (``inside`` true).
    Returns the loop's summary and a params digest; with ``inside`` false
    also the failure-free run's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import kfac
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.runtime.elastic import DeviceLoss
    from repro_torch.runtime.loop import LoopConfig, TrainLoop

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    program = train_mod.KFACProgram(cfg, kfac.KFACConfig(**common),
                                    device="cpu", mesh=make_dev_mesh(),
                                    dist_inv=True)
    ds = SyntheticTokens(cfg.vocab, common["stats_seq"],
                         common["stats_batch"], seed=0)

    def summary(loop):
        res = loop.run()
        return {"recoveries": res["recoveries"], "steps": res["steps"],
                "history": [(h["step"], float(h["loss"]))
                            for h in res["history"]],
                "digest": train_mod.params_digest(loop.final_state.params)}

    fired = []

    def fail(step):
        if rank == fail_rank and step == fail_at and not fired:
            fired.append(step)
            raise DeviceLoss(0, f"injected on rank {rank}")

    if inside:
        make_step = program.make_step

        def make_failing_step(state):
            step_fn = make_step(state)
            calls = []

            def failing(state, batch):
                fail(len(calls))
                calls.append(1)
                return step_fn(state, batch)

            return failing

        program.make_step = make_failing_step
        return summary(TrainLoop(LoopConfig(n_steps, hang_factor=None),
                                 program, ds))
    plain = summary(TrainLoop(LoopConfig(n_steps, hang_factor=None),
                              program, ds))
    drill = summary(TrainLoop(
        LoopConfig(n_steps, ckpt_dir=ckpt_dir, ckpt_every=2,
                   hang_factor=None), program, ds, inject=fail))
    return {"plain": plain, "drill": drill}


# ---------------------------------------------------------------------------
# tests/test_torch_dist_tp.py
# ---------------------------------------------------------------------------

#: the tensor-parallel tests' K-FAC block: at 32 the smoke configs take
#: every case of the slicing rule (tests/test_torch_dist_tp.py)
TP_BLOCK = 32


def seams_rank(rank, world):
    """The seams on a (1, world) mesh: ``fwd_psum`` sums forward and
    passes the cotangent through, ``bwd_psum`` passes forward and sums
    the cotangent; the ``*_if_bound`` forms only inside a guard that
    bound the axis; the guard's binding dropped after a raise."""
    from repro_torch.dist import api
    from repro_torch.launch.mesh import make_dev_mesh

    mesh = make_dev_mesh(world)
    sub = mesh["model"]
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1)
    ct = torch.full((2, 3), float(rank + 1))
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    total = sum(range(1, world + 1))
    flags = {}
    api.SEAM_TRAFFIC.update(reductions=0, bytes=0)
    xr = x.clone().requires_grad_()
    y = api.fwd_psum(xr, sub)
    (g,) = torch.autograd.grad(y, xr, ct)
    flags["fwd_value"] = torch.equal(y, base * total)
    flags["fwd_grad"] = torch.equal(g, ct)
    xr = x.clone().requires_grad_()
    y = api.bwd_psum(xr, sub)
    (g,) = torch.autograd.grad(y, xr, ct)
    flags["bwd_value"] = torch.equal(y, x)
    flags["bwd_grad"] = torch.equal(g, torch.full((2, 3), float(total)))
    xb = x.to(torch.bfloat16).requires_grad_()
    (g,) = torch.autograd.grad(api.bwd_psum(xb, sub), xb,
                               ct.to(torch.bfloat16))
    flags["bwd_bf16"] = g.dtype == torch.bfloat16 and torch.equal(
        g.float(), torch.full((2, 3), float(total)))
    flags["traffic"] = api.SEAM_TRAFFIC == {"reductions": 3,
                                            "bytes": 3 * 6 * 4}
    flags["unbound"] = (api.psum_if_bound(x, "model") is x
                        and api.bwd_psum_if_bound(x, "model") is x
                        and api.bound_axes() == {})
    with api.hint_guard({"model": sub}):
        flags["bound"] = (api.bound_axes() == {"model": world}
                          and torch.equal(api.psum_if_bound(x, "model"),
                                          base * total)
                          and api.bound_mesh("data") is None)
        with api.hint_guard():
            flags["inner_unbound"] = api.psum_if_bound(x, "model") is x
    try:
        with api.hint_guard({"model": sub}):
            raise KeyError("inside")
    except KeyError:
        pass
    flags["dropped_after_raise"] = api.bound_axes() == {}
    return flags


def tp_model_rank(rank, world, mesh_shape, cases):
    """Loss and gradients of each case ``(arch, params, batch)`` (fp32
    compute, the full numpy weights and batch) on a ``(data, model)``
    mesh of ``mesh_shape``: the rank's slices of the weights, its rows of
    the batch, the model under the guard, the loss and gradients reduced
    over the data ranks, the gradients gathered over the model ranks.
    Returns each case's loss and gathered gradients (rank 0), the
    sliced dims, and whether every sliced leaf lives only as its slice
    (its shape the full one divided by ``mp`` along that dim)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import batch_shard
    from repro_torch.dist import sharding
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_dev_mesh

    data, mp = mesh_shape
    mesh = make_dev_mesh(mp)
    data_mesh = mesh["data"] if data > 1 else None
    out = []
    for arch, params_np, batch_np in cases:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        full = {k: torch.from_numpy(v) for k, v in params_np.items()}
        shards = sharding.model_shards(cfg, mesh, full, TP_BLOCK)
        local = sharding.local_params(full, shards)
        shard, n = batch_shard(mesh)
        b = batch_np["tokens"].shape[0] // n
        rows = steps_mod.batch_rows(
            {k: torch.from_numpy(v) for k, v in batch_np.items()},
            shard * b, (shard + 1) * b)
        with steps_mod.bound(shards):
            loss, grads = steps_mod._grads(cfg, local, rows)
        order = sorted(grads)
        if data_mesh is not None:
            red = steps_mod.reduce_shares([grads[k] for k in order] + [loss],
                                          data_mesh, [1.0 / n] * (len(order)
                                                                  + 1))
            grads, loss = dict(zip(order, red[:-1])), red[-1]
        gathered = sharding.full_params(grads, shards)
        sliced_only = all(
            local[k].shape[d] * mp == full[k].shape[d]
            and local[k].shape[:d] + local[k].shape[d + 1:]
            == full[k].shape[:d] + full[k].shape[d + 1:]
            for k, d in shards.dims.items() if d is not None)
        out.append({"loss": float(loss),
                    "grads": ({k: v.numpy() for k, v in gathered.items()}
                              if rank == 0 else None),
                    "dims": {k: d for k, d in shards.dims.items()
                             if d is not None},
                    "sliced_only": sliced_only})
    return out


def tp_train_rank(rank, world, mesh_shape, arch, n_steps, common,
                  ckpt_dir):
    """``runtime.TrainLoop`` over ``KFACProgram`` on a ``(data, model)``
    mesh of ``mesh_shape`` (seed-0 weights, fp32 compute, ``--dist-inv``)
    for ``n_steps``, writing its last checkpoint into ``ckpt_dir``: the
    losses and trust-region ``nu`` of every step, digests of the
    replicated leaves at every step, rank 0's full final state (gathered),
    and whether the ``--dist-inv`` refresh of the final factors is bitwise
    the one-rank refresh's blocks, and the trust-region ``nu`` of one
    update on seeded gradients, on one rank's full state and on this
    rank's slices. At (2, 2) also ``solve.fused_wu`` in both modes over
    the data submesh against the local call, and the compressed
    reduction of a seeded gradient over ``data``, against the one-axis
    call on the data submesh, and over (pod, data) of a (1, 2, 2) mesh."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import kfac
    from repro_torch.data import SyntheticTokens
    from repro_torch.dist import compression, sharding
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.runtime.loop import LoopConfig, TrainLoop
    from repro_torch.solve import make_wu_plan

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    mesh = make_dev_mesh(mesh_shape[1])
    program = train_mod.KFACProgram(cfg, kfac.KFACConfig(**common),
                                    device="cpu", mesh=mesh, dist_inv=True)
    ds = SyntheticTokens(cfg.vocab, common["stats_seq"],
                         common["stats_batch"], seed=0)
    digests = []
    make_step = program.make_step

    def digesting(state):
        step_fn = make_step(state)

        def step(state, batch):
            state, m = step_fn(state, batch)
            digests.append(train_mod.params_digest(
                {k: v for k, v in state.params.items()
                 if program.shards.dims.get(k) is None}))
            return state, m

        return step

    program.make_step = digesting
    loop = TrainLoop(LoopConfig(n_steps, ckpt_dir=ckpt_dir,
                                ckpt_every=n_steps, hang_factor=None,
                                model_parallel=mesh_shape[1]), program, ds)
    res = loop.run()
    full = program.full_state(loop.final_state)
    # the split refresh of the final factors: each rank's inverse blocks
    # bitwise the matching blocks of the one-rank refresh
    refresh = steps_mod.make_inv_refresh(cfg, program.kcfg, mesh=mesh,
                                         distributed=True,
                                         shards=program.shards)
    one = sharding.local_factors(
        kfac.invert_factors(full.kfac.factors, program.kcfg),
        program.shards)
    # the trust-region scale on the same seeded gradients: one rank's
    # on the full state against this rank's on its slices
    g = {k: torch.from_numpy(np.random.default_rng(7).standard_normal(
        tuple(v.shape)).astype(np.float32)) for k, v in full.params.items()}
    nus = []
    for st, grads, shards in ((full, g, None),
                              (loop.final_state,
                               sharding.local_params(g, program.shards),
                               program.shards)):
        specs = steps_mod.kfac_specs(cfg, shards)
        info: dict = {}
        kfac.apply_updates(st.params, grads, st.kfac, specs, program.kcfg,
                           wu_plan=make_wu_plan(specs, st.kfac.factors),
                           use_kernel=True, shards=shards, info=info)
        nus.append(float(info["nu"]))
    out = {"losses": [h["loss"] for h in res["history"]],
           "nu_same_inputs": nus,
           "refresh_bitwise": bitwise(
               refresh(loop.final_state.kfac.factors), one),
           "nu": [h["nu"] for h in res["history"]],
           "replicated_digests": digests,
           "digest": train_mod.params_digest(full.params),
           "local_shapes": {k: tuple(v.shape) for k, v in
                            loop.final_state.params.items()},
           "state": ({"params": {k: v.numpy() for k, v in
                                 full.params.items()},
                      "factors": numpy_tree(full.kfac.factors),
                      "inverses": numpy_tree(full.kfac.inverses)}
                     if rank == 0 else None)}
    if mesh_shape == (2, 2):
        # fused INV->VMM over the data submesh, on this rank's slices
        from repro_torch.solve import refresh_and_precondition

        local, specs = loop.final_state, steps_mod.kfac_specs(
            cfg, program.shards)
        lg = sharding.local_params(g, program.shards)
        lg = {k: v for k, v in lg.items() if k in specs}
        inv1, pre1 = refresh_and_precondition(
            local.kfac.factors, lg, program.kcfg,
            make_wu_plan(specs, local.kfac.factors))
        wu2 = make_wu_plan(specs, local.kfac.factors, ndev=2)
        out["fused_wu_data_submesh"] = {
            mode: bitwise(refresh_and_precondition(
                local.kfac.factors, lg, program.kcfg, wu2,
                mesh=mesh["data"], mode=mode), (inv1, pre1))
            for mode in ("owner", "gather")}
        g = {"w": torch.from_numpy(np.random.default_rng(rank).standard_normal(
            (8, 16)).astype(np.float32))}
        e = {"w": torch.zeros(8, 16)}
        got, err = compression.compressed_allreduce_tree(
            g, e, mesh, ("pod", "data"))
        want, werr = compression.compressed_allreduce_tree(
            g, e, mesh["data"], ("data",))
        from torch.distributed.device_mesh import init_device_mesh
        mesh3 = init_device_mesh("cpu", (1, 2, 2),
                                 mesh_dim_names=("pod", "data", "model"))
        got3, err3 = compression.compressed_allreduce_tree(
            g, e, mesh3, ("pod", "data"))
        out["compressed"] = {"data_axis": bitwise(got, want)
                             and bitwise(err, werr),
                             "pod_data_axes": bitwise(got3, want)
                             and bitwise(err3, werr)}
    return out


def tp_world2_rank(rank, world, cases):
    """World 2's body: :func:`seams_rank`, then :func:`tp_model_rank` at
    (1, 2)."""
    return {"seams": seams_rank(rank, world),
            "models": tp_model_rank(rank, world, (1, world), cases)}


# ---------------------------------------------------------------------------
# tests/test_torch_cuda.py
# ---------------------------------------------------------------------------

def cuda_refresh_rank(rank, world, leaves):
    """The distributed refresh on this rank's card (``leaves``: (name,
    side, nb, bs) of random SPD factors, the same on every rank): its
    ``neumann_inv`` launches against its plan rows' schedule, the blocks
    they inverted, and whether the result is bitwise the one-rank grouped
    refresh."""
    from repro_torch.core.kfac import KFACConfig
    from repro_torch.kernels import neumann_inv as nv_mod
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.solve import invert_factor_tree, make_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    kw = dict(ns_iters=20, taylor_terms=4, refine_steps=2)
    cfg = KFACConfig(**kw)
    r = np.random.default_rng(11)
    factors = {}
    for name, side, nb, bs in leaves:
        factors.setdefault(name, {})[side] = torch.from_numpy(
            spd(r, (nb, bs, bs))).to(dev)
    mesh = make_dev_mesh()
    plan = make_plan(factors, world, cfg)
    ops.reset_launch_counts()
    got = invert_factor_tree(factors, cfg, mesh=mesh, plan=plan)
    torch.cuda.synchronize(dev)
    launches = ops.launch_counts()["neumann_inv"]
    items = ops.launch_items()["neumann_inv"]
    one = invert_factor_tree(factors, cfg)
    return {"bitwise": bitwise(got, one), "launches": launches,
            "items": items,
            "expected": nv_mod.expected_launches(
                {g.bs: [g.per_device] for g in plan.groups}, **kw),
            "per_device": {g.bs: g.per_device for g in plan.groups}}


#: tests/test_torch_cuda.py's tensor-parallel run: dense smoke at fp32
CUDA_TP = dict(arch="qwen1.5-0.5b", steps=4,
               kcfg=dict(stats_every=2, inv_every=2, block_size=TP_BLOCK,
                         stats_batch=4, stats_seq=32))


def _cuda_tp_run(device, mesh):
    """``CUDA_TP``'s K-FAC run on ``device`` (``mesh``: a (1, 2) mesh, or
    None for one rank): losses, launches, blocks inverted, gathered
    params digest."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import kfac
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import fused_precond as fp_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(CUDA_TP["arch"]),
                              dtype="float32")
    kc = CUDA_TP["kcfg"]
    program = train_mod.KFACProgram(cfg, kfac.KFACConfig(**kc),
                                    device=device, mesh=mesh, dist_inv=True)
    ops.reset_launch_counts()
    state, hist = train_mod.run(program, SyntheticTokens(
        cfg.vocab, kc["stats_seq"], kc["stats_batch"], seed=0),
        CUDA_TP["steps"])
    torch.cuda.synchronize(device)
    wu = steps_mod.make_wu_plan_for(cfg, state, shards=program.shards)
    return {"losses": [h["loss"] for h in hist],
            "fused_precond": ops.launch_counts()["fused_precond"],
            "fused_precond_expected": CUDA_TP["steps"] * sum(
                fp_mod.expected_launches(g.n_tiles, g.bi, g.bo,
                                         shared=g.bi == g.bo)
                for g in wu.groups),
            "blocks": ops.launch_items()["neumann_inv"],
            "digest": train_mod.params_digest(
                program.full_state(state).params)}


def cuda_tp_rank(rank, world):
    """One rank of ``CUDA_TP`` on its card, on a (1, 2) mesh."""
    from repro_torch.launch.mesh import make_dev_mesh

    return _cuda_tp_run(torch.device("cuda", torch.cuda.current_device()),
                        make_dev_mesh(world))


def cuda_tp_one_rank(device):
    """``CUDA_TP`` on one rank (the test process)."""
    return _cuda_tp_run(device, None)


# ---------------------------------------------------------------------------
# tests/test_torch_dist_ep.py
# ---------------------------------------------------------------------------

#: the expert-parallel tests' K-FAC config (moonshot smoke at fp32): a
#: stats step and a refresh every 2 steps, block 32, global batch 4 x 16
EP_KCFG = dict(stats_every=2, inv_every=2, block_size=TP_BLOCK,
               stats_batch=4, stats_seq=16)
#: the trajectory's data seed: every step's batch drops pairs at the
#: capacity of one rank and of each of two data shards (at seeds 0-3
#: some step's shard drops none)
EP_DATA_SEED = 4


def _ep_cfg(arch, **kw):
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def _ep_program(cfg, mesh, **kw):
    from repro_torch.core import kfac
    from repro_torch.launch import train as train_mod

    return train_mod.KFACProgram(cfg, kfac.KFACConfig(**{**EP_KCFG, **kw}),
                                 device="cpu", mesh=mesh, dist_inv=True)


def _ep_state(program, params_np):
    """The program's state on the given full weights: this rank's
    slices."""
    from repro_torch.core import kfac
    from repro_torch.launch import steps as steps_mod

    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    return program.local_state(steps_mod.TrainState(params, kfac.init(
        params, steps_mod.kfac_specs(program.cfg), program.kcfg)))


def _rows(batch_np, mesh):
    """This rank's contiguous rows of a global batch."""
    from repro_torch.data.pipeline import batch_rows_of

    lo, hi = batch_rows_of(batch_np["tokens"].shape[0], mesh)
    return {k: torch.from_numpy(v[lo:hi]) for k, v in batch_np.items()}


def ep_grads(cfg, mesh, params_np, batch_np):
    """One train step of ``KFACProgram`` on ``mesh`` from the given full
    weights and global batch: its loss and the gradients it hands the
    WU (reduced over the data ranks), gathered over the model ranks."""
    from repro_torch.core import kfac
    from repro_torch.dist import sharding
    from repro_torch.launch import steps as steps_mod

    program = _ep_program(cfg, mesh)
    state = _ep_state(program, params_np)
    seen = {}
    orig = kfac.apply_updates

    def spy(params, grads, *a, **k):
        seen["grads"] = grads
        return orig(params, grads, *a, **k)

    kfac.apply_updates = spy
    try:
        train = steps_mod.make_train_step(
            cfg, program.kcfg, data_mesh=program.data_mesh,
            shards=program.shards)
        _, m = train(state, _rows(batch_np, mesh))
    finally:
        kfac.apply_updates = orig
    grads = seen["grads"]
    if program.shards is not None:
        grads = sharding.full_params(grads, program.shards)
    return {"loss": float(m["loss"]),
            "grads": {k: v.numpy() for k, v in grads.items()}}


def ep_grams(cfg, mesh, params_np, batch_np, stats_batch):
    """The factors after step 0 of ``KFACProgram`` on ``mesh`` at EMA
    decay 0 (so the Grams of the subsample, the global batch's rows
    ``[:stats_batch]``), gathered over the model ranks; the
    ``--dist-inv`` refresh of them ran too."""
    from repro_torch.dist import sharding

    program = _ep_program(cfg, mesh, ema_decay=0.0, stats_batch=stats_batch)
    state = _ep_state(program, params_np)
    state, _ = program.make_step(state)(state, _rows(batch_np, mesh))
    fac = state.kfac.factors
    if program.shards is not None:
        fac = sharding.full_factors(fac, program.shards)
    return numpy_tree(fac)


def ep_train(cfg, mesh, n_steps, ckpt_dir):
    """``runtime.TrainLoop`` over ``KFACProgram`` on ``mesh`` (seed-0
    weights, data seed :data:`EP_DATA_SEED`, ``--dist-inv``) for
    ``n_steps``, its last checkpoint in
    ``ckpt_dir``: the losses, a digest of the router (and of every
    replicated leaf) after each step, the expert leaves' local factor,
    inverse and WU stacks, whether the split refresh of the final
    factors is bitwise the one-rank refresh's blocks, and rank 0's full
    final state."""
    from repro_torch.core import kfac
    from repro_torch.data import SyntheticTokens
    from repro_torch.dist import sharding
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime.loop import LoopConfig, TrainLoop

    program = _ep_program(cfg, mesh)
    shards = program.shards
    ds = SyntheticTokens(cfg.vocab, EP_KCFG["stats_seq"],
                         EP_KCFG["stats_batch"], seed=EP_DATA_SEED)
    routers, replicated = [], []
    make_step = program.make_step

    def digesting(state):
        step_fn = make_step(state)

        def step(state, batch):
            state, m = step_fn(state, batch)
            routers.append(train_mod.params_digest(
                {k: v for k, v in state.params.items()
                 if k.endswith("moe/router")}))
            replicated.append(train_mod.params_digest(
                {k: v for k, v in state.params.items()
                 if shards is None or shards.dims.get(k) is None}))
            return state, m

        return step

    program.make_step = digesting
    mp = 1 if shards is None else shards.mp
    loop = TrainLoop(LoopConfig(n_steps, ckpt_dir=ckpt_dir,
                                ckpt_every=n_steps, hang_factor=None,
                                model_parallel=mp), program, ds)
    res = loop.run()
    local = loop.final_state
    full = program.full_state(local)
    experts = [n for n in local.kfac.factors if "/moe/" in n]
    out = {"losses": [h["loss"] for h in res["history"]],
           "routers": routers, "replicated": replicated,
           "digest": train_mod.params_digest(full.params),
           "factor_shapes": {n: {s: tuple(t.shape) for s, t in
                                 local.kfac.factors[n].items()}
                             for n in experts},
           "inverse_shapes": {n: {s: tuple(t.shape) for s, t in
                                  local.kfac.inverses[n].items()}
                              for n in experts},
           "wu_stacks": {leaf.name: tuple(leaf.stack) for g in
                         steps_mod.make_wu_plan_for(cfg, local,
                                                    shards=shards).groups
                         for leaf in g.leaves if leaf.name in experts},
           "state": ({"params": {k: v.numpy() for k, v in
                                 full.params.items()},
                      "factors": numpy_tree(full.kfac.factors),
                      "inverses": numpy_tree(full.kfac.inverses),
                      "adam_mu": {k: v.numpy() for k, v in
                                  full.kfac.adam_mu.items()}}
                     if torch.distributed.get_rank() == 0 else None)}
    if shards is not None:
        refresh = steps_mod.make_inv_refresh(cfg, program.kcfg, mesh=mesh,
                                             distributed=True, shards=shards)
        one = sharding.local_factors(
            kfac.invert_factors(full.kfac.factors, program.kcfg), shards)
        out["refresh_bitwise"] = bitwise(refresh(local.kfac.factors), one)
    return out


def ep_rank(rank, world, cases):
    """Every case ``(key, kind, arch, cfg overrides, mesh shape, args)``
    of this world, in order: ``kind`` "grads" (:func:`ep_grads`, args
    the weights and the batch), "grams" (:func:`ep_grams`, plus the
    subsample's rows) or "train" (:func:`ep_train`, args the step count
    and the checkpoint dir). Returns ``{key: result}``, the gathered
    arrays on rank 0 only."""
    from repro_torch.launch.mesh import make_dev_mesh

    out = {}
    for key, kind, arch, over, shape, args in cases:
        cfg = _ep_cfg(arch, **over)
        mesh = make_dev_mesh(shape[1])
        fn = {"grads": ep_grads, "grams": ep_grams, "train": ep_train}[kind]
        got = fn(cfg, mesh, *args)
        if rank and kind == "grads":
            got["grads"] = None
        elif rank and kind == "grams":
            got = None
        out[key] = got
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_dist_pp.py
# ---------------------------------------------------------------------------

#: the pipeline tests' K-FAC config (smoke widths, block 32)
PP_KCFG = dict(block_size=32, stats_batch=8, stats_seq=16, stats_every=2,
               inv_every=2)
#: the trajectory's data seed
PP_DATA_SEED = 3


def _pp_program(cfg, mesh, **kw):
    from repro_torch.core import kfac
    from repro_torch.dist.api import axis_sizes
    from repro_torch.launch import train as train_mod

    return train_mod.KFACProgram(
        cfg, kfac.KFACConfig(**{**PP_KCFG, **kw}), device="cpu", mesh=mesh,
        pp=axis_sizes(mesh)["stage"], dist_inv=True)


def _pp_rows(batch_np, mesh):
    """This rank's rows of a global batch (M-RoPE positions on their
    batch dim)."""
    from repro_torch.data.pipeline import batch_rows_of
    from repro_torch.pipeline.microbatch import batch_axis

    lo, hi = batch_rows_of(batch_np["tokens"].shape[0], mesh)
    return {k: torch.from_numpy(np.ascontiguousarray(
        np.take(v, range(lo, hi), axis=batch_axis(k, v.ndim))))
        for k, v in batch_np.items()}


def _gather_params(tree, shards, cfg):
    """A parameter-shaped dict of this rank's leaves, whole (every rank
    calls)."""
    from repro_torch.dist import sharding
    from repro_torch.launch import steps as steps_mod

    if shards.model is not None:
        tree = sharding.full_params(tree, shards.model)
    like = steps_mod.init_params(cfg, generator=None, device="meta")
    return sharding.stage_full_params(tree, like, shards, "cpu")


def pp_grads(cfg, mesh, params_np, batch_np, uniform=False):
    """One pipelined train step of ``KFACProgram`` on ``mesh`` from the
    given full weights and global batch, under each schedule: the loss,
    the gradients the WU takes (gathered whole), each schedule's peak
    stash on this rank, whether GPipe's loss and gradients are bitwise
    1F1B's, and this rank's leaves. ``uniform``: the uniform partition
    instead of the free one."""
    from repro_torch.core import kfac
    from repro_torch.dist import sharding
    from repro_torch.launch import steps as steps_mod
    from repro_torch.pipeline import partition_stages

    program = _pp_program(cfg, mesh)
    shards = program.shards
    if uniform:
        shards = sharding.stage_shards(
            cfg, mesh, partition_stages(cfg, shards.n_stages,
                                        require_uniform=True),
            shards.model)
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    state = steps_mod.local_state(steps_mod.TrainState(params, kfac.init(
        params, steps_mod.kfac_specs(cfg), program.kcfg)), shards)
    rows = _pp_rows(batch_np, mesh)
    out = {"leaves": sorted(state.params), "peak_stash": {}}
    seen = {}
    orig = kfac.apply_updates

    def spy(params, grads, *a, **k):
        seen["grads"] = grads
        return orig(params, grads, *a, **k)

    kfac.apply_updates = spy
    try:
        for kind in ("1f1b", "gpipe"):
            step = steps_mod.make_pipeline_step(
                cfg, program.kcfg, mesh=mesh, pp=shards.n_stages,
                schedule=kind, shards=shards)
            _, m = step(state, rows)
            out["peak_stash"][kind] = step.grads_fn.peak_stash
            out[kind] = (m["loss"], seen.pop("grads"))
    finally:
        kfac.apply_updates = orig
    (l1, g1), (lg, gg) = out.pop("1f1b"), out.pop("gpipe")
    out["gpipe_bitwise"] = bool(torch.equal(l1, lg)) and all(
        torch.equal(g1[k], gg[k]) for k in g1)
    out["loss"] = float(l1)
    full = _gather_params(g1, shards, cfg)
    out["grads"] = ({k: v.numpy() for k, v in full.items()}
                    if torch.distributed.get_rank() == 0 else None)
    return out


def pp_grams(cfg, mesh, params_np, batch_np):
    """The factors after the statistics step of ``KFACProgram`` on
    ``mesh`` at EMA decay 0 (the Grams of the whole batch, passed
    through the stages), this rank's names and shapes, whether the
    stage's ``--dist-inv`` refresh over its ``(data, model)`` ranks is
    bitwise the local refresh of its factors, and the factors gathered
    whole (rank 0)."""
    from repro_torch.core import kfac
    from repro_torch.dist import sharding
    from repro_torch.launch import steps as steps_mod

    program = _pp_program(cfg, mesh, ema_decay=0.0)
    shards = program.shards
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    state = steps_mod.local_state(steps_mod.TrainState(params, kfac.init(
        params, steps_mod.kfac_specs(cfg), program.kcfg)), shards)
    stats = steps_mod.make_stats_step(cfg, program.kcfg,
                                      data_mesh=program.data_mesh,
                                      shards=shards)
    state, _ = stats(state, _pp_rows(batch_np, mesh))
    fac = state.kfac.factors
    # the stage's distributed refresh over its (data, model) ranks
    refresh = steps_mod.make_inv_refresh(
        cfg, program.kcfg, mesh=mesh["data", "model"], distributed=True,
        shards=shards.model)
    out = {"shapes": {n: {s: tuple(t.shape) for s, t in d.items()}
                      for n, d in fac.items()},
           "refresh_bitwise": bitwise(refresh(fac), kfac.invert_factors(
               fac, program.kcfg))}
    if shards.model is not None:
        fac = sharding.full_factors(fac, shards.model)
    like = steps_mod.state_like(cfg, program.kcfg).kfac.factors
    full = sharding.stage_full_factors(fac, like, shards, "cpu")
    out["factors"] = (numpy_tree(full) if torch.distributed.get_rank() == 0
                      else None)
    return out


def pp_train(cfg, mesh, n_steps, ckpt_dir):
    """``runtime.TrainLoop`` over the pipelined ``KFACProgram`` on
    ``mesh`` (seed-0 weights, data seed :data:`PP_DATA_SEED`,
    ``--dist-inv``) for ``n_steps``, its last checkpoint in ``ckpt_dir``:
    the losses, this rank's leaves, factor and inverse shapes, its WU
    tiles and factor blocks, whether its refresh of the final factors is
    bitwise the one-rank refresh's blocks, the gathered params' digest,
    and rank 0's full final state."""
    from repro_torch.core import kfac, soi
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime.loop import LoopConfig, TrainLoop

    program = _pp_program(cfg, mesh)
    shards = program.shards
    ds = SyntheticTokens(cfg.vocab, PP_KCFG["stats_seq"],
                         PP_KCFG["stats_batch"], seed=PP_DATA_SEED)
    loop = TrainLoop(LoopConfig(n_steps, ckpt_dir=ckpt_dir,
                                ckpt_every=n_steps, hang_factor=None,
                                model_parallel=shards.mp,
                                pipeline_parallel=shards.n_stages),
                     program, ds)
    res = loop.run()
    local = loop.final_state
    full = program.full_state(local)
    specs = steps_mod.kfac_specs(cfg, shards)
    refresh = steps_mod.make_inv_refresh(
        cfg, program.kcfg, mesh=mesh["data", "model"], distributed=True,
        shards=shards.model)
    one = steps_mod.local_state(steps_mod.TrainState(
        full.params, dataclasses.replace(
            full.kfac, inverses=kfac.invert_factors(full.kfac.factors,
                                                    program.kcfg))),
        shards).kfac.inverses
    return {
        "losses": [h["loss"] for h in res["history"]],
        "leaves": sorted(local.params),
        "factor_shapes": {n: {s: tuple(t.shape) for s, t in d.items()}
                          for n, d in local.kfac.factors.items()},
        "inverse_shapes": {n: {s: tuple(t.shape) for s, t in d.items()}
                           for n, d in local.kfac.inverses.items()},
        "blocks": sum(math.prod(shape[:-2]) for s in specs.values()
                      for shape in soi.factor_shapes(
                          s, program.kcfg.block_size).values()),
        "wu_tiles": steps_mod.make_wu_plan_for(
            cfg, local, shards=shards).total_tiles,
        "refresh_bitwise": bitwise(refresh(local.kfac.factors), one),
        "digest": train_mod.params_digest(full.params),
        "state": ({"params": {k: v.numpy() for k, v in
                              full.params.items()},
                   "factors": numpy_tree(full.kfac.factors),
                   "inverses": numpy_tree(full.kfac.inverses),
                   "adam_mu": {k: v.numpy() for k, v in
                               full.kfac.adam_mu.items()},
                   "momentum": {k: v.numpy() for k, v in
                                full.kfac.momentum.items()}}
                  if torch.distributed.get_rank() == 0 else None)}


def pp_rank(rank, world, cases):
    """Every case ``(key, kind, arch, cfg overrides, mesh shape (stage,
    data, model), args)`` of this world, in order: ``kind`` "grads"
    (:func:`pp_grads`), "grams" (:func:`pp_grams`) or "train"
    (:func:`pp_train`). Returns ``{key: result}``."""
    from repro_torch.launch.mesh import make_pipeline_mesh

    out = {}
    for key, kind, arch, over, shape, args in cases:
        cfg = _ep_cfg(arch, **over)
        mesh = make_pipeline_mesh(shape[0], shape[2])
        fn = {"grads": pp_grads, "grams": pp_grams, "train": pp_train}[kind]
        out[key] = fn(cfg, mesh, *args)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_elastic.py
# ---------------------------------------------------------------------------

#: the drills' K-FAC config (block 32: the smoke model's attention and MLP
#: slice whole blocks over 2 model ranks) and run: a checkpoint every 2
#: steps, the loss at step 3, 4 steps
ELASTIC_KCFG = dict(stats_every=2, inv_every=2, block_size=32,
                    stats_batch=4, stats_seq=16)
ELASTIC_STEPS, ELASTIC_FAIL_AT = 4, 3


def _elastic_program(cfg, mesh, pp):
    from repro_torch.core import kfac
    from repro_torch.launch import train as train_mod

    return train_mod.KFACProgram(cfg, kfac.KFACConfig(**ELASTIC_KCFG),
                                 device="cpu", mesh=mesh, pp=pp,
                                 dist_inv=True)


def elastic_drill(rank, shape, lost, fail_rank, root):
    """The loss drill on a mesh of ``shape`` (``(data, model)`` or
    ``(stage, data, model)``): ``runtime.TrainLoop`` over ``KFACProgram``
    (seed-0 weights, fp32 compute, ``--dist-inv``), rank ``fail_rank``
    raising ``DeviceLoss(lost)`` from the ``inject`` hook at step
    :data:`ELASTIC_FAIL_AT`; then, on the mesh re-formed without ``lost``
    ranks, a failure-free run restored from the drill's own checkpoint of
    step 2. Returns the drill's summary and losses, the remesh events and
    counter (rank 0), and on the survivors the reference run's losses,
    both runs' gathered params' digests and rank 0's gathered params."""
    import json
    import os
    import shutil

    import torch.distributed as tdist

    from repro_torch import obs as obs_mod
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_dev_mesh, make_pipeline_mesh
    from repro_torch.runtime.elastic import DeviceLoss, elastic_mesh, in_mesh
    from repro_torch.runtime.loop import LoopConfig, TrainLoop

    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                              dtype="float32")
    pp, mp = (shape[0] if len(shape) == 3 else 1), shape[-1]
    obs = obs_mod.Observability(out_dir=os.path.join(root, f"obs{rank}"))
    mesh = (make_pipeline_mesh(pp, mp, obs=obs) if pp > 1
            else make_dev_mesh(mp, obs=obs))
    ds = SyntheticTokens(cfg.vocab, ELASTIC_KCFG["stats_seq"],
                         ELASTIC_KCFG["stats_batch"], seed=0)
    lcfg = dict(ckpt_every=2, hang_factor=None, model_parallel=mp,
                pipeline_parallel=pp)
    fired = []

    def fail(step):
        if rank == fail_rank and step == ELASTIC_FAIL_AT and not fired:
            fired.append(step)
            raise DeviceLoss(lost, f"injected on rank {rank}")

    drill_dir, ref_dir = os.path.join(root, "drill"), os.path.join(root,
                                                                   "ref")
    loop = TrainLoop(LoopConfig(ELASTIC_STEPS, ckpt_dir=drill_dir, **lcfg),
                     _elastic_program(cfg, mesh, pp), ds, inject=fail,
                     obs=obs)
    res = loop.run()
    out = {"summary": {k: v for k, v in res.items() if k != "history"},
           "history": [(h["step"], float(h["loss"]))
                       for h in res["history"]]}
    if rank == 0:
        obs.flush()
        with open(os.path.join(root, "obs0", obs_mod.JSONL_NAME)) as f:
            out["events"] = [json.loads(line) for line in f]
        out["remesh_total"] = obs.counter(
            "runtime_remesh_total").snapshot()["samples"]
        step = os.path.join(ref_dir, "step_0000000002")
        shutil.copytree(os.path.join(drill_dir, "step_0000000002"), step)
    tdist.barrier()
    new = elastic_mesh(mp, pp=pp, exclude=lost)
    if not in_mesh(new):
        return out
    ref_prog = _elastic_program(cfg, new, pp)
    ref = TrainLoop(LoopConfig(ELASTIC_STEPS, ckpt_dir=ref_dir, **lcfg),
                    ref_prog, ds)
    rres = ref.run()
    full = ref_prog.full_state(ref.final_state).params
    drill_full = loop.program.full_state(loop.final_state).params
    out.update(
        ref_history=[(h["step"], float(h["loss"]))
                     for h in rres["history"]],
        ref_digest=train_mod.params_digest(full),
        digest=train_mod.params_digest(drill_full),
        stage=(loop.program.shards.stage if pp > 1 else None),
        params=({k: v.numpy() for k, v in drill_full.items()}
                if rank == 0 else None))
    return out


def elastic_rank(rank, world, cases, root):
    """Every drill ``(key, shape, lost, fail_rank)`` of this world, in
    order (:func:`elastic_drill`): ``{key: result}``."""
    import os

    return {key: elastic_drill(rank, shape, lost, fail_rank,
                               os.path.join(root, key))
            for key, shape, lost, fail_rank in cases}


# ---------------------------------------------------------------------------
# tests/test_torch_dist_solvers.py
# ---------------------------------------------------------------------------

def solvers_program(cfg, kcfg_kw, mesh=None, pp=1, **kw):
    """The program of one case of the solver tests: SGD when ``kw`` has
    ``lr`` alone, else ``KFACProgram`` with ``kw``."""
    from repro_torch.core import kfac
    from repro_torch.launch import train as train_mod

    if kcfg_kw is None:
        return train_mod.SGDProgram(cfg, device="cpu", mesh=mesh, **kw)
    return train_mod.KFACProgram(cfg, kfac.KFACConfig(**kcfg_kw),
                                 device="cpu", mesh=mesh, pp=pp, **kw)


def solvers_run(program, params_np, ds_kw, n_steps):
    """``n_steps`` of ``program`` from the given full weights (its
    mesh's rows of each batch): the losses, the SMW drifts and fallback
    flags, the phases, the gathered params, a digest of this rank's
    inverses and, for K-FAC, the gathered inverses."""
    from repro_torch.core import kfac
    from repro_torch.data import DataCursor, SyntheticTokens
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod

    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    if isinstance(program, train_mod.SGDProgram):
        state = program.local_state(
            (params, {k: torch.zeros_like(v) for k, v in params.items()}))
    else:
        state = steps_mod.TrainState(params, kfac.init(
            params, steps_mod.kfac_specs(program.cfg), program.kcfg))
        state = program.local_state(state)
    step_fn = program.make_step(state)
    ds = SyntheticTokens(program.cfg.vocab, **ds_kw)
    hist, cursor = [], DataCursor()
    for _ in range(n_steps):
        batch = (ds.batch(cursor, device="cpu") if program.mesh is None
                 else make_global_batch(ds, cursor, program.mesh,
                                        device="cpu"))
        state, m = step_fn(state, batch)
        cursor = cursor.advance()
        hist.append({"loss": float(m["loss"]),
                     "phases": sorted(m["phase_s"]),
                     **{k: float(m[k]) for k in ("smw_drift",
                                                 "smw_fallback",
                                                 "pp_bubble_ticks",
                                                 "pp_bubble_fraction")
                        if k in m}})
    full = program.full_state(state)
    out = {"hist": hist}
    if isinstance(program, train_mod.SGDProgram):
        out["params"] = {k: v.numpy() for k, v in full[0].items()}
        return out
    out["params"] = {k: v.numpy() for k, v in full.params.items()}
    out["inverses"] = numpy_tree(full.kfac.inverses)
    out["local_inverses"] = train_mod.params_digest(
        {f"{n}/{s}": v for n, d in state.kfac.inverses.items()
         for s, v in d.items()})
    if program.refresher is not None:
        r = program.refresher
        out["refresher"] = (r.n_dispatched, r.n_swapped)
    return out


def smw_no_rows(rank, world, mesh, params_np, ds_kw):
    """One ``--smw`` step on ``mesh`` from the same state, with a
    subsample of one row: the ranks after the first hold none of it
    (zero Grams and columns, ``steps.make_smw_step``'s no-rows path).
    Returns whether this rank's updated inverses and drift are bitwise
    one rank's step on the same row."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import kfac
    from repro_torch.data import DataCursor, SyntheticTokens
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.solve.smw import SMWConfig

    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                              dtype="float32")
    kcfg = kfac.KFACConfig(block_size=32, stats_batch=1,
                           stats_seq=ds_kw["seq_len"])
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    state = steps_mod.TrainState(params, kfac.init(
        params, steps_mod.kfac_specs(cfg), kcfg))
    ds = SyntheticTokens(cfg.vocab, **ds_kw)
    scfg = SMWConfig(rank=16)
    rows = make_global_batch(ds, DataCursor(0), mesh, device="cpu")
    held = {"tokens": rows["tokens"][:1 if rank == 0 else 0]}
    got, m = steps_mod.make_smw_step(cfg, kcfg, scfg, data_mesh=mesh,
                                     mesh=mesh)(
        state, held, weight=1.0 if rank == 0 else 0.0, rows=1)
    one, m1 = steps_mod.make_smw_step(cfg, kcfg, scfg)(
        state, {"tokens": ds.batch(DataCursor(0), device="cpu")["tokens"]
                [:1]})
    return {"rows": held["tokens"].shape[0],
            "inverses": bitwise(got.kfac.inverses, one.kfac.inverses),
            "factors": bitwise(got.kfac.factors, one.kfac.factors),
            "drift": float(m["smw_drift"]) == float(m1["smw_drift"])}


def solvers_rank(rank, world, cases, probe=False):
    """Every case ``(key, arch, cfg overrides, mesh shape, kcfg kwargs or
    None, program kwargs, weights, dataset kwargs, steps)`` on this
    world's gloo ranks, in order: ``{key: solvers_run's result}``, rank
    0's gathered params and inverses only; with ``probe``, also
    ``benchmarks.dist_inverse``'s ``--smw`` probe (``"dist_inverse_smw"``)."""
    from repro_torch.benchmarks import dist_inverse
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_dev_mesh, make_pipeline_mesh

    from repro_torch.solve.smw import reduce_drift

    out = {}
    if probe:
        out["dist_inverse_smw"] = dist_inverse.smw_probe(rank, world, "cpu")
        # the drift every gate reads: the max, and NaN if any rank's is
        mesh = make_dev_mesh()
        out["drift_max"] = float(reduce_drift(
            torch.tensor(0.25 * (rank + 1)), mesh))
        out["drift_nan"] = float(reduce_drift(torch.tensor(
            float("nan") if rank == world - 1 else 0.5), mesh))
        out["smw_no_rows"] = smw_no_rows(rank, world, mesh,
                                         cases[0][6], cases[0][7])
    for key, arch, over, shape, kcfg_kw, kw, params_np, ds_kw, n in cases:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                  **over)
        pp = shape[0] if len(shape) == 3 else 1
        mesh = (make_pipeline_mesh(pp, shape[-1]) if pp > 1
                else make_dev_mesh(shape[-1]))
        res = solvers_run(solvers_program(cfg, kcfg_kw, mesh, pp, **kw),
                          params_np, ds_kw, n)
        if rank:
            res.pop("params")
            res.pop("inverses", None)
        out[key] = res
    return out
