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
    # a trainer on a mesh with a model axis of several ranks refuses it
    from repro_torch.core.kfac import KFACConfig
    from repro_torch.launch.train import KFACProgram
    try:
        KFACProgram(get_smoke_config(arch), KFACConfig(), device="cpu",
                    mesh=dev_mesh)
        res["model_axis_refused"] = False
    except NotImplementedError as e:
        res["model_axis_refused"] = "item 8" in str(e)
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
