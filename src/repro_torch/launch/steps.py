"""Step builders for K-FAC training and serving (counterpart of
``repro.launch.steps``).

  train_step   FP + BP + WU (precondition + update) every step
  stats_step   SU: factor Grams on a token subsample, EMA'd into state
  inv refresh  INV: composed-precision inverse of every factor block
               through the solver (``make_inv_step``: the same on a
               whole state)
  smw_step     SU with rank-k columns + factor EMA + SMW inverse update
               + drift probe, the every-step program of ``--smw``
  sgd_step     FP + BP + heavy-ball SGD, the first-order baseline
  prefill_step, decode_step   the serving programs

Every builder takes any family: :func:`model_module` is
``models.whisper`` for the audio encoder-decoder and ``models.lm`` for
the rest.

Data parallelism: the train and stats steps take ``data_mesh``, a mesh
whose ranks each hold their own rows of the global batch (the params
replicated on every rank). Each rank computes on its rows, scales by its
share of the rows (the stats step takes it as ``weight``: the SU
subsample may split unevenly) and all-reduces once, so that every rank
holds the global batch's loss and gradients (averaged), and the global
batch's A and G Grams: A is a mean over tokens (scaled by the share), G
a sum over tokens of the global mean loss's tap gradients, which are the
local ones times the share (so G is scaled by its square). The MoE
experts' A is the exception: their queues span the global subsample
(``models.moe``), each rank's buffer holds its tokens at their global
slots, and its A-Gram over the ``C`` slots is already its part of the
global one, summed with weight 1. The reduced values are the same on
every rank, so the ranks' updates are too. The steps bind ``data_mesh``
to the ``data`` axis (:func:`bound`), where the MoE layers read it.
With ``train_accum > 1`` each rank splits its own rows into contiguous
microbatches of ``q = B / (n accum)`` rows. The reference splits the
global batch instead, and its data shard ``d`` of microbatch ``i`` holds
rows ``[i mb + d q, i mb + (d + 1) q)``: the same partition of the rows
into blocks of ``q``, each block one MoE queue of ``c_loc`` slots in
both, computed on another rank and summed in another order.

Tensor parallelism: the steps take ``shards``
(``dist.sharding.ModelShards``), whose params are this rank's model
slices. They run the model inside a ``dist.api.hint_guard`` binding the
model submesh, so its seams reduce over it; ``data_mesh`` is then the
data submesh, whose ranks hold the same slices. The specs are the
local ones (:func:`kfac_specs`), so factors, inverses and WU tiles are
the rank's own blocks, and the WU of a sliced leaf needs no collective.
With ``distributed`` the refresh inverts each block of the full factor
tree on exactly one rank (:func:`make_inv_refresh`).

Pipeline parallelism: ``shards`` may be a ``dist.sharding.StageShards``
(:func:`pipeline_shards`), whose state holds one stage's leaves.
:func:`make_pipeline_step` streams microbatches through the stages
(``repro_torch.pipeline``) and ends in the same WU as
:func:`make_train_step`; the statistics step passes its subsample
through the stages, each stage getting its own layers' Grams;
:func:`full_state`/:func:`local_state` gather and cut over the stage
ranks too. Gradient accumulation and the pipeline share one splitter
(``pipeline.microbatch.split_microbatches``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import kfac
from repro_torch.core.kfac import KFACConfig, KFACState
from repro_torch.dist import sharding
from repro_torch.dist.api import DATA, MODEL, all_reduce, axis_sizes, \
    hint_guard, mesh_ndev
from repro_torch.models import lm, whisper
from repro_torch.pipeline.microbatch import batch_axis, split_microbatches
from repro_torch.solve import smw as smw_mod
from repro_torch.solve.block_solver import invert_factor_tree
from repro_torch.solve.partition import Plan, make_plan, make_wu_plan


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    kfac: KFACState


def model_module(cfg):
    return whisper if cfg.family == "audio" else lm


def _model_shards(shards):
    """The tensor-parallel layout inside ``shards`` (a stage's, under
    pipeline parallelism)."""
    return shards.model if isinstance(shards, sharding.StageShards) \
        else shards


def kfac_specs(cfg, shards=None):
    """Every factored linear's spec; under ``shards`` this rank's: a
    pipeline stage's (``pipeline.kfac_glue.stage_specs``), model slices
    (``dist.sharding.local_specs``)."""
    specs = model_module(cfg).kfac_specs(cfg)
    if isinstance(shards, sharding.StageShards):
        from repro_torch.pipeline import kfac_glue

        specs = kfac_glue.stage_specs(specs, shards.part)[shards.stage]
    model = _model_shards(shards)
    return specs if model is None else sharding.local_specs(specs, model)


def pipeline_shards(cfg, mesh, pp: int, block_size: int):
    """This rank's ``dist.sharding.StageShards`` on a ``(stage, data,
    model)`` mesh: the free partition of ``pp`` stages
    (``pipeline.partition_stages``, as ``make_pipeline_step`` cuts), and
    the model slices inside the stage at K-FAC block ``block_size``."""
    from repro_torch.pipeline import partition_stages

    shapes = init_params(cfg, generator=None, device="meta")
    return sharding.stage_shards(
        cfg, mesh, partition_stages(cfg, pp),
        sharding.model_shards(cfg, mesh, shapes, block_size))


def bound(shards, data_mesh=None):
    """The ``hint_guard`` a step runs its model calls in: binding the
    model submesh under ``shards`` and ``data_mesh`` (the ranks holding
    other rows of the batch) to ``data``, each where given."""
    model = _model_shards(shards)
    axes = {} if model is None else {MODEL: model.mesh}
    if data_mesh is not None:
        axes[DATA] = data_mesh
    return hint_guard(axes)


def local_params(params, shards):
    """A full parameter-shaped dict cut to this rank's leaves: its stage's
    (``dist.sharding.stage_local_params``), then its model slices."""
    if isinstance(shards, sharding.StageShards):
        params = sharding.stage_local_params(params, shards)
    model = _model_shards(shards)
    return params if model is None else sharding.local_params(params, model)


def state_like(cfg, kcfg: KFACConfig) -> TrainState:
    """The one-rank state's shapes and dtypes, on the meta device: the
    template a pipeline stage's parts are gathered into."""
    params = init_params(cfg, generator=None, device="meta")
    return TrainState(params, kfac.init(params, kfac_specs(cfg), kcfg))


def full_state(state: TrainState, shards, like: TrainState = None
               ) -> TrainState:
    """The full model's state from every rank's parts (collective over
    the model submesh, then under pipeline parallelism over the stage
    submesh, into the shapes of ``like``, :func:`state_like`); the state
    itself without ``shards``."""
    if isinstance(shards, sharding.StageShards):
        state = full_state(state, shards.model)
        k, lk = state.kfac, like.kfac
        dev = next(iter(state.params.values())).device

        def par(local, tmpl):
            return sharding.stage_full_params(local, tmpl, shards, dev)

        def fac(local, tmpl):
            return sharding.stage_full_factors(local, tmpl, shards, dev)

        return TrainState(par(state.params, like.params), dataclasses.replace(
            k, factors=fac(k.factors, lk.factors),
            inverses=fac(k.inverses, lk.inverses),
            momentum=par(k.momentum, lk.momentum),
            adam_mu=par(k.adam_mu, lk.adam_mu),
            adam_nu=par(k.adam_nu, lk.adam_nu)))
    if shards is None:
        return state
    k = state.kfac
    return TrainState(sharding.full_params(state.params, shards),
                      dataclasses.replace(
                          k, factors=sharding.full_factors(k.factors, shards),
                          inverses=sharding.full_factors(k.inverses, shards),
                          momentum=sharding.full_params(k.momentum, shards),
                          adam_mu=sharding.full_params(k.adam_mu, shards),
                          adam_nu=sharding.full_params(k.adam_nu, shards)))


def local_state(state: TrainState, shards) -> TrainState:
    """A full state cut to this rank's parts (:func:`full_state`'s
    inverse)."""
    if isinstance(shards, sharding.StageShards):
        k = state.kfac
        cut = sharding.stage_local_params
        state = TrainState(cut(state.params, shards), dataclasses.replace(
            k, factors=sharding.stage_local_factors(k.factors, shards),
            inverses=sharding.stage_local_factors(k.inverses, shards),
            momentum=cut(k.momentum, shards),
            adam_mu=cut(k.adam_mu, shards), adam_nu=cut(k.adam_nu, shards)))
        return local_state(state, shards.model)
    if shards is None:
        return state
    k = state.kfac
    return TrainState(sharding.local_params(state.params, shards),
                      dataclasses.replace(
                          k, factors=sharding.local_factors(k.factors, shards),
                          inverses=sharding.local_factors(k.inverses,
                                                          shards),
                          momentum=sharding.local_params(k.momentum, shards),
                          adam_mu=sharding.local_params(k.adam_mu, shards),
                          adam_nu=sharding.local_params(k.adam_nu, shards)))


def enc_len_for(cfg, seq: int) -> int:
    """Whisper's frame count for a decoder length ``seq`` (the real
    model takes 1500 frames; the assigned seq is kept on the decoder
    side)."""
    del cfg
    return min(1500, seq)


def init_params(cfg, *, generator: torch.Generator, device):
    return model_module(cfg).init(cfg, generator=generator, device=device)


def make_wu_plan_for(cfg, state: TrainState, *, ndev: int = 1,
                     shards=None):
    """Pooled WU plan for this model (this rank's slices under
    ``shards``), from the state's factor shapes, on an INV plan of
    ``ndev`` devices."""
    return make_wu_plan(kfac_specs(cfg, shards), state.kfac.factors,
                        ndev=ndev)


def reduce_shares(tensors, data_mesh, scales) -> list:
    """``sum over ranks of scale * t`` for each tensor, in one
    ``all_reduce`` of one flat fp32 buffer over ``data_mesh``; each
    result keeps its tensor's shape and dtype."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) * sc
                      for t, sc in zip(tensors, scales)])
    all_reduce(flat, data_mesh)
    out, ofs = [], 0
    for t in tensors:
        out.append(flat[ofs:ofs + t.numel()].reshape(t.shape).to(t.dtype))
        ofs += t.numel()
    return out


def build_taps(cfg, specs, batch, rows=None) -> Dict[str, torch.Tensor]:
    """Zero taps for one stats batch, ready to take gradients; ``rows``:
    the whole subsample's rows across the data ranks (default the
    batch's), which size the MoE experts' taps. The audio
    family counts rows per name: the encoder's taps and the
    cross-attention's ``wk``/``wv`` (their outputs are over the encoder's
    frames) see ``b x t_enc`` rows, the decoder's other taps ``b x t``.
    (The reference sizes every ``dec/`` tap ``b x t``, which agrees only
    while ``t_enc == t``.)"""
    b, t = batch["tokens"].shape
    device = batch["tokens"].device
    if cfg.family != "audio":
        return lm.build_taps(cfg, specs, b * t, device=device,
                             n_global=None if rows is None else rows * t)
    te = batch["enc_embeds"].shape[1]
    frames = ("enc/", "dec/cross/wk", "dec/cross/wv")
    return {name: torch.zeros(
        s.stack + (b * (te if name.startswith(frames) else t), s.d_out),
        dtype=torch.float32, device=device, requires_grad=True)
        for name, s in specs.items()}


def _grads(cfg, params, batch) -> Tuple[torch.Tensor, dict]:
    """Loss and gradients; a parameter the batch does not reach (the
    VLM's ``img_proj`` without ``img_embeds``) gets a zero gradient, as
    in JAX."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss, _ = model_module(cfg).loss_fn(cfg, p, batch)
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(p.items(), grads)}


def batch_rows(batch: dict, lo: int, hi: int) -> dict:
    """Rows ``lo:hi`` of every batch leaf, on its batch dim
    (``pipeline.microbatch.batch_axis``: the first one, except for
    M-RoPE ``positions`` (3, B, T), where it is the second)."""
    return {k: v.narrow(batch_axis(k, v.ndim), lo, hi - lo)
            for k, v in batch.items()}


def make_train_step(cfg, kcfg: KFACConfig, wu_plan=None,
                    use_kernel: bool = False,
                    timer: Callable | None = None,
                    data_mesh=None, shards=None) -> Callable:
    """One FP+BP+WU step ``(state, batch) -> (state, metrics)``; the
    metrics carry the loss, the gradient norm and the trust-region
    scale ``nu``.

    ``cfg.train_accum > 1`` splits the batch rows into that many
    microbatches and averages their loss and gradients. ``wu_plan``
    routes the WU through the pooled program and ``use_kernel`` that
    program through the ``fused_precond`` kernel. ``timer(name, fn)``,
    if given, runs the WU as ``timer("wu", fn)``. ``data_mesh``: the
    loss and gradients are the global batch's, reduced over its ranks,
    each holding an even share of the rows
    (``data.make_global_batch``). ``shards``: tensor parallelism (see
    the module's docstring)."""
    specs = kfac_specs(cfg, shards)
    accum = max(cfg.train_accum, 1)
    timer = timer or (lambda name, fn: fn())

    def train_step(state: TrainState, batch):
        with bound(shards, data_mesh):
            return step(state, batch)

    def step(state: TrainState, batch):
        if accum == 1:
            loss, grads = _grads(cfg, state.params, batch)
        else:
            micro = split_microbatches(batch, accum)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in state.params.items()}
            for i in range(accum):
                part = {k: v[i] for k, v in micro.items()}
                l_i, g_i = _grads(cfg, state.params, part)
                for k in grads:             # in place: no second tree
                    grads[k].add_(g_i[k].to(torch.float32) / accum)
                del g_i
                loss = loss + l_i / accum
        if data_mesh is not None:
            w = 1.0 / mesh_ndev(data_mesh)
            order = kfac.tree_order(grads)
            red = reduce_shares([grads[k] for k in order] + [loss],
                                data_mesh, [w] * (len(order) + 1))
            grads, loss = dict(zip(order, red[:-1])), red[-1]
        return _wu_tail(state, loss, grads, specs, kcfg, wu_plan,
                        use_kernel, timer, shards)

    return train_step


def _wu_tail(state: TrainState, loss, grads, specs, kcfg: KFACConfig,
             wu_plan, use_kernel: bool, timer: Callable, shards):
    """The WU every train step ends with: K-FAC precondition and update
    of the reduced gradients, the gradient norm, the metrics (one
    definition, so the monolithic and the pipelined steps report and
    update alike)."""
    info: dict = {}
    params2, kstate2 = timer("wu", lambda: kfac.apply_updates(
        state.params, grads, state.kfac, specs, kcfg, wu_plan=wu_plan,
        use_kernel=use_kernel, shards=shards, info=info))
    gnorm = torch.sqrt(sharding.leaf_sum(
        [(k, torch.sum(torch.square(grads[k].to(torch.float32))))
         for k in kfac.tree_order(grads)], shards))
    return TrainState(params2, kstate2), {
        "loss": loss, "grad_norm": gnorm, "nu": info["nu"]}


def make_pipeline_step(cfg, kcfg: KFACConfig, *, mesh=None, pp: int = 1,
                       schedule="1f1b", n_micro: int | None = None,
                       wu_plan=None, use_kernel: bool = False,
                       timer: Callable | None = None,
                       shards=None) -> Callable:
    """Pipeline-parallel FP+BP+WU step over the ``stage`` mesh axis
    (``--pp``).

    The layer stack is cut into ``pp`` contiguous stages (the free
    partition, ``pipeline.partition_stages``), each rank's rows into
    microbatches (``n_micro``, default ``max(train_accum, pp)``), and
    the ``schedule`` ("gpipe" | "1f1b", or a built ``pipeline.Schedule``)
    runs on each stage rank (``pipeline.make_pipeline_grads_fn``). The
    loss and gradients keep the gradient-accumulation semantics, and the
    WU (K-FAC precondition and update of this stage's leaves, through
    ``wu_plan`` and the ``fused_precond`` kernel with ``use_kernel``) is
    the monolithic step's. ``shards``: this rank's
    ``dist.sharding.StageShards`` (:func:`pipeline_shards` by default);
    the state holds its leaves. The step function's ``grads_fn`` is the
    executor (its ``peak_stash``).

    ``pp=1`` returns :func:`make_train_step` itself.
    """
    if pp <= 1:
        return make_train_step(cfg, kcfg, wu_plan=wu_plan,
                               use_kernel=use_kernel, timer=timer)
    from repro_torch import pipeline

    if mesh is None:
        raise ValueError("pp > 1 needs a mesh with a 'stage' axis "
                         "(launch.mesh.make_pipeline_mesh)")
    if shards is None:
        shards = pipeline_shards(cfg, mesh, pp, kcfg.block_size)
    part = shards.part
    m = n_micro or max(cfg.train_accum, pp)
    if isinstance(schedule, pipeline.Schedule):
        sched = schedule
        if (sched.n_stages, sched.n_micro) != (pp, m):
            raise ValueError(
                f"schedule was built for (S={sched.n_stages}, "
                f"M={sched.n_micro}), step wants (S={pp}, M={m})")
    else:
        sched = pipeline.make_schedule(schedule, pp, m)
    grads_fn = pipeline.make_pipeline_grads_fn(cfg, part, sched, mesh,
                                               shards)
    specs = kfac_specs(cfg, shards)
    timer = timer or (lambda name, fn: fn())
    data_shards = 1
    for ax in ("pod", "data"):
        data_shards *= axis_sizes(mesh).get(ax, 1)

    def train_step(state: TrainState, batch):
        b = batch["tokens"].shape[0] * data_shards
        if b % (m * data_shards):
            raise ValueError(
                f"global batch {b} must divide into n_micro={m} "
                f"microbatches x {data_shards} data shard(s); pick a "
                f"batch that is a multiple of {m * data_shards}")
        micro = pipeline.split_microbatches(batch, m)
        loss, grads = grads_fn(state.params, micro)
        return _wu_tail(state, loss, grads, specs, kcfg, wu_plan,
                        use_kernel, timer, shards)

    train_step.grads_fn = grads_fn
    train_step.schedule = sched
    return train_step


def make_stats_step(cfg, kcfg: KFACConfig, data_mesh=None,
                    shards=None) -> Callable:
    """SU: factor Grams from one tapped fwd+bwd, EMA'd into the state:
    ``(state, batch, weight=None, rows=None) -> (state, metrics)``.

    The model collects its A-Grams at ``kcfg.block_size``, the factors'
    block size. (The reference collects at ``cfg.soi_block`` and so
    fails on any config whose ``soi_block`` exceeds the K-FAC block
    size, e.g. the full qwen1.5-0.5b at ``--block-size 128``.)
    ``data_mesh``: the Grams and the loss are the global subsample's,
    reduced over its ranks; ``weight`` is this rank's share of the
    subsample's rows (default an even split) and ``rows`` the whole
    subsample's (default this rank's times the data ranks); a rank
    holding none of them (``weight`` 0, no rows) adds zeros, and its
    zero counts to the MoE queues. ``shards``: tensor parallelism (see
    the module's docstring)."""
    specs = kfac_specs(cfg, shards)
    mod = model_module(cfg)

    def local_grams(state: TrainState, batch, rows):
        taps = build_taps(cfg, specs, batch, rows)

        def loss_with_taps(p, tp, bt):
            return mod.loss_fn(cfg, p, bt, taps=tp, collect=True,
                               soi_block=kcfg.block_size)

        with bound(shards, data_mesh):
            if not isinstance(shards, sharding.StageShards):
                return kfac.stats_grams(loss_with_taps, state.params, taps,
                                        batch, specs, kcfg.block_size)
            from repro_torch.pipeline.schedule import stats_pass

            loss, acts, tap_grads = stats_pass(
                cfg, shards, state.params, taps, batch, kcfg.block_size)
            return (*kfac.grams_of(acts, tap_grads, specs, kcfg.block_size),
                    loss)

    def stats_step(state: TrainState, batch, weight=None, rows=None):
        if data_mesh is None:
            a_grams, g_grams, loss = local_grams(state, batch, None)
        else:
            w, rows = _share(batch, data_mesh, weight, rows)
            if batch["tokens"].shape[0]:
                a_grams, g_grams, loss = local_grams(state, batch, rows)
            else:
                a_grams, g_grams, loss = _no_rows(cfg, specs, state,
                                                  data_mesh)
            a_grams, g_grams, loss = _reduce_grams(a_grams, g_grams, loss,
                                                   specs, data_mesh, w)
        kstate2 = kfac.update_factors(state.kfac, a_grams, g_grams, kcfg)
        return dataclasses.replace(state, kfac=kstate2), {"stats_loss": loss}

    return stats_step


def _share(batch, data_mesh, weight, rows):
    """``(weight, rows)`` of a statistics pass on ``data_mesh``: this
    rank's share of the subsample's rows (default an even split) and the
    whole subsample's rows (default this rank's times the data ranks)."""
    n_data = mesh_ndev(data_mesh)
    w = 1.0 / n_data if weight is None else weight
    if rows is None:
        rows = batch["tokens"].shape[0] * n_data
    return w, rows


def _no_rows(cfg, specs, state: TrainState, data_mesh):
    """A rank holding none of a statistics pass's rows: zero Grams and
    loss, and its zero part of the MoE queues' gathers."""
    fac = state.kfac.factors
    if model_module(cfg) is lm:
        lm.join_moe_queues(cfg, state.params, data_mesh)
    a_names = [n for n in specs if specs[n].share_a_with is None]
    return ({n: torch.zeros_like(fac[n]["A"]) for n in a_names},
            {n: torch.zeros_like(fac[n]["G"]) for n in specs},
            torch.zeros((), device=fac[a_names[0]]["A"].device))


def _reduce_grams(a_grams, g_grams, loss, specs, data_mesh, w: float):
    """The global subsample's Grams and loss from this rank's, at its
    share ``w``: A at ``w`` (the experts' A parts, over the global
    queue's slots, at 1), G at ``w * w``, the loss at ``w``; one
    reduction."""
    a_names = [n for n in specs if specs[n].share_a_with is None]
    red = reduce_shares(
        [a_grams[n] for n in a_names] + [g_grams[n] for n in specs]
        + [loss], data_mesh,
        [1.0 if specs[n].cap_tokens else w for n in a_names]
        + [w * w] * len(specs) + [w])
    return (dict(zip(a_names, red[:len(a_names)])),
            dict(zip(specs, red[len(a_names):-1])), red[-1])


def make_smw_step(cfg, kcfg: KFACConfig,
                  scfg: smw_mod.SMWConfig | None = None, *, data_mesh=None,
                  shards=None, mesh=None) -> Callable:
    """SU + incremental INV in one step: rank-k stats, factor EMA, SMW
    inverse update and the drift probe: ``(state, batch, weight=None,
    rows=None) -> (state, metrics)``.

    The taps are those of :func:`make_stats_step`, but the model
    collects the blocked token columns (``collect="cols"``);
    ``kfac.stats_rank_k`` keeps the factor EMA bitwise that of the
    Gram path and exposes the columns the Woodbury update takes. As in
    :func:`make_stats_step`, the columns are collected at
    ``kcfg.block_size`` (the reference collects at ``cfg.soi_block``
    and so fails on the full qwen1.5-0.5b at ``--block-size 128``).
    Metrics carry ``smw_drift`` for the host gate
    (``solve.async_refresh.SMWRefresher``).

    ``data_mesh``, ``weight``, ``rows`` and ``shards`` as in
    :func:`make_stats_step` (under pipeline parallelism the columns come
    from the statistics pass through the stages): the Grams are reduced
    as there, and the columns made the global subsample's
    (``solve.smw.gather_cols``), so that every data rank's update is the
    one-device update of its blocks. ``mesh``: the whole mesh, over which
    the drift is MAX-reduced (``solve.smw.reduce_drift``), so that every
    rank's gate falls back on the same steps."""
    scfg = scfg or smw_mod.SMWConfig()
    specs = kfac_specs(cfg, shards)
    mod = model_module(cfg)
    queued = {n for n, sp in specs.items() if sp.cap_tokens}

    def local_cols(state: TrainState, batch, rows):
        taps = build_taps(cfg, specs, batch, rows)

        def loss_with_taps(p, tp, bt):
            return mod.loss_fn(cfg, p, bt, taps=tp, collect="cols",
                               soi_block=kcfg.block_size)

        with bound(shards, data_mesh):
            if not isinstance(shards, sharding.StageShards):
                return kfac.stats_rank_k(loss_with_taps, state.params, taps,
                                         batch, specs, kcfg.block_size)
            from repro_torch.pipeline.schedule import stats_pass

            loss, acts, tap_grads = stats_pass(
                cfg, shards, state.params, taps, batch, kcfg.block_size,
                collect="cols")
            return (*kfac.rank_k_of(acts, tap_grads, specs,
                                    kcfg.block_size), loss)

    def no_cols(state: TrainState, batch, rows):
        # a rank holding none of the rows: zero Grams, and columns of its
        # zero tokens (the queues' slots, of the whole subsample)
        a_grams, g_grams, loss = _no_rows(cfg, specs, state, data_mesh)
        taps = build_taps(cfg, specs, batch, rows)
        cols = {}
        for n in specs:
            k = taps[n].shape[-2]
            cols[n] = {side: f.new_zeros(f.shape[:-2] + (k, f.shape[-1]))
                       for side, f in state.kfac.factors[n].items()}
        return a_grams, g_grams, cols, loss

    def smw_step(state: TrainState, batch, weight=None, rows=None):
        ks = None
        if data_mesh is None:
            a_grams, g_grams, cols, loss = local_cols(state, batch, None)
        else:
            w, rows = _share(batch, data_mesh, weight, rows)
            a_grams, g_grams, cols, loss = (
                local_cols if batch["tokens"].shape[0] else no_cols)(
                    state, batch, rows)
            a_grams, g_grams, loss = _reduce_grams(a_grams, g_grams, loss,
                                                   specs, data_mesh, w)
            cols, ks = smw_mod.gather_cols(cols, data_mesh, w, scfg.rank,
                                           queued)
        kstate2 = kfac.update_factors(state.kfac, a_grams, g_grams, kcfg)
        new_inv, drift = smw_mod.smw_refresh(
            kstate2.inverses, kstate2.factors, cols, kcfg, scfg, ks=ks)
        if mesh is not None and mesh_ndev(mesh) > 1:
            drift = smw_mod.reduce_drift(drift, mesh)
        kstate2 = dataclasses.replace(kstate2, inverses=new_inv)
        return (dataclasses.replace(state, kfac=kstate2),
                {"stats_loss": loss, "smw_drift": drift})

    return smw_step


def make_inv_refresh(cfg, kcfg: KFACConfig, *, mesh=None,
                     distributed: bool = False, plan: Plan | None = None,
                     pdiv_cap_bs: int | None = None,
                     shards=None) -> Callable:
    """``refresh(factors, out=None) -> inverses``: the paper's
    composed-precision INV of every SOI block through
    ``solve.block_solver.invert_factor_tree`` (the ``neumann_inv`` kernel
    on CUDA, one launch a block side); ``out`` is an inverse tree to
    write into.

    ``distributed`` on a ``mesh`` of several ranks routes through the
    block-parallel solver: a plan for ``mesh_ndev(mesh)`` devices (capped
    at ``pdiv_cap_bs``) is built once, from the factor shapes of the
    first call, and each rank inverts about ``1/ndev`` of the blocks, the
    shards gathered. Otherwise, as in the reference, the refresh is the
    replicated one. ``plan`` routes the refresh through a plan the caller
    built, such as ``make_plan(factors, 1, kcfg, pdiv_cap_bs=128)``, which
    sends blocks above its cap through ``solve.pdiv``, as the reference's
    plan does; on a distributed mesh it takes the place of the built one,
    under ``invert_factor_tree``'s rules (a plan for another rank count
    raises ``ValueError``, a one-device plan runs replicated). Without
    one, ``neumann_inv`` takes every block whole, up to 1024 (its one-CTA
    route up to 128, its large route above).

    Under ``shards`` (a ``(data, model)`` ``mesh``, the factors this
    rank's blocks) ``distributed`` inverts each block of the full factor
    tree on exactly one rank, as the reference's plan over every mesh
    axis does: the replicated leaves (the A side of a column-parallel
    weight, the G side of a row-parallel one, every side of an unsliced
    one) on a plan over the whole mesh, the model-sliced leaves on a plan
    over the data ranks of the rank's model column (``mesh["data"]``):
    two grouped calls, each gathered over its own mesh."""
    del cfg
    if distributed and shards is not None:
        return _split_refresh(kcfg, mesh, shards)
    dist_mesh = mesh if (distributed and mesh is not None
                         and mesh_ndev(mesh) > 1) else None
    built = {"plan": plan}

    def refresh(factors, out=None):
        if dist_mesh is None:
            return invert_factor_tree(factors, kcfg, plan=plan, out=out)
        if built["plan"] is None:
            built["plan"] = make_plan(factors, mesh_ndev(dist_mesh), kcfg,
                                      pdiv_cap_bs=pdiv_cap_bs)
        return invert_factor_tree(factors, kcfg, mesh=dist_mesh,
                                  plan=built["plan"], out=out)

    return refresh


def _split_refresh(kcfg: KFACConfig, mesh, shards) -> Callable:
    """:func:`make_inv_refresh`'s tensor-parallel ``distributed``
    refresh."""
    parts = ((mesh, lambda d: d is None),
             (mesh[DATA], lambda d: d is not None))
    plans: dict = {}

    def refresh(factors, out=None):
        res: dict = {}
        for i, (sub, pick) in enumerate(parts):
            tree = {n: {s: f for s, f in d.items()
                        if pick(shards.factor_dim(n, s, f.ndim))}
                    for n, d in factors.items()}
            tree = {n: d for n, d in tree.items() if d}
            if not tree:
                continue
            if i not in plans:
                plans[i] = make_plan(tree, mesh_ndev(sub), kcfg)
            got = invert_factor_tree(
                tree, kcfg, mesh=sub, plan=plans[i],
                out=None if out is None else {n: out[n] for n in tree})
            for n, d in got.items():
                res.setdefault(n, {}).update(d)
        return {n: {s + "_inv": res[n][s + "_inv"] for s in d}
                for n, d in factors.items()}

    return refresh


def make_inv_step(cfg, kcfg: KFACConfig, *, mesh=None,
                  distributed: bool = False) -> Callable:
    """``state -> state`` with every inverse refreshed from the state's
    factors (:func:`make_inv_refresh` on a whole state)."""
    refresh = make_inv_refresh(cfg, kcfg, mesh=mesh, distributed=distributed)

    def inv_step(state: TrainState) -> TrainState:
        kst = state.kfac
        return dataclasses.replace(state, kfac=dataclasses.replace(
            kst, inverses=refresh(kst.factors)))

    return inv_step


def make_sgd_step(cfg, lr: float = 1e-2, momentum: float = 0.9, *,
                  data_mesh=None, shards=None) -> Callable:
    """First-order baseline (the paper's GPU-1st / PipeLayer side):
    heavy-ball SGD on the whole batch, ``state = (params, momentum)``,
    ``m <- momentum m + g`` and ``p <- p - lr m``. ``data_mesh`` and
    ``shards`` as in :func:`make_train_step`: the loss and gradients
    are the global batch's, reduced over the data ranks, and the params
    this rank's model slices."""

    def sgd_step(state, batch):
        params, mom = state
        with bound(shards, data_mesh):
            loss, grads = _grads(cfg, params, batch)
        if data_mesh is not None:
            w = 1.0 / mesh_ndev(data_mesh)
            order = kfac.tree_order(grads)
            red = reduce_shares([grads[k] for k in order] + [loss],
                                data_mesh, [w] * (len(order) + 1))
            grads, loss = dict(zip(order, red[:-1])), red[-1]
        mom2 = {k: momentum * mom[k] + grads[k] for k in params}
        params2 = {k: params[k] - lr * mom2[k] for k in params}
        return (params2, mom2), {"loss": loss}

    return sgd_step


def make_prefill_step(cfg) -> Callable:
    """``prefill_step(params, batch, cache) -> (logits, cache)``."""
    mod = model_module(cfg)

    def prefill_step(params, batch, cache):
        return mod.prefill(cfg, params, batch, cache)

    return prefill_step


def make_decode_step(cfg) -> Callable:
    """``decode_step(params, token, cache) -> (logits, cache)``."""
    mod = model_module(cfg)

    def decode_step(params, token, cache):
        return mod.decode_step(cfg, params, token, cache)

    return decode_step
