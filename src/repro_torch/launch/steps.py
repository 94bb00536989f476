"""Step builders for single-device K-FAC training and serving
(counterpart of ``repro.launch.steps``).

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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import kfac
from repro_torch.core.kfac import KFACConfig, KFACState
from repro_torch.models import lm, whisper
from repro_torch.solve import smw as smw_mod
from repro_torch.solve.block_solver import invert_factor_tree
from repro_torch.solve.partition import Plan, make_wu_plan


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    kfac: KFACState


def model_module(cfg):
    return whisper if cfg.family == "audio" else lm


def kfac_specs(cfg):
    return model_module(cfg).kfac_specs(cfg)


def enc_len_for(cfg, seq: int) -> int:
    """Whisper's frame count for a decoder length ``seq`` (the real
    model takes 1500 frames; the assigned seq is kept on the decoder
    side)."""
    del cfg
    return min(1500, seq)


def init_params(cfg, *, generator: torch.Generator, device):
    return model_module(cfg).init(cfg, generator=generator, device=device)


def make_wu_plan_for(cfg, state: TrainState):
    """Pooled WU plan for this model, from the state's factor shapes."""
    return make_wu_plan(kfac_specs(cfg), state.kfac.factors)


def build_taps(cfg, specs, batch) -> Dict[str, torch.Tensor]:
    """Zero taps for one stats batch, ready to take gradients. The audio
    family counts rows per name: the encoder's taps and the
    cross-attention's ``wk``/``wv`` (their outputs are over the encoder's
    frames) see ``b x t_enc`` rows, the decoder's other taps ``b x t``.
    (The reference sizes every ``dec/`` tap ``b x t``, which agrees only
    while ``t_enc == t``.)"""
    b, t = batch["tokens"].shape
    device = batch["tokens"].device
    if cfg.family != "audio":
        return lm.build_taps(cfg, specs, b * t, device=device)
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
    """Rows ``lo:hi`` of every batch leaf: the batch dim is the first
    one, except for M-RoPE ``positions`` (3, B, T), where it is the
    second."""
    return {k: (v[:, lo:hi] if k == "positions" and v.ndim == 3
                else v[lo:hi]) for k, v in batch.items()}


def make_train_step(cfg, kcfg: KFACConfig, wu_plan=None,
                    use_kernel: bool = False,
                    timer: Callable | None = None) -> Callable:
    """One FP+BP+WU step ``(state, batch) -> (state, metrics)``.

    ``cfg.train_accum > 1`` splits the batch rows into that many
    microbatches and averages their loss and gradients. ``wu_plan``
    routes the WU through the pooled program and ``use_kernel`` that
    program through the ``fused_precond`` kernel. ``timer(name, fn)``,
    if given, runs the WU as ``timer("wu", fn)``."""
    specs = kfac_specs(cfg)
    accum = max(cfg.train_accum, 1)
    timer = timer or (lambda name, fn: fn())

    def train_step(state: TrainState, batch):
        if accum == 1:
            loss, grads = _grads(cfg, state.params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % accum:
                raise ValueError(f"batch {b} does not split into "
                                 f"train_accum={accum} microbatches")
            mb = b // accum
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in state.params.items()}
            for i in range(accum):
                part = batch_rows(batch, i * mb, (i + 1) * mb)
                l_i, g_i = _grads(cfg, state.params, part)
                grads = {k: grads[k] + g_i[k].to(torch.float32) / accum
                         for k in grads}
                loss = loss + l_i / accum
        params2, kstate2 = timer("wu", lambda: kfac.apply_updates(
            state.params, grads, state.kfac, specs, kcfg, wu_plan=wu_plan,
            use_kernel=use_kernel))
        gnorm = torch.sqrt(sum(
            torch.sum(torch.square(grads[k].to(torch.float32)))
            for k in kfac.tree_order(grads)))
        return TrainState(params2, kstate2), {"loss": loss,
                                              "grad_norm": gnorm}

    return train_step


def make_stats_step(cfg, kcfg: KFACConfig) -> Callable:
    """SU: factor Grams from one tapped fwd+bwd, EMA'd into the state.

    The model collects its A-Grams at ``kcfg.block_size``, the factors'
    block size. (The reference collects at ``cfg.soi_block`` and so
    fails on any config whose ``soi_block`` exceeds the K-FAC block
    size, e.g. the full qwen1.5-0.5b at ``--block-size 128``.)"""
    specs = kfac_specs(cfg)
    mod = model_module(cfg)

    def stats_step(state: TrainState, batch):
        taps = build_taps(cfg, specs, batch)

        def loss_with_taps(p, tp, bt):
            return mod.loss_fn(cfg, p, bt, taps=tp, collect=True,
                               soi_block=kcfg.block_size)

        a_grams, g_grams, loss = kfac.stats_grams(
            loss_with_taps, state.params, taps, batch, specs,
            kcfg.block_size)
        kstate2 = kfac.update_factors(state.kfac, a_grams, g_grams, kcfg)
        return dataclasses.replace(state, kfac=kstate2), {"stats_loss": loss}

    return stats_step


def make_smw_step(cfg, kcfg: KFACConfig,
                  scfg: smw_mod.SMWConfig | None = None) -> Callable:
    """SU + incremental INV in one step: rank-k stats, factor EMA, SMW
    inverse update and the drift probe.

    The taps are those of :func:`make_stats_step`, but the model
    collects the blocked token columns (``collect="cols"``);
    ``kfac.stats_rank_k`` keeps the factor EMA bitwise that of the
    Gram path and exposes the columns the Woodbury update takes. As in
    :func:`make_stats_step`, the columns are collected at
    ``kcfg.block_size`` (the reference collects at ``cfg.soi_block``
    and so fails on the full qwen1.5-0.5b at ``--block-size 128``).
    Metrics carry ``smw_drift`` for the host gate
    (``solve.async_refresh.SMWRefresher``)."""
    scfg = scfg or smw_mod.SMWConfig()
    specs = kfac_specs(cfg)
    mod = model_module(cfg)

    def smw_step(state: TrainState, batch):
        taps = build_taps(cfg, specs, batch)

        def loss_with_taps(p, tp, bt):
            return mod.loss_fn(cfg, p, bt, taps=tp, collect="cols",
                               soi_block=kcfg.block_size)

        a_grams, g_grams, cols, loss = kfac.stats_rank_k(
            loss_with_taps, state.params, taps, batch, specs,
            kcfg.block_size)
        kstate2 = kfac.update_factors(state.kfac, a_grams, g_grams, kcfg)
        new_inv, drift = smw_mod.smw_refresh(
            kstate2.inverses, kstate2.factors, cols, kcfg, scfg)
        kstate2 = dataclasses.replace(kstate2, inverses=new_inv)
        return (dataclasses.replace(state, kfac=kstate2),
                {"stats_loss": loss, "smw_drift": drift})

    return smw_step


def make_inv_refresh(cfg, kcfg: KFACConfig, *, distributed: bool = False,
                     plan: Plan | None = None,
                     pdiv_cap_bs: int | None = None) -> Callable:
    """``refresh(factors, out=None) -> inverses``: the paper's
    composed-precision INV of every SOI block through
    ``solve.block_solver.invert_factor_tree`` (the ``neumann_inv`` kernel
    on CUDA, one launch a block side); ``out`` is an inverse tree to
    write into.

    ``distributed`` asks for the block-parallel solver, and
    ``pdiv_cap_bs`` for the cap of the plan it builds. As in the
    reference, that plan is built for a mesh of several devices only, so
    on one device (the port's only) the refresh is the replicated one.
    ``plan`` routes the refresh through a plan the caller built, such as
    ``make_plan(factors, 1, kcfg, pdiv_cap_bs=128)``, which sends blocks
    above the kernel's 128 through ``solve.pdiv``."""
    del cfg, distributed, pdiv_cap_bs

    def refresh(factors, out=None):
        return invert_factor_tree(factors, kcfg, plan=plan, out=out)

    return refresh


def make_inv_step(cfg, kcfg: KFACConfig, *,
                  distributed: bool = False) -> Callable:
    """``state -> state`` with every inverse refreshed from the state's
    factors (:func:`make_inv_refresh` on a whole state)."""
    refresh = make_inv_refresh(cfg, kcfg, distributed=distributed)

    def inv_step(state: TrainState) -> TrainState:
        kst = state.kfac
        return dataclasses.replace(state, kfac=dataclasses.replace(
            kst, inverses=refresh(kst.factors)))

    return inv_step


def make_sgd_step(cfg, lr: float = 1e-2, momentum: float = 0.9) -> Callable:
    """First-order baseline (the paper's GPU-1st / PipeLayer side):
    heavy-ball SGD on the whole batch, ``state = (params, momentum)``,
    ``m <- momentum m + g`` and ``p <- p - lr m``."""

    def sgd_step(state, batch):
        params, mom = state
        loss, grads = _grads(cfg, params, batch)
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
