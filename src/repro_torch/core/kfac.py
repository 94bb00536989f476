"""K-FAC second-order optimizer with composed-precision block inversion
(counterpart of ``repro.core.kfac``, single device).

Paper mapping (RePAST Sec. II-A, V-A):
  SU  -> :func:`stats_grams` + :func:`update_factors` (factor Grams via
         taps, EMA'd into the running factors); :func:`stats_rank_k`
         also returns the rank-k columns for the SMW refresh;
  INV -> :func:`refresh_inverses`, every diagonal block through the
         ``neumann_inv`` kernel (``kernels.ops``) on the composed method,
         one launch for all the blocks of one side;
  WU  -> :func:`precondition` + :func:`apply_updates`
         (``dW = A^{-1} (dL/dW) G^{-1}``, Eqn. 3), pooled over the WU
         plan's tiles and, with ``use_kernel``, through the
         ``fused_precond`` kernel.

Factor gradients come from taps: zero tensors added to every factored
linear's output whose gradients (``torch.autograd.grad``) are the
per-token output gradients. Parameters, grads, factors and inverses are
flat dicts keyed by parameter path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Tuple

import torch

from repro_torch.core import quantize, soi
from repro_torch.core.soi import LinearSpec
from repro_torch.dist.sharding import leaf_sum
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class KFACConfig:
    lr: float = 3e-2
    momentum: float = 0.9
    damping: float = 0.03           # relative Tikhonov (of mean block trace)
    ema_decay: float = 0.95         # factor EMA
    block_size: int = 1024          # paper's INV-crossbar group limit
    stats_every: int = 10           # SU cadence (paper: 10 batches)
    inv_every: int = 10             # inverse refresh cadence
    stats_batch: int = 8            # SU subsample: sequences per pass
    stats_seq: int = 1024           # SU subsample: tokens per sequence
    kl_clip: float = 1.0            # trust-region scale clip
    # "composed" = paper scheme (NS + Neumann + refine), "composed_fast"
    # = without the Neumann stage, "exact" = linalg baseline
    inv_method: str = "composed"
    ns_iters: int = 20
    taylor_terms: int = 4
    refine_steps: int = 2
    weight_decay: float = 0.0
    # WU product precision (quantize.precision_kind): fp32 | hilo |
    # int8 | int<T>b<S>
    precision: str = "fp32"
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8


@dataclasses.dataclass
class KFACState:
    """Optimizer state. ``step`` is a host int (the cadence branches on
    it without a device read). Moments exist per update path: factored
    leaves carry heavy-ball ``momentum``, the others Adam's
    ``adam_mu``/``adam_nu``."""

    step: int
    factors: Dict[str, Dict[str, torch.Tensor]]
    inverses: Dict[str, Dict[str, torch.Tensor]]
    momentum: Dict[str, torch.Tensor]
    adam_mu: Dict[str, torch.Tensor]
    adam_nu: Dict[str, torch.Tensor]


def tree_order(names) -> list:
    """Parameter paths in the reference's pytree order (sorted nested
    dict keys), which fixes the trust-region dot's summation order."""
    return sorted(names, key=lambda k: k.split("/"))


def init(params: Mapping[str, torch.Tensor],
         specs: Mapping[str, LinearSpec], cfg: KFACConfig) -> KFACState:
    device = next(iter(params.values())).device
    return KFACState(
        step=0,
        factors=soi.init_factors(specs, cfg.block_size, device=device),
        inverses=soi.init_inverses(specs, cfg.block_size, device=device),
        momentum={k: torch.zeros_like(p) for k, p in params.items()
                  if k in specs},
        adam_mu={k: torch.zeros_like(p) for k, p in params.items()
                 if k not in specs},
        adam_nu={k: torch.zeros_like(p) for k, p in params.items()
                 if k not in specs},
    )


# ---------------------------------------------------------------------------
# SU: factor statistics
# ---------------------------------------------------------------------------

def _stats_pass(loss_with_taps: Callable, params,
                taps: Dict[str, torch.Tensor], batch):
    """The tapped fwd+bwd: ``(loss, acts, tap_grads)``."""
    names = list(taps)
    with torch.enable_grad():
        loss, acts = loss_with_taps(params, taps, batch)
        tap_grads = dict(zip(names, torch.autograd.grad(
            loss, [taps[n] for n in names])))
    return loss.detach(), acts, tap_grads


def stats_grams(loss_with_taps: Callable, params, taps: Dict[str, torch.Tensor],
                batch, specs: Mapping[str, LinearSpec], bs: int):
    """One SU pass: ``(A_grams, G_grams, loss)``.

    ``loss_with_taps(params, taps, batch) -> (loss, acts)`` where
    ``acts[name]`` is the input activations (*stack, T, d_in) or an
    already blocked Gram (*stack, nb, bs, bs). ``taps`` require grad."""
    loss, acts, tap_grads = _stats_pass(loss_with_taps, params, taps,
                                        batch)
    a_grams, g_grams = grams_of(acts, tap_grads, specs, bs)
    return a_grams, g_grams, loss


def grams_of(acts, tap_grads, specs: Mapping[str, LinearSpec], bs: int):
    """``(A_grams, G_grams)`` of one SU pass's ``acts`` and tap gradients
    (:func:`stats_grams`; the pipeline's statistics pass gives its
    stage's)."""
    a_grams, g_grams = {}, {}
    for name, spec in specs.items():
        bi, bo = soi.spec_blocks(spec, bs)
        g = tap_grads[name]                        # (*stack, T, d_out)
        # Fisher convention: G = E_t[g g^T] * T
        g_grams[name] = soi.blocked_gram(g, bs, bo) * g.shape[-2]
        if spec.share_a_with is None:
            a = acts[name]
            if (a.ndim == len(spec.stack) + 3
                    and a.shape[-1] == a.shape[-2]):
                a_grams[name] = a                  # already a blocked Gram
            else:
                a_grams[name] = soi.blocked_gram(a, bs, bi)
    return a_grams, g_grams


def stats_rank_k(loss_with_taps: Callable, params,
                 taps: Dict[str, torch.Tensor], batch,
                 specs: Mapping[str, LinearSpec], bs: int):
    """SU pass that also returns the rank-k column factors:
    ``(A_grams, G_grams, cols, loss)``.

    The model must collect with ``collect="cols"``: ``acts[name]`` is
    then ``soi.blocked_tokens`` (*stack, T, nb, bs). ``cols[name][side]``
    is (*stack, nb, k, bs) with k the subsample's tokens, and each
    block's Gram contribution is ``V^T V * w`` with ``w = 1/k`` for A
    (token-mean Gram) and ``w = 1`` for G (Fisher sum over tokens),
    the convention ``solve.smw`` relies on. The Grams are bitwise those
    of :func:`stats_grams` on the same inputs, so the factor EMA does
    not depend on which stats path ran."""
    loss, acts, tap_grads = _stats_pass(loss_with_taps, params, taps,
                                        batch)
    return (*rank_k_of(acts, tap_grads, specs, bs), loss)


def rank_k_of(acts, tap_grads, specs: Mapping[str, LinearSpec], bs: int):
    """``(A_grams, G_grams, cols)`` of one SU pass that collected the
    blocked token columns (:func:`stats_rank_k`; the pipeline's
    statistics pass gives its stage's)."""
    a_grams, g_grams, cols = {}, {}, {}
    for name, spec in specs.items():
        g = soi.blocked_tokens(tap_grads[name], bs,
                               soi.spec_blocks(spec, bs)[1])  # (*stack,T,nb,bs)
        g_grams[name] = soi.gram_from_tokens(g) * g.shape[-3]
        entry = {"G": soi.cols_from_tokens(g)}
        if spec.share_a_with is None:
            a = acts[name]                 # blocked tokens (*stack,T,nb,bs)
            a_grams[name] = soi.gram_from_tokens(a)
            entry["A"] = soi.cols_from_tokens(a)
        cols[name] = entry
    return a_grams, g_grams, cols


def update_factors(state: KFACState, a_grams: dict, g_grams: dict,
                   cfg: KFACConfig) -> KFACState:
    """EMA the new Grams into the running factors."""
    d = cfg.ema_decay
    new = {}
    for name, f in state.factors.items():
        nf = dict(f)
        if "A" in f and name in a_grams:
            nf["A"] = d * f["A"] + (1.0 - d) * a_grams[name]
        if name in g_grams:
            nf["G"] = d * f["G"] + (1.0 - d) * g_grams[name]
        new[name] = nf
    return dataclasses.replace(state, factors=new)


# ---------------------------------------------------------------------------
# INV: the paper's high-precision inversion of every diagonal block
# ---------------------------------------------------------------------------

def invert_blocks_grouped(flats, lams, cfg: KFACConfig, *,
                          out=None) -> list:
    """Invert leaves of (N_i, bs_i, bs_i) blocks with per-block damping
    (N_i blocks' worth, any shape), in the order given.

    The composed methods run the ``neumann_inv`` kernel (its plain
    version for CPU tensors) at ``KFACConfig``'s counts in one grouped
    call: one launch for all the leaves of one block side. ``out``: one
    preallocated fp32 buffer per leaf, shaped like it, which receives
    the inverses (and is returned)."""
    if cfg.inv_method == "exact":
        invs = [torch.linalg.inv(
            f + lam.reshape(-1, 1, 1) * torch.eye(
                f.shape[-1], dtype=f.dtype, device=f.device))
            for f, lam in zip(flats, lams)]
        if out is None:
            return invs
        for o, inv in zip(out, invs):
            o.copy_(inv)
        return list(out)
    if cfg.inv_method not in ("composed", "composed_fast"):
        raise ValueError(f"unknown inv_method {cfg.inv_method!r}")
    taylor = 1 if cfg.inv_method == "composed_fast" else cfg.taylor_terms
    return ops.neumann_inv_grouped(
        [f.contiguous() for f in flats], [lam.reshape(-1) for lam in lams],
        ns_iters=cfg.ns_iters, taylor_terms=taylor,
        refine_steps=cfg.refine_steps, out=out)


def invert_blocks_flat(flat: torch.Tensor, lam: torch.Tensor,
                       cfg: KFACConfig) -> torch.Tensor:
    """Invert a flat batch of damped blocks, (N, bs, bs) with per-block
    damping (N,): the reference's single inversion primitive, here one
    leaf of :func:`invert_blocks_grouped`, so every path (replicated,
    pooled, pdiv) inverts through the same grouped call."""
    return invert_blocks_grouped([flat], [lam], cfg)[0]


def invert_factors(factors, cfg: KFACConfig, *, out=None) -> dict:
    """``{name: {A|G: f}}`` -> ``{name: {A_inv|G_inv: inv}}``: every
    factor leaf's blocks in one grouped inversion. ``out``: an inverse
    tree of the same layout (contiguous fp32 leaves) to write into; the
    returned tree holds its tensors."""
    keys = [(name, side) for name, f in factors.items() for side in f]
    leaves = [factors[name][side] for name, side in keys]
    flats = [leaf.reshape((-1,) + tuple(leaf.shape[-2:])) for leaf in leaves]
    bufs = None if out is None else [
        out[name][side + "_inv"].view(flat.shape)
        for (name, side), flat in zip(keys, flats)]
    invs = invert_blocks_grouped(
        flats, [soi.tikhonov_damping(leaf, cfg.damping) for leaf in leaves],
        cfg, out=bufs)
    res = {name: {} for name in factors}
    for (name, side), leaf, inv in zip(keys, leaves, invs):
        res[name][side + "_inv"] = (inv.reshape(leaf.shape) if out is None
                                    else out[name][side + "_inv"])
    return res


def refresh_inverses(state: KFACState, cfg: KFACConfig, *,
                     plan=None) -> KFACState:
    """Every inverse refreshed from the state's factors. With ``plan``
    (a ``solve.partition.Plan``) through the pooled solver
    (``solve.block_solver.invert_factor_tree``), bitwise the same on
    the composed methods."""
    if plan is not None:
        from repro_torch.solve.block_solver import invert_factor_tree

        return dataclasses.replace(state, inverses=invert_factor_tree(
            state.factors, cfg, plan=plan))
    return dataclasses.replace(state,
                               inverses=invert_factors(state.factors, cfg))


# ---------------------------------------------------------------------------
# WU: preconditioning + parameter update
# ---------------------------------------------------------------------------

def inverse_pools(inverses, inv_plan) -> Dict[int, torch.Tensor]:
    """Per-``bs`` flat pools ``{bs: (M, bs, bs)}`` in the plan's pooled
    block order (the layout the WU plan's ``a_src``/``g_src`` index)."""
    pools = {}
    for g in inv_plan.groups:
        parts = [inverses[name][side + "_inv"].reshape(-1, g.bs, g.bs)
                 for name, side in g.leaves]
        pools[g.bs] = parts[0] if len(parts) == 1 else torch.cat(parts)
    return pools


def group_tiles(grads_by_name: Mapping[str, torch.Tensor], grp
                ) -> torch.Tensor:
    """One WU group's gradient tiles, its leaves' in plan order."""
    return torch.cat([soi.gather_grad_tiles(grads_by_name[l.name], l.stack,
                                            grp.bi, grp.bo)
                      for l in grp.leaves])


def scatter_group_tiles(grp, o: torch.Tensor) -> dict:
    """A WU group's tiles in plan order -> ``{leaf: (*stack, d_in,
    d_out)}``."""
    out, ofs = {}, 0
    for l in grp.leaves:
        out[l.name] = soi.scatter_grad_tiles(
            o[ofs:ofs + l.n_tiles], l.stack, l.nb_i, l.nb_o, l.d_in, l.d_out)
        ofs += l.n_tiles
    return out


def precondition_pooled(grads_by_name: Mapping[str, torch.Tensor],
                        inverses, wu_plan, use_kernel: bool = False,
                        precision: str = "fp32") -> dict:
    """Pooled WU: every factored gradient tile of one ``(bi, bo)`` group
    goes through one batched two-sided product, its A/G inverse blocks
    gathered from the per-``bs`` pools.

    ``use_kernel`` runs the pool through ``kernels.ops.fused_precond``
    (the Hopper kernel on CUDA, its plain hi/lo version on the CPU),
    which reads each tile's inverse blocks from the pools by the plan's
    ``a_src``/``g_src``: no gathered copy per tile. Its per-tile
    trust-region dots are discarded here, as in the reference, since
    :func:`apply_updates` folds the dot per leaf.
    Otherwise the tiles go through ``quantize.lowp_einsum`` at
    ``precision``. The kernel *is* the hi/lo scheme, so ``use_kernel``
    takes "fp32" and "hilo" only, and an integer-sliced precision
    raises, as in the reference."""
    kind = quantize.precision_kind(precision)
    if use_kernel and kind not in ("fp32", "hilo"):
        raise ValueError(
            f"use_kernel supports precision 'fp32'/'hilo' (the "
            f"fused_precond kernel is the hi/lo scheme), not "
            f"{precision!r}")
    pools = inverse_pools(inverses, wu_plan.inv_plan)
    out = {}
    for grp in wu_plan.groups:
        g_pool = group_tiles(grads_by_name, grp).contiguous()
        a_src, g_src = grp.src_on(g_pool.device)
        if use_kernel:
            o, _dots = ops.fused_precond(pools[grp.bi], g_pool,
                                         pools[grp.bo], a_src, g_src)
        else:
            a_sel = pools[grp.bi][a_src.long()]
            g_sel = pools[grp.bo][g_src.long()]
            tmp = quantize.lowp_einsum("nab,nbc->nac", a_sel, g_pool,
                                       precision=precision)
            o = quantize.lowp_einsum("nac,ncd->nad", tmp, g_sel,
                                     precision=precision)
        out.update(scatter_group_tiles(grp, o))
    return out


def precondition(grads: Mapping[str, torch.Tensor], state: KFACState,
                 specs: Mapping[str, LinearSpec], cfg: KFACConfig,
                 wu_plan=None, use_kernel: bool = False) -> dict:
    """``A^{-1} g G^{-1}`` for every factored gradient; the others pass
    through. With ``wu_plan`` the pooled route runs, else the per-leaf
    einsum (the reference's legacy path, kept as the parity yardstick)."""
    if wu_plan is not None:
        pooled = precondition_pooled(
            {k: g for k, g in grads.items() if k in specs},
            state.inverses, wu_plan, use_kernel=use_kernel,
            precision=cfg.precision)
        missing = set(specs) & set(grads) - set(pooled)
        if missing:
            raise ValueError(
                f"wu_plan does not cover factored leaves {sorted(missing)}; "
                f"rebuild it with make_wu_plan for the current specs")
        return {k: pooled.get(k, g) for k, g in grads.items()}
    out = {}
    for name, g in grads.items():
        if name in specs:
            a_name = specs[name].share_a_with or name
            out[name] = soi.block_precondition(
                g, state.inverses[a_name]["A_inv"],
                state.inverses[name]["G_inv"], precision=cfg.precision)
        else:
            out[name] = g
    return out


def _pooled_chain(keys, leaves_by_slot, fn, n_out):
    """Run one elementwise update chain over many leaves at once.

    ``keys``: the participating leaves; ``leaves_by_slot``: per input
    slot a dict key -> leaf (p, d, m, ...); ``fn(vec...) -> vecs`` runs
    on flat vectors. The leaves are raveled and concatenated per dtype,
    the chain runs once per dtype, and the results are split back:
    elementwise operations do not depend on position, so every output
    leaf is bitwise what the per-leaf loop computes. Returns ``n_out``
    dicts key -> updated leaf."""
    outs = [dict() for _ in range(n_out)]
    by_dtype: dict = {}
    for k in keys:
        by_dtype.setdefault(leaves_by_slot[0][k].dtype, []).append(k)
    for ks in by_dtype.values():
        vecs = [torch.cat([ins[k].reshape(-1) for k in ks])
                if len(ks) > 1 else ins[ks[0]].reshape(-1)
                for ins in leaves_by_slot]
        res = fn(*vecs)
        ofs = 0
        for k in ks:
            ref = leaves_by_slot[0][k]
            for slot in range(n_out):
                outs[slot][k] = res[slot][ofs:ofs + ref.numel()].reshape(
                    ref.shape)
            ofs += ref.numel()
    return outs


def _apply_updates_pooled(params, pre, grads, state: KFACState, specs,
                          cfg: KFACConfig, order, nu, bc1, bc2):
    """The pooled elementwise tail: one momentum chain over every
    factored leaf, one Adam chain over every other leaf."""
    fact = [k for k in order if k in specs]
    adam = [k for k in order if k not in specs]
    new_p, new_m, new_mu, new_nu = {}, {}, {}, {}
    if fact:
        def mom_chain(p, d, m):
            m2 = cfg.momentum * m + d * nu
            upd = cfg.lr * m2 + cfg.lr * cfg.weight_decay * p
            return p - upd, m2

        new_p, new_m = _pooled_chain(
            fact, (params, pre, state.momentum), mom_chain, 2)
    if adam:
        def adam_chain(p, g, mu, nvu):
            mu2 = cfg.adam_b1 * mu + (1 - cfg.adam_b1) * g
            nu2 = cfg.adam_b2 * nvu + (1 - cfg.adam_b2) * g * g
            mhat = mu2 / bc1
            nhat = nu2 / bc2
            return p - cfg.lr * mhat / (torch.sqrt(nhat) + cfg.adam_eps), \
                mu2, nu2

        got_p, new_mu, new_nu = _pooled_chain(
            adam, (params, grads, state.adam_mu, state.adam_nu),
            adam_chain, 3)
        new_p.update(got_p)
    return new_p, new_m, new_mu, new_nu


def apply_updates(params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: KFACState,
                  specs: Mapping[str, LinearSpec], cfg: KFACConfig,
                  wu_plan=None, use_kernel: bool = False,
                  pool_elementwise: bool = False, shards=None,
                  info: dict | None = None) -> Tuple[dict, KFACState]:
    """Trust-region-clipped update: factored params take the
    preconditioned direction with heavy-ball momentum, the others Adam.

    The clip scale ``nu = min(1, kl_clip / (lr |sum(d * g)|))`` sums
    the factored leaves' dots in the reference's leaf order; under
    ``shards`` (``dist.sharding.ModelShards``: the params are this
    rank's model slices) the sliced leaves' partial dots are summed over
    the model ranks and the replicated leaves counted once
    (``sharding.leaf_sum``), so every rank clips with the same ``nu``.
    ``info``, if given, receives ``nu``. With
    ``wu_plan``, ``pool_elementwise`` runs the momentum and Adam updates
    as one chain each over the concatenated leaves (bitwise the per-leaf
    loop; off by default, as in the reference: the concatenation costs
    about four more passes over the moments). Returns new dicts; the
    inputs are not modified."""
    pre = precondition(grads, state, specs, cfg, wu_plan=wu_plan,
                       use_kernel=use_kernel)
    dev = next(iter(params.values())).device
    order = tree_order(params)
    terms = [(k, torch.sum(pre[k] * grads[k])) for k in order if k in specs]
    dot = leaf_sum(terms, shards) if terms else torch.zeros((), device=dev)
    nu = torch.clamp(cfg.kl_clip / (cfg.lr * torch.abs(dot) + 1e-12),
                     max=1.0)
    if info is not None:
        info["nu"] = nu

    step = state.step + 1
    stepf = torch.tensor(float(step), dtype=torch.float32, device=dev)
    bc1 = 1 - torch.tensor(cfg.adam_b1, dtype=torch.float32,
                           device=dev) ** stepf
    bc2 = 1 - torch.tensor(cfg.adam_b2, dtype=torch.float32,
                           device=dev) ** stepf

    if wu_plan is not None and pool_elementwise:
        new_p, new_m, new_mu, new_nu = _apply_updates_pooled(
            params, pre, grads, state, specs, cfg, order, nu, bc1, bc2)
        state2 = dataclasses.replace(
            state, step=step,
            momentum={k: new_m[k] for k in order if k in specs},
            adam_mu={k: new_mu[k] for k in order if k not in specs},
            adam_nu={k: new_nu[k] for k in order if k not in specs})
        return {k: new_p[k] for k in params}, state2

    new_p, new_m, new_mu, new_nu = {}, {}, {}, {}
    for k in order:
        p, d, g = params[k], pre[k], grads[k]
        if k in specs:
            m2 = cfg.momentum * state.momentum[k] + d * nu
            upd = cfg.lr * m2 + cfg.lr * cfg.weight_decay * p
            new_p[k] = p - upd
            new_m[k] = m2
        else:
            # the reference's expressions, their temporaries written in
            # place (the same operations in the same order: the same
            # bits) so that a vocab-sized leaf holds fewer copies at once
            mu2 = (cfg.adam_b1 * state.adam_mu[k]).add_(
                (1 - cfg.adam_b1) * g)
            nu2 = (cfg.adam_b2 * state.adam_nu[k]).add_(
                ((1 - cfg.adam_b2) * g).mul_(g))
            den = torch.sqrt(nu2 / bc2).add_(cfg.adam_eps)
            new_p[k] = p - (mu2 / bc1).mul_(cfg.lr).div_(den)
            new_mu[k] = mu2
            new_nu[k] = nu2
    state2 = dataclasses.replace(state, step=step, momentum=new_m,
                                 adam_mu=new_mu, adam_nu=new_nu)
    return {k: new_p[k] for k in params}, state2
