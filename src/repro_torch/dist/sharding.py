"""Name-pattern sharding rules for params, K-FAC state and batches, as
pure spec functions (counterpart of ``repro.dist.sharding``).

A spec is a tuple with one entry per dim: None, an axis name, or a tuple
of axis names, cleaned for a mesh by :func:`repro_torch.dist.api.clean_spec`
(dims that do not divide degrade to replication). The layout scheme is
the reference's:

* **column-parallel** linears (wq/wk/wv, wg/wu, w1, the SSM and RG-LRU
  input projections, img_proj): ``(*stack, d_in/'data', d_out/'model')``;
* **row-parallel** linears (wo, wd, w2, out_proj, out): the transpose;
* **MoE expert weights** put the expert dim on ``model``;
* ``embed (V, D) -> ('model', 'data')``, ``lm_head (D, V) -> ('data',
  'model')``; 1-D params replicate; scanned stacks ride ``stage``;
* **K-FAC factors** ``(*stack, nb, bs, bs)``: the block-index dim
  follows the mesh axis of the weight dim it preconditions (A -> d_in's,
  G -> d_out's), the image of "each SOI block on its own INV crossbar
  group".

These specs are the reference's GSPMD layout, which also shards weights
over ``data``; PyTorch has no partitioner to insert the collectives that
layout needs, so the port does not place tensors by them. Tensor
parallelism (``--model-parallel``) follows instead the layout of the
reference's explicit program, where the collectives are written by hand
(``repro.pipeline.schedule._model_spec_dim``): :func:`model_spec_dim`
slices q/k/v (and their biases) by columns and ``wo`` by rows when both
head counts divide the model ranks, the MLP's ``wg``/``wu`` by columns
and ``wd`` by rows when ``d_ff`` does, the MoE experts on their expert
dim when ``n_experts`` does (expert parallelism), and replicates
everything else, with one more gate: a slice must hold whole K-FAC
blocks of the full leaf, so that every factor block, its inverse and
its WU tiles live on one rank. (An expert slice holds whole experts,
and so whole factor stacks.) :class:`ModelShards` is one rank's layout;
:func:`local_specs`, :func:`local_params`/:func:`full_params` and
:func:`local_factors`/:func:`full_factors` carry specs, parameter-shaped
trees and factor trees between the full model and a rank's slices.
Pipeline parallelism (``--pp``) follows the reference's stage program:
:class:`StageShards` is a stage rank's layout (its atoms of each scanned
stack, with the model slices inside the stage), and
:func:`stage_local_params`/:func:`stage_full_params` and
:func:`stage_local_factors`/:func:`stage_full_factors` cut and gather
over the stage ranks, the uneven atom counts padded for the gather.
:func:`leaf_sum` totals per-leaf scalars under either layout. The
reference's cache and pool shardings wait for serving on a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core import soi
from repro_torch.dist.api import (
    BATCH_AXES,
    DATA,
    MODEL,
    STAGE,
    all_gather_rows,
    all_reduce,
    axis_sizes,
    clean_spec,
    mesh_axes,
    mesh_position,
)

# trailing path component -> parallelism class
_COL = {
    "wq", "wk", "wv",                    # attention inputs
    "wg", "wu", "w1",                    # MLP up/gate
    "in_proj", "x_proj", "dt_proj",      # mamba
    "in_x", "in_gate", "w_a", "w_x",     # rg-lru
    "img_proj",                          # VLM frontend
}
_ROW = {"wo", "wd", "w2", "out_proj", "out"}

_MOE_EXPERT = {"wg", "wu", "wd"}


def _param_pspec(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Spec of the weight at path ``name`` with ``ndim`` dims. The leading
    dim of a scanned stack (``layers/``, ``units/``, ``enc/``, ``dec/``)
    rides ``stage``; other stack dims replicate, except the MoE expert
    dim, which rides ``model``."""
    base = name.rsplit("/", 1)[-1]

    def staged(spec: Tuple[Optional[str], ...]):
        stacked = name.startswith(("layers/", "units/", "enc/", "dec/"))
        if stacked and ndim >= 2 and spec[0] is None:
            return (STAGE,) + spec[1:]
        return spec

    if ndim < 2:
        return (None,) * ndim
    if "moe/" in name and base in _MOE_EXPERT and ndim >= 3:
        lead = (None,) * (ndim - 3)
        if base in _ROW:
            return staged(lead + (MODEL, None, DATA))
        return staged(lead + (MODEL, DATA, None))
    if base == "embed":
        two = (MODEL, DATA)
    elif base == "lm_head" or base in _COL:
        two = (DATA, MODEL)
    elif base in _ROW:
        two = (MODEL, DATA)
    else:
        return staged((None,) * ndim)
    return staged((None,) * (ndim - 2) + two)


def _factor_pspec(shape: Tuple[int, ...], side: str,
                  name: str) -> Tuple[Optional[str], ...]:
    """Spec of one K-FAC factor or inverse ``(*stack, nb, bs, bs)``;
    ``side`` is "A"(_inv) or "G"(_inv)."""
    stack = shape[:-3]
    wspec = _param_pspec(name, len(stack) + 2)
    ax = wspec[-2] if side.startswith("A") else wspec[-1]
    return tuple(wspec[:-2]) + (ax, None, None)


def param_sharding(params: Dict[str, Any], mesh) -> Dict[str, tuple]:
    """``{path: spec}`` for a flat param dict (tensors, meta tensors or
    anything with a ``.shape``)."""
    return {k: clean_spec(_param_pspec(k, len(v.shape)), v.shape, mesh)
            for k, v in params.items()}


def kfac_sharding(kstate, params, mesh):
    """The spec tree of a ``KFACState`` (the state with each tensor
    replaced by its spec): factors and inverses follow
    :func:`_factor_pspec`; momentum and Adam moments follow the params,
    from each state leaf's own shape; the host step replicates."""
    del params

    def factor_tree(tree: Dict[str, Dict[str, Any]]) -> Dict:
        return {name: {k: clean_spec(_factor_pspec(tuple(v.shape), k, name),
                                     v.shape, mesh)
                       for k, v in d.items()}
                for name, d in tree.items()}

    return dataclasses.replace(
        kstate, step=(),
        factors=factor_tree(kstate.factors),
        inverses=factor_tree(kstate.inverses),
        momentum=param_sharding(kstate.momentum, mesh),
        adam_mu=param_sharding(kstate.adam_mu, mesh),
        adam_nu=param_sharding(kstate.adam_nu, mesh))


def batch_sharding(batch: Dict[str, Any], mesh) -> Dict[str, tuple]:
    """The batch dim over (pod, data); M-RoPE ``positions`` (3, B, T)
    carry the batch on dim 1."""
    out = {}
    for k, v in batch.items():
        ndim = len(v.shape)
        spec = [None] * ndim
        if k == "positions" and ndim == 3:
            spec[1] = BATCH_AXES
        elif ndim >= 1:
            spec[0] = BATCH_AXES
        out[k] = clean_spec(tuple(spec), v.shape, mesh)
    return out


def solve_pool_sharding(mesh) -> tuple:
    """Spec of the block-parallel solver's device-major pools ``(ndev, m,
    bs, bs)``: the leading dim is one row per rank over every mesh axis
    combined (``solve.block_solver`` hands each rank its own row); one
    axis is a name, several a tuple, as in every spec."""
    axes = mesh_axes(mesh)
    return (axes[0] if len(axes) == 1 else axes,)


# ---------------------------------------------------------------------------
# Tensor parallelism: the layout of the reference's explicit program
# ---------------------------------------------------------------------------

def model_spec_dim(cfg, path: str, ndim: int, mp: int,
                   block_size: int) -> Optional[int]:
    """The dim of leaf ``path`` (``ndim`` dims) that the ``model`` axis
    slices over ``mp`` ranks, or None (replicated): the reference's
    ``_model_spec_dim`` (``repro.pipeline.schedule``), gated on exact
    divisibility as there, and on whole K-FAC blocks.

    * attention q/k/v columns (and their biases) and ``wo`` rows slice
      together, when both head counts divide ``mp`` and each rank's
      share of the q and of the k/v width is whole blocks of that
      width's block size at ``block_size``
      (``soi.block_size_for``);
    * MLP ``wg``/``wu`` columns and ``wd`` rows, when ``d_ff`` divides
      ``mp`` and each share is whole blocks of ``d_ff``'s;
    * MoE experts on their expert dim when ``n_experts`` divides ``mp``
      (``models.moe`` dispatches to this rank's experts); the router
      replicated;
    * the audio family, norms, embeddings, head, and the ssm and
      RG-LRU mixers: replicated.

    Without the block gate a factor block would straddle two ranks, and
    its WU would need a gather."""
    if mp <= 1 or cfg.family == "audio":
        return None
    parts = path.split("/")
    name = parts[-1]
    if "moe" in parts:
        if name in ("wg", "wu", "wd") and cfg.n_experts % mp == 0:
            return ndim - 3
        return None

    def whole(width: int) -> bool:
        bs = soi.block_size_for(width, block_size)
        return width % mp == 0 and (width // mp) % bs == 0

    if "attn" in parts:
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        if h % mp or kv % mp or not (whole(h * hd) and whole(kv * hd)):
            return None
        if name in ("wq", "wk", "wv", "bq", "bk", "bv"):
            return ndim - 1
        return ndim - 2 if name == "wo" else None
    if "mlp" in parts and cfg.d_ff % mp == 0 and whole(cfg.d_ff):
        if name in ("wg", "wu"):
            return ndim - 1
        if name == "wd":
            return ndim - 2
    return None


@dataclasses.dataclass(frozen=True)
class ModelShards:
    """One rank's tensor-parallel layout: ``mesh`` the one-axis model
    submesh (``mp`` ranks, this one at position ``rank``), ``dims`` each
    parameter path's sliced dim (:func:`model_spec_dim`; None:
    replicated), ``block_size`` the K-FAC block cap the gate used."""

    mesh: Any
    mp: int
    rank: int
    block_size: int
    dims: Dict[str, Optional[int]]

    def factor_dim(self, name: str, side: str, ndim: int) -> Optional[int]:
        """The sliced dim of factor or inverse leaf ``side`` ("A", "G",
        "A_inv", "G_inv"; ``ndim`` dims) of linear ``name``: the block
        dim (-3) when the side it preconditions is sliced, the stack dim
        the weight's is (the experts', -4) on both sides when a stack
        dim is, else None."""
        d = self.dims.get(name)
        w = ndim - 1                      # the weight's ndim
        if d is not None and d < w - 2:
            return d - ndim
        if d is not None and d == (w - 2 if side[0] == "A" else w - 1):
            return -3
        return None


def model_shards(cfg, mesh, shapes: Mapping[str, Any],
                 block_size: int) -> Optional[ModelShards]:
    """This rank's :class:`ModelShards` on a ``(data, model)`` mesh for
    parameters of ``shapes`` (``{path: tensor or shape holder}``), or
    None when the model axis holds one rank."""
    mp = axis_sizes(mesh).get(MODEL, 1)
    if mp <= 1:
        return None
    sub = mesh[MODEL]
    return ModelShards(
        mesh=sub, mp=mp, rank=mesh_position(sub), block_size=block_size,
        dims={k: model_spec_dim(cfg, k, len(v.shape), mp, block_size)
              for k, v in shapes.items()})


def local_specs(specs: Mapping[str, soi.LinearSpec],
                shards: ModelShards) -> Dict[str, soi.LinearSpec]:
    """Each factored linear's spec on this rank: a sliced side's width
    divided by ``mp``, its block size that of the full width; a sliced
    stack dim (the experts') divided by ``mp``, the widths whole."""
    out = {}
    for name, s in specs.items():
        d = shards.dims.get(name)
        w = len(s.stack) + 2
        bi, bo = soi.spec_blocks(s, shards.block_size)
        if d is not None and d < w - 2:
            stack = list(s.stack)
            stack[d] //= shards.mp
            s = dataclasses.replace(s, stack=tuple(stack))
        elif d == w - 1:
            s = soi.SlicedSpec(**{**dataclasses.asdict(s),
                                  "d_out": s.d_out // shards.mp},
                               bs_out=bo)
        elif d == w - 2:
            s = soi.SlicedSpec(**{**dataclasses.asdict(s),
                                  "d_in": s.d_in // shards.mp}, bs_in=bi)
        out[name] = s
    return out


def _slice(t: torch.Tensor, dim: Optional[int], shards: ModelShards):
    if dim is None:
        return t
    return t.chunk(shards.mp, dim)[shards.rank].contiguous()


def _gather(t: torch.Tensor, dim: Optional[int], shards: ModelShards):
    if dim is None:
        return t
    return all_gather_rows(t.movedim(dim, 0), shards.mesh).movedim(0, dim)


def local_params(params: Mapping[str, torch.Tensor],
                 shards: ModelShards) -> Dict[str, torch.Tensor]:
    """A full parameter-shaped dict (params, momentum, Adam moments)
    sliced to this rank's shard."""
    return {k: _slice(v, shards.dims.get(k), shards)
            for k, v in params.items()}


def full_params(local: Mapping[str, torch.Tensor],
                shards: ModelShards) -> Dict[str, torch.Tensor]:
    """The full dict from every rank's slices (an ``all_gather`` over the
    model submesh a sliced leaf; every model rank calls)."""
    return {k: _gather(v, shards.dims.get(k), shards)
            for k, v in local.items()}


def local_factors(tree, shards: ModelShards) -> dict:
    """A full factor or inverse tree ``{name: {side: (*stack, nb, bs,
    bs)}}`` cut to this rank's blocks."""
    return {n: {s: _slice(t, shards.factor_dim(n, s, t.ndim), shards)
                for s, t in d.items()} for n, d in tree.items()}


def full_factors(tree, shards: ModelShards) -> dict:
    """The full factor or inverse tree from every rank's blocks."""
    return {n: {s: _gather(t, shards.factor_dim(n, s, t.ndim), shards)
                for s, t in d.items()} for n, d in tree.items()}


def leaf_sum(terms, shards=None):
    """``sum`` of per-leaf scalars ``[(path, t)]`` in order, the same
    full total on every rank. Under ``shards`` (:class:`ModelShards`) a
    sliced leaf's scalar is this rank's part: those parts are summed
    over the model ranks and added once, after the replicated leaves'
    sum. Under a :class:`StageShards` a stage-local leaf's scalar (its
    stacked atoms', or the hybrid tail's) is this stage's part, summed
    over the stage ranks, and the shared leaves' (the embedding, the
    head, the final norms: the same on every stage) are added once; the
    model slices within a stage as above."""
    if shards is None:
        return sum(t for _, t in terms)
    if isinstance(shards, StageShards):
        return _stage_leaf_sum(terms, shards)
    sliced = [t for k, t in terms if shards.dims.get(k) is not None]
    total = sum(t for k, t in terms if shards.dims.get(k) is None)
    if sliced:
        part = sum(sliced).reshape(1).clone()
        total = total + all_reduce(part, shards.mesh)[0]
    return total


# ---------------------------------------------------------------------------
# Pipeline parallelism: each stage rank holds its own atoms
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageShards:
    """One rank's pipeline layout (``--pp``): stage ``stage`` of
    ``n_stages`` (``mesh``, the one-axis ``stage`` submesh: this rank's
    pipeline), the free partition ``part`` (``pipeline.partition_stages``)
    and ``model``, the tensor-parallel layout inside the stage (None with
    one model rank).

    Leaves, as in the reference's stage program (``_param_specs``):
      * **stacked** (``layers/``, hybrid ``units/``, whisper ``enc/`` and
        ``dec/``): cut on dim 0 to this stage's atoms, ``ranges[key]``
        = ``[lo, hi)``; a stage holding none of a stack (a pure-encoder
        stage's ``dec/``) holds no such leaf. So are their K-FAC
        factors, inverses and WU tiles (``pipeline.kfac_glue.
        stage_specs``), momentum and Adam moments;
      * the hybrid **tail** (``tail/``): on the last stage only, which
        alone runs it. (The reference replicates the tail's params on
        every stage and sums the others' zero gradients over ``stage``;
        its factors are on the last stage only, where alone their update
        can be computed, so the port keeps the params with them.);
      * **shared**: everything else (the embedding, ``img_proj``,
        ``final_norm``, ``lm_head``, whisper's ``enc_ln_f``/``dec_ln_f``),
        whole on every stage; their gradients are summed over ``stage``.
    """

    mesh: Any
    n_stages: int
    stage: int
    part: Any
    ranges: Dict[str, Tuple[int, int]]
    counts: Dict[str, Tuple[int, ...]]
    model: Optional[ModelShards] = None

    @property
    def last(self) -> bool:
        return self.stage == self.n_stages - 1

    def kind(self, path: str) -> str:
        """``"stacked"``, ``"tail"`` or ``"shared"``."""
        key = path.split("/", 1)[0]
        if key in self.ranges:
            return "stacked"
        return "tail" if key == "tail" else "shared"

    def holds(self, path: str) -> bool:
        """Whether this stage holds leaf ``path``."""
        kind = self.kind(path)
        if kind == "stacked":
            lo, hi = self.ranges[path.split("/", 1)[0]]
            return hi > lo
        return self.last if kind == "tail" else True

    def local(self, path: str) -> bool:
        """A leaf held by one stage (its part of the model), not shared."""
        return self.kind(path) != "shared"

    @property
    def mp(self) -> int:
        return 1 if self.model is None else self.model.mp


def stage_layout(cfg, part, stage: int, mesh=None,
                 model: Optional[ModelShards] = None) -> StageShards:
    """Stage ``stage``'s :class:`StageShards` for the partition ``part``
    (``mesh``: the stage submesh, needed only to gather)."""
    if part.atom == "encdec":
        ne = [part.enc_dec_counts(i)[0] for i in range(part.n_stages)]
        nd = [part.enc_dec_counts(i)[1] for i in range(part.n_stages)]
        counts = {"enc": tuple(ne), "dec": tuple(nd)}
    else:
        key = "units" if cfg.family == "hybrid" else "layers"
        counts = {key: part.layer_counts()}
    ranges = {k: (sum(c[:stage]), sum(c[:stage + 1]))
              for k, c in counts.items()}
    return StageShards(mesh=mesh, n_stages=part.n_stages, stage=stage,
                       part=part, ranges=ranges, counts=counts, model=model)


def stage_shards(cfg, mesh, part, model: Optional[ModelShards] = None
                 ) -> StageShards:
    """This rank's :class:`StageShards` on a ``(stage, data, model)``
    mesh (``launch.mesh.make_pipeline_mesh``) for the partition
    ``part``."""
    sub = mesh[STAGE]
    return stage_layout(cfg, part, mesh_position(sub), sub, model)


def _cut(t: torch.Tensor, path: str, st: StageShards) -> torch.Tensor:
    if st.kind(path) != "stacked":
        return t
    lo, hi = st.ranges[path.split("/", 1)[0]]
    return t[lo:hi].contiguous()


def stage_local_params(params: Mapping[str, torch.Tensor],
                       st: StageShards) -> Dict[str, torch.Tensor]:
    """A full parameter-shaped dict (params, momentum, Adam moments) cut
    to the leaves and atoms this stage holds."""
    return {k: _cut(v, k, st) for k, v in params.items() if st.holds(k)}


def stage_local_factors(tree, st: StageShards) -> dict:
    """A full factor or inverse tree cut to this stage's linears (their
    stack dim to its atoms)."""
    return {n: {s: _cut(t, n, st) for s, t in d.items()}
            for n, d in tree.items() if st.holds(n)}


def _stage_gather(t: Optional[torch.Tensor], path: str, like,
                  st: StageShards, device) -> torch.Tensor:
    """Leaf ``path`` whole (shape and dtype of ``like``) from the stage
    that holds each part: a stacked leaf's uneven parts padded to the
    largest count, gathered over ``stage`` and cut back; the tail's from
    the last stage; a shared leaf as it is."""
    kind = st.kind(path)
    if kind == "shared":
        return t
    if kind == "tail":
        counts = (0,) * (st.n_stages - 1) + (1,)
        part = None if t is None else t[None]
    else:
        counts = st.counts[path.split("/", 1)[0]]
        part = t
    top = max(counts)
    buf = torch.zeros((top,) + tuple(like.shape[1 if kind == "stacked"
                                                else 0:]),
                      dtype=like.dtype, device=device)
    if part is not None:
        buf[:part.shape[0]] = part
    got = all_gather_rows(buf, st.mesh).reshape((st.n_stages, top)
                                                + buf.shape[1:])
    out = torch.cat([got[i, :c] for i, c in enumerate(counts)])
    return out[0] if kind == "tail" else out


def stage_full_params(local: Mapping[str, torch.Tensor], like,
                      st: StageShards, device) -> Dict[str, torch.Tensor]:
    """The full dict of the leaves of ``like`` (``{path: tensor or meta
    tensor}`` of the full model, in its order) from every stage's parts
    (every rank of the stage submesh calls, one gather a local leaf)."""
    return {k: _stage_gather(local.get(k), k, v, st, device)
            for k, v in like.items()}


def stage_full_factors(local, like, st: StageShards, device) -> dict:
    """The full factor or inverse tree of the shapes of ``like`` (``{name:
    {side: tensor or meta tensor}}``) from every stage's parts."""
    return {n: {s: _stage_gather(local.get(n, {}).get(s), n, v, st, device)
                for s, v in d.items()} for n, d in like.items()}


def _stage_leaf_sum(terms, st: StageShards):
    """:func:`leaf_sum` under a :class:`StageShards`."""
    sliced = (lambda k: False) if st.model is None else (
        lambda k: st.model.dims.get(k) is not None)
    shared = [t for k, t in terms if not st.local(k) and not sliced(k)]
    shared_sl = [t for k, t in terms if not st.local(k) and sliced(k)]
    own = [t for k, t in terms if st.local(k) and not sliced(k)]
    own_sl = [t for k, t in terms if st.local(k) and sliced(k)]
    dev = terms[0][1].device if terms else None

    def total(ts):
        return (sum(ts) if ts else torch.zeros((), device=dev)).reshape(1)

    shared, own = total(shared), total(own)
    if st.model is not None:
        m = all_reduce(torch.cat([total(shared_sl), total(own_sl)]),
                       st.model.mesh)
        shared, own = shared + m[:1], own + m[1:]
    return shared[0] + all_reduce(own.clone(), st.mesh)[0]
