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
trees and factor trees between the full model and a rank's slices. The
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


def leaf_sum(terms, shards: Optional[ModelShards] = None):
    """``sum`` of per-leaf scalars ``[(path, t)]`` in order. Under
    ``shards`` a sliced leaf's scalar is this rank's part: those parts
    are summed over the model ranks and added once, after the
    replicated leaves' sum, so every rank holds the same full total."""
    if shards is None:
        return sum(t for _, t in terms)
    sliced = [t for k, t in terms if shards.dims.get(k) is not None]
    total = sum(t for k, t in terms if shards.dims.get(k) is None)
    if sliced:
        part = sum(sliced).reshape(1).clone()
        total = total + all_reduce(part, shards.mesh)[0]
    return total
