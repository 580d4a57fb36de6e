"""Tensor parallelism over the mesh's ``model`` axis: the port's form of
the layouts the reference leaves to GSPMD (``repro.distributed.
sharding``: "TP: attention heads, FFN hidden, vocab, experts").

Between steps the parameters, the plans and the decode cache are this
rank's blocks (:func:`~repro_torch.distributed.sharding.shard_tree`).
Inside a step (:func:`~repro_torch.distributed.sharding.sharded_params`)
each layer takes a *view* of its leaves just before it runs: every dim
split over a mesh axis is all-gathered
(:func:`~repro_torch.distributed.sharding.gather_leaf`, one layer at a
time, never the whole tree), except the ``model`` axis's blocks of the
leaves that compute split:

- column-parallel (``N`` on ``model``, role ``"col"``): ``wq`` / ``wk`` /
  ``wv`` and the fused QKV group (a rank's heads), ``gate`` / ``up`` (its
  MLP columns), ``lm_head`` and a tied embedding (its vocabulary).  A
  column block launches the split kernel as it is: the chunked saturating
  sum runs along ``K``, so each column is exact;
- ``K`` on ``model`` (role ``"row"``, ``wo`` and ``down``): in digital mode
  row-parallel, each rank its ``K`` block and then a sum all-reduce; in
  the analog modes the leaf is gathered whole and its input activation
  all-gathered, so the 5-bit-coded chunked sum keeps its fp32 order;
- everything else whole: norms, RWKV, the SSM mixer, block plans, the MoE
  router and shared expert.  The expert stacks keep their expert block
  for the expert-parallel dispatch.

The views below make that choice, one per kind of layer, and each
returns its ``params`` as they are without shardings.  A view marks what
computes split with ``"_tp"``: ``"col"`` (a linear's ``N`` block, an
attention on its heads, an embedding's vocabulary block) or ``"row"`` (a
linear's ``K`` block); :func:`~repro_torch.api.program.apply_linear`
runs a ``"row"`` linear row-parallel, and the module that owns a
``"col"`` view keeps its output split where the next layer consumes it
split, or all-gathers it.
"""
from __future__ import annotations

from repro_torch.distributed import sharding as shd
from repro_torch.exec.plan import GROUP_COLUMN_CONCAT, find_group

MODEL = "model"


def model_size() -> int:
    """The size of the active mesh's ``model`` axis (1 without one)."""
    return shd.axis_sizes().get(MODEL, 1)


def on_model(ns, dim: int) -> bool:
    """Does ``ns`` split dim ``dim`` (negative: from the right) over the
    ``model`` axis?"""
    if ns is None:
        return False
    spec = tuple(ns.spec)
    d = dim % len(spec) if spec else 0
    return bool(spec) and MODEL in shd.split_axes(spec[d])


def _usable_plan(p: dict, acfg):
    lp = p.get("_plan")
    if lp is None or lp.signed_input != acfg.signed_input or \
            lp.chunk_rows != acfg.chunk_rows:
        return None
    return lp


def linear_view(p: dict, sh, role, acfg) -> dict:
    """One linear's leaves as it runs under the mesh, with only what the
    call reads (digital: ``w`` and ``b``; analog: a usable ``"_plan"``,
    else the masters it is lowered from).  ``role``: ``"col"`` keeps the
    ``N`` block of the ``model`` axis, ``"row"`` the ``K`` block in
    digital mode; None (or a leaf the axis does not split) gathers the
    leaf whole."""
    if sh is None:
        return p
    digital = acfg.mode == "digital"
    if digital:
        names = [k for k in ("w", "b") if k in p]
    elif _usable_plan(p, acfg) is not None:
        names = ["_plan"]
    else:
        names = [k for k in p if k != "_plan"]
    keep = ()
    if role == "col" and on_model(sh["w"], -1):
        keep = (MODEL,)
    elif role == "row" and digital and on_model(sh["w"], -2):
        keep = (MODEL,)
    view = shd.gather_leaf({k: p[k] for k in names},
                           {k: sh[k] for k in names}, keep=keep,
                           split_compute=bool(keep) and role == "col")
    if keep:
        view = {**view, "_tp": role}
    return view


def split_cols(p: dict) -> bool:
    """Does a linear's view compute its ``N`` block (role ``"col"``)?"""
    return p.get("_tp") == "col"


def split_rows(p: dict) -> bool:
    """Does a linear's view compute row-parallel (role ``"row"``)?"""
    return p.get("_tp") == "row"


def heads_split(sh, n_heads: int, n_kv_heads: int) -> bool:
    """Can attention run on this rank's heads: the ``model`` axis divides
    the query and the KV heads (so each GQA group stays whole on a rank)
    and splits the q / k / v projections' output columns?"""
    m = model_size()
    return (m > 1 and n_heads % m == 0 and n_kv_heads % m == 0
            and all(on_model(sh[k]["w"], -1) for k in ("wq", "wk", "wv")))


def embedding_view(params, shardings):
    """The embedding (or a tied lm_head): its table gathered over every
    axis but ``model``, whose vocabulary block stays this rank's (marked
    ``"col"``)."""
    if shardings is None or not on_model(shardings["table"], 0):
        return shd.gather_leaf(params, shardings)
    view = shd.gather_leaf(params, shardings, keep=(MODEL,))
    return {**view, "_tp": "col"}


def attention_view(params, shardings, acfg, n_heads: int, n_kv_heads: int):
    """The attention: where :func:`heads_split` holds, q / k / v (or the
    fused QKV group, member by member) on this rank's heads, the view
    marked ``"col"``; else gathered whole.  ``wo`` row-parallel (digital)
    or gathered whole (analog)."""
    from repro_torch.models.attention import qkv_plan

    if shardings is None:
        return params
    heads = heads_split(shardings, n_heads, n_kv_heads)
    view = {}
    gp = find_group(params.get("_groups"), GROUP_COLUMN_CONCAT,
                    ("wq", "wk", "wv"))
    if qkv_plan(params, acfg) is not None:
        name = next(k for k, v in params["_groups"].items() if v is gp)
        view["_groups"] = {name: shd.gather_leaf(
            gp, shardings["_groups"][name], keep=(MODEL,) if heads else ())}
    else:
        for k in ("wq", "wk", "wv"):
            view[k] = linear_view(params[k], shardings[k],
                                  "col" if heads else None, acfg)
    view["wo"] = linear_view(params["wo"], shardings["wo"], "row", acfg)
    if heads:
        view["_tp"] = "col"
    return view


def mlp_view(params, shardings, acfg):
    """The MLP: ``gate`` / ``up`` on this rank's columns of the hidden
    width, ``down`` row-parallel (digital) or gathered whole (analog)."""
    view = {k: linear_view(params[k], shardings[k], "col", acfg)
            for k in ("up", "gate") if k in params}
    view["down"] = linear_view(params["down"], shardings["down"], "row",
                               acfg)
    return view


def moe_view(params, shardings, dispatch: str) -> dict:
    """The MoE layer: the router and the shared expert gathered whole; the
    expert stacks (raw and pre-lowered) keep this rank's expert block of
    the ``model`` axis for the expert-parallel dispatch
    (``dispatch="shard_map"``), else gathered whole too."""
    ep = dispatch == "shard_map" and model_size() > 1
    return {k: shd.gather_leaf(v, shardings[k], keep=(MODEL,))
            if ep and k in ("up", "gate", "down", "_groups")
            else shd.gather_leaf(v, shardings[k]) for k, v in params.items()}
