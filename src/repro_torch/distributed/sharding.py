"""Logical-axis sharding over a device mesh (port of
``repro.distributed.sharding``): named axes on every parameter, cache and
activation, resolved against the active mesh by a rules table, and the
explicit collectives that the port's sharded code runs.

Parallelism mapping (production mesh, :mod:`repro_torch.launch.mesh`):

- ``data`` (16)  - batch DP; MoE token groups; FSDP of the ``embed`` dims
- ``model`` (16) - heads, FFN hidden, vocab, experts (EP)
- ``pod``  (2)   - extra DP by default; pipeline stages when PP is on

The mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with
named dimensions; each named axis is a sub-group of the process group
(``mesh.get_group(axis)``).  The port runs explicit collectives over
those sub-groups - the reference's ``shard_map`` sites already write
theirs out - and never DTensor's sharding propagation: every kernel
binding takes a plain local tensor.  A leaf is stored as this rank's
block (:func:`shard_tree`, the twin of ``jax.device_put`` with a
``NamedSharding``), a tensor of its own; inside a sharded step
(:func:`sharded_params`) each layer gathers its leaves as it runs
(:func:`gather_leaf`), keeping the ``model`` blocks of the layers that
compute split (:mod:`repro_torch.distributed.tensor_parallel`), and
:func:`gather_tree` gathers a whole tree for a checkpoint.  The batch
stays split over its axes through a sharded step
(:func:`batch_split`), where every whole-batch reduction (a dynamic
calibration's abs-max, a loss mean) is all-reduced over those axes.
On an axis of size 1 every collective is the identity and moves nothing,
so a 1-device mesh computes exactly what no mesh computes.

Every array of a model carries named logical axes (``"embed"``,
``"mlp"``, ``"heads"``, ``"expert"``, ...).  A pre-lowered plan's
tensors carry the SAME logical axes as the master weight they were baked
from, so a lowered params tree shards over a mesh exactly like the raw
params tree (:func:`plan_specs_like`); the ``sharding-specs`` verifier
rule (:mod:`repro_torch.verify.invariants`) reads these spec trees to
prove every plan leaf is placeable.

The port keeps a scan-stacked layer or group as a
:class:`~repro_torch.exec.plan.PlanStack` of member plans where the
reference keeps one plan with an ``[S, ...]`` prefix on every leaf: a
member's spec is the member weight's spec without the stack prefix.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.exec.plan import (GROUP_BATCH_CONCAT, GROUP_COLUMN_CONCAT,
                                   PYTREE_FIELDS, GroupPlan, LayerPlan,
                                   PlanStack, WeightStore)

# logical axis -> preferred mesh axes, in priority order.  The first mesh
# axis that exists in the active mesh and is not yet taken by another
# logical axis of the same spec wins; otherwise the axis is replicated.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),                 # sequence kept local by default (SP opt-in)
    "seq_sp": ("model",),      # sequence-parallel alternative
    # FSDP: parameter embed dims shard over the data axis; activations
    # never carry the "embed" name, so batch keeps the data axis for DP
    "embed": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "qkv": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "capacity": (),
    "layers": (),              # stacked-scan leading axis
    "chunks": (),              # analog fpn chunk axis
    "conv": (),
    "state": (),
    # decode caches: if kv_heads cannot shard, the sequence axis takes
    # the model axis instead (split-KV parallelism)
    "kv_seq": ("model",),
    "stage": ("pod",),         # pipeline stages
}


def _SPEC_LEAF(x) -> bool:
    """A logical-axis name tuple (a spec tree's leaf)."""
    return isinstance(x, tuple) and not isinstance(x, PlanStack) and all(
        isinstance(e, (str, type(None))) for e in x)


def rules_for(run) -> dict:
    """DEFAULT_RULES specialized by the RunConfig distribution knobs."""
    rules = dict(DEFAULT_RULES)
    if not getattr(run, "fsdp", True):
        rules["embed"] = ()
    if not getattr(run, "seq_sp", True):
        rules["seq_sp"] = ()
    return rules


def _with(obj, **fields):
    """A copy of a frozen plan dataclass with ``fields`` set, without
    rebuilding it: a spec tree holds name tuples where the plan holds
    tensors, so the classes' derived views must not be re-derived."""
    out = copy.copy(obj)
    for k, v in fields.items():
        object.__setattr__(out, k, v)
    return out


def layer_plan_specs(lp, w_spec: Sequence[Optional[str]]):
    """Spec tree (a LayerPlan holding logical-name tuples) for one lowered
    layer, or a :class:`PlanStack` of them for a scan-stacked layer.

    ``w_spec`` is the logical spec of the master weight, e.g.
    ``("embed", "mlp")``, or ``("layers", "embed", "mlp")`` for a stacked
    layer: the trailing two names are the (in, out) axes, anything before
    them the prefix every baked tensor shares.  A stack's members take
    the spec without its leading (stack) name."""
    w_spec = tuple(w_spec)
    if isinstance(lp, PlanStack):
        return PlanStack(layer_plan_specs(m, w_spec[1:]) for m in lp)
    prefix, in_name, out_name = w_spec[:-2], w_spec[-2], w_spec[-1]
    nd = len(prefix)         # rank of the stack prefix

    def per_col(leaf):       # [*, N]-shaped leaves (gain may be scalar)
        if leaf is None:
            return None
        return prefix + (out_name,) if leaf.ndim > nd else prefix

    s = lp.store
    store = _with(
        s,
        # the packed codes carry the SAME logical axes as the master
        # weight they quantize; gain tables shard by the axes they index
        codes=w_spec,
        w_scale=prefix + (None, out_name),
        gain=per_col(s.gain),
        col_gain=None if s.col_gain is None else prefix + (out_name,),
        row_gain=None if s.row_gain is None else prefix + (None, in_name),
        chunk_gain=(None if s.chunk_gain is None
                    else prefix + ("chunks", out_name)),
        gain_map=None if s.gain_map is None else w_spec,
    )
    return _with(
        lp,
        store=store,
        a_scale=prefix,
        a_scale_in=None if lp.a_scale_in is None else prefix,
        chunk_offset=(None if lp.chunk_offset is None
                      else prefix + ("chunks", out_name)),
        colsum=None if lp.colsum is None else prefix + (out_name,),
        bias=None if lp.bias is None else prefix + (out_name,),
    )


def _replicated(obj, fields):
    return _with(obj, **{f: (None,) * getattr(obj, f).ndim for f in fields
                         if getattr(obj, f) is not None})


def analog_plan_specs(plan, layer_axes: Sequence[Sequence[Optional[str]]]):
    """Spec tree for a whole AnalogPlan: ``layer_axes[i]`` is the
    (in_name, out_name) pair of layer i.  The megakernel packing (when
    baked) is replicated: its row-concatenated operands interleave
    layers, so no single logical axis describes them."""
    layers = tuple(layer_plan_specs(lp, tuple(ax))
                   for lp, ax in zip(plan.layers, layer_axes))
    mega = plan.mega
    if mega is not None:
        # every data leaf gets a replicated spec - the float-glue extras
        # (deq/bias/enc/ln) included
        mega = _replicated(mega, ("gain", "off", "deq", "bias", "enc", "ln"))
        mega = _with(mega, stores=tuple(
            _replicated(s, ("codes", "w_scale", "gain", "col_gain",
                            "row_gain", "chunk_gain", "gain_map"))
            for s in plan.mega.stores))
    block = plan.block
    if block is not None:
        block = _replicated(block, ("ln1", "ln2"))
    return _with(plan, layers=layers, mega=mega, block=block)


def group_plan_specs(gp, parent_spec):
    """Spec tree for one lowered fusion group (a
    :class:`~repro_torch.exec.plan.GroupPlan`, or a :class:`PlanStack` of
    them), derived from the members' master-weight specs in
    ``parent_spec`` (the parent node's spec dict):

    - ``column_concat``: the fused plan inherits member 0's weight spec,
    - ``batch_concat``: ditto, with the member axis (replicated) spliced
      in before the (in, out) pair,
    - ``expert_stack``: the member's raw stacked-weight spec (e.g.
      ``("expert", "embed", None)``) already carries the expert axis.
    """
    probe = gp[0] if isinstance(gp, PlanStack) else gp
    mspec = parent_spec[probe.member_names[0]]
    w_spec = tuple(mspec["w"]) if isinstance(mspec, dict) else tuple(mspec)
    if probe.kind == GROUP_BATCH_CONCAT:
        w_spec = w_spec[:-2] + (None,) + w_spec[-2:]
    if isinstance(gp, PlanStack):
        return PlanStack(_with(m, fused=layer_plan_specs(m.fused,
                                                         w_spec[1:]))
                         for m in gp)
    return _with(gp, fused=layer_plan_specs(gp.fused, w_spec))


def replicated_specs(plan):
    """A spec tree that keeps every tensor of ``plan`` (a plan
    dataclass, a :class:`PlanStack`, a tensor) whole on every rank."""
    if isinstance(plan, torch.Tensor):
        return (None,) * plan.ndim
    if isinstance(plan, PlanStack):
        return PlanStack(replicated_specs(m) for m in plan)
    if type(plan) in PYTREE_FIELDS:
        return _with(plan, **{f: replicated_specs(getattr(plan, f))
                              for f in PYTREE_FIELDS[type(plan)][0]})
    if isinstance(plan, (list, tuple)):
        return type(plan)(replicated_specs(m) for m in plan)
    return plan


def plan_specs_like(spec_tree, lowered_tree):
    """Augment a logical-axis spec tree with entries for the ``"_plan"`` /
    ``"_groups"`` leaves of a pre-lowered params tree, so the result
    matches the lowered tree's structure leaf for leaf.  A layer's
    ``"_plan"`` inherits its own ``"w"`` spec; fusion-group plans derive
    from their members' specs (:func:`group_plan_specs`)."""
    if isinstance(lowered_tree, dict):
        out = {}
        for k, v in lowered_tree.items():
            if k == "_plan":
                out[k] = layer_plan_specs(v, spec_tree["w"])
            elif k == "_block_plan":
                # a block's packing interleaves its four layers: whole on
                # every rank
                out[k] = replicated_specs(v)
            elif k == "_groups":
                out[k] = {name: group_plan_specs(gp, spec_tree)
                          for name, gp in v.items()}
            else:
                out[k] = plan_specs_like(spec_tree[k], v)
        return out
    if isinstance(lowered_tree, (list, tuple)) and not _SPEC_LEAF(
            lowered_tree):
        return type(lowered_tree)(
            plan_specs_like(s, v) for s, v in zip(spec_tree, lowered_tree))
    return spec_tree


# --------------------------------------------------------------------------
# The mesh binding: the active mesh, spec resolution, and the collectives.
# --------------------------------------------------------------------------
class P(tuple):
    """The port's ``PartitionSpec``: one entry per dimension, each a mesh
    axis name, a tuple of them (a dimension split over several axes,
    major first) or None (replicated)."""

    def __new__(cls, *entries):
        # a one-axis tuple is that axis, as in JAX's PartitionSpec
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec bound to a mesh (the JAX class of that name): where each
    dimension of one leaf is split."""

    mesh: Any
    spec: P


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict[str, tuple[str, ...]] = dict(DEFAULT_RULES)
        # mesh axes the batch is split over inside a sharded step
        self.batch_axes: tuple[str, ...] = ()
        # further axes a dynamic abs-max spans (the expert-parallel block)
        self.amax_axes: tuple[str, ...] = ()
        self.logs: list = []
        # the parameters' shardings inside a sharded step (sharded_params)
        self.params = None
        # the member widths of the column_concat group being walked
        self.cols = None


_CTX = _Ctx()


def set_mesh(mesh, rules: Optional[dict] = None) -> None:
    _CTX.mesh = mesh
    if rules is not None:
        _CTX.rules = dict(rules)


def get_mesh():
    return _CTX.mesh


class use_mesh:
    """Context manager: activate a mesh (and optional rule overrides)."""

    def __init__(self, mesh, rules: Optional[dict] = None):
        self.mesh, self.rules = mesh, rules
        self._saved: tuple = ()

    def __enter__(self):
        self._saved = (_CTX.mesh, _CTX.rules)
        set_mesh(self.mesh, self.rules)
        return self.mesh

    def __exit__(self, *exc):
        _CTX.mesh, _CTX.rules = self._saved
        return False


def axis_sizes(mesh=None) -> dict:
    """``{axis name: size}`` of ``mesh`` (default: the active mesh)."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_index(axis: str) -> int:
    """This rank's index along a named axis of the active mesh."""
    return _CTX.mesh.get_local_rank(axis)


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def split_axes(entry) -> tuple:
    """The mesh axes of size > 1 that a spec entry names (major first)."""
    sizes = axis_sizes()
    return tuple(a for a in _axes(entry) if sizes[a] > 1)


def spec_axes(spec) -> tuple:
    """Every mesh axis a spec names: the axes that split its leaf."""
    return tuple(a for entry in spec for a in _axes(entry))


def logical_to_spec(names: Sequence[Optional[str]]) -> P:
    """Resolve logical axis names to a spec under the active rules."""
    axes_in_mesh = set(axis_sizes())
    used: set[str] = set()
    out = []
    for name in names:
        resolved = None
        if name is not None:
            for cand in _CTX.rules.get(name, ()):
                if cand in axes_in_mesh and cand not in used:
                    resolved = cand
                    used.add(cand)
                    break
        out.append(resolved)
    return P(*out)


def logical_to_spec_multi(names: Sequence[Optional[str]]) -> P:
    """Like :func:`logical_to_spec`, but a logical axis may absorb *all*
    its candidate mesh axes ('batch' -> ('pod', 'data') joint DP)."""
    axes_in_mesh = set(axis_sizes())
    used: set[str] = set()
    out = []
    for name in names:
        resolved: tuple = ()
        if name is not None:
            for cand in _CTX.rules.get(name, ()):
                if cand in axes_in_mesh and cand not in used:
                    resolved = resolved + (cand,)
                    used.add(cand)
        out.append(resolved if resolved else None)
    return P(*out)


def resolve_spec(names: Sequence[Optional[str]], shape: Sequence[int]) -> P:
    """Shape-aware resolution: dims are assigned mesh axes right to left
    (the most specific logical axes sit rightmost in the layouts), and an
    axis is taken only when the dim size is divisible by it - otherwise
    the next candidate (or replication) applies.  So ``kv_heads=2``
    cannot take a 16-way model axis, and the cache's ``kv_seq`` dim
    does."""
    sizes = axis_sizes()
    if not sizes:
        return P()
    names = tuple(names)
    if len(names) > len(shape):       # collapsed dims (e.g. [B*S, d]): keep
        names = names[len(names) - len(shape):]   # the trailing names
    elif len(names) < len(shape):
        names = (None,) * (len(shape) - len(names)) + names
    used: set[str] = set()
    out: list = [None] * len(names)
    for i in range(len(names) - 1, -1, -1):
        name = names[i]
        if name is None:
            continue
        resolved: tuple = ()
        prod = 1
        for cand in _CTX.rules.get(name, ()):
            if cand in sizes and cand not in used and \
                    shape[i] % (prod * sizes[cand]) == 0:
                resolved = resolved + (cand,)
                prod *= sizes[cand]
                used.add(cand)
        if resolved:
            out[i] = resolved if len(resolved) > 1 else resolved[0]
    return P(*out)


def sharding_for(names: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None
                 ) -> Optional[NamedSharding]:
    mesh = _CTX.mesh
    if mesh is None:
        return None
    if shape is None:
        return NamedSharding(mesh, logical_to_spec_multi(names))
    return NamedSharding(mesh, resolve_spec(names, shape))


def constrain(x, *names: Optional[str]):
    """The reference's ``with_sharding_constraint`` by logical names.  The
    port's sharded code holds local tensors whose placement is explicit,
    so a constraint moves nothing: ``x`` comes back as it is."""
    return x


def _map_specs(fn, spec_tree, value_tree):
    """``fn(spec_leaf, value)`` over a spec tree and the tree it mirrors
    (dicts, sequences, :class:`PlanStack`, plan dataclasses).  A ``None``
    spec pairs with a ``None`` value (an absent plan field)."""
    if _SPEC_LEAF(spec_tree):
        return fn(spec_tree, value_tree)
    if spec_tree is None:
        return None
    if isinstance(value_tree, dict):
        return {k: _map_specs(fn, spec_tree[k], v)
                for k, v in value_tree.items()}
    if type(value_tree) in PYTREE_FIELDS:
        return _with(spec_tree, **{
            f: _map_specs(fn, getattr(spec_tree, f), getattr(value_tree, f))
            for f in PYTREE_FIELDS[type(value_tree)][0]})
    if isinstance(value_tree, (list, tuple)):
        return type(value_tree)(_map_specs(fn, s, v)
                                for s, v in zip(spec_tree, value_tree))
    raise TypeError(f"spec tree entry {spec_tree!r} does not mirror "
                    f"{type(value_tree).__name__}")


def tree_sharding(spec_tree):
    """Map a tree of logical-name tuples to NamedShardings (or None
    without a mesh).  Shape-unaware (kept for replicated/scalar specs)."""
    if _CTX.mesh is None:
        return None

    def walk(t):
        if _SPEC_LEAF(t):
            return sharding_for(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t

    return walk(spec_tree)


def sharding_like(spec_tree, abstract_tree):
    """Shape-aware tree sharding: resolve each leaf's logical names
    against the matching leaf's shape (divisibility-checked).  A leaf
    without a shape (a cache's Python lengths) is replicated."""
    mesh = _CTX.mesh
    if mesh is None:
        return None

    def one(names, leaf):
        shape = getattr(leaf, "shape", None)
        if shape is None:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, resolve_spec(names, tuple(shape)))

    return _map_specs(one, spec_tree, abstract_tree)


def _is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


def split_dims(ns: NamedSharding, ndim: int, only=None):
    """``(dim, axes)`` pairs of the dims that ``ns`` splits (axes major
    first), restricted to mesh axes in ``only`` (None: every axis) and to
    axes of size > 1."""
    sizes = axis_sizes(ns.mesh)
    out = []
    for d, entry in enumerate(tuple(ns.spec)[:ndim]):
        axes = tuple(a for a in _axes(entry)
                     if sizes[a] > 1 and (only is None or a in only))
        if axes:
            out.append((d, axes))
    return out


def block_index(axes) -> tuple[int, int]:
    """``(index, count)`` of this rank's block of a dim split over
    ``axes`` (major first)."""
    sizes = axis_sizes()
    idx, n = 0, 1
    for a in _axes(axes):
        idx = idx * sizes[a] + axis_index(a)
        n *= sizes[a]
    return idx, n


def _cut(t: torch.Tensor, d: int, i: int, n: int, members=None):
    """Block ``i`` of ``n`` along dim ``d``.  ``members``: the widths of
    the members laid side by side along ``d`` (a ``column_concat``
    group's fused columns, q | k | v): each member is cut on its own and
    the block holds member 0's part, then member 1's, ..."""
    widths = (t.shape[d],) if members is None else tuple(members)
    if sum(widths) != t.shape[d] or any(w % n for w in widths):
        raise ValueError(f"dim {d} of shape {tuple(t.shape)} (members "
                         f"{widths}) does not split {n} ways")
    parts, c0 = [], 0
    for w in widths:
        parts.append(t.narrow(d, c0 + i * (w // n), w // n))
        c0 += w
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)


def _uncut(t: torch.Tensor, d: int, n: int, per=None):
    """The inverse of :func:`_cut` for ``t``, the ``n`` blocks side by
    side along ``d`` in block order (an all-gather's result); ``per``:
    the members' widths in one block."""
    if per is None:
        return t
    blocks = [b.split(list(per), dim=d) for b in t.split(sum(per), dim=d)]
    return torch.cat([blocks[r][j] for j in range(len(per))
                      for r in range(n)], dim=d)


def _members(t: torch.Tensor, d: int):
    """The member widths a cut or a gather along ``d`` follows while a
    ``column_concat`` group is walked: the group's own (as stored: the
    whole widths in a whole tree, a block's in a rank's), for its
    columns - the last dim of a per-column leaf - else None."""
    cols = _CTX.cols
    if cols is None or d != t.ndim - 1 or t.shape[d] != sum(cols):
        return None
    return tuple(cols)


def _local_block(t: torch.Tensor, ns: NamedSharding) -> torch.Tensor:
    """This rank's block of ``t``: a tensor of its own (contiguous, not a
    view), so the whole leaf can be freed.  A meta tensor stays a view:
    it holds no bytes."""
    cut = False
    for d, axes in split_dims(ns, t.ndim):
        i, n = block_index(axes)
        t = _cut(t, d, i, n, _members(t, d))
        cut = True
    if cut and t.device.type != "meta":
        t = t.clone(memory_format=torch.contiguous_format)
    return t


# a plan field that indexes a column_concat group's fused columns
_PER_COL = {"codes", "w_scale", "gain", "col_gain", "chunk_gain", "gain_map",
            "chunk_offset", "colsum", "bias"}


def _rebuild(obj, fields: dict):
    """A plan dataclass with ``fields`` replaced, rebuilt through
    ``__init__`` (its derived views come from its new tensors; a
    :class:`WeightStore`'s ``w_eff`` at its first read); the original
    object when nothing changed.  The static widths follow the new
    tensors: a :class:`LayerPlan`'s ``n``, a store's ``col_blocks`` and a
    group's ``member_ns`` (a rank's block of N columns holds N / n of
    each member's)."""
    if all(getattr(obj, k) is v for k, v in fields.items()):
        return obj
    fields = dict(fields)
    if isinstance(obj, WeightStore) and obj.col_blocks is not None:
        n_old, n_new = obj.codes.shape[-1], fields["codes"].shape[-1]
        fields["col_blocks"] = tuple(w * n_new // n_old
                                     for w in obj.col_blocks)
    elif isinstance(obj, LayerPlan):
        fields["n"] = fields["store"].codes.shape[-1]
    elif isinstance(obj, GroupPlan):
        n_old, n_new = obj.fused.n, fields["fused"].n
        fields["member_ns"] = tuple(w * n_new // n_old
                                    for w in obj.member_ns)
    return dataclasses.replace(obj, **fields)


def _first_sharding(tree) -> Optional[NamedSharding]:
    if _is_sharding(tree):
        return tree
    if isinstance(tree, dict):
        items = tree.values()
    elif type(tree) in PYTREE_FIELDS:
        items = (getattr(tree, f) for f in PYTREE_FIELDS[type(tree)][0])
    elif isinstance(tree, (list, tuple)):
        items = tree
    else:
        return None
    for item in items:
        found = _first_sharding(item)
        if found is not None:
            return found
    return None


def splits(shardings) -> bool:
    """Does a sharding tree's mesh split anything (an axis of size > 1)?"""
    ns = _first_sharding(shardings)
    return ns is not None and any(n > 1 for n in
                                  axis_sizes(ns.mesh).values())


@contextlib.contextmanager
def _columns(members):
    saved = _CTX.cols
    _CTX.cols = members
    try:
        yield
    finally:
        _CTX.cols = saved


def _map_tree(fn, tree, shardings):
    """``fn(tensor, sharding)`` over the tensor leaves of ``tree``;
    containers whose leaves all come back unchanged are returned as they
    are, so a 1-device mesh copies nothing.  Inside a ``column_concat``
    group a cut or a gather of the fused columns goes member by member
    (:func:`_members`)."""
    if tree is None or shardings is None:
        return tree
    if _is_sharding(shardings):
        return fn(tree, shardings) if isinstance(tree, torch.Tensor) \
            else tree
    if isinstance(tree, dict):
        out = {k: _map_tree(fn, v, shardings[k]) for k, v in tree.items()}
        return tree if all(out[k] is tree[k] for k in tree) else out
    if type(tree) in PYTREE_FIELDS:
        names = PYTREE_FIELDS[type(tree)][0]
        if isinstance(tree, GroupPlan) and tree.kind == GROUP_COLUMN_CONCAT:
            # the fused columns hold q | k | v: cut each member on its own
            with _columns(tree.member_ns):
                return _rebuild(tree, {"fused": _map_tree(
                    fn, tree.fused, shardings.fused)})
        if isinstance(tree, (LayerPlan, WeightStore)) and \
                _CTX.cols is not None:
            out = {}
            for f in names:
                if f in _PER_COL or f == "store":
                    out[f] = _map_tree(fn, getattr(tree, f),
                                       getattr(shardings, f))
                else:
                    with _columns(None):
                        out[f] = _map_tree(fn, getattr(tree, f),
                                           getattr(shardings, f))
            return _rebuild(tree, out)
        return _rebuild(tree, {
            f: _map_tree(fn, getattr(tree, f), getattr(shardings, f))
            for f in names})
    if isinstance(tree, (list, tuple)):
        out = [_map_tree(fn, v, s) for v, s in zip(tree, shardings)]
        if all(a is b for a, b in zip(out, tree)):
            return tree
        return type(tree)(out)
    return tree


def shard_tree(tree, shardings):
    """This rank's block of every leaf (the twin of ``jax.device_put(tree,
    shardings)``): each tensor cut along the dims its
    :class:`NamedSharding` splits into a tensor of its own, so the caller
    frees the whole leaf by dropping its tree.  A plan's block is a valid
    plan: every table is cut by the axis it indexes, a ``column_concat``
    group member by member (a rank holds its heads of q, of k and of v),
    and its ``w_eff`` is derived from the block's own tables at first
    read.  On a mesh of 1-sized axes the tree comes back as it is,
    without a walk."""
    if not splits(shardings):
        return tree
    return _map_tree(_local_block, tree, shardings)


def gather_tree(tree, shardings, axes=None):
    """The inverse of :func:`shard_tree`: every split dim all-gathered
    over its mesh axes (``axes``: only these mesh axes; None: all).  Plan
    stores are rebuilt, so their derived weights are the whole leaf's.
    The whole tree at once: for a checkpoint or a caller that asks; a
    step gathers one layer at a time (:func:`gather_leaf`)."""
    if not splits(shardings):
        return tree
    only = None if axes is None else set(_axes(axes))

    def one(t, ns):
        for d, ax in split_dims(ns, t.ndim, only):
            t = _uncut(all_gather(t, ax, dim=d), d, block_index(ax)[1],
                       _members(t, d))
        return t

    return _map_tree(one, tree, shardings)


class _GatherLeaf(torch.autograd.Function):
    """One leaf's block all-gathered along ``dim`` over ``axes``
    (member-aware, :func:`_uncut`).  Backward: this rank's block of the
    cotangent, summed first over the axes among them that split the batch
    (their ranks' cotangents differ: the transpose of an all-gather is a
    reduce-scatter, which it is where every axis splits the batch); the
    other ranks computed the same cotangent."""

    @staticmethod
    def forward(ctx, x, axes, dim, per):
        ctx.mesh, ctx.axes, ctx.dim, ctx.per = _CTX.mesh, axes, dim, per
        ctx.block = block_index(axes)
        ctx.summed = tuple(a for a in axes if a in _CTX.batch_axes)
        return _uncut(all_gather(x, axes, dim), dim, ctx.block[1], per)

    @staticmethod
    def backward(ctx, g):
        i, n = ctx.block
        with use_mesh(ctx.mesh):
            if ctx.per is None and ctx.summed == ctx.axes:
                # every axis splits the batch (FSDP's data): the sum and
                # the cut are one reduce-scatter
                return reduce_scatter(g.contiguous(), ctx.axes, ctx.dim), \
                    None, None, None
            if ctx.summed:
                g = all_reduce(g, ctx.summed)
        whole = None if ctx.per is None else [w * n for w in ctx.per]
        return _cut(g, ctx.dim, i, n, whole).contiguous(), None, None, None


def gather_leaf(tree, shardings, keep=(), split_compute=False):
    """One layer's leaves whole (a tensor, a linear's dict, a plan): every
    dim split over a mesh axis not in ``keep`` all-gathered, just before
    the layer runs; the dims ``keep``'s axes split stay this rank's block.
    Differentiable (:class:`_GatherLeaf`): a leaf's gradient comes back as
    this rank's block.  ``split_compute``: the layer computes on its
    ``keep`` blocks (column-parallel), so a leaf they do not split (a
    gain, a row table) takes a partial gradient on each rank, summed over
    them (:func:`psum_grad`).  Plans are rebuilt, and a store derives its
    fp32 ``w_eff`` as every store does, at its first read: a kernel that
    reads the int8 codes never builds it."""
    if shardings is None or not splits(shardings):
        return tree
    keep = set(_axes(keep))
    summed = split_axes(tuple(sorted(keep))) if split_compute else ()

    def one(t, ns):
        kept = False
        for d, ax in split_dims(ns, t.ndim):
            kept = kept or any(a in keep for a in ax)
            ax = tuple(a for a in ax if a not in keep)
            if ax:
                t = _GatherLeaf.apply(t, ax, d, _members(t, d))
        if summed and not kept:
            t = psum_grad(t, summed)
        return t

    return _map_tree(one, tree, shardings)


def stack_shardings(node, i: int):
    """Group ``i``'s shardings of a scan-stacked tree's (the twin of
    :func:`~repro_torch.models.transformer.stack_index`): a leaf's spec
    without its leading stack entry, member ``i`` of a
    :class:`PlanStack`."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: stack_shardings(v, i) for k, v in node.items()}
    if _is_sharding(node):
        return NamedSharding(node.mesh, P(*tuple(node.spec)[1:]))
    if isinstance(node, (PlanStack, list)):
        return node[i]
    return node


@contextlib.contextmanager
def sharded_params(shardings):
    """Inside the block the model's parameters are this rank's blocks,
    laid out by ``shardings``: the model gathers one layer's leaves at a
    time (:func:`gather_leaf`) and keeps the ``model`` axis's blocks where
    the layer computes split (:mod:`repro_torch.distributed.
    tensor_parallel`)."""
    saved = _CTX.params
    _CTX.params = shardings
    try:
        yield
    finally:
        _CTX.params = saved


def param_shardings():
    """The shardings of :func:`sharded_params`, or None."""
    return _CTX.params


# ------------------------------------------------------- the batch split
@contextlib.contextmanager
def batch_split(axes):
    """Inside the block the batch is split over the mesh ``axes`` (major
    first): each rank holds its block of every batch-major tensor, and
    whole-batch reductions go through :func:`batch_amax` /
    :func:`batch_sum`."""
    saved = _CTX.batch_axes
    _CTX.batch_axes = split_axes(axes)
    try:
        yield
    finally:
        _CTX.batch_axes = saved


def batch_axes() -> tuple:
    """The mesh axes (of size > 1) the batch is split over, or ()."""
    return _CTX.batch_axes


@contextlib.contextmanager
def amax_over(axes):
    """Inside the block every :func:`batch_amax` also spans ``axes``: a
    tensor whose blocks along them make up the whole operand (the
    expert-parallel dispatch buffer, split by expert over ``model``)."""
    saved = _CTX.amax_axes
    _CTX.amax_axes = saved + split_axes(axes)
    try:
        yield
    finally:
        _CTX.amax_axes = saved


def batch_amax(t: torch.Tensor) -> torch.Tensor:
    """A local abs-max (dynamic calibration) made the whole operand's:
    all-reduced (MAX) over the batch split (and :func:`amax_over`'s
    axes).  The identity outside them, so no mesh computes as before."""
    axes = _CTX.batch_axes + _CTX.amax_axes
    return all_reduce(t, axes, op="max") if axes else t


class _SumOver(torch.autograd.Function):
    """Forward: the sum over the ranks of ``axes``.  Backward: the
    identity - each rank's term takes its own gradient, and the step sums
    the parameter gradients over the same ranks (the transpose of a psum
    of rank-varying terms)."""

    @staticmethod
    def forward(ctx, x, axes):
        return all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(t: torch.Tensor, axes) -> torch.Tensor:
    """``t`` summed over the ranks of ``axes``, each rank's term taking
    its own gradient (:class:`_SumOver`): for a sum every rank then uses
    whole."""
    axes = split_axes(axes)
    return _SumOver.apply(t, axes) if axes else t


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """A local partial sum over the batch made global (summed over the
    batch split's ranks, identity gradient).  The identity outside a
    split."""
    return sum_over(t, _CTX.batch_axes)


def batch_count() -> int:
    """How many blocks the batch is split into (1 outside a split)."""
    return block_index(_CTX.batch_axes)[1] if _CTX.batch_axes else 1


def batch_rows(shape: tuple) -> tuple:
    """The global shape of a batch-major local ``shape`` (rows times the
    split's block count) and this rank's row offset in it."""
    i, n = block_index(_CTX.batch_axes) if _CTX.batch_axes else (0, 1)
    return (shape[0] * n,) + tuple(shape[1:]), i * shape[0]


# ------------------------------------------------------------ collectives
# bytes each rank moves, as a multiple of the result buffer (the reference
# dry run's ``_COLL_FACTOR``)
COLL_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
               "collective-permute": 1.0}


@contextlib.contextmanager
def record_collectives():
    """Count every collective issued in the block: yields ``{"counts":
    {op: n}, "bytes_per_op": {op: bytes}, "largest": {op: bytes},
    "total_bytes"}`` (bytes per rank, as the reference's
    ``parse_collectives`` reads them from HLO; ``largest``: the largest
    single call's)."""
    log = {"counts": {}, "bytes_per_op": {}, "largest": {},
           "total_bytes": 0.0}
    _CTX.logs.append(log)
    try:
        yield log
    finally:
        _CTX.logs.remove(log)


def _record(op: str, result: torch.Tensor) -> None:
    nbytes = result.numel() * result.element_size() * COLL_FACTOR[op]
    for log in _CTX.logs:
        log["counts"][op] = log["counts"].get(op, 0) + 1
        log["bytes_per_op"][op] = log["bytes_per_op"].get(op, 0.0) + nbytes
        log["largest"][op] = max(log["largest"].get(op, 0.0), nbytes)
        log["total_bytes"] += nbytes


def _group(axis: str):
    return _CTX.mesh.get_group(axis)


def all_gather(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The blocks of ``x`` over the ranks of ``axes`` (major first),
    concatenated along ``dim`` in block order."""
    sizes = axis_sizes()
    for a in reversed(_axes(axes)):
        n = sizes[a]
        if n == 1:
            continue
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=_group(a))
        x = torch.cat(parts, dim=dim)
        _record("all-gather", x)
    return x


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over the ranks of ``axes``;
    a new tensor, ``x`` is left as it was."""
    sizes = axis_sizes()
    for a in _axes(axes):
        if sizes[a] == 1:
            continue
        x = x.clone()
        dist.all_reduce(x, op=_OPS[op], group=_group(a))
        _record("all-reduce", x)
    return x


def reduce_scatter(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, of which this rank
    keeps its block along ``dim`` (the inverse of :func:`all_gather`'s
    layout).  gloo has no reduce-scatter: there it is an all-reduce and
    the block."""
    sizes = axis_sizes()
    for a in _axes(axes):
        n = sizes[a]
        if n == 1:
            continue
        group = _group(a)
        i = axis_index(a)
        if dist.get_backend(group) == "gloo":
            full = x.clone()
            dist.all_reduce(full, group=group)
            x = full.narrow(dim, i * (x.shape[dim] // n),
                            x.shape[dim] // n).contiguous()
            _record("all-reduce", full)
            continue
        parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
        out = torch.empty_like(parts[i])
        dist.reduce_scatter(out, parts, group=group)
        x = out
        _record("reduce-scatter", x)
    return x


def permute(x: torch.Tensor, axis: str, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: for each ``(src, dst)`` pair of ``perm``
    (indices along ``axis``), rank ``src``'s ``x`` arrives at ``dst``;
    a rank no pair sends to receives zeros."""
    n = axis_sizes()[axis]
    if n == 1:
        return x if (0, 0) in [tuple(p) for p in perm] else \
            torch.zeros_like(x)
    me = axis_index(axis)
    group = _group(axis)
    out = torch.zeros_like(x)
    reqs = []
    x = x.contiguous()
    for src, dst in perm:
        if src == me:
            reqs.append(dist.isend(x, dist.get_global_rank(group, dst),
                                   group=group))
        if dst == me:
            reqs.append(dist.irecv(out, dist.get_global_rank(group, src),
                                   group=group))
    for r in reqs:
        r.wait()
    _record("collective-permute", out)
    return out


class _GatherBlocks(torch.autograd.Function):
    """:func:`all_gather` of blocks that every rank of ``axes`` then uses
    whole (the same downstream work on each): the cotangents agree, and
    each rank's block takes its own part of one of them."""

    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.block = block_index(axes)[0]
        return all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.block * ctx.size, ctx.size), None, None


def gather_blocks(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """:func:`all_gather` under autograd, for an output every rank of
    ``axes`` uses whole (backward: this rank's block of the cotangent)."""
    return _GatherBlocks.apply(x, axes, dim)


class _Permute(torch.autograd.Function):
    """:func:`permute` whose backward is the inverse permutation."""

    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.mesh, ctx.axis = _CTX.mesh, axis
        ctx.perm = tuple(tuple(p) for p in perm)
        return permute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inv = [(d, s) for s, d in ctx.perm]
        with use_mesh(ctx.mesh):
            return permute(g, ctx.axis, inv), None, None


def permute_grad(x: torch.Tensor, axis: str, perm) -> torch.Tensor:
    """:func:`permute` under autograd (backward: the inverse)."""
    return _Permute.apply(x, axis, perm)


class _PsumGrad(torch.autograd.Function):
    """Identity forward; the gradient summed over the ranks of ``axes``:
    the transpose of a value every rank holds whole and feeds to work that
    the ranks split (a replicated ``shard_map`` input)."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.mesh, ctx.axes = _CTX.mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with use_mesh(ctx.mesh):
            return all_reduce(g, ctx.axes), None


def psum_grad(x: torch.Tensor, axes) -> torch.Tensor:
    """``x`` unchanged, its gradient all-reduced over ``axes``."""
    return _PsumGrad.apply(x, axes)
