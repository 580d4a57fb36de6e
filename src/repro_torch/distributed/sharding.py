"""Logical-axis sharding specs of lowered plans (port of the plan-spec half
of ``repro.distributed.sharding``).

Every array of a model carries named logical axes (``"embed"``,
``"mlp"``, ``"heads"``, ``"expert"``, ...); a rules table maps each
logical axis to the mesh axes it may shard over.  A pre-lowered plan's
tensors carry the SAME logical axes as the master weight they were baked
from, so a lowered params tree shards over a mesh exactly like the raw
params tree.  This module derives those spec trees: a spec tree mirrors
the artifact, with a tuple of logical names (or None entries) in place
of each tensor.  Nothing here needs a mesh; the ``sharding-specs``
verifier rule (:mod:`repro_torch.verify.invariants`) reads these trees
to prove every plan leaf is placeable.

Not ported yet: the mesh binding (``set_mesh``, ``get_mesh``,
``resolve_spec``, ``sharding_for``, ``constrain``, ``tree_sharding``,
``sharding_like``), which waits for the port's multi-card slice.

The port keeps a scan-stacked layer or group as a
:class:`~repro_torch.exec.plan.PlanStack` of member plans where the
reference keeps one plan with an ``[S, ...]`` prefix on every leaf: a
member's spec is the member weight's spec without the stack prefix.
"""
from __future__ import annotations

import copy
from typing import Optional, Sequence

from repro_torch.exec.plan import GROUP_BATCH_CONCAT, PlanStack

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
