"""``compile(spec, params, run_cfg)``: the compile half of the front door
(port of the stack and tree branches of ``repro.api.compile``).

- stack specs lower to one :class:`~repro_torch.exec.plan.AnalogPlan`
  (:func:`repro_torch.exec.lower.lower_stack`);
- tree specs pre-lower every analog layer in place in the params tree (a
  ``"_plan"`` entry beside its parameters; a scan-stacked layer dict gets
  a :class:`~repro_torch.exec.plan.PlanStack`, one plan per slice) and
  every declared fusion group into a
  :class:`~repro_torch.exec.plan.GroupPlan` under the members' parent
  node (``"_groups"``): ONE analog dispatch where the per-layer path
  issued N (the attention QKV's ``column_concat``, the RWKV r/k/v/g
  ``batch_concat``).  An MoE node's raw expert weights lower into
  ``expert_stack`` groups, a scan-stacked ``[S, E, K, N]`` weight into a
  :class:`~repro_torch.exec.plan.PlanStack` of them, one per scan member
  (the reference leaves scan-stacked experts to the per-call path).

- block specs (:func:`block_spec`, :func:`compile_block`) lower one
  attention+MLP transformer block into a 4-layer plan that replays as ONE
  kernel launch (:func:`~repro_torch.exec.lower.lower_block`).

- digital mode of a stack lowers nothing: ``apply`` runs the float
  reference chain (``x @ w (+ b)``, ReLU between layers), the software
  baseline of the ECG accuracy loop.

``calibration=`` selects the bake source: None keeps the oracle
``params["fpn"]`` bake (simulation-only ground truth); a
:class:`repro_torch.calib.snapshot.CalibrationSnapshot` bakes MEASURED
per-(chunk, column) gain/offset tables and static activation scales
instead - the only bake real hardware supports.  Snapshot entries are
looked up by spec layer name (stacks) / dotted params path (trees);
layers without an entry keep the oracle bake.  A tree's column_concat
group fuses under static activation calibration when the snapshot gave
all its members one shared input LSB (``a_scale_in``).  A scan-stacked
layer or group takes a per-stack-member record (``[S, C, N]`` tables,
one measured device per member: the fleet gather,
:func:`repro_torch.fleet.model_snapshot`): slice ``i`` bakes into member
``i`` of its :class:`~repro_torch.exec.plan.PlanStack`.  A block bakes by
its seven physical member names (``"wq"`` ... ``"down"``).
:meth:`~repro_torch.api.program.CompiledModel.with_calibration` hot-swaps
a refreshed snapshot's tables without lowering.

Everything is lowered once, on the target device, inside an
``api.compile`` span of :mod:`repro_torch.obs.trace` that records the
:func:`~repro_torch.exec.lower.lowering_count` it took.

``verify=True`` (the default) then runs the CHEAP static invariant rules
(:mod:`repro_torch.verify.invariants`: shapes and static metadata only,
no host-device synchronisation, so cheap enough for the train step's
per-step recompile) over the spec and the lowered artifact, records each
finding as a ``verify.diagnostic`` trace event and their count as the
span's ``diagnostics``, and raises
:class:`repro_torch.verify.VerifyError` on any.  The full rule set
(drift-swap, sharding coverage, packed layout) is
:meth:`~repro_torch.api.program.CompiledModel.verify`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

from repro_torch.api.module import (
    BLOCK,
    STACK,
    TREE,
    GroupSpec,
    LayerSpec,
    ModuleSpec,
    group_parent,
)
from repro_torch.api.program import CompiledModel
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.device import DeviceLike, resolve_device, to_device
from repro_torch.exec.lower import (layer_with_tables, lower_batch_concat,
                                    lower_block, lower_expert_stack,
                                    lower_fused, lower_layer, lower_stack,
                                    lowering_count, stack_calibs,
                                    stacked_calib)
from repro_torch.exec.plan import (GROUP_BATCH_CONCAT, GROUP_COLUMN_CONCAT,
                                   GROUP_EXPERT_STACK, GroupPlan, PlanStack)
from repro_torch.obs import trace as _trace

_PLAN = "_plan"
_GROUPS = "_groups"
_QKV_MEMBERS = ("wq", "wk", "wv")
_RKVG_MEMBERS = ("wr", "wk", "wv", "wg")
_EXPERT_MEMBERS = ("up", "gate", "down")
# physical devices of one transformer block, in schedule order: the
# member-name key space of a block's bake-time calibration snapshot
_BLOCK_MEMBERS = ("wq", "wk", "wv", "wo", "up", "gate", "down")


def _acfg(run_cfg) -> AnalogConfig:
    """Accept a config with an ``.analog`` field or a bare AnalogConfig."""
    return getattr(run_cfg, "analog", run_cfg)


def _is_analog_layer(node) -> bool:
    """An analog linear's parameter dict: 2-D master weights, or 3-D when
    stacked with a leading scan axis."""
    return (
        isinstance(node, dict)
        and "w" in node and "w_scale" in node and "gain" in node
        and getattr(node["w"], "ndim", 0) in (2, 3)
    )


def _slice(node, i: int):
    """Slice ``i`` of a scan-stacked params node (every tensor leaf)."""
    if isinstance(node, dict):
        return {k: _slice(v, i) for k, v in node.items()}
    return node[i]


def _lower_leaf(node: dict, acfg: AnalogConfig, calib=None):
    """Lower one analog layer dict; a scan-stacked one slice by slice (the
    reference vmaps over the stack axis).  A measured record applies to a
    plain 2-D layer, and to a scan-stacked one when it carries
    per-stack-member tables (:func:`~repro_torch.exec.lower.
    stacked_calib`): slice ``i`` of the record bakes member ``i``."""
    if node["w"].ndim == 3:
        s = node["w"].shape[0]
        return PlanStack(lower_layer(_slice(node, i), acfg, calib=c)
                         for i, c in enumerate(stack_calibs(calib, s)))
    return lower_layer(node, acfg, calib=calib)


def _member_calibs(calibration, parent: str, locals_: Sequence[str]):
    """The group members' calibration records (member order) when the
    snapshot covers ALL of them, else None.  A partial snapshot must not
    change how a group lowers."""
    if calibration is None:
        return None
    calibs = [calibration.layer(f"{parent}.{m}" if parent else m)
              for m in locals_]
    if any(c is None for c in calibs):
        return None
    return calibs


def _static_fusable(calibs) -> bool:
    """column_concat under static activation calibration needs the
    group's shared input LSB (``a_scale_in``) on every member -
    produced by :func:`repro_torch.calib.routines.share_group_input_scale`."""
    return calibs is not None and all(c.a_scale_in is not None
                                      for c in calibs)


def _expert_stacks(node) -> list:
    """The names of an MoE node's raw expert weights (``up`` / ``gate`` /
    ``down`` tensors of rank 3, ``[E, K, N]``, or 4 when scan-stacked,
    beside a ``router``), else []."""
    if not isinstance(node, dict) or "router" not in node:
        return []
    return [m for m in _EXPERT_MEMBERS
            if getattr(node.get(m), "ndim", 0) in (3, 4)]


def _derive_groups(params) -> Tuple[GroupSpec, ...]:
    """The fusion-group declaration of a bare params tree (the walk
    :func:`tree_spec` records):

    - one ``column_concat`` group per attention node whose wq/wk/wv share
      the input dim and the stack rank;
    - one ``batch_concat`` group per RWKV time-mix node whose
      wr/wk/wv/wg share the weight geometry and the stack rank;
    - one ``expert_stack`` group per raw expert weight of an MoE node.
      The reference derives none (its scan-stacked LM trees re-derive the
      experts' codes in every call); the port lowers them once, so a
      served MoE model re-derives nothing per call, with the same values.
    """
    groups = []

    def walk(node, path):
        if _is_analog_layer(node) or not isinstance(node, dict):
            return
        prefix = ".".join(path + [""]) if path else ""
        ms = [node.get(m) for m in _QKV_MEMBERS]
        if (all(_is_analog_layer(m) for m in ms)
                and len({(m["w"].ndim, m["w"].shape[-2]) for m in ms}) == 1):
            groups.append(GroupSpec(
                name=prefix + "qkv", kind=GROUP_COLUMN_CONCAT,
                members=tuple(prefix + m for m in _QKV_MEMBERS),
            ))
        ms = [node.get(m) for m in _RKVG_MEMBERS]
        if (all(_is_analog_layer(m) for m in ms)
                and len({(m["w"].ndim,) + tuple(m["w"].shape[-2:])
                         for m in ms}) == 1):
            groups.append(GroupSpec(
                name=prefix + "rkvg", kind=GROUP_BATCH_CONCAT,
                members=tuple(prefix + m for m in _RKVG_MEMBERS),
            ))
        for m in _expert_stacks(node):
            groups.append(GroupSpec(name=prefix + m, kind=GROUP_EXPERT_STACK,
                                    members=(prefix + m,)))
        for k, v in node.items():
            walk(v, path + [k])

    walk(params, [])
    return tuple(groups)


def _lower_group(g: GroupSpec, locals_: Sequence[str], node: dict,
                 acfg: AnalogConfig, calibration=None, parent: str = ""):
    """Lower one declared fusion group at its parent node, or None when it
    cannot fuse under this config (column_concat shares one input
    encoding: always under dynamic activation calibration, under static
    only when the snapshot calibrated the group together; otherwise the
    members keep their per-layer plans; batch_concat members encode at
    their own scales and always fuse).  Scan-stacked members give a
    :class:`PlanStack` of per-slice group plans, slice ``i`` baked from
    member ``i`` of per-stack-member records when every member of the
    group has one (else from none)."""
    members = [node[m] for m in locals_]
    if g.kind == GROUP_EXPERT_STACK:
        # an expert stack has no measured device: always the plain bake
        w = members[0]

        def stack(arr):
            return GroupPlan(kind=g.kind, fused=lower_expert_stack(arr, acfg),
                             member_names=tuple(locals_),
                             member_ns=(int(arr.shape[-1]),))

        if w.ndim == 4:
            return PlanStack(stack(w[i]) for i in range(w.shape[0]))
        return stack(w)
    calibs = _member_calibs(calibration, parent, locals_)
    member_ns = tuple(int(m["w"].shape[-1]) for m in members)
    if g.kind == GROUP_BATCH_CONCAT:
        # each member encodes at its own scale: it fuses under either
        # activation calibration (a scan stack gives a PlanStack)
        fused = lower_batch_concat(members, acfg, calibs=calibs)
        if isinstance(fused, PlanStack):
            return PlanStack(GroupPlan(kind=g.kind, fused=f,
                                       member_names=tuple(locals_),
                                       member_ns=member_ns) for f in fused)
        return GroupPlan(kind=g.kind, fused=fused,
                         member_names=tuple(locals_), member_ns=member_ns)
    if acfg.act_calib != "dynamic" and not _static_fusable(calibs):
        return None

    def group(ms, cs):
        return GroupPlan(kind=g.kind,
                         fused=lower_fused(ms, acfg, calibs=cs),
                         member_names=tuple(locals_), member_ns=member_ns)

    if members[0]["w"].ndim == 3:
        s = members[0]["w"].shape[0]
        per = [[None] * len(members)] * s
        if calibs is not None and all(stacked_calib(c, s) for c in calibs):
            per = list(zip(*(stack_calibs(c, s) for c in calibs)))
        return PlanStack(group([_slice(m, i) for m in members], list(per[i]))
                         for i in range(s))
    return group(members, calibs)


def lower_tree(params, run_cfg, *,
               groups: Optional[Sequence[GroupSpec]] = None,
               calibration=None):
    """Pre-lower every analog layer in a params tree: each analog-layer
    dict gains a ``"_plan"`` entry, every fusion group a
    :class:`~repro_torch.exec.plan.GroupPlan` in its parent node's
    ``"_groups"`` dict (fused members get no per-layer plan).  ``groups``
    is the fusion declaration (``spec.groups`` when called through
    :func:`compile`); None derives it from the params structure.
    ``calibration`` (a snapshot keyed by dotted params path) bakes
    measured tables where it has an entry.  Returns the params tree
    unchanged in digital mode."""
    acfg = _acfg(run_cfg)
    if acfg.mode == "digital":
        return params
    if groups is None:
        groups = _derive_groups(params)
    by_parent: dict = {}
    for g in groups:
        parent, locals_ = group_parent(g)
        by_parent.setdefault(parent, []).append((g, locals_))

    def walk(node, path):
        joined = ".".join(path)
        if _is_analog_layer(node):
            calib = (calibration.layer(joined) if calibration is not None
                     else None)
            return {**node, _PLAN: _lower_leaf(node, acfg, calib)}
        if not isinstance(node, dict):
            return node
        gplans: dict = {}
        fused: set = set()
        for g, locals_ in by_parent.get(joined, ()):
            missing = [m for m in locals_ if m not in node]
            if missing:
                raise ValueError(
                    f"group {g.name!r}: members {missing} not found under "
                    f"params node {joined or '<root>'!r}"
                )
            gp = _lower_group(g, locals_, node, acfg, calibration, joined)
            if gp is not None:
                gplans[g.local_name] = gp
                fused.update(locals_)
        out = {k: (dict(v) if isinstance(v, dict) else v) if k in fused
               else walk(v, path + [k]) for k, v in node.items()}
        if gplans:
            out[_GROUPS] = gplans
        return out

    return walk(params, [])


def iter_analog_layers(params) -> Iterator[Tuple[str, dict]]:
    """Yield (dotted path, layer params) for every analog layer dict."""

    def walk(node, path):
        if _is_analog_layer(node):
            yield ".".join(path), node
        elif isinstance(node, dict):
            for k in node:
                yield from walk(node[k], path + [k])

    yield from walk(params, [])


def tree_spec(name: str, params, *, param_axes=None,
              apply_fn=None) -> ModuleSpec:
    """A tree-kind :class:`ModuleSpec` from a params tree: one
    :class:`LayerSpec` per analog layer plus the derived fusion groups
    (:func:`_derive_groups`).  The groups are authoritative:
    :func:`compile` lowers exactly ``spec.groups``.  ``param_axes`` is
    the params' logical-axis spec tree."""
    groups = _derive_groups(params)
    member_group = {m: g.name for g in groups for m in g.members}
    layers = []
    for path, node in iter_analog_layers(params):
        w = node["w"]
        layers.append(LayerSpec(
            name=path, in_dim=int(w.shape[-2]), out_dim=int(w.shape[-1]),
            group=member_group.get(path),
            stacked=int(w.shape[0]) if w.ndim == 3 else 0,
        ))
    for g in groups:
        if g.kind == GROUP_EXPERT_STACK:
            w = params
            for key in g.members[0].split("."):
                w = w[key]
            layers.append(LayerSpec(
                name=g.members[0], in_dim=int(w.shape[-2]),
                out_dim=int(w.shape[-1]), group=g.name,
                stacked=int(w.shape[-3])))
    return ModuleSpec(name=name, layers=tuple(layers), kind=TREE,
                      apply_fn=apply_fn, param_axes=param_axes,
                      groups=groups)


def _stack_params(spec: ModuleSpec, params) -> list:
    layer_params = []
    for l in spec.layers:
        if _is_analog_layer(params):          # single-layer convenience:
            p = params                        # the layer dict itself
        elif isinstance(params, dict) and l.name in params:
            p = params[l.name]
        else:
            raise ValueError(
                f"spec layer {l.name!r}: no analog layer params found"
            )
        if not _is_analog_layer(p) or p["w"].ndim != 2:
            raise ValueError(
                f"spec layer {l.name!r}: params are not an analog layer "
                "dict (need 2-D w / w_scale / gain)"
            )
        got = tuple(p["w"].shape[-2:])
        if got != (l.in_dim, l.out_dim):
            raise ValueError(
                f"spec layer {l.name!r} declares "
                f"{(l.in_dim, l.out_dim)} but params are {got}"
            )
        layer_params.append(p)
    return layer_params


def block_spec(name: str, *, d_model: int, d_ff: int, n_heads: int,
               n_kv_heads: int, head_dim: int, seq: int,
               rope_theta: float = 10000.0, eps: float = 1e-5,
               signed_input: Optional[str] = None) -> ModuleSpec:
    """Spec for one attention+MLP transformer block compiled as a SINGLE
    whole-block dispatch.  The four declared layers are the block's analog
    dispatches in schedule order."""
    nq = n_heads * head_dim
    nkv = n_kv_heads * head_dim
    return ModuleSpec(
        name=name,
        layers=(
            LayerSpec("qkv", d_model, nq + 2 * nkv,
                      signed_input=signed_input),
            LayerSpec("o", nq, d_model, signed_input=signed_input),
            LayerSpec("up_gate", d_model, 2 * d_ff,
                      signed_input=signed_input),
            LayerSpec("down", d_ff, d_model, signed_input=signed_input),
        ),
        kind=BLOCK,
        input_domain="float",
        block_geom={
            "n_heads": n_heads, "n_kv_heads": n_kv_heads,
            "head_dim": head_dim, "seq": seq,
            "rope_theta": rope_theta, "eps": eps,
        },
    )


def swap_calibration(lowered, snapshot, *, path: str = ""):
    """Hot-swap a refreshed snapshot's measured tables into a pre-lowered
    params tree: every ``"_plan"`` entry and every column_concat or
    batch_concat ``"_groups"`` plan the snapshot covers gets its
    ``chunk_offset`` replaced - and its ``chunk_gain`` when the plan
    baked a measured gain table of matching shape
    (:func:`~repro_torch.exec.lower.layer_with_tables`); a column_concat
    group's member tables concatenate along the columns, a batch_concat
    group's stack along its member axis.  Expert stacks have no measured
    device and are kept.  A scan-stacked
    plan (a :class:`PlanStack`) swaps per-stack-member ``[S, C, N]``
    tables, member ``i`` taking slice ``i``.  Nothing is lowered; layers
    the snapshot does not cover and tables that do not match the plan's
    shape (a stack against plain ``[C, N]`` tables included) are kept."""
    import torch

    def swap(lp, off, gain):
        if (off is None or lp.chunk_offset is None
                or tuple(off.shape) != tuple(lp.chunk_offset.shape)):
            return lp
        cg = lp.store.chunk_gain
        if (gain is None or cg is None or lp.colsum is not None
                or tuple(gain.shape) != tuple(cg.shape)):
            gain = None
        return layer_with_tables(lp, chunk_offset=off, chunk_gain=gain)

    def swap_any(v, off, gain, fn):
        """``fn(member, off, gain)`` over a plan, or over each member of
        a stack with slice ``i`` of ``[S, ...]`` tables."""
        if not isinstance(v, PlanStack):
            return fn(v, off, gain)
        if off is None or off.ndim < 1 or off.shape[0] != len(v):
            return v
        if gain is not None and (gain.ndim < 1 or gain.shape[0] != len(v)):
            gain = None
        return PlanStack(fn(m, off[i], None if gain is None else gain[i])
                         for i, m in enumerate(v))

    def swap_group(gp, p: str):
        probe = gp[0] if isinstance(gp, PlanStack) and len(gp) else gp
        if isinstance(probe, PlanStack) or probe.kind not in (
                GROUP_COLUMN_CONCAT, GROUP_BATCH_CONCAT):
            return gp
        recs = _member_calibs(snapshot, p, probe.member_names)
        if recs is None or any(r.chunk_offset is None for r in recs):
            return gp
        dev = probe.fused.store.codes.device

        def cat(ts):
            ts = [torch.as_tensor(t).to(dev, torch.float32) for t in ts]
            if probe.kind == GROUP_BATCH_CONCAT:
                # the member axis, after a per-stack-member [S] axis
                return torch.stack(ts, dim=-3)
            return torch.cat(ts, dim=-1)

        gains = [r.gain_table for r in recs]
        gain = None if any(g is None for g in gains) else cat(gains)
        return swap_any(gp, cat([r.chunk_offset for r in recs]), gain,
                        lambda g, off, gn: dataclasses.replace(
                            g, fused=swap(g.fused, off, gn)))

    def walk(node, p: str):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k == _PLAN:
                rec = snapshot.layer(p)
                out[k] = v if rec is None else swap_any(
                    v, rec.chunk_offset, rec.gain_table, swap)
            elif k == _GROUPS:
                out[k] = {name: swap_group(gp, p) for name, gp in v.items()}
            else:
                out[k] = walk(v, f"{p}.{k}" if p else k)
        return out

    return walk(lowered, path)


def _compile_block(spec: ModuleSpec, params, acfg: AnalogConfig,
                   calibration=None):
    g = spec.block_geom
    calibs = None
    if calibration is not None:
        calibs = {m: calibration.layer(m) for m in _BLOCK_MEMBERS}
    return lower_block(
        params, acfg,
        n_heads=g["n_heads"], n_kv_heads=g["n_kv_heads"],
        head_dim=g["head_dim"], seq=g["seq"],
        rope_theta=g["rope_theta"], eps=g.get("eps", 1e-5),
        calibs=calibs,
    )


def compile_block(block_params, run_cfg, *, n_heads: int, n_kv_heads: int,
                  head_dim: int, seq: int, rope_theta: float = 10000.0,
                  eps: float = 1e-5, name: str = "block",
                  calibration=None,
                  device: DeviceLike = None) -> CompiledModel:
    """Compile ONE attention+MLP transformer block into a single-dispatch
    program on ``device`` (``None`` = the CUDA device).

    ``block_params`` is the standard block node ``{"ln1", "attn": {wq,
    wk, wv, wo}, "ln2", "mlp": {up, down, gate}}``.  The resulting model
    applies as ``model.apply(x)`` with ``x [batch, seq, d_model]`` (the
    baked prefill ``seq`` is static); its ``lower()`` artifact is a
    4-layer block :class:`~repro_torch.exec.plan.AnalogPlan` whose
    canonical replay is ONE kernel launch.  Needs an analog mode with
    ``act_calib='static'`` and ``signed_input`` in ``('none', 'split')``.

    ``calibration`` bakes measured tables by PHYSICAL member name
    (``"wq"``, ``"wk"``, ``"wv"``, ``"wo"``, ``"up"``, ``"gate"``,
    ``"down"``); a drift refresh through
    :meth:`~repro_torch.api.program.CompiledModel.with_calibration` keys
    on the four fused dispatch names instead (``"qkv"``, ``"o"``,
    ``"up_gate"``, ``"down"``).
    """
    attn, mlp = block_params["attn"], block_params["mlp"]
    spec = block_spec(
        name,
        d_model=int(attn["wq"]["w"].shape[0]),
        d_ff=int(mlp["up"]["w"].shape[1]),
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
        seq=seq, rope_theta=rope_theta, eps=eps,
    )
    return compile(spec, block_params, run_cfg, calibration=calibration,
                   device=device)


def compile(spec: ModuleSpec, params, run_cfg, *,  # noqa: A001
            calibration=None, device: DeviceLike = None,
            verify: bool = True) -> CompiledModel:
    """Compile a declared model against concrete parameters on ``device``
    (``None`` = the CUDA device; raises when there is none).  The
    parameters are moved there first, then every analog layer is lowered
    once: a stack into one AnalogPlan, a tree into plan entries beside the
    params (fusion groups planned from ``spec.groups``), a block into one
    block plan.  ``calibration`` (a CalibrationSnapshot) bakes measured
    tables in place of the oracle fixed pattern (module docstring).

    ``verify=True`` (the default) runs the CHEAP static invariant rules
    (:mod:`repro_torch.verify.invariants`: shape/static-metadata only)
    over the spec and the lowered artifact and raises
    :class:`repro_torch.verify.VerifyError` on any diagnostic.  The full
    rule set (drift-swap, sharding coverage, packed layout) is
    :meth:`CompiledModel.verify`."""
    dev = resolve_device(device)
    acfg = _acfg(run_cfg)
    params = to_device(params, dev)
    with _trace.span("api.compile", spec=spec.name, kind=spec.kind,
                     mode=acfg.mode) as sp:
        before = lowering_count()
        if spec.kind == TREE:
            lowered = lower_tree(params, acfg, groups=spec.groups,
                                 calibration=calibration)
        elif spec.kind == BLOCK:
            if acfg.mode == "digital":
                raise ValueError(
                    f"spec {spec.name!r}: digital mode compiles no analog "
                    "block; run the transformer model path instead "
                    "(models.transformer)"
                )
            lowered = _compile_block(spec, params, acfg, calibration)
        elif acfg.mode == "digital":
            lowered = None
        else:
            assert spec.kind == STACK, spec.kind
            calibs = None
            if calibration is not None:
                calibs = [calibration.layer(l.name) for l in spec.layers]
            lowered = lower_stack(
                _stack_params(spec, params), acfg,
                signed_inputs=[l.signed_input for l in spec.layers],
                epilogues=[l.epilogue for l in spec.layers],
                flatten_outs=[l.flatten_out for l in spec.layers],
                input_domain=spec.input_domain,
                calibs=calibs,
            )
        sp.add(lowerings=lowering_count() - before)
        if verify:
            from repro_torch.verify import invariants as _inv

            diags = _inv.verify_spec(spec)
            if lowered is not None:
                diags = diags + _inv.verify_plan(
                    lowered, spec=spec, calibration=calibration,
                    cheap_only=True,
                )
            for d in diags:
                _trace.event("verify.diagnostic", rule=d.rule,
                             path=d.path, message=d.message)
            sp.add(diagnostics=len(diags))
            _inv.check(diags)
    return CompiledModel(spec=spec, params=params, run_cfg=run_cfg,
                         lowered=lowered, device=dev,
                         calibration=calibration)
