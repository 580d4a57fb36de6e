"""Static plan/spec invariant rules (port of ``repro.verify.invariants``):
check compiled artifacts BEFORE execution.

Every invariant the executor bakes into its frozen plans - domain chains,
dispatch counts, chunk geometry, fused-group layout, drift swaps that
keep the plan's structure, sharding-spec coverage, calibration
compatibility - is a named rule over the plan dataclasses of
:mod:`repro_torch.exec.plan` (and the lowered params trees that carry
them).  A violated rule returns a :class:`Diagnostic` naming the rule,
the path of the offending leaf (``plan.layers[1].chunk_offset``, the
reference's path for the same leaf) and a fix hint.

Rules come in two tiers:

- **cheap** rules read only ``.shape`` / ``.ndim`` / ``.dtype`` and
  static metadata, never a tensor's values, so they cause no host-device
  synchronisation: ``api.compile(..., verify=True)`` runs exactly these
  on every compile, the train step's per-step recompile included.  One
  exception: ``calibration-compat`` compares the shared input LSBs
  (``a_scale_in``) of a calibrated fusion group, and reads them in ONE
  batched copy per calibrated compile (only when the spec declares
  groups whose snapshot records carry such scales);
- the full tier (drift-swap, sharding-specs, packed-layout) builds plans,
  reads one scalar per store and copies one chunk of it to the host, and
  runs from
  :meth:`repro_torch.api.program.CompiledModel.verify`, ``python -m
  repro_torch.verify`` and the sweep.

The port walks plain dataclasses, dicts and tuples.  Where the reference
keeps ONE scan-stacked plan whose leaves carry an ``[S, ...]`` prefix,
the port keeps a :class:`~repro_torch.exec.plan.PlanStack` of member
plans: member ``i`` adds an index step to the path
(``..._plan[i].store.codes``), and the rules see each member as a plain
plan.

Entry points: :func:`verify_plan`, :func:`verify_spec`,
:func:`verify_model`, :func:`verify_swap`, :func:`check`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.exec.plan import (
    EPILOGUE_NONE,
    EPILOGUE_RELU_SHIFT,
    GROUP_BATCH_CONCAT,
    GROUP_COLUMN_CONCAT,
    GROUP_EXPERT_STACK,
    GROUP_KINDS,
    INPUT_CODES,
    INPUT_FLOAT,
    PYTREE_FIELDS,
    AnalogPlan,
    GroupPlan,
    LayerPlan,
    MegakernelPack,
    PlanStack,
)
from repro_torch.distributed.sharding import _SPEC_LEAF
from repro_torch.verify import domains as dom

SIGNED_MODES = ("none", "split", "offset")
EPILOGUES = (EPILOGUE_NONE, EPILOGUE_RELU_SHIFT)

@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verifier finding: which rule fired, WHERE in the artifact
    (a path like ``plan.layers[1].chunk_offset``), what is wrong, and how
    to fix it."""

    rule: str
    path: str
    message: str
    hint: str = ""

    def __str__(self) -> str:
        s = f"[{self.rule}] {self.path}: {self.message}"
        if self.hint:
            s += f"  (fix: {self.hint})"
        return s


class VerifyError(ValueError):
    """Raised by :func:`check` (and ``api.compile(..., verify=True)``)
    when any invariant rule fired; ``.diagnostics`` carries the findings."""

    def __init__(self, diagnostics):
        self.diagnostics = tuple(diagnostics)
        super().__init__(
            "plan verification failed "
            f"({len(self.diagnostics)} diagnostic(s)):\n"
            + "\n".join(f"  {d}" for d in self.diagnostics)
        )


@dataclasses.dataclass(frozen=True)
class Rule:
    """One registered invariant rule.  ``cheap`` rules read shapes and
    static metadata only (the default ``api.compile(..., verify=True)``
    tier)."""

    id: str
    cheap: bool
    fn: Callable
    doc: str


RULES: Dict[str, Rule] = {}


def rule(rule_id: str, *, cheap: bool):
    def deco(fn):
        RULES[rule_id] = Rule(
            id=rule_id, cheap=cheap, fn=fn,
            doc=(fn.__doc__ or "").strip().split("\n")[0],
        )
        return fn
    return deco


# --------------------------------------------------------------------------
# walking an artifact
# --------------------------------------------------------------------------
def leaves_with_path(obj, path: str = "", *, is_leaf=None
                     ) -> Iterator[Tuple[str, Any]]:
    """Every leaf of a lowered artifact with its path, in the order and
    with the path strings of the reference's
    ``jax.tree_util.tree_flatten_with_path`` + ``keystr``: dict entries
    ``['key']`` (sorted keys), sequence items ``[i]``, plan fields
    ``.name`` (data fields only); ``None`` has no leaves."""
    if is_leaf is not None and is_leaf(obj):
        yield path, obj
    elif obj is None:
        return
    elif type(obj) in PYTREE_FIELDS:
        for f in PYTREE_FIELDS[type(obj)][0]:
            yield from leaves_with_path(getattr(obj, f), f"{path}.{f}",
                                        is_leaf=is_leaf)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from leaves_with_path(obj[k], f"{path}[{k!r}]",
                                        is_leaf=is_leaf)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from leaves_with_path(v, f"{path}[{i}]", is_leaf=is_leaf)
    else:
        yield path, obj


def structure(obj):
    """The artifact's structure with its static metadata (the port's
    treedef): equal for two artifacts exactly when one may replace the
    other in a replay without a different code path."""
    if obj is None:
        return None
    if type(obj) in PYTREE_FIELDS:
        data, meta = PYTREE_FIELDS[type(obj)]
        return (type(obj).__name__,
                tuple(getattr(obj, f) for f in meta),
                tuple(structure(getattr(obj, f)) for f in data))
    if isinstance(obj, dict):
        return ("dict", tuple((k, structure(obj[k])) for k in sorted(obj)))
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, tuple(structure(v) for v in obj))
    return "*"


@dataclasses.dataclass
class _Ctx:
    lowered: Any
    # the artifact's root path (verify_plan's ``path``): snapshot and
    # placement names are tree paths below it
    root: str = ""
    spec: Any = None
    calibration: Any = None
    plans: List[Tuple[str, AnalogPlan]] = dataclasses.field(
        default_factory=list)
    layers: List[Tuple[str, LayerPlan]] = dataclasses.field(
        default_factory=list)
    groups: List[Tuple[str, GroupPlan]] = dataclasses.field(
        default_factory=list)
    # paths of group-fused layers: their codes carry the member/expert
    # axis (batch_concat / expert_stack), one more leading axis than a
    # plain layer
    fused_paths: set = dataclasses.field(default_factory=set)
    # scan-stacked "_plan" entries (path -> PlanStack of LayerPlans): the
    # reference's stacked plan at that path
    stacks: Dict[str, PlanStack] = dataclasses.field(default_factory=dict)
    # fleet context (repro_torch.fleet): a Placement unlocks the
    # placement-coverage rule, a FleetSnapshot the fleet-calibration rule
    placement: Any = None
    fleet: Any = None


def _collect(ctx: _Ctx, node, path: str) -> None:
    if isinstance(node, AnalogPlan):
        ctx.plans.append((path, node))
        for i, lp in enumerate(node.layers):
            ctx.layers.append((f"{path}.layers[{i}]", lp))
    elif isinstance(node, GroupPlan):
        ctx.groups.append((path, node))
        ctx.layers.append((f"{path}.fused", node.fused))
        ctx.fused_paths.add(f"{path}.fused")
    elif isinstance(node, LayerPlan):
        ctx.layers.append((path, node))
    elif isinstance(node, dict):
        for k, v in node.items():
            _collect(ctx, v, f"{path}.{k}" if path else str(k))
    elif isinstance(node, (list, tuple)):
        if (isinstance(node, PlanStack) and len(node)
                and all(isinstance(m, LayerPlan) for m in node)):
            ctx.stacks[path] = node
        for i, v in enumerate(node):
            _collect(ctx, v, f"{path}[{i}]")


def _shape(x) -> Optional[tuple]:
    s = getattr(x, "shape", None)
    return None if s is None else tuple(int(d) for d in s)


def _ndim(x) -> int:
    return getattr(x, "ndim", 0)


@dataclasses.dataclass(frozen=True)
class _Named:
    """A lowered layer found by its snapshot / placement name: the layer
    (member 0 of a scan stack) and the stack size (0 for a plain
    layer) - the reference's stacked codes have ``ndim`` 3."""

    lp: LayerPlan
    s: int = 0

    @property
    def nd(self) -> int:
        return _ndim(self.lp.store.codes) + (1 if self.s else 0)

    @property
    def n_chunks(self) -> int:
        return int(self.lp.store.codes.shape[-2]) // self.lp.chunk_rows


def _by_name(ctx: _Ctx) -> Dict[str, _Named]:
    """Lowered layers by name: a stack spec's layer names, and each tree
    ``"_plan"`` entry's path below the root without the suffix (the
    dotted tree path that snapshots and placements use)."""
    out: Dict[str, _Named] = {}
    lead = f"{ctx.root}." if ctx.root else ""

    def name(path):
        return path[len(lead): -len("._plan")] if path.startswith(
            lead) else path[: -len("._plan")]

    spec = ctx.spec
    if spec is not None and getattr(spec, "kind", None) == "stack":
        for (_, plan) in ctx.plans[:1]:
            for l, lp in zip(spec.layers, plan.layers):
                out[l.name] = _Named(lp)
    for path, lp in ctx.layers:
        if path.endswith("._plan"):
            out.setdefault(name(path), _Named(lp))
    for path, st in ctx.stacks.items():
        if path.endswith("._plan"):
            out.setdefault(name(path), _Named(st[0], len(st)))
    return out


# --------------------------------------------------------------------------
# cheap rules (shape / static metadata only)
# --------------------------------------------------------------------------
@rule("chunk-alignment", cheap=True)
def _chunk_alignment(ctx: _Ctx):
    """Every baked table matches the layer's chunk grid: the packed
    codes are padded to whole chunks and [*, K_pad, N]; w_scale /
    chunk_offset / colsum / bias trailing dims agree with
    (n_chunks, N)."""
    for path, lp in ctx.layers:
        w = lp.store.codes
        nd = _ndim(w)
        # group-fused layers carry the member/expert axis
        nd_ok = (2, 3, 4) if path in ctx.fused_paths else (2, 3)
        if nd not in nd_ok:
            yield Diagnostic(
                "chunk-alignment", f"{path}.store.codes",
                f"packed codes must be [K_pad, N] with at most "
                f"{nd_ok[-1] - 2} stack/member axes; got ndim={nd}",
                "lower through repro_torch.exec.lower / "
                "repro_torch.api.compile",
            )
            continue
        k_pad, n = int(w.shape[-2]), int(w.shape[-1])
        stack = tuple(int(s) for s in w.shape[:-2])
        if lp.chunk_rows <= 0 or k_pad % lp.chunk_rows:
            yield Diagnostic(
                "chunk-alignment", f"{path}.store.codes",
                f"{k_pad} weight rows are not a whole number of "
                f"{lp.chunk_rows}-row chunks",
                "re-lower the layer (lower_layer pads K to the chunk "
                "grid)",
            )
            continue
        if k_pad < lp.k:
            yield Diagnostic(
                "chunk-alignment", f"{path}.store.codes",
                f"padded rows K_pad={k_pad} < logical k={lp.k}",
                "static k must be the pre-padding logical width",
            )
        if n != lp.n:
            yield Diagnostic(
                "chunk-alignment", f"{path}.store.codes",
                f"packed codes have {n} columns but static n={lp.n}",
                "re-lower the layer; n is the output width",
            )
        n_chunks = k_pad // lp.chunk_rows
        ws = _shape(lp.w_scale)
        if ws is None or ws[-1] != n or ws[:-2] != stack:
            yield Diagnostic(
                "chunk-alignment", f"{path}.w_scale",
                f"w_scale shape {ws} does not provide one LSB per "
                f"output column (N={n})",
                "w_scale is [*, 1, N] (per-column weight LSB)",
            )
        if lp.chunk_offset is not None:
            cs = _shape(lp.chunk_offset)
            if cs[-2:] != (n_chunks, n) or cs[:-2] != stack:
                yield Diagnostic(
                    "chunk-alignment", f"{path}.chunk_offset",
                    f"offset table shape {cs} does not match the "
                    f"({n_chunks}, {n}) chunk grid",
                    "bake offsets for this layer's geometry (or drop "
                    "the table and re-lower)",
                )
        for field in ("colsum", "bias"):
            v = getattr(lp, field)
            if v is not None and _shape(v)[-1] != n:
                yield Diagnostic(
                    "chunk-alignment", f"{path}.{field}",
                    f"{field} shape {_shape(v)} does not cover the "
                    f"{n} output columns",
                    "re-lower the layer",
                )


def _tag_diags(path: str, lp: LayerPlan, epilogue_msg: str):
    if lp.epilogue not in EPILOGUES:
        yield Diagnostic(
            "domain-chain", f"{path}.epilogue", epilogue_msg,
            f"use one of {EPILOGUES}",
        )
    if lp.signed_input not in SIGNED_MODES:
        yield Diagnostic(
            "domain-chain", f"{path}.signed_input",
            f"unknown signed encoding {lp.signed_input!r}",
            f"use one of {SIGNED_MODES}",
        )


@rule("domain-chain", cheap=True)
def _domain_chain(ctx: _Ctx):
    """The hand-off chain is legal: known epilogue/signed/input-domain
    tags and every layer's output width feeds the next layer's input
    (flatten hand-offs divide)."""
    for ppath, plan in ctx.plans:
        if plan.input_domain not in (None, INPUT_CODES, INPUT_FLOAT):
            yield Diagnostic(
                "domain-chain", f"{ppath}.input_domain",
                f"unknown input domain {plan.input_domain!r}",
                "use 'codes', 'float' or None (legacy inference)",
            )
        last = len(plan.layers) - 1
        for i, lp in enumerate(plan.layers):
            lpath = f"{ppath}.layers[{i}]"
            yield from _tag_diags(
                lpath, lp, f"unknown epilogue {lp.epilogue!r}; no entry in "
                "the domain-transition table")
            if plan.block is not None:
                continue      # block glue (attention, swiglu) reshapes
                              # between layers; widths do not telescope
            if i < last:
                nxt = plan.layers[i + 1]
                if lp.flatten_out:
                    if nxt.k % lp.n:
                        yield Diagnostic(
                            "domain-chain", lpath,
                            f"flatten hand-off width n={lp.n} does not "
                            f"divide layer {i + 1} width k={nxt.k}",
                            "the im2col position merge needs "
                            "k[i+1] = positions * n[i]",
                        )
                elif nxt.k != lp.n:
                    yield Diagnostic(
                        "domain-chain", lpath,
                        f"hand-off width n={lp.n} does not feed layer "
                        f"{i + 1} width k={nxt.k}",
                        "declare matching layer dims (the ModuleSpec "
                        "chain must telescope)",
                    )
    # standalone layers (tree "_plan" entries) get tag checks too
    in_plans = {id(lp) for _, p in ctx.plans for lp in p.layers}
    for path, lp in ctx.layers:
        if id(lp) not in in_plans:
            yield from _tag_diags(path, lp,
                                  f"unknown epilogue {lp.epilogue!r}")


@rule("pack-consistency", cheap=True)
def _pack_consistency(ctx: _Ctx):
    """A megakernel packing is present exactly when the domain table says
    the chain is eligible (an eligible-but-unpacked plan silently costs
    L dispatches instead of 1; an ineligible-but-packed plan would replay
    wrong numerics)."""
    for ppath, plan in ctx.plans:
        reason = dom.chain_ineligible_reason(plan)
        if reason is None and plan.mega is None:
            yield Diagnostic(
                "pack-consistency", f"{ppath}.mega",
                "chain is megakernel-eligible but carries no packing "
                "(replay falls back to one dispatch per layer)",
                "re-lower via lower_stack/compile, or "
                "dataclasses.replace(plan, mega=pack_megakernel(plan))",
            )
        elif reason is not None and plan.mega is not None:
            yield Diagnostic(
                "pack-consistency", f"{ppath}.mega",
                f"plan carries a megakernel packing but the chain is "
                f"ineligible: {reason}",
                "drop the stale packing and re-lower",
            )


@rule("dispatch-count", cheap=True)
def _dispatch_count(ctx: _Ctx):
    """``AnalogPlan.expected_dispatches`` agrees with the domain table,
    and the packed schedule mirrors the layers one-to-one (tags, widths,
    chunk geometry, row offsets)."""
    for ppath, plan in ctx.plans:
        if plan.block is None and len(plan.layers):
            want = dom.expected_dispatches(
                dom.DOMAIN_CODES if plan.expects_codes
                else dom.DOMAIN_FLOAT,
                [lp.epilogue for lp in plan.layers],
                [lp.signed_input for lp in plan.layers],
                fused_split=plan.cfg.fused_split,
            )
            got = plan.expected_dispatches
            if got != want:
                yield Diagnostic(
                    "dispatch-count", ppath,
                    f"expected_dispatches={got} but the domain-transition "
                    f"table counts {want} per layer-by-layer replay",
                    "the plan's counting walk drifted from "
                    "repro_torch.verify.domains.DOMAIN_AFTER",
                )
        mega = plan.mega
        if mega is None:
            continue
        yield from _schedule_diags(f"{ppath}.mega", plan, mega)


def _schedule_diags(mpath: str, plan: AnalogPlan, mega: MegakernelPack):
    layers = plan.layers
    if len(mega.schedule) != len(layers):
        yield Diagnostic(
            "dispatch-count", f"{mpath}.schedule",
            f"packed schedule has {len(mega.schedule)} entries for "
            f"{len(layers)} layers",
            "re-pack (pack_megakernel)",
        )
        return
    if layers and mega.chunk_rows != layers[0].chunk_rows:
        yield Diagnostic(
            "dispatch-count", f"{mpath}.chunk_rows",
            f"packed chunk_rows={mega.chunk_rows} disagrees with "
            f"layer 0 ({layers[0].chunk_rows})",
            "re-pack",
        )
    if mega.n_max % 128 or any(lp.n > mega.n_max for lp in layers):
        yield Diagnostic(
            "dispatch-count", f"{mpath}.n_max",
            f"lane width n_max={mega.n_max} is not 128-aligned or "
            "smaller than a layer output",
            "re-pack",
        )
    if plan.block is not None:
        domains = [dom.DOMAIN_FLOAT] * len(layers)
        handoffs = ("attn", "res_ln", "swiglu", "res_out")
    else:
        domains = dom.consumed_domains(plan)
        last = len(layers) - 1
        handoffs = tuple(
            dom.handoff_tag(lp.epilogue, i == last)
            for i, lp in enumerate(layers)
        )
    row0 = c0 = 0
    for i, (m, lp) in enumerate(zip(mega.schedule, layers)):
        spath = f"{mpath}.schedule[{i}]"
        k_pad = int(lp.store.codes.shape[-2])
        n_chunks = k_pad // lp.chunk_rows
        geom = dict(k=lp.k, n=lp.n, k_pad=k_pad, n_chunks=n_chunks,
                    shift=lp.shift, row0=row0, c0=c0,
                    relu_shift=lp.epilogue == EPILOGUE_RELU_SHIFT)
        for field, want in geom.items():
            if getattr(m, field) != want:
                yield Diagnostic(
                    "dispatch-count", f"{spath}.{field}",
                    f"schedule says {field}={getattr(m, field)} but "
                    f"layer {i} has {field}={want}",
                    "the packed schedule no longer matches its "
                    "layers; re-pack",
                )
        want_enc = dom.encode_tag(domains[i], lp.signed_input)
        if m.encode != want_enc:
            yield Diagnostic(
                "dispatch-count", f"{spath}.encode",
                f"schedule encodes {m.encode!r} but layer {i} "
                f"consumes {domains[i]!r} "
                f"(signed_input={lp.signed_input!r}) "
                f"=> {want_enc!r}",
                "re-pack",
            )
        if m.handoff != handoffs[i]:
            yield Diagnostic(
                "dispatch-count", f"{spath}.handoff",
                f"schedule hands off {m.handoff!r} but the domain "
                f"table derives {handoffs[i]!r}",
                "re-pack",
            )
        row0 += k_pad
        c0 += n_chunks
    rows = sum(
        int(s.codes.shape[-2]) for s in mega.stores
        if _shape(s.codes) is not None
    )
    if len(mega.stores) != len(layers) or rows != row0:
        yield Diagnostic(
            "dispatch-count", f"{mpath}.stores",
            f"packed stores cover {len(mega.stores)} layers / "
            f"{rows} rows, schedule covers {len(layers)} layers / "
            f"{row0} rows",
            "re-pack",
        )


@rule("group-layout", cheap=True)
def _group_layout(ctx: _Ctx):
    """Fused-group plans carry the layout their kind promises: member
    widths tile the fused columns (column_concat), every leaf rides the
    member axis (batch_concat) / expert axis (expert_stack), and the
    shared input LSB ``a_scale_in`` has the kind's shape."""
    for path, gp in ctx.groups:
        if gp.kind not in GROUP_KINDS:
            yield Diagnostic(
                "group-layout", f"{path}.kind",
                f"unknown fusion kind {gp.kind!r}",
                f"use one of {GROUP_KINDS}",
            )
            continue
        g = len(gp.member_names)
        if g == 0 or len(gp.member_ns) != g:
            yield Diagnostic(
                "group-layout", f"{path}.member_ns",
                f"{len(gp.member_ns)} member widths for {g} members",
                "GroupPlan.member_ns records each member's output width",
            )
            continue
        lp = gp.fused
        nd = _ndim(lp.store.codes)
        if gp.kind == GROUP_COLUMN_CONCAT:
            if sum(gp.member_ns) != lp.n:
                yield Diagnostic(
                    "group-layout", f"{path}.fused",
                    f"member widths {gp.member_ns} sum to "
                    f"{sum(gp.member_ns)} but the fused plan has "
                    f"{lp.n} columns",
                    "column_concat concatenates member output columns; "
                    "re-lower the group",
                )
            if lp.a_scale_in is not None and _ndim(lp.a_scale_in) != nd - 2:
                yield Diagnostic(
                    "group-layout", f"{path}.fused.a_scale_in",
                    "a shared input LSB must be one scalar per fused "
                    f"dispatch; got shape {_shape(lp.a_scale_in)}",
                    "calibrate the group with share_group_input_scale",
                )
        elif gp.kind == GROUP_BATCH_CONCAT:
            # [G, K_pad, N]; a PlanStack member is one slice of the
            # reference's [S, G, K_pad, N]
            ax = max(nd - 3, 0)
            if nd not in (3, 4) or int(lp.store.codes.shape[ax]) != g:
                yield Diagnostic(
                    "group-layout", f"{path}.fused.store.codes",
                    f"batch_concat needs a [{g}, K_pad, N] member-"
                    f"stacked weight (optional scan-stack prefix); got "
                    f"shape {_shape(lp.store.codes)}",
                    "lower via lower_batch_concat",
                )
            if any(n != lp.n for n in gp.member_ns):
                yield Diagnostic(
                    "group-layout", f"{path}.member_ns",
                    f"batch_concat members must share the output width "
                    f"{lp.n}; got {gp.member_ns}",
                    "members with different widths need column_concat",
                )
            for field in ("a_scale", "a_scale_in"):
                v = getattr(lp, field)
                if v is not None and (_ndim(v) < ax + 1
                                      or int(v.shape[ax]) != g):
                    yield Diagnostic(
                        "group-layout", f"{path}.fused.{field}",
                        f"per-member {field} must stack along the "
                        f"member axis [{g}]; got shape {_shape(v)}",
                        "each batch_concat member keeps its own input "
                        "encoding; re-lower the group",
                    )
        elif gp.kind == GROUP_EXPERT_STACK:
            if len(gp.member_names) != 1:
                yield Diagnostic(
                    "group-layout", f"{path}.member_names",
                    f"expert_stack groups have ONE stacked member; got "
                    f"{gp.member_names}",
                    "declare one group per stacked [E, K, N] weight",
                )
            if nd not in (3, 4):
                yield Diagnostic(
                    "group-layout", f"{path}.fused.store.codes",
                    f"expert_stack needs an [E, K_pad, N] stacked "
                    f"weight (optional scan-stack prefix); got shape "
                    f"{_shape(lp.store.codes)}",
                    "lower via lower_expert_stack",
                )


def _group_scales(spec, cal) -> List[Tuple[str, List[float]]]:
    """Each declared group's members' shared input LSBs, for the groups
    whose snapshot records carry two or more: read to the host in ONE
    batched copy (the tables may live on the card)."""
    found = []
    for g in getattr(spec, "groups", ()):
        recs = [cal.layer(m) for m in g.members]
        scales = [r.a_scale_in for r in recs
                  if r is not None and r.a_scale_in is not None]
        if len(scales) >= 2:
            found.append((g.name, scales))
    if not found:
        return []
    flat = [torch.as_tensor(s, dtype=torch.float32).detach().reshape(())
            for _, ss in found for s in ss]
    dev = next((t.device for t in flat if t.device.type != "cpu"),
               torch.device("cpu"))
    vals = torch.stack([t.to(dev) for t in flat]).tolist()   # the one read
    out, i = [], 0
    for name, ss in found:
        out.append((name, vals[i:i + len(ss)]))
        i += len(ss)
    return out


@rule("calibration-compat", cheap=True)
def _calibration_compat(ctx: _Ctx):
    """A baked calibration snapshot is compatible: known format version,
    per-layer tables shaped like the plan's chunk grid, and one shared
    input LSB across every fused group's members."""
    cal = ctx.calibration
    if cal is None:
        return
    from repro_torch.calib.snapshot import FORMAT_VERSION

    if getattr(cal, "version", FORMAT_VERSION) != FORMAT_VERSION:
        yield Diagnostic(
            "calibration-compat", "calibration.version",
            f"snapshot format {cal.version!r} is not {FORMAT_VERSION!r}",
            "re-measure or migrate the snapshot",
        )
    by_name = _by_name(ctx)
    for name, rec in sorted(getattr(cal, "layers", {}).items()):
        found = by_name.get(name)
        for field in ("gain_table", "chunk_offset"):
            t = getattr(rec, field, None)
            if t is None:
                continue
            ts = _shape(t)
            if len(ts) not in (2, 3):
                yield Diagnostic(
                    "calibration-compat",
                    f"calibration[{name!r}].{field}",
                    f"{field} must be a [chunks, N] table (or a "
                    f"per-stack-member [S, chunks, N] table); got shape "
                    f"{ts}",
                    "measure per-(chunk, column) tables",
                )
                continue
            if found is None:
                continue
            nd = found.nd
            if len(ts) == 2 and nd == 2:
                want = (found.n_chunks, found.lp.n)
            elif len(ts) == 3 and nd == 3:
                lead = found.s or int(found.lp.store.codes.shape[0])
                want = (lead, found.n_chunks, found.lp.n)
            else:
                yield Diagnostic(
                    "calibration-compat",
                    f"calibration[{name!r}].{field}",
                    f"{field} rank {len(ts)} does not match the lowered "
                    f"layer (codes ndim={nd}): a scan-stacked layer "
                    "takes [S, chunks, N] tables, a plain layer "
                    "[chunks, N]",
                    "re-measure against the current geometry",
                )
                continue
            if ts != want:
                yield Diagnostic(
                    "calibration-compat",
                    f"calibration[{name!r}].{field}",
                    f"{field} shape {ts} does not match the "
                    f"{want} chunk grid of the lowered layer",
                    "re-measure against the current geometry",
                )
    # fused groups calibrated under ONE shared input LSB
    if ctx.spec is not None:
        for gname, vals in _group_scales(ctx.spec, cal):
            if any(v != vals[0] for v in vals[1:]):
                yield Diagnostic(
                    "calibration-compat",
                    f"calibration[{gname!r}].a_scale_in",
                    f"group members disagree on the shared input LSB: "
                    f"{vals}",
                    "fit the group with "
                    "calib.routines.share_group_input_scale",
                )


@rule("placement-coverage", cheap=True)
def _placement_coverage(ctx: _Ctx):
    """A fleet Placement books every layer tile exactly once on a
    serving chip: chip/slot ids inside the fleet grid, no (chip, slot)
    double-booked, the spare pool empty, per-layer sites matching the
    plan_tiles grid of the declared shapes, and placed shapes agreeing
    with the name-matched lowered layers."""
    pl = ctx.placement
    if pl is None:
        return
    from repro_torch.fleet.placement import _layer_sites

    spares = set(pl.spares)
    booked: Dict[tuple, str] = {}
    for a in pl.assignments:
        apath = (f"placement[{a.layer!r}]"
                 f"[s{a.stack},c{a.chunk},t{a.coltile}]")
        if not (0 <= a.chip < pl.n_chips and 0 <= a.slot < pl.slots):
            yield Diagnostic(
                "placement-coverage", apath,
                f"(chip {a.chip}, slot {a.slot}) lies outside the fleet "
                f"grid [0, {pl.n_chips}) x [0, {pl.slots})",
                "re-place with fleet.place_model",
            )
            continue
        if a.chip in spares:
            yield Diagnostic(
                "placement-coverage", apath,
                f"tile assigned to spare chip {a.chip}",
                "spares stay empty until remap() promotes them",
            )
        key = (a.chip, a.slot)
        if key in booked:
            yield Diagnostic(
                "placement-coverage", apath,
                f"(chip {a.chip}, slot {a.slot}) is double-booked "
                f"(also holds {booked[key]})",
                "one tile per chunk slot",
            )
        else:
            booked[key] = apath
    # exact site coverage: every tile of every declared shape, once
    placed: Dict[str, set] = {}
    for a in pl.assignments:
        placed.setdefault(a.layer, set()).add(a.site)
    for name, shape in pl.shapes:
        want = set(_layer_sites(
            name, shape, chunk_rows=pl.chunk_rows, cols=pl.cols))
        got = placed.pop(name, set())
        missing, extra = want - got, got - want
        if missing or extra:
            yield Diagnostic(
                "placement-coverage", f"placement[{name!r}]",
                f"tile set diverges from the plan_tiles grid of shape "
                f"{shape}: {len(missing)} site(s) missing, "
                f"{len(extra)} unknown",
                "place every (stack, chunk, coltile) site exactly once",
            )
    for name in sorted(placed):
        yield Diagnostic(
            "placement-coverage", f"placement[{name!r}]",
            "assignments exist for a layer absent from placement.shapes",
            "build placements from the model's layer shapes "
            "(fleet.model_layer_shapes)",
        )
    # placed shapes agree with the name-matched lowered layers
    by_name = _by_name(ctx)
    for name, shape in pl.shapes:
        found = by_name.get(name)
        if found is None:
            continue
        lp, nd = found.lp, found.nd
        if (len(shape) == 3) != (nd == 3):
            yield Diagnostic(
                "placement-coverage", f"placement[{name!r}]",
                f"placed shape {shape} and the lowered layer "
                f"(codes ndim={nd}) disagree on scan-stacking",
                "re-place from the compiled model's layer shapes",
            )
            continue
        if shape[-1] != lp.n:
            yield Diagnostic(
                "placement-coverage", f"placement[{name!r}]",
                f"placed shape {shape} has {shape[-1]} columns, the "
                f"lowered layer {lp.n}",
                "re-place from the compiled model's layer shapes",
            )
        elif pl.chunk_rows == lp.chunk_rows:
            want_chunks = -(-shape[-2] // pl.chunk_rows)
            if want_chunks != found.n_chunks:
                yield Diagnostic(
                    "placement-coverage", f"placement[{name!r}]",
                    f"placed shape {shape} spans {want_chunks} row "
                    f"chunks, the lowered layer {found.n_chunks}",
                    "re-place from the compiled model's layer shapes",
                )


@rule("fleet-calibration-compat", cheap=True)
def _fleet_calibration_compat(ctx: _Ctx):
    """A FleetSnapshot is servable: known fleet format version, 3-D
    [chips, chunks, N] gain/offset tables of one shape, and - when a
    Placement is present - enough chips, chunk slots and columns to
    cover the placement grid."""
    fs = ctx.fleet
    if fs is None:
        return
    from repro_torch.fleet.calibrate import FLEET_FORMAT_VERSION

    if getattr(fs, "version", FLEET_FORMAT_VERSION) != FLEET_FORMAT_VERSION:
        yield Diagnostic(
            "fleet-calibration-compat", "fleet.version",
            f"fleet snapshot format {fs.version!r} is not "
            f"{FLEET_FORMAT_VERSION!r}",
            "re-measure or migrate the snapshot",
        )
    gs, os_ = _shape(fs.gain_table), _shape(fs.chunk_offset)
    if gs is None or os_ is None or len(gs) != 3 or gs != os_:
        yield Diagnostic(
            "fleet-calibration-compat", "fleet.gain_table",
            f"fleet tables must be one [chips, chunks, N] pair; got "
            f"gain {gs} / offset {os_}",
            "calibrate with fleet.calibrate_fleet",
        )
        return
    pl = ctx.placement
    if pl is None:
        return
    d, c, n = gs
    if d < pl.n_chips:
        yield Diagnostic(
            "fleet-calibration-compat", "fleet.gain_table",
            f"snapshot covers {d} chips, the placement addresses "
            f"{pl.n_chips}",
            "calibrate the whole fleet, spares included",
        )
    if c < pl.slots:
        yield Diagnostic(
            "fleet-calibration-compat", "fleet.gain_table",
            f"snapshot has {c} chunk slots per chip, the placement "
            f"packs {pl.slots}",
            "fleet chips must expose every placed slot",
        )
    if n < pl.cols:
        yield Diagnostic(
            "fleet-calibration-compat", "fleet.gain_table",
            f"snapshot has {n} columns per chip, the placement tiles "
            f"{pl.cols}-wide",
            "fleet chips must expose every placed column",
        )


# --------------------------------------------------------------------------
# full-tier rules (build plans, copy a probe to the host)
# --------------------------------------------------------------------------
@rule("drift-swap", cheap=False)
def _drift_swap(ctx: _Ctx):
    """An offset hot-swap keeps the plan's structure: swapping a plan's
    own offset tables back in reproduces the identical dataclass
    structure, static metadata and leaf shapes/dtypes/devices (so a
    replay keeps its code path and buffers)."""
    from repro_torch.exec.lower import plan_with_offsets

    for ppath, plan in ctx.plans:
        offs = [lp.chunk_offset for lp in plan.layers]
        if not plan.layers or all(o is None for o in offs):
            continue
        try:
            swapped = plan_with_offsets(plan, offs)
        except Exception as e:      # noqa: BLE001 - report, don't crash
            yield Diagnostic(
                "drift-swap", ppath,
                f"identity offset swap failed: {e}",
                "plan_with_offsets must accept the plan's own tables",
            )
            continue
        yield from verify_swap(plan, swapped, path=ppath)


@rule("sharding-specs", cheap=False)
def _sharding_specs(ctx: _Ctx):
    """Every plan leaf gets a logical-axis sharding spec: the spec tree
    from ``analog_plan_specs`` / ``plan_specs_like`` covers the lowered
    artifact leaf for leaf (a bare tensor left in the spec tree means a
    leaf the sharding rules cannot place)."""
    from repro_torch.distributed import sharding as shd

    spec = ctx.spec
    targets = []
    if ctx.plans and (spec is None or spec.kind in ("stack", "block")):
        for ppath, plan in ctx.plans:
            axes = [(None, None)] * len(plan.layers)
            if spec is not None and len(spec.layers) == len(plan.layers):
                axes = [l.sharding for l in spec.layers]
            try:
                specs = shd.analog_plan_specs(plan, axes)
            except Exception as e:  # noqa: BLE001
                yield Diagnostic(
                    "sharding-specs", ppath,
                    f"analog_plan_specs failed: {e}",
                    "every baked leaf needs a derivable logical spec",
                )
                continue
            targets.append((ppath, plan, specs))
    elif spec is not None and spec.kind == "tree" and \
            spec.param_axes is not None:
        try:
            specs = shd.plan_specs_like(spec.param_axes, ctx.lowered)
        except Exception as e:      # noqa: BLE001
            yield Diagnostic(
                "sharding-specs", "plan",
                f"plan_specs_like failed: {e}",
                "param_axes must mirror the params tree",
            )
            return
        targets.append(("plan", ctx.lowered, specs))
    for ppath, obj, specs in targets:
        got = {key for key, _ in leaves_with_path(obj)}
        have = set()
        for key, leaf in leaves_with_path(specs, is_leaf=_SPEC_LEAF):
            if _SPEC_LEAF(leaf):
                have.add(key)
            else:
                yield Diagnostic(
                    "sharding-specs", f"{ppath}{key}",
                    "plan leaf has no logical-axis spec (the sharding "
                    "derivation left a raw tensor in the spec tree)",
                    "extend distributed.sharding to name this leaf",
                )
        for key in sorted(got - have):
            yield Diagnostic(
                "sharding-specs", f"{ppath}{key}",
                "plan leaf missing from the derived sharding specs",
                "extend distributed.sharding to cover this leaf",
            )


def _host(t) -> "torch.Tensor":
    return t.detach().to("cpu")


@rule("packed-layout", cheap=False)
def _packed_layout(ctx: _Ctx):
    """Every plan's WeightStore is a valid packed bake: codes are 6-bit
    signed values (int8, or integer-valued fp32 STE codes of a store
    lowered under autograd), the gain tables match the chunk/column-block
    layout, and the dequantized ``w_eff`` view reproduces the
    code-times-gain product on a one-chunk probe (an independent numpy
    recompute, so a drifted dequant path cannot self-certify)."""
    import numpy as np

    from repro_torch.core.hw import BSS2

    for path, lp in ctx.layers:
        s = lp.store
        spath = f"{path}.store"
        codes = s.codes.detach()
        if codes.dtype not in (torch.int8, torch.float32):
            yield Diagnostic(
                "packed-layout", f"{spath}.codes",
                f"codes dtype {codes.dtype} is neither int8 nor fp32",
                "lower through repro_torch.exec.lower "
                "(lower_layer packs int8 codes)",
            )
            continue
        # the range and integrality checks run where the codes live; one
        # scalar comes back (and only the probe chunk below)
        if codes.dtype == torch.float32 and not torch.equal(
                codes, torch.round(codes)):
            yield Diagnostic(
                "packed-layout", f"{spath}.codes",
                "fp32 codes hold non-integer values",
                "codes are quantize_weight outputs; re-lower",
            )
            continue
        amax = 0.0
        if codes.numel():
            lo, hi = torch.aminmax(codes)
            amax = float(torch.maximum(-lo.to(torch.float32),
                                       hi.to(torch.float32)))
        if amax > BSS2.w_max:
            yield Diagnostic(
                "packed-layout", f"{spath}.codes",
                f"codes reach |{amax:.0f}| > the 6-bit signed range "
                f"+-{BSS2.w_max}",
                "codes are clipped at quantize time; re-lower",
            )
            continue
        k_pad, n = int(codes.shape[-2]), int(codes.shape[-1])
        pre = tuple(int(d) for d in codes.shape[:-2])
        n_chunks = k_pad // max(s.chunk_rows, 1)
        g = len(s.col_blocks) if s.col_blocks is not None else 1
        if s.col_blocks is not None and sum(s.col_blocks) != n:
            yield Diagnostic(
                "packed-layout", f"{spath}.col_blocks",
                f"column blocks {s.col_blocks} sum to "
                f"{sum(s.col_blocks)} but the codes have {n} columns",
                "re-lower the fused group",
            )
            continue
        shapes = {
            "w_scale": (s.w_scale, pre + (1, n)),
            "col_gain": (s.col_gain, pre + (n,)),
            "row_gain": (s.row_gain, pre + (g, k_pad)),
            "chunk_gain": (s.chunk_gain, pre + (n_chunks, n)),
            "gain_map": (s.gain_map, pre + (k_pad, n)),
        }
        bad = False
        for field, (v, want) in shapes.items():
            if v is not None and _shape(v) != want:
                yield Diagnostic(
                    "packed-layout", f"{spath}.{field}",
                    f"{field} shape {_shape(v)} does not match the "
                    f"{want} packed layout",
                    "re-lower the layer",
                )
                bad = True
        if bad:
            continue
        # probe: the first chunk of the dequant view vs an independent
        # numpy recompute of codes x gain tables (same multiply order)
        cr = min(s.chunk_rows, k_pad)
        w = _host(codes[..., :cr, :]).numpy().astype(np.float32)
        if s.col_gain is not None:
            w = w * _host(s.col_gain).numpy()[..., None, :]
        if s.row_gain is not None:
            rg = _host(s.row_gain[..., :cr]).numpy()
            if s.col_blocks is None:
                w = w * rg[..., 0, :, None]
            else:
                parts, c0 = [], 0
                for gi, nb in enumerate(s.col_blocks):
                    parts.append(
                        w[..., :, c0:c0 + nb] * rg[..., gi, :, None]
                    )
                    c0 += nb
                w = np.concatenate(parts, axis=-1)
        if s.chunk_gain is not None:
            w = w * _host(s.chunk_gain[..., :1, :]).numpy()
        if s.gain_map is not None:
            w = w * _host(s.gain_map[..., :cr, :]).numpy()
        # the store's derived view where it has derived one, else its
        # derivation of the first chunk alone (the probe derives no
        # whole w_eff: a store derives it at first read)
        cached = s.__dict__.get("_w_eff")
        with torch.no_grad():
            got = (s._derive_w_eff(rows=cr) if cached is None
                   else cached[..., :cr, :])
        got = _host(got.detach()).numpy()
        if not np.array_equal(got, w):
            yield Diagnostic(
                "packed-layout", f"{spath}.codes",
                "dequantized w_eff view disagrees with the packed "
                "codes x gain tables on the first-chunk probe",
                "the store's gain tables and its dequant path drifted "
                "apart; re-lower",
            )


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def verify_plan(lowered, *, spec=None, calibration=None,
                cheap_only: bool = False, path: str = "plan",
                rules: Optional[Tuple[str, ...]] = None,
                placement=None, fleet=None
                ) -> Tuple[Diagnostic, ...]:
    """Run the invariant rules over a lowered artifact (an
    :class:`~repro_torch.exec.plan.AnalogPlan`, a pre-lowered params
    tree, a :class:`~repro_torch.exec.plan.GroupPlan` or a bare LayerPlan)
    and return all diagnostics (empty tuple = clean).

    ``cheap_only`` restricts to the shape/static rules (what
    ``api.compile(..., verify=True)`` runs); ``rules`` names a subset
    explicitly.  ``spec`` / ``calibration`` unlock the spec-aware checks
    (sharding coverage, snapshot compatibility); ``placement`` (a
    :class:`repro_torch.fleet.Placement`) and ``fleet`` (a
    :class:`repro_torch.fleet.FleetSnapshot`) unlock the fleet rules."""
    ctx = _Ctx(lowered=lowered, root=path, spec=spec,
               calibration=calibration, placement=placement, fleet=fleet)
    _collect(ctx, lowered, path)
    out: List[Diagnostic] = []
    for r in RULES.values():
        if rules is not None and r.id not in rules:
            continue
        if cheap_only and not r.cheap:
            continue
        out.extend(r.fn(ctx))
    return tuple(out)


def verify_spec(spec) -> Tuple[Diagnostic, ...]:
    """Static checks on a :class:`~repro_torch.api.module.ModuleSpec`
    alone (construction already validates groups; this checks what
    construction cannot: the stack chain telescopes and every tag is
    known)."""
    out: List[Diagnostic] = []
    ppath = f"spec[{spec.name!r}]"
    if spec.input_domain not in (None, INPUT_CODES, INPUT_FLOAT):
        out.append(Diagnostic(
            "domain-chain", f"{ppath}.input_domain",
            f"unknown input domain {spec.input_domain!r}",
            "use 'codes', 'float' or None",
        ))
    for i, l in enumerate(spec.layers):
        lpath = f"{ppath}.layers[{i}]({l.name!r})"
        if l.epilogue not in EPILOGUES:
            out.append(Diagnostic(
                "domain-chain", f"{lpath}.epilogue",
                f"unknown epilogue {l.epilogue!r}",
                f"use one of {EPILOGUES}",
            ))
        if l.signed_input not in (None,) + SIGNED_MODES:
            out.append(Diagnostic(
                "domain-chain", f"{lpath}.signed_input",
                f"unknown signed encoding {l.signed_input!r}",
                f"use one of {SIGNED_MODES} or None",
            ))
        if spec.kind != "stack" or i + 1 >= len(spec.layers):
            continue
        nxt = spec.layers[i + 1]
        if l.flatten_out:
            if nxt.in_dim % l.out_dim:
                out.append(Diagnostic(
                    "domain-chain", lpath,
                    f"flatten hand-off width {l.out_dim} does not "
                    f"divide layer {i + 1} in_dim={nxt.in_dim}",
                    "k[i+1] must be positions * n[i]",
                ))
        elif nxt.in_dim != l.out_dim:
            out.append(Diagnostic(
                "domain-chain", lpath,
                f"out_dim={l.out_dim} does not feed layer {i + 1} "
                f"in_dim={nxt.in_dim}",
                "stack layer dims must telescope",
            ))
    return tuple(out)


def verify_model(model, *, cheap_only: bool = False
                 ) -> Tuple[Diagnostic, ...]:
    """Full verification of a :class:`repro_torch.api.program.
    CompiledModel`: spec rules plus every plan rule over its lowered
    artifact (digital models have no plans; only the spec is checked)."""
    out = list(verify_spec(model.spec))
    if model.lowered is not None:
        out.extend(verify_plan(
            model.lowered, spec=model.spec,
            calibration=model.calibration, cheap_only=cheap_only,
        ))
    return tuple(out)


def _abstract(x) -> tuple:
    return (_shape(x), getattr(x, "dtype", None),
            getattr(x, "device", None))


def verify_swap(old, new, *, path: str = "plan") -> Tuple[Diagnostic, ...]:
    """Check that ``new`` may hot-swap for ``old`` on the same code path:
    identical dataclass structure and static metadata
    (:func:`structure`), and identical leaf shapes, dtypes and devices.
    This is the contract of ``plan_with_offsets`` / ``swap_calibration``:
    table VALUES may change, nothing else."""
    if structure(old) != structure(new):
        return (Diagnostic(
            "drift-swap", path,
            "hot-swap changed the plan structure or static metadata "
            "(a replay would take another code path)",
            "swap only chunk_offset leaf values "
            "(plan_with_offsets/swap_calibration)",
        ),)
    out = []
    for (key, a), (_, b) in zip(leaves_with_path(old),
                                leaves_with_path(new)):
        if _abstract(a) != _abstract(b):
            out.append(Diagnostic(
                "drift-swap", f"{path}{key}",
                f"leaf changed shape/dtype across the swap: "
                f"{_shape(a)}/{getattr(a, 'dtype', None)} -> "
                f"{_shape(b)}/{getattr(b, 'dtype', None)}",
                "a hot-swap must keep every leaf's shape, dtype and "
                "device",
            ))
    return tuple(out)


def check(diagnostics) -> None:
    """Raise :class:`VerifyError` if any diagnostics were produced."""
    diagnostics = tuple(diagnostics)
    if diagnostics:
        raise VerifyError(diagnostics)
