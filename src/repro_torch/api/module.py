"""Declarative module specs: the "declare once" half of the front door
(port of the stack and tree kinds of ``repro.api.module``).

- ``"stack"``: the layers ARE the model - an ordered chain executed as one
  :class:`~repro_torch.exec.plan.AnalogPlan` (the ECG net).
- ``"tree"``: the analog layers live inside a larger host program
  (attention, norms, the residual stream stay digital).  The spec lists
  them by dotted path into the params tree; :func:`repro_torch.api.compile`
  bakes a plan beside each layer's parameters and the host program
  (``apply_fn``) replays them.

- ``"block"``: one attention+MLP transformer block whose four analog
  dispatches (fused QKV, o, fused up|gate, down) AND digital glue
  (RMSNorms, RoPE + attention, residuals, SwiGLU) run as ONE kernel
  launch (:func:`repro_torch.exec.lower.lower_block`).  ``block_geom``
  carries the geometry the in-kernel glue needs (head counts, head_dim,
  the baked prefill ``seq``, rope_theta, the RMSNorm eps).

Fusion groups (tree specs): a :class:`GroupSpec` names the layers that
replay as ONE analog dispatch.  Three kinds, as in the reference:
``"column_concat"`` (same input, concatenated output columns - the
attention QKV), ``"batch_concat"`` (same weight geometry, DIFFERENT
inputs - the RWKV r/k/v/g projections, one member axis with each
member's own tables and input scale) and ``"expert_stack"`` (one stacked
``[E, K, N]`` MoE expert weight, lowered once into a per-expert plan,
every expert in one dispatch).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

from repro_torch.exec.plan import (GROUP_BATCH_CONCAT, GROUP_COLUMN_CONCAT,
                                   GROUP_EXPERT_STACK, GROUP_KINDS)

STACK = "stack"
TREE = "tree"
BLOCK = "block"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One analog layer, declared once.

    name:         layer name ("fc1") or dotted path into the params tree
                  ("layers.l0.attn.wq").
    in_dim/out_dim: logical matmul dims (pre chunk padding).
    signed_input: per-layer override of ``cfg.signed_input`` or None.
    epilogue:     ADC hand-off to the NEXT stacked layer ("none" float
                  glue | "relu_shift" code-domain chain).
    flatten_out:  flatten trailing output dims before the next layer.
    sharding:     logical axis names of the (in, out) weight dims.
    group:        name of the :class:`GroupSpec` this layer dispatches
                  with, or None; a tag without a declared GroupSpec implies
                  a ``column_concat`` group of the layers sharing it.
    stacked:      leading scan-stack size (0 = plain 2-D layer).
    """

    name: str
    in_dim: int
    out_dim: int
    signed_input: Optional[str] = None
    epilogue: str = "none"
    flatten_out: bool = False
    sharding: Tuple[Optional[str], Optional[str]] = (None, None)
    group: Optional[str] = None
    stacked: int = 0


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """One fusion group: the members that replay as ONE analog dispatch.

    name:    group name; its dotted prefix locates the group
             ("layers.l0.attn.qkv"), the last segment is its local name at
             the parent params node.
    kind:    "column_concat" | "batch_concat" | "expert_stack".
    members: ordered member layer names (declared layers, all siblings;
             an expert_stack group has one, a stacked expert weight).
    """

    name: str
    kind: str
    members: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "members", tuple(self.members))

    @property
    def local_name(self) -> str:
        """The group's key inside its parent node's ``"_groups"`` dict."""
        return self.name.rsplit(".", 1)[-1]


def _parent_of(path: str) -> str:
    return path.rsplit(".", 1)[0] if "." in path else ""


def _local_of(path: str) -> str:
    return path.rsplit(".", 1)[-1]


def group_parent(g: GroupSpec) -> Tuple[str, Tuple[str, ...]]:
    """(parent dotted path, local member names) of a validated group."""
    return _parent_of(g.members[0]), tuple(_local_of(m) for m in g.members)


def _validate_group(g: GroupSpec, by_name: dict, spec_name: str) -> None:
    where = f"spec {spec_name!r} group {g.name!r}"
    if g.kind not in GROUP_KINDS:
        raise ValueError(
            f"{where}: unknown kind {g.kind!r}; kinds: "
            f"{', '.join(GROUP_KINDS)}"
        )
    if not g.members:
        raise ValueError(f"{where}: a group needs at least one member")
    missing = [m for m in g.members if m not in by_name]
    if missing:
        raise ValueError(
            f"{where}: members {missing} are not declared layers; "
            f"declared: {', '.join(by_name) or '(none)'}"
        )
    if len(set(g.members)) != len(g.members):
        raise ValueError(f"{where}: duplicate members {g.members}")
    parents = {_parent_of(m) for m in g.members}
    if len(parents) != 1:
        raise ValueError(
            f"{where}: members must be siblings (direct children of one "
            f"params node); got parents {sorted(parents)}"
        )
    ls = [by_name[m] for m in g.members]
    if {l.epilogue for l in ls} != {"none"}:
        raise ValueError(
            f"{where}: fused members hand off dequantized floats and "
            "cannot carry a code-domain epilogue"
        )
    if g.kind == GROUP_EXPERT_STACK:
        if len(g.members) != 1:
            raise ValueError(
                f"{where}: declare one expert_stack group per stacked "
                f"weight array; got members {g.members}"
            )
        if ls[0].stacked <= 0:
            raise ValueError(
                f"{where}: expert_stack member {ls[0].name!r} must be a "
                f"stacked [E, K, N] weight (LayerSpec.stacked > 0)"
            )
        return
    if g.kind == GROUP_BATCH_CONCAT:
        for attr in ("signed_input", "stacked"):
            if len({getattr(l, attr) for l in ls}) != 1:
                raise ValueError(
                    f"{where}: {GROUP_BATCH_CONCAT} members must agree on "
                    f"{attr}; got {[(l.name, getattr(l, attr)) for l in ls]}"
                )
        if len({(l.in_dim, l.out_dim) for l in ls}) != 1:
            raise ValueError(
                f"{where}: {GROUP_BATCH_CONCAT} members must share the "
                "weight geometry (in_dim, out_dim); got "
                f"{[(l.name, l.in_dim, l.out_dim) for l in ls]}"
            )
        return
    for attr in ("signed_input", "stacked", "in_dim"):
        if len({getattr(l, attr) for l in ls}) != 1:
            raise ValueError(
                f"{where}: {GROUP_COLUMN_CONCAT} members share one input "
                f"and must agree on {attr}; got "
                f"{[(l.name, getattr(l, attr)) for l in ls]}"
            )


@dataclasses.dataclass(frozen=True)
class ModuleSpec:
    """A model's analog declaration: what to compile, not how to run it.

    ``apply_fn(model, *args, **kw)`` is the host program executed by
    ``CompiledModel.apply`` (stacks default to running their plan).
    ``input_domain`` (stack kind) declares what the compiled program's
    INITIAL input is: "codes" (unsigned 5-bit event codes, quantization
    skipped) or "float" (quantized on entry); None infers it from the
    first layer's epilogue.  ``param_axes`` (tree kind) is the
    logical-axis spec tree of the raw params
    (:mod:`repro_torch.distributed.sharding`; the ``sharding-specs``
    verifier rule extends it over the baked plans).  ``groups`` declares the fusion groups (tree
    kind); a ``LayerSpec.group`` tag must name one of them.
    ``block_geom`` (block kind only, required there) is the geometry dict
    :func:`repro_torch.exec.lower.lower_block` takes: ``n_heads``,
    ``n_kv_heads``, ``head_dim``, ``seq``, ``rope_theta``, ``eps``.
    """

    name: str
    layers: Tuple[LayerSpec, ...] = ()
    kind: str = STACK
    apply_fn: Optional[Callable] = None
    param_axes: Any = None
    input_domain: Optional[str] = None
    groups: Tuple[GroupSpec, ...] = ()
    block_geom: Optional[dict] = None

    def __post_init__(self):
        if self.kind not in (STACK, TREE, BLOCK):
            raise NotImplementedError(
                f"spec {self.name!r}: kind {self.kind!r} is not ported yet; "
                f"ported kinds: {STACK!r}, {TREE!r}, {BLOCK!r}"
            )
        if self.kind == BLOCK and self.block_geom is None:
            raise ValueError(
                f"spec {self.name!r}: block specs need block_geom "
                "(n_heads/n_kv_heads/head_dim/seq/rope_theta/eps); use "
                "api.block_spec() to build one"
            )
        object.__setattr__(self, "layers", tuple(self.layers))
        by_name = {l.name: l for l in self.layers}
        if len(by_name) != len(self.layers):
            raise ValueError(
                f"spec {self.name!r}: duplicate layer names in "
                f"{[l.name for l in self.layers]}"
            )
        object.__setattr__(self, "groups", tuple(self.groups))
        declared = {g.name for g in self.groups}
        if len(declared) != len(self.groups):
            raise ValueError(
                f"spec {self.name!r}: duplicate group names in "
                f"{[g.name for g in self.groups]}"
            )
        untied = [l.name for l in self.layers
                  if l.group is not None and l.group not in declared]
        if untied:
            raise ValueError(
                f"spec {self.name!r}: layers {untied} name an undeclared "
                "fusion group"
            )
        if self.groups and self.kind != TREE:
            raise ValueError(
                f"spec {self.name!r}: fusion groups are a tree-spec feature"
            )
        seen: dict = {}
        for g in self.groups:
            _validate_group(g, by_name, self.name)
            key = (_parent_of(g.members[0]), g.local_name)
            if key in seen:
                raise ValueError(
                    f"spec {self.name!r}: groups {seen[key]!r} and "
                    f"{g.name!r} collide on local name {g.local_name!r}"
                )
            seen[key] = g.name

    def layer(self, name: str) -> LayerSpec:
        for layer in self.layers:
            if layer.name == name:
                return layer
        raise KeyError(
            f"no layer {name!r} in spec {self.name!r}; declared layers: "
            f"{', '.join(self.layer_names()) or '(none)'}"
        )

    def layer_names(self) -> Tuple[str, ...]:
        """Every declared analog layer name, in order - the key space of
        a :class:`repro_torch.calib.snapshot.CalibrationSnapshot` for
        this model (stack: layer names; tree: dotted params paths)."""
        return tuple(layer.name for layer in self.layers)

    def group(self, name: str) -> GroupSpec:
        for g in self.groups:
            if g.name == name:
                return g
        raise KeyError(
            f"no fusion group {name!r} in spec {self.name!r}; declared "
            f"groups: {', '.join(g.name for g in self.groups) or '(none)'}"
        )

    def group_members(self) -> dict:
        """{group name -> member name tuple} for every fusion group.
        Group members share one analog dispatch; calibration fits their
        activation scales together
        (:func:`repro_torch.calib.routines.share_group_input_scale`)."""
        return {g.name: tuple(g.members) for g in self.groups}


def linear_spec(in_dim: int, out_dim: int, *, name: str = "layer",
                signed_input: Optional[str] = None,
                sharding: Tuple[Optional[str], Optional[str]] = (None, None),
                ) -> ModuleSpec:
    """Spec for a single analog linear layer (params = {name: layer_params}
    or the layer params dict itself)."""
    return ModuleSpec(
        name=f"linear_{in_dim}x{out_dim}",
        layers=(LayerSpec(name, in_dim, out_dim, signed_input=signed_input,
                          sharding=sharding),),
        kind=STACK,
    )
