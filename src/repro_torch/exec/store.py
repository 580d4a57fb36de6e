"""Plan store: save/load lowered artifacts as versioned ``.npz`` files
(port of ``repro.exec.store``, format ``repro-plan-v1``).

A lowered plan is what the chip stores - int8 weight codes plus small
gain/offset tables - so a plan is worth persisting: a cold start loads
the packed artifact and skips lowering, and the bytes on disk scale with
the 6-bit codes, not the fp32 effective weights.

Format: one ``np.savez`` archive holding

- ``__version__``: the format tag (any other version is refused with a
  re-save hint),
- ``__tree__``: a JSON descriptor - nested nodes tagging each
  plan/layer/store/group/glue/dict/list/tuple/py/arr/none and referencing
  arrays by index,
- ``a0, a1, ...``: the array leaves, dtypes kept (int8 codes stay int8).

The descriptor and the leaves are the reference's, so a plan saved by
either package loads into the other.  Two translations keep it so:

- the port keeps a scan-stacked layer, fusion group or block plan as a
  :class:`~repro_torch.exec.plan.PlanStack` of per-slice plans where the
  reference keeps one plan whose leaves carry a leading stack axis; a
  stack is written as that stacked node (each leaf stacked along axis 0),
  and a stacked node is read back as a stack;
- the plan's ``cfg`` names the reference's ``use_pallas`` where the port
  says ``use_kernels`` (both: route the hot loop to the kernels); a plan
  loaded onto a CUDA device always routes to the kernels.

A megakernel packing is recorded as a flag and re-packed at load time
from the loaded stores - repackaging, no lowering, so
:func:`~repro_torch.exec.lower.lowering_count` does not move.
``batch_concat`` and ``expert_stack`` groups (a leading member or
expert axis on every leaf; a scan-stacked one as the reference's
``[S, G, ...]`` leaves) load as live groups that
:func:`~repro_torch.exec.run.run_batch_concat` and
:func:`~repro_torch.exec.run.run_expert_stack` replay.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.core.analog import AnalogConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.noise import NoiseConfig
from repro_torch.exec.plan import (
    GROUP_COLUMN_CONCAT,
    AnalogPlan,
    BlockGlue,
    GroupPlan,
    LayerPlan,
    PYTREE_FIELDS,
    MegakernelPack,
    PlanStack,
    WeightStore,
)

FORMAT_VERSION = "repro-plan-v1"

_LAYER_DATA, _LAYER_META = PYTREE_FIELDS[LayerPlan]
_STORE_DATA = PYTREE_FIELDS[WeightStore][0]
_GLUE_META = PYTREE_FIELDS[BlockGlue][1]


def _shift_arrays(node, base: int):
    """The descriptor ``node`` with every array index moved by ``base``."""
    if isinstance(node, dict):
        if node.get("t") == "arr":
            return {"t": "arr", "i": node["i"] + base}
        return {k: _shift_arrays(v, base) for k, v in node.items()}
    if isinstance(node, list):
        return [_shift_arrays(v, base) for v in node]
    return node


def _encode_stack(members, arrays: list):
    """A :class:`PlanStack` as the reference's stacked node: the members'
    descriptors must agree, and each of their leaves stacks along a new
    leading axis."""
    descs, leaves = [], []
    for m in members:
        own: list = []
        descs.append(_encode(m, own))
        leaves.append(own)
    if any(d != descs[0] for d in descs[1:]):
        raise ValueError("the members of a PlanStack differ in structure; "
                         "only a homogeneous stack is storable")
    base = len(arrays)
    for j in range(len(leaves[0])):
        arrays.append(np.stack([own[j] for own in leaves]))
    return _shift_arrays(descs[0], base)


def _encode(obj, arrays: list):
    """Recursively render a lowered artifact as a JSON-able descriptor,
    appending array leaves (dtype-preserved) to ``arrays``."""
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, PlanStack):
        return _encode_stack(obj, arrays)
    if isinstance(obj, AnalogPlan):
        return {
            "t": "plan",
            "layers": [_encode(lp, arrays) for lp in obj.layers],
            "cfg": _encode_cfg(obj.cfg),
            "input_domain": obj.input_domain,
            "block": _encode(obj.block, arrays),
            "mega": obj.mega is not None,
        }
    if isinstance(obj, LayerPlan):
        node = {"t": "layer",
                "meta": {f: getattr(obj, f) for f in _LAYER_META}}
        for f in _LAYER_DATA:
            node[f] = _encode(getattr(obj, f), arrays)
        return node
    if isinstance(obj, WeightStore):
        node = {"t": "store", "chunk_rows": obj.chunk_rows,
                "col_blocks": (None if obj.col_blocks is None
                               else list(obj.col_blocks))}
        for f in _STORE_DATA:
            node[f] = _encode(getattr(obj, f), arrays)
        return node
    if isinstance(obj, GroupPlan):
        return {
            "t": "group", "kind": obj.kind,
            "member_names": list(obj.member_names),
            "member_ns": list(obj.member_ns),
            "fused": _encode(obj.fused, arrays),
        }
    if isinstance(obj, BlockGlue):
        node = {"t": "glue",
                "meta": {f: getattr(obj, f) for f in _GLUE_META}}
        node["ln1"] = _encode(obj.ln1, arrays)
        node["ln2"] = _encode(obj.ln2, arrays)
        return node
    if isinstance(obj, MegakernelPack):
        raise TypeError(
            "save a MegakernelPack via its owning AnalogPlan (the pack is "
            "re-built from the layers' stores at load time)"
        )
    if isinstance(obj, dict):
        keys = list(obj.keys())
        if not all(isinstance(k, str) for k in keys):
            raise TypeError(f"non-string dict keys are not storable: {keys}")
        return {"t": "dict", "k": keys,
                "v": [_encode(obj[k], arrays) for k in keys]}
    if isinstance(obj, (list, tuple)):
        return {"t": "list" if isinstance(obj, list) else "tuple",
                "v": [_encode(v, arrays) for v in obj]}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "py", "v": obj}
    if isinstance(obj, torch.Tensor):
        arrays.append(obj.detach().cpu().numpy())
        return {"t": "arr", "i": len(arrays) - 1}
    arr = np.asarray(obj)
    if arr.dtype == object:
        raise TypeError(f"cannot store leaf of type {type(obj).__name__}")
    arrays.append(arr)
    return {"t": "arr", "i": len(arrays) - 1}


def _encode_cfg(cfg: AnalogConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["use_pallas"] = d.pop("use_kernels")
    return d


def _decode_cfg(d: dict, dev: torch.device) -> AnalogConfig:
    d = dict(d)
    d["noise"] = NoiseConfig(**d["noise"])
    # use_kernels=False is the CPU-only plain route: on the card the
    # layers always run through the kernels
    d["use_kernels"] = bool(d.pop("use_pallas")) or dev.type == "cuda"
    return AnalogConfig(**d)


def _codes_rank(node, arrays) -> int:
    """The rank of a layer node's weight codes."""
    return arrays[node["store"]["codes"]["i"]].ndim


def _stack_len(node, arrays, base: int):
    """The leading stack length of a layer node whose codes carry more
    than ``base`` axes, else None."""
    codes = arrays[node["store"]["codes"]["i"]]
    extra = codes.ndim - base
    if extra == 0:
        return None
    if extra != 1:
        raise ValueError(f"weight codes of rank {codes.ndim}: nested "
                         "stacks are not supported")
    return codes.shape[0]


def _member_rank(kind: str) -> int:
    # batch_concat / expert_stack fused plans carry a member (expert) axis
    return 2 if kind == GROUP_COLUMN_CONCAT else 3


def _decode(node, arrays, dev, idx=None):
    """Rebuild a node on ``dev``; ``idx`` selects member ``idx`` of every
    leaf of a stacked node."""
    t = node["t"]
    if t == "none":
        return None
    if t == "arr":
        a = arrays[node["i"]]
        if idx is not None:
            a = np.asarray(a[idx])
        return torch.as_tensor(a).to(dev)
    if t == "py":
        return node["v"]
    if t == "dict":
        return {k: _decode(v, arrays, dev, idx)
                for k, v in zip(node["k"], node["v"])}
    if t == "list":
        return [_decode(v, arrays, dev, idx) for v in node["v"]]
    if t == "tuple":
        return tuple(_decode(v, arrays, dev, idx) for v in node["v"])
    if t == "store":
        kw = {f: _decode(node[f], arrays, dev, idx) for f in _STORE_DATA}
        cb = node["col_blocks"]
        return WeightStore(  # verify: allow-packed-weights
            chunk_rows=int(node["chunk_rows"]),
            col_blocks=None if cb is None else tuple(int(x) for x in cb),
            **kw,
        )
    if t == "layer":
        if idx is None:
            s = _stack_len(node, arrays, 2)
            if s is not None:
                return PlanStack(_decode(node, arrays, dev, i)
                                 for i in range(s))
        return _decode_layer(node, arrays, dev, idx)
    if t == "group":
        if idx is None:
            s = _stack_len(node["fused"], arrays, _member_rank(node["kind"]))
            if s is not None:
                return PlanStack(_decode(node, arrays, dev, i)
                                 for i in range(s))
        return GroupPlan(
            kind=node["kind"],
            fused=_decode_layer(node["fused"], arrays, dev, idx),
            member_names=tuple(node["member_names"]),
            member_ns=tuple(int(x) for x in node["member_ns"]),
        )
    if t == "glue":
        return BlockGlue(
            ln1=_decode(node["ln1"], arrays, dev, idx),
            ln2=_decode(node["ln2"], arrays, dev, idx),
            **node["meta"],
        )
    if t == "plan":
        if idx is None and node["layers"]:
            s = _stack_len(node["layers"][0], arrays, 2)
            if s is not None:
                return PlanStack(_decode(node, arrays, dev, i)
                                 for i in range(s))
        from repro_torch.exec.lower import pack_megakernel

        plan = AnalogPlan(
            layers=tuple(_decode_layer(lp, arrays, dev, idx)
                         for lp in node["layers"]),
            cfg=_decode_cfg(node["cfg"], dev),
            input_domain=node["input_domain"],
            block=_decode(node["block"], arrays, dev, idx),
        )
        if node["mega"]:
            # re-pack from the loaded stores: pure repackaging, no
            # quantization - lowering_count() stays where it was
            plan = dataclasses.replace(plan, mega=pack_megakernel(plan))
        return plan
    raise ValueError(f"unknown plan-store node tag {t!r}")


def _decode_layer(node, arrays, dev, idx):
    kw = {f: _decode(node[f], arrays, dev, idx) for f in _LAYER_DATA}
    return LayerPlan(**kw, **node["meta"])


def save_plan(path: str, lowered) -> None:
    """Persist a lowered artifact (plan / group / layer / pre-lowered
    params tree) to a versioned ``.npz`` archive at ``path``."""
    arrays: list = []
    tree = _encode(lowered, arrays)
    np.savez(
        path,
        __version__=np.asarray(FORMAT_VERSION),
        __tree__=np.asarray(json.dumps(tree)),
        **{f"a{i}": a for i, a in enumerate(arrays)},
    )


def load_plan(path: str, device: DeviceLike = None):
    """Load a lowered artifact saved by either package's ``save_plan``
    onto ``device`` (``None`` = the CUDA device), bit-exact, dtypes kept;
    megakernel packings are re-packed from the loaded stores."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        version = str(z["__version__"])
        if version != FORMAT_VERSION:
            raise ValueError(
                f"plan store {path!r} has format {version!r}, this build "
                f"reads {FORMAT_VERSION!r}; re-lower and re-save the plan"
            )
        tree = json.loads(str(z["__tree__"]))
        arrays = {}
        for k in z.files:
            if k.startswith("a"):
                arrays[int(k[1:])] = z[k]
    return _decode(tree, arrays, dev)
