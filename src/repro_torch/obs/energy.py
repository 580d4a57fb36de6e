"""Per-inference energy/latency accounting for compiled plans (port of
``repro.obs.energy``).

Walks a lowered artifact (an ``AnalogPlan`` stack, a lowered params tree
with ``"_plan"``/``"_groups"`` entries, or a ``CompiledModel``) into
``core.energy.LayerWork`` items and runs them through the existing
``SystemModel``, reporting µs/sample and µJ/sample next to the paper's
measured ECG numbers (276 µs per inference, 192 µJ ASIC energy).

Energy counts *physical* analog passes: megakernel fusion is a host-code
optimization, so a fused block still pays each member VMM; expert-stack
groups count every expert (a static upper bound - routing picks fewer at
run time).

The port keeps a scan-stacked layer as a :class:`PlanStack` of per-slice
plans where the reference keeps one plan with a leading stack axis; the
walk reads a stack as that stacked plan (its codes shape gains the stack
axis), so the counts, and the report, equal the reference's for the same
plan structure.
"""

from __future__ import annotations

from typing import Any, Optional

from repro_torch.core.energy import LayerWork, SystemModel
from repro_torch.exec.plan import AnalogPlan, GroupPlan, LayerPlan, PlanStack

from . import metrics, trace

__all__ = [
    "PAPER_US_PER_INFERENCE",
    "PAPER_UJ_PER_INFERENCE",
    "layer_works",
    "plan_layer_works",
    "tree_layer_works",
    "energy_report",
    "record",
    "format_report",
]

# Measured on the BrainScaleS-2 mobile system (PAPER.md): one ECG trace
# classification takes 276 us and 192 uJ on the ASIC (1.56 mJ system-wide).
PAPER_US_PER_INFERENCE = 276.0
PAPER_UJ_PER_INFERENCE = 192.0


def _work(lp: LayerPlan, split: bool) -> LayerWork:
    return LayerWork(k=lp.k, n=lp.n, vectors=1,
                     passes_per_vector=2 if split else 1)


def plan_layer_works(plan: AnalogPlan) -> list[LayerWork]:
    """LayerWorks of one stack replay, mirroring the signed-input chain of
    :meth:`AnalogPlan.expected_dispatches` — except that a split pair is
    ALWAYS two physical passes: ``cfg.fused_split`` folds the pair into
    one *dispatch*, but the hardware still drives both vectors.
    Code-domain inputs (unsigned event codes) need no split pair."""
    from repro_torch.exec.plan import EPILOGUE_NONE, EPILOGUE_RELU_SHIFT

    works: list[LayerWork] = []
    is_codes = False if plan.block is not None else plan.expects_codes
    last = len(plan.layers) - 1
    for i, lp in enumerate(plan.layers):
        signed = "none" if is_codes else lp.signed_input
        works.append(_work(lp, signed == "split"))
        if lp.epilogue == EPILOGUE_NONE and i < last:
            is_codes = False
        else:
            is_codes = lp.epilogue == EPILOGUE_RELU_SHIFT
    return works


def _codes_shape(obj) -> tuple:
    """The codes shape of a layer plan, as the reference's stacked plan
    would carry it: a :class:`PlanStack` prepends its stack axis."""
    if isinstance(obj, PlanStack):
        return (len(obj),) + _codes_shape(obj[0])
    return tuple(obj.store.codes.shape)


def _group_works(gp) -> list[LayerWork]:
    # a PlanStack of group plans reads as the reference's stacked group
    g0 = gp[0] if isinstance(gp, PlanStack) else gp
    fused = g0.fused
    split = fused.signed_input == "split"
    if g0.kind == "column_concat":
        return [_work(fused, split)]
    # batch_concat / expert_stack: every leaf carries a leading member
    # axis; count one physical VMM per member (expert_stack: upper bound).
    shape = _codes_shape(PlanStack(p.fused for p in gp)
                         if isinstance(gp, PlanStack) else fused)
    g = shape[0] if len(shape) == 3 else len(g0.member_names)
    if len(shape) == 4 and g0.kind == "expert_stack":
        g = shape[0] * shape[1]     # a scan stack of expert stacks
    return [_work(fused, split)] * g


def tree_layer_works(lowered: Any) -> list[LayerWork]:
    """LayerWorks of a lowered params tree: every ``"_plan"`` entry
    (scan-stacked plans, codes ndim 3, count once per stacked layer) and
    every ``"_groups"`` GroupPlan.  The legacy ``"_qkv_plan"`` alias is
    skipped — it points at a group already counted."""
    works: list[LayerWork] = []
    if not isinstance(lowered, dict):
        return works
    for key, val in lowered.items():
        if key == "_qkv_plan":
            continue
        if key == "_plan" and isinstance(val, (LayerPlan, PlanStack)):
            lp = val[0] if isinstance(val, PlanStack) else val
            split = lp.signed_input == "split"
            shape = _codes_shape(val)
            copies = shape[0] if len(shape) == 3 else 1
            works.extend([_work(lp, split)] * copies)
        elif key == "_groups" and isinstance(val, dict):
            for gp in val.values():
                if isinstance(gp, GroupPlan) or (
                        isinstance(gp, PlanStack)
                        and isinstance(gp[0], GroupPlan)):
                    works.extend(_group_works(gp))
        elif isinstance(val, dict):
            works.extend(tree_layer_works(val))
    return works


def layer_works(obj: Any) -> list[LayerWork]:
    """Dispatch on artifact type: AnalogPlan | lowered tree | CompiledModel
    (digital CompiledModels lower to None -> no analog work)."""
    if isinstance(obj, AnalogPlan):
        return plan_layer_works(obj)
    lowered = getattr(obj, "lowered", obj)
    if isinstance(lowered, AnalogPlan):
        return plan_layer_works(lowered)
    return tree_layer_works(lowered)


def energy_report(obj: Any, model: Optional[SystemModel] = None) -> dict:
    """Per-inference energy/latency estimate for a compiled artifact,
    with the paper's measured reference alongside."""
    model = model or SystemModel()
    works = layer_works(obj)
    if not works:
        return {"layers": 0, "us_per_sample": 0.0, "uj_per_sample": 0.0,
                "analog_passes": 0,
                "paper_us_per_sample": PAPER_US_PER_INFERENCE,
                "paper_uj_per_sample": PAPER_UJ_PER_INFERENCE}
    rep = model.report(works)
    us = rep["time_s"] * 1e6
    uj = rep["energy_asic_j"] * 1e6
    return {
        "layers": len(works),
        "analog_passes": rep["analog_passes"],
        "us_per_sample": us,
        "uj_per_sample": uj,
        "uj_total_per_sample": rep["energy_total_j"] * 1e6,
        "paper_us_per_sample": PAPER_US_PER_INFERENCE,
        "paper_uj_per_sample": PAPER_UJ_PER_INFERENCE,
        "us_vs_paper": us / PAPER_US_PER_INFERENCE,
        "uj_vs_paper": uj / PAPER_UJ_PER_INFERENCE,
    }


def record(obj: Any, prefix: str = "energy",
           model: Optional[SystemModel] = None) -> dict:
    """Compute an energy report and publish it: gauges
    ``<prefix>.us_per_sample`` / ``<prefix>.uj_per_sample`` plus a trace
    event named ``<prefix>`` carrying the full report."""
    rep = energy_report(obj, model=model)
    metrics.gauge(f"{prefix}.us_per_sample").set(rep["us_per_sample"])
    metrics.gauge(f"{prefix}.uj_per_sample").set(rep["uj_per_sample"])
    trace.event(prefix, **{k: (round(v, 3) if isinstance(v, float) else v)
                           for k, v in rep.items()})
    return rep


def format_report(rep: dict, title: str = "energy") -> str:
    """Human-readable two-line summary vs the paper reference."""
    return (
        f"[{title}] {rep['us_per_sample']:.1f} us/sample, "
        f"{rep['uj_per_sample']:.1f} uJ/sample (ASIC) over "
        f"{rep['layers']} layers / {rep['analog_passes']} analog passes\n"
        f"[{title}] paper reference: {rep['paper_us_per_sample']:.0f} us, "
        f"{rep['paper_uj_per_sample']:.0f} uJ  "
        f"(x{rep.get('us_vs_paper', 0.0):.2f} time, "
        f"x{rep.get('uj_vs_paper', 0.0):.2f} energy)"
    )
