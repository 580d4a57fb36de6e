"""The activation domain-transition table (port of
``repro.verify.domains``): which domain ("codes" | "float") each layer of
a lowered chain consumes, how an epilogue transforms it, and what that
implies for megakernel packing.  :func:`repro_torch.exec.lower.pack_megakernel`
and :func:`repro_torch.exec.lower.megakernel_ineligible_reason` consume
it; the messages are the reference's, word for word.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.exec.plan import (
    EPILOGUE_NONE,
    EPILOGUE_RELU_SHIFT,
    INPUT_CODES,
    AnalogPlan,
)

DOMAIN_CODES = "codes"     # unsigned 5-bit event codes
DOMAIN_FLOAT = "float"     # dequantized float features

# (domain a layer consumes, its epilogue) -> domain the NEXT layer
# consumes.  relu_shift requantizes to 5-bit codes at the readout; "none"
# dequantizes to float.
DOMAIN_AFTER = {
    (DOMAIN_CODES, EPILOGUE_RELU_SHIFT): DOMAIN_CODES,
    (DOMAIN_CODES, EPILOGUE_NONE): DOMAIN_FLOAT,
    (DOMAIN_FLOAT, EPILOGUE_RELU_SHIFT): DOMAIN_CODES,
    (DOMAIN_FLOAT, EPILOGUE_NONE): DOMAIN_FLOAT,
}

# signed encodings a megakernel can emit in-kernel for float-consuming
# layers ("offset" keeps its column-sum correction per-layer)
PACKABLE_SIGNED = ("none", "split")


def next_domain(domain: str, epilogue: str) -> str:
    """One transition of the table (KeyError on unknown tags)."""
    return DOMAIN_AFTER[(domain, epilogue)]


def plan_input_domain(plan: AnalogPlan) -> str:
    """The domain the plan's FIRST layer consumes (float unless baked
    as codes)."""
    return DOMAIN_CODES if plan.input_domain == INPUT_CODES else DOMAIN_FLOAT


def consumed_domains(plan: AnalogPlan) -> List[str]:
    """``domains[i]`` is the domain layer i CONSUMES, walked from the
    plan's input domain through :data:`DOMAIN_AFTER`."""
    domains = []
    d = plan_input_domain(plan)
    for lp in plan.layers:
        domains.append(d)
        d = DOMAIN_AFTER.get((d, lp.epilogue), DOMAIN_FLOAT)
    return domains


def encode_tag(domain: str, signed_input: str) -> str:
    """The megakernel input-encoding tag of a layer consuming ``domain``:
    codes arrive as-is; float features are quantized in-kernel at the
    baked LSB, either unsigned or as signed-split pos/neg passes."""
    if domain == DOMAIN_CODES:
        return "codes"
    return "split" if signed_input == "split" else "unsigned"


def handoff_tag(epilogue: str, is_last: bool) -> str:
    """The megakernel hand-off tag a layer emits: inter-layer relu_shift
    hands 5-bit codes, "none" dequantizes + ReLUs in-kernel; the final
    layer hands raw accumulated ADC codes out."""
    if is_last:
        return "raw"
    return "codes" if epilogue == EPILOGUE_RELU_SHIFT else "relu"


def expected_dispatches(
    input_domain: str,
    epilogues: Sequence[str],
    signed_inputs: Sequence[str],
    *,
    fused_split: bool,
) -> int:
    """Analog dispatches one layer-by-layer deterministic replay issues,
    derived from the transition table alone: one per layer, plus a second
    pass for float-consuming signed-split layers without the fused-split
    kernel (codes-consuming layers are never re-encoded, so their signed
    mode is moot)."""
    n = 0
    d = input_domain
    last = len(epilogues) - 1
    for i, (epi, signed) in enumerate(zip(epilogues, signed_inputs)):
        eff = "none" if d == DOMAIN_CODES else signed
        n += 2 if (eff == "split" and not fused_split) else 1
        if i < last:
            d = DOMAIN_AFTER.get((d, epi), DOMAIN_FLOAT)
    return n


def chain_ineligible_reason(plan: AnalogPlan) -> Optional[str]:
    """Structural megakernel eligibility of a lowered plan; None when
    eligible, else a reason naming the first offending layer.  Block
    plans are validated at lower time and always eligible."""
    if plan.block is not None:
        return None
    layers = plan.layers
    if len(layers) < 2:
        return "megakernel needs a stack of >= 2 layers"
    domains = consumed_domains(plan)
    last = len(layers) - 1
    for i, lp in enumerate(layers):
        where = (
            f"layer {i} (consumes {domains[i]!r}, epilogue {lp.epilogue!r})"
        )
        if getattr(lp.store.codes, "ndim", 2) != 2:
            return f"{where}: scan-stacked (vmapped) plans are not packable"
        if lp.chunk_rows != layers[0].chunk_rows:
            return (
                f"{where}: chunk geometry {lp.chunk_rows} disagrees with "
                f"layer 0 ({layers[0].chunk_rows})"
            )
        if domains[i] == DOMAIN_FLOAT:
            # in-kernel re-encoding needs a compile-time activation LSB:
            # dynamic calibration derives the scale from the live
            # activations, which do not exist at pack time
            if plan.cfg.act_calib != "static":
                return (
                    f"{where}: float activations under act_calib="
                    f"{plan.cfg.act_calib!r} cannot be encoded in-kernel; "
                    "the baked static LSB needs act_calib='static'"
                )
            if lp.signed_input not in PACKABLE_SIGNED:
                return (
                    f"{where}: signed_input {lp.signed_input!r} is not "
                    "packable (the offset encoding's column-sum "
                    "correction stays per-layer); use 'none' or 'split'"
                )
        if i < last:
            nxt = layers[i + 1]
            if lp.flatten_out:
                if nxt.k % lp.n:
                    return (
                        f"{where}: flatten hand-off width n={lp.n} does "
                        f"not divide layer {i + 1} width k={nxt.k}"
                    )
            elif nxt.k != lp.n:
                return (
                    f"{where}: hand-off width n={lp.n} does not feed "
                    f"layer {i + 1} width k={nxt.k}"
                )
        elif lp.epilogue != EPILOGUE_NONE:
            return (
                f"{where}: the last layer must dequantize "
                "(epilogue 'none')"
            )
    return None
