"""Repo-wide invariant sweep (port of ``repro.verify.sweep``): verify
every registered config's SMOKE spec, both ECG epilogues' specs, the
representative compiled plans (the ECG code-domain chain with both
epilogues, an RWKV ``batch_concat`` group plain and scan-stacked, an MoE
``expert_stack`` group, a fused attention+MLP block) and a placed,
fleet-calibrated ECG plan.

This is what ``python -m repro_torch.verify`` runs: a structural
regression anywhere in the lower/pack/spec pipeline surfaces here as a
named rule + path.  The plans are compiled on ``device`` (``None`` = the
CUDA device); the specs need shapes only and are built on the CPU.

Heavier than the other verify modules (imports models and compiles
plans), so it is NOT imported by ``repro_torch.verify.__init__``.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.verify.invariants import (Diagnostic, verify_model,
                                           verify_plan, verify_spec)


def _silent(msg: str) -> None:
    pass


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def sweep_specs(log: Callable[[str], None] = _silent
                ) -> Tuple[Diagnostic, ...]:
    """Spec-level rules over all registered arch configs (their SMOKE
    sizes, through ``lm_module_spec``) plus the ECG module specs."""
    from repro_torch import configs
    from repro_torch.models import ecg as ECG
    from repro_torch.models import transformer as T

    out: List[Diagnostic] = []
    for name in configs.ARCH_NAMES:
        cfg = configs.get_smoke(name)
        params = T.lm_init(_gen(0), cfg, device="cpu")
        diags = verify_spec(T.lm_module_spec(cfg, params))
        log(f"spec {name}: {len(diags)} diagnostic(s)")
        out.extend(diags)
    for epi in ("none", "relu_shift"):
        diags = verify_spec(
            ECG.ecg_module_spec(ECG.ECGConfig(), epilogue=epi))
        log(f"spec ecg/{epi}: {len(diags)} diagnostic(s)")
        out.extend(diags)
    return tuple(out)


def sweep_plans(log: Callable[[str], None] = _silent,
                device: DeviceLike = None) -> Tuple[Diagnostic, ...]:
    """Full-tier plan rules over compiled models covering every plan
    shape the executor produces: the ECG code-domain chain (both
    epilogues), an RWKV batch_concat group, the same group scan-stacked
    (a PlanStack), an MoE expert_stack group, and the fused
    attention+MLP block - compiled on ``device``."""
    from repro_torch import api
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.noise import NOISELESS
    from repro_torch.models import ecg as ECG
    from repro_torch.models import moe as M
    from repro_torch.models import rwkv as R
    from repro_torch.models import transformer as T

    dev = resolve_device(device)
    acfg = AnalogConfig(noise=NOISELESS)
    out: List[Diagnostic] = []

    def run(label, model):
        diags = verify_model(model)
        log(f"plan {label}: {len(diags)} diagnostic(s)")
        out.extend(diags)

    ecg_cfg = ECG.ECGConfig()
    ecg_params = ECG.ecg_init(_gen(0), ecg_cfg, device=dev)
    for epi in ("none", "relu_shift"):
        run(f"ecg/{epi}", api.compile(
            ECG.ecg_module_spec(ecg_cfg, epilogue=epi), ecg_params, acfg,
            device=dev))

    d, heads = 64, 4
    run("rwkv/batch_concat", api.compile(
        R.rwkv_module_spec(d, heads), R.rwkv_init(_gen(0), d, heads,
                                                  device=dev),
        acfg, device=dev))

    # scan-stacked groups: the LM rwkv arch lowers its batch_concat group
    # per stack member (a PlanStack)
    rw_cfg = ArchConfig("t-rwkv", "ssm", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=4, d_ff=128,
                        vocab_size=256, block="rwkv", remat=False)
    rw_params = T.lm_init(_gen(0), rw_cfg, device=dev)
    run("rwkv/scan_stacked", api.compile(
        T.lm_module_spec(rw_cfg, rw_params), rw_params, acfg, device=dev))

    run("moe/expert_stack", api.compile(
        M.moe_module_spec(64, 32, 4, top_k=2),
        M.moe_init(_gen(0), 64, 32, 4, device=dev), acfg, device=dev))

    arch = ArchConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=2, n_kv_heads=2, d_ff=96, vocab_size=64,
                      remat=False)
    run("block/attn_mlp", api.compile_block(
        T._layer_init(_gen(0), "attn_mlp", arch, dev),
        AnalogConfig(act_calib="static", noise=NOISELESS),
        n_heads=arch.n_heads, n_kv_heads=arch.n_kv_heads,
        head_dim=arch.hd, seq=8, rope_theta=arch.rope_theta, device=dev))
    return tuple(out)


def sweep_fleet(log: Callable[[str], None] = _silent,
                device: DeviceLike = None) -> Tuple[Diagnostic, ...]:
    """Fleet rules over a placed, fleet-calibrated compiled plan: the ECG
    stack placed across a 6-chip fleet (2 spares), calibrated fleet-wide
    and baked through ``api.compile(calibration=)`` on ``device`` - the
    entry that exercises ``placement-coverage`` and
    ``fleet-calibration-compat`` beside the plan rules."""
    from repro_torch import api
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.noise import NOISELESS
    from repro_torch.fleet import (ChipFleet, calibrate_fleet,
                                   model_layer_shapes, model_snapshot,
                                   place_model)
    from repro_torch.models import ecg as ECG

    dev = resolve_device(device)
    cfg = ECG.ECGConfig()
    params = ECG.ecg_init(_gen(0), cfg, device=dev)
    spec = ECG.ecg_module_spec(cfg)
    pl = place_model(model_layer_shapes(spec, params), n_chips=6, spares=2)
    fleet = ChipFleet.for_placement(torch.Generator(device=dev)
                                    .manual_seed(1), pl, noise=NOISELESS)
    fsnap = calibrate_fleet(fleet, offset_repeats=4, gain_repeats=1,
                            source="verify-sweep")
    model = api.compile(
        spec, params,
        AnalogConfig(act_calib="static", signed_input="none",
                     noise=NOISELESS),
        calibration=model_snapshot(pl, fsnap, source="verify-sweep"),
        device=dev)
    diags = verify_plan(
        model.lowered, spec=model.spec, calibration=model.calibration,
        placement=pl, fleet=fsnap, path="fleet-plan",
    )
    log(f"fleet ecg/placed: {len(diags)} diagnostic(s)")
    return tuple(diags)


def sweep(log: Callable[[str], None] = _silent,
          device: DeviceLike = None) -> Tuple[Diagnostic, ...]:
    """The full invariant sweep (specs + compiled plans + placed fleet),
    the plans on ``device``."""
    return (sweep_specs(log) + sweep_plans(log, device)
            + sweep_fleet(log, device))
