"""Analytical energy / latency model of the BSS-2 mobile system (a copy
of ``repro.core.energy``: the port keeps its own so that it never
imports the JAX package).

Reproduces the paper's Table 1 and Eqs. (1)-(3) from first principles plus
two calibrated system constants, and generalizes to arbitrary analog-mapped
models (used to project the assigned LM architectures onto BSS-2 tiles, the
paper's §V scaling argument).

Model structure, per inference (batch size 1, paper §IV):

    t_inf = t_analog + t_io
    t_analog = passes * vmm_cycle            (5 us integrate+reset+ADC each)
    t_io     = events_in * event_period + t_ctrl

The paper measures t_inf = 276 us for the ECG network whose analog part is
3 VMM passes (conv pass, split-FC pass, classifier pass = 15 us) - i.e. the
system is I/O / control dominated, consistent with §V ("the speed of the
analog CDNN calculation has not yet been optimized").  ``t_ctrl`` is the one
calibrated timing constant; energies follow from the measured mean powers.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hw import BSS2, BSS2Spec
from repro_torch.core.partition import TileGrid, plan_tiles


@dataclasses.dataclass(frozen=True)
class LayerWork:
    """Analog workload of one layer for one inference."""

    k: int                   # logical signed input dim
    n: int                   # output dim
    vectors: int = 1         # how many input vectors stream through (e.g. conv
    #                          positions already unrolled onto columns -> 1)
    passes_per_vector: int = 1  # 2 for signed-input split encoding

    @property
    def macs(self) -> int:
        return self.k * self.n * self.vectors

    def grid(self, spec: BSS2Spec = BSS2) -> TileGrid:
        return plan_tiles(self.k, self.n, spec)


@dataclasses.dataclass(frozen=True)
class SystemModel:
    spec: BSS2Spec = BSS2
    chips: int = 1
    # calibrated: FPGA/DMA/control overhead per inference (s).  Fitted once so
    # the ECG showcase lands on the measured 276 us (see calibrate_t_ctrl).
    t_ctrl: float = 251.944e-6

    # ------------------------------------------------------------------ time
    def analog_passes(self, layers: list[LayerWork]) -> int:
        total = 0
        for layer in layers:
            grid = layer.grid(self.spec)
            total += (
                grid.passes_serial(self.chips)
                * layer.vectors
                * layer.passes_per_vector
            )
        return total

    def t_analog(self, layers: list[LayerWork]) -> float:
        return self.analog_passes(layers) * self.spec.vmm_cycle_s

    def t_events(self, layers: list[LayerWork]) -> float:
        """Input event streaming time (rows stream at 8 ns each, all columns
        of one pass in parallel; overlapped across column tiles)."""
        t = 0.0
        for layer in layers:
            grid = layer.grid(self.spec)
            rows = min(layer.k, self.spec.signed_rows) * grid.row_chunks
            t += (
                rows
                * self.spec.event_period_s
                * layer.vectors
                * layer.passes_per_vector
            )
        return t

    def time_per_inference(self, layers: list[LayerWork]) -> float:
        return self.t_analog(layers) + self.t_events(layers) + self.t_ctrl

    # ---------------------------------------------------------------- energy
    def energy(self, layers: list[LayerWork]) -> dict:
        t = self.time_per_inference(layers)
        s = self.spec
        # split the system power by the measured Table-1 component ratios
        total_j = s.system_power_w * t
        f = lambda part: total_j * (part / s.energy_total_j)
        return {
            "time_s": t,
            "energy_total_j": total_j,
            "energy_system_controller_j": f(s.energy_sysctrl_j),
            "energy_arm_j": f(s.energy_arm_j),
            "energy_fpga_j": f(s.energy_fpga_j),
            "energy_dram_j": f(s.energy_dram_j),
            "energy_asic_j": s.asic_power_w * t,
            "energy_asic_io_j": f(s.energy_asic_io_j),
            "energy_asic_analog_j": f(s.energy_asic_analog_j),
            "energy_asic_digital_j": f(s.energy_asic_digital_j),
        }

    # ------------------------------------------------------------- summaries
    def report(self, layers: list[LayerWork]) -> dict:
        t = self.time_per_inference(layers)
        macs = sum(l.macs for l in layers)
        ops = 2 * macs
        e = self.energy(layers)
        return {
            **e,
            "total_ops": ops,
            "ops_per_s": ops / t,
            "ops_per_j": ops / e["energy_asic_j"],
            "inferences_per_j": 1.0 / e["energy_asic_j"],
            "analog_passes": self.analog_passes(layers),
            "peak_ops": self.spec.peak_ops,
            "sustained_ops": self.spec.sustained_ops,
            "area_eff_top_s_mm2": self.spec.area_efficiency_top_s_mm2,
        }


def calibrate_t_ctrl(
    layers: list[LayerWork],
    measured_t_inf: float = BSS2.time_per_inference_s,
    spec: BSS2Spec = BSS2,
    chips: int = 1,
) -> float:
    """Solve the single free constant so the model reproduces the measured
    per-inference latency of the showcase network."""
    m = SystemModel(spec=spec, chips=chips, t_ctrl=0.0)
    return measured_t_inf - m.t_analog(layers) - m.t_events(layers)


def battery_lifetime_years(
    energy_per_inference_j: float,
    interval_s: float = 120.0,
    battery_mah: float = 200.0,
    battery_v: float = 3.0,
) -> float:
    """Paper §V: a CR2032 (~200 mAh) powering one inference every two minutes
    lasts ~5 years."""
    battery_j = battery_mah * 1e-3 * 3600.0 * battery_v
    inferences = battery_j / energy_per_inference_j
    return inferences * interval_s / (3600.0 * 24.0 * 365.25)
