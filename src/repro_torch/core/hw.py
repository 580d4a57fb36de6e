"""Hardware constants for the BrainScaleS-2 ASIC.

All numbers are taken directly from the paper (Stradmann et al., 2022,
IEEE OJCAS, DOI 10.1109/OJCAS.2022.3208413): Section II-A, Eqs. (1)-(3)
and Table 1.  A copy of ``repro.core.hw.BSS2Spec``: the port keeps its
own so that it never imports the JAX package.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BSS2Spec:
    """Physical constants of one BrainScaleS-2 ASIC (paper §II-A, Table 1)."""

    # --- synapse array geometry (Fig. 3) -----------------------------------
    n_rows: int = 256            # hardware synapse rows per full array pass
    n_cols: int = 512            # analog neuron circuits (output columns)
    n_quadrants: int = 4         # 4 x (128 neurons x 256 synapses)
    signed_rows: int = 128       # logical signed inputs (2 hw rows / input)
    half_cols: int = 256         # columns per array half (Fig. 6 mapping)

    # --- datapath resolutions (Fig. 4) -------------------------------------
    a_bits: int = 5              # unsigned input activations (pulse length)
    w_bits: int = 6              # signed synaptic weights
    adc_bits: int = 8            # membrane readout resolution
    a_max: int = 31              # 2**5 - 1
    w_max: int = 63              # 2**6 - 1 magnitude, sign via A/B input
    adc_min: int = -128
    adc_max: int = 127

    # --- timing (Eq. (1), Eq. (2)) ------------------------------------------
    event_period_s: float = 8e-9       # back-to-back activation period (125 MHz)
    vmm_cycle_s: float = 5e-6          # full integrate + reset + ADC cycle

    # --- silicon (Eq. (3)) ----------------------------------------------------
    synapse_area_m2: float = 8e-6 * 12e-6
    die_area_mm2: float = 32.0

    # --- measured power/energy (Table 1) -------------------------------------
    system_power_w: float = 5.6
    asic_power_w: float = 0.69
    # Table-1 energy split for one ECG inference (J):
    energy_total_j: float = 1.56e-3
    energy_sysctrl_j: float = 0.7e-3
    energy_arm_j: float = 0.34e-3
    energy_fpga_j: float = 0.21e-3
    energy_dram_j: float = 0.12e-3
    energy_asic_j: float = 0.19e-3
    energy_asic_io_j: float = 0.07e-3
    energy_asic_analog_j: float = 0.07e-3
    energy_asic_digital_j: float = 0.07e-3
    # Table-1 reference performance numbers:
    time_per_inference_s: float = 276e-6
    ops_per_inference: float = 132e3
    processing_speed_ops: float = 477e6
    energy_eff_op_per_j: float = 689e6
    energy_eff_inf_per_j: float = 5.25e3

    # ------------------------------------------------------------------ derived
    @property
    def peak_ops(self) -> float:
        """Eq. (1): 125 MHz * 256 * 512 * 2 Op = 32.8 TOp/s."""
        return (1.0 / self.event_period_s) * self.n_rows * self.n_cols * 2

    @property
    def sustained_ops(self) -> float:
        """Eq. (2): (1 / 5 us) * 256 * 512 * 2 Op ~= 52 GOp/s."""
        return (1.0 / self.vmm_cycle_s) * self.n_rows * self.n_cols * 2

    @property
    def synapse_array_area_mm2(self) -> float:
        return self.n_rows * self.n_cols * self.synapse_area_m2 * 1e6

    @property
    def area_efficiency_top_s_mm2(self) -> float:
        """Eq. (3): 32.8 TOp/s over the synapse array area = 2.6 TOp/(s mm^2)."""
        return self.peak_ops / 1e12 / self.synapse_array_area_mm2


BSS2 = BSS2Spec()
