"""End-to-end driver of the PyTorch port: the paper's showcase, start to
finish (paper §III-IV; the twin of ``examples/ecg_train.py``).

    PYTHONPATH=src python examples_torch/ecg_train.py [--epochs 40] \
        [--fast] [--device cpu]

Pipeline (all stages implemented, none stubbed):
  synthetic 2-channel ECG records (the competition set is private)
    -> FPGA preprocessing chain (derivative, max-min pool 32, 5-bit quant)
    -> Fig.-6 CDNN declared once (``ecg_module_spec``) and compiled
       through the ``repro_torch.api`` front door onto the analog backend
    -> hardware-in-the-loop training (noisy analog fwd, float bwd;
       training re-compiles per step, eval replays one CompiledModel)
    -> standalone-inference evaluation (deterministic, avg-pool readout)
    -> Table-1 energy/latency accounting for the trained model

The training loop is ``repro_torch.train.ecg_accuracy.run`` (the port of
``benchmarks/ecg_accuracy.py``).  It runs on the CUDA device (the
hand-written kernels) unless ``--device`` names another.

Paper reference points: detection (93.7 +- 0.7)% @ (14.0 +- 1.0)% FP,
276 us / 1.56 mJ per inference.
"""
import argparse

from repro_torch import api, obs
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.energy import LayerWork, SystemModel, battery_lifetime_years
from repro_torch.models.ecg import ECGConfig, ecg_module_spec
from repro_torch.train.ecg_accuracy import run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--n-train", type=int, default=0,
                    help="override train-set size (0 = preset)")
    ap.add_argument("--n-test", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    a = ap.parse_args(argv)

    kw = dict(n_train=600, n_test=250, epochs=10) if a.fast else dict(
        epochs=a.epochs
    )
    if a.n_train:
        kw["n_train"] = a.n_train
    if a.n_test:
        kw["n_test"] = a.n_test
    kw["device"] = a.device
    with obs.collect("ecg-train") as tr:
        print("=== HIL training on the analog backend (mock-mode noise) "
              "===")
        with obs.span("ecg.train.analog"):
            r = run(mode="analog_faithful", **kw)
        print(f"\nanalog HIL: detection {r['detection_rate']*100:.1f}% @ "
              f"{r['false_positive_rate']*100:.1f}% FP  "
              f"[paper: 93.7% @ 14.0%]  ({r['train_s']:.0f}s)")

        print("\n=== digital software baseline (same data/model) ===")
        with obs.span("ecg.train.digital"):
            rd = run(mode="digital", verbose=False, **kw)
        print(f"digital:   detection {rd['detection_rate']*100:.1f}% @ "
              f"{rd['false_positive_rate']*100:.1f}% FP")

        print("\n=== deployment cost on the BSS-2 mobile system ===")
        ecg = ECGConfig()
        m = SystemModel()
        rep = m.report([LayerWork(k=lw.k, n=lw.n)
                        for lw in ecg.layer_works()])
        print(f"per inference: {rep['time_s']*1e6:.0f} us, "
              f"{rep['energy_total_j']*1e3:.2f} mJ total "
              f"({rep['energy_asic_j']*1e6:.0f} uJ on-ASIC)  "
              f"[paper: 276 us, 1.56 mJ, 192 uJ]")
        print(f"CR2032 @ 2-min monitoring interval: "
              f"{battery_lifetime_years(rep['energy_total_j']):.1f} years "
              f"[paper: ~5 years]")

        # end-of-run obs report: the SAME accounting, but derived from
        # the compiled plan of the trained weights (paper §II-A
        # standalone inference: the code-domain single program) rather
        # than from config geometry
        plan = api.compile(
            ecg_module_spec(ecg, epilogue="relu_shift"), r["params"],
            AnalogConfig(mode="analog_fast"), device=a.device,
        ).lower()
        erep = obs.energy.record(plan, prefix="ecg.energy")

    print("\n=== end-of-run obs report (trained plan) ===")
    print(obs.energy.format_report(erep, title="ecg"))
    print()
    print(obs.report.render(
        obs.report.records_of(tr, obs.metrics.registry())
    ))


if __name__ == "__main__":
    main()
