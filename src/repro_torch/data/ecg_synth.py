"""Synthetic two-channel ECG generator (sinus rhythm vs atrial fibrillation).

The BMBF competition dataset is private (paper footnote 1), so per the
reproduction rules we simulate it with matched statistics:

- 2 channels, consumer-wearable quality (noise, baseline wander)
- sinus rhythm: regular RR intervals (~60-100 bpm, low HRV), P-QRS-T complex
- atrial fibrillation: irregularly-irregular RR intervals (high HRV,
  autocorrelation-free), absent P waves, fibrillatory baseline (4-9 Hz
  f-waves) - the standard clinical discriminators (Clifford et al. 2017).

The generator is deterministic in (seed, index) so the data pipeline is
resumable and shardable by construction.
"""
from __future__ import annotations

import dataclasses

import numpy as np

FS = 300.0                      # Hz, PhysioNet-2017-like sampling rate
WINDOW_RAW = 4033               # 13.4 s -> 4032 derivative samples -> 126


@dataclasses.dataclass(frozen=True)
class ECGDatasetConfig:
    n_train: int = 4000
    n_test: int = 500
    seed: int = 1234
    afib_fraction: float = 0.5
    fs: float = FS
    window: int = WINDOW_RAW


def _qrs_complex(t, width=0.025):
    """Narrow biphasic QRS-like wavelet."""
    return (1.0 - (t / width) ** 2) * np.exp(-0.5 * (t / width) ** 2)


def _wave(t, center, width, amp):
    return amp * np.exp(-0.5 * ((t - center) / width) ** 2)


def _synth_beat_train(rng, n_samples, fs, afib: bool):
    """One channel of ECG as a sum of per-beat templates."""
    t_total = n_samples / fs
    beats = []
    t = float(rng.uniform(0.0, 0.3))
    while t < t_total + 1.0:
        if afib:
            # irregularly irregular: heavy-tailed, uncorrelated RR
            rr = float(np.clip(rng.gamma(4.0, 0.045) + 0.35, 0.3, 1.6))
        else:
            rr = float(np.clip(rng.normal(0.85, 0.04), 0.6, 1.2))
        beats.append(t)
        t += rr
    sig = np.zeros(n_samples)
    ts = np.arange(n_samples) / fs
    for tb in beats:
        amp = rng.normal(1.0, 0.08)
        sig += amp * _qrs_complex(ts - tb)
        # T wave
        sig += _wave(ts, tb + 0.25, 0.06, 0.25 * amp)
        if not afib:
            # P wave precedes QRS in sinus rhythm only
            sig += _wave(ts, tb - 0.16, 0.035, 0.12 * amp)
    if afib:
        # fibrillatory baseline: 4-9 Hz f-waves
        f = rng.uniform(4.0, 9.0)
        phase = rng.uniform(0, 2 * np.pi)
        sig += 0.06 * np.sin(2 * np.pi * f * ts + phase)
        sig += 0.03 * np.sin(2 * np.pi * (f * 1.7) * ts + phase * 1.3)
    return sig


def synth_record(seed: int, index: int, afib: bool,
                 cfg: ECGDatasetConfig = ECGDatasetConfig()) -> np.ndarray:
    """One two-channel record [2, window] in raw 12-bit ADC counts."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    out = np.zeros((2, cfg.window), np.float32)
    for ch, gain in enumerate((1.0, 0.7)):
        sig = gain * _synth_beat_train(rng, cfg.window, cfg.fs, afib)
        # baseline wander (respiration) + powerline + sensor noise
        ts = np.arange(cfg.window) / cfg.fs
        sig += 0.4 * np.sin(2 * np.pi * rng.uniform(0.15, 0.4) * ts
                            + rng.uniform(0, 6.28))
        sig += 0.02 * np.sin(2 * np.pi * 50.0 * ts)
        sig += rng.normal(0.0, 0.03, cfg.window)
        # 12-bit ADC counts around mid-scale (the FPGA receives 12-bit data)
        out[ch] = np.clip(np.round(sig * 600.0 + 2048.0), 0, 4095)
    return out


def make_dataset(cfg: ECGDatasetConfig = ECGDatasetConfig(), split="train"):
    """Returns (records [N, 2, T] float32 raw counts, labels [N] int32)."""
    n = cfg.n_train if split == "train" else cfg.n_test
    base = 0 if split == "train" else 10_000_000
    rng = np.random.default_rng(cfg.seed + (1 if split == "test" else 0))
    labels = (rng.random(n) < cfg.afib_fraction).astype(np.int32)
    records = np.stack(
        [
            synth_record(cfg.seed, base + i, bool(labels[i]), cfg)
            for i in range(n)
        ]
    )
    return records, labels
