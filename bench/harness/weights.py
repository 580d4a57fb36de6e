"""The benchmark's weights: every master tensor of a dense transformer
drawn on the device from the run's seed, in a few large calls, in the tree
layout that ``ServeEngine`` takes (every layer leaf stacked over the
layers under ``layers.l0``).

Per linear layer ``[K, N]``: ``w ~ N(0, 1/K)``; the per-column weight LSB
``max|w| / 63``; the activation LSB ``1/31``; the analog gain that keeps
three sigmas of a 128-row chunk's partial sum, at an assumed RMS of 9
activation codes, inside the 8-bit ADC; the frozen rank-1 fixed pattern
(row and column gains ``1 + 0.02/sqrt(2) N(0, 1)``) and per-(chunk,
column) ADC offsets ``N(0, 1)`` LSB.  Embeddings ``0.02 N(0, 1)``, norm
scales 1.  These are inputs: the program bakes from them, and the
reference bakes from the same tensors drawn again.
"""
from __future__ import annotations

import math

import numpy as np
import torch

W_MAX, A_MAX, ADC_MAX = 63, 31, 127
CHUNK_ROWS = 128
GAIN_STD, OFFSET_STD = 0.02, 1.0
ACT_RMS, HEADROOM = 9.0, 3.0


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of one of the run's independent random streams."""
    state = np.random.SeedSequence([seed % 2**64, stream]).generate_state(
        1, np.uint64)
    return int(state[0]) % 2**63


def _linear(gen, n_layers, k, n, device):
    """One stacked linear leaf of ``n_layers`` ``[k, n]`` layers (``None``:
    unstacked, one layer)."""
    lead = () if n_layers is None else (n_layers,)

    def normal(*shape):
        return torch.randn(lead + shape, generator=gen, dtype=torch.float32,
                           device=device)

    w = normal(k, n).mul_(1.0 / math.sqrt(k))
    top = torch.maximum(w.amax(dim=-2, keepdim=True),
                        -w.amin(dim=-2, keepdim=True))
    w_scale = torch.clamp_min(top, 1e-8) / W_MAX
    gains = []
    for i in range(1 if n_layers is None else n_layers):
        wi, si = (w, w_scale) if n_layers is None else (w[i], w_scale[i])
        rms = torch.sqrt(torch.mean((wi / si) ** 2) + 1e-6)
        partial = math.sqrt(CHUNK_ROWS) * ACT_RMS * rms
        gains.append(torch.clamp_max(ADC_MAX / (HEADROOM * partial + 1e-6),
                                     1.0))
    gain = gains[0] if n_layers is None else torch.stack(gains)
    s = GAIN_STD / math.sqrt(2.0)
    return {
        "w": w,
        "w_scale": w_scale,
        "a_scale": torch.full(lead, 1.0 / A_MAX, dtype=torch.float32,
                              device=device),
        "gain": gain,
        "fpn": {
            "row_gain": normal(k).mul_(s).add_(1.0),
            "col_gain": normal(n).mul_(s).add_(1.0),
            "chunk_offset": normal(-(-k // CHUNK_ROWS), n).mul_(OFFSET_STD),
        },
    }


def init_params(arch, seed: int, device) -> dict:
    """Master tensors of the dense transformer ``arch`` (an
    ``ArchConfig``: ``n_layers``, ``d_model``, ``n_heads``,
    ``n_kv_heads``, ``hd``, ``d_ff``, ``vocab_size``) from ``seed``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(stream_seed(seed, 1))
    n_l, d, ff = arch.n_layers, arch.d_model, arch.d_ff
    nq, nkv = arch.n_heads * arch.hd, arch.n_kv_heads * arch.hd

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    with torch.no_grad():
        table = torch.randn((arch.vocab_size, d), generator=gen,
                            dtype=torch.float32, device=dev).mul_(0.02)
        layer = {
            "ln1": {"scale": ones(n_l, d)},
            "attn": {"wq": _linear(gen, n_l, d, nq, dev),
                     "wk": _linear(gen, n_l, d, nkv, dev),
                     "wv": _linear(gen, n_l, d, nkv, dev),
                     "wo": _linear(gen, n_l, nq, d, dev)},
            "ln2": {"scale": ones(n_l, d)},
            "mlp": {"up": _linear(gen, n_l, d, ff, dev),
                    "down": _linear(gen, n_l, ff, d, dev),
                    "gate": _linear(gen, n_l, d, ff, dev)},
        }
        return {"embed": {"table": table}, "layers": {"l0": layer},
                "final_norm": {"scale": ones(d)},
                "lm_head": _linear(gen, None, d, arch.vocab_size, dev)}
