"""Work counted from shapes: the split kernel's bytes and operations per
launch, its roofline bound, and the model FLOPs of the prefills.  Frozen
here, so that a change to the program cannot change the yardstick.

``arch`` is a mapping with ``n_layers``, ``d_model``, ``n_heads``,
``n_kv_heads``, ``hd``, ``d_ff`` and ``vocab``.
"""
from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
CHUNK_ROWS = 128


def split_launches(arch: dict, m: int) -> list:
    """``(m, k_pad, n, table_bytes)`` of each split launch of one prefill
    or decode call on ``m`` rows: per layer the fused q|k|v (one row-gain
    vector per member), ``wo``, ``up``, ``gate``, ``down``, then the
    lm_head."""
    d, ff, v = arch["d_model"], arch["d_ff"], arch["vocab"]
    nq = arch["n_heads"] * arch["hd"]
    nkv = arch["n_kv_heads"] * arch["hd"]

    def launch(k, n, members=1):
        k_pad = -(-k // CHUNK_ROWS) * CHUNK_ROWS
        # rank-1 tables: a column gain per column, a row gain per row
        return (m, k_pad, n, 4 * (n + members * k_pad))

    layer = [launch(d, nq + 2 * nkv, members=3), launch(nq, d),
             launch(d, ff), launch(d, ff), launch(ff, d)]
    return layer * arch["n_layers"] + [launch(d, v)]


def split_work(m: int, k: int, n: int, table_bytes: int) -> tuple:
    """(bytes, operations) of one split launch with the int8 code operand:
    both passes' activation codes (fp32), the codes, their gain tables,
    the gain, the chunk offsets and the output, each once; both passes'
    products."""
    c = k // CHUNK_ROWS
    nbytes = 4 * (2 * m * k + n + c * n + m * n) + k * n + table_bytes
    return nbytes, 2 * 2 * m * k * n


def bound_s(nbytes: float, nops: float) -> float:
    """The least time of a launch: bytes over HBM bandwidth or operations
    over the bf16 peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S)


def split_bound_s(arch: dict, m: int) -> float:
    """Summed bound of the split launches of one call on ``m`` rows."""
    return sum(bound_s(*split_work(*launch))
               for launch in split_launches(arch, m))


def _layer_matmul_flops(arch: dict) -> int:
    d, ff = arch["d_model"], arch["d_ff"]
    nq = arch["n_heads"] * arch["hd"]
    nkv = arch["n_kv_heads"] * arch["hd"]
    return 2 * (d * (nq + 2 * nkv) + nq * d + 3 * d * ff)


def _attention_flops(arch: dict, keys: int) -> int:
    """QK^T and AV of one query over ``keys`` keys, all heads."""
    return 4 * arch["n_heads"] * arch["hd"] * keys


def prefill_flops(arch: dict, prompt_lens) -> int:
    """Model FLOPs of one prefill: each prompt's real tokens through every
    layer, attention over its causal context, the lm_head at the one
    position sampled.  No padding."""
    n_l = arch["n_layers"]
    head = 2 * arch["d_model"] * arch["vocab"]
    total = 0
    for n in prompt_lens:
        total += n * n_l * _layer_matmul_flops(arch)
        total += n_l * _attention_flops(arch, n * (n + 1) // 2)
        total += head
    return total

