"""Carry parameters across from the JAX package.

The reference's parameter tree, with every leaf converted to a numpy
array (``jax.tree.map(np.asarray, params)`` on the caller's side), maps
leaf for leaf onto the port's: the same nested dicts (``w``, ``w_scale``,
``a_scale``, ``gain``, ``b`` and the ``fpn`` fixed-pattern tables) holding
float32 tensors; an LM tree carries its scan-stacked ``layers`` (a
leading ``[n_groups]`` axis on every leaf), ``embed`` and the norms the
same way (an MoE layer's ``router.w``, its raw ``up`` / ``gate`` /
``down`` expert stacks ``[E, K, N]`` - ``[S, E, K, N]`` scan-stacked - and
its ``shared`` expert MLP included; an RWKV layer's time mix ``rwkv``
with its token-shift factors ``tm.mu_r`` ... ``tm.mu_w``, ``w0``, ``u``
and the decay LoRA ``w_lora_a`` / ``w_lora_b`` beside ``wr`` / ``wk`` /
``wv`` / ``wg`` / ``wo``, and its channel mix ``cmix`` (``mu_k``, ``wk``,
``wv``); a Mamba layer's ``in_proj``, ``conv_w`` / ``conv_b``,
``A_log``, ``dt_bias``, ``D``, ``norm`` and ``out_proj``; and Zamba2's
unstacked ``shared_attn`` block, ``ln`` and ``attn``); a training state
(:func:`state_from_numpy`) adds the AdamW moments and the error-feedback
tree.  The port cannot reproduce
``jax.random`` draws, so this is how a parity check hands both packages
the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device


def params_from_numpy(tree, device: DeviceLike = None):
    """Nested dicts of numpy arrays -> the same dicts of float32 tensors on
    ``device`` (``None`` = the CUDA device)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype.kind != "f":
            raise TypeError(f"expected a floating-point leaf, got {arr.dtype}")
        return torch.tensor(arr, dtype=torch.float32, device=dev)

    return conv(tree)


def state_from_numpy(state, device: DeviceLike = None):
    """A training state of the reference (``{"params", "opt": {"step",
    "m", "v"}, ["ef"]}``, every leaf a numpy array) -> the port's: float
    leaves as float32 tensors, the integer step count as an int32
    tensor, on ``device`` (``None`` = the CUDA device).  A parity check
    starts both packages' train steps from one state so."""
    dev = resolve_device(device)
    out = {"params": params_from_numpy(state["params"], dev),
           "opt": {"step": torch.tensor(np.asarray(state["opt"]["step"]),
                                        dtype=torch.int32, device=dev),
                   "m": params_from_numpy(state["opt"]["m"], dev),
                   "v": params_from_numpy(state["opt"]["v"], dev)}}
    if "ef" in state:
        out["ef"] = params_from_numpy(state["ef"], dev)
    return out
