"""Fault-tolerant checkpointing without external dependencies (port of
``repro.train.checkpoint``, in the reference's on-disk format, so a
checkpoint written by either package restores in the other).

- **atomicity**: write to ``<dir>/tmp.step_<step>`` then ``os.replace`` -
  a crash mid-write never corrupts the latest checkpoint;
- **integrity**: a SHA-256 per file in ``manifest.json``, verified on
  restore;
- **resumability**: :func:`restore_latest` returns ``(params, opt_state,
  step, extra)`` and skips corrupt or partial checkpoints;
- **retention**: keep-last-k;
- **layout**: the leaves of one process in ``shard-<proc>.npz``, keyed by
  their ``/``-joined dict paths (``params/layers/l0/attn/wq/w``,
  ``opt_state/m/...``, ``opt_state/step``).

The leaves are saved as numpy arrays in their own dtype; a bfloat16
leaf, which numpy has no type for, is saved as float32 and cast back to
the template's dtype on restore (the reference casts to the template's
dtype too).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from typing import Optional

import numpy as np
import torch

MANIFEST = "manifest.json"


def _process_index() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _flatten(tree, prefix: str = "") -> dict:
    """``/``-joined path -> numpy array, for nested dicts of tensors."""
    flat = {}
    for k in sorted(tree):          # the reference's pytree key order
        path = f"{prefix}/{k}" if prefix else str(k)
        v = tree[k]
        if isinstance(v, dict):
            flat.update(_flatten(v, path))
        else:
            t = torch.as_tensor(v).detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.to(torch.float32)
            flat[path] = t.numpy()
    return flat


def _unflatten(template, flat: dict, prefix: str = ""):
    out = {}
    for k, leaf in template.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(leaf, dict):
            out[k] = _unflatten(leaf, flat, path)
            continue
        if path not in flat:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        arr = flat[path]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {path}: ckpt {arr.shape} "
                             f"vs {tuple(leaf.shape)}")
        out[k] = torch.from_numpy(np.array(arr)).to(device=leaf.device,
                                                    dtype=leaf.dtype)
    return out


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save(directory: str, step: int, params, opt_state=None,
         extra: Optional[dict] = None, keep: int = 3) -> str:
    """Atomically save a checkpoint; returns the final path."""
    os.makedirs(directory, exist_ok=True)
    proc = _process_index()
    tmp = os.path.join(directory, f"tmp.step_{step:09d}")
    final = os.path.join(directory, f"step_{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    payload = {"params": params}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    flat = _flatten(payload)
    shard_file = os.path.join(tmp, f"shard-{proc:05d}.npz")
    np.savez(shard_file, **flat)

    manifest = {
        "step": int(step),
        "time": time.time(),
        "extra": extra or {},
        "files": {os.path.basename(shard_file): _sha256(shard_file)},
        "n_leaves": len(flat),
    }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    if os.path.isdir(final):   # re-save of the same step: replace it
        shutil.rmtree(final)
    os.replace(tmp, final)     # atomic publish
    _gc(directory, keep)
    return final


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _gc(directory: str, keep: int) -> None:
    steps = _steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)
    # sweep stale tmp dirs from crashed writers
    for name in os.listdir(directory):
        if name.startswith("tmp."):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def _verify(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        for fname, digest in manifest["files"].items():
            fpath = os.path.join(path, fname)
            if not os.path.exists(fpath) or _sha256(fpath) != digest:
                return None
        return manifest
    except (OSError, json.JSONDecodeError, KeyError):
        return None


def restore_latest(directory: str, params_template, opt_template=None):
    """Restore the newest intact checkpoint onto the templates' devices
    and dtypes.  Returns ``(params, opt_state, step, extra)`` or None if
    nothing is restorable; corrupt checkpoints are skipped."""
    for step in reversed(_steps(directory)):
        path = os.path.join(directory, f"step_{step:09d}")
        manifest = _verify(path)
        if manifest is None:
            continue
        flat = {}
        for fname in manifest["files"]:
            with np.load(os.path.join(path, fname)) as z:
                flat.update({k: z[k] for k in z.files})
        template = {"params": params_template}
        if opt_template is not None:
            template["opt_state"] = opt_template
        try:
            payload = _unflatten(template, flat)
        except (KeyError, ValueError):
            continue
        return (payload["params"], payload.get("opt_state"),
                manifest["step"], manifest.get("extra", {}))
    return None
