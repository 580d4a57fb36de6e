"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on its own by ``nvcc`` into a shared library with
a plain C interface, at first use, into ``build/kernels/`` at the root of
the checkout, and loaded with ``ctypes``.  The file name carries a hash of
the source, of every shared header (``csrc/*.cuh``) and of the flags, so
an edited source or header rebuilds and an unchanged one is reused.
:func:`build` starts one ``nvcc`` per missing source, all at once, and
waits for them.

Every launch goes through :func:`launch`: it calls the C entry point on
PyTorch's current stream, raises when the entry point returns a CUDA
error, and only then adds one to the kernel's launch count.  Each kernel
module declares its entry point's C signature once
(:func:`declare`); the entry point is looked up and bound when its
library loads, so a launch only calls it (pointers as plain ints, which
``ctypes.c_void_p`` arguments take at full width).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional, Sequence

import torch

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
KERNELS = ("maxmin_pool", "analog_mvm", "analog_mvm_split", "analog_plan",
           "analog_plan_block")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_ARGTYPES: Dict[str, tuple] = {}
_ENTRIES: Dict[str, object] = {}
# launch counts: one per kernel, and the split kernel's expert-axis
# launches (one per expert stack) and member-axis launches (one per
# batch_concat group) under names of their own
COUNTERS = KERNELS + ("analog_mvm_split_experts", "analog_mvm_split_members")
_LAUNCHES: Dict[str, int] = {name: 0 for name in COUNTERS}
# PyTorch's current stream as a plain int (the private binding its own
# Triton launcher uses), else through a Stream object
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are compiled at "
        "first use and need the CUDA toolkit (nvcc on PATH or under "
        "/usr/local/cuda)"
    )


def library_path(name: str) -> pathlib.Path:
    """Where the shared library of kernel ``name`` is (or will be) built."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; known: {KERNELS}")
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    # the shared headers too: an edited header rebuilds what includes it
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every kernel in ``names`` whose library is missing, one
    ``nvcc`` process per source, all started together.  Returns the wall
    seconds each build took (0.0 for a library that was already built).
    ``nvcc``'s register and shared-memory report (``-Xptxas -v``) is kept
    beside each library as ``<library>.log``."""
    names = tuple(names)
    todo = {n: library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    seconds = {n: 0.0 for n in names}
    if not todo:
        return seconds
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def declare(name: str, argtypes: Sequence) -> None:
    """Declare the C signature of ``<name>_launch`` without its trailing
    stream argument (bound when the library loads)."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; known: {KERNELS}")
    _ARGTYPES[name] = tuple(argtypes) + (ctypes.c_void_p,)


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = list(_ARGTYPES[name])
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: Sequence,
             restype=ctypes.c_int):
    """Another C function of kernel ``name``'s library (a query, not a
    launch: not counted), bound once."""
    key = f"{name}:{symbol}"
    fn = _ENTRIES.get(key)
    if fn is None:
        fn = getattr(_library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _ENTRIES[key] = fn
    return fn


def launch(name: str, device: torch.device, *args,
           count_as: Optional[str] = None) -> None:
    """Call ``<name>_launch(*args, stream)`` of kernel ``name`` on
    PyTorch's current stream of ``device``; raise on a CUDA error, else
    count the launch (under ``count_as``, one of :data:`COUNTERS`, when
    given).  ``device`` becomes the current device only for the call,
    and only when it is not already."""
    fn = _ENTRIES.get(name)
    if fn is None:
        _library(name)
        fn = _ENTRIES[name]
    index = device.index
    current = torch.cuda.current_device()
    if index is None or index == current:
        rc = fn(*args, _stream(current))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, _stream(index))
    if rc != 0:
        msg = getattr(_LIBS[name], f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
    _LAUNCHES[count_as or name] += 1


def _stream(index: int) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device`` (what the kernels take)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address for a ``ctypes.c_void_p`` argument
    (None for an absent operand: a null pointer)."""
    return None if t is None else t.data_ptr()
