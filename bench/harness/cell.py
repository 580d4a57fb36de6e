"""One run of one cell: set-up, the window, the traced stretch, the
correctness check.

Set-up draws the weights on the device from the seed, builds
``ServeEngine`` (which lowers the model once; the kernels come from
``build/kernels/`` in the checkout, built by the first run there), serves
one warm-up group of the traffic's largest prompt shape, and allocates
the host buffers of the check's capture.  The window then serves the
traffic's groups in a closed loop (:mod:`harness.window`).  With
``trace`` a stretch of it runs under the profiler
(:mod:`harness.profile`; started once in set-up, so that its own start
does not fall in the window): the traffic's ``trace`` entry names the
first group profiled, how many and how many tries; a stretch whose trace
lost records of the split kernel is tried again on the next groups, and
a run whose every try lost some fails.  The trace is read once the
window has closed.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from harness import capture
from harness import check as check_lib
from harness import profile as profile_lib
from harness import weights
from harness import window as window_lib
from harness.traffic import Traffic

# top-level modules the process must not hold once the window has closed
# (``bench/run.py`` looks before it prints a result)
BANNED = ("jax", "jaxlib", "flax", "repro")
# the configuration file's published sizes, as the program's ArchConfig
DIMS = {"num_hidden_layers": "n_layers", "num_layers": "n_layers",
        "hidden_size": "d_model", "intermediate_size": "d_ff",
        "ffn_hidden_size": "d_ff", "num_attention_heads": "n_heads",
        "num_key_value_heads": "n_kv_heads",
        "multi_query_group_num": "n_kv_heads", "vocab_size": "vocab_size",
        "padded_vocab_size": "vocab_size", "rope_theta": "rope_theta"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def arch_of(config: dict):
    """The program's ArchConfig of the configuration file, checked
    against the file's sizes."""
    from repro_torch import configs

    arch = configs.get_arch(config["arch"])
    for key, attr in DIMS.items():
        if key in config and float(config[key]) != float(getattr(arch, attr)):
            raise ValueError(f"{config['arch']}: {key} = {config[key]} in the "
                             f"configuration file, {getattr(arch, attr)} in "
                             "the program")
    return arch


class Steps:
    """The engine's step functions, wrapped: each call noted as a host
    range of the traced stretch, the layer tap told of each step, and the
    logits kept while the tap is on."""

    def __init__(self, engine, tracer, tap):
        self.tracer, self.tap = tracer, tap
        self.logits = []
        for kind in ("prefill", "decode"):
            setattr(engine, kind, self._wrap(kind, getattr(engine, kind)))

    def _wrap(self, kind, step):
        def run(params, batch, cache):
            rows = (batch["tokens"] if kind == "prefill" else batch).numel()
            self.tracer.call(kind, rows)
            self.tap.begin_step()
            t0 = time.time_ns()
            logits, cache = step(params, batch, cache)
            self.tracer.mark(f"{kind} step", t0)
            if self.tap.on:
                self.logits.append(self.tap.pool.keep(logits))
            return logits, cache
        return run


class Tracer:
    """The traced stretch's schedule and its tries (no-op when off)."""

    def __init__(self, spec, launches):
        self.spec, self.launches = spec, launches
        self.active = False
        self.kept = None
        self.tries = 0
        self.first = None if spec is None else int(spec["first"])
        self.trace = profile_lib.DeviceTrace()
        self.calls = []
        self.host = []

    def warm(self) -> None:
        """Start and stop the profiler once (set-up)."""
        if self.spec is not None:
            self.trace.start()
            self.trace.stop()

    def _start(self):
        self.active = True
        self.calls, self.host = [], []
        self.split0 = self.launches()
        self.trace.start()

    def _stop(self):
        events = self.trace.stop()
        self.active = False
        kept = profile_lib.split_records(events, self.trace.end_ns)
        launched = self.launches() - self.split0
        self.tries += 1
        if kept < launched:
            log(f"trace try {self.tries}: {kept} of {launched} split kernel "
                "records kept")
            if self.tries < int(self.spec["tries"]):
                self.first += int(self.spec["count"])
            else:
                self.first = None
            return
        self.kept = (events, self.trace.window_s, self.trace.end_ns,
                     self.calls, self.host, launched)
        self.first = None

    def result(self):
        """The kept stretch, read (None when no try kept it whole)."""
        if self.kept is None:
            return None
        events, window_s, end_ns, calls, host, launched = self.kept
        got = profile_lib.reduce(events, window_s, host, end_ns)
        got.update(calls=calls, split_launches=launched)
        return got

    def before_group(self, i: int) -> None:
        if self.first is not None and i == self.first:
            self._start()

    def after_group(self, i: int) -> None:
        if self.active and i == self.first + int(self.spec["count"]) - 1:
            self._stop()

    def call(self, kind, rows):
        if self.active:
            self.calls.append([kind, rows])

    def mark(self, name: str, t0_ns: int) -> None:
        """Note the host range ``name`` from ``t0_ns`` to now."""
        if self.active:
            self.host.append((t0_ns, time.time_ns(), name))


def build(cell, arch, traffic, seed: int, dev, tracer, tap):
    """The engine on the run's weights, its steps wrapped, and
    ``serve(group)``, which hands it one group."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.serve.engine import Request, ServeEngine

    params = weights.init_params(arch, seed, dev)
    engine = ServeEngine(arch, RunConfig(analog=AnalogConfig(
        mode=cell.config["mode"])), params, batch_size=traffic.batch,
        max_len=traffic.max_len, device=dev)
    del params
    steps = Steps(engine, tracer, tap)

    def serve(group):
        return engine.run_batch([Request(uid=r.uid, prompt=r.prompt,
                                         max_new_tokens=r.new_tokens)
                                 for r in group])
    return engine, steps, serve


def pools(arch, traffic, sampled: list, on_card: bool) -> dict:
    """A host buffer per sampled group for its capture."""
    return {gi: capture.Pool(capture.group_numel(arch, traffic,
                                                 traffic.group(gi)),
                             torch.bfloat16, on_card) for gi in sampled}


def served_tokens(outs) -> np.ndarray:
    return np.stack([o.astype(np.int64) for o in outs])


def run(cell, seed: int, seconds: float, trace: bool, *, device, t_start,
        arch=None) -> dict:
    """One run of ``cell``: its records (``rec``, what the metrics read),
    the check's readings and the peak device memory."""
    from repro_torch.kernels import _build
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    arch = arch or arch_of(cell.config)
    traffic = Traffic(cell.traffic, arch.vocab_size, seed)
    obs_metrics.reset_metrics()
    tr = obs_trace.begin("bench")
    tracer = Tracer(cell.traffic["trace"] if trace and on_card else None,
                    lambda: _build.launch_counts()["analog_mvm_split"])
    tap = capture.Tap()
    marks = [("start", time.monotonic() - t_start)]
    engine, steps, serve = build(cell, arch, traffic, seed, dev, tracer, tap)
    marks.append(("engine", time.monotonic() - t_start))
    serve(traffic.warmup_group())
    marks.append(("warm-up group", time.monotonic() - t_start))
    tracer.warm()
    sampled = check_lib.sample(cell.limits, seed,
                               check_lib.traced_groups(cell.traffic))
    kept_pools = pools(arch, traffic, sampled, on_card)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t_start
    compile_s = tr.spans("serve.compile")[0]["dur_us"] / 1e6
    log(f"set-up {setup_s:.3f} s (serve.compile {compile_s:.3f} s; "
        + ", ".join(f"{n} at {t:.3f} s" for n, t in marks) + ")")
    peak_setup = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    kept = {}

    def one(i):
        group = traffic.group(i)
        tap.on = i in sampled
        tap.pool, tap.steps = kept_pools.get(i), []
        steps.logits = []
        n_events = len(tr.events)
        tracer.before_group(i)
        handoff, t0 = obs_trace.clock_us(), time.time_ns()
        done = serve(group)
        back = obs_trace.clock_us()
        tracer.mark("engine between steps", t0)
        profiled = tracer.active
        tracer.after_group(i)
        tap.on = False
        pre = [e for e in tr.events[n_events:]
               if e["rec"] == "span" and e["name"] == "serve.prefill"][-1]
        outs = [r.output for r in done]
        if i in sampled:
            kept[i] = (group, served_tokens(outs), tap.steps, steps.logits)
        return {
            "prompt_lens": [len(r.prompt) for r in group],
            "padded_len": max(len(r.prompt) for r in group),
            "new_tokens": [len(o) for o in outs],
            "ok": [len(o) == r.new_tokens and bool(
                ((o >= 0) & (o < arch.vocab_size)).all())
                for o, r in zip(outs, group)],
            "handoff_us": handoff,
            "prefill_end_us": tr.t0_us + pre["t_us"] + pre["dur_us"],
            "return_us": back,
            "prefill_us": pre["dur_us"],
            "profiled": profiled,
            "sampled": i in sampled,
            "slot": i % len(traffic.layout),
        }

    with tap.installed():
        groups, window_s = window_lib.closed_loop(one, seconds)
    if tracer.active:
        tracer._stop()
    if on_card:
        torch.cuda.synchronize()
    log(f"window {window_s:.3f} s, {len(groups)} groups")
    peak_window = torch.cuda.max_memory_allocated(dev) if on_card else 0
    obs_trace.end(tr)
    t0 = time.monotonic()
    rec = {
        "arch": {"n_layers": arch.n_layers, "d_model": arch.d_model,
                 "n_heads": arch.n_heads, "n_kv_heads": arch.n_kv_heads,
                 "hd": arch.hd, "d_ff": arch.d_ff, "vocab": arch.vocab_size},
        "groups": groups, "window_s": window_s, "setup_s": setup_s,
        "compile_s": compile_s, "peak_window_bytes": peak_window,
        "trace": tracer.result(),
    }
    if tracer.spec is not None:
        if rec["trace"] is None:
            raise RuntimeError("the trace lost split kernel records in every "
                               "try (or never began); no share is reported")
        log(f"trace read in {time.monotonic() - t0:.3f} s")
    del one, serve, engine, steps
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    readings = check_lib.check(arch, seed, kept, traffic.max_len,
                               dev)["sound"]
    log(f"reference {time.monotonic() - t0:.3f} s")
    return {"rec": rec, "readings": readings,
            "peak_bytes": max(peak_setup, peak_window)}
