"""Batched serving engine (port of ``repro.serve.engine``): request queue
-> left-padded prefill -> synchronous batched decode with per-sequence
stopping.  Requests are grouped into fixed decode slots of
``batch_size``.

Telemetry (:mod:`repro_torch.obs`, host side, the reference's names): a
``serve.compile`` span around the compile (``api.compile`` nests under
it) and a ``serve.energy`` event with the plans' energy report; per
batch a ``serve.refill`` event and a ``serve.batch`` span nesting
``serve.prefill`` and ``serve.decode``; histograms ``serve.queue_us``,
``serve.prefill_us``, ``serve.decode_us`` (per step),
``serve.request_us`` and ``serve.batch_occupancy``.  Each step's
sampled tokens are read on the host once, as the loop needs them anyway;
the telemetry adds no synchronization.

The deployment hooks (the reference's):

- ``calibration``: a measured
  :class:`~repro_torch.calib.snapshot.CalibrationSnapshot` that
  ``api.compile`` bakes in place of the oracle fixed pattern (per-stack-
  member ``[S, C, N]`` tables for scan-stacked layers, the fleet gather);
- ``plan_cache``: a ``.npz`` path of the lowered tree
  (:mod:`repro_torch.exec.store`).  When the file exists the engine boots
  from it and lowers nothing; otherwise it compiles and writes it.  The
  counters and events ``serve.plan_cache.hit`` / ``.miss`` record which;
- ``drift_monitor``: a :class:`~repro_torch.calib.monitor.DriftMonitor`
  probed between batches; a refreshed snapshot is hot-swapped into the
  served plans (``CompiledModel.with_calibration``, no lowering), a
  ``serve.hot_swap`` span and counter;
- ``fleet``: a :class:`~repro_torch.fleet.health.FleetMonitor` whose probe
  runs between batches beside the drift check; a dead chip's chunks are
  remapped onto a spare and the spare's tables hot-swapped the same way;
- ``prelower=False`` serves the raw parameters, every analog layer
  lowered per call (the reference's unbaked route).

Under a mesh (:func:`repro_torch.distributed.sharding.use_mesh`) the
served tree - the pre-lowered plans, a hot-swapped or remapped tree, or
the raw parameters - is stored as this rank's blocks, sharded by
``CompiledModel.sharding_specs()`` (``T.lm_specs`` for raw parameters),
and the steps are :class:`~repro_torch.serve.serve_step.MeshServeStep`:
nothing is lowered between batches, and every rank samples the same
tokens.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.device import DeviceLike, resolve_device, to_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.obs import energy as obs_energy
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.serve_step import init_cache, make_serve_steps


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # [S] int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine:
    output: Optional[np.ndarray] = None
    # stamped by serve() on admission; feeds the serve.queue_us histogram
    t_enqueue_us: Optional[float] = None


class ServeEngine:
    def __init__(self, cfg: ArchConfig, run: RunConfig, params,
                 batch_size: int = 8, max_len: int = 512,
                 greedy: bool = True, seed: int = 0, prelower: bool = True,
                 calibration=None, drift_monitor=None,
                 plan_cache: Optional[str] = None, fleet=None,
                 device: DeviceLike = None):
        if not cfg.embed_inputs:
            raise ValueError(
                f"{cfg.name} is fed precomputed embeddings (embed_inputs="
                "False), but ServeEngine serves token prompts; serve it "
                "through serve_step.make_serve_steps with {'embeds': ...}")
        self.cfg, self.run = cfg, run
        self.device = resolve_device(device)
        # Serving is inference against frozen weights: compile the model
        # ONCE through the front door (quantized effective weights, chunk
        # padding, offsets, the fused QKV dispatch groups) on the device,
        # so every prefill/decode replays the baked plans.  LM plans are
        # split-encoded float layers: one fused-split dispatch per layer.
        # A plan cache that exists IS the executable: the int8 codes and
        # tables on disk load without lowering (it holds the bake of THESE
        # params: after a weight update, delete it or pass a new path).
        self.model = None
        self.drift_monitor = drift_monitor
        self.fleet = fleet
        if prelower and run.analog.mode != "digital":
            with obs_trace.span("serve.compile", model=cfg.name) as sp:
                spec = T.lm_module_spec(cfg, params)
                if plan_cache is not None and os.path.exists(plan_cache):
                    from repro_torch.exec.store import load_plan

                    obs_metrics.counter("serve.plan_cache.hit").inc()
                    obs_trace.event("serve.plan_cache", status="hit",
                                    path=plan_cache)
                    self.model = api.CompiledModel(
                        spec=spec, params=params, run_cfg=run,
                        lowered=load_plan(plan_cache, device=self.device),
                        device=self.device, calibration=calibration)
                    sp.add(route="plan_cache")
                else:
                    if plan_cache is not None:
                        obs_metrics.counter("serve.plan_cache.miss").inc()
                        obs_trace.event("serve.plan_cache", status="miss",
                                        path=plan_cache)
                    self.model = api.compile(spec, params, run,
                                             calibration=calibration,
                                             device=self.device)
                    if plan_cache is not None:
                        from repro_torch.exec.store import save_plan

                        save_plan(plan_cache, self.model.lower())
                    sp.add(route="lower")
                # static per-inference cost of the plans this engine serves
                obs_energy.record(self.model, prefix="serve.energy")
            params = self.model.lower()
        else:
            params = to_device(params, self.device)
        step_kw = {}
        if shd.get_mesh() is not None:
            step_kw = dict(abstract_params=params, param_specs=(
                T.lm_specs(cfg) if self.model is None
                else self.model.sharding_specs()))
        self.prefill, self.decode = make_serve_steps(cfg, run, **step_kw)
        self.param_shardings = getattr(self.prefill, "param_shardings", None)
        self.params = self._placed(params)
        self.batch_size = batch_size
        self.max_len = max_len
        self.greedy = greedy
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _placed(self, params):
        """The served tree as this engine stores it: this rank's blocks
        under a mesh (plan leaves shard by the axes of the weights they
        were baked from), else as it is.  Where the mesh splits the tree,
        the engine lets the whole tree go - its compiled model keeps the
        spec and the calibration, not the whole tree - unless a drift
        monitor or a fleet may hot-swap the plans, which re-derives them
        from the whole compiled model."""
        if shd.get_mesh() is None:
            return params
        local = shd.shard_tree(params, self.param_shardings)
        if (local is not params and self.model is not None
                and self.drift_monitor is None and self.fleet is None):
            self.model = dataclasses.replace(self.model, params=None,
                                             lowered=None)
        return local

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.greedy:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def maybe_recalibrate(self) -> bool:
        """Drift-monitor hook (called between batches): probe the devices
        and, on drift, hot-swap the refreshed snapshot's tables into the
        served plans.  Returns True iff a swap happened."""
        if self.drift_monitor is None or self.model is None:
            return False
        snapshot = self.drift_monitor.maybe_refresh()
        if snapshot is None:
            return False
        with obs_trace.span("serve.hot_swap"):
            self.model = self.model.with_calibration(snapshot)
            self.params = self._placed(self.model.lower())
        obs_metrics.counter("serve.hot_swap").inc()
        return True

    def maybe_remap(self) -> bool:
        """Fleet-health hook (called between batches): probe every chip
        and, when one died, remap its chunks onto a spare and hot-swap the
        re-gathered tables into the served plans.  Returns True iff a
        remap happened."""
        if self.fleet is None or self.model is None:
            return False
        model = self.fleet.maybe_remap(self.model)
        if model is None:
            return False
        with obs_trace.span("serve.hot_swap", reason="fleet.remap"):
            self.model = model
            self.params = self._placed(self.model.lower())
        obs_metrics.counter("serve.hot_swap").inc()
        return True

    def run_batch(self, requests: list) -> list:
        """Serve one group of <= batch_size requests to completion.

        Telemetry: a ``serve.batch`` span nests ``serve.prefill`` and
        ``serve.decode``; each span closes after the host read of the
        step's sampled tokens (the read the loop needs), so a prefill or
        decode time includes its device work."""
        if len(requests) > self.batch_size:
            raise ValueError(f"{len(requests)} requests > batch_size "
                             f"{self.batch_size}")
        self.maybe_recalibrate()
        self.maybe_remap()
        b = len(requests)
        t_start = obs_trace.clock_us()
        for r in requests:
            if r.t_enqueue_us is not None:
                obs_metrics.histogram("serve.queue_us").record(
                    t_start - r.t_enqueue_us)
        obs_metrics.histogram("serve.batch_occupancy").record(
            b / self.batch_size)
        prompt_len = max(len(r.prompt) for r in requests)
        with obs_trace.span("serve.batch", batch=b,
                            prompt_len=prompt_len) as bsp:
            toks = np.zeros((b, prompt_len), np.int64)
            for i, r in enumerate(requests):
                toks[i, prompt_len - len(r.prompt):] = r.prompt  # left-pad
            cache = init_cache(self.cfg, b, self.max_len,
                               dtype=torch.float32, device=self.device)
            with obs_trace.span("serve.prefill", batch=b,
                                prompt_len=prompt_len) as psp:
                logits, cache = self.prefill(
                    self.params,
                    {"tokens": torch.as_tensor(toks, device=self.device)},
                    cache)
                next_tok = self._sample(logits)
                host_tok = next_tok.cpu().numpy()
            obs_metrics.histogram("serve.prefill_us").record(psp.dur_us)
            max_new = max(r.max_new_tokens for r in requests)
            outs = [[] for _ in range(b)]
            done = np.zeros(b, bool)
            steps = 0
            with obs_trace.span("serve.decode", batch=b) as dsp:
                for _ in range(max_new):
                    for i, r in enumerate(requests):
                        if not done[i]:
                            tok = int(host_tok[i])
                            outs[i].append(tok)
                            if (r.eos_id is not None and tok == r.eos_id
                                    ) or len(outs[i]) >= r.max_new_tokens:
                                done[i] = True
                                obs_metrics.histogram(
                                    "serve.request_us").record(
                                    obs_trace.clock_us() - (
                                        r.t_enqueue_us
                                        if r.t_enqueue_us is not None
                                        else t_start))
                    if done.all():
                        break
                    t_step = obs_trace.clock_us()
                    logits, cache = self.decode(self.params,
                                                next_tok[:, None], cache)
                    next_tok = self._sample(logits)
                    host_tok = next_tok.cpu().numpy()
                    obs_metrics.histogram("serve.decode_us").record(
                        obs_trace.clock_us() - t_step)
                    steps += 1
                dsp.add(steps=steps)
            bsp.add(tokens=int(sum(len(o) for o in outs)))
        for i, r in enumerate(requests):
            r.output = np.asarray(outs[i], np.int32)
        return requests

    def serve(self, requests: list) -> list:
        """Serve an arbitrary number of requests in batched groups."""
        now = obs_trace.clock_us()
        for r in requests:
            if r.t_enqueue_us is None:
                r.t_enqueue_us = now
        out = []
        for i in range(0, len(requests), self.batch_size):
            group = requests[i:i + self.batch_size]
            obs_trace.event("serve.refill", group=i // self.batch_size,
                            size=len(group))
            out.extend(self.run_batch(group))
        return out
