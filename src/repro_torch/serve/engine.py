"""Batched serving engine (port of ``repro.serve.engine``): request queue
-> left-padded prefill -> synchronous batched decode with per-sequence
stopping.  Requests are grouped into fixed decode slots of
``batch_size``.

Not ported yet (ROADMAP): measured calibration, the drift monitor, the
fleet hot-swap, the plan cache and the ``obs`` telemetry; passing any of
``calibration``, ``drift_monitor``, ``plan_cache`` or ``fleet`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.device import DeviceLike, resolve_device, to_device
from repro_torch.models import transformer as T
from repro_torch.serve.serve_step import make_serve_steps


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # [S] int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # filled by the engine:
    output: Optional[np.ndarray] = None


class ServeEngine:
    def __init__(self, cfg: ArchConfig, run: RunConfig, params,
                 batch_size: int = 8, max_len: int = 512,
                 greedy: bool = True, seed: int = 0, calibration=None,
                 drift_monitor=None, plan_cache: Optional[str] = None,
                 fleet=None, device: DeviceLike = None):
        hooks = dict(calibration=calibration, drift_monitor=drift_monitor,
                     plan_cache=plan_cache, fleet=fleet)
        given = [k for k, v in hooks.items() if v is not None]
        if given:
            raise NotImplementedError(
                f"ServeEngine({', '.join(given)}=...) is not ported yet "
                "(ROADMAP)")
        self.cfg, self.run = cfg, run
        self.device = resolve_device(device)
        # Serving is inference against frozen weights: compile the model
        # ONCE through the front door (quantized effective weights, chunk
        # padding, offsets, the fused QKV dispatch groups) on the device,
        # so every prefill/decode replays the baked plans.  LM plans are
        # split-encoded float layers: one fused-split dispatch per layer.
        self.model = None
        if run.analog.mode != "digital":
            self.model = api.compile(T.lm_module_spec(cfg, params), params,
                                     run, device=self.device)
            params = self.model.lower()
        else:
            params = to_device(params, self.device)
        self.params = params
        self.batch_size = batch_size
        self.max_len = max_len
        self.greedy = greedy
        self.prefill, self.decode = make_serve_steps(cfg, run)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.greedy:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def run_batch(self, requests: list) -> list:
        """Serve one group of <= batch_size requests to completion."""
        if len(requests) > self.batch_size:
            raise ValueError(f"{len(requests)} requests > batch_size "
                             f"{self.batch_size}")
        b = len(requests)
        prompt_len = max(len(r.prompt) for r in requests)
        toks = np.zeros((b, prompt_len), np.int64)
        for i, r in enumerate(requests):
            toks[i, prompt_len - len(r.prompt):] = r.prompt  # left-pad
        cache = T.init_lm_cache(self.cfg, b, self.max_len,
                                dtype=torch.float32, device=self.device)
        logits, cache = self.prefill(
            self.params, {"tokens": torch.as_tensor(toks, device=self.device)},
            cache)
        next_tok = self._sample(logits)
        max_new = max(r.max_new_tokens for r in requests)
        outs = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        for _ in range(max_new):
            host_tok = next_tok.cpu().numpy()
            for i, r in enumerate(requests):
                if not done[i]:
                    tok = int(host_tok[i])
                    outs[i].append(tok)
                    if (r.eos_id is not None and tok == r.eos_id
                            ) or len(outs[i]) >= r.max_new_tokens:
                        done[i] = True
            if done.all():
                break
            logits, cache = self.decode(self.params, next_tok[:, None],
                                        cache)
            next_tok = self._sample(logits)
        for i, r in enumerate(requests):
            r.output = np.asarray(outs[i], np.int32)
        return requests

    def serve(self, requests: list) -> list:
        """Serve an arbitrary number of requests in batched groups."""
        out = []
        for i in range(0, len(requests), self.batch_size):
            out.extend(self.run_batch(requests[i:i + self.batch_size]))
        return out
