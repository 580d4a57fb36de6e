"""The one traffic generator: a mix is a JSON file of parameters
(``bench/traffic/<name>.json``), read here.

Keys of a mix:

- ``batch``, ``max_len``: the engine's decode slots and cache positions;
- ``prompt_len``: ``{"dist": "log_uniform" | "uniform", "lo", "hi"}``,
  the prompt lengths in tokens;
- ``new_tokens``: tokens served per request (no EOS: every request runs
  to its length);
- ``block_groups``: groups per block. Every block holds the same
  ``block_groups * batch`` prompt lengths, the distribution's quantiles at
  ``(i + 0.5) / n``, cut into the same groups by a fixed layout
  (``layout_seed``), so every seed serves the same sizes;
- ``warmup``: ``{"new_tokens"}`` of the set-up's group, whose prompts
  all have the mix's longest length;
- ``trace``: ``{"first", "count", "tries"}``, the groups a traced run
  profiles (``harness/cell.py``).

Every block serves its groups in the same order, the group that holds
the longest prompt first, so that a window of a given length serves the
same sizes whatever the seed.  The run's seed orders the requests inside
each group and draws every token id uniformly over the vocabulary.
Group ``i`` is drawn on its own, so any number of groups comes out the
same for one seed.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    uid: int
    prompt: np.ndarray        # [S] int64 token ids
    new_tokens: int


def stratified_lengths(spec: dict, n: int) -> list:
    """The ``n`` quantiles ``(i + 0.5) / n`` of the prompt-length
    distribution, rounded to whole tokens."""
    lo, hi = float(spec["lo"]), float(spec["hi"])
    out = []
    for i in range(n):
        q = (i + 0.5) / n
        if spec["dist"] == "log_uniform":
            v = math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
        elif spec["dist"] == "uniform":
            v = lo + q * (hi - lo)
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
        out.append(int(round(v)))
    return out


class Traffic:
    """The groups of one mix for one seed, over a vocabulary of
    ``vocab`` ids."""

    def __init__(self, spec: dict, vocab: int, seed: int):
        self.spec, self.vocab, self.seed = spec, vocab, seed % 2**63
        self.batch = int(spec["batch"])
        self.max_len = int(spec["max_len"])
        self.new_tokens = int(spec["new_tokens"])
        g, b = int(spec["block_groups"]), self.batch
        lengths = stratified_lengths(spec["prompt_len"], g * b)
        order = np.random.default_rng(int(spec["layout_seed"])).permutation(
            g * b)
        layout = [sorted(lengths[j] for j in order[i * b:(i + 1) * b])
                  for i in range(g)]
        top = max(range(g), key=lambda i: max(layout[i]))
        self.layout = [layout[top]] + layout[:top] + layout[top + 1:]
        if max(lengths) + self.new_tokens > self.max_len:
            raise ValueError(f"prompts of up to {max(lengths)} tokens and "
                             f"{self.new_tokens} new ones overflow max_len "
                             f"{self.max_len}")

    def _rng(self, *key) -> np.random.Generator:
        return np.random.default_rng([self.seed, *key])

    def group(self, i: int) -> list:
        """Group ``i`` of the run: ``batch`` requests."""
        lens = self.layout[i % len(self.layout)]
        rng = self._rng(1, i)
        lens = [lens[k] for k in rng.permutation(len(lens))]
        return [Request(uid=i * self.batch + r,
                        prompt=rng.integers(0, self.vocab, n, dtype=np.int64),
                        new_tokens=self.new_tokens)
                for r, n in enumerate(lens)]

    def warmup_group(self) -> list:
        """The set-up's group: ``batch`` prompts of the mix's longest
        length (its largest prefill shape)."""
        longest = max(max(g) for g in self.layout)
        rng = self._rng(2)
        return [Request(uid=-1 - r, prompt=rng.integers(
                    0, self.vocab, longest, dtype=np.int64),
                    new_tokens=int(self.spec["warmup"]["new_tokens"]))
                for r in range(self.batch)]


def padded(group: list) -> np.ndarray:
    """The group's prompts left-padded with id 0 to the longest, as the
    engine batches them: ``[B, S]``."""
    s = max(len(r.prompt) for r in group)
    out = np.zeros((len(group), s), np.int64)
    for i, r in enumerate(group):
        out[i, s - len(r.prompt):] = r.prompt
    return out
