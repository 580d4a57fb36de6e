"""A copy of ``repro.data.lm_data`` (numpy only; the port imports nothing of
the JAX package, and the tokens must be the reference's bit for bit).

Deterministic, shardable, resumable synthetic token pipeline for the LM
architectures (training-loop substrate; real deployments swap in a tokenized
corpus reader with the same interface).

Properties required at scale and tested:
- sharding by (host, data-parallel rank) without overlap,
- O(1) resume from a step counter (stateless indexing - the checkpoint
  stores only ``step``),
- per-example determinism in (seed, global_index).

The synthetic stream is a mixture of Zipf-distributed unigrams and
deterministic n-gram motifs so that models can actually reduce loss on it
(used by the convergence integration test and the end-to-end example).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 8
    n_motifs: int = 64


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = max(cfg.vocab_size - 2, 2)
        # precompute motif table (deterministic "grammar")
        self.motifs = rng.integers(
            0, v, size=(cfg.n_motifs, cfg.motif_len)
        ).astype(np.int32)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.p = (p / p.sum()).astype(np.float64)
        self.v = v

    def example(self, global_index: int) -> np.ndarray:
        """Deterministic example -> [seq_len + 1] tokens."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, global_index])
        )
        n = cfg.seq_len + 1
        toks = rng.choice(self.v, size=n, p=self.p).astype(np.int32)
        # plant motifs: predictable structure -> learnable signal
        i = 0
        while i < n - cfg.motif_len:
            if rng.random() < 0.25:
                m = self.motifs[rng.integers(0, cfg.n_motifs)]
                toks[i : i + cfg.motif_len] = m
                i += cfg.motif_len
            else:
                i += rng.integers(1, cfg.motif_len)
        return toks

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """Batch for ``step`` on data shard ``shard``: stateless indexing."""
        cfg = self.cfg
        per_shard = cfg.global_batch // n_shards
        base = step * cfg.global_batch + shard * per_shard
        toks = np.stack([self.example(base + i) for i in range(per_shard)])
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
