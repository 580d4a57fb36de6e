"""What decides ``correct``: the sampled groups, followed layer by layer by
the plain reference (``bench/reference``) once the window has closed.

Why layer by layer: the model takes one activation LSB per matmul from
the abs-max of the whole batch.  A readout that the kernel and the
reference round apart at a tie (they sum a chunk's products in another
order) can move that abs-max, and then every code of the matmul moves;
over 32-40 layers the free-running logits of two sound implementations
part by about 0.4 of their largest magnitude (measured on the card, see
PERF.md), as far as a lower precision does.  So the window keeps the
residual stream entering every layer and leaving the last
(``harness/capture.py``) and the logits each step returns, and the
reference computes each stage from the program's own input to it:

- the embedding from the step's tokens, each layer from the stream that
  entered it (keeping its own KV cache, written from the program's
  streams), the final norm and lm_head from the stream that left the last
  layer.

The numbers, each against its limit (``bench/limits/<cell>.json``):

- ``embed_diff``: the largest share of a step's embedded tokens that
  differ from the reference's lookup (an exact comparison: limit 0);
- ``prefill_stage_diff``: per checked group, the median over layers of
  the share of a layer's output elements in the prefill step that differ
  from the reference's; the largest over the groups.  The prefill runs
  the split tile at M of thousands of rows and the prefill attention,
  which no decode step runs: a fault there leaves the decode steps as
  they were (the reference writes its cache from the program's streams),
  so the prefill is held by a number of its own;
- ``decode_stage_diff``: the median of the same share over every layer of
  every checked decode step;
- ``head_diff``: the largest share of a captured logits row's elements
  that differ from the reference's lm_head on the same stream;
- ``token_diff``: the share of served tokens that are not the argmax of the logits their step returned (the sampling,
  checked by itself: an exact comparison);
- ``tokens_off``: the share of served tokens whose logit in the
  reference's lm_head output lies below the best of that output (the
  widest such gap, ``gap``, is reported beside it: at bfloat16 logits it
  is one or two units of the last place for sound runs and for the TF32
  control alike, so it separates nothing and is not compared).  A cell
  compares it only where it serves enough tokens that the control moves
  it.

The sample: group 0 (which holds the longest prompt of the run) and
``check_groups - 1`` more drawn from the seed among the first
``among_first`` groups, leaving out the groups a traced run may profile
(the traffic's ``trace`` entry, whether or not this run traces), so
that the capture's copies never fall in the traced stretch; only groups
that the window finished are checked.

The capture reads the residual stream where the program hands it from
layer to layer (``models.transformer._group_apply``).  A step whose
capture does not hold one state per layer and one more stops the run
with an error naming that function: a change to its signature or call
site has to be met here.
"""
from __future__ import annotations

import statistics

import numpy as np
import torch

from harness import traffic as traffic_lib
from harness import weights
from reference.lm import Dims, ReferenceLM, fp32_products


def traced_groups(traffic: dict) -> range:
    """Every group that a traced run of the mix may profile (its first
    stretch and each stretch tried again)."""
    spec = traffic["trace"]
    first = int(spec["first"])
    return range(first, first + int(spec["count"]) * int(spec["tries"]))


def sample(limits: dict, seed: int, skip=()) -> list:
    """The indices of the groups to check, none of them in ``skip``."""
    rng = np.random.default_rng([seed % 2**63, 3])
    n, among = int(limits["check_groups"]), int(limits["among_first"])
    pool = np.array([i for i in range(1, among) if i not in skip])
    if len(pool) < n - 1 or 0 in skip:
        raise ValueError(f"{n} groups to check among the first {among}, "
                         f"{len(skip)} of them left out")
    return [0] + [int(i) for i in rng.permutation(pool)[:n - 1]]


def dims_of(arch) -> Dims:
    return Dims(n_layers=arch.n_layers, d_model=arch.d_model,
                n_heads=arch.n_heads, n_kv_heads=arch.n_kv_heads,
                d_ff=arch.d_ff, vocab=arch.vocab_size,
                rope_theta=arch.rope_theta, head_dim=arch.hd)


def differ(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of elements of ``a`` and ``b`` that are not equal."""
    return float((a != b).to(torch.float32).mean())


class Readings:
    """The worst readings over the checked groups."""

    def __init__(self):
        self.prefill = []        # per group: the median over its layers
        self.decode = []         # every layer of every decode step
        self.embed_diff = 0.0
        self.head_diff = 0.0
        self.token_diff = 0.0
        self.gap = 0.0
        self.off = 0
        self.tokens = 0
        self.groups = 0

    def token(self, gaps: torch.Tensor) -> None:
        """Count served positions by their gaps ``[B]``."""
        self.gap = max(self.gap, float(gaps.max()))
        self.off += int((gaps > 0).sum())
        self.tokens += gaps.numel()

    def summary(self) -> dict:
        return {"embed_diff": self.embed_diff,
                "prefill_stage_diff": max(self.prefill, default=0.0),
                "decode_stage_diff": statistics.median(self.decode or [0.0]),
                "head_diff": self.head_diff,
                "token_diff": self.token_diff,
                "tokens_off": self.off / max(self.tokens, 1),
                "gap": self.gap, "tokens": self.tokens, "groups": self.groups,
                "stages": {"prefill": [round(v, 6) for v in self.prefill],
                           "decode_n": len(self.decode),
                           "decode_max": max(self.decode, default=0.0)}}


def replay(ref, group, served, states, logits, max_len: int,
           device, sound: Readings, others=None) -> None:
    """Follow one group's captured steps with ``ref``; ``others`` maps
    the reference at another precision to its readings, each of whose
    stages and lm_head are read against ``ref``'s on the same program
    streams (the reference put in the program's place)."""
    others = others or {}
    toks = torch.as_tensor(traffic_lib.padded(group), device=device)
    srv = torch.as_tensor(served, device=device)
    b = toks.shape[0]
    caches = ref.new_cache(b, max_len, device)
    side = {low: low.new_cache(b, max_len, device) for low in others}
    for r in (sound, *others.values()):
        r.groups += 1
    n_layers = len(ref.layers)
    if len(states) != len(logits) or any(len(xs) != n_layers + 1
                                         for xs in states):
        raise RuntimeError(
            f"the capture holds {[len(xs) for xs in states]} layer states "
            f"for {len(logits)} steps, not {n_layers + 1} a step: "
            "models.transformer._group_apply no longer hands the residual "
            "stream from layer to layer as harness/capture.py reads it")
    start = 0
    for t, xs in enumerate(states):
        inputs = toks if t == 0 else srv[:, t - 1:t]
        sound.embed_diff = max(sound.embed_diff,
                               differ(ref.embed(inputs), xs[0].to(device)))
        step = {r: [] for r in (sound, *others.values())}
        for i in range(n_layers):
            x = xs[i].to(device)
            y = ref.layer(i, x, caches[i], start)
            for low, r in others.items():
                step[r].append(differ(low.layer(i, x, side[low][i], start),
                                      y))
            step[sound].append(differ(y, xs[i + 1].to(device)))
        for r, shares in step.items():
            if t == 0:
                r.prefill.append(statistics.median(shares))
            else:
                r.decode.extend(shares)
        x = xs[-1].to(device)
        head = ref.head(x)
        lf = head.to(torch.float32)
        best = lf.amax(dim=-1)
        sound.token(best - lf.gather(1, srv[:, t:t + 1])[:, 0])
        got = logits[t].to(device)
        sound.head_diff = max(sound.head_diff, differ(got, head))
        sound.token_diff = max(sound.token_diff,
                               differ(got.argmax(dim=-1), srv[:, t]))
        for low, r in others.items():
            head_low = low.head(x)
            r.token(best - lf.gather(
                1, head_low.argmax(dim=-1, keepdim=True))[:, 0])
            r.head_diff = max(r.head_diff, differ(head_low, head))
        start += inputs.shape[1]


def check(arch, seed: int, groups: dict, max_len: int, device,
          others=()) -> dict:
    """Follow ``groups`` (index -> (requests, served [B, T], layer states
    per step, logits per step)) with the reference built
    from the run's weights drawn again.  Returns the program's readings
    under ``"sound"`` and, for each precision in ``others``, the readings
    of the reference at that precision put in the program's place."""
    params = weights.init_params(arch, seed, device)
    ref = ReferenceLM(params, dims_of(arch))
    del params
    out = {"sound": Readings()}
    lows = {ref.at(p): out.setdefault(p, Readings()) for p in others}
    with fp32_products(), torch.no_grad():
        for group, served, states, logits in groups.values():
            replay(ref, group, served, states, logits, max_len,
                   device, out["sound"], lows)
    return {k: r.summary() for k, r in out.items()}
