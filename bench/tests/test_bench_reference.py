"""The plain reference against the port on the CPU at the SMOKE sizes of
both configurations: the engine's prefill and decode logits, served from
the benchmark's weights, equal the reference's replay of the group bit
for bit; the TF32 control does not."""
import pathlib
import sys

import numpy as np
import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import check, weights  # noqa: E402
from harness.traffic import Request, padded  # noqa: E402
from reference.lm import ReferenceLM, to_tf32  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.serve import engine as engine_lib  # noqa: E402

SEED = 2**31 + 99


def _served(arch, group, max_len):
    params = weights.init_params(arch, SEED, "cpu")
    eng = engine_lib.ServeEngine(arch, RunConfig(analog=AnalogConfig(
        mode="analog_faithful")), params, batch_size=len(group),
        max_len=max_len, device="cpu")
    logits = []
    for kind in ("prefill", "decode"):
        step = getattr(eng, kind)

        def run(p, batch, cache, step=step):
            out, cache = step(p, batch, cache)
            logits.append(out.clone())
            return out, cache
        setattr(eng, kind, run)
    done = eng.run_batch([engine_lib.Request(uid=r.uid, prompt=r.prompt,
                                             max_new_tokens=r.new_tokens)
                          for r in group])
    return np.stack([r.output.astype(np.int64) for r in done]), logits


@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "glm4-9b"])
def test_reference_equals_the_port(name):
    arch = configs.get_smoke(name)
    rng = np.random.default_rng(5)
    group = [Request(uid=i, prompt=rng.integers(0, arch.vocab_size, n),
                     new_tokens=5) for i, n in enumerate((9, 30, 17, 24))]
    served, got = _served(arch, group, 48)
    ref = ReferenceLM(weights.init_params(arch, SEED, "cpu"),
                      check.dims_of(arch))
    toks, srv = torch.as_tensor(padded(group)), torch.as_tensor(served)
    want = list(ref.steps(toks, srv, 48))
    assert len(want) == len(got) == 5
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and torch.equal(g, w)
    low = list(ref.at("tf32").steps(toks, srv, 48))
    assert max(float((a.float() - b.float()).abs().max())
               for a, b in zip(low, want)) > 0.05


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0e-3])
    got = to_tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 + 2**-10
    assert got[2] == 1.0 + 2**-9
    assert abs(float(got[3]) + 3.0e-3) <= 3.0e-3 * 2**-11
    assert torch.equal(to_tf32(got), got)
