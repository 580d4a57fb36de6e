"""``correct`` decided by the check, on the CPU at SMOKE sizes: a sound
run of each cell is correct, and a run whose timed path is broken
underneath is not - once for each fault a serving cell can have (a step
that returns its state unchanged; half of the batch left out, the mean
taken over the rest; a token altered where it is produced; one card, so
no exchange between cards to leave out), and once for a fault that only
the prefill runs into (a wrong MLP ``down`` at the prefill's rows, which
leaves the decode steps, the lm_head and the tokens' argmax as they
are).  The TF32 control fails each cell's limits too."""
import pathlib
import sys
import time

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from harness import cell as cell_lib  # noqa: E402
from harness import control, manifest, result  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.serve import engine as engine_lib  # noqa: E402

CELLS = [w["name"] for w in manifest.load_manifest(ROOT)["workloads"]]
SEED = 2**31 + 4242


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return list(tree) if isinstance(tree, list) else tree


def _steps_with(fault):
    real = engine_lib.make_serve_steps

    def make(cfg, run, **kw):
        prefill, decode = real(cfg, run, **kw)
        if fault == "state_unchanged":
            def decode_stale(params, tok, cache):
                logits, _ = decode(params, tok, _copy(cache))
                return logits, cache
            return prefill, decode_stale

        def halve(step):
            def run_half(params, batch, cache):
                logits, cache = step(params, batch, cache)
                h = logits.shape[0] // 2
                logits = logits.clone()
                logits[h:] = logits[:h].mean(dim=0)
                return logits, cache
            return run_half
        return halve(prefill), halve(decode)
    return make


def _altered_sample(real):
    def sample(self, logits):
        tok = real(self, logits).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    return sample


def _prefill_down_off(real):
    """``mlp_apply`` whose ``down`` output is 1/16 too large where a row
    holds more than one position: the prefill, never a decode step."""
    def mlp(params, x, acfg, **kw):
        y = real(params, x, acfg, **kw)
        return y * 1.0625 if x.dim() == 3 and x.shape[1] > 1 else y
    return mlp


def _run(name):
    cell = manifest.load_cell(name, ROOT)
    arch = configs.get_smoke(cell.config["arch"])
    out = cell_lib.run(cell, SEED, 0.01, False, device="cpu",
                       t_start=time.monotonic(), arch=arch)
    line, _ = result.assemble(cell, out, False, "cpu")
    return line


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    line = _run(name)
    assert line["correct"] and line["failed"] == 0
    assert all(c["value"] == 0.0 for c in line["check"].values())


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_path_is_not_correct(name, fault, monkeypatch):
    if fault == "token_altered":
        monkeypatch.setattr(engine_lib.ServeEngine, "_sample",
                            _altered_sample(engine_lib.ServeEngine._sample))
    else:
        monkeypatch.setattr(engine_lib, "make_serve_steps",
                            _steps_with(fault))
    line = _run(name)
    assert not line["correct"]
    assert any(c["value"] > c["limit"] for c in line["check"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_fails_the_limits(name):
    cell = manifest.load_cell(name, ROOT)
    got = control.readings(cell, SEED, "cpu",
                           arch=configs.get_smoke(cell.config["arch"]))
    limits = cell.limits["limits"]
    assert all(got["sound"][k] <= v for k, v in limits.items())
    assert any(got["control"][k] > v for k, v in limits.items())


@pytest.mark.parametrize("name", CELLS)
def test_a_prefill_only_fault_is_not_correct(name, monkeypatch):
    monkeypatch.setattr(layers, "mlp_apply",
                        _prefill_down_off(layers.mlp_apply))
    line = _run(name)
    assert not line["correct"]
    check = line["check"]
    assert check["prefill_stage_diff"]["value"] > check[
        "prefill_stage_diff"]["limit"]
    assert all(c["value"] <= c["limit"] for k, c in check.items()
               if k != "prefill_stage_diff")
