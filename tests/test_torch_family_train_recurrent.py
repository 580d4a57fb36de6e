"""Hardware-in-the-loop training of RWKV-6 and the Zamba2 hybrid in the
port against the JAX package, on their SMOKE configs on the CPU: one
train step per mode against the reference's (``test_torch_family_train.
py``'s :func:`check_step`), remat replaying the readout noise into every
analog layer (the r/k/v/g group's members in member order, Zamba2's
shared attention block at each group's entry), and ``train_loop``.

Tolerances (:func:`check_step`'s, and):

- rwkv6-7b's gradients within 2e-4 of each leaf's max |grad|: the LoRA
  decay's tanh / exp and the group norm round differently in the two
  frameworks (the blocks' outputs agree within 1e-4, ``test_torch_rwkv.
  py``), and the gradients carry that; measured 7.2e-5 in digital mode.
- rwkv6-7b's dynamic-calibration analog step: the tie bounds, as the
  RWKV LMs' analog logits are held at TIE_REL (its LayerNorm puts a
  5-bit code on an ulp tie); its static-calibration step on integer
  ``w_eff`` has no tie and is held at the rest of the bounds.
- zamba2-2.7b: fp32 tolerances in every mode.
- the noisy step with and without remat, in the port: bit-identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_family_train import (_batch, _np, _pairs, _params_np,  # noqa: E402
                                     check_step)

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.noise import NoiseConfig  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

RWKV_GRAD_REL = 2e-4


@pytest.mark.parametrize("mode,act_calib", [
    ("digital", "dynamic"), ("analog_faithful", "dynamic"),
    ("analog_faithful", "static")])
def test_rwkv_step_matches_the_reference(mode, act_calib):
    check_step("rwkv6-7b", mode, act_calib=act_calib,
               grad_rel=RWKV_GRAD_REL,
               ties=mode != "digital" and act_calib == "dynamic")


@pytest.mark.parametrize("mode,act_calib", [
    ("digital", "dynamic"), ("analog_faithful", "dynamic"),
    ("analog_faithful", "static")])
def test_zamba2_step_matches_the_reference(mode, act_calib):
    """The Mamba-2 layers (softplus's gradient at 0 included), the SSD
    scan, and the shared attention block's gradient summed over the
    groups through remat."""
    check_step("zamba2-2.7b", mode, act_calib=act_calib)


@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-2.7b"])
def test_remat_replays_the_noise_into_every_layer(name):
    """A noisy step (two-pass split, readout noise from one
    ``torch.Generator``) with ``cfg.remat`` on and off: the recompute
    replays every analog layer's draws - the r/k/v/g members one after
    another, the shared block at each group's entry - so the loss and
    every gradient are bit-identical, and the generator ends where the
    first forward left it."""
    cfg = configs.get_smoke(name)
    run = RunConfig(analog=AnalogConfig(
        mode="analog_faithful", deterministic=False,
        noise=NoiseConfig(gain_std=0.0, offset_std=0.0, readout_std=0.7,
                          mode="rank1")), activation_dtype="float32")
    _, tb = _batch(cfg)
    params = params_from_numpy(_params_np(name), "cpu")
    out = {}
    for remat in (True, False):
        gen = torch.Generator().manual_seed(5)
        loss, _, grads = TS.loss_and_grads(
            params, tb, gen, cfg=dataclasses.replace(cfg, remat=remat),
            run=run)
        out[remat] = (loss, grads, gen.get_state())
    assert float(out[True][0]) == float(out[False][0])
    for path, a, b in _pairs(out[True][1], out[False][1]):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)
    assert torch.equal(out[True][2], out[False][2])
    # the noise reaches the loss: a second generator seed moves it
    other = TS.loss_and_grads(params, tb, torch.Generator().manual_seed(6),
                              cfg=cfg, run=run)[0]
    assert float(other) != float(out[True][0])


@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-2.7b",
                                  "qwen3-moe-30b-a3b"])
def test_train_loop_runs(name):
    """``launch.train.train_loop`` on the SMOKE config, analog faithful:
    three steps with finite losses and parameters."""
    out = tlaunch.train_loop(name, steps=3, batch=2, seq_len=16,
                             mode="analog_faithful", log_every=0,
                             device="cpu")
    assert len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))
    for path, p, _ in _pairs(out["state"]["params"],
                             out["state"]["params"]):
        assert bool(torch.isfinite(p).all()), path
    assert int(out["state"]["opt"]["step"]) == 3
