"""One train step of the families fed precomputed embeddings - qwen2-vl
(M-RoPE on distinct (t, h, w) positions) and musicgen (LayerNorm, GELU) -
in the port against the JAX package, on their SMOKE configs on the CPU,
with ``embeds`` batches as the reference's ``tests/test_archs.py`` builds
them.  The step and its tolerances are ``test_torch_family_train.py``'s
:func:`check_step`: fp32 tolerances, except musicgen's dynamic-calibration
analog step, whose LayerNorm flips a 5-bit code at an ulp tie (row 8 of
the second sequence, carried to its later positions by attention): it is
held to the tie bounds, and its static-calibration step, which has no
tie, at fp32 tolerances.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_family_train import check_step  # noqa: E402


@pytest.mark.parametrize("mode", ["digital", "analog_faithful"])
@pytest.mark.parametrize("name", ["qwen2-vl-7b", "musicgen-medium"])
def test_train_step_matches_the_reference(name, mode):
    check_step(name, mode, ties=mode != "digital"
               and name == "musicgen-medium")


def test_musicgen_tie_free_step_matches_the_reference():
    """Static calibration on integer ``w_eff``: no code sits at a tie, so
    the analog step is held at fp32 tolerance."""
    check_step("musicgen-medium", "analog_faithful", act_calib="static")
