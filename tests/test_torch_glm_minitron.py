"""glm4-9b (2 KV heads, d_ff 13696 at full width) and minitron-4b (the
only squared-ReLU MLP, LayerNorm, a 256000-token vocabulary at full
width) in the port against the JAX package, on their SMOKE configs on the
CPU: ``lm_apply`` at ``analog_faithful`` and in digital mode, and one
train step of each.

``lm_apply``: both packages from the reference's ``lm_init`` draw
(carried across by ``convert.params_from_numpy``) at fp32 activations,
compiled through their front doors; logits within 1e-5 x max|logit| and
equal greedy tokens (the rank-1 fixed pattern's ``test_torch_lm.py``
tolerance is 1e-4; these two hold ten times tighter).

The train step is ``test_torch_family_train.py``'s :func:`check_step`
(fp32 tolerances: the loss within 1e-6 relative, every gradient leaf
within 1e-5 of its max, the global norm within 1e-5, the parameters
after AdamW at ``STATE_TOL``), at dynamic calibration.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

from test_torch_family_train import check_step  # noqa: E402

NAMES = ("glm4-9b", "minitron-4b")
MODES = ("digital", "analog_faithful")
REL = 1e-5


def _runs(mode):
    acfg = dict(mode=mode)
    if mode == "digital":
        return (JRunConfig(activation_dtype="float32"),
                RunConfig(activation_dtype="float32"))
    return (JRunConfig(analog=JAnalogConfig(**acfg),
                       activation_dtype="float32"),
            RunConfig(analog=AnalogConfig(**acfg),
                      activation_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _params(name):
    jp = JT.lm_init(jax.random.PRNGKey(0), jconfigs.get_smoke(name))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_smoke_configs_are_the_reference():
    for name in NAMES:
        cfg, jcfg = configs.get_smoke(name), jconfigs.get_smoke(name)
        assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == {
            f: getattr(jcfg, f) for f in cfg.__dataclass_fields__
            if f != "param_dtype"} | {"param_dtype": cfg.param_dtype}
    assert configs.get_smoke("minitron-4b").act == "relu2"
    assert configs.get_smoke("glm4-9b").n_kv_heads == 2


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_lm_apply_matches_the_reference(name, mode):
    jcfg, cfg = jconfigs.get_smoke(name), configs.get_smoke(name)
    jrun, run = _runs(mode)
    jp, tp = _params(name)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9))
    jm = japi.compile(JT.lm_module_spec(jcfg, jp), jp, jrun)
    tm = api.compile(T.lm_module_spec(cfg, tp), tp, run, device="cpu")
    jl, _, _ = JT.lm_apply(jm.lower(), {"tokens": jnp.asarray(tokens)},
                           jcfg, jrun)
    with torch.no_grad():
        tl, _, _ = T.lm_apply(tm.lower(),
                              {"tokens": torch.from_numpy(tokens)}, cfg, run)
    want, got = np.asarray(jl), tl.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_the_reference(name, mode):
    check_step(name, mode)
