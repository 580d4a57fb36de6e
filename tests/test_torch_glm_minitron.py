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

``ServeEngine``: each package's engine on the same parameters, its own
``prefill`` of a [2, 7] prompt and 4 greedy ``decode`` steps: every
step's logits within 1e-5 x max|logit| and the same argmax, and
``serve`` of three requests giving the same tokens.

glm4-9b's block route (rmsnorm + swiglu: ``attach_block_plans`` holds)
at static calibration on integer effective weights (the reference's
NOISELESS draw): the block plans' int8 codes and packed tables equal
the reference's bit for bit, the 2 x 12 prefill's logits (one dispatch
per block and the lm_head) within 1e-5 x max|logit| of the reference's
block route (``analog_plan_pallas`` in interpret mode) with equal
argmax, and bit-identical to the port's own per-layer route.
minitron-4b (layernorm + squared ReLU) raises the reference's
``ValueError``.
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
from repro.core.noise import NOISELESS as JNOISELESS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.exec import run as trun  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

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


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_serve_engine_matches_the_reference(name, mode):
    jcfg, cfg = jconfigs.get_smoke(name), configs.get_smoke(name)
    jrun, run = _runs(mode)
    jp, tp = _params(name)
    jeng = JServeEngine(jcfg, jrun, jp, batch_size=2, max_len=16)
    eng = ServeEngine(cfg, run, tp, batch_size=2, max_len=16, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 7))
    jc = JT.init_lm_cache(jcfg, 2, 16, dtype=jnp.float32)
    tc = T.init_lm_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    jl, jc = jeng.prefill(jeng.params, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = eng.prefill(eng.params, {"tokens": torch.from_numpy(toks)},
                         tc)
    for step in range(5):
        want, got = np.asarray(jl), tl.numpy()
        assert got.shape == want.shape == (2, cfg.vocab_size)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=REL * np.abs(want).max(),
                                   err_msg=f"step {step}")
        nxt = want.argmax(-1)
        np.testing.assert_array_equal(got.argmax(-1), nxt)
        if step == 4:
            break
        jl, jc = jeng.decode(jeng.params, jnp.asarray(nxt[:, None]), jc)
        tl, tc = eng.decode(eng.params, torch.from_numpy(nxt[:, None]), tc)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(4, 9))
               for _ in range(3)]
    jout = jeng.serve([JRequest(uid=i, prompt=p, max_new_tokens=4)
                       for i, p in enumerate(prompts)])
    out = eng.serve([Request(uid=i, prompt=p, max_new_tokens=4)
                     for i, p in enumerate(prompts)])
    assert [r.output.tolist() for r in out] == \
        [r.output.tolist() for r in jout]


@functools.lru_cache(maxsize=None)
def _noiseless_params(name):
    saved = JT.NOISE
    JT.NOISE = JNOISELESS
    try:
        jp = JT.lm_init(jax.random.PRNGKey(1), jconfigs.get_smoke(name))
    finally:
        JT.NOISE = saved
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _static():
    return (JAnalogConfig(mode="analog_faithful", act_calib="static",
                          use_pallas=True),
            AnalogConfig(mode="analog_faithful", act_calib="static"))


def test_glm4_block_route_matches_the_reference():
    name, seq = "glm4-9b", 12
    jcfg, cfg = jconfigs.get_smoke(name), configs.get_smoke(name)
    jacfg, acfg = _static()
    jrun = JRunConfig(analog=jacfg, activation_dtype="float32")
    run = RunConfig(analog=acfg, activation_dtype="float32")
    jp, tp = _noiseless_params(name)
    jb = JT.attach_block_plans(jp, jcfg, jacfg, seq=seq)
    tree = api.lower_tree(tp, run)
    tb = T.attach_block_plans(tree, cfg, acfg, seq=seq)
    jstack, stack = jb["layers"]["l0"]["_block_plan"], \
        tb["layers"]["l0"]["_block_plan"]
    assert len(stack) == cfg.n_layers
    assert stack[0].block.n_heads // stack[0].block.n_kv_heads == 4
    for i, bp in enumerate(stack):
        for li, (lp, jlp) in enumerate(zip(bp.layers, jstack.layers)):
            for f in ("codes", "col_gain", "row_gain", "w_scale"):
                a, b = getattr(lp.store, f), getattr(jlp.store, f)
                if a is None or b is None:
                    assert a is None and b is None, (i, li, f)
                    continue
                b = np.asarray(b)[i]
                np.testing.assert_array_equal(
                    a.numpy().astype(np.float32), b.astype(np.float32),
                    err_msg=f"block {i} layer {li} {f}")
        np.testing.assert_array_equal(bp.mega.off.numpy(),
                                      np.asarray(jstack.mega.off)[i])
        np.testing.assert_array_equal(bp.mega.gain.numpy(),
                                      np.asarray(jstack.mega.gain)[i])
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, seq))
    want = np.asarray(JT.lm_apply(jb, {"tokens": jnp.asarray(toks)}, jcfg,
                                  jrun)[0])
    trun.reset_dispatch_count()
    with torch.no_grad():
        got = T.lm_apply(tb, {"tokens": torch.from_numpy(toks)}, cfg, run)[0]
        assert trun.dispatch_count() == cfg.n_layers + 1
        per_layer = T.lm_apply(tree, {"tokens": torch.from_numpy(toks)},
                               cfg, run)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=REL * np.abs(want).max())
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    assert torch.equal(got, per_layer)


def test_minitron_block_plans_raise_the_reference_error():
    jcfg, cfg = (jconfigs.get_smoke("minitron-4b"),
                 configs.get_smoke("minitron-4b"))
    jacfg, acfg = _static()
    jp, tp = _params("minitron-4b")
    with pytest.raises(ValueError) as jerr:
        JT.attach_block_plans(jp, jcfg, jacfg, seq=12)
    with pytest.raises(ValueError) as err:
        T.attach_block_plans(tp, cfg, acfg, seq=12)
    assert str(err.value) == str(jerr.value)
    assert "act='relu2'" in str(err.value)
