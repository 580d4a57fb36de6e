"""The MoE, vision (M-RoPE) and audio LM families of the port against
the JAX package's, on their SMOKE configs (2 layers, d_model 64-128):
qwen3-moe-30b-a3b (8 experts, top-2, an MoE layer in every group),
llama4-maverick-400b-a17b (4 experts, top-1, a shared expert, [dense,
MoE] groups), qwen2-vl-7b (M-RoPE, precomputed embeddings) and
musicgen-medium (layernorm, gelu, precomputed embeddings).

Both packages compute with the reference's ``lm_init`` draw (carried
across by ``convert.params_from_numpy``) at fp32 activations, compiled
through their front doors (the port lowers the scan-stacked expert
stacks once; the reference derives them per call: the same values).
Tolerances, those of ``test_torch_lm.py``'s rank-1 fixed pattern:

- logits (``lm_apply``, and every prefill / decode step of
  ``make_serve_steps`` with a cache): within 1e-4 * max|logit|, equal
  greedy tokens.
- ``lm_loss``: nll within 1e-5 relative; the MoE aux loss within 1e-6
  relative (the router's softmax and the mean over tokens round in
  another order in the two frameworks).
- ``apply_mrope`` alone: within 1e-6 (fp32 transcendentals).
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
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.serve_step import make_serve_steps as jmake_serve_steps  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.serve_step import make_serve_steps  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

FAMILIES = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b", "qwen2-vl-7b",
            "musicgen-medium")
B, S = 2, 7
REL = 1e-4


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _runs(mode="analog_faithful"):
    return (JRunConfig(analog=JAnalogConfig(mode=mode),
                       activation_dtype="float32"),
            RunConfig(analog=AnalogConfig(mode=mode),
                      activation_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _setup(name):
    """Configs, the reference's draw and the port's copy, both compiled."""
    jcfg, cfg = jconfigs.get_smoke(name), configs.get_smoke(name)
    jp = JT.lm_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jrun, run = _runs()
    jm = japi.compile(JT.lm_module_spec(jcfg, jp), jp, jrun)
    tm = api.compile(T.lm_module_spec(cfg, tp), tp, run, device="cpu")
    return jcfg, cfg, jp, tp, jm, tm


def _batch(cfg, seed, s=S):
    """Tokens, or precomputed embeddings (embed_inputs=False); distinct
    (t, h, w) positions under M-RoPE."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, s))}
    else:
        b = {"embeds": rng.standard_normal((B, s, cfg.d_model))
             .astype(np.float32)}
    if cfg.mrope:
        b["positions"] = rng.integers(0, 3 * s, (B, s, 3)).astype(np.int32)
    return b


def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("name", FAMILIES)
def test_configs_run_in_the_port(name):
    cfg = configs.get_arch(name)
    assert cfg == configs.get_smoke(name).__class__(
        **{f: getattr(jconfigs.get_arch(name), f)
           for f in cfg.__dataclass_fields__})
    assert T.n_groups(cfg) * len(T.group_def(cfg)) == cfg.n_layers


@pytest.mark.parametrize("name", FAMILIES)
def test_lm_apply_logits_and_aux(name):
    jcfg, cfg, _, _, jm, tm = _setup(name)
    jrun, run = _runs()
    jb, tb = _both(_batch(cfg, 1))
    jl, _, jaux = JT.lm_apply(jm.lower(), jb, jcfg, jrun)
    tl, _, aux = T.lm_apply(tm.lower(), tb, cfg, run)
    _close(tl, jl)
    np.testing.assert_array_equal(_np(tl).argmax(-1), _np(jl).argmax(-1))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if cfg.n_experts:
        assert float(aux) > 0


@pytest.mark.parametrize("name", FAMILIES)
def test_lm_loss(name):
    jcfg, cfg, jp, tp, _, _ = _setup(name)
    jrun, run = _runs()
    b = _batch(cfg, 2)
    b["labels"] = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                    (B, S))
    jb, tb = _both(b)
    jloss, jmet = JT.lm_loss(jp, jb, jcfg, jrun)
    with torch.no_grad():
        loss, met = T.lm_loss(tp, tb, cfg, run)
    np.testing.assert_allclose(float(met["nll"]), float(jmet["nll"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_steps_with_a_cache(name):
    """A [2, 7] prefill and three decode steps through both packages'
    ``make_serve_steps`` (greedy tokens fed back, or the next embedding
    frames), on the compiled trees."""
    jcfg, cfg, _, _, jm, tm = _setup(name)
    jrun, run = _runs()
    jpre, jdec = jmake_serve_steps(jcfg, jrun)
    tpre, tdec = make_serve_steps(cfg, run)
    jc = JT.init_lm_cache(jcfg, B, 16, dtype=jnp.float32)
    tc = T.init_lm_cache(cfg, B, 16, dtype=torch.float32, device="cpu")
    b = _batch(cfg, 4)
    if cfg.mrope:
        del b["positions"]      # the steps broadcast the cache positions
    jb, tb = _both(b)
    jl, jc = jpre(jm.lower(), jb, jc)
    tl, tc = tpre(tm.lower(), tb, tc)
    _close(tl, jl)
    rng = np.random.default_rng(5)
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1)
        np.testing.assert_array_equal(_np(tl).argmax(-1), nxt)
        if cfg.embed_inputs:
            step = nxt[:, None]
        else:
            step = rng.standard_normal((B, 1, cfg.d_model)).astype(
                np.float32)
        jl, jc = jdec(jm.lower(), jnp.asarray(step), jc)
        tl, tc = tdec(tm.lower(), torch.from_numpy(step), tc)
        _close(tl, jl)
    assert tc["step"] == int(jc["step"]) == S + 3


def test_apply_mrope():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 3, 128)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 5, 3)).astype(np.int32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # equal positions on the three axes are plain RoPE
    same = np.repeat(pos[..., :1], 3, axis=-1)
    np.testing.assert_allclose(
        _np(L.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), 1e6)),
        _np(L.apply_rope(torch.from_numpy(x), torch.from_numpy(same[..., 0]),
                         1e6)), rtol=1e-6, atol=1e-6)


def test_moe_and_mrope_train_and_embeds_refuse_token_serving():
    """qwen3-moe and qwen2-vl train through ``make_train_step`` (one
    step: finite loss and parameters; the steps against the reference's:
    ``test_torch_family_train*.py``); ``ServeEngine`` still refuses a
    config fed precomputed embeddings (``make_serve_steps`` serves it)."""
    from repro_torch.train import train_step as TS

    for name in ("qwen3-moe-30b-a3b", "qwen2-vl-7b"):
        cfg, run = configs.get_smoke(name), _runs()[1]
        state = TS.init_state(torch.Generator().manual_seed(0), cfg, run,
                              device="cpu")
        b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 5).items()}
        b["labels"] = torch.from_numpy(np.random.default_rng(6).integers(
            0, cfg.vocab_size, (B, S)))
        state, metrics = make_train_step(cfg, run)(state, b)
        assert bool(torch.isfinite(metrics["loss"]))
        assert int(state["opt"]["step"]) == 1
        assert all(bool(torch.isfinite(p).all())
                   for p in TS.O.tree_leaves(state["params"]))
    _, cfg, _, tp, _, _ = _setup("musicgen-medium")
    with pytest.raises(ValueError, match="make_serve_steps"):
        ServeEngine(cfg, _runs()[1], tp, device="cpu")
