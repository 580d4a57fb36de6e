"""Mamba-2 and the Zamba2 hybrid in the port against the JAX package, on
the CPU: the causal conv, the SSD recurrence, ``mamba_apply`` with and
without a cache, and the zamba2-2.7b SMOKE LM (Mamba layers behind a
shared attention block, one KV cache per group) through ``lm_apply``,
``lm_loss``, ``make_serve_steps`` and ``ServeEngine``.

Parameters come from the reference's draw (``convert.params_from_numpy``);
activations are fp32.  Tolerances:

- ``_causal_conv``: within 1e-6 x max|out| (SiLU rounds differently);
  its carry exact.  ``ssd_scan``: within 1e-5 x max|out|.
- ``mamba_apply`` against the reference: within 1e-4 x max|out|.
- LMs against the reference: digital mode within 1e-4 x max|logit|; in
  analog mode within TIE_REL x max|logit| (0.1) with equal greedy tokens
  (an ulp of the RMSNorm between XLA and PyTorch can flip a 5-bit code at
  a rounding tie; ``test_torch_rwkv.py`` says more), ``lm_loss`` within
  1e-3 relative (1e-5 in digital mode).
- a prefill then decode steps against the whole sequence, in the port:
  exact at static calibration, within 1e-5 x max in digital mode (the
  digital projections are matmuls whose sum order depends on the row
  count).
"""
import dataclasses
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
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.serve_step import make_serve_steps as jmake_serve_steps  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.exec.run import dispatch_count, reset_dispatch_count  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.serve_step import make_serve_steps  # noqa: E402

ARCH = "zamba2-2.7b"
D, D_STATE = 64, 16
B, S_LEN = 2, 6
REL = 1e-4
TIE_REL = 0.1


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ------------------------------------------------------------- recurrence
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    c = 24
    x, w, b = _x(1, (B, S_LEN, c)), _x(2, (S.CONV_K, c), 0.2), _x(3, (c,))
    st = _x(4, (B, S.CONV_K - 1, c)) if with_state else None
    jy, js = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             None if st is None else jnp.asarray(st))
    ty, ts = S._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b),
                            None if st is None else torch.from_numpy(st))
    _close(ty, jy, 1e-6)
    np.testing.assert_array_equal(_np(ts), np.asarray(js))


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan(with_state):
    h, p, n = 4, 16, D_STATE
    xh = _x(5, (B, S_LEN, h, p))
    dt = np.abs(_x(6, (B, S_LEN, h)))
    a = np.exp(-dt).astype(np.float32)
    bb, cc = _x(7, (B, S_LEN, n)), _x(8, (B, S_LEN, n))
    s0 = _x(9, (B, h, p, n)) if with_state else np.zeros((B, h, p, n),
                                                          np.float32)
    jy, js = JS.ssd_scan(*(jnp.asarray(v) for v in (xh, dt, a, bb, cc, s0)))
    ty, ts = S.ssd_scan(*(torch.from_numpy(v) for v in (xh, dt, a, bb, cc,
                                                          s0)))
    _close(ty, jy, 1e-5)
    _close(ts, js, 1e-5)


def test_softplus():
    x = np.linspace(-30, 30, 1001).astype(np.float32)
    np.testing.assert_allclose(_np(S._softplus(torch.from_numpy(x))),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ block
@functools.lru_cache(maxsize=None)
def _block():
    jp = JS.mamba_init(jax.random.PRNGKey(3), D, d_state=D_STATE)
    np_p = jax.tree.map(np.asarray, jp)
    return jp, params_from_numpy(np_p, "cpu")


def test_mamba_params_carry_across():
    jp, tp = _block()
    ours = S.mamba_init(torch.Generator().manual_seed(0), D, d_state=D_STATE,
                        device="cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, jp)) == \
        jax.tree.structure(jax.tree.map(_np, ours))
    for k in ("A_log", "dt_bias", "D", "conv_b"):
        np.testing.assert_array_equal(_np(ours[k]), _np(tp[k]))
    assert tuple(ours["in_proj"]["w"].shape) == (D, 2 * D + 2 * D + 2 *
                                                 D_STATE + 2 * D // 64)


@pytest.mark.parametrize("mode", ["digital", "analog_faithful"])
def test_mamba_apply_with_and_without_cache(mode):
    jp, tp = _block()
    jacfg, acfg = JAnalogConfig(mode=mode), AnalogConfig(mode=mode)
    x = _x(10, (B, S_LEN, D))
    jy, jc = JS.mamba_apply(jp, jnp.asarray(x), acfg=jacfg, d_state=D_STATE)
    ty, tc = S.mamba_apply(tp, torch.from_numpy(x), acfg=acfg,
                           d_state=D_STATE)
    _close(ty, jy)
    _close(tc["conv"], jc["conv"])
    _close(tc["state"], jc["state"])
    x2 = _x(11, (B, 1, D))
    jy2, _ = JS.mamba_apply(jp, jnp.asarray(x2), acfg=jacfg, d_state=D_STATE,
                            cache=jc)
    ty2, _ = S.mamba_apply(tp, torch.from_numpy(x2), acfg=acfg,
                           d_state=D_STATE, cache=tc)
    _close(ty2, jy2)


def test_mamba_prefill_then_decode_equals_the_whole_sequence():
    _, tp = _block()
    acfg = AnalogConfig(act_calib="static")
    x = torch.from_numpy(_x(12, (B, S_LEN, D)))
    whole, _ = S.mamba_apply(tp, x, acfg=acfg, d_state=D_STATE)
    parts, cache = [], None
    for sl in (slice(0, 4), slice(4, 5), slice(5, 6)):
        y, cache = S.mamba_apply(tp, x[:, sl], acfg=acfg, d_state=D_STATE,
                                 cache=cache)
        parts.append(y)
    np.testing.assert_array_equal(_np(torch.cat(parts, 1)), _np(whole))


# -------------------------------------------------------------------- LM
def _runs(mode="analog_faithful"):
    return (JRunConfig(analog=JAnalogConfig(mode=mode),
                       activation_dtype="float32"),
            RunConfig(analog=AnalogConfig(mode=mode),
                      activation_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _lm():
    jcfg, cfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    jp = JT.lm_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jrun, run = _runs()
    jm = japi.compile(JT.lm_module_spec(jcfg, jp), jp, jrun)
    tm = api.compile(T.lm_module_spec(cfg, tp), tp, run, device="cpu")
    return jcfg, cfg, jp, tp, jm, tm


def _tokens(cfg, seed, s=S_LEN):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s))


def test_configs_copy_the_reference():
    for get, jget in ((configs.get_arch, jconfigs.get_arch),
                      (configs.get_smoke, jconfigs.get_smoke)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(
            jget(ARCH))
    full = configs.get_arch(ARCH)
    assert (full.n_layers, full.d_model, full.ssm_state, full.attn_every,
            T.n_groups(full), full.vocab_size) == (54, 2560, 64, 6, 9, 32000)


def test_lm_tree_layout():
    """One unstacked shared attention block (its QKV one column_concat
    group), the Mamba projections scan-stacked; the cache holds one KV
    cache per group."""
    _, cfg, jp, tp, _, tm = _lm()
    assert set(tp) == set(jp) and "shared_attn" in tp
    assert tp["shared_attn"]["attn"]["wq"]["w"].ndim == 2
    assert "qkv" in tm.lower()["shared_attn"]["attn"]["_groups"]
    cache = T.init_lm_cache(cfg, B, 16, device="cpu")
    assert cache["layers"]["shared_attn"]["len"] == [0] * T.n_groups(cfg)
    assert tuple(cache["layers"]["l0"]["mamba"]["state"].shape) == (
        T.n_groups(cfg), B, 2 * cfg.d_model // 64, 64, cfg.ssm_state)


@pytest.mark.parametrize("mode", ["analog_faithful", "digital"])
def test_lm_apply_logits(mode):
    jcfg, cfg, jp, tp, jm, tm = _lm()
    jrun, run = _runs(mode)
    toks = _tokens(cfg, 1)
    if mode == "digital":
        jl, _, _ = JT.lm_apply(jp, {"tokens": jnp.asarray(toks)}, jcfg, jrun)
        tl, _, _ = T.lm_apply(tp, {"tokens": torch.from_numpy(toks)}, cfg,
                              run)
    else:
        jl, _, _ = JT.lm_apply(jm.lower(), {"tokens": jnp.asarray(toks)},
                               jcfg, jrun)
        reset_dispatch_count()
        tl, _, _ = T.lm_apply(tm.lower(), {"tokens": torch.from_numpy(toks)},
                              cfg, run)
        # in / out per Mamba layer, QKV + o per shared attention, lm_head
        assert dispatch_count() == 2 * cfg.n_layers + 2 * T.n_groups(cfg) + 1
    _close(tl, jl, REL if mode == "digital" else TIE_REL)
    np.testing.assert_array_equal(_np(tl).argmax(-1), np.asarray(jl).argmax(-1))


@pytest.mark.parametrize("mode", ["analog_faithful", "digital"])
def test_lm_loss(mode):
    jcfg, cfg, jp, tp, _, _ = _lm()
    jrun, run = _runs(mode)
    toks, labels = _tokens(cfg, 2), _tokens(cfg, 3)
    jloss, jmet = JT.lm_loss(jp, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)}, jcfg, jrun)
    with torch.no_grad():
        loss, met = T.lm_loss(tp, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)},
                              cfg, run)
    rtol = 1e-5 if mode == "digital" else 1e-3
    np.testing.assert_allclose(float(met["nll"]), float(jmet["nll"]),
                               rtol=rtol)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)


def test_serve_steps_with_a_cache():
    jcfg, cfg, _, _, jm, tm = _lm()
    jrun, run = _runs()
    jpre, jdec = jmake_serve_steps(jcfg, jrun)
    tpre, tdec = make_serve_steps(cfg, run)
    jc = JT.init_lm_cache(jcfg, B, 16, dtype=jnp.float32)
    tc = T.init_lm_cache(cfg, B, 16, dtype=torch.float32, device="cpu")
    toks = _tokens(cfg, 4)
    jl, jc = jpre(jm.lower(), {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = tpre(tm.lower(), {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl, TIE_REL)
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1)
        np.testing.assert_array_equal(_np(tl).argmax(-1), nxt)
        jl, jc = jdec(jm.lower(), jnp.asarray(nxt[:, None]), jc)
        tl, tc = tdec(tm.lower(), torch.from_numpy(nxt[:, None]), tc)
        _close(tl, jl, TIE_REL)
    assert tc["step"] == int(jc["step"]) == S_LEN + 3
    assert tc["layers"]["shared_attn"]["len"] == [S_LEN + 3] * T.n_groups(cfg)


@pytest.mark.parametrize("mode", ["analog_faithful", "digital"])
def test_prefill_then_decode_equals_the_whole_sequence_lm(mode):
    """The conv carries, SSM states and the shared attention's per-group
    KV caches reach the stacked cache (static calibration in analog
    mode)."""
    _, cfg, _, tp, _, _ = _lm()
    run = RunConfig(analog=AnalogConfig(mode=mode, act_calib="static"),
                    activation_dtype="float32")
    toks = torch.from_numpy(_tokens(cfg, 5))
    whole, _, _ = T.lm_apply(tp, {"tokens": toks}, cfg, run)
    cache = T.init_lm_cache(cfg, B, 16, dtype=torch.float32, device="cpu")
    parts = []
    for sl in (slice(0, 4), slice(4, 5), slice(5, 6)):
        lg, cache, _ = T.lm_apply(tp, {"tokens": toks[:, sl]}, cfg, run,
                                  cache=cache)
        parts.append(lg)
    got = _np(torch.cat(parts, 1))
    if mode == "digital":
        _close(got, whole, 1e-5)
    else:
        np.testing.assert_array_equal(got, _np(whole))


def test_serve_engine_tokens():
    jcfg, cfg, jp, tp, _, _ = _lm()
    jrun, run = _runs()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, rng.integers(4, 9))
               for _ in range(2)]
    jout = JServeEngine(jcfg, jrun, jp, batch_size=2, max_len=32).serve(
        [JRequest(uid=i, prompt=p, max_new_tokens=3)
         for i, p in enumerate(prompts)])
    eng = ServeEngine(cfg, run, tp, batch_size=2, max_len=32, device="cpu")
    reset_dispatch_count()
    out = eng.serve([Request(uid=i, prompt=p, max_new_tokens=3)
                     for i, p in enumerate(prompts)])
    assert dispatch_count() == 3 * (2 * cfg.n_layers + 2 * T.n_groups(cfg)
                                    + 1)
    for r, jr in zip(out, jout):
        assert r.output.tolist() == jr.output.tolist()


def test_training_step_runs():
    """``make_train_step`` on the SMOKE config (analog faithful, fp32
    activations): one step, finite loss and parameters (the step against the
    reference's: ``test_torch_family_train_recurrent.py``)."""
    from repro_torch.train import train_step as TS

    cfg, run = configs.get_smoke(ARCH), _runs()[1]
    state = TS.init_state(torch.Generator().manual_seed(0), cfg, run,
                          device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 9)))
    state, metrics = TS.make_train_step(cfg, run)(
        state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert bool(torch.isfinite(metrics["loss"])) and \
        float(metrics["loss"]) > 0
    assert int(state["opt"]["step"]) == 1
    assert all(bool(torch.isfinite(p).all())
               for p in jax.tree.leaves(state["params"]))
