"""The port's language-model serve path against the JAX package's, on
``phi4-mini-3.8b-smoke`` (2 layers, d_model 96, d_ff 192: every analog
layer spans 1-2 chunks of 128 rows).

Both packages compute with the same weights (the reference's
``lm_init`` draw, carried across by ``convert.params_from_numpy``) and
the same numpy inputs.  Parity is held at fp32 activations
(``activation_dtype="float32"``): dynamic calibration takes one abs-max
over the whole batch, so a one-ulp difference upstream of a quantizer
could flip an input code, and bf16 rounds at other places in the two
frameworks.  Tolerances:

- plans, norms, RoPE: plans bit-exact; norms and RoPE within 1e-6
  relative (fp32 reductions and transcendentals in another order).
- attention and ``lm_apply``: under ``NOISELESS`` the logits within
  1e-5 * max|logit|; with the default rank-1 fixed pattern, equal greedy
  tokens and logits within 1e-4 * max|logit| (the rank-1 effective weights
  are floats, so a dot may round differently at an ADC tie).  Measured
  here: below 4e-7 * max|logit| in both.
- ``ServeEngine.serve``: equal tokens.
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
from repro.core.noise import NOISELESS as JNOISELESS  # noqa: E402
from repro.exec.run import run_group as jrun_group  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.noise import NOISELESS  # noqa: E402
from repro_torch.exec import run as trun  # noqa: E402
from repro_torch.exec.plan import PlanStack  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ARCH = "phi4-mini-3.8b"
CFG = configs.get_smoke(ARCH)
JCFG = jconfigs.get_smoke(ARCH)


def _runs(noiseless: bool, mode="analog_faithful"):
    jnoise = JNOISELESS if noiseless else JAnalogConfig().noise
    noise = NOISELESS if noiseless else AnalogConfig().noise
    return (JRunConfig(analog=JAnalogConfig(mode=mode, noise=jnoise),
                       activation_dtype="float32"),
            RunConfig(analog=AnalogConfig(mode=mode, noise=noise),
                      activation_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _params(noiseless: bool):
    """The reference's draw (its module-level fixed-pattern default
    swapped for NOISELESS when asked) and the port's copy of it."""
    saved = JT.NOISE
    JT.NOISE = JNOISELESS if noiseless else saved
    try:
        jp = JT.lm_init(jax.random.PRNGKey(0), JCFG)
    finally:
        JT.NOISE = saved
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@functools.lru_cache(maxsize=None)
def _models(noiseless: bool):
    jp, tp = _params(noiseless)
    jrun, run = _runs(noiseless)
    jm = japi.compile(JT.lm_module_spec(JCFG, jp), jp, jrun)
    tm = api.compile(T.lm_module_spec(CFG, tp), tp, run, device="cpu")
    return jm, tm


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _assert_store(lp_t, lp_j, i=None):
    """A port LayerPlan against slice ``i`` of a reference LayerPlan."""
    pick = (lambda x: x) if i is None else (lambda x: x[i])
    assert (lp_t.k, lp_t.n, lp_t.chunk_rows, lp_t.signed_input) == (
        lp_j.k, lp_j.n, lp_j.chunk_rows, lp_j.signed_input)
    _eq(lp_t.store.codes, pick(lp_j.store.codes))
    _eq(lp_t.w_eff, pick(lp_j.store.w_eff))
    _eq(lp_t.w_scale, pick(lp_j.store.w_scale))
    _eq(torch.broadcast_to(lp_t.gain, (lp_t.n,)),
        np.broadcast_to(_np(pick(lp_j.store.gain)), (lp_j.n,)))
    _eq(lp_t.a_scale, pick(lp_j.a_scale))
    assert (lp_t.chunk_offset is None) == (lp_j.chunk_offset is None)
    if lp_t.chunk_offset is not None:
        _eq(lp_t.chunk_offset, pick(lp_j.chunk_offset))
    assert lp_t.store.col_blocks == lp_j.store.col_blocks


class TestConfigs:
    def test_dense_configs_copy_the_reference(self):
        for name in configs.ARCH_NAMES:
            for get, jget in ((configs.get_arch, jconfigs.get_arch),
                              (configs.get_smoke, jconfigs.get_smoke)):
                assert dataclasses.asdict(get(name)) == \
                    dataclasses.asdict(jget(name))
        full = configs.get_arch(ARCH)
        assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
                full.hd, full.d_ff, full.vocab_size) == (
            32, 3072, 24, 8, 128, 8192, 200064)
        assert full.dtype == torch.float32

    def test_other_families_are_not_ported(self):
        # since the RWKV and SSM-hybrid slice no family is left unported:
        # every name of the reference's registry resolves, to a copy
        unported = sorted(set(jconfigs.ARCH_NAMES) - set(configs.ARCH_NAMES))
        assert unported == []
        assert configs.ARCH_NAMES == list(jconfigs.ARCH_NAMES)
        for name in ("rwkv6-7b", "zamba2-2.7b"):
            for get, jget in ((configs.get_arch, jconfigs.get_arch),
                              (configs.get_smoke, jconfigs.get_smoke)):
                assert dataclasses.asdict(get(name)) == \
                    dataclasses.asdict(jget(name))
        with pytest.raises(KeyError):
            configs.get_smoke("no-such-arch")


class TestLowering:
    def test_params_carry_across(self):
        jp, tp = _params(False)
        jl, tl = jax.tree_util.tree_flatten_with_path(jp)[0], []

        def walk(node, path):
            if isinstance(node, dict):
                for k in node:
                    walk(node[k], path + (k,))
            else:
                tl.append((path, node))

        walk(tp, ())
        assert [tuple(e.key for e in p) for p, _ in jl] == [p for p, _ in tl]
        for (_, a), (_, b) in zip(jl, tl):
            assert b.dtype == torch.float32 and b.device.type == "cpu"
            _eq(b, a)
        assert tuple(tp["layers"]["l0"]["attn"]["wq"]["w"].shape) == (2, 96, 96)

    def test_lower_tree_fused_qkv_and_stacked_plans(self):
        jm, tm = _models(False)
        jt, tt = jm.lower(), tm.lower()
        jattn, tattn = jt["layers"]["l0"]["attn"], tt["layers"]["l0"]["attn"]
        stack = tattn["_groups"]["qkv"]
        assert isinstance(stack, PlanStack) and len(stack) == CFG.n_layers
        jg = jattn["_groups"]["qkv"]
        for i, gp in enumerate(stack):
            assert (gp.kind, gp.member_names, gp.member_ns) == (
                jg.kind, jg.member_names, jg.member_ns) == (
                "column_concat", ("wq", "wk", "wv"), (96, 32, 32))
            _assert_store(gp.fused, jg.fused, i)
            _eq(gp.fused.store.row_gain, jg.fused.store.row_gain[i])
        for m in ("wq", "wk", "wv"):         # fused members: no own plan
            assert "_plan" not in tattn[m] and "_plan" not in jattn[m]
        for node_t, node_j in ((tattn["wo"], jattn["wo"]),
                               *((tt["layers"]["l0"]["mlp"][k],
                                  jt["layers"]["l0"]["mlp"][k])
                                 for k in ("up", "gate", "down"))):
            assert isinstance(node_t["_plan"], PlanStack)
            for i, lp in enumerate(node_t["_plan"]):
                _assert_store(lp, node_j["_plan"], i)
        _assert_store(tt["lm_head"]["_plan"], jt["lm_head"]["_plan"])
        assert tm.group_plan("layers.l0.attn.qkv") is stack

    def test_spec_declares_the_reference_groups(self):
        jm, tm = _models(False)
        assert [(g.name, g.kind, g.members) for g in tm.spec.groups] == [
            (g.name, g.kind, g.members) for g in jm.spec.groups]
        assert [(l.name, l.in_dim, l.out_dim, l.group, l.stacked)
                for l in tm.spec.layers] == [
            (l.name, l.in_dim, l.out_dim, l.group, l.stacked)
            for l in jm.spec.layers]

    def test_static_calibration_keeps_per_layer_plans(self):
        _, tp = _params(True)
        run = RunConfig(analog=AnalogConfig(mode="analog_faithful",
                                            act_calib="static"))
        tt = api.lower_tree(tp, run)
        attn = tt["layers"]["l0"]["attn"]
        assert "_groups" not in attn
        assert all(isinstance(attn[m]["_plan"], PlanStack)
                   for m in ("wq", "wk", "wv"))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


class TestLayers:
    @pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
    def test_norm_apply(self, kind):
        x = _rand((2, 5, 96), 1, 3.0)
        p = {"scale": _rand((96,), 2) + 1, "bias": _rand((96,), 3)}
        if kind == "rmsnorm":
            del p["bias"]
        want = JL.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), kind)
        got = L.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), kind)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        assert L.norm_init(96, kind, "cpu").keys() == \
            JL.norm_init(96, kind).keys()

    def test_apply_rope(self):
        x = _rand((2, 7, 6, 16), 4)
        pos = np.arange(3, 10, dtype=np.int32)[None].repeat(2, 0)
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
        got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)

    def test_embedding_and_digital_mlp(self):
        jp, tp = _params(False)
        tok = np.array([[3, 0, 511]])
        _eq(L.embedding_apply(tp["embed"], torch.from_numpy(tok)),
            JL.embedding_apply(jp["embed"], jnp.asarray(tok)))
        x = _rand((2, 3, 96), 5)
        jmlp = jax.tree.map(lambda a: a[0], jp["layers"]["l0"]["mlp"])
        tmlp = T.stack_index(tp["layers"]["l0"]["mlp"], 0)
        want = JL.mlp_apply(jmlp, jnp.asarray(x), JAnalogConfig(mode="digital"))
        got = L.mlp_apply(tmlp, torch.from_numpy(x),
                          AnalogConfig(mode="digital"))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def _layer0_attn(noiseless):
    jm, tm = _models(noiseless)
    return (jax.tree.map(lambda a: a[0], jm.lower()["layers"]["l0"]["attn"]),
            T.stack_index(tm.lower()["layers"]["l0"]["attn"], 0))


class TestAttention:
    @pytest.mark.parametrize("noiseless", [True, False])
    def test_prefill_and_decode_with_cache(self, noiseless):
        jattn, tattn = _layer0_attn(noiseless)
        jrun, run = _runs(noiseless)
        kw = dict(n_heads=CFG.n_heads, n_kv_heads=CFG.n_kv_heads,
                  head_dim=CFG.hd, rope_theta=CFG.rope_theta)
        jc = JA.init_cache(2, 12, CFG.n_kv_heads, CFG.hd, jnp.float32)
        tc = A.init_cache(2, 12, CFG.n_kv_heads, CFG.hd, torch.float32, "cpu")
        for step, s in enumerate((5, 1, 1)):
            x = _rand((2, s, 96), 10 + step)
            start = 0 if step == 0 else 4 + step
            pos = np.tile(np.arange(start, start + s, dtype=np.int32),
                          (2, 1))
            jy, jc = JA.attention_apply(
                jattn, jnp.asarray(x), positions=jnp.asarray(pos),
                acfg=jrun.analog, cache=jc, **kw)
            ty, tc = A.attention_apply(
                tattn, torch.from_numpy(x), positions=torch.from_numpy(pos),
                acfg=run.analog, cache=tc, **kw)
            jy = np.asarray(jy)
            np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                                       atol=1e-5 * np.abs(jy).max())
            assert tc["len"] == int(jc["len"])
            np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                       rtol=0, atol=1e-5)

    def test_run_group_splits_the_fused_columns(self):
        jattn, tattn = _layer0_attn(True)
        jrun, run = _runs(True)
        x = _rand((2, 3, 96), 30)
        want = jrun_group(jattn["_groups"]["qkv"], jnp.asarray(x), jrun.analog)
        got = trun.run_group(tattn["_groups"]["qkv"], torch.from_numpy(x),
                             run.analog)
        assert [tuple(t.shape) for t in got] == [w.shape for w in want] == [
            (2, 3, 96), (2, 3, 32), (2, 3, 32)]
        for t, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())

    def test_prefill_without_cache(self):
        jattn, tattn = _layer0_attn(True)
        jrun, run = _runs(True)
        kw = dict(n_heads=CFG.n_heads, n_kv_heads=CFG.n_kv_heads,
                  head_dim=CFG.hd, rope_theta=CFG.rope_theta)
        x = _rand((2, 6, 96), 20)
        pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
        jy, _ = JA.attention_apply(jattn, jnp.asarray(x),
                                   positions=jnp.asarray(pos),
                                   acfg=jrun.analog, **kw)
        ty, tc = A.attention_apply(tattn, torch.from_numpy(x),
                                   positions=torch.from_numpy(pos),
                                   acfg=run.analog, **kw)
        assert tc is None
        jy = np.asarray(jy)
        np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                                   atol=1e-5 * np.abs(jy).max())


def _lm_steps(noiseless, mode="analog_faithful"):
    """Prefill of a [2, 7] prompt plus 3 greedy decode steps through both
    packages; returns the per-step (reference, port) logits."""
    if mode == "digital":
        jp, tp = _params(noiseless)
        jl_tree, tl_tree = jp, tp
    else:
        jm, tm = _models(noiseless)
        jl_tree, tl_tree = jm.lower(), tm.lower()
    jrun, run = _runs(noiseless, mode)
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 7))
    jc = JT.init_lm_cache(JCFG, 2, 16, dtype=jnp.float32)
    tc = T.init_lm_cache(CFG, 2, 16, dtype=torch.float32, device="cpu")
    out = []
    for _ in range(4):
        jl, jc, _ = JT.lm_apply(jl_tree, {"tokens": jnp.asarray(toks)}, JCFG,
                                jrun, cache=jc)
        tl, tc, _ = T.lm_apply(tl_tree, {"tokens": torch.from_numpy(toks)},
                               CFG, run, cache=tc)
        out.append((np.asarray(jl), tl.numpy()))
        toks = np.asarray(jl)[:, -1].argmax(-1)[:, None]
    assert tc["step"] == int(jc["step"]) == 10
    return out


class TestLM:
    @pytest.mark.parametrize("noiseless", [True, False])
    def test_prefill_and_decode_logits(self, noiseless):
        rel = 1e-5 if noiseless else 1e-4
        for jl, tl in _lm_steps(noiseless):
            assert tl.shape == jl.shape and np.isfinite(tl).all()
            np.testing.assert_allclose(tl, jl, rtol=0,
                                       atol=rel * np.abs(jl).max())
            np.testing.assert_array_equal(tl[:, -1].argmax(-1),
                                          jl[:, -1].argmax(-1))

    def test_digital_mode_logits(self):
        for jl, tl in _lm_steps(False, mode="digital"):
            np.testing.assert_allclose(tl, jl, rtol=0,
                                       atol=1e-5 * np.abs(jl).max())

    def test_serve_engine_tokens(self):
        jp, tp = _params(False)
        jrun, run = _runs(False)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, CFG.vocab_size, rng.integers(4, 12))
                   for _ in range(2)]
        jeng = JServeEngine(JCFG, jrun, jp, batch_size=2, max_len=32)
        jout = jeng.serve([JRequest(uid=i, prompt=p, max_new_tokens=3)
                           for i, p in enumerate(prompts)])
        eng = ServeEngine(CFG, run, tp, batch_size=2, max_len=32,
                          device="cpu")
        trun.reset_dispatch_count()
        out = eng.serve([Request(uid=i, prompt=p, max_new_tokens=3)
                         for i, p in enumerate(prompts)])
        # one prefill and two decode calls, each 5 dispatches per layer
        # (fused QKV, o, up, gate, down) plus the lm_head
        assert trun.dispatch_count() == 3 * (5 * CFG.n_layers + 1)
        for r, jr in zip(out, jout):
            assert r.output.tolist() == jr.output.tolist()
            assert len(r.output) == 3


class TestDispatches:
    def test_split_path_dispatch_count(self):
        """Every analog layer of a call is ONE fused-split dispatch: the
        fused QKV group, o, up, gate and down per layer, plus lm_head."""
        _, tm = _models(False)
        _, run = _runs(False)
        cache = T.init_lm_cache(CFG, 2, 16, dtype=torch.float32,
                                device="cpu")
        per_call = 5 * CFG.n_layers + 1
        assert len(tm.spec.layers) - 2 * len(tm.spec.groups) == 6
        trun.reset_dispatch_count()
        _, cache, _ = T.lm_apply(tm.lower(), {"tokens": torch.zeros(
            (2, 4), dtype=torch.long)}, CFG, run, cache=cache)
        assert trun.dispatch_count() == per_call
        T.lm_apply(tm.lower(), {"tokens": torch.zeros((2, 1),
                                                      dtype=torch.long)},
                   CFG, run, cache=cache)
        assert trun.dispatch_count() == 2 * per_call
        # without the plans (per-call lowering, no fusion) QKV takes three
        trun.reset_dispatch_count()
        T.lm_apply(_params(False)[1], {"tokens": torch.zeros(
            (1, 3), dtype=torch.long)}, CFG, run)
        assert trun.dispatch_count() == 7 * CFG.n_layers + 1


class TestNotPorted:
    def test_unported_hooks_and_paths_raise(self):
        # the engine's calibration, drift, plan-cache and fleet hooks are
        # ported (tests/test_torch_serve_hooks.py); these paths are not
        # the int8 cache, the offset encoding and the two-pass split are
        # ported too (tests/test_torch_lm_serve_opts.py); so is M-RoPE,
        # held against the reference's attention at head_dim 128 (its
        # sections 16 + 24 + 24 fill head_dim / 2) with distinct (t, h, w)
        # positions, prefill and one cached decode step, logits within
        # 1e-5 * max|out| (NOISELESS, as above)
        _, tp = _params(True)
        _, run = _runs(True)
        c = A.init_cache(1, 4, 2, 16, torch.int8, "cpu")
        assert c["k"].dtype == torch.int8 and c["k_scale"].shape == (1, 4, 2)
        lp = api.lower_tree(tp, run)["lm_head"]["_plan"]
        x = torch.ones((1, 96))
        y = trun.run_layer(lp, x, run.analog.replace(fused_split=False))
        assert torch.equal(y, trun.run_layer(lp, x, run.analog))
        jrun, _ = _runs(True)
        geo = dict(n_heads=2, n_kv_heads=1, head_dim=128, rope_theta=1e6,
                   mrope=True)
        jp = JA.attention_init(jax.random.PRNGKey(3), 64, 2, 1, 128,
                               noise=JNOISELESS)
        ap = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        rng = np.random.default_rng(4)
        x = rng.standard_normal((2, 5, 64)).astype(np.float32)
        pos = rng.integers(0, 40, (2, 6, 3)).astype(np.int32)
        jc = JA.init_cache(2, 8, 1, 128, jnp.float32)
        tc = A.init_cache(2, 8, 1, 128, torch.float32, "cpu")
        for sl in (slice(0, 5), slice(5, 6)):
            xs = x[:, :5] if sl.start == 0 else x[:, :1] * 0.5
            jy, jc = JA.attention_apply(jp, jnp.asarray(xs),
                                        positions=jnp.asarray(pos[:, sl]),
                                        acfg=jrun.analog, cache=jc, **geo)
            ty, tc = A.attention_apply(ap, torch.from_numpy(xs),
                                       positions=torch.from_numpy(pos[:, sl]),
                                       acfg=run.analog, cache=tc, **geo)
            want = np.asarray(jy)
            np.testing.assert_allclose(_np(ty), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        with pytest.raises(ValueError, match="sections"):
            L.apply_mrope(torch.ones((1, 2, 1, 16)),
                          torch.zeros((1, 2, 3)), 1e4)
