"""The port's whole-plan float stages and transformer-block path against
the JAX package's, on the CPU.

Weights come from the reference's own init (``analog_linear_init``,
``_layer_init``, ``lm_init``), carried across by
``convert.params_from_numpy``; inputs are made with numpy from a seed.
The reference side runs ``analog_plan_pallas`` in interpret mode
(``use_pallas=True``), as its own tests do.  Tolerances:

- lowering (``lower_block`` schedule, packed rows, effective weights):
  bit-exact.
- float-domain chains (code -> relu_shift -> relu -> raw, and a split
  chain) under ``NOISELESS``: bit-exact (integer effective weights; the
  dequant, ReLU and encode steps round identically).
- a block, and the LM logits through ``attach_block_plans``: within
  1e-5 * max|y| (RMSNorm, RoPE, softmax and SiLU reduce and round in
  another order in XLA than in PyTorch, so a 5-bit code can flip at a
  rounding tie); equal argmax.
- the port's block route against its own per-layer fallback and its
  per-layer model path: bit-exact under ``NOISELESS`` (the same glue
  functions on the same device).
- a noisy block call (readout noise drawn) against the reference's
  ``run(plan, x, key=)`` with the reference's draws passed in: within
  1e-5 * max|y|, as a deterministic block.
- the block route's HIL gradients (input, the seven weight masters,
  ln1 and ln2, lowered under autograd) against the reference's
  ``jax.grad`` through its megakernel route: within 1e-6 absolute (the
  reference holds its own two routes to that); the port's block route
  against its per-layer route: bit-exact.

The CUDA kernels run only on the card: tests/test_torch_cuda.py and
``chip_smoke.py`` hold them against these plain versions there.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import exec as JE  # noqa: E402
from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.analog import analog_linear_init as jlinear_init  # noqa: E402
from repro.core.noise import NOISELESS as JNOISELESS  # noqa: E402
from repro.core.noise import readout_noise as j_readout_noise  # noqa: E402
from repro.kernels.analog_plan import analog_plan_pallas  # noqa: E402
from repro.kernels.analog_plan import default_block_b  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.configs.base import ArchConfig, RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.noise import NoiseFeed  # noqa: E402
from repro_torch.exec import run as trun  # noqa: E402
from repro_torch.exec.lower import lower_block, lower_stack  # noqa: E402
from repro_torch.exec.plan import PlanStack  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "phi4-mini-3.8b"
CFG = configs.get_smoke(ARCH)      # 6/2 heads of 16: grouped queries
JCFG = jconfigs.get_smoke(ARCH)
SEQ = 12
REL = 1e-5
MODES = ["analog_faithful", "analog_fast"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _close(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _acfgs(mode="analog_faithful", **kw):
    return (JAnalogConfig(mode=mode, act_calib="static", use_pallas=True,
                          **kw),
            AnalogConfig(mode=mode, act_calib="static", **kw))


@functools.lru_cache(maxsize=None)
def _jblock_params(noiseless: bool, seed: int = 0):
    """One block node of the smoke config, from the reference's init (its
    module-level fixed-pattern default swapped for NOISELESS when asked)."""
    saved = JT.NOISE
    JT.NOISE = JNOISELESS if noiseless else saved
    try:
        return JT._layer_init(jax.random.PRNGKey(seed), "attn_mlp", JCFG)
    finally:
        JT.NOISE = saved


def _block_plans(mode, noiseless):
    jacfg, acfg = _acfgs(mode)
    jp = _jblock_params(noiseless)
    kw = dict(n_heads=CFG.n_heads, n_kv_heads=CFG.n_kv_heads,
              head_dim=CFG.hd, seq=SEQ, rope_theta=CFG.rope_theta)
    return (JE.lower_block(jp, jacfg, **kw),
            lower_block(_port(jp), acfg, **kw))


def _block_x(b, seed=1):
    return (np.random.default_rng(seed).standard_normal(
        (b, SEQ, CFG.d_model)) * 0.5).astype(np.float32)


def _chain(kind, mode):
    """The mixed chain (codes -> relu_shift -> relu -> raw) or a split
    chain (float -> relu -> relu -> raw, signed-split encodes), both
    NOISELESS, lowered by both packages from the same weights."""
    jacfg, acfg = _acfgs(mode)
    ks = jax.random.split(jax.random.PRNGKey(4), 3)
    dims = ((32, 48), (48, 40), (40, 24)) if kind == "mixed" else (
        (100, 70), (70, 150), (150, 9))
    layers = [jlinear_init(k, i, o, noise=JNOISELESS)
              for k, (i, o) in zip(ks, dims)]
    if kind == "mixed":
        kw = dict(epilogues=["relu_shift", "none", "none"],
                  input_domain="codes")
        sig = [None] * 3
    else:
        kw = dict(epilogues=["none"] * 3, input_domain="float")
        sig = ["split"] * 3
    jplan = JE.lower_stack(layers, jacfg, signed_inputs=sig,
                           flatten_outs=[False] * 3, **kw)
    tplan = lower_stack([_port(p) for p in layers], acfg, signed_inputs=sig,
                        flatten_outs=[False] * 3, **kw)
    return jplan, tplan


class TestPlanRef:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("kind", ["mixed", "split"])
    def test_chain_ref_vs_pallas(self, kind, mode):
        jplan, tplan = _chain(kind, mode)
        jm, tm = jplan.mega, tplan.mega
        assert [tuple(m) for m in tm.schedule] == [tuple(m)
                                                    for m in jm.schedule]
        assert [m.handoff for m in tm.schedule] == ["codes" if kind == "mixed"
                                                    else "relu", "relu", "raw"]
        rng = np.random.default_rng(7)
        if kind == "mixed":
            x = rng.integers(0, 32, (5, 32)).astype(np.float32)
            x = np.pad(x, ((0, 0), (0, 96)))       # codes padded to k_pad
        else:
            x = rng.standard_normal((5, 100)).astype(np.float32)
        faithful = mode == "analog_faithful"
        want = analog_plan_pallas(
            jnp.asarray(x), jm.w_cat, jm.gain, jm.off, jm.deq, jm.bias,
            jm.enc, schedule=jm.schedule, faithful=faithful, block_b=2,
            interpret=True)
        got = ref.analog_plan_ref(torch.from_numpy(x), tm.w_cat, tm.gain,
                                  tm.off, tm.schedule, faithful=faithful,
                                  extras=tm.extras)
        _eq(got, want)
        # the CPU route of the dispatching wrapper is the plain version
        _eq(ops.analog_plan_codes(torch.from_numpy(x), tm.weights, tm.gain,
                                  tm.off, schedule=tm.schedule,
                                  faithful=faithful, extras=tm.extras), got)

    @pytest.mark.parametrize("mode", MODES)
    def test_chain_megakernel_route_matches_reference(self, mode):
        jplan, tplan = _chain("split", mode)
        x = np.random.default_rng(8).standard_normal((4, 3, 100)).astype(
            np.float32)
        want = JE.run(jplan, jnp.asarray(x), megakernel=True)
        trun.reset_dispatch_count()
        got = trun.run(tplan, torch.from_numpy(x), megakernel=True)
        assert trun.dispatch_count() == 1
        _eq(got, want)
        _eq(trun.run(tplan, torch.from_numpy(x), megakernel=False), got)

    @pytest.mark.parametrize("noiseless", [True, False])
    @pytest.mark.parametrize("mode", MODES)
    def test_block_ref_vs_pallas(self, mode, noiseless):
        jplan, tplan = _block_plans(mode, noiseless)
        jm, tm = jplan.mega, tplan.mega
        b = 3
        x = _block_x(b).reshape(b * SEQ, CFG.d_model)
        want = analog_plan_pallas(
            jnp.asarray(x), jm.w_cat, jm.gain, jm.off, jm.deq, jm.bias,
            jm.enc, jm.ln, schedule=jm.schedule,
            faithful=mode == "analog_faithful",
            block_b=default_block_b(b, SEQ), interpret=True, block=jm.block)
        got = ref.analog_plan_ref(
            torch.from_numpy(x), tm.weights, tm.gain, tm.off, tm.schedule,
            faithful=mode == "analog_faithful", extras=tm.extras,
            block=tm.block)
        _close(got, want)


class TestLowering:
    @pytest.mark.parametrize("noiseless", [True, False])
    def test_lower_block_equals_reference(self, noiseless):
        jplan, tplan = _block_plans("analog_faithful", noiseless)
        jm, tm = jplan.mega, tplan.mega
        assert [tuple(m) for m in tm.schedule] == [tuple(m)
                                                    for m in jm.schedule]
        assert [m.handoff for m in tm.schedule] == [
            "attn", "res_ln", "swiglu", "res_out"]
        assert all(m.encode == "split" and m.m_mult == SEQ
                   for m in tm.schedule)
        assert tuple(tm.block) == tuple(jm.block)
        assert tm.n_max == jm.n_max and tm.chunk_rows == jm.chunk_rows
        for name in ("gain", "off", "deq", "bias", "enc", "ln"):
            _eq(getattr(tm, name), getattr(jm, name))
        # block plans hold no column-padded w_cat: the kernel reads each
        # layer's w_eff in place; it equals the reference's packed slice
        assert tm.w_cat is None
        jw = np.asarray(jm.w_cat)
        for w, meta in zip(tm.weights, tm.schedule):
            assert w.is_contiguous()
            _eq(w, jw[meta.row0:meta.row0 + meta.k_pad, :meta.n])
        for tl, jl in zip(tplan.layers, jplan.layers):
            assert (tl.k, tl.n, tl.k_pad) == (jl.k, jl.n, jl.k_pad)
            _eq(tl.store.codes, jl.store.codes)
        _eq(tplan.block.ln1, jplan.block.ln1)
        assert tplan.expected_dispatches == jplan.expected_dispatches == 1

    def test_lower_block_rejects_dynamic_calibration_and_offset(self):
        p = _port(_jblock_params(True))
        kw = dict(n_heads=CFG.n_heads, n_kv_heads=CFG.n_kv_heads,
                  head_dim=CFG.hd, seq=SEQ, rope_theta=CFG.rope_theta)
        with pytest.raises(ValueError, match="act_calib"):
            lower_block(p, AnalogConfig(act_calib="dynamic"), **kw)
        with pytest.raises(ValueError, match="offset"):
            lower_block(p, AnalogConfig(act_calib="static",
                                        signed_input="offset"), **kw)
        nogate = {**p, "mlp": {k: v for k, v in p["mlp"].items()
                               if k != "gate"}}
        with pytest.raises(ValueError, match="swiglu"):
            lower_block(nogate, AnalogConfig(act_calib="static"), **kw)


class TestDomains:
    """The port's megakernel eligibility walk accepts exactly what the
    reference's accepts, with the same reasons, and packs the same
    encode/hand-off tags."""

    @pytest.mark.parametrize("calib,signed,entry,epilogues", [
        ("static", "split", "float", ["none", "none", "none"]),
        ("static", "none", "float", ["none", "relu_shift", "none"]),
        ("static", "none", "codes", ["relu_shift", "none", "none"]),
        ("static", "offset", "float", ["none", "none", "none"]),
        ("static", "offset", "codes", ["relu_shift", "relu_shift", "none"]),
        ("dynamic", "split", "float", ["none", "none", "none"]),
        ("dynamic", "none", "codes", ["relu_shift", "none", "none"]),
        ("dynamic", "none", "codes", ["relu_shift", "relu_shift", "none"]),
    ])
    def test_eligibility_matches_reference(self, calib, signed, entry,
                                           epilogues):
        from repro.exec.lower import megakernel_ineligible_reason as jwhy

        from repro_torch.exec.lower import megakernel_ineligible_reason

        ks = jax.random.split(jax.random.PRNGKey(6), 3)
        layers = [jlinear_init(k, i, o, noise=JNOISELESS)
                  for k, (i, o) in zip(ks, ((40, 30), (30, 20), (20, 8)))]
        kw = dict(signed_inputs=[signed] * 3, epilogues=epilogues,
                  flatten_outs=[False] * 3, input_domain=entry)
        jplan = JE.lower_stack(layers, JAnalogConfig(act_calib=calib), **kw)
        tplan = lower_stack([_port(p) for p in layers],
                            AnalogConfig(act_calib=calib), **kw)
        assert megakernel_ineligible_reason(tplan) == jwhy(jplan)
        assert (tplan.mega is None) == (jplan.mega is None)
        if tplan.mega is not None:
            assert [(m.encode, m.handoff) for m in tplan.mega.schedule] == [
                (m.encode, m.handoff) for m in jplan.mega.schedule]


class TestBlockRoutes:
    @pytest.mark.parametrize("mode", MODES)
    def test_block_route_equals_fallback(self, mode):
        _, tplan = _block_plans(mode, True)
        x = torch.from_numpy(_block_x(2))
        trun.reset_dispatch_count()
        y_mega = trun.run(tplan, x, megakernel=True)
        assert trun.dispatch_count() == 1
        trun.reset_dispatch_count()
        y_fall = trun.run(tplan, x, megakernel=False)
        assert trun.dispatch_count() == 4
        assert y_mega.shape == x.shape
        _eq(y_mega, y_fall)

    @pytest.mark.parametrize("mode", MODES)
    def test_block_route_matches_reference_run(self, mode):
        jplan, tplan = _block_plans(mode, False)
        x = _block_x(2, seed=3)
        _close(trun.run(tplan, torch.from_numpy(x)),
               JE.run(jplan, jnp.asarray(x), megakernel=True))

    def test_block_seq_mismatch_raises(self):
        _, tplan = _block_plans("analog_faithful", True)
        x = torch.zeros((2, SEQ + 1, CFG.d_model))
        with pytest.raises(ValueError, match="re-lower"):
            trun.run(tplan, x)

    def test_bfloat16_input_computes_in_fp32(self):
        _, tplan = _block_plans("analog_faithful", True)
        x = torch.from_numpy(_block_x(1)).to(torch.bfloat16)
        y = trun.run(tplan, x)
        assert y.dtype == torch.bfloat16
        assert torch.equal(
            y, trun.run(tplan, x.to(torch.float32)).to(torch.bfloat16))


def _block_draws(key, jplan, b, mode):
    """The reference's readout noise of a noisy block replay, in the
    port's call order: one key per layer (``split(key, 4)``), each split
    once more into the positive and the negative pass of its signed
    split; ``[B, S, C, N]`` per pass (faithful) or ``[B, S, N]`` (fast)."""
    draws = []
    for lk, lp in zip(jax.random.split(key, 4), jplan.layers):
        shape = (b, SEQ, lp.n_chunks, lp.n) if mode == "analog_faithful" \
            else (b, SEQ, lp.n)
        draws += [torch.tensor(np.asarray(
            j_readout_noise(kk, shape, jplan.cfg.noise)))
            for kk in jax.random.split(lk)]
    return draws


_TRAINED = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
            ("mlp", "up"), ("mlp", "gate"), ("mlp", "down"))


def _with_masters(jp, masters):
    """The block node ``jp`` with its seven weight masters and its two
    RMSNorm scales taken from ``masters``."""
    out = {**jp, "ln1": {"scale": masters["ln1"]},
           "ln2": {"scale": masters["ln2"]}}
    for grp in ("attn", "mlp"):
        out[grp] = {k: dict(v) for k, v in jp[grp].items()}
    for grp, k in _TRAINED:
        out[grp][k]["w"] = masters[f"{grp}.{k}"]
    return out


@functools.lru_cache(maxsize=None)
def _jblock_grads(mode):
    """``jax.grad`` of mean(y**2) through the reference's megakernel route
    of a block lowered inside the gradient (its custom VJP of
    ``_plan_codes``), w.r.t. the input, the weight masters and the
    RMSNorm scales."""
    jacfg, _ = _acfgs(mode)
    jacfg = jacfg.replace(use_pallas=False)
    jp = _jblock_params(False)
    kw = dict(n_heads=CFG.n_heads, n_kv_heads=CFG.n_kv_heads,
              head_dim=CFG.hd, seq=SEQ, rope_theta=CFG.rope_theta)
    masters = {"ln1": jp["ln1"]["scale"], "ln2": jp["ln2"]["scale"]}
    masters.update({f"{g}.{k}": jp[g][k]["w"] for g, k in _TRAINED})

    def loss(m, x):
        plan = JE.lower_block(_with_masters(jp, m), jacfg, **kw)
        return (JE.run(plan, x, megakernel=True) ** 2).mean()

    gm, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        masters, jnp.asarray(_block_x(2, seed=4)))
    return {k: np.asarray(v) for k, v in gm.items()}, np.asarray(gx)


def _port_block_grads(mode, megakernel):
    """The port's gradients of the same loss, the block lowered under
    autograd from the reference's parameters."""
    _, acfg = _acfgs(mode)
    tp = _port(_jblock_params(False))
    masters = {"ln1": tp["ln1"]["scale"], "ln2": tp["ln2"]["scale"]}
    masters.update({f"{g}.{k}": tp[g][k]["w"] for g, k in _TRAINED})
    for t in masters.values():
        t.requires_grad_(True)
    x = torch.from_numpy(_block_x(2, seed=4)).requires_grad_(True)
    plan = lower_block(tp, acfg, n_heads=CFG.n_heads,
                       n_kv_heads=CFG.n_kv_heads, head_dim=CFG.hd, seq=SEQ,
                       rope_theta=CFG.rope_theta)
    trun.reset_dispatch_count()
    (trun.run(plan, x, megakernel=megakernel) ** 2).mean().backward()
    assert trun.dispatch_count() == (1 if megakernel else 4)
    return {k: t.grad for k, t in masters.items()}, x.grad


class TestBlockNoise:
    @pytest.mark.parametrize("mode", MODES)
    def test_noisy_replay_matches_reference_draws(self, mode):
        jacfg, acfg = _acfgs(mode, deterministic=False)
        jp = _jblock_params(False)
        kw = dict(n_heads=CFG.n_heads, n_kv_heads=CFG.n_kv_heads,
                  head_dim=CFG.hd, seq=SEQ, rope_theta=CFG.rope_theta)
        jplan = JE.lower_block(jp, jacfg, **kw)
        tplan = lower_block(_port(jp), acfg, **kw)
        x = _block_x(2, seed=5)
        key = jax.random.PRNGKey(11)
        want = JE.run(jplan, jnp.asarray(x), key=key)
        feed = NoiseFeed(_block_draws(key, jplan, 2, mode))
        trun.reset_dispatch_count()
        got = trun.run(tplan, torch.from_numpy(x), noise=feed)
        assert feed.pos == len(feed.draws) == 8      # 4 layers x 2 passes
        assert trun.dispatch_count() == 8
        _close(got, want)
        # the draws took effect: the deterministic replay differs
        assert not np.array_equal(_np(got), _np(trun.run(
            tplan, torch.from_numpy(x))))

    def test_noisy_megakernel_refused_with_reason(self):
        _, acfg = _acfgs(deterministic=False)
        tplan = lower_block(_port(_jblock_params(False)), acfg,
                            n_heads=CFG.n_heads, n_kv_heads=CFG.n_kv_heads,
                            head_dim=CFG.hd, seq=SEQ,
                            rope_theta=CFG.rope_theta)
        x = torch.from_numpy(_block_x(1))
        gen = torch.Generator().manual_seed(0)
        reason = "noisy replay (readout-noise keys) is layer-by-layer"
        with pytest.raises(ValueError, match=reason.replace("(", r"\(")
                           .replace(")", r"\)")):
            trun.run(tplan, x, noise=gen, megakernel=True)
        assert trun.megakernel_fallback_reason(tplan, x, noise=gen) == reason
        assert trun.megakernel_fallback_reason(tplan, x) is None


class TestBlockHILGradients:
    @pytest.mark.parametrize("mode", MODES)
    def test_block_route_gradients_match_reference(self, mode):
        jgm, jgx = _jblock_grads(mode)
        gm, gx = _port_block_grads(mode, True)
        assert np.abs(jgx).max() > 0
        np.testing.assert_allclose(_np(gx), jgx, rtol=0, atol=1e-6)
        for k, want in jgm.items():
            assert np.abs(want).max() > 0, k
            np.testing.assert_allclose(_np(gm[k]), want, rtol=0, atol=1e-6,
                                       err_msg=k)

    @pytest.mark.parametrize("mode", MODES)
    def test_block_route_gradients_equal_per_layer(self, mode):
        gm, gx = _port_block_grads(mode, True)
        fm, fx = _port_block_grads(mode, False)
        _eq(gx, fx)
        for k in gm:
            _eq(gm[k], fm[k])


@functools.lru_cache(maxsize=None)
def _lm_params(noiseless: bool):
    saved = JT.NOISE
    JT.NOISE = JNOISELESS if noiseless else saved
    try:
        jp = JT.lm_init(jax.random.PRNGKey(0), JCFG)
    finally:
        JT.NOISE = saved
    return jp, _port(jp)


def _tokens(s, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (2, s))


class TestLM:
    @pytest.mark.parametrize("noiseless", [True, False])
    def test_attach_block_plans_lm_matches_reference(self, noiseless):
        jp, tp = _lm_params(noiseless)
        jacfg, acfg = _acfgs()
        jrun = JRunConfig(analog=jacfg, activation_dtype="float32")
        run = RunConfig(analog=acfg, activation_dtype="float32")
        jb = JT.attach_block_plans(jp, JCFG, jacfg, seq=SEQ)
        tb = T.attach_block_plans(tp, CFG, acfg, seq=SEQ)
        stack = tb["layers"]["l0"]["_block_plan"]
        assert isinstance(stack, PlanStack) and len(stack) == CFG.n_layers
        toks = _tokens(SEQ)
        want = np.asarray(JT.lm_apply(jb, {"tokens": jnp.asarray(toks)},
                                      JCFG, jrun)[0])
        trun.reset_dispatch_count()
        got = T.lm_apply(tb, {"tokens": torch.from_numpy(toks)}, CFG, run)[0]
        # one dispatch per block, plus the analog lm_head
        assert trun.dispatch_count() == CFG.n_layers + 1
        _close(got, want)
        _eq(got.numpy().argmax(-1), want.argmax(-1))
        # a length other than the baked seq keeps the per-layer path
        toks = _tokens(SEQ - 3, seed=1)
        want = np.asarray(JT.lm_apply(jb, {"tokens": jnp.asarray(toks)},
                                      JCFG, jrun)[0])
        trun.reset_dispatch_count()
        got = T.lm_apply(tb, {"tokens": torch.from_numpy(toks)}, CFG, run)[0]
        assert trun.dispatch_count() == 7 * CFG.n_layers + 1
        _close(got, want)

    def test_block_route_equals_per_layer_model_path(self):
        _, tp = _lm_params(True)
        _, acfg = _acfgs()
        run = RunConfig(analog=acfg, activation_dtype="float32")
        tree = api.lower_tree(tp, run)
        tb = T.attach_block_plans(tree, CFG, acfg, seq=SEQ)
        batch = {"tokens": torch.from_numpy(_tokens(SEQ, seed=2))}
        _eq(T.lm_apply(tb, batch, CFG, run)[0],
            T.lm_apply(tree, batch, CFG, run)[0])

    def test_attach_block_plans_rejects_foreign_glue(self):
        cfg = ArchConfig(name="t", family="dense", n_layers=1, d_model=64,
                         n_heads=2, n_kv_heads=2, d_ff=96, vocab_size=64,
                         act="gelu")
        params = T.lm_init(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
        with pytest.raises(ValueError, match="swiglu"):
            T.attach_block_plans(params, cfg, _acfgs()[1], seq=SEQ)


class TestApi:
    def test_compile_block_applies_and_lowers(self):
        jp = _jblock_params(False)
        jacfg, acfg = _acfgs()
        kw = dict(n_heads=CFG.n_heads, n_kv_heads=CFG.n_kv_heads,
                  head_dim=CFG.hd, seq=SEQ, rope_theta=CFG.rope_theta)
        m = api.compile_block(_port(jp), acfg, device="cpu", **kw)
        x = _block_x(2, seed=4)
        y = m.apply(torch.from_numpy(x))
        _eq(y, m.apply(torch.from_numpy(x), megakernel=False))
        plan = m.lower()
        assert plan.block is not None and plan.expected_dispatches == 1
        assert [l.name for l in m.spec.layers] == ["qkv", "o", "up_gate",
                                                   "down"]
        jm = japi.compile_block(jp, jacfg, **kw)
        _close(y, jm.apply(jnp.asarray(x)))

    def test_block_spec_checks(self):
        with pytest.raises(ValueError, match="block_geom"):
            api.ModuleSpec(name="b", kind="block")
        p = _port(_jblock_params(True))
        kw = dict(n_heads=CFG.n_heads, n_kv_heads=CFG.n_kv_heads,
                  head_dim=CFG.hd, seq=SEQ, device="cpu")
        with pytest.raises(ValueError, match="digital"):
            api.compile_block(p, AnalogConfig(mode="digital",
                                              act_calib="static"), **kw)
        # a snapshot that covers no member keeps the oracle bake
        from repro_torch.calib import CalibrationSnapshot

        acfg = AnalogConfig(act_calib="static")
        x = torch.randn((1, SEQ, CFG.d_model),
                        generator=torch.Generator().manual_seed(4))
        assert torch.equal(
            api.compile_block(p, acfg, calibration=CalibrationSnapshot(),
                              **kw).apply(x),
            api.compile_block(p, acfg, **kw).apply(x))
