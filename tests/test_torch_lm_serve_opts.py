"""The port's two remaining LM serving options against the JAX package's,
on the CPU (``phi4-mini-3.8b-smoke``): the int8 KV cache through
``make_serve_steps``, and offset-encoded activations
(``signed_input="offset"``) for one layer, a fused QKV group, the
scan-stacked tree and a whole served call.

Both packages compute with the reference's weights (``lm_init``, its
fixed pattern swapped for ``NOISELESS`` where stated, so the effective
weights are integers) and the same numpy inputs, at fp32 activations.
Tolerances:

- int8 cache: the scales within 1e-6 relative (RoPE and the norms run
  their fp32 transcendentals in another order, so ``max|k|`` may differ
  in its last bit); the int8 codes equal but for rounding ties moved by
  that last bit (at most 1 apart, on at most 0.1 % of the entries;
  measured: equal); logits within ``1e-5 * max|logit|``, equal greedy
  tokens.
- offset encoding: ``colsum`` equal (integer effective weights: the
  column sums are exact in any order) or within 1e-6 relative (the
  default rank-1 pattern); ADC codes within 1 LSB, on at most 1 % of the
  readouts (the reference's contract at rounding ties, the derated gain
  being a float; measured: equal); the served logits at static
  calibration within ``1e-4 * max|logit|`` (measured: 2e-7) and equal
  greedy tokens.
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
from repro.core import quant as jq  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.noise import NOISELESS as JNOISELESS  # noqa: E402
from repro.exec.lower import lower_fused as j_lower_fused  # noqa: E402
from repro.exec.lower import lower_layer as j_lower_layer  # noqa: E402
from repro.exec.run import run_layer as j_run_layer  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import serve_step as JSS  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.noise import NOISELESS  # noqa: E402
from repro_torch.exec import run as trun  # noqa: E402
from repro_torch.exec.lower import lower_fused, lower_layer  # noqa: E402
from repro_torch.exec.plan import PlanStack  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import serve_step as SS  # noqa: E402

ARCH = "phi4-mini-3.8b"
CFG = configs.get_smoke(ARCH)
JCFG = jconfigs.get_smoke(ARCH)
TIE_SHARE = 0.01


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _runs(noiseless=True, signed="split"):
    jn = JNOISELESS if noiseless else JAnalogConfig().noise
    tn = NOISELESS if noiseless else AnalogConfig().noise
    return (JRunConfig(analog=JAnalogConfig(mode="analog_faithful", noise=jn,
                                            signed_input=signed),
                       activation_dtype="float32"),
            RunConfig(analog=AnalogConfig(mode="analog_faithful", noise=tn,
                                          signed_input=signed),
                      activation_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _params(noiseless=True):
    saved = JT.NOISE
    JT.NOISE = JNOISELESS if noiseless else saved
    try:
        jp = JT.lm_init(jax.random.PRNGKey(0), JCFG)
    finally:
        JT.NOISE = saved
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@functools.lru_cache(maxsize=None)
def _models(noiseless=True, signed="split"):
    jp, tp = _params(noiseless)
    jrun, run = _runs(noiseless, signed)
    return (japi.compile(JT.lm_module_spec(JCFG, jp), jp, jrun),
            api.compile(T.lm_module_spec(CFG, tp), tp, run, device="cpu"))


def _serve(jm, tm, cache_dtype, *, batch=2, prompt=6, steps=3, max_len=16):
    """Prefill and greedy decode through both packages' serve steps;
    returns the per-call (reference, port) logits and the final caches."""
    jrun, run = jm.run_cfg, tm.run_cfg
    jpf, jdc = JSS.make_serve_steps(JCFG, jrun)
    pf, dc = SS.make_serve_steps(CFG, run)
    jc = JT.init_lm_cache(JCFG, batch, max_len, dtype=cache_dtype[0])
    tc = T.init_lm_cache(CFG, batch, max_len, dtype=cache_dtype[1],
                         device="cpu")
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size,
                                             (batch, prompt))
    jl, jc = jpf(jm.lower(), {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = pf(tm.lower(), {"tokens": torch.from_numpy(toks)}, tc)
    out = [(np.asarray(jl), _np(tl))]
    for _ in range(steps):
        nxt = np.asarray(jl).argmax(-1)[:, None]
        jl, jc = jdc(jm.lower(), jnp.asarray(nxt), jc)
        tl, tc = dc(tm.lower(), torch.from_numpy(nxt), tc)
        out.append((np.asarray(jl), _np(tl)))
    return out, jc, tc


class TestInt8Cache:
    def test_init_cache_layout(self):
        jc = JT.init_lm_cache(JCFG, 2, 8, dtype=jnp.int8)
        tc = T.init_lm_cache(CFG, 2, 8, dtype=torch.int8, device="cpu")
        ja, ta = jc["layers"]["l0"]["attn"], tc["layers"]["l0"]["attn"]
        assert set(ta) == set(ja)
        for k in ("k", "v", "k_scale", "v_scale"):
            assert tuple(ta[k].shape) == ja[k].shape
            assert str(ta[k].dtype).split(".")[-1] == str(ja[k].dtype)
        assert ta["len"] == [0] * CFG.n_layers

    def test_serve_steps_match_reference(self):
        jm, tm = _models()
        out, jc, tc = _serve(jm, tm, (jnp.int8, torch.int8))
        for jl, tl in out:
            np.testing.assert_allclose(tl, jl, rtol=0,
                                       atol=1e-5 * np.abs(jl).max())
            np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
        ja, ta = jc["layers"]["l0"]["attn"], tc["layers"]["l0"]["attn"]
        assert ta["len"] == [int(x) for x in ja["len"]] == [9] * CFG.n_layers
        for k in ("k_scale", "v_scale"):
            np.testing.assert_allclose(_np(ta[k]), np.asarray(ja[k]),
                                       rtol=1e-6, atol=0)
        for k in ("k", "v"):
            got, want = _np(ta[k]).astype(int), np.asarray(ja[k]).astype(int)
            assert np.abs(got - want).max() <= 1
            assert np.mean(got != want) <= 1e-3
        assert int(tc["step"]) == int(jc["step"]) == 9

    def test_int8_gap_to_float_cache_matches_reference(self):
        """The logits of the int8 cache against the float cache's: the
        port's gap is the reference's own.  (The reference's "<1 % logit
        error" does not hold through the analog projections of this
        smoke model: 13-17 % of max|logit| in both packages, since the
        dynamic 5-bit encodings downstream of attention turn the int8
        keys' and values' rounding into whole code steps; the greedy
        tokens stay equal.)"""
        jm, tm = _models()
        out8, _, tc = _serve(jm, tm, (jnp.int8, torch.int8))
        out32, _, _ = _serve(jm, tm, (jnp.float32, torch.float32))
        for (j8, t8), (j32, t32) in zip(out8, out32):
            gap_t = np.abs(t8 - t32).max() / np.abs(t32).max()
            gap_j = np.abs(j8 - j32).max() / np.abs(j32).max()
            assert abs(gap_t - gap_j) <= 1e-5
            np.testing.assert_array_equal(t8.argmax(-1), t32.argmax(-1))
        ck = tc["layers"]["l0"]["attn"]["k"]
        assert ck.dtype == torch.int8 and int(ck.abs().max()) == 127


class TestOffsetEncoding:
    def _codes_within_contract(self, got, want, lsb):
        """Outputs as ADC codes (divided by each column's LSB): within 1
        code, and unequal on at most TIE_SHARE of the readouts."""
        d = np.abs(_np(got) - np.asarray(want)) / np.asarray(lsb)
        assert d.max() <= 1.0 + 1e-3
        assert np.mean(d > 0.5) <= TIE_SHARE

    @staticmethod
    def _lsb(x, lp_j, acfg):
        """The dequantization step of one ADC code of the offset route."""
        a_scale = jq.act_scale_from_max(jnp.abs(x).max() + 1e-9) * 2.0
        rms, half = acfg.act_rms_codes, 16.0
        gain = lp_j.gain * rms / jnp.sqrt(rms ** 2 + half ** 2)
        return np.asarray(a_scale * lp_j.w_scale.reshape(-1) / gain)

    @pytest.mark.parametrize("noiseless", [True, False])
    def test_layer(self, noiseless):
        jp, tp = _params(noiseless)
        jrun, run = _runs(noiseless, "offset")
        sl = lambda t: jax.tree.map(lambda a: a[1], t)  # noqa: E731
        jlayer = sl(jp["layers"]["l0"]["mlp"]["down"])
        tlayer = T.stack_index(tp["layers"], 1)["l0"]["mlp"]["down"]
        jlp = j_lower_layer(jlayer, jrun.analog)
        tlp = lower_layer(tlayer, run.analog)
        assert tlp.signed_input == jlp.signed_input == "offset"
        self._colsum(tlp.colsum, jlp.colsum, noiseless)
        x = np.random.default_rng(2).standard_normal(
            (3, 5, tlp.k)).astype(np.float32)
        want = j_run_layer(jlp, jnp.asarray(x), jrun.analog)
        trun.reset_dispatch_count()
        got = trun.run_layer(tlp, torch.tensor(x), run.analog)
        assert trun.dispatch_count() == 1
        self._codes_within_contract(got, want, self._lsb(x, jlp, jrun.analog))

    @staticmethod
    def _colsum(got, want, exact):
        if exact:
            np.testing.assert_array_equal(_np(got), np.asarray(want))
        else:
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())

    @pytest.mark.parametrize("noiseless", [True, False])
    def test_fused_qkv_group(self, noiseless):
        jp, tp = _params(noiseless)
        jrun, run = _runs(noiseless, "offset")
        sl = lambda t: jax.tree.map(lambda a: a[0], t)  # noqa: E731
        jattn = sl(jp["layers"]["l0"]["attn"])
        tattn = T.stack_index(tp["layers"], 0)["l0"]["attn"]
        names = ("wq", "wk", "wv")
        jlp = j_lower_fused([jattn[m] for m in names], jrun.analog)
        tlp = lower_fused([tattn[m] for m in names], run.analog)
        self._colsum(tlp.colsum, jlp.colsum, noiseless)
        assert tlp.colsum.shape == (tlp.n,)
        x = np.random.default_rng(3).standard_normal(
            (2, 7, tlp.k)).astype(np.float32)
        want = j_run_layer(jlp, jnp.asarray(x), jrun.analog)
        got = trun.run_layer(tlp, torch.tensor(x), run.analog)
        self._codes_within_contract(got, want, self._lsb(x, jlp, jrun.analog))

    def test_scan_stack_colsum(self):
        jm, tm = _models(True, "offset")
        jt, tt = jm.lower(), tm.lower()
        stack = tt["layers"]["l0"]["attn"]["_groups"]["qkv"]
        assert isinstance(stack, PlanStack)
        jcs = jt["layers"]["l0"]["attn"]["_groups"]["qkv"].fused.colsum
        assert jcs.shape == (CFG.n_layers, stack[0].fused.n)
        for i, gp in enumerate(stack):
            np.testing.assert_array_equal(_np(gp.fused.colsum),
                                          np.asarray(jcs[i]))
        for i, lp in enumerate(tt["layers"]["l0"]["mlp"]["down"]["_plan"]):
            np.testing.assert_array_equal(
                _np(lp.colsum),
                np.asarray(jt["layers"]["l0"]["mlp"]["down"]["_plan"]
                           .colsum[i]))

    def test_served_call_static_calibration(self):
        """Served through ``make_serve_steps`` at static calibration.
        (Under dynamic calibration the abs-max element encodes at exactly
        +-15.5 before rounding in EVERY call - the offset route doubles
        the LSB that maps the abs-max to 31 - so the last-bit differences
        of RoPE and the norms flip that tie, and a flipped input code
        moves every output column: 21-26 % of max|logit| in this smoke
        model.  The layers themselves agree bit for bit above.)"""
        jp, tp = _params(True)
        jrun, run = _runs(True, "offset")
        jrun = dataclasses.replace(jrun, analog=jrun.analog.replace(
            act_calib="static"))
        run = dataclasses.replace(run, analog=run.analog.replace(
            act_calib="static"))
        jm = japi.compile(JT.lm_module_spec(JCFG, jp), jp, jrun)
        tm = api.compile(T.lm_module_spec(CFG, tp), tp, run, device="cpu")
        trun.reset_dispatch_count()
        out, _, _ = _serve(jm, tm, (jnp.float32, torch.float32), steps=2)
        # one analog dispatch per layer and call (static calibration keeps
        # q, k and v apart: 7 per block) + the lm_head
        assert trun.dispatch_count() == 3 * (7 * CFG.n_layers + 1)
        for jl, tl in out:
            np.testing.assert_allclose(tl, jl, rtol=0,
                                       atol=1e-4 * np.abs(jl).max())
            np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))

    def test_two_pass_split_matches_fused(self):
        """``fused_split=False`` (two ``analog_mvm`` passes) gives the
        fused split's values bit for bit, with two dispatches a layer."""
        jm, tm = _models(True, "split")
        _, run = _runs(True, "split")
        run2 = dataclasses.replace(run, analog=run.analog.replace(
            fused_split=False))
        toks = torch.from_numpy(np.random.default_rng(4).integers(
            0, CFG.vocab_size, (2, 5)))
        want, _, _ = T.lm_apply(tm.lower(), {"tokens": toks}, CFG, run)
        trun.reset_dispatch_count()
        got, _, _ = T.lm_apply(tm.lower(), {"tokens": toks}, CFG, run2)
        assert trun.dispatch_count() == 2 * (5 * CFG.n_layers + 1)
        np.testing.assert_array_equal(_np(got), _np(want))
