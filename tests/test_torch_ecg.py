"""The port's ECG main path (repro_torch) against the JAX package: raw
records -> preprocessing -> lowering -> logits, on the CPU.

Parameters come from ``repro.models.ecg.ecg_init`` and are carried across
with ``repro_torch.convert.params_from_numpy``; records come from the
numpy generator both packages share.  Tolerances:

- preprocessing, lowering (codes, effective weights, pack): bit-exact.
- logits with NOISELESS weights: bit-exact (integer effective weights).
- logits with the full fixed-pattern gain map: argmax equal and every
  logit within 1e-5 (fp32 dot order differs between XLA and PyTorch, so
  an ADC code may flip at a rounding tie); measured here: bit-exact.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.analog import _statistical_gain as jstat_gain  # noqa: E402
from repro.core.noise import NOISELESS as JNOISELESS  # noqa: E402
from repro.data.ecg_synth import ECGDatasetConfig, make_dataset  # noqa: E402
from repro.data.preprocess import preprocess_batch  # noqa: E402
from repro.models.ecg import ECGConfig as JECGConfig  # noqa: E402
from repro.models.ecg import ecg_init as jecg_init  # noqa: E402
from repro.models.ecg import ecg_module_spec as jecg_spec  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import analog as t_analog  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.noise import NOISELESS  # noqa: E402
from repro_torch.data import ecg_synth as t_synth  # noqa: E402
from repro_torch.data.preprocess import preprocess  # noqa: E402
from repro_torch.models.ecg import ECGConfig, ecg_init, ecg_module_spec  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
FULL_MAP_TOL = 1e-5
_RAW = make_dataset(ECGDatasetConfig(n_test=4), "test")[0]
_JPARAMS = {}
_JLOGITS = {}


def _jparams(noiseless: bool):
    if noiseless not in _JPARAMS:
        cfg = JECGConfig(noise=JNOISELESS) if noiseless else JECGConfig()
        _JPARAMS[noiseless] = (cfg, jecg_init(jax.random.PRNGKey(11), cfg))
    return _JPARAMS[noiseless]


def _tparams(noiseless: bool):
    return params_from_numpy(
        jax.tree.map(np.asarray, _jparams(noiseless)[1]), "cpu")


def _jax_logits(epilogue, mode, use_kernels, megakernel, noiseless=False):
    key = (epilogue, mode, use_kernels, megakernel, noiseless)
    if key not in _JLOGITS:
        cfg, params = _jparams(noiseless)
        model = japi.compile(
            jecg_spec(cfg, epilogue=epilogue), params,
            JAnalogConfig(mode=mode, use_pallas=use_kernels,
                          fused_epilogue=True))
        _JLOGITS[key] = np.asarray(
            model.apply(preprocess_batch(_RAW), megakernel=megakernel))
    return _JLOGITS[key]


def _port_model(epilogue, mode, use_kernels, noiseless=False, **kw):
    return api.compile(
        ecg_module_spec(ECGConfig(), epilogue=epilogue),
        _tparams(noiseless),
        AnalogConfig(mode=mode, use_kernels=use_kernels, fused_epilogue=True,
                     **kw),
        device="cpu")


class TestPreprocess:
    def test_bit_exact_vs_reference(self):
        raw = make_dataset(ECGDatasetConfig(n_test=6), "test")[0]
        want = np.asarray(preprocess_batch(raw))
        got = preprocess(raw, device="cpu")
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)

    def test_generator_copy_matches_reference(self):
        cfg = ECGDatasetConfig(n_test=3)
        want, wl = make_dataset(cfg, "test")
        got, gl = t_synth.make_dataset(t_synth.ECGDatasetConfig(n_test=3),
                                       "test")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(gl, wl)


class TestLowering:
    @pytest.mark.parametrize("noiseless", [False, True])
    def test_stack_and_pack_equal_reference(self, noiseless):
        cfg, params = _jparams(noiseless)
        jplan = japi.compile(jecg_spec(cfg, epilogue="relu_shift"), params,
                             JAnalogConfig()).lower()
        tplan = _port_model("relu_shift", "analog_faithful", True,
                            noiseless).lower()
        assert tplan.input_domain == jplan.input_domain == "codes"
        for jl, tl in zip(jplan.layers, tplan.layers):
            assert tl.store.codes.dtype == torch.int8
            np.testing.assert_array_equal(tl.store.codes.numpy(),
                                          np.asarray(jl.store.codes))
            np.testing.assert_array_equal(tl.w_eff.numpy(),
                                          np.asarray(jl.w_eff))
            assert (tl.k, tl.n, tl.k_pad, tl.shift, tl.epilogue,
                    tl.flatten_out) == (jl.k, jl.n, jl.k_pad, jl.shift,
                                        jl.epilogue, jl.flatten_out)
        jm, tm = jplan.mega, tplan.mega
        assert [tuple(m) for m in tm.schedule] == [tuple(m)
                                                    for m in jm.schedule]
        assert tm.n_max == jm.n_max == 256
        for name in ("w_cat", "gain", "off"):
            np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                          np.asarray(getattr(jm, name)))
        assert tm.deq is None and jm.deq is None

    def test_derived_weights_are_built_once(self):
        """w_eff, the gain row and the pack's w_cat are derived at lower
        time and kept: an apply reads them, it does not rebuild them."""
        model = _port_model("relu_shift", "analog_faithful", True)
        plan = model.lower()
        before = [(lp.w_eff, lp.gain_row) for lp in plan.layers]
        w_cat = plan.mega.w_cat
        for mk in (True, False):
            model.apply(preprocess(_RAW, device="cpu"), megakernel=mk)
        for lp, (w_eff, gain_row) in zip(plan.layers, before):
            assert lp.w_eff is w_eff and lp.gain_row is gain_row
            st = lp.store
            assert torch.equal(w_eff, st.codes.to(torch.float32) * st.gain_map)
            assert gain_row.is_contiguous()
            assert torch.equal(gain_row, st.gain.expand(lp.n))
        assert plan.mega.w_cat is w_cat
        for lp, meta in zip(plan.layers, plan.mega.schedule):
            block = w_cat[meta.row0:meta.row0 + lp.k_pad]
            assert torch.equal(block[:, :lp.n], lp.w_eff)
            assert not block[:, lp.n:].any()

    @pytest.mark.parametrize("k", [100, 256])
    def test_rank1_layer_equals_reference(self, k):
        """The default (rank-1) fixed pattern: row gains padded with exact
        1.0 to the chunk width, then the reference's multiply order."""
        from repro.core.analog import analog_linear_init as jinit
        from repro.exec.lower import lower_layer as jlower
        from repro_torch.exec.lower import lower_layer

        p = jinit(jax.random.PRNGKey(5), k, 24)
        assert set(p["fpn"]) == {"row_gain", "col_gain", "chunk_offset"}
        want = jlower(p, JAnalogConfig())
        got = lower_layer(params_from_numpy(jax.tree.map(np.asarray, p),
                                            "cpu"), AnalogConfig())
        np.testing.assert_array_equal(got.store.codes.numpy(),
                                      np.asarray(want.store.codes))
        np.testing.assert_array_equal(got.w_eff.numpy(),
                                      np.asarray(want.w_eff))
        np.testing.assert_array_equal(got.chunk_offset.numpy(),
                                      np.asarray(want.chunk_offset))

    def test_static_float_chain_pack_equals_reference(self):
        """A static-calibration float-glue chain packs the in-kernel
        dequant/bias/encode rows (stage b of the whole-plan kernel)."""
        cfg, params = _jparams(False)
        jplan = japi.compile(jecg_spec(cfg, epilogue="none"), params,
                             JAnalogConfig(act_calib="static")).lower()
        tplan = _port_model("none", "analog_faithful", True,
                            act_calib="static").lower()
        jm, tm = jplan.mega, tplan.mega
        assert [tuple(m) for m in tm.schedule] == [tuple(m)
                                                    for m in jm.schedule]
        for name in ("w_cat", "gain", "off", "deq", "bias", "enc"):
            np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                          np.asarray(getattr(jm, name)))


class TestEndToEnd:
    @pytest.mark.parametrize("use_kernels", [True, False])
    @pytest.mark.parametrize("megakernel", [True, False, "auto"])
    @pytest.mark.parametrize("mode", ["analog_faithful", "analog_fast"])
    @pytest.mark.parametrize("epilogue", ["relu_shift", "none"])
    def test_logits_match_reference(self, epilogue, mode, megakernel,
                                    use_kernels):
        model = _port_model(epilogue, mode, use_kernels)
        x = preprocess(_RAW, device="cpu")
        if epilogue == "none" and megakernel is True:
            # dynamic calibration keeps the float chain per-layer in both
            with pytest.raises(ValueError, match="act_calib='static'"):
                model.apply(x, megakernel=True)
            with pytest.raises(ValueError, match="act_calib='static'"):
                _jax_logits(epilogue, mode, use_kernels, True)
            return
        # "auto" takes the route the plan is eligible for
        route = (epilogue == "relu_shift") if megakernel == "auto" \
            else megakernel
        want = _jax_logits(epilogue, mode, use_kernels, route)
        got = model.apply(x, megakernel=megakernel).numpy()
        assert got.shape == want.shape == (len(_RAW), 2)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, rtol=0, atol=FULL_MAP_TOL)

    @pytest.mark.parametrize("epilogue,megakernel", [
        ("relu_shift", True), ("relu_shift", False), ("none", False)])
    def test_noiseless_logits_bit_exact(self, epilogue, megakernel):
        model = _port_model(epilogue, "analog_faithful", True, noiseless=True)
        got = model.apply(preprocess(_RAW, device="cpu"),
                          megakernel=megakernel)
        want = _jax_logits(epilogue, "analog_faithful", True, megakernel,
                           noiseless=True)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_float_domain_megakernel_routes_per_layer(self):
        """A static float-glue chain (unsigned encodes, relu hand-offs
        with the im2col flatten) takes the whole-plan route: with
        megakernel=True it matches the reference's megakernel within the
        full-map tolerance, bit-exact under NOISELESS, and equals the
        port's own per-layer replay bit for bit."""
        x = preprocess(_RAW, device="cpu")
        for noiseless in (False, True):
            model = _port_model("none", "analog_faithful", True, noiseless,
                                act_calib="static")
            cfg, params = _jparams(noiseless)
            jmodel = japi.compile(
                jecg_spec(cfg, epilogue="none"), params,
                JAnalogConfig(use_pallas=True, fused_epilogue=True,
                              act_calib="static"))
            want = np.asarray(jmodel.apply(preprocess_batch(_RAW),
                                           megakernel=True))
            got = model.apply(x, megakernel=True).numpy()
            np.testing.assert_array_equal(
                got, model.apply(x, megakernel=False).numpy())
            if noiseless:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=FULL_MAP_TOL)


class TestInit:
    def test_ecg_init_shapes_dtypes_and_fixed_pattern(self):
        got = ecg_init(torch.Generator().manual_seed(0), device="cpu")
        _, want = _jparams(False)
        for layer in ("conv", "fc1", "fc2"):
            for k, v in want[layer].items():
                if isinstance(v, dict):
                    for kk, vv in v.items():
                        assert tuple(got[layer][k][kk].shape) == vv.shape
                        assert got[layer][k][kk].dtype == torch.float32
                else:
                    assert tuple(got[layer][k].shape) == v.shape
                    assert got[layer][k].dtype == torch.float32
        gain = torch.cat([got[l]["fpn"]["gain"].reshape(-1)
                          for l in ("conv", "fc1", "fc2")])
        off = torch.cat([got[l]["fpn"]["chunk_offset"].reshape(-1)
                         for l in ("conv", "fc1", "fc2")])
        # ~33k gain draws: mean 1, spread 0.02; 264 offset draws: spread 1
        assert abs(float(gain.mean()) - 1.0) < 1e-3
        assert abs(float(gain.std()) - 0.02) < 1e-3
        assert abs(float(off.std()) - 1.0) < 0.15
        # the same generator seed gives the same parameters
        again = ecg_init(torch.Generator().manual_seed(0), device="cpu")
        assert torch.equal(again["fc1"]["w"], got["fc1"]["w"])

    def test_scales_and_gain_match_reference(self):
        _, params = _jparams(False)
        for layer in ("conv", "fc1", "fc2"):
            w = np.array(params[layer]["w"])
            tw = torch.from_numpy(w)
            np.testing.assert_array_equal(
                t_analog.quant.calibrate_weight_scale(tw).numpy(),
                np.asarray(params[layer]["w_scale"]))
            np.testing.assert_allclose(
                float(t_analog._statistical_gain(tw, 128)),
                float(jstat_gain(jax.numpy.asarray(w), 128)), rtol=1e-6)

    def test_noiseless_init_has_no_fixed_pattern(self):
        got = ecg_init(torch.Generator().manual_seed(0),
                       ECGConfig(noise=NOISELESS), device="cpu")
        assert all("fpn" not in got[l] for l in ("conv", "fc1", "fc2"))


class TestDevice:
    def test_entry_points_default_to_cuda_and_raise_without_it(
            self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        spec = ecg_module_spec(epilogue="relu_shift")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.compile(spec, _tparams(False), AnalogConfig())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            preprocess(_RAW)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ecg_init(torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_analog.analog_linear_init(torch.Generator(), 8, 4)

    def test_plain_route_refuses_cuda_tensors(self):
        """use_kernels=False is the CPU parity route: a CUDA operand under
        it raises in run() and analog_matmul, before any work."""
        from types import SimpleNamespace

        from repro_torch.exec.run import run

        on_card = SimpleNamespace(device=torch.device("cuda"))
        plain = AnalogConfig(use_kernels=False)
        with pytest.raises(ValueError, match="use_kernels=False"):
            t_analog.check_route(plain, on_card)
        t_analog.check_route(AnalogConfig(), on_card)
        t_analog.check_route(plain, torch.zeros(1))
        model = _port_model("relu_shift", "analog_faithful", False)
        for mk in (True, False):
            with pytest.raises(ValueError, match="use_kernels=False"):
                run(model.lower(), on_card, megakernel=mk)
        with pytest.raises(ValueError, match="use_kernels=False"):
            t_analog.analog_matmul(on_card, None, None, None, plain)

    def test_port_imports_neither_jax_nor_reference(self):
        code = (
            "import sys\n"
            "import repro_torch.models.ecg, repro_torch.api\n"
            "import repro_torch.kernels.ops, repro_torch.convert\n"
            "import repro_torch.configs, repro_torch.models.transformer\n"
            "import repro_torch.serve, repro_torch.serve.serve_step\n"
            "import repro_torch.kernels.analog_plan, repro_torch.exec.lower\n"
            "import repro_torch.exec.run, repro_torch.models.attention\n"
            "for name in repro_torch.configs.ARCH_NAMES:\n"
            "    repro_torch.configs.get_arch(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
        )
        env = dict(os.environ, PYTHONPATH=SRC)
        res = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
