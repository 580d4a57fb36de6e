"""The port's kernels (repro_torch.kernels) against the JAX package's.

Each plain PyTorch version is held against its JAX Pallas twin run in
interpret mode, on the same numpy inputs made from a seed.  Tolerances:

- max-min pooling: bit-exact (max and min are exact).
- analog VMM and whole-plan chain with integer effective weights: bit-
  exact (5-bit x 6-bit products summed over 128 rows stay below 2**24,
  so fp32 is exact in any order).
- with float gains (the fixed-pattern gain map), fp32 dot order differs
  between XLA and PyTorch, so an ADC code may differ by at most 1 LSB per
  chunk at a rounding tie, on at most 1% of the elements (the
  reference's own contract, tests/test_calib.py).  Measured at these
  seeds: 0 differing elements.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
and ``chip_smoke.py`` hold each against its plain version there.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.kernels.analog_mvm import analog_mvm_pallas  # noqa: E402
from repro.kernels.analog_plan import analog_plan_pallas  # noqa: E402
from repro.kernels.preproc import maxmin_pool_pallas  # noqa: E402
from repro.models.ecg import ecg_init as jecg_init  # noqa: E402
from repro.models.ecg import ecg_module_spec as jecg_spec  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.analog_mvm import analog_mvm_cuda  # noqa: E402
from repro_torch.kernels.analog_plan import analog_plan_cuda  # noqa: E402
from repro_torch.kernels.preproc import maxmin_pool_cuda  # noqa: E402
from repro_torch.models.ecg import ecg_module_spec  # noqa: E402

# M and N are no multiple of a tile; K covers 1, 2 and 3 chunks
MVM_SHAPES = [(1, 128, 1), (17, 256, 129), (33, 384, 70), (100, 128, 10)]
# share of elements that may differ (by <= 1 LSB per chunk) with float gains
TIE_SHARE = 0.01


def _mvm_inputs(m, k, n, float_gain):
    rng = np.random.default_rng(m * 1000 + k + n)
    a = rng.integers(0, 32, (m, k)).astype(np.float32)
    w = rng.integers(-63, 64, (k, n)).astype(np.float32)
    if float_gain:
        w = (w * (1 + 0.02 * rng.standard_normal((k, n)))).astype(np.float32)
    gain = np.full((n,), 0.02, np.float32)
    off = rng.standard_normal((k // 128, n)).astype(np.float32)
    return a, w, gain, off


def _assert_codes(got, want, n_chunks, float_gain):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if not float_gain:
        np.testing.assert_array_equal(got, want)
        return
    diff = np.abs(got - want)
    assert diff.max() <= n_chunks
    assert (diff != 0).mean() <= TIE_SHARE


class TestMaxminPool:
    def test_ref_bit_exact_vs_pallas(self):
        rng = np.random.default_rng(0)
        # T/32 = 126 outputs per row: no multiple of the Pallas 128-tile
        x = rng.integers(-2048, 2048, (6, 4032)).astype(np.float32)
        want = np.asarray(maxmin_pool_pallas(jnp.asarray(x), interpret=True))
        got = ref.maxmin_pool_ref(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)
        # the CPU wrapper runs the plain version, batch dims preserved
        got3 = ops.maxmin_pool(torch.from_numpy(x).reshape(3, 2, 4032))
        np.testing.assert_array_equal(got3.reshape(6, 126).numpy(), want)


class TestAnalogMVM:
    @pytest.mark.parametrize("m,k,n", MVM_SHAPES)
    @pytest.mark.parametrize("faithful", [True, False])
    @pytest.mark.parametrize("shift", [None, 2])
    @pytest.mark.parametrize("float_gain", [False, True])
    def test_ref_vs_pallas(self, m, k, n, faithful, shift, float_gain):
        a, w, gain, off = _mvm_inputs(m, k, n, float_gain)
        epi = None if shift is None else ("relu_shift", shift)
        want = analog_mvm_pallas(
            jnp.asarray(a), jnp.asarray(w), jnp.asarray(gain),
            jnp.asarray(off), faithful=faithful, interpret=True,
            epilogue=epi,
        )
        t = [torch.from_numpy(v) for v in (a, w, gain, off)]
        got = ops.analog_mvm(*t, faithful=faithful, epilogue=epi)
        _assert_codes(got, want, k // 128, float_gain)

    def test_no_offsets_means_zero_offsets(self):
        a, w, gain, off = _mvm_inputs(9, 256, 20, False)
        t = [torch.from_numpy(v) for v in (a, w, gain)]
        got = ops.analog_mvm(*t, None)
        want = ops.analog_mvm(*t, torch.zeros((2, 20)))
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@functools.lru_cache(maxsize=None)
def _ecg_packs(float_gain):
    """The JAX and the port's megakernel pack of the relu_shift ECG chain,
    built from the same JAX-initialized parameters."""
    from repro.core.noise import NOISELESS
    from repro.models.ecg import ECGConfig as JECGConfig

    jcfg = JECGConfig() if float_gain else JECGConfig(noise=NOISELESS)
    params = jecg_init(jax.random.PRNGKey(3), jcfg)
    jplan = japi.compile(jecg_spec(jcfg, epilogue="relu_shift"), params,
                         JAnalogConfig()).lower()
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tplan = api.compile(ecg_module_spec(epilogue="relu_shift"), tparams,
                        AnalogConfig(), device="cpu").lower()
    return jplan.mega, tplan.mega


class TestAnalogPlan:
    @pytest.mark.parametrize("faithful", [True, False])
    @pytest.mark.parametrize("float_gain", [False, True])
    def test_ref_vs_pallas_on_ecg_pack(self, faithful, float_gain):
        jmega, tmega = _ecg_packs(float_gain)
        rng = np.random.default_rng(7)
        b = 3
        x = rng.integers(0, 32, (b * 32, 128)).astype(np.float32)
        want = analog_plan_pallas(
            jnp.asarray(x), jmega.w_cat, jmega.gain, jmega.off,
            schedule=jmega.schedule, faithful=faithful, block_b=2,
            interpret=True,
        )
        got = ref.analog_plan_ref(
            torch.from_numpy(x), tmega.w_cat, tmega.gain, tmega.off,
            tmega.schedule, faithful=faithful,
        )
        assert tuple(got.shape) == (b, 10)
        _assert_codes(got, want, 1, float_gain)
        np.testing.assert_array_equal(
            ops.analog_plan_codes(torch.from_numpy(x), tmega.w_cat,
                                  tmega.gain, tmega.off,
                                  schedule=tmega.schedule,
                                  faithful=faithful).numpy(),
            got.numpy())

    def test_ref_refuses_float_domain_schedule(self):
        _, tmega = _ecg_packs(False)
        sched = (tmega.schedule[0]._replace(handoff="relu"),
                 *tmega.schedule[1:])
        x = torch.zeros((32, 128))
        with pytest.raises(ValueError, match="code-domain"):
            ref.analog_plan_ref(x, tmega.w_cat, tmega.gain, tmega.off, sched)


class TestNoFallback:
    """A CUDA wrapper given a CPU tensor raises; it never runs the plain
    version in the kernel's place."""

    def test_cuda_wrappers_refuse_cpu_tensors(self):
        x = torch.zeros((2, 64))
        with pytest.raises(ValueError, match="CUDA"):
            maxmin_pool_cuda(x)
        a, w, gain, off = (torch.from_numpy(v)
                           for v in _mvm_inputs(4, 128, 8, False))
        with pytest.raises(ValueError, match="CUDA"):
            analog_mvm_cuda(a, w, gain, off)
        _, tmega = _ecg_packs(False)
        with pytest.raises(ValueError, match="CUDA"):
            analog_plan_cuda(torch.zeros((32, 128)), tmega.w_cat,
                             tmega.gain, tmega.off, schedule=tmega.schedule)
