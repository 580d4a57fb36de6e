"""The port's signed-split analog VMM against the JAX package's.

The plain version (``ref.analog_mvm_split_ref``, two analog passes
subtracted) and the CPU route of the dispatching wrapper
(``ops.analog_mvm_split``) are held against the fused Pallas split kernel
run in interpret mode and against the reference's own dispatching wrapper
(``use_pallas=False``), on the same numpy inputs made from a seed.
Tolerances:

- integer effective weights: bit-exact (5-bit x 6-bit products summed
  over 128 rows stay below 2**24, so every dot is exact in fp32, and the
  gain/offset step rounds identically).
- rank-1 fixed-pattern gains (``w * row_gain * col_gain``): fp32 dot order
  differs between XLA and PyTorch, so an ADC code may differ at a
  rounding tie: every element within 1 LSB, at most 1 % of the elements
  differing - the reference's own contract at ADC ties
  (tests/test_calib.py).  Measured at these seeds: 0 differing elements.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
and ``chip_smoke.py`` hold it against its plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.analog_mvm import analog_mvm_split_pallas  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.analog_mvm import analog_mvm_split_cuda  # noqa: E402

# M and N are no multiple of a tile (either of the kernel's two tile
# heights); K covers 1, 2 and 3 chunks
SPLIT_SHAPES = [(1, 128, 1), (4, 256, 129), (17, 384, 70), (100, 128, 10)]
TIE_SHARE = 0.01


def _inputs(m, k, n, rank1):
    rng = np.random.default_rng(m * 1000 + k + n)
    a_pos = rng.integers(0, 32, (m, k)).astype(np.float32)
    a_neg = rng.integers(0, 32, (m, k)).astype(np.float32)
    # a signed activation has one nonzero part per element
    a_neg[a_pos > 15] = 0.0
    w = rng.integers(-63, 64, (k, n)).astype(np.float32)
    if rank1:
        row = 1 + 0.014 * rng.standard_normal(k)
        col = 1 + 0.014 * rng.standard_normal(n)
        w = (w * col[None, :] * row[:, None]).astype(np.float32)
    gain = np.full((n,), 0.02, np.float32)
    off = rng.standard_normal((k // 128, n)).astype(np.float32)
    return a_pos, a_neg, w, gain, off


def _assert_codes(got, want, rank1):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if not rank1:
        np.testing.assert_array_equal(got, want)
        return
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    assert (diff != 0).mean() <= TIE_SHARE


@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES)
@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("shift", [None, 3])
@pytest.mark.parametrize("rank1", [False, True])
def test_plain_version_vs_pallas_split_kernel(m, k, n, faithful, shift,
                                              rank1):
    args = _inputs(m, k, n, rank1)
    epi = None if shift is None else ("relu_shift", shift)
    want = analog_mvm_split_pallas(
        *(jnp.asarray(v) for v in args), faithful=faithful,
        interpret=True, epilogue=epi,
    )
    t = [torch.from_numpy(v) for v in args]
    got = ref.adc_epilogue_ref(
        ref.analog_mvm_split_ref(*t, faithful=faithful), epi)
    _assert_codes(got, want, rank1)


@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES)
@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("rank1", [False, True])
def test_cpu_route_vs_reference_wrapper(m, k, n, faithful, rank1):
    """The port's CPU route (faithful: the chunk scan; fast: the stacked
    plain version) against ``repro.kernels.ops.analog_mvm_split`` on its
    jnp route, and against the port's own plain version."""
    args = _inputs(m, k, n, rank1)
    want = jops.analog_mvm_split(*(jnp.asarray(v) for v in args), 128,
                                 faithful, False, True)
    t = [torch.from_numpy(v) for v in args]
    got = ops.analog_mvm_split(*t, faithful=faithful)
    _assert_codes(got, want, rank1)
    np.testing.assert_array_equal(
        got.numpy(), ref.analog_mvm_split_ref(*t, faithful=faithful).numpy())


def test_cpu_route_epilogue_matches_reference_infer():
    args = _inputs(9, 256, 40, False)
    epi = ("relu_shift", 2)
    want = jops.analog_mvm_infer(*(jnp.asarray(v) for v in args),
                                 use_pallas=False, epilogue=epi)
    got = ops.analog_mvm_split(*(torch.from_numpy(v) for v in args),
                               epilogue=epi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.min()) >= 0.0 and float(got.max()) <= 31.0


def test_no_offsets_means_zero_offsets():
    a_pos, a_neg, w, gain, _ = (torch.from_numpy(v)
                                for v in _inputs(5, 256, 20, True))
    got = ops.analog_mvm_split(a_pos, a_neg, w, gain, None)
    want = ops.analog_mvm_split(a_pos, a_neg, w, gain, torch.zeros((2, 20)))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_cuda_wrapper_refuses_cpu_tensors():
    """No fallback: the kernel's wrapper never runs the plain version."""
    t = [torch.from_numpy(v) for v in _inputs(4, 128, 8, False)]
    with pytest.raises(ValueError, match="CUDA"):
        analog_mvm_split_cuda(*t)
