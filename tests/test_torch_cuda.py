"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device (and nvcc, to build the
kernels at first use) and skips without one; the file imports only
torch and the port, so it runs where JAX is not installed:

    python3 -m pytest -q tests/test_torch_cuda.py

Tolerance: bit-exact throughout (integer effective weights; the kernels
repeat the plain versions' per-chunk arithmetic), and equal greedy tokens
for the smoke LM served on the card and on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.noise import NoiseConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.analog_mvm import (  # noqa: E402
    analog_mvm_cuda, analog_mvm_split_cuda)
from repro_torch.kernels.analog_plan import analog_plan_cuda  # noqa: E402
from repro_torch.kernels.preproc import maxmin_pool_cuda  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.ecg import ECGConfig, ecg_init, ecg_module_spec  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

# M and N are no multiple of a tile; K covers 1, 2 and 3 chunks
MVM_SHAPES = [(1, 128, 1), (17, 256, 129), (33, 384, 70), (100, 128, 10)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _mvm_inputs(m, k, n, device):
    rng = np.random.default_rng(m * 1000 + k + n)
    a = rng.integers(0, 32, (m, k)).astype(np.float32)
    w = rng.integers(-63, 64, (k, n)).astype(np.float32)
    gain = np.full((n,), 0.02, np.float32)
    off = rng.standard_normal((k // 128, n)).astype(np.float32)
    return [torch.from_numpy(v).to(device) for v in (a, w, gain, off)]


def test_maxmin_pool(cuda):
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -2048, 2048, (1000, 4032)).astype(np.float32)).to(cuda)
    assert torch.equal(maxmin_pool_cuda(x), ref.maxmin_pool_ref(x))


@pytest.mark.parametrize("m,k,n", MVM_SHAPES)
@pytest.mark.parametrize("faithful", [True, False])
def test_analog_mvm(cuda, m, k, n, faithful):
    t = _mvm_inputs(m, k, n, cuda)
    for epi in (None, ("relu_shift", 2)):
        got = analog_mvm_cuda(*t, faithful=faithful, epilogue=epi)
        want = ref.adc_epilogue_ref(ref.analog_mvm_ref(*t, faithful=faithful),
                                    epi)
        assert torch.equal(got, want)


# the split kernel's two tile heights (M <= 16 and M > 16) and ragged N
SPLIT_SHAPES = [(4, 128, 1), (16, 256, 129), (17, 384, 70), (48, 128, 200)]


def _split_inputs(m, k, n, device):
    """Integer w_eff with a dyadic gain and offsets: every partial sum is
    exact in fp32, so the kernel must equal the plain version bit for bit
    in both modes whatever the summation order."""
    rng = np.random.default_rng(m * 1000 + k + n)
    a_pos = rng.integers(0, 32, (m, k)).astype(np.float32)
    a_neg = rng.integers(0, 32, (m, k)).astype(np.float32)
    w = rng.integers(-63, 64, (k, n)).astype(np.float32)
    gain = np.full((n,), 1 / 64, np.float32)
    off = (rng.integers(-16, 17, (k // 128, n)) / 8).astype(np.float32)
    return [torch.from_numpy(v).to(device)
            for v in (a_pos, a_neg, w, gain, off)]


@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES)
@pytest.mark.parametrize("faithful", [True, False])
def test_analog_mvm_split(cuda, m, k, n, faithful):
    t = _split_inputs(m, k, n, cuda)
    for epi in (None, ("relu_shift", 2)):
        got = analog_mvm_split_cuda(*t, faithful=faithful, epilogue=epi)
        want = ref.adc_epilogue_ref(
            ref.analog_mvm_split_ref(*t, faithful=faithful), epi)
        assert torch.equal(got, want)
        # the dispatching wrapper launches the same kernel
        assert torch.equal(ops.analog_mvm_split(*t, faithful=faithful,
                                                epilogue=epi), got)


def _ecg_model(device, **run_kw):
    # the parameters are drawn (and their gains reduced) on the CPU, then
    # compiled for ``device``: ecg_init on two devices gives gains that
    # differ in the last bit (the mean reduces in another order)
    cfg = ECGConfig(noise=NoiseConfig(gain_std=0.0, mode="full"))
    params = ecg_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    return api.compile(ecg_module_spec(cfg, epilogue="relu_shift"), params,
                       AnalogConfig(fused_epilogue=True, **run_kw),
                       device=device)


@pytest.mark.parametrize("faithful", [True, False])
def test_analog_plan(cuda, faithful):
    mega = _ecg_model(cuda).lower().mega
    x = torch.randint(0, 32, (5 * 32, 128), dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0)).to(cuda)
    args = (x, mega.w_cat, mega.gain, mega.off)
    got = analog_plan_cuda(*args, schedule=mega.schedule, faithful=faithful)
    want = ref.analog_plan_ref(*args, mega.schedule, faithful=faithful)
    assert torch.equal(got, want)


def test_routes_agree_and_count_launches(cuda):
    model = _ecg_model(cuda)
    x = torch.randint(0, 32, (7, 2, 126), dtype=torch.float32,
                      generator=torch.Generator().manual_seed(1)).to(cuda)
    ops.reset_launch_counts()
    y_mk = model.apply(x, megakernel=True)
    y_pl = model.apply(x, megakernel=False)
    assert ops.launch_counts() == {"maxmin_pool": 0, "analog_mvm": 3,
                                   "analog_mvm_split": 0, "analog_plan": 1}
    cpu = _ecg_model("cpu")
    assert torch.equal(y_mk, y_pl)
    assert torch.equal(y_mk.cpu(), cpu.apply(x.cpu()))


def test_plain_route_refuses_the_card(cuda):
    model = _ecg_model(cuda, use_kernels=False)
    x = torch.zeros((2, 2, 126), device=cuda)
    for mk in (True, False):
        with pytest.raises(ValueError, match="use_kernels=False"):
            model.apply(x, megakernel=mk)


def _lm_serve(device, run, params, cfg):
    reqs = [Request(uid=i, prompt=(np.arange(3 + 2 * i) * 37 + i)
                    % cfg.vocab_size, max_new_tokens=4) for i in range(3)]
    engine = ServeEngine(cfg, run, params, batch_size=4, max_len=32,
                         device=device)
    return [r.output.tolist() for r in engine.serve(reqs)]


def test_lm_serve_on_card_matches_cpu(cuda):
    cfg = configs.get_smoke("phi4-mini-3.8b")
    run = RunConfig(analog=AnalogConfig(mode="analog_faithful"),
                    activation_dtype="float32")
    params = T.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    ops.reset_launch_counts()
    on_card = _lm_serve(cuda, run, params, cfg)
    # one prefill and three decode calls, 5 per layer + the lm_head each
    assert ops.launch_counts()["analog_mvm_split"] == 4 * (
        5 * cfg.n_layers + 1)
    assert on_card == _lm_serve("cpu", run, params, cfg)


def test_lm_plain_route_refuses_the_card(cuda):
    cfg = configs.get_smoke("phi4-mini-3.8b")
    run = RunConfig(analog=AnalogConfig(mode="analog_faithful",
                                        use_kernels=False))
    params = T.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="use_kernels=False"):
        _lm_serve(cuda, run, params, cfg)
