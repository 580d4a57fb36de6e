"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device (and nvcc, to build the
kernels at first use) and skips without one; the file imports only
torch and the port, so it runs where JAX is not installed:

    python3 -m pytest -q tests/test_torch_cuda.py

Tolerance: bit-exact throughout (integer effective weights; the kernels
repeat the plain versions' per-chunk arithmetic), and equal greedy tokens
for the smoke LM served on the card and on the CPU.  The split kernel with
rank-1 float gains sums each chunk's products in another order (tensor
cores) than the plain version: each element within 1 ADC LSB per chunk,
at most 1 % of the elements differing (the reference's contract at ADC
rounding ties); its two weight operands agree bit for bit, in the split
kernel and in the block kernel's VMM stages.  The block kernel's
glue stages (RMSNorm, attention, SwiGLU) reduce and take transcendentals
in another order than PyTorch: each is held within 1e-6 of its stage's
max |value| when fed the kernel's own stage input.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.analog import AnalogConfig, analog_linear_init  # noqa: E402
from repro_torch.core.noise import NoiseConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.analog_mvm import (  # noqa: E402
    MVM_SMEM_LIMIT, analog_mvm_cuda, analog_mvm_cuda_with_plan,
    analog_mvm_split_codes_cuda, analog_mvm_split_cuda, mvm_geometry)
from repro_torch.core.device import to_device  # noqa: E402
from repro_torch.exec.lower import lower_block, lower_stack  # noqa: E402
from repro_torch.kernels.analog_plan import (  # noqa: E402
    BLOCK_STAGES, analog_plan_block_cuda, analog_plan_cuda, chain_layout,
    default_per_block)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.kernels.preproc import maxmin_pool_cuda  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.ecg import ECGConfig, ecg_init, ecg_module_spec  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

# M and N are no multiple of a tile; K covers 1, 2 and 3 chunks.  The
# plan (mvm_plan) takes: M = 1 with 4-column tiles (fc1 at batch 1: two
# chunks side by side, 4-byte loads), the conv layer at batch 500 (16-byte
# loads, > 48 KB of shared memory), 2 and 3 chunks side by side in one
# CTA with 16-byte loads, and 3 chunks walked in series with 3 staging
# buffers in flight (2 waves)
MVM_SHAPES = [(1, 128, 1), (17, 256, 129), (33, 384, 70), (100, 128, 10),
              (1, 256, 123), (16000, 128, 8), (500, 256, 124),
              (64, 384, 256), (1000, 384, 200)]


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


# B=1 and B=500 ECG records (2 channels each), ragged row counts and
# lengths, and the other window widths the kernel takes
@pytest.mark.parametrize("rows,t,window", [
    (2, 4032, 32), (1000, 4032, 32), (1, 32, 32), (7, 96, 32), (3, 4064, 32),
    (333, 4032, 32), (5, 64, 4), (9, 640, 128), (4, 256, 16)])
def test_maxmin_pool_sizes(cuda, rows, t, window):
    x = torch.from_numpy(np.random.default_rng(rows + t).standard_normal(
        (rows, t)).astype(np.float32)).to(cuda)
    ops.reset_launch_counts()
    got = maxmin_pool_cuda(x, window=window)
    assert ops.launch_counts()["maxmin_pool"] == 1
    assert torch.equal(got, ref.maxmin_pool_ref(x, window=window))


def test_maxmin_pool_refuses_unaligned_rows(cuda):
    x = torch.zeros((2 * 4032 + 1,), device=cuda)[1:].view(2, 4032)
    with pytest.raises(ValueError, match="16-byte"):
        maxmin_pool_cuda(x)


@pytest.mark.parametrize("m,k,n", MVM_SHAPES)
@pytest.mark.parametrize("faithful", [True, False])
def test_analog_mvm(cuda, m, k, n, faithful):
    t = _mvm_inputs(m, k, n, cuda)
    for epi in (None, ("relu_shift", 2)):
        got = analog_mvm_cuda(*t, faithful=faithful, epilogue=epi)
        want = ref.adc_epilogue_ref(ref.analog_mvm_ref(*t, faithful=faithful),
                                    epi)
        assert torch.equal(got, want)


def _exact_mvm_inputs(m, k, n, device, seed):
    """Integer w_eff with a dyadic gain and offsets: every partial sum is
    exact in fp32, so any chunk count sums to the plain version's value
    bit for bit (its sum over more than 4 chunks runs in another order)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 32, (m, k)).astype(np.float32)
    w = rng.integers(-63, 64, (k, n)).astype(np.float32)
    gain = np.full((n,), 1 / 64, np.float32)
    off = (rng.integers(-16, 17, (k // 128, n)) / 8).astype(np.float32)
    return [torch.from_numpy(v).to(device) for v in (a, w, gain, off)]


def _forced_plans(tn):
    """(M, K, N, plan) cuts of the analog_mvm kernel beyond what the ECG
    shapes take, at column tile ``tn``: N ragged (4-byte loads) and a
    multiple of 4 (16-byte loads, two tiles); 2 chunks side by side with
    7 chunks walked in 4 steps through 2 buffers refilled in flight
    (slots and refills), and 1 chunk per step through 4 buffers."""
    out = []
    for n, ways, stages in ((2 * tn - 1, 2, 2), (2 * tn, 1, 4)):
        tm = max(1, min(7, 256 // (tn // 4 * ways)))
        plan = mvm_geometry(19, n, tm, tn, ways, stages, 128)
        while plan.smem > MVM_SMEM_LIMIT:
            plan = mvm_geometry(19, n, tm, tn, ways, plan.stages - 1, 128)
        out.append((19, 7 * 128, n, plan))
    return out


def test_analog_mvm_every_tile_width(cuda):
    """Every column tile width (4 to 128) and staging branch of the
    kernel, bit-exact against the plain version in both modes, with and
    without the epilogue."""
    ops.reset_launch_counts()
    launches = 0
    for tn in range(4, 129, 4):
        for m, k, n, plan in _forced_plans(tn):
            t = _exact_mvm_inputs(m, k, n, cuda, tn + n)
            for faithful in (True, False):
                for epi in (None, ("relu_shift", 3)):
                    got = analog_mvm_cuda_with_plan(
                        *t, plan, faithful=faithful, epilogue=epi)
                    want = ref.adc_epilogue_ref(
                        ref.analog_mvm_ref(*t, faithful=faithful), epi)
                    assert torch.equal(got, want), (tn, n, plan, faithful,
                                                    epi)
                    launches += 1
    assert ops.launch_counts()["analog_mvm"] == launches


@pytest.mark.parametrize("chunk_rows", [32, 256])
@pytest.mark.parametrize("faithful", [True, False])
def test_analog_mvm_other_chunk_rows(cuda, chunk_rows, faithful):
    """Chunks of another length than the datapath's 128 rows (the kernel's
    instantiation that reads the length at run time)."""
    m, k, n = 9, 4 * chunk_rows, 37
    rng = np.random.default_rng(chunk_rows)
    a, w, gain, off = (torch.from_numpy(v).to(cuda) for v in (
        rng.integers(0, 32, (m, k)).astype(np.float32),
        rng.integers(-63, 64, (k, n)).astype(np.float32),
        np.full((n,), 1 / 64, np.float32),
        (rng.integers(-16, 17, (4, n)) / 8).astype(np.float32)))
    for epi in (None, ("relu_shift", 3)):
        got = analog_mvm_cuda(a, w, gain, off, chunk_rows=chunk_rows,
                              faithful=faithful, epilogue=epi)
        want = ref.adc_epilogue_ref(ref.analog_mvm_ref(
            a, w, gain, off, chunk_rows=chunk_rows, faithful=faithful), epi)
        assert torch.equal(got, want)


def test_kernels_on_every_device(cuda):
    """The split kernel and analog_mvm on each visible card, each against
    its plain version: their > 48 KB shared-memory attribute is set once
    per device, so a second card launches as the first does."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip(f"needs two CUDA devices, found {count}")
    for index in range(count):
        dev = torch.device("cuda", index)
        t = _mvm_inputs(16000, 128, 8, dev)  # > 48 KB of shared memory
        got = analog_mvm_cuda(*t)
        assert got.device == dev
        assert torch.equal(got, ref.analog_mvm_ref(*t))
        t = _split_inputs(48, 384, 200, dev)
        got = analog_mvm_split_cuda(*t)
        assert got.device == dev
        assert torch.equal(got, ref.analog_mvm_split_ref(*t))


# M on both sides of the split kernel's row tilings (8, 16, 24, 48 rows),
# ragged N
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


# the split kernel's row tilings (one, two, three and six m16 tiles per
# CTA; one and two row groups) and, per (K, N): one chunk, five chunks
# cut into ranges of 2, 2 and 1 (the split factor does not divide them),
# and ragged N (no multiple of 16: the operands are staged without
# cp.async)
SPLIT_M = [1, 4, 16, 20, 48, 64, 65]
SPLIT_KN = [(128, 1), (640, 300), (384, 70), (256, 512)]


def _split_codes_inputs(m, k, n, device, rank1, blocks=None):
    """Codes, gain tables and activations of a split layer: integer
    effective weights (no gain tables, dyadic gain and offsets: every
    partial sum exact) or rank-1 gains (one row-gain vector per column
    block)."""
    rng = np.random.default_rng(m * 1000 + k + n + rank1)
    a_pos = rng.integers(0, 32, (m, k)).astype(np.float32)
    a_neg = rng.integers(0, 32, (m, k)).astype(np.float32)
    a_neg[a_pos > 15] = 0.0
    codes = rng.integers(-63, 64, (k, n)).astype(np.int8)
    col = row = None
    if rank1:
        col = (1 + 0.014 * rng.standard_normal(n)).astype(np.float32)
        row = (1 + 0.014 * rng.standard_normal(
            (1 if blocks is None else len(blocks), k))).astype(np.float32)
    gain = np.full((n,), 1 / 64, np.float32)
    off = (rng.integers(-16, 17, (k // 128, n)) / 8).astype(np.float32)
    return [None if v is None else torch.from_numpy(v).to(device)
            for v in (a_pos, a_neg, codes, col, row, gain, off)]


def _assert_split(got, want, exact, n_chunks):
    if exact:
        assert torch.equal(got, want)
        return
    diff = (got - want).abs()
    assert float(diff.max()) <= n_chunks
    assert float((diff != 0).float().mean()) <= 0.01


@pytest.mark.parametrize("m", SPLIT_M)
@pytest.mark.parametrize("k,n", SPLIT_KN)
@pytest.mark.parametrize("faithful", [True, False])
def test_analog_mvm_split_operand_forms(cuda, m, k, n, faithful):
    """Both weight operands against the plain version of the code operand
    (the rebuilt w_eff through the two-pass split), with and without the
    epilogue; the two operands bit-identical to each other."""
    for rank1 in (False, True):
        a_pos, a_neg, codes, col, row, gain, off = _split_codes_inputs(
            m, k, n, cuda, rank1)
        w_eff = ref.rebuild_w_eff_ref(codes, col, row)
        for epi in (None, ("relu_shift", 2)):
            want = ref.adc_epilogue_ref(ref.analog_mvm_split_codes_ref(
                a_pos, a_neg, codes, col, row, gain, off,
                faithful=faithful), epi)
            got = analog_mvm_split_codes_cuda(
                a_pos, a_neg, codes, col, row, gain, off, faithful=faithful,
                epilogue=epi)
            _assert_split(got, want, not rank1, k // 128)
            assert torch.equal(analog_mvm_split_cuda(
                a_pos, a_neg, w_eff, gain, off, faithful=faithful,
                epilogue=epi), got)


@pytest.mark.parametrize("m", [4, 48])
@pytest.mark.parametrize("faithful", [True, False])
def test_analog_mvm_split_fused_qkv_blocks(cuda, m, faithful):
    """A column_concat store of three members (q, k, v widths as in a
    GQA attention) with one row-gain vector per member."""
    blocks = (192, 64, 64)
    a_pos, a_neg, codes, col, row, gain, off = _split_codes_inputs(
        m, 384, sum(blocks), cuda, True, blocks)
    want = ref.analog_mvm_split_codes_ref(
        a_pos, a_neg, codes, col, row, gain, off, col_blocks=blocks,
        faithful=faithful)
    got = analog_mvm_split_codes_cuda(a_pos, a_neg, codes, col, row, gain,
                                      off, col_blocks=blocks,
                                      faithful=faithful)
    _assert_split(got, want, False, 3)
    w_eff = ref.rebuild_w_eff_ref(codes, col, row, blocks)
    assert torch.equal(analog_mvm_split_cuda(a_pos, a_neg, w_eff, gain, off,
                                             faithful=faithful), got)


def test_split_dispatch_reads_the_store(cuda):
    """``ops.analog_mvm_split`` with a rank-1 store launches the code
    operand (one launch), equal to the fp32 operand on the store's
    w_eff; a store with a full gain map takes the fp32 operand."""
    from repro_torch.exec.plan import WeightStore

    a_pos, a_neg, codes, col, row, gain, off = _split_codes_inputs(
        4, 256, 96, cuda, True)
    store = WeightStore(  # verify: allow-packed-weights
        codes=codes, w_scale=torch.ones((1, 96), device=cuda),
        gain=torch.tensor(1.0, device=cuda), col_gain=col, row_gain=row)
    ops.reset_launch_counts()
    got = ops.analog_mvm_split(a_pos, a_neg, store.w_eff, gain, off,
                               store=store)
    assert ops.launch_counts()["analog_mvm_split"] == 1
    assert torch.equal(got, analog_mvm_split_cuda(a_pos, a_neg, store.w_eff,
                                                  gain, off))
    full = WeightStore(  # verify: allow-packed-weights
        codes=codes, w_scale=torch.ones((1, 96), device=cuda),
        gain=torch.tensor(1.0, device=cuda),
        gain_map=1 + 0.01 * torch.randn((256, 96), device=cuda))
    assert torch.equal(
        ops.analog_mvm_split(a_pos, a_neg, full.w_eff, gain, off,
                             store=full),
        analog_mvm_split_cuda(a_pos, a_neg, full.w_eff, gain, off))


# form 0 with a measured per-(chunk, column) gain table: (M, K, N,
# chunk_rows) at the decode and prefill row tilings, an odd N (plain
# loads, no cp.async) and 64-row chunks (two 32-row stages per chunk)
CHUNK_GAIN_SHAPES = [(4, 256, 129, 128), (48, 384, 96, 128),
                     (4, 256, 160, 64), (48, 640, 300, 64)]


def _chunk_gain_store(codes, col, row, blocks, chunk_rows, integer, seed):
    """A WeightStore of these codes and tables plus a chunk_gain table:
    integer-valued (1 or 2, so w_eff holds integers when there are no
    rank-1 tables) or a float table around 1 (a calibrated bake's)."""
    from repro_torch.exec.plan import WeightStore

    k, n = codes.shape
    rng = np.random.default_rng(seed)
    cg = (rng.integers(1, 3, (k // chunk_rows, n)) if integer else
          1 + 0.02 * rng.standard_normal((k // chunk_rows, n)))
    dev = codes.device
    return WeightStore(  # verify: allow-packed-weights
        codes=codes, w_scale=torch.ones((1, n), device=dev),
        gain=torch.tensor(1.0, device=dev), col_gain=col, row_gain=row,
        chunk_gain=torch.from_numpy(cg.astype(np.float32)).to(dev),
        chunk_rows=chunk_rows, col_blocks=blocks)


@pytest.mark.parametrize("m,k,n,chunk_rows", CHUNK_GAIN_SHAPES)
@pytest.mark.parametrize("faithful", [True, False])
def test_analog_mvm_split_chunk_gain(cuda, m, k, n, chunk_rows, faithful):
    """Form 0 reading a chunk_gain table: bit-exact against the plain
    version on the store's w_eff with an integer table, within the ADC
    contract with rank-1 and float tables; form 0 and form 1 (the store's
    w_eff) bit-identical in both cases."""
    for integer in (True, False):
        a_pos, a_neg, codes, col, row, gain, _ = _split_codes_inputs(
            m, k, n, cuda, not integer)
        rng = np.random.default_rng(k + n)
        off = torch.from_numpy((rng.integers(-16, 17, (k // chunk_rows, n))
                                / 8).astype(np.float32)).to(cuda)
        st = _chunk_gain_store(codes, col, row, None, chunk_rows, integer,
                               m + k)
        for epi in (None, ("relu_shift", 2)):
            want = ref.adc_epilogue_ref(ref.analog_mvm_split_ref(
                a_pos, a_neg, st.w_eff, gain, off, chunk_rows=chunk_rows,
                faithful=faithful), epi)
            got = analog_mvm_split_codes_cuda(
                a_pos, a_neg, codes, col, row, gain, off,
                chunk_gain=st.chunk_gain, chunk_rows=chunk_rows,
                faithful=faithful, epilogue=epi)
            _assert_split(got, want, integer, k // chunk_rows)
            assert torch.equal(analog_mvm_split_cuda(
                a_pos, a_neg, st.w_eff, gain, off, chunk_rows=chunk_rows,
                faithful=faithful, epilogue=epi), got)
            ops.reset_launch_counts()
            assert torch.equal(ops.analog_mvm_split(
                a_pos, a_neg, st.w_eff, gain, off, chunk_rows=chunk_rows,
                faithful=faithful, epilogue=epi, store=st), got)
            assert ops.launch_counts()["analog_mvm_split"] == 1


@pytest.mark.parametrize("m", [4, 48])
@pytest.mark.parametrize("faithful", [True, False])
def test_analog_mvm_split_chunk_gain_qkv_blocks(cuda, m, faithful):
    """A column_concat store (one row-gain vector per member) with a
    float chunk_gain table: within the ADC contract of the plain version,
    form 0 bit-identical to form 1."""
    blocks = (192, 64, 64)
    a_pos, a_neg, codes, col, row, gain, off = _split_codes_inputs(
        m, 384, sum(blocks), cuda, True, blocks)
    st = _chunk_gain_store(codes, col, row, blocks, 128, False, m)
    want = ref.analog_mvm_split_ref(a_pos, a_neg, st.w_eff, gain, off,
                                    faithful=faithful)
    got = analog_mvm_split_codes_cuda(
        a_pos, a_neg, codes, col, row, gain, off, chunk_gain=st.chunk_gain,
        col_blocks=blocks, faithful=faithful)
    _assert_split(got, want, False, 3)
    assert torch.equal(analog_mvm_split_cuda(a_pos, a_neg, st.w_eff, gain,
                                             off, faithful=faithful), got)


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
                                   "analog_mvm_split": 0, "analog_plan": 1,
                                   "analog_plan_block": 0,
                                   "analog_mvm_split_experts": 0,
                                   "analog_mvm_split_members": 0}
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


# integer effective weights (a gain map of exactly 1), offsets kept
INT_NOISE = NoiseConfig(gain_std=0.0, mode="full")
GLUE_TOL = 1e-6


def _float_chain(device, encode):
    """A static-calibration float chain: k = 100 and 300 (ragged chunk
    padding), relu hand-offs, every layer encoding floats in-kernel."""
    g = torch.Generator().manual_seed(3)
    layers = [to_device(analog_linear_init(g, k, n, noise=INT_NOISE,
                                           device="cpu"), device)
              for k, n in ((100, 70), (70, 300), (300, 9))]
    acfg = AnalogConfig(act_calib="static", signed_input=encode,
                        fused_epilogue=True)
    return lower_stack(layers, acfg, input_domain="float")


@pytest.mark.parametrize("encode", ["none", "split"])
@pytest.mark.parametrize("faithful", [True, False])
def test_analog_plan_float_chain(cuda, encode, faithful):
    mega = _float_chain(cuda, encode).mega
    assert [m.encode for m in mega.schedule] == [
        "split" if encode == "split" else "unsigned"] * 3
    for b in (1, 37):
        x = torch.randn((b, 100), generator=torch.Generator().manual_seed(b)
                        ).to(cuda)
        args = (x, mega.w_cat, mega.gain, mega.off)
        got = analog_plan_cuda(*args, schedule=mega.schedule,
                               faithful=faithful, extras=mega.extras)
        want = ref.analog_plan_ref(*args, mega.schedule, faithful=faithful,
                                   extras=mega.extras)
        assert torch.equal(got, want)


# layer 0's encode -> (input domain, signed input of the float layers)
CHAIN_ENCODES = {"codes": ("codes", "split"), "unsigned": ("float", "none"),
                 "split": ("float", "split")}
# inter-layer hand-off -> the epilogue of the first two layers
CHAIN_HANDOFFS = {"codes": "relu_shift", "relu": "none"}


def _chain(device, dims, encode, handoff, seed):
    """A chain of fc layers ``dims`` (k, n) with integer w_eff, entered by
    ``encode`` (CHAIN_ENCODES) and handing off by ``handoff``."""
    entry, signed = CHAIN_ENCODES[encode]
    g = torch.Generator().manual_seed(seed)
    layers = [to_device(analog_linear_init(g, k, n, noise=INT_NOISE,
                                           device="cpu"), device)
              for k, n in dims]
    acfg = AnalogConfig(act_calib="static", signed_input=signed,
                        fused_epilogue=True)
    epi = CHAIN_HANDOFFS[handoff]
    mega = lower_stack(layers, acfg, input_domain=entry,
                       epilogues=[epi] * (len(dims) - 1) + ["none"]).mega
    assert mega.schedule[0].encode == encode
    assert [m.handoff for m in mega.schedule] == \
        [handoff] * (len(dims) - 1) + ["raw"]
    return mega


def _chain_input(mega, b, device):
    gx = torch.Generator().manual_seed(b)
    first = mega.schedule[0]
    if first.encode == "codes":
        x = torch.randint(0, 32, (b, first.k), generator=gx).float()
        x = torch.nn.functional.pad(x, (0, first.k_pad - first.k))
    else:
        x = torch.randn((b, first.k), generator=gx)
    return x.to(device)


def _assert_chain_exact(mega, x, faithful):
    args = (x, mega.w_cat, mega.gain, mega.off)
    got = analog_plan_cuda(*args, schedule=mega.schedule, faithful=faithful,
                           extras=mega.extras)
    want = ref.analog_plan_ref(*args, mega.schedule, faithful=faithful,
                               extras=mega.extras)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b", [1, 2, 133, 500])
@pytest.mark.parametrize("encode", list(CHAIN_ENCODES))
@pytest.mark.parametrize("handoff", list(CHAIN_HANDOFFS))
@pytest.mark.parametrize("faithful", [True, False])
def test_analog_plan_chain_sweep(cuda, b, encode, handoff, faithful):
    """The chain kernel bit-exact against its plain version at batch 1 (a
    dot's chunks cut over threads in faithful mode), 2, 133 and 500 (two
    to four records per block), every layer-0 encode, both hand-offs."""
    mega = _chain(cuda, ((100, 70), (70, 300), (300, 9)), encode, handoff,
                  seed=5)
    _assert_chain_exact(mega, _chain_input(mega, b, cuda), faithful)


@pytest.mark.parametrize("b", [1, 133])
@pytest.mark.parametrize("encode", list(CHAIN_ENCODES))
@pytest.mark.parametrize("handoff", list(CHAIN_HANDOFFS))
@pytest.mark.parametrize("faithful", [True, False])
def test_analog_plan_chain_unstaged(cuda, b, encode, handoff, faithful):
    """Layers whose weights exceed a block's shared memory (fc 100 -> 1024
    is 512 KiB, 1024 -> 256 is 1 MiB) are read in place, the small last
    layer staged; bit-exact against the plain version."""
    mega = _chain(cuda, ((100, 1024), (1024, 256), (256, 9)), encode,
                  handoff, seed=7)
    x = _chain_input(mega, b, cuda)
    assert chain_layout(mega.schedule, b, x.shape[1], mega.w_cat.shape[1],
                        cuda) == (1, (False, False, True))
    _assert_chain_exact(mega, x, faithful)


@pytest.mark.parametrize("faithful", [True, False])
def test_analog_plan_chain_fewer_per_block(cuda, faithful):
    """A split float chain whose weights (100 -> 384 -> 9, 221 KiB with its
    tables) fit beside one record's activations but not beside two: at
    B = 133 (two records per block by default) the kernel takes one record
    per block and stages every layer; bit-exact."""
    mega = _chain(cuda, ((100, 384), (384, 9)), "split", "relu", seed=7)
    assert default_per_block(133, cuda) == 2
    x = _chain_input(mega, 133, cuda)
    assert chain_layout(mega.schedule, 133, x.shape[1], mega.w_cat.shape[1],
                        cuda) == (1, (True, True))
    _assert_chain_exact(mega, x, faithful)


def test_ecg_float_chain_routes_agree(cuda):
    cfg = ECGConfig(noise=NoiseConfig(gain_std=0.0, mode="full"))
    params = ecg_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    spec = ecg_module_spec(cfg, epilogue="none")
    acfg = AnalogConfig(act_calib="static", fused_epilogue=True)
    model = api.compile(spec, params, acfg, device=cuda)
    x = torch.randint(0, 32, (5, 2, 126), dtype=torch.float32,
                      generator=torch.Generator().manual_seed(1)).to(cuda)
    ops.reset_launch_counts()
    y_mk = model.apply(x, megakernel=True)
    assert ops.launch_counts()["analog_plan"] == 1
    assert torch.equal(y_mk, model.apply(x, megakernel=False))
    cpu = api.compile(spec, params, acfg, device="cpu")
    assert torch.equal(y_mk.cpu(), cpu.apply(x.cpu(), megakernel=True))


# (d_model, heads, kv heads, head_dim, d_ff, batch, seq): GQA, ragged
# widths, and M = 15, 48 and 84 rows (every row-tile height, two row tiles);
# the last has ragged N (o and down 68 columns, up|gate 200: no multiple of
# 16, so the int8 operand is staged with plain loads) and a ragged K (d_ff
# 100 of a 128-row chunk)
BLOCK_GEOMS = [(96, 6, 2, 16, 192, 3, 5), (128, 4, 2, 32, 160, 4, 12),
               (64, 2, 2, 32, 96, 7, 12), (68, 4, 2, 16, 100, 2, 12)]
def _with_gain_map(mega):
    """The same pack with a full gain map of exactly 1 in every store
    (integer w_eff still; the stores then give the fp32 w_eff operand)."""
    return dataclasses.replace(mega, stores=tuple(
        dataclasses.replace(s, gain_map=torch.ones_like(s.w_eff))
        for s in mega.stores))


def _block_plan(device, geom, faithful, seed=0, noise=INT_NOISE):
    d, h, kvh, hd, dff, _, seq = geom
    g = torch.Generator().manual_seed(seed)
    params = {
        "ln1": {"scale": 1 + 0.1 * torch.randn((d,), generator=g)},
        "attn": A.attention_init(g, d, h, kvh, hd, noise=noise,
                                 device="cpu"),
        "ln2": {"scale": 1 + 0.1 * torch.randn((d,), generator=g)},
        "mlp": L.mlp_init(g, d, dff, noise=noise, device="cpu"),
    }
    acfg = AnalogConfig(mode="analog_faithful" if faithful else "analog_fast",
                        act_calib="static")
    return lower_block(to_device(params, device), acfg, n_heads=h,
                       n_kv_heads=kvh, head_dim=hd, seq=seq,
                       rope_theta=1e4)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("geom", BLOCK_GEOMS)
@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("store", ["codes", "gain_map"])
def test_analog_plan_block_stages(cuda, geom, faithful, store):
    """Every stage of the block kernel against its plain version fed the
    kernel's own stage input, through the stores (the int8 code operand
    where a store has no gain map) and through the fp32 w_eff tensors:
    VMM stages, code regions, res2 and the output bit-exact, glue within
    GLUE_TOL; the two operands bit-identical."""
    mega = _block_plan(cuda, geom, faithful).mega
    if store == "gain_map":
        mega = _with_gain_map(mega)
    assert mega.w_cat is None
    assert all((s.gain_map is None) == (store == "codes")
               for s in mega.stores)
    d, batch, seq = geom[0], geom[5], geom[6]
    x = torch.randn((batch * seq, d), generator=torch.Generator(
    ).manual_seed(9)).to(cuda)
    outs = []
    for weights in (mega.stores, mega.weights):
        args = (x, weights, mega.gain, mega.off)
        out, stages, grid = analog_plan_block_cuda(
            *args, schedule=mega.schedule, block=mega.block,
            extras=mega.extras, faithful=faithful)
        assert grid >= torch.cuda.get_device_properties(
            cuda).multi_processor_count
        want = ref.block_stages_ref(x, stages, *args[1:], mega.schedule,
                                    mega.block, mega.extras,
                                    faithful=faithful)
        for name, _, _ in BLOCK_STAGES:
            if name.startswith("acc_") or name == "res2" or \
                    name.endswith(("_pos", "_neg")):
                assert torch.equal(stages[name], want[name]), name
            else:
                assert _rel(stages[name], want[name]) <= GLUE_TOL, name
        assert torch.equal(out, want["out"])
        outs.append((out, stages))
    assert torch.equal(outs[0][0], outs[1][0])
    for name, _, _ in BLOCK_STAGES:
        assert torch.equal(outs[0][1][name], outs[1][1][name]), name
    ops.reset_launch_counts()
    again = ops.analog_plan_codes(x, mega.stores, mega.gain, mega.off,
                                  schedule=mega.schedule, faithful=faithful,
                                  extras=mega.extras, block=mega.block)
    assert ops.launch_counts()["analog_plan_block"] == 1
    assert torch.equal(again, outs[0][0])


@pytest.mark.parametrize("geom", [BLOCK_GEOMS[1], BLOCK_GEOMS[3]])
@pytest.mark.parametrize("faithful", [True, False])
def test_analog_plan_block_chunk_gain_mix(cuda, geom, faithful):
    """A block whose stores mix the operands: qkv and up|gate with an
    integer chunk_gain table (form 0), o with a gain map of ones (form 1),
    down with none (form 0).  Every stage against its plain version fed
    the kernel's own stage input (VMM stages, code regions, res2 and the
    output bit-exact), and the same block through the fp32 w_eff tensors
    bit-identical."""
    mega = _block_plan(cuda, geom, faithful).mega
    rng = np.random.default_rng(geom[0])
    stores = []
    for i, st in enumerate(mega.stores):
        if i in (0, 2):
            cg = rng.integers(1, 3, (st.k_pad // st.chunk_rows,
                                     st.codes.shape[1]))
            st = dataclasses.replace(st, chunk_gain=torch.from_numpy(
                cg.astype(np.float32)).to(cuda))
        elif i == 1:
            st = dataclasses.replace(st, gain_map=torch.ones_like(st.w_eff))
        stores.append(st)
    mega = dataclasses.replace(mega, stores=tuple(stores))
    assert [s.code_operand for s in mega.stores] == [True, False, True, True]
    d, batch, seq = geom[0], geom[5], geom[6]
    x = torch.randn((batch * seq, d), generator=torch.Generator(
    ).manual_seed(9)).to(cuda)
    outs = []
    for weights in (mega.stores, mega.weights):
        args = (x, weights, mega.gain, mega.off)
        out, stages, _ = analog_plan_block_cuda(
            *args, schedule=mega.schedule, block=mega.block,
            extras=mega.extras, faithful=faithful)
        want = ref.block_stages_ref(x, stages, *args[1:], mega.schedule,
                                    mega.block, mega.extras,
                                    faithful=faithful)
        for name, _, _ in BLOCK_STAGES:
            if name.startswith("acc_") or name == "res2" or \
                    name.endswith(("_pos", "_neg")):
                assert torch.equal(stages[name], want[name]), name
            else:
                assert _rel(stages[name], want[name]) <= GLUE_TOL, name
        assert torch.equal(out, want["out"])
        outs.append(out)
    assert torch.equal(outs[0], outs[1])


def test_lm_block_route_on_card(cuda):
    """attach_block_plans + lm_apply on the smoke config: one block launch
    per layer and one split launch (lm_head) per prefill; the logits
    close to the CPU's (a glue ulp may flip a code at a tie)."""
    cfg = configs.get_smoke("phi4-mini-3.8b")
    acfg = AnalogConfig(mode="analog_faithful", act_calib="static")
    run = RunConfig(analog=acfg, activation_dtype="float32")
    params = T.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 12)))
    logits = {}
    for dev in (cuda, torch.device("cpu")):
        tree = T.attach_block_plans(api.lower_tree(to_device(params, dev), run),
                                    cfg, acfg, seq=12)
        ops.reset_launch_counts()
        logits[dev.type] = T.lm_apply(tree, {"tokens": toks.to(dev)}, cfg,
                                      run)[0].cpu()
        if dev.type == "cuda":
            assert ops.launch_counts() == {
                "maxmin_pool": 0, "analog_mvm": 0, "analog_mvm_split": 1,
                "analog_plan": 0, "analog_plan_block": cfg.n_layers,
                "analog_mvm_split_experts": 0, "analog_mvm_split_members": 0}
    want = logits["cpu"]
    assert _rel(logits["cuda"], want) <= 1e-2
    assert float((logits["cuda"].argmax(-1) == want.argmax(-1)).float().mean()
                 ) >= 0.95


# the split kernel's expert axis: qwen3-moe-30b-a3b's up/gate and down
# stacks at M = 32 per expert (narrowed to 16 experts here; chip_smoke.py
# runs all 128), and a ragged sweep over E, M, K and N
EXPERT_SHAPES = [(16, 32, 2048, 768), (16, 32, 768, 2048), (1, 5, 128, 40),
                 (3, 9, 256, 136), (7, 17, 384, 200), (5, 33, 128, 64),
                 (2, 48, 512, 1000), (4, 60, 256, 96)]


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("e,m,k,n", EXPERT_SHAPES)
def test_analog_mvm_split_experts(cuda, e, m, k, n, faithful):
    from repro_torch.kernels.analog_mvm import analog_mvm_split_experts_cuda

    rng = np.random.default_rng(e * 7 + m + k + n)
    a_pos, a_neg = (torch.from_numpy(rng.integers(0, 32, (e, m, k))
                                     .astype(np.float32)).to(cuda)
                    for _ in range(2))
    codes = torch.from_numpy(rng.integers(-63, 64, (e, k, n))
                             .astype(np.int8)).to(cuda)
    gain = torch.from_numpy(np.repeat(rng.uniform(0.005, 0.05, (e, 1)), n, 1)
                            .astype(np.float32)).to(cuda)
    post = None
    if not faithful:
        post, gain = gain, torch.ones_like(gain)
    ops.reset_launch_counts()
    got = analog_mvm_split_experts_cuda(a_pos, a_neg, codes, gain,
                                        post_gain=post, faithful=faithful)
    counts = ops.launch_counts()
    assert counts["analog_mvm_split_experts"] == 1
    assert counts["analog_mvm_split"] == 0
    want = ref.analog_mvm_split_experts_ref(
        a_pos.cpu(), a_neg.cpu(), codes.cpu().float(), gain.cpu(),
        post_gain=None if post is None else post.cpu(), faithful=faithful)
    assert torch.equal(got.cpu(), want)


def test_expert_stack_and_moe_on_card_match_cpu(cuda):
    """An MoE layer on the card against the CPU, the CPU's routing passed
    in: the expert stacks through the split kernel's expert axis (one
    launch per stack), their products bit-exact; the layer's output
    within 1e-5 * max|y| (SiLU rounds in another order on the card)."""
    from repro_torch.exec.lower import lower_expert_stack
    from repro_torch.exec.plan import GroupPlan
    from repro_torch.exec.run import run_expert_stack
    from repro_torch.models import moe as M

    g = torch.Generator().manual_seed(0)
    p = M.moe_init(g, 256, 128, 8, act="swiglu", device="cpu")
    acfg = AnalogConfig(mode="analog_faithful")
    x = torch.randn((2, 12, 256), generator=g)
    rec = M.Routes()
    want, want_aux = M.moe_apply(p, x, acfg=acfg, top_k=2, routes=rec)
    ops.reset_launch_counts()
    got, aux = M.moe_apply(to_device(p, cuda), x.to(cuda), acfg=acfg,
                           top_k=2, routes=M.Routes(replay=rec.taken))
    assert ops.launch_counts()["analog_mvm_split_experts"] == 3
    assert torch.allclose(got.cpu(), want, rtol=0,
                          atol=1e-5 * want.abs().max().item())
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * float(want_aux)
    xe = torch.randn((8, 6, 256), generator=g)
    for mode in ("analog_faithful", "analog_fast"):
        acfg = AnalogConfig(mode=mode)
        gp = GroupPlan(kind="expert_stack",
                       fused=lower_expert_stack(p["up"], acfg),
                       member_names=("up",), member_ns=(128,))
        gpc = GroupPlan(kind="expert_stack",
                        fused=lower_expert_stack(p["up"].to(cuda), acfg),
                        member_names=("up",), member_ns=(128,))
        assert torch.equal(run_expert_stack(gpc, xe.to(cuda), acfg).cpu(),
                           run_expert_stack(gp, xe, acfg))


# the split kernel's member axis: rwkv6-7b's r/k/v/g (G = 4, K = N = 4096,
# narrowed to N = 1024 here; chip_smoke.py runs the full width) at the
# decode and prefill rows, and a ragged sweep over G, M, K and N
MEMBER_SHAPES = [(4, 4, 4096, 1024), (4, 48, 4096, 1024), (1, 5, 128, 40),
                 (2, 9, 256, 136), (3, 17, 384, 200), (4, 33, 128, 64),
                 (2, 48, 512, 1000), (5, 60, 256, 96)]


def _member_operands(g, m, k, n, chunk_rows, seed, form):
    """Codes, integer per-member rank-1 tables (1..3), integer chunk
    offsets, a dyadic gain per member and, in form 2, an integer
    chunk_gain: every chunk sum of the rebuilt weights is an exact
    integer.  Form 1 gives the rebuilt fp32
    weights instead of codes and tables."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    c = k // chunk_rows
    a_pos, a_neg = (f32(rng.integers(0, 32, (g, m, k))) for _ in range(2))
    codes = torch.from_numpy(rng.integers(-63, 64, (g, k, n)).astype(np.int8))
    col = f32(rng.integers(1, 4, (g, n)))
    row = f32(rng.integers(1, 4, (g, 1, k)))
    cg = f32(rng.integers(1, 3, (g, c, n))) if form == 2 else None
    # dyadic gains: fast mode's float totals are exact in any order too
    gain = f32(np.repeat(2.0 ** -rng.integers(6, 10, (g, 1)), n, axis=1))
    off = f32(rng.integers(-3, 4, (g, c, n)))
    return a_pos, a_neg, codes, col, row, cg, gain, off


def _member_w_eff(codes, col, row, cg, chunk_rows):
    w = (codes.float() * col[:, None, :]) * row[:, 0, :, None]
    if cg is not None:
        w = w * torch.repeat_interleave(cg, chunk_rows, dim=1)
    return w


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("form", [0, 1, 2])
@pytest.mark.parametrize("g,m,k,n", MEMBER_SHAPES)
def test_analog_mvm_split_members(cuda, g, m, k, n, form, faithful):
    """Per-member col_gain, row_gain, chunk offsets and chunk_gain (form
    2), or per-member fp32 weights (form 1): one launch, counted as a
    member launch, bit-exact against the plain version on integer
    tables, and each member bit-identical to its own 2-D launch."""
    from repro_torch.kernels.analog_mvm import (analog_mvm_split_codes_cuda,
                                                analog_mvm_split_cuda,
                                                analog_mvm_split_members_cuda)

    ops_ = _member_operands(g, m, k, n, 128, g * 31 + m + k + n + form,
                            form)
    a_pos, a_neg, codes, col, row, cg, gain, off = (
        None if t is None else t.to(cuda) for t in ops_)
    w = _member_w_eff(codes, col, row, cg, 128)
    ops.reset_launch_counts()
    if form == 1:
        got = analog_mvm_split_members_cuda(a_pos, a_neg, w.contiguous(),
                                            None, None, gain, off,
                                            faithful=faithful)
    else:
        got = analog_mvm_split_members_cuda(a_pos, a_neg, codes, col, row,
                                            gain, off, chunk_gain=cg,
                                            faithful=faithful)
    counts = ops.launch_counts()
    assert counts["analog_mvm_split_members"] == 1
    assert counts["analog_mvm_split"] == counts[
        "analog_mvm_split_experts"] == 0
    want = ref.analog_mvm_split_members_ref(
        a_pos.cpu(), a_neg.cpu(), w.cpu(), gain.cpu(), off.cpu(),
        faithful=faithful)
    assert torch.equal(got.cpu(), want)
    for i in range(g):
        if form == 1:
            solo = analog_mvm_split_cuda(a_pos[i], a_neg[i],
                                         w[i].contiguous(), gain[i], off[i],
                                         faithful=faithful)
        else:
            solo = analog_mvm_split_codes_cuda(
                a_pos[i], a_neg[i], codes[i].contiguous(), col[i], row[i],
                gain[i], off[i], faithful=faithful,
                chunk_gain=None if cg is None else cg[i].contiguous())
        assert torch.equal(got[i], solo)


@pytest.mark.parametrize("faithful", [True, False])
def test_shared_tables_reproduce_the_expert_axis(cuda, faithful):
    """Zero-stride (shared) tables: the expert axis's launch, bit for
    bit, still counted as an expert launch."""
    from repro_torch.kernels.analog_mvm import (analog_mvm_split_experts_cuda,
                                                analog_mvm_split_members_cuda)

    a_pos, a_neg, codes, _, _, _, gain, _ = (
        None if t is None else t.to(cuda)
        for t in _member_operands(4, 12, 512, 136, 128, 5, 0))
    ops.reset_launch_counts()
    experts = analog_mvm_split_experts_cuda(a_pos, a_neg, codes, gain,
                                            faithful=faithful)
    assert ops.launch_counts()["analog_mvm_split_experts"] == 1
    members = analog_mvm_split_members_cuda(a_pos, a_neg, codes, None, None,
                                            gain, None, faithful=faithful)
    assert ops.launch_counts()["analog_mvm_split_members"] == 1
    assert torch.equal(members, experts)


def test_batch_concat_group_on_card_matches_cpu(cuda):
    """An RWKV time-mix block compiled on the card: r/k/v/g in one member
    launch, bit-exact against the CPU's group on integer tables."""
    from repro_torch.models import rwkv as R

    g = torch.Generator().manual_seed(3)
    p = R.rwkv_init(g, 256, 4, device="cpu")
    rng = np.random.default_rng(4)
    for name in ("wr", "wk", "wv", "wg", "wo"):
        fpn = p[name]["fpn"]
        for t in ("col_gain", "row_gain"):
            fpn[t] = torch.from_numpy(rng.integers(1, 3, tuple(
                fpn[t].shape)).astype(np.float32))
        fpn["chunk_offset"] = torch.from_numpy(rng.integers(
            -2, 3, tuple(fpn["chunk_offset"].shape)).astype(np.float32))
    acfg = AnalogConfig(mode="analog_faithful")
    x = torch.randn((2, 6, 256), generator=g) * 0.3
    spec = R.rwkv_module_spec(256, 4)
    want = api.compile(spec, p, acfg, device="cpu").lower()["_groups"][
        "rkvg"]
    got = api.compile(spec, p, acfg, device=cuda).lower()["_groups"]["rkvg"]
    from repro_torch.exec.run import run_batch_concat

    xs = [x * (1 + i) for i in range(4)]
    ops.reset_launch_counts()
    ys = run_batch_concat(got, [t.to(cuda) for t in xs], acfg)
    assert ops.launch_counts()["analog_mvm_split_members"] == 1
    assert ops.launch_counts()["analog_mvm_split"] == 0
    for a, b in zip(ys, run_batch_concat(want, xs, acfg)):
        assert torch.equal(a.cpu(), b)


def test_divisions_are_exact_on_the_card(cuda):
    """The int8 KV cache's codes and scales, the cached decode's scores,
    the int8 gradient compression's scale and the learning-rate schedule
    on the card equal the CPU's bit for bit (PyTorch's CUDA division by a
    Python number multiplies by its rounded reciprocal; these sites pass
    the divisor as a tensor)."""
    from repro_torch.train import compression as C
    from repro_torch.train import optimizer as O

    rng = np.random.default_rng(9)
    t = torch.from_numpy(rng.standard_normal((3, 50, 4, 64))
                         .astype(np.float32) * 3)
    for a, b in zip(A._quantize_kv(t.to(cuda)), A._quantize_kv(t)):
        assert torch.equal(a.cpu(), b)
    # integer q and k: the dot products are exact, the division is what
    # is compared
    for hd in (24, 64, 96, 128):
        q = torch.from_numpy(rng.integers(-9, 10, (2, 3, 2, 2, hd))
                             .astype(np.float32))
        k = torch.from_numpy(rng.integers(-9, 10, (2, 7, 2, hd))
                             .astype(np.float32))
        assert torch.equal(A.decode_scores(q.to(cuda), k.to(cuda)).cpu(),
                           A.decode_scores(q, k))
    g = torch.from_numpy(rng.standard_normal((1000,)).astype(np.float32))
    for a, b in zip(C.compress(g.to(cuda)), C.compress(g)):
        assert torch.equal(a.cpu(), b)
    cfg = O.AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=1000)
    for step in (0, 1, 50, 100, 101, 537, cfg.total_steps):
        s = torch.tensor(step, dtype=torch.int32)
        assert torch.equal(O.schedule(cfg, s.to(cuda)).cpu(),
                           O.schedule(cfg, s))


# the split kernel's leading axis under autograd: the members (per-member
# integer rank-1 tables, chunk offsets) and the experts (table-free STE
# codes), on the card against the CPU.  The forward is the one launch,
# bit-exact; da and dw are fp32 products at "highest" precision summed in
# another order than the CPU's: within LEAD_GRAD_REL of their max
LEAD_GRAD_REL = 1e-5
LEAD_SHAPES = [(4, 48, 512, 256), (1, 5, 128, 40), (3, 9, 256, 136),
               (5, 33, 384, 64)]


def _lead_case(g, m, k, n, experts, device, seed):
    """Operands, a store as the training path lowers it (fp32 STE codes
    requiring grad; members also rank-1 tables requiring grad), gains,
    offsets and an output gradient, on ``device``."""
    from repro_torch.exec.plan import WeightStore

    a_pos, a_neg, codes, col, row, _, gain, off = _member_operands(
        g, m, k, n, 128, seed, 0)
    gy = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (g, m, n)).astype(np.float32))
    mv = (lambda t, grad=False: t.to(device).requires_grad_(grad))
    if experts:
        st = WeightStore(  # verify: allow-packed-weights
            codes=mv(codes.float(), True), w_scale=mv(torch.ones((g, 1, n))),
            gain=mv(gain[:, 0].contiguous()))
        off = None
    else:
        st = WeightStore(  # verify: allow-packed-weights
            codes=mv(codes.float(), True), w_scale=mv(torch.ones((g, 1, n))),
            gain=mv(gain), col_gain=mv(col, True), row_gain=mv(row, True))
        off = mv(off)
    return (mv(a_pos, True), mv(a_neg, True), st, mv(gain),
            None if off is None else off, mv(gy), codes)


def _lead_grads(case, experts, faithful):
    a_pos, a_neg, st, gain, off, gy, _ = case
    if experts:
        y = ops.analog_mvm_split(a_pos, a_neg, st.w_eff, st.gain_row, None,
                                 store=st, faithful=faithful)
    else:
        y = ops.analog_mvm_split_members(a_pos, a_neg, gain, off, store=st,
                                         faithful=faithful)
    return (y,) + torch.autograd.grad(y, (a_pos, a_neg, st.w_eff), gy)


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("experts", [False, True])
@pytest.mark.parametrize("g,m,k,n", LEAD_SHAPES)
def test_leading_axis_backward_on_card_matches_cpu(cuda, g, m, k, n, experts,
                                                   faithful):
    """The leading axis under autograd: one launch counted for its axis,
    the forward bit-exact against the CPU's, each of da_pos, da_neg and
    dw within LEAD_GRAD_REL of the CPU's max."""
    seed = g * 13 + m + k + n
    ops.reset_launch_counts()
    card = _lead_grads(_lead_case(g, m, k, n, experts, cuda, seed), experts,
                       faithful)
    counts = ops.launch_counts()
    kern = "analog_mvm_split_experts" if experts else \
        "analog_mvm_split_members"
    assert counts[kern] == 1 and sum(counts.values()) == 1
    cpu = _lead_grads(_lead_case(g, m, k, n, experts, torch.device("cpu"),
                                 seed), experts, faithful)
    assert torch.equal(card[0].detach().cpu(), cpu[0].detach())
    for a, b in zip(card[1:], cpu[1:]):
        err = float((a.cpu() - b).abs().max())
        assert err <= LEAD_GRAD_REL * float(b.abs().max())


@pytest.mark.parametrize("faithful", [True, False])
def test_expert_axis_reads_ste_codes_as_int8(cuda, faithful):
    """``_split_experts`` on a store of fp32 STE codes equals the call on
    the same codes packed to int8, bit for bit."""
    from repro_torch.exec.plan import WeightStore
    from repro_torch.kernels.analog_mvm import analog_mvm_split_experts_cuda

    a_pos, a_neg, st, gain, _, _, codes = _lead_case(6, 20, 256, 72, True,
                                                     cuda, 7)
    got = ops._split_experts(a_pos.detach(), a_neg.detach(), None,
                             st.gain_row, chunk_rows=128, faithful=faithful,
                             store=st)
    int8 = WeightStore(  # verify: allow-packed-weights
        codes=codes.to(cuda), w_scale=st.w_scale, gain=st.gain)
    want = ops._split_experts(a_pos.detach(), a_neg.detach(), None,
                              int8.gain_row, chunk_rows=128,
                              faithful=faithful, store=int8)
    assert torch.equal(got, want)
    post, gk = (None, st.gain_row) if faithful else (
        st.gain_row, torch.ones_like(st.gain_row))
    assert torch.equal(got, analog_mvm_split_experts_cuda(
        a_pos.detach(), a_neg.detach(), codes.to(cuda), gk, post_gain=post,
        faithful=faithful))


def _family_step(name, device, routes=None):
    """One train step of a SMOKE config (integer effective weights, fp32
    activations, static calibration: under dynamic calibration a last-bit
    difference between card and CPU flips a 5-bit code at a rounding tie
    now and then) on ``device``: loss, gradients, the state after AdamW
    and the parameters before it."""
    from repro_torch.core.noise import NOISELESS
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    cfg = configs.get_smoke(name)
    run = RunConfig(analog=AnalogConfig(mode="analog_faithful",
                                        noise=NOISELESS, act_calib="static"),
                    activation_dtype="float32", learning_rate=3e-4,
                    warmup_steps=1)
    saved = T.NOISE
    T.NOISE = NOISELESS
    try:
        state = TS.init_state(torch.Generator().manual_seed(0), cfg, run,
                              device="cpu")
    finally:
        T.NOISE = saved
    state = O.tree_map(lambda t: t.to(device), state)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 17))).to(device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params = O.tree_map(lambda t: t.clone(), state["params"])
    loss, _, grads = TS.loss_and_grads(state["params"], batch, cfg=cfg,
                                       run=run, routes=routes)
    TS.apply_update(state, grads, opt_cfg=TS.make_opt_config(run))
    return loss, grads, state, params


@pytest.mark.parametrize("name", ["rwkv6-7b", "qwen3-moe-30b-a3b"])
def test_family_train_step_on_card_matches_cpu(cuda, name):
    """One ``train_step`` on the rwkv6-7b and qwen3-moe SMOKE configs on
    the card against the CPU (the CPU's routes replayed): one member
    launch per RWKV layer and forward pass (the remat recompute is one),
    three expert launches per MoE layer and pass; the loss within 1e-6
    relative, every gradient leaf within 1e-5 of its max |grad|, a
    layer's w_scale, gain and a_scale (sums of cancelling terms) within
    2e-4 of it or, for a gain, of the scale of its terms (RWKV's r/k/v
    gains sum to zero: the group norm makes the loss invariant to their
    scale); the parameters after AdamW within 2 lr."""
    from repro_torch.models import moe as M
    from repro_torch.train import optimizer as O

    rec = M.Routes()
    cpu = _family_step(name, torch.device("cpu"), rec)
    ops.reset_launch_counts()
    card = _family_step(name, cuda, M.Routes(replay=rec.taken))
    counts = ops.launch_counts()
    n = configs.get_smoke(name).n_layers
    if name == "rwkv6-7b":
        assert counts["analog_mvm_split_members"] == 2 * n
        assert counts["analog_mvm_split"] == 2 * 3 * n + 1
    else:
        assert counts["analog_mvm_split_experts"] == 2 * 3 * n
    assert abs(float(card[0]) - float(cpu[0])) <= 1e-6 * abs(float(cpu[0]))

    def named(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from named(v, f"{path}/{k}")
        else:
            yield path, tree

    params, grads = dict(named(cpu[3])), dict(named(cpu[1]))
    for (path, a), (_, b) in zip(named(card[1]), named(cpu[1])):
        parent, leaf = path.rsplit("/", 1)
        scale = float(b.abs().max())
        if leaf == "gain":
            # the terms the gain's gradient sums: the dequantization
            # y_int * a_scale * w_scale / gain ties it to w_scale's
            terms = (params[f"{parent}/w_scale"]
                     * grads[f"{parent}/w_scale"]).abs()
            scale = max(scale, float((terms.reshape(b.shape + (-1,)).sum(-1)
                                      / params[path].abs()).max()))
        sums = leaf in ("w_scale", "gain", "a_scale")
        lim = (2e-4 if sums else 1e-5) * max(scale, 1e-30)
        assert float((a.cpu() - b).abs().max()) <= lim, path
    for a, b in zip(O.tree_leaves(card[2]["params"]),
                    O.tree_leaves(cpu[2]["params"])):
        assert float((a.cpu() - b).abs().max()) <= 2 * 3e-4 + 1e-6
