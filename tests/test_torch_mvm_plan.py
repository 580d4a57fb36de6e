"""The ``analog_mvm`` kernel's launch plan and its cut, shown on the CPU.

The CUDA kernel (``csrc/analog_mvm.cu``) runs only on the card
(tests/test_torch_cuda.py, ``chip_smoke.py``).  Its geometry is chosen
in Python (``mvm_plan``), so it is checked here:

- (a) the plan covers every output element and every chunk exactly once
  (the kernel's own index arithmetic, mirrored), fits the shared-memory
  limit, has a thread for each item, and gives a column tile that fits N
  (a multiple of 4, 4 to 128, never wider than N rounded up to 4); at
  the ECG shapes it fills the card: at batch 1 one CTA per row and 4
  columns, at batch 500 one wave of at least half the SMs;
- (b) a plain mirror of the kernel's cut - each CTA's tile, each step's
  chunks side by side, every chunk's readout (faithful) or pre-round
  value (fast) in its own slot, the owner adding the slots in ascending
  chunk order - equals the plain version ``analog_mvm_ref`` bit for bit
  in both modes, on non-integer weights, for 1-4 chunks, and with
  integer weights the JAX package's Pallas kernel in interpret mode.

Tolerance: bit-exact throughout.  The mirror computes each chunk's dot as
the plain version does; what it checks is the cut and the order of the
chunk sum (the plain version's sum over at most 4 chunks runs in
ascending order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.analog_mvm import (  # noqa: E402
    MVM_SMEM_LIMIT, MVM_THREADS, mvm_plan, mvm_smem_bytes)

SMS = 132  # the H100's SMs
CHUNK = 128
# the ECG classifier's three layers (conv, fc1, fc2) as M x K x N
ECG = {1: ((32, 128, 8), (1, 256, 123), (1, 128, 10)),
       500: ((16000, 128, 8), (500, 256, 123), (500, 128, 10))}


def _thread_items(plan):
    """Per thread of a CTA, the kernel's (part, row, first column) and
    whether it computes (``tid < tm * tn / 4 * ways``)."""
    tid = np.arange(MVM_THREADS)
    groups = plan.tn // 4
    owners = plan.tm * groups
    part = tid // owners
    loc = tid - part * owners
    row = loc // groups
    return part, row, 4 * (loc - row * groups), part < plan.ways


def _exactly_once(idx, size):
    counts = np.bincount(idx[idx < size], minlength=size)
    return bool((counts == 1).all())


@pytest.mark.parametrize("n_chunks", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 8, 10, 123, 129, 700])
@pytest.mark.parametrize("m", [1, 32, 500, 16000])
def test_plan_covers_and_fits(m, n, n_chunks):
    plan = mvm_plan(m, n, n_chunks, CHUNK, SMS)
    assert plan.tn % 4 == 0 and 4 <= plan.tn <= min(128, -(-n // 4) * 4)
    assert plan.row_groups == -(-m // plan.tm)
    assert plan.col_tiles == -(-n // plan.tn)
    assert plan.smem == mvm_smem_bytes(plan.tm, plan.tn, plan.ways,
                                       plan.stages, CHUNK)
    assert plan.smem <= MVM_SMEM_LIMIT
    steps = -(-n_chunks // plan.ways)
    assert 1 <= plan.stages <= min(steps, 4)

    part, row, col, active = _thread_items(plan)
    # inside a CTA, every (part, row, 4 columns) has its thread, once
    cells = (part * plan.tm + row) * (plan.tn // 4) + col // 4
    n_cells = plan.ways * plan.tm * (plan.tn // 4)
    assert active.sum() == n_cells and _exactly_once(cells[active], n_cells)
    # the grid's tiles cover every row and column once, the steps every
    # chunk once
    rows = np.arange(plan.row_groups)[:, None] * plan.tm + np.arange(plan.tm)
    cols = np.arange(plan.col_tiles)[:, None] * plan.tn + np.arange(plan.tn)
    chunks = np.arange(steps)[:, None] * plan.ways + np.arange(plan.ways)
    assert _exactly_once(rows.ravel(), m)
    assert _exactly_once(cols.ravel(), n)
    assert _exactly_once(chunks.ravel(), n_chunks)


@pytest.mark.parametrize("b", [1, 500])
def test_plan_fills_the_card_at_ecg_shapes(b):
    for m, k, n in ECG[b]:
        plan = mvm_plan(m, n, k // CHUNK, CHUNK, SMS)
        ctas = plan.row_groups * plan.col_tiles
        # no tile wider than N needs: conv (N = 8) and fc2 (N = 10) no
        # longer mask 7/8 and 54/64 of a 64-column tile
        assert plan.tn <= -(-n // 4) * 4
        # every chunk of a step side by side (fc1's two chunks)
        assert plan.ways == k // CHUNK and plan.stages == 1
        if b == 1:
            assert (plan.tm, plan.tn) == (1, 4)
            assert ctas == m * -(-n // 4)
        else:
            assert SMS // 2 < ctas <= SMS


def _mirror(a, w, gain, off, plan, faithful, chunk_rows):
    """The kernel's cut in plain PyTorch: per CTA tile and step, each
    chunk's value in its own slot, the owner adding them in ascending
    chunk order from 0."""
    m, k = a.shape
    n = w.shape[1]
    c_all = k // chunk_rows
    # each chunk's dot as the plain version computes it
    dots = torch.einsum("mck,ckn->mcn", a.reshape(m, c_all, chunk_rows),
                        w.reshape(c_all, chunk_rows, n))
    out = torch.empty((m, n))
    steps = -(-c_all // plan.ways)
    for rg in range(plan.row_groups):
        rows = slice(rg * plan.tm, min(m, (rg + 1) * plan.tm))
        for ct in range(plan.col_tiles):
            cols = slice(ct * plan.tn, min(n, (ct + 1) * plan.tn))
            tot = torch.zeros((rows.stop - rows.start, cols.stop - cols.start))
            for s in range(steps):
                slots = []
                for p in range(plan.ways):
                    c = s * plan.ways + p
                    if c >= c_all:
                        break
                    v = dots[rows, c, cols] * gain[cols] + off[c, cols]
                    if faithful:
                        v = torch.clamp(torch.round(v), -128.0, 127.0)
                    slots.append(v)
                for v in slots:
                    tot = tot + v
            if not faithful:
                tot = torch.clamp(torch.round(tot), -128.0 * c_all,
                                  127.0 * c_all)
            out[rows, cols] = tot
    return out


def _inputs(seed, m, k, n, integer):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 32, (m, k)).astype(np.float32)
    w = rng.integers(-63, 64, (k, n)).astype(np.float32)
    if not integer:  # the fixed-pattern gain map: non-integer w_eff
        w = (w * (1 + 0.02 * rng.standard_normal((k, n)))).astype(np.float32)
    gain = np.full((n,), 0.02, np.float32)
    off = rng.standard_normal((k // CHUNK, n)).astype(np.float32)
    return [torch.from_numpy(v) for v in (a, w, gain, off)]


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 4])
@pytest.mark.parametrize("m,n", [(1, 123), (37, 10), (500, 8)])
@pytest.mark.parametrize("faithful", [True, False])
def test_mirror_of_the_cut_equals_the_plain_version(m, n, n_chunks,
                                                    faithful):
    k = n_chunks * CHUNK
    t = _inputs(m * 10 + n_chunks, m, k, n, integer=False)
    want = ref.analog_mvm_ref(*t, faithful=faithful)
    # the plan the card takes, and cuts that put 1 and 2 chunks side by
    # side and walk the rest in steps
    plans = {mvm_plan(m, n, n_chunks, CHUNK, SMS)}
    for ways in {1, min(2, n_chunks)}:
        plans.add(mvm_plan(m, n, n_chunks, CHUNK, SMS)._replace(ways=ways))
    for plan in plans:
        got = _mirror(*t, plan, faithful, CHUNK)
        assert torch.equal(got, want), plan


@pytest.mark.parametrize("faithful", [True, False])
def test_mirror_matches_pallas_on_integer_weights(faithful):
    """With integer w_eff every chunk's dot is exact: the mirror of the
    cut equals the JAX package's kernel, epilogue included."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.analog_mvm import analog_mvm_pallas

    m, k, n = 9, 3 * CHUNK, 70
    t = _inputs(5, m, k, n, integer=True)
    plan = mvm_plan(m, n, 3, CHUNK, SMS)
    assert plan.ways > 1
    epi = ("relu_shift", 2)
    want = analog_mvm_pallas(*(jnp.asarray(v.numpy()) for v in t),
                             faithful=faithful, interpret=True, epilogue=epi)
    got = ref.adc_epilogue_ref(_mirror(*t, plan, faithful, CHUNK), epi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.device_get(
        want)))
