"""A ``WeightStore``'s fp32 ``w_eff`` is derived at its first read, not
when the store is built: the card's kernels read the int8 codes and the
gain tables, so a served store never holds the 4 bytes per weight of the
fp32 copy.  Held on the CPU (torch only):

- a calibrated store built by ``exec/lower.py`` holds no ``w_eff``
  until it is read; the first read has the bits of ``_derive_w_eff()``
  and is kept; the verifier's one-chunk probe derives none;
- a calibrated SMOKE engine's tokens and prefill logits are the same
  bits whether its stores derive lazily or all up front;
- with the card's dispatch emulated (``ops._on_cuda`` true, the split
  kernels replaced by their plain versions on the codes), a
  ``ServeEngine.serve``, a 2-D store's split call and a 3-D
  (batch_concat member axis) store's call under ``torch.no_grad()``
  derive nothing, and the engine's tokens equal the CPU's;
- a store lowered under autograd from masters that require grad (the
  HIL training step) derives at construction, its ``w_eff`` in the
  graph.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, calib, configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.exec.lower import lower_layer  # noqa: E402
from repro_torch.exec.plan import GroupPlan, LayerPlan  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ARCH = "phi4-mini-3.8b"
CFG = configs.get_smoke(ARCH)
RUN = RunConfig(analog=AnalogConfig(mode="analog_faithful"),
                activation_dtype="float32")


def _stores(tree):
    """Every WeightStore of a lowered tree (plans, groups, stacks)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _stores(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _stores(v)
    elif isinstance(tree, GroupPlan):
        yield tree.fused.store
    elif isinstance(tree, LayerPlan):
        yield tree.store


@functools.lru_cache(maxsize=None)
def _params(arch=ARCH):
    return T.lm_init(torch.Generator().manual_seed(0),
                     configs.get_smoke(arch), device="cpu")


@functools.lru_cache(maxsize=None)
def _snapshot():
    params = _params()
    spec = T.lm_module_spec(CFG, params)
    return calib.calibrate_model(spec, params,
                                 torch.Generator().manual_seed(2))


def _requests():
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, CFG.vocab_size,
                                               rng.integers(4, 9)),
                    max_new_tokens=3) for i in range(3)]


def test_calibrated_store_derives_at_first_read():
    params = _params()
    model = api.compile(T.lm_module_spec(CFG, params), params, RUN,
                        calibration=_snapshot(), device="cpu")
    tree = model.lower()
    stores = list(_stores(tree))
    head = tree["lm_head"]["_plan"].store
    assert head.chunk_gain is not None and len(stores) > 3
    assert not any(st.derived for st in stores)
    assert model.verify() == ()          # the full tier's probe included
    assert not any(st.derived for st in stores)
    want = head._derive_w_eff()
    got = head.w_eff
    assert head.derived and torch.equal(got, want)
    assert head.w_eff is got             # kept
    assert torch.equal(head._derive_w_eff(rows=96), want[:96])


def _prefill(engine, toks):
    cache = T.init_lm_cache(CFG, 2, 16, dtype=torch.float32, device="cpu")
    return engine.prefill(engine.params, {"tokens": toks}, cache)[0]


def test_calibrated_engine_unchanged_by_lazy_derivation():
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, CFG.vocab_size, (2, 7)))
    out = {}
    for eager in (False, True):
        eng = ServeEngine(CFG, RUN, _params(), batch_size=2, max_len=16,
                          calibration=_snapshot(), device="cpu")
        if eager:
            for st in _stores(eng.params):
                st.w_eff
        out[eager] = ([r.output.tolist() for r in eng.serve(_requests())],
                      _prefill(eng, toks))
    assert out[False][0] == out[True][0]
    assert torch.equal(out[False][1], out[True][1])


def _codes_split(a_pos, a_neg, codes, col_gain, row_gain, gain, off, *,
                 chunk_gain=None, col_blocks=None, chunk_rows=128,
                 faithful=True, epilogue=None):
    """The split kernel's code operand as its plain version computes it
    (stands in for the launch where the test emulates the card)."""
    assert chunk_gain is None and epilogue is None
    return ref.analog_mvm_split_codes_ref(
        a_pos, a_neg, codes, col_gain, row_gain, gain, off,
        col_blocks=col_blocks, chunk_rows=chunk_rows, faithful=faithful)


def _members_split(a_pos, a_neg, codes, col_gain, row_gain, gain, off, *,
                   chunk_gain=None, chunk_rows=128, faithful=True):
    assert chunk_gain is None
    return torch.stack([
        ref.analog_mvm_split_codes_ref(
            a_pos[g], a_neg[g], codes[g], col_gain[g], row_gain[g], gain[g],
            None if off is None else off[g], chunk_rows=chunk_rows,
            faithful=faithful)
        for g in range(codes.shape[0])])


def _emulate_card(monkeypatch):
    """The card's dispatch on CPU tensors: every wrapper takes its launch
    route, the split launches computed by their plain versions."""
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(ops, "analog_mvm_split_codes_cuda", _codes_split)
    monkeypatch.setattr(ops, "analog_mvm_split_members_cuda", _members_split)


@pytest.fixture
def card(monkeypatch):
    _emulate_card(monkeypatch)


def test_serve_on_the_card_derives_nothing(monkeypatch):
    want = [r.output.tolist() for r in ServeEngine(
        CFG, RUN, _params(), batch_size=2, max_len=16,
        device="cpu").serve(_requests())]
    _emulate_card(monkeypatch)
    eng = ServeEngine(CFG, RUN, _params(), batch_size=2, max_len=16,
                      device="cpu")
    got = [r.output.tolist() for r in eng.serve(_requests())]
    assert not any(st.derived for st in _stores(eng.params))
    assert got == want


def test_no_grad_calls_on_2d_and_3d_stores_derive_nothing(card,
                                                        monkeypatch):
    tree = api.lower_tree(_params(), RUN)
    lp = tree["lm_head"]["_plan"]
    rtree = api.lower_tree(_params("rwkv6-7b"), RUN)
    gp = [g for g in _groups(rtree) if g.fused.store.codes.ndim == 3]
    assert gp, "no batch_concat group in the RWKV tree"
    st3 = gp[0].fused
    g = torch.Generator().manual_seed(4)
    a = torch.randint(0, 32, (3, lp.k_pad), generator=g).float()
    k3 = st3.store.codes.shape
    a3 = torch.randint(0, 32, (k3[0], 3, k3[1]), generator=g).float()
    with torch.no_grad():
        ops.analog_mvm_split(a, a.flip(0), None, lp.gain_row,
                             lp.chunk_offset, store=lp.store)
        ops.analog_mvm_split_members(a3, a3.flip(1), st3.gain_row,
                                     st3.chunk_offset, store=st3.store)
    assert not lp.store.derived and not st3.store.derived
    # outside no_grad nothing requires grad either: still nothing derived
    ops.analog_mvm_split(a, a.flip(0), None, lp.gain_row, lp.chunk_offset,
                         store=lp.store)
    assert not lp.store.derived
    # the CPU's plain version reads the view, and derives it there
    monkeypatch.setattr(ops, "_on_cuda", lambda t: False)
    ops.analog_mvm_split(a, a.flip(0), lp.w_eff, lp.gain_row,
                         lp.chunk_offset, store=lp.store)
    assert lp.store.derived


def _groups(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _groups(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _groups(v)
    elif isinstance(tree, GroupPlan):
        yield tree


def test_store_lowered_under_autograd_derives_at_construction():
    params = T.stack_index(_params()["layers"]["l0"], 0)["mlp"]["up"]
    masters = {k: v.clone().requires_grad_(k == "w") if k != "fpn" else v
               for k, v in params.items()}
    lp = lower_layer(masters, RUN.analog)
    assert lp.store.derived and lp.store.records_grad()
    assert lp.store.w_eff.requires_grad
    with torch.no_grad():
        lp2 = lower_layer(masters, RUN.analog)
    assert not lp2.store.derived and not lp2.store.records_grad()
    assert torch.equal(lp2.store.w_eff, lp.store.w_eff.detach())
    assert not lp2.store.w_eff.requires_grad
