"""Hardware-in-the-loop training of the MoE, M-RoPE and audio families in
the port against the JAX package, on the CPU: the split kernel's leading
axis under autograd (a batch_concat group's members and an MoE expert
stack's experts), the recurrences' segmented backward, softplus's
gradient, M-RoPE through flash attention, and one train step on the
qwen3-moe and llama4-maverick SMOKE configs (the other families' steps
are in ``test_torch_family_train_embeds.py`` and
``test_torch_family_train_recurrent.py``, which share :func:`check_step`).

Parameters are drawn once in the port (``NOISELESS`` fixed pattern, so
every effective weight of a train step is an integer) and carried to the
reference as numpy; kernel-level cases take the reference's draw through
``convert.params_from_numpy``.  Activations are fp32.  The JAX side of a
train step is jitted, as its own tests run it.  Tolerances:

- the leading axis's backward against the reference (the vmapped custom
  VJP of ``analog_mvm_split`` for the members, ``jax.grad`` of
  ``_analog_expert_matmul`` for the experts, faithful and fast): forward
  bit-exact on integer tables, every gradient within GRAD_REL of its
  leaf's max |grad| (fp32 products summed in another order; measured:
  below 1e-7), a layer's calibration scalars (LAYER_SUMS: a static
  ``a_scale``, ``w_scale``, ``gain``) within LAYER_SUM_TOL of it (their
  gradient sums a column or a layer of terms that cancel).
- the fused group against its G solo dispatches, and an expert stack
  against its E per-expert 2-D calls, in the port: every gradient within
  1e-6 of its leaf's max (a batched product against G single ones).
- ``wkv_scan`` / ``ssd_scan`` gradients against ``jax.grad`` through the
  reference's ``lax.scan``: within GRAD_REL of each leaf's max; the
  segmented backward against plain autograd through the loop: forward
  bit-identical, gradients bit-identical but ``wkv``'s ``u`` (within
  1e-6: its per-step terms sum in another order).
- train steps (:func:`check_step`): the loss within 1e-6 relative; every
  gradient leaf within GRAD_REL of its max |grad| (measured: 7e-6),
  except a layer's calibration scalars (LAYER_SUMS), whose gradient
  sums a column or a layer of terms that cancel: within LAYER_SUM_TOL of
  the larger of their max |grad| and the scale of their terms
  (:func:`_sum_scale`); the parameters after AdamW as in
  ``test_torch_lm_train.py`` (where the clipped gradient is at least
  1e-4, within ``atol = 1e-6, rtol = 1e-5``; elsewhere within ``2 lr``).
  A LayerNorm family's dynamic-calibration step flips a 5-bit code at an
  ulp tie (ROADMAP "Differences to know"): the loss within TIE_LOSS_REL,
  the gradients and the global norm within TIE_GRAD_REL, the parameters
  within ``2 lr``; its static-calibration step has no tie and is held
  at the fp32 tolerances above.
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
from repro.core.analog import analog_linear_init as janalog_linear_init  # noqa: E402
from repro.core.noise import NOISELESS as JNOISELESS  # noqa: E402
from repro.core.noise import NoiseConfig as JNoiseConfig  # noqa: E402
from repro.exec.lower import lower_batch_concat as jlower_batch_concat  # noqa: E402
from repro.exec.plan import GroupPlan as JGroupPlan  # noqa: E402
from repro.exec.run import run_batch_concat as jrun_batch_concat  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import rwkv as JR  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy, state_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.noise import NOISELESS  # noqa: E402
from repro_torch.exec.lower import lower_batch_concat, lower_layer  # noqa: E402
from repro_torch.exec.plan import GroupPlan  # noqa: E402
from repro_torch.exec.run import (dispatch_count, reset_dispatch_count,  # noqa: E402
                                  run_batch_concat, run_layer)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

NAMES = ("wr", "wk", "wv", "wg")
D = 64
GRAD_REL = 1e-5
LAYER_SUMS = ("w_scale", "gain", "a_scale")
LAYER_SUM_TOL = 2e-4
STATE_TOL = dict(atol=1e-6, rtol=1e-5)
# a dynamic-calibration step whose LayerNorm flips a 5-bit code at an ulp
# tie (XLA's and PyTorch's mean / rsqrt differ by an ulp on the CPU):
# measured 4.4e-4 on the loss, 0.11 of a leaf's max on the gradients
TIE_LOSS_REL = 1e-3
TIE_GRAD_REL = 0.25
MODES = ("analog_faithful", "analog_fast")
B, SEQ = 2, 16


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _pairs(a, b, path=""):
    """(path, a-leaf, b-leaf) over two nested dicts (``a``'s keys)."""
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def _rel_close(got, want, rel, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    lim = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= lim, f"{what}: {err} > {lim}"


def _leaf_close(path, got, want, rel):
    """A gradient leaf within ``rel`` of its max |grad|, or a layer's
    calibration scalar (LAYER_SUMS) within LAYER_SUM_TOL of it."""
    if path.rsplit("/", 1)[-1] in LAYER_SUMS:
        rel = max(rel, LAYER_SUM_TOL)
    _rel_close(got, want, rel, path)


def _leaves(tree):
    """Leaf views of a tree of tensors that record gradients."""
    if isinstance(tree, dict):
        return {k: _leaves(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    else:
        yield path, tree


# ------------------------------------------------------------ leading axis
@functools.lru_cache(maxsize=None)
def _members(integer: bool):
    """Four same-geometry analog layers of the reference's draw (rank-1
    fixed pattern and chunk offsets); ``integer``: integer rank-1 tables
    and offsets, so every ``w_eff`` is an integer and the forward exact.
    Their static ``a_scale`` differ by member."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(4):
        p = jax.tree.map(np.asarray, janalog_linear_init(
            jax.random.PRNGKey(i), D, D, noise=JNoiseConfig()))
        p["a_scale"] = np.float32(p["a_scale"] * (1 + 0.5 * i))
        if integer:
            fpn = p["fpn"]
            fpn["col_gain"] = rng.integers(1, 3, D).astype(np.float32)
            fpn["row_gain"] = rng.integers(1, 3, D).astype(np.float32)
            fpn["chunk_offset"] = rng.integers(
                -2, 3, fpn["chunk_offset"].shape).astype(np.float32)
        out.append(p)
    return out


def _x(seed, shape=(B, 6, D), scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _group_inputs(integer):
    xs = [_x(20 + i, scale=0.2 + 0.1 * i) for i in range(4)]
    gys = [_x(60 + i, scale=1.0) for i in range(4)]
    return _members(integer), xs, gys


def _port_group_grads(ps_np, xs, gys, acfg, fused=True):
    """Gradients of ``sum_i <y_i, gy_i>`` with respect to the member
    parameters and inputs: through the fused group (one dispatch), or
    through the G solo dispatches."""
    ps = [_leaves(params_from_numpy(p, "cpu")) for p in ps_np]
    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    reset_dispatch_count()
    if fused:
        gp = GroupPlan("batch_concat", lower_batch_concat(ps, acfg), NAMES,
                       (D,) * 4)
        ys = run_batch_concat(gp, txs, acfg)
        assert dispatch_count() == 1
    else:
        ys = [run_layer(lower_layer(p, acfg), x, acfg)
              for p, x in zip(ps, txs)]
    loss = sum((y * torch.from_numpy(g)).sum() for y, g in zip(ys, gys))
    leaves = [t for p in ps for _, t in _flat(p)] + txs
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    out = [{path: next(grads) for path, _ in _flat(p)} for p in ps]
    return out, [next(grads) for _ in txs], [y.detach() for y in ys]


class TestLeadingAxis:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("act_calib", ["dynamic", "static"])
    def test_group_grads_match_the_reference_vmap(self, mode, act_calib):
        """The fused r/k/v/g group under autograd against the reference's
        ``jax.grad`` of its group (``vmap`` of ``run_layer``, each member
        through ``analog_mvm_split``'s custom VJP): the outputs bit-exact
        on integer tables, every member's parameter and input gradients
        within GRAD_REL of their max."""
        jacfg = JAnalogConfig(mode=mode, act_calib=act_calib)
        acfg = AnalogConfig(mode=mode, act_calib=act_calib)
        ps_np, xs, gys = _group_inputs(True)

        def jloss(ps, xs):
            gp = JGroupPlan("batch_concat",
                            jlower_batch_concat(list(ps), jacfg), NAMES,
                            (D,) * 4)
            ys = jrun_batch_concat(gp, list(xs), jacfg)
            return sum(jnp.sum(y * g) for y, g in zip(ys, gys)), ys

        (_, jys), (jgp, jgx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(
            tuple(jax.tree.map(jnp.asarray, p) for p in ps_np),
            tuple(jnp.asarray(x) for x in xs))
        gp, gx, ys = _port_group_grads(ps_np, xs, gys, acfg)
        for y, jy in zip(ys, jys):
            np.testing.assert_array_equal(_np(y), np.asarray(jy))
        for i in range(4):
            _rel_close(gx[i], jgx[i], GRAD_REL, f"x{i}")
            for path, want in _flat(jgp[i]):
                got = gp[i][path]
                got = torch.zeros(np.shape(want)) if got is None else got
                _leaf_close(f"member {i} {path}", got, want, GRAD_REL)

    @pytest.mark.parametrize("mode", MODES)
    def test_member_axis_backward_matches_the_vmapped_vjp(self, mode):
        """``ops.analog_mvm_split_members`` alone: ``da_pos``, ``da_neg``
        and ``dw`` against the reference's ``vmap`` of
        ``analog_mvm_split``'s VJP, per-member gains and offsets."""
        rng = np.random.default_rng(5)
        g, m, k, n = 3, 5, 256, 24
        a_pos, a_neg = (rng.integers(0, 32, (g, m, k)).astype(np.float32)
                        for _ in range(2))
        w = rng.integers(-63, 64, (g, k, n)).astype(np.float32)
        gain = np.repeat(2.0 ** -rng.integers(6, 9, (g, 1)), n, 1).astype(
            np.float32)
        off = rng.integers(-2, 3, (g, k // 128, n)).astype(np.float32)
        gy = rng.standard_normal((g, m, n)).astype(np.float32)
        faithful = mode == "analog_faithful"

        def jf(ap, an, ww):
            return jax.vmap(lambda a, b, c, d, e: jops.analog_mvm_split(
                a, b, c, d, e, 128, faithful, False, True))(
                ap, an, ww, jnp.asarray(gain), jnp.asarray(off))

        jy, vjp = jax.vjp(jf, *(jnp.asarray(t) for t in (a_pos, a_neg, w)))
        jgrads = vjp(jnp.asarray(gy))
        from repro_torch.exec.plan import WeightStore
        ta, tn, tw = (torch.tensor(t, requires_grad=True)
                      for t in (a_pos, a_neg, w))
        store = WeightStore(  # verify: allow-packed-weights
            codes=tw, w_scale=torch.ones((g, 1, n)),
            gain=torch.from_numpy(gain))
        y = ops.analog_mvm_split_members(
            ta, tn, torch.from_numpy(gain), torch.from_numpy(off),
            store=store, faithful=faithful)
        np.testing.assert_array_equal(_np(y), np.asarray(jy))
        got = torch.autograd.grad(y, (ta, tn, tw), torch.from_numpy(gy))
        for what, t, want in zip(("da_pos", "da_neg", "dw"), got, jgrads):
            _rel_close(t, want, GRAD_REL, what)

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("act_calib", ["dynamic", "static"])
    def test_fused_group_grads_equal_the_solo_dispatches(self, mode,
                                                         act_calib):
        """One member-axis dispatch under autograd against the four solo
        dispatches (each a 2-D ``analog_mvm_split`` with its own HIL
        backward), on the float rank-1 fixed pattern: outputs bit-exact,
        every gradient within 1e-6 of its leaf's max."""
        acfg = AnalogConfig(mode=mode, act_calib=act_calib)
        ps_np, xs, gys = _group_inputs(False)
        fp, fx, fy = _port_group_grads(ps_np, xs, gys, acfg)
        sp, sx, sy = _port_group_grads(ps_np, xs, gys, acfg, fused=False)
        for i in range(4):
            np.testing.assert_array_equal(_np(fy[i]), _np(sy[i]))
            _rel_close(fx[i], sx[i], 1e-6, f"x{i}")
            for path, want in sp[i].items():
                got = fp[i][path]
                if want is None:
                    assert got is None or not bool(got.any()), path
                    continue
                _leaf_close(f"member {i} {path}", got, want, 1e-6)

    @pytest.mark.parametrize("mode", MODES)
    def test_expert_products_match_jax_grad(self, mode):
        """The expert axis under autograd (the per-call path: the stack
        lowered with fp32 STE codes, one split call over the experts)
        against ``jax.grad`` of the reference's ``_analog_expert_matmul``:
        faithful mode freezes the gain in the product, fast mode passes
        the gradient through ``clip(round_ste(total * gain))`` and into
        the gain; in both the statistical gain reaches the masters
        through the dequantization."""
        rng = np.random.default_rng(3)
        e, c, k, n = 3, 5, 200, 40
        x = rng.standard_normal((e, c, k)).astype(np.float32)
        w = (rng.standard_normal((e, k, n)) * 0.1).astype(np.float32)
        gy = rng.standard_normal((e, c, n)).astype(np.float32)

        def jf(x, w):
            y = JM._analog_expert_matmul(x, w, JAnalogConfig(mode=mode))
            return jnp.sum(y * gy), y

        (_, jy), (jgx, jgw) = jax.value_and_grad(
            jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))
        tx, tw = (torch.tensor(t, requires_grad=True) for t in (x, w))
        y = M._analog_expert_matmul(tx, tw, AnalogConfig(mode=mode))
        gx, gw = torch.autograd.grad((y * torch.from_numpy(gy)).sum(),
                                     (tx, tw))
        _rel_close(y, jy, 1e-6, "y")
        _rel_close(gx, jgx, GRAD_REL, "dx")
        _rel_close(gw, jgw, GRAD_REL, "dw")

    def test_expert_stack_grads_equal_per_expert_split_calls(self):
        """The expert axis's HIL backward (faithful) against E separate
        2-D ``analog_mvm_split`` calls at each expert's gain, on the same
        STE codes: outputs bit-exact, gradients within 1e-6."""
        from repro_torch.exec.lower import lower_expert_stack

        rng = np.random.default_rng(8)
        e, m, k, n = 4, 6, 256, 32
        a_pos, a_neg = (rng.integers(0, 32, (e, m, k)).astype(np.float32)
                        for _ in range(2))
        w = (rng.standard_normal((e, k, n)) * 0.1).astype(np.float32)
        gy = torch.from_numpy(rng.standard_normal((e, m, n)).astype(
            np.float32))
        out = {}
        for fused in (True, False):
            tw = torch.tensor(w, requires_grad=True)
            ta, tn = (torch.tensor(t, requires_grad=True)
                      for t in (a_pos, a_neg))
            lp = lower_expert_stack(tw, AnalogConfig())
            assert lp.store.codes.dtype == torch.float32
            gain = lp.gain_row
            if fused:
                y = ops.analog_mvm_split(ta, tn, lp.w_eff, gain, None,
                                         store=lp.store)
            else:
                y = torch.stack([ops.analog_mvm_split(
                    ta[i], tn[i], lp.w_eff[i], gain[i], None)
                    for i in range(e)])
            out[fused] = (y, torch.autograd.grad((y * gy).sum(),
                                                 (ta, tn, tw)))
        np.testing.assert_array_equal(_np(out[True][0]), _np(out[False][0]))
        for what, a, b in zip(("da_pos", "da_neg", "dw"), out[True][1],
                              out[False][1]):
            _rel_close(a, b, 1e-6, what)

    def test_expert_stack_serves_int8_and_trains_on_ste_codes(self):
        """``lower_expert_stack`` packs int8 codes without autograd (the
        serve path, unchanged) and keeps fp32 STE codes of the same
        integers when the weights require grad."""
        from repro_torch.exec.lower import lower_expert_stack

        w = torch.randn((2, 130, 16), generator=torch.Generator()
                        .manual_seed(0)) * 0.1
        served = lower_expert_stack(w, AnalogConfig())
        trained = lower_expert_stack(w.clone().requires_grad_(True),
                                     AnalogConfig())
        assert served.store.codes.dtype == torch.int8
        assert trained.store.codes.dtype == torch.float32
        assert trained.store.codes.requires_grad
        assert torch.equal(served.store.codes.float(),
                           trained.store.codes.detach())
        assert torch.equal(served.store.gain, trained.store.gain.detach())


# -------------------------------------------------------------- the scans
def _scan_inputs(kind, t=10):
    rng = np.random.default_rng(4)
    if kind == "wkv":
        shape = (B, t, 2, 8)
        r, k, v = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(3))
        w = rng.uniform(0.5, 0.99, shape).astype(np.float32)
        u = rng.standard_normal(shape[2:]).astype(np.float32)
        s0 = rng.standard_normal((B, 2, 8, 8)).astype(np.float32)
        return (r, k, v, w, u, s0), (B, 2, 8, 8)
    h, p, n = 3, 4, 5
    xh = rng.standard_normal((B, t, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, t, h)).astype(np.float32)
    a = np.exp(-dt).astype(np.float32)
    bb, cc = (rng.standard_normal((B, t, n)).astype(np.float32)
              for _ in range(2))
    s0 = rng.standard_normal((B, h, p, n)).astype(np.float32)
    return (xh, dt, a, bb, cc, s0), (B, h, p, n)


def _scan_fns(kind):
    return (R.wkv_scan, JR.wkv_scan) if kind == "wkv" else \
        (S.ssd_scan, JS.ssd_scan)


def _port_scan(kind, args, gy, gs):
    fn = _scan_fns(kind)[0]
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y, s = fn(*ts)
    loss = (y * torch.from_numpy(gy)).sum() + (s * torch.from_numpy(gs)).sum()
    return y.detach(), s.detach(), torch.autograd.grad(loss, ts)


class TestSegmentedScans:
    @pytest.mark.parametrize("kind", ["wkv", "ssd"])
    def test_grads_match_jax_grad_through_lax_scan(self, kind, monkeypatch):
        """Segments of 3 steps over 10 (a ragged last one) against
        ``jax.grad`` through the reference's scan."""
        monkeypatch.setattr(L, "SCAN_SEGMENT", 3)
        args, sshape = _scan_inputs(kind)
        rng = np.random.default_rng(9)
        ys_shape = args[0].shape
        gy = rng.standard_normal(ys_shape).astype(np.float32)
        gs = rng.standard_normal(sshape).astype(np.float32)
        jfn = _scan_fns(kind)[1]

        def jf(*a):
            y, s = jfn(*a)
            return jnp.sum(y * gy) + jnp.sum(s * gs)

        jg = jax.grad(jf, argnums=tuple(range(6)))(*map(jnp.asarray, args))
        _, _, tg = _port_scan(kind, args, gy, gs)
        for i, (a, b) in enumerate(zip(tg, jg)):
            _rel_close(a, b, GRAD_REL, f"{kind} arg {i}")

    @pytest.mark.parametrize("kind", ["wkv", "ssd"])
    def test_segments_equal_plain_autograd(self, kind, monkeypatch):
        """The segmented backward (segments of 4 over 10 steps) against
        plain autograd through the loop (``SCAN_SEGMENT = None``): the
        forward bit-identical (the same loop), the gradients bit-identical
        except ``wkv``'s ``u`` (its per-step terms sum in another order:
        within 1e-6 of its max)."""
        args, sshape = _scan_inputs(kind)
        rng = np.random.default_rng(10)
        gy = rng.standard_normal(args[0].shape).astype(np.float32)
        gs = rng.standard_normal(sshape).astype(np.float32)
        monkeypatch.setattr(L, "SCAN_SEGMENT", None)
        whole = _port_scan(kind, args, gy, gs)
        monkeypatch.setattr(L, "SCAN_SEGMENT", 4)
        parts = _port_scan(kind, args, gy, gs)
        np.testing.assert_array_equal(_np(parts[0]), _np(whole[0]))
        np.testing.assert_array_equal(_np(parts[1]), _np(whole[1]))
        for i, (a, b) in enumerate(zip(parts[2], whole[2])):
            if kind == "wkv" and i == 4:
                _rel_close(a, b, 1e-6, "u")
            else:
                np.testing.assert_array_equal(_np(a), _np(b),
                                              err_msg=f"{kind} arg {i}")

    @pytest.mark.parametrize("kind", ["wkv", "ssd"])
    def test_autograd_forward_is_the_serving_loop(self, kind, monkeypatch):
        """Under autograd the forward is the serving loop's, bit for bit
        (the segmented function runs it and keeps the segment starts);
        without autograd no function is recorded."""
        monkeypatch.setattr(L, "SCAN_SEGMENT", 3)
        args, _ = _scan_inputs(kind)
        fn = _scan_fns(kind)[0]
        with torch.no_grad():
            y0, s0 = fn(*(torch.from_numpy(a) for a in args))
        y1, s1 = fn(*(torch.tensor(a, requires_grad=True) for a in args))
        assert y1.grad_fn is not None and y0.grad_fn is None
        np.testing.assert_array_equal(_np(y1), _np(y0))
        np.testing.assert_array_equal(_np(s1), _np(s0))

    def test_softplus_gradient_is_logaddexps(self):
        """``_softplus``'s gradient is ``logaddexp``'s ``exp(x - out)``:
        0.5 at exactly 0 (an analog ``in_proj`` puts ADC codes of 0 on
        ``dt`` all the time), against ``jax.grad`` of
        ``jax.nn.softplus``."""
        x = np.array([-30.0, -2.0, -0.0, 0.0, 1e-3, 3.0, 25.0], np.float32)
        t = torch.tensor(x, requires_grad=True)
        (g,) = torch.autograd.grad(S._softplus(t).sum(), (t,))
        want = jax.grad(lambda a: jnp.sum(jax.nn.softplus(a)))(
            jnp.asarray(x))
        np.testing.assert_allclose(_np(g), np.asarray(want), rtol=1e-6,
                                   atol=0)
        assert float(g[3]) == 0.5


# ------------------------------------------------------------ M-RoPE flash
@pytest.mark.parametrize("mode", ["digital", "analog_faithful"])
def test_mrope_attention_trains_through_flash(mode):
    """M-RoPE attention past ``flash_threshold`` (the flash path and its
    blockwise backward) on distinct (t, h, w) positions, against
    ``jax.grad`` of the reference's attention at its own threshold:
    every parameter and input gradient within GRAD_REL of its max."""
    cfg = configs.get_smoke("qwen2-vl-7b")
    jp = jax.tree.map(np.asarray, JA.attention_init(
        jax.random.PRNGKey(2), cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
        cfg.hd, noise=JNOISELESS))
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((B, SEQ, cfg.d_model)) * 0.5).astype(np.float32)
    pos = rng.integers(0, 3 * SEQ, (B, SEQ, 3)).astype(np.int32)
    gy = rng.standard_normal((B, SEQ, cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.hd, rope_theta=cfg.rope_theta, mrope=True,
              flash_threshold=4)

    def jf(p, x):
        y, _ = JA.attention_apply(p, x, positions=jnp.asarray(pos),
                                  acfg=JAnalogConfig(mode=mode), **kw)
        return jnp.sum(y * gy)

    jgp, jgx = jax.jit(jax.grad(jf, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = _leaves(params_from_numpy(jp, "cpu"))
    tx = torch.tensor(x, requires_grad=True)
    y, _ = A.attention_apply(tp, tx, positions=torch.from_numpy(pos),
                             acfg=AnalogConfig(mode=mode),
                             flash_blocks=(8, 8), **kw)
    leaves = [t for _, t in _flat(tp)]
    grads = torch.autograd.grad((y * torch.from_numpy(gy)).sum(),
                                leaves + [tx], allow_unused=True)
    _rel_close(grads[-1], jgx, GRAD_REL, "x")
    for (path, want), got in zip(_flat(jgp), grads[:-1]):
        if got is None:
            assert not np.abs(np.asarray(want)).any(), path
            continue
        _rel_close(got, want, GRAD_REL, path)


# -------------------------------------------------------------- train steps
def _runs(mode, act_calib="dynamic"):
    kw = dict(mode=mode, act_calib=act_calib)
    common = dict(activation_dtype="float32", learning_rate=1e-3,
                  warmup_steps=1)
    return (JRunConfig(analog=JAnalogConfig(noise=JNOISELESS, **kw),
                       **common),
            RunConfig(analog=AnalogConfig(noise=NOISELESS, **kw), **common))


@functools.lru_cache(maxsize=None)
def _params_np(name):
    """The port's ``lm_init`` draw (NOISELESS fixed pattern) as numpy."""
    saved = T.NOISE
    T.NOISE = NOISELESS
    try:
        p = T.lm_init(torch.Generator().manual_seed(0),
                      configs.get_smoke(name), device="cpu")
    finally:
        T.NOISE = saved

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return node.numpy()

    return conv(p)


def _batch(cfg, seed=1):
    """Tokens, or precomputed embeddings (the reference's
    ``tests/test_archs.py`` batch); distinct (t, h, w) positions under
    M-RoPE."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ))}
    else:
        b = {"embeds": (rng.standard_normal((B, SEQ, cfg.d_model)) * 0.1)
             .astype(np.float32)}
    b["labels"] = rng.integers(0, cfg.vocab_size, (B, SEQ))
    if cfg.mrope:
        b["positions"] = rng.integers(0, 3 * SEQ, (B, SEQ, 3))
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
          for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    return jb, tb


def _sum_scale(path, params, grads):
    """The scale of the terms a layer's calibration scalar sums: for its
    ``gain``, ``sum_n |w_scale_n * dL/dw_scale_n| / |gain|`` (the
    dequantization ``y_int * a_scale * w_scale / gain`` ties the two
    gradients), per scan-stack member; 0 for the other leaves."""
    parent, leaf = path.rsplit("/", 1)
    if leaf != "gain":
        return 0.0
    node_p, node_g = params, grads
    for k in parent.strip("/").split("/"):
        node_p, node_g = node_p[k], node_g[k]
    if "w_scale" not in node_p:
        return 0.0
    ws, gws = np.asarray(node_p["w_scale"]), np.asarray(node_g["w_scale"])
    gain = np.abs(np.asarray(node_p["gain"]))
    terms = np.abs(ws * gws).reshape(gain.shape + (-1,)).sum(axis=-1)
    return float((terms / gain).max())


def check_step(name, mode, act_calib="dynamic", grad_rel=GRAD_REL,
               ties=False):
    """One train step of SMOKE config ``name`` in the port against the
    reference's (``value_and_grad`` of its compiled ``lm_loss``, then its
    ``adamw_update``), from the same parameters and batch: the loss,
    every gradient leaf, the global norm and the parameters after
    AdamW.  ``ties``: the step flips a dynamic 5-bit code at an ulp tie
    (TIE_LOSS_REL, TIE_GRAD_REL; the parameters within ``2 lr``)."""
    jcfg, cfg = jconfigs.get_smoke(name), configs.get_smoke(name)
    jrun, run = _runs(mode, act_calib)
    p_np = _params_np(name)
    jb, tb = _batch(cfg)
    opt_cfg = JTS.make_opt_config(jrun)

    def loss_fn(params):
        model = japi.compile(JT.lm_module_spec(jcfg, params), params, jrun)
        return JT.lm_loss(model.lower(), jb, jcfg, jrun)

    @jax.jit
    def jstep(params, opt):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        new_p, new_opt, metrics = JO.adamw_update(params, grads, opt,
                                                  opt_cfg)
        return loss, grads, new_p, new_opt, metrics

    jparams = jax.tree.map(jnp.asarray, p_np)
    jopt = JO.adamw_init(jparams, opt_cfg)
    jl, jg, jnew_p, jnew_opt, jm = jax.tree.map(
        np.asarray, jstep(jparams, jopt))

    st = state_from_numpy({"params": p_np, "opt": jax.tree.map(
        np.asarray, jopt)}, "cpu")
    loss, _, grads = TS.loss_and_grads(st["params"], tb, cfg=cfg, run=run)
    np.testing.assert_allclose(float(loss), float(jl),
                               rtol=TIE_LOSS_REL if ties else 1e-6)
    if ties:
        grad_rel = TIE_GRAD_REL
    for path, want, got in _pairs(jg, grads):
        lim = grad_rel * max(float(np.abs(want).max()), 1e-30)
        if path.rsplit("/", 1)[1] in LAYER_SUMS:
            lim = max(lim, LAYER_SUM_TOL * max(
                float(np.abs(want).max()), _sum_scale(path, p_np, jg)))
        err = float(np.abs(_np(got) - want).max())
        assert err <= lim, f"{name} {mode} grad {path}: {err} > {lim}"
    opt_cfg_t = TS.make_opt_config(run)
    metrics = TS.apply_update(st, grads, opt_cfg=opt_cfg_t)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jm["grad_norm"]),
                               rtol=TIE_GRAD_REL if ties else 1e-5)
    clip = min(1.0, run.grad_clip / (float(jm["grad_norm"]) + 1e-9))
    for path, want, got in _pairs(jnew_p, st["params"]):
        g = _leaf(jg, path)
        well = (np.abs(g) * clip >= 1e-4) & (not ties)
        np.testing.assert_allclose(_np(got)[well], want[well], err_msg=path,
                                   **STATE_TOL)
        assert np.all(np.abs(_np(got) - want)
                      <= 2 * run.learning_rate + 1e-6), path
    return float(loss)


def _leaf(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return np.asarray(tree)


MOE_FAMILIES = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")


@pytest.mark.parametrize("mode", ["digital", "analog_faithful"])
@pytest.mark.parametrize("name", MOE_FAMILIES)
def test_train_step_matches_the_reference(name, mode):
    """The MoE families' step: the router's gradient through the softmax
    and the renormalized top-k, the capacity buffer, the combine, the
    aux loss, and the expert stacks' HIL backward."""
    check_step(name, mode)


def test_every_registry_config_builds_a_train_step():
    """``make_train_step`` accepts every config of the registry (nothing
    is refused: the reference trains them all)."""
    run = _runs("analog_faithful")[1]
    for name in configs.ARCH_NAMES:
        for cfg in (configs.get_smoke(name), configs.get_arch(name)):
            assert callable(TS.make_train_step(cfg, run))


def test_moe_routes_replay_under_autograd():
    """``Routes`` replayed into a train step: the loss and every gradient
    equal the recording run's (the router's gradient taken at the
    replayed experts), and remat's recompute replays its group's own
    routes."""
    name = "qwen3-moe-30b-a3b"
    cfg = configs.get_smoke(name)
    _, run = _runs("analog_faithful")
    _, tb = _batch(cfg)
    params = params_from_numpy(_params_np(name), "cpu")
    rec = M.Routes()
    l0, _, g0 = TS.loss_and_grads(params, tb, cfg=cfg, run=run, routes=rec)
    assert len(rec.taken) == T.n_groups(cfg)
    rep = M.Routes(replay=rec.taken)
    l1, _, g1 = TS.loss_and_grads(params, tb, cfg=cfg, run=run, routes=rep)
    assert float(l0) == float(l1)
    for path, a, b in _pairs(g0, g1):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)
    off = dataclasses.replace(cfg, remat=False)
    l2, _, g2 = TS.loss_and_grads(params, tb, cfg=off, run=run)
    assert float(l0) == float(l2)
    for path, a, b in _pairs(g0, g2):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)
