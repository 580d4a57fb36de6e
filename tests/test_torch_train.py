"""The port's hardware-in-the-loop training path (repro_torch) against the
JAX package's, on the CPU: the straight-through quantizers, the noisy
analog VMM, the HIL autograd around the kernel wrappers, one ECG train
step, AdamW, the digital stack and the accuracy loop.

The same numpy inputs and parameters go through both packages; the
readout noise is drawn by ``jax.random`` and injected into the port
(torch cannot reproduce ``jax.random``).  The JAX side runs as its own
tests run it: ``use_pallas=False``, or Pallas in interpret mode for the
kernel-forward wrappers.  Tolerances:

- quantizer gradients at ties (clip bounds, the floor's steps, max and
  ReLU at 0, tied class copies): equal to JAX's, exactly.
- integer effective weights (dyadic gain and offsets): forward bit-exact;
  gradients ``atol = rtol = 1e-5`` (the reference's own two HIL routes
  differ by 2.2e-6, fp32 summation order).
- the full fixed-pattern gain map: ADC readouts within 1 LSB on at most
  1 % of the readouts; loss within 1e-5 relative; each leaf's gradient
  within 1e-3 of that leaf's max |grad|.
- parameters after an AdamW update: ``rtol = 1e-6``, ``atol = 1e-7``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from benchmarks.ecg_accuracy import _clip_masters as j_clip_masters  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.core import analog as janalog  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.noise import NoiseConfig as JNoiseConfig  # noqa: E402
from repro.core.noise import readout_noise as j_readout_noise  # noqa: E402
from repro.data.ecg_synth import ECGDatasetConfig, make_dataset  # noqa: E402
from repro.data.preprocess import preprocess_batch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.ecg import ECGConfig as JECGConfig  # noqa: E402
from repro.models.ecg import _pool_class_copies as j_pool  # noqa: E402
from repro.models.ecg import ecg_init as jecg_init  # noqa: E402
from repro.models.ecg import ecg_loss as jecg_loss  # noqa: E402
from repro.models.ecg import ecg_module_spec as jecg_spec  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import analog as tanalog  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.noise import NoiseConfig  # noqa: E402
from repro_torch.exec import run as trun  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.ecg import ECGConfig, _pool_class_copies  # noqa: E402
from repro_torch.models.ecg import ecg_module_spec  # noqa: E402
from repro_torch.train import ecg_accuracy as tacc  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402

INT_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=1e-7, rtol=1e-6)
FULL_MAP_GRAD = 1e-3
TIE_SHARE = 0.01
NOISY = JNoiseConfig(mode="full")            # readout_std 0.7 LSB


def _t(a, grad=False):
    t = torch.tensor(np.asarray(a), dtype=torch.float32)
    return t.requires_grad_(True) if grad else t


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _grad_check(name, want, got, full_map):
    want, got = np.asarray(want), got.detach().numpy()
    assert want.shape == got.shape, name
    if full_map:
        lim = FULL_MAP_GRAD * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(want - got).max()) <= lim, name
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **INT_TOL)


# ------------------------------------------------------------------ (a)
TIE_POINTS = np.array([-70.0, -64.0, -63.0, -62.5, -1.0, -0.3, 0.0, 0.4,
                       0.5, 1.5, 2.0, 30.5, 31.0, 31.4, 32.0, 62.6, 63.0,
                       63.4, 64.0, 126.6, 127.0, 127.2, 128.0, -127.6,
                       -128.0, -128.6, -200.0], np.float32)


def _grad_pair(jfn, tfn, x, *extra):
    """Gradients of sum(fn(x) * r) in both packages, wrt x and extras."""
    args = (x,) + extra
    shape = np.shape(jfn(*map(jnp.asarray, args)))
    r = np.linspace(0.5, 1.5, int(np.prod(shape)),
                    dtype=np.float32).reshape(shape)
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * r),
                  argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    tt = [_t(a, grad=True) for a in args]
    (tfn(*tt) * _t(r)).sum().backward()
    return [np.asarray(g) for g in jg], [t.grad.numpy() for t in tt]


class TestQuantizerTies:
    @pytest.mark.parametrize("name", [
        "quantize_act", "quantize_weight", "adc_readout", "requantize_5bit",
        "maximum0", "relu", "clip"])
    def test_gradients_equal_jax_exactly(self, name):
        x = TIE_POINTS
        if name == "quantize_act":
            pairs = _grad_pair(jq.quantize_act, tq.quantize_act, x,
                               np.float32(1.0))
            pairs2 = _grad_pair(jq.quantize_act, tq.quantize_act, x * 0.25,
                                np.float32(0.25))
            for w, g in zip(*pairs2):
                np.testing.assert_array_equal(g, w)
        elif name == "quantize_weight":
            scale = np.full((1, x.size), 1.0, np.float32)
            scale[0, ::3] = 0.5
            pairs = _grad_pair(jq.quantize_weight, tq.quantize_weight,
                               x[None, :] * scale, scale)
        elif name == "adc_readout":
            pairs = _grad_pair(jq.adc_readout, tq.adc_readout, x)
        elif name == "requantize_5bit":
            steps = np.arange(-8.0, 140.0, 1.0, dtype=np.float32)
            pairs = _grad_pair(lambda v: jq.requantize_5bit(v, 2),
                               lambda v: tq.requantize_5bit(v, 2), steps)
        elif name == "maximum0":
            pairs = _grad_pair(lambda v: jnp.maximum(v, 0.0), tq._maximum0, x)
        elif name == "relu":
            pairs = _grad_pair(jax.nn.relu, torch.relu, x)
        else:
            jfn = lambda v: jnp.clip(v, -63.0, 31.0)  # noqa: E731
            jtf = lambda v: tq._clip_ste(v, -63.0, 31.0)  # noqa: E731
            pairs = _grad_pair(jfn, jtf, x)
        for w, g in zip(*pairs):
            np.testing.assert_array_equal(g, w)

    def test_ties_land_on_the_half_rule(self):
        """The tie rule itself, beside the parity: 0.5 at a clip bound and
        at max(x, 0) == 0, 0 for relu at 0, 1 inside, 0 outside."""
        x = _t([0.0, 31.0, 15.0, 40.0, -3.0], grad=True)
        tq._clip_ste(x, 0.0, 31.0).sum().backward()
        assert x.grad.tolist() == [0.5, 0.5, 1.0, 0.0, 0.0]
        y = _t([0.0, 2.0, -1.0], grad=True)
        tq._maximum0(y).sum().backward()
        assert y.grad.tolist() == [0.5, 1.0, 0.0]

    def test_forward_values_unchanged_without_grad(self):
        rng = np.random.default_rng(0)
        v = (rng.standard_normal(4096) * 300).astype(np.float32)
        v[::7] = np.round(v[::7]) + 0.5          # exact rounding ties
        t = _t(v)
        tg = _t(v, grad=True)
        for fn in (tq.adc_readout, lambda u: tq.quantize_act(u, 0.25),
                   lambda u: tq.quantize_weight(u, 3.0),
                   lambda u: tq.requantize_5bit(u, 3), tq._maximum0):
            np.testing.assert_array_equal(fn(tg).detach().numpy(),
                                          fn(t).numpy())
        np.testing.assert_array_equal(tq.adc_readout(t).numpy(),
                                      np.asarray(jq.adc_readout(v)))

    def test_class_copy_max_splits_ties_like_jax(self):
        out = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                        [0.0] * 10], np.float32)
        pairs = _grad_pair(lambda o: j_pool(o, JECGConfig(), True),
                           lambda o: _pool_class_copies(o, ECGConfig(), True),
                           out)
        np.testing.assert_array_equal(pairs[1][0], pairs[0][0])


# ------------------------------------------------------------------ (b)
def _vmm_inputs(k, n, full_map, batch=(3, 5), seed=0):
    rng = np.random.default_rng(seed + k + n)
    a = rng.integers(0, 32, batch + (k,)).astype(np.float32)
    a[..., : k // 4] = 0.0                    # many exact-0 codes
    w = rng.integers(-63, 64, (k, n)).astype(np.float32)
    if full_map:
        w = (w * (1 + 0.02 * rng.standard_normal((k, n)))).astype(np.float32)
    gain = (2.0 ** -rng.integers(5, 8, (n,))).astype(np.float32)
    c = -(-k // 128)
    off = (rng.integers(-8, 9, (c, n)) / 4.0).astype(np.float32)
    r = rng.standard_normal(batch + (n,)).astype(np.float32)
    return a, w, gain, off, r


def _mm_both(mode, a, w, gain, off, r, *, rn=None, key=None,
             use_pallas=False, use_kernels=True, deterministic=False):
    jcfg = JAnalogConfig(mode=mode, deterministic=deterministic,
                         use_pallas=use_pallas, noise=NOISY)
    tcfg = AnalogConfig(mode=mode, deterministic=deterministic,
                        use_kernels=use_kernels, noise=NoiseConfig(
                            mode="full"))

    def jf(a_, w_, g_, o_):
        return janalog.analog_matmul(a_, w_, g_, o_, key, jcfg)

    jy, jvjp = jax.vjp(jf, *map(jnp.asarray, (a, w, gain, off)))
    jg = jvjp(jnp.asarray(r))
    tt = [_t(x, grad=True) for x in (a, w, gain, off)]
    ty = tanalog.analog_matmul(*tt, tcfg, noise=rn)
    (ty * _t(r)).sum().backward()
    return np.asarray(jy), [np.asarray(g) for g in jg], ty, [
        t.grad if t.grad is not None else torch.zeros_like(t) for t in tt]


class TestNoisyMatmul:
    @pytest.mark.parametrize("mode", ["analog_faithful", "analog_fast"])
    @pytest.mark.parametrize("k", [256, 200])
    def test_injected_noise_matches_jax(self, mode, k):
        n, batch = 24, (3, 5)
        a, w, gain, off, r = _vmm_inputs(k, n, False, batch)
        c = -(-k // 128)
        key = jax.random.PRNGKey(k)
        shape = batch + ((c, n) if mode == "analog_faithful" else (n,))
        rn = _t(j_readout_noise(key, shape, NOISY))
        jy, jg, ty, tg = _mm_both(mode, a, w, gain, off, r, rn=rn, key=key)
        np.testing.assert_array_equal(ty.detach().numpy(), jy)
        for name, want, got in zip(("a", "w_eff", "gain", "offset"), jg, tg):
            _grad_check(name, want, got, False)
        # the gradient reached every operand (the noisy readout carries
        # the linearization, not the frozen-calibration rule)
        assert float(tg[2].abs().max()) > 0

    def test_full_map_readouts_within_contract(self):
        a, w, gain, off, r = _vmm_inputs(256, 123, True, (16,))
        key = jax.random.PRNGKey(5)
        rn = _t(j_readout_noise(key, (16, 2, 123), NOISY))
        jy, jg, ty, tg = _mm_both("analog_faithful", a, w, gain, off, r,
                                  rn=rn, key=key)
        d = np.abs(ty.detach().numpy() - jy)
        assert d.max() <= 2 and (d > 0).mean() <= TIE_SHARE
        for name, want, got in zip(("a", "w_eff", "gain", "offset"), jg, tg):
            _grad_check(name, want, got, True)

    def test_generator_draws_and_noiseless_configs(self):
        cfg = NoiseConfig(mode="full")
        dev = torch.device("cpu")
        g1 = torch.Generator().manual_seed(3)
        g2 = torch.Generator().manual_seed(3)
        d1 = tnoise.readout_noise(g1, (4, 2, 5), cfg, device=dev)
        d2 = tnoise.readout_noise(g2, (4, 2, 5), cfg, device=dev)
        assert tuple(d1.shape) == (4, 2, 5) and torch.equal(d1, d2)
        assert abs(float(d1.std()) - 0.7) < 0.4
        for c in (cfg.with_mode("none"),
                  NoiseConfig(mode="full", readout_std=0.0)):
            assert tnoise.readout_noise(g1, (4,), c, device=dev) is None
        assert tnoise.readout_noise(None, (4,), cfg, device=dev) is None
        with pytest.raises(ValueError, match="shape"):
            tnoise.readout_noise(torch.zeros(3), (4,), cfg, device=dev)
        # a generator drives the noisy branch: two draws differ
        a, w, gain, off, _ = _vmm_inputs(256, 8, False, (6,))
        tcfg = AnalogConfig(deterministic=False, noise=cfg)
        ys = [tanalog.analog_matmul(_t(a), _t(w), _t(gain), _t(off), tcfg,
                                    noise=g1) for _ in range(2)]
        assert not torch.equal(ys[0], ys[1])


# ------------------------------------------------------------------ (c)
class TestHILFunctions:
    @pytest.mark.parametrize("full_map", [False, True])
    @pytest.mark.parametrize("mode", ["analog_faithful", "analog_fast"])
    def test_deterministic_matmul_matches_jax(self, mode, full_map):
        """No kernels: faithful mode's ``_FaithfulMM`` against
        ``_faithful_mm``, fast mode's STE matmul against the reference's."""
        a, w, gain, off, r = _vmm_inputs(384, 40, full_map, (7,))
        jy, jg, ty, tg = _mm_both(mode, a, w, gain, off, r,
                                  use_kernels=False, deterministic=True)
        if full_map:
            d = np.abs(ty.detach().numpy() - jy)
            assert d.max() <= 3 and (d > 0).mean() <= TIE_SHARE
        else:
            np.testing.assert_array_equal(ty.detach().numpy(), jy)
        for name, want, got in zip(("a", "w_eff", "gain", "offset"), jg, tg):
            _grad_check(name, want, got, full_map)
        if mode == "analog_faithful":
            # frozen calibration state
            assert not tg[2].any() and not tg[3].any()

    @pytest.mark.parametrize("faithful", [True, False])
    def test_ops_analog_mvm_matches_jax(self, faithful):
        a, w, gain, off, _ = _vmm_inputs(256, 20, False, (9,))
        r = np.random.default_rng(1).standard_normal((9, 20)).astype(
            np.float32)

        def jf(a_, w_, g_, o_):
            return jops.analog_mvm(a_, w_, g_, o_, 128, faithful, True)

        jy, jvjp = jax.vjp(jf, *map(jnp.asarray, (a, w, gain, off)))
        jg = jvjp(jnp.asarray(r))
        tt = [_t(x, grad=True) for x in (a, w, gain, off)]
        ty = ops.analog_mvm(*tt, chunk_rows=128, faithful=faithful)
        (ty * _t(r)).sum().backward()
        np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
        for name, want, t in zip(("a", "w", "gain"), jg, tt):
            _grad_check(name, want, t.grad, False)
        assert tt[3].grad is None or not tt[3].grad.any()
        with pytest.raises(ValueError, match="inference-only"):
            ops.analog_mvm(*tt, chunk_rows=128, epilogue=("relu_shift", 3))


# ------------------------------------------------------------------ (d)
_JP = {}


def _ecg_params(kind):
    """JAX ECG params: "int" (integer effective weights, offsets kept) or
    "full" (the full fixed-pattern gain map)."""
    if kind not in _JP:
        cfg = (JECGConfig(noise=JNoiseConfig(gain_std=0.0, mode="full"))
               if kind == "int" else JECGConfig())
        _JP[kind] = jax.jit(jecg_init, static_argnums=1)(
            jax.random.PRNGKey(21), cfg)
    return _JP[kind]


def _chain_setup(epilogue, kind):
    static = epilogue == "none"
    jcfg = JAnalogConfig(act_calib="static" if static else "dynamic")
    tcfg = AnalogConfig(act_calib="static" if static else "dynamic",
                        fused_epilogue=True)
    jp = _ecg_params(kind)
    jplan = jax.jit(lambda p: japi.compile(
        jecg_spec(JECGConfig(), epilogue=epilogue), p, jcfg).lower())(jp)
    tparams = params_from_numpy(_tree_np(jp), "cpu")
    rng = np.random.default_rng(4)
    rows = 2 * jplan.mega.schedule[0].m_mult
    if static:
        x = rng.uniform(0.0, 1.2, (rows, 128)).astype(np.float32)
    else:
        x = rng.integers(0, 32, (rows, 128)).astype(np.float32)
    return jplan, tparams, tcfg, x


class TestChainHIL:
    @pytest.mark.parametrize("route", ["ops", "ref"])
    @pytest.mark.parametrize("epilogue", ["relu_shift", "none"])
    def test_chain_function_matches_plan_codes(self, epilogue, route):
        """``ops.analog_plan_codes`` (the chain's HIL function) and the
        plain ``analog_plan_ref`` differentiated with its own STE chunk
        scan, against the VJP of the reference's ``_plan_codes``."""
        jplan, tparams, tcfg, x = _chain_setup(epilogue, "int")
        jm = jplan.mega
        r = np.random.default_rng(2).standard_normal(
            (2, jm.schedule[-1].n)).astype(np.float32)
        args = [jnp.asarray(x), jm.w_cat, jm.gain, jm.off, jm.extras]

        @jax.jit
        def value_and_vjp(args, r):
            y, vjp = jax.vjp(
                lambda *a: jops._plan_codes(*a, jm.schedule, 128, True,
                                            False, None, None), *args)
            return y, vjp(r)

        jy, jg = value_and_vjp(args, jnp.asarray(r))
        tm = api.compile(ecg_module_spec(ECGConfig(), epilogue=epilogue),
                         tparams, tcfg, device="cpu").lower().mega
        tx = _t(x, grad=True)
        tw = tm.w_cat.clone().requires_grad_(True)
        tex = None
        if tm.extras is not None:
            tex = tuple(None if e is None else e.clone().requires_grad_(True)
                        for e in tm.extras)
        if route == "ops":
            ty = ops.analog_plan_codes(tx, tw, tm.gain, tm.off,
                                       schedule=tm.schedule, extras=tex)
        else:
            ty = tref.analog_plan_ref(tx, tw, tm.gain, tm.off, tm.schedule,
                                      extras=tex)
        (ty * _t(r)).sum().backward()
        np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
        _grad_check("x_in", jg[0], tx.grad, False)
        _grad_check("w_cat", jg[1], tw.grad, False)
        assert not np.asarray(jg[2]).any() and not np.asarray(jg[3]).any()
        if tex is not None:
            for name, want, e in zip(("deq", "bias", "enc"), jg[4], tex):
                _grad_check(name, want, e.grad, False)

    @pytest.mark.parametrize("kind", ["int", "full"])
    @pytest.mark.parametrize("epilogue", ["relu_shift", "none"])
    def test_megakernel_grads_equal_per_layer_route(self, epilogue, kind):
        """The chain function's gradients to every parameter against the
        port's own per-layer route (``analog_mvm`` HIL function and the
        elementwise STE hand-offs), through the lowering."""
        jplan, tparams, tcfg, x = _chain_setup(epilogue, kind)
        spec = ecg_module_spec(ECGConfig(), epilogue=epilogue)
        x3 = x.reshape(2, jplan.mega.schedule[0].m_mult, 128)
        r = _t(np.random.default_rng(6).standard_normal((2, 10)))
        grads = {}
        for mk in (True, False):
            leaves = O.tree_map(lambda p: p.clone().requires_grad_(True),
                                tparams)
            model = api.compile(spec, leaves, tcfg, device="cpu")
            trun.reset_dispatch_count()
            y = model.run_stack(_t(x3), megakernel=mk)
            assert trun.dispatch_count() == (1 if mk else 3)
            (y * r).sum().backward()
            grads[mk] = O.tree_map(
                lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
                leaves)
        g_pl = _named(grads[False])
        for path, g_mk in _named(grads[True]).items():
            _grad_check(path, g_pl[path].numpy(), g_mk, kind == "full")

    def test_block_plans_and_split_raise_under_autograd(self):
        # neither raises any more: the split pair has its HIL backward
        # (the LM training path, tests/test_torch_lm_train.py), and so
        # has a block plan's one launch (held against the reference in
        # tests/test_torch_block.py::TestBlockHILGradients)
        x = torch.ones((2, 256), requires_grad=True)
        w = torch.ones((256, 4))
        g = torch.ones(4)
        ops.analog_mvm_split(x, x, w, g, None).sum().backward()
        assert torch.equal(x.grad, torch.zeros_like(x))   # da_pos - da_neg
        from repro_torch.configs.base import ArchConfig
        from repro_torch.exec.lower import lower_block
        from repro_torch.models import transformer as T

        arch = ArchConfig(name="t", family="dense", n_layers=1, d_model=64,
                          n_heads=2, n_kv_heads=2, d_ff=96, vocab_size=64)
        plan = lower_block(
            T._layer_init(torch.Generator().manual_seed(0), "attn_mlp", arch,
                          "cpu"), AnalogConfig(act_calib="static"),
            n_heads=2, n_kv_heads=2, head_dim=32, seq=4, rope_theta=1e4)
        xb = torch.randn((2, 4, 64), generator=torch.Generator()
                         .manual_seed(1)).requires_grad_(True)
        m = plan.mega
        y = ops.analog_plan_codes(
            xb.reshape(8, 64), m.stores, m.gain, m.off,
            schedule=m.schedule, extras=m.extras, block=m.block)
        (gx,) = torch.autograd.grad((y ** 2).sum(), xb)
        xf = xb.detach().requires_grad_(True)
        (gf,) = torch.autograd.grad(
            (trun.run(plan, xf, megakernel=False) ** 2).sum(), xf)
        assert float(gx.abs().max()) > 0
        assert torch.equal(gx, gf)


def _named(tree, prefix=""):
    """{dotted path: leaf} of nested dicts."""
    if isinstance(tree, dict):
        return {p: leaf for k, v in tree.items()
                for p, leaf in _named(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


def _pairs(got, want):
    """(path, port leaf, JAX leaf as numpy) for every leaf of two trees
    with the same paths."""
    got, want = _named(got), _named(_tree_np(want))
    assert set(got) == set(want)
    return [(p, got[p], want[p]) for p in sorted(got)]


# ------------------------------------------------------------------ (e)
B_STEP = 6


def _step_data():
    raw, y = make_dataset(ECGDatasetConfig(n_train=B_STEP), "train")
    return np.asarray(preprocess_batch(raw)), np.asarray(y)


def _layer_draws(key, b):
    """The reference's per-layer readout noise: run() splits the step key
    into one key per layer (conv [B,32] rows x 1 chunk x 8, fc1 2 chunks x
    123, fc2 1 chunk x 10)."""
    shapes = [(b, 32, 1, 8), (b, 2, 123), (b, 1, 10)]
    return [_t(j_readout_noise(k, s, NOISY))
            for k, s in zip(jax.random.split(key, 3), shapes)]


class TestTrainStep:
    @pytest.mark.parametrize("epilogue", ["none", "relu_shift"])
    def test_one_step_matches_jax(self, epilogue):
        x, y = _step_data()
        jp = _ecg_params("full")
        jacfg = JAnalogConfig(mode="analog_faithful", deterministic=False)
        key = jax.random.PRNGKey(17)
        step = jax.jit(jax.value_and_grad(jecg_loss, has_aux=True),
                       static_argnums=(3, 4), static_argnames="epilogue")
        (jl, jaux), jg = step(jp, jnp.asarray(x), jnp.asarray(y), jacfg,
                              JECGConfig(), key, epilogue=epilogue)
        ocfg = dict(lr=3e-3, warmup_steps=20, weight_decay=0.01,
                    total_steps=260)
        jocfg = JO.AdamWConfig(**ocfg)
        jnew, _, jom = jax.jit(
            lambda p, g: JO.adamw_update(p, g, JO.adamw_init(p, jocfg),
                                         jocfg))(jp, jg)
        jnew = _tree_np(jax.jit(j_clip_masters)(jnew))

        tp = params_from_numpy(_tree_np(jp), "cpu")
        acfg = AnalogConfig(mode="analog_faithful", deterministic=False)
        loss, aux, grads = tacc.loss_and_grads(
            tp, _t(x), torch.tensor(y, dtype=torch.int64), acfg,
            ECGConfig(), noise=_layer_draws(key, B_STEP), epilogue=epilogue)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        assert float(aux["acc"]) == float(jaux["acc"])
        for path, got, want in _pairs(grads, jg):
            _grad_check(path, want, got, True)
        np.testing.assert_allclose(float(O.global_norm(grads)),
                                   float(JO.global_norm(jg)), rtol=1e-5)
        tocfg = O.AdamWConfig(**ocfg)
        with torch.no_grad():
            new, _, om = O.adamw_update(tp, grads, O.adamw_init(tp, tocfg),
                                        tocfg)
            new = tacc._clip_masters(new)
        np.testing.assert_allclose(float(om["lr"]), float(jom["lr"]),
                                   rtol=1e-6)
        for path, got, want in _pairs(new, jnew):
            np.testing.assert_allclose(got.numpy(), want, err_msg=path,
                                       **PARAM_TOL)

    def test_noisy_call_stays_layer_by_layer(self):
        jplan, tparams, _, x = _chain_setup("relu_shift", "int")
        model = api.compile(ecg_module_spec(ECGConfig(), epilogue="relu_shift"),
                            tparams, AnalogConfig(deterministic=False),
                            device="cpu")
        cols = _t(x.reshape(2, 32, 128))
        g = torch.Generator().manual_seed(0)
        with pytest.raises(ValueError, match="noisy"):
            model.run_stack(cols, noise=g, megakernel=True)
        trun.reset_dispatch_count()
        model.run_stack(cols, noise=g)
        assert trun.dispatch_count() == 3
        with pytest.raises(ValueError, match="readout-noise draws"):
            model.run_stack(cols, noise=[None])


# ------------------------------------------------------------------ (f)
class TestAdamW:
    def test_three_steps_match_jax(self):
        rng = np.random.default_rng(8)
        jp = {"l": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                    "b": rng.standard_normal((3,)).astype(np.float32),
                    "w_scale": np.full((1, 3), 0.05, np.float32),
                    "gain": np.float32(0.3),
                    "fpn": {"gain": rng.standard_normal((4, 3)).astype(
                        np.float32)}}}
        kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.1)
        jcfg, tcfg = JO.AdamWConfig(**kw), O.AdamWConfig(**kw)
        jst = JO.adamw_init(jax.tree.map(jnp.asarray, jp), jcfg)
        tpar = params_from_numpy(jp, "cpu")
        tst = O.adamw_init(tpar, tcfg)
        jpar = jax.tree.map(jnp.asarray, jp)
        assert tuple(tst["m"]["l"]["w_scale"].shape) == ()   # frozen slot
        for step in range(3):
            g = jax.tree.map(lambda a: (rng.standard_normal(np.shape(a))
                                        * 10).astype(np.float32), jp)
            jpar, jst, jom = JO.adamw_update(jpar, jax.tree.map(
                jnp.asarray, g), jst, jcfg)
            tpar, tst, tom = O.adamw_update(
                tpar, params_from_numpy(g, "cpu"), tst, tcfg)
            assert float(tom["grad_norm"]) > tcfg.grad_clip   # clipping on
            for name in ("grad_norm", "lr"):
                np.testing.assert_allclose(float(tom[name]),
                                           float(jom[name]), rtol=1e-6)
            for tree_t, tree_j in ((tpar, jpar), (tst["m"], jst["m"]),
                                   (tst["v"], jst["v"])):
                for path, got, want in _pairs(tree_t, tree_j):
                    np.testing.assert_allclose(got.numpy(), want,
                                               err_msg=f"{step} {path}",
                                               **PARAM_TOL)
            assert int(tst["step"]) == int(jst["step"]) == step + 1
        # frozen leaves did not move
        assert float(tpar["l"]["gain"]) == float(jp["l"]["gain"])
        np.testing.assert_array_equal(tpar["l"]["fpn"]["gain"].numpy(),
                                      jp["l"]["fpn"]["gain"])


# ------------------------------------------------------------------ (g)
class TestDigitalStack:
    def test_digital_stack_matches_jax(self):
        x, y = _step_data()
        jp = _ecg_params("full")
        jcfg = JAnalogConfig(mode="digital")
        want = japi.compile(jecg_spec(JECGConfig()), jp, jcfg).apply(
            jnp.asarray(x))
        (jl, _), jg = jax.jit(
            jax.value_and_grad(jecg_loss, has_aux=True),
            static_argnums=(3, 4))(jp, jnp.asarray(x), jnp.asarray(y), jcfg,
                                   JECGConfig())
        tp = params_from_numpy(_tree_np(jp), "cpu")
        model = api.compile(ecg_module_spec(ECGConfig()), tp,
                            AnalogConfig(mode="digital"), device="cpu")
        assert model.lower() is None
        got = model.apply(_t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        with pytest.raises(ValueError, match="digital"):
            model.apply(_t(x), megakernel=True)
        loss, _, grads = tacc.loss_and_grads(
            tp, _t(x), torch.tensor(y, dtype=torch.int64),
            AnalogConfig(mode="digital"), ECGConfig())
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        for path, got_g, want_g in _pairs(grads, jg):
            _grad_check(path, want_g, got_g, True)


# ------------------------------------------------------------------ (h)
REFERENCE_KEYS = {"mode", "epilogue", "detection_rate",
                  "false_positive_rate", "accuracy", "train_s", "history",
                  "params"}


class TestAccuracyLoop:
    @pytest.mark.parametrize("mode,epilogue", [
        ("analog_faithful", "relu_shift"), ("digital", "none")])
    def test_one_epoch_returns_reference_keys(self, mode, epilogue):
        r = tacc.run(n_train=128, n_test=48, epochs=1, mode=mode,
                     epilogue=epilogue, verbose=False, device="cpu")
        assert REFERENCE_KEYS <= set(r)
        assert (r["mode"], r["epilogue"]) == (mode, epilogue)
        assert len(r["history"]) == r["epochs_run"] == 1
        assert r["steps"] == (128 - 32) // 64
        for k in ("detection_rate", "false_positive_rate", "accuracy"):
            assert 0.0 <= r[k] <= 1.0
        assert set(r["params"]) == {"conv", "fc1", "fc2"}
        assert all(not t.requires_grad
                   for t in O.tree_leaves(r["params"]))

    def test_entry_point_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="cuda"):
            tacc.run(n_train=128, n_test=48, epochs=1, verbose=False)


class TestScalesOnTheCard:
    def test_scales_from_max_divide_exactly(self):
        """The dynamic activation scale and the weight scale on the card
        equal the CPU's bit for bit (PyTorch's CUDA division by a Python
        number multiplies by its rounded reciprocal instead)."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        x = torch.from_numpy(np.random.default_rng(5).uniform(
            0.0, 40.0, (4096,)).astype(np.float32))
        for fn in (tq.act_scale_from_max, tq.weight_scale_from_max):
            assert torch.equal(fn(x.to("cuda")).cpu(), fn(x))
