"""The port's LM training path (repro_torch) against the JAX package's, on
the CPU: the synthetic token pipeline, ``lm_loss``, the split pair's
hardware-in-the-loop gradients, one train step per mode on
``phi4-mini-3.8b-smoke``, int8 gradient compression, the fault-tolerance
helpers, the training loop's resume and checkpoints across packages.

Both packages start from the reference's ``init_state`` draw (carried
across by ``convert.state_from_numpy``) with the fixed pattern swapped
for ``NOISELESS``, so every effective weight is an integer and the
forward is exact in fp32; activations are fp32 (``activation_dtype=
"float32"``).  The readout noise of the noisy step is the reference's
own: its key tree is walked here and each pass's ``jax.random`` draw is
injected through a ``NoiseFeed``.  The JAX side is jitted, as its own
tests run it.  Tolerances:

- tokens, compression codes and scales, checkpoint leaves: equal.
- losses and metrics: within 1e-6 relative (measured: equal).
- gradients: ``atol = rtol = 1e-5`` per element (the HIL products sum in
  another order; measured: below 2e-7 on the weights), but a layer's
  ``w_scale``, ``gain`` and ``a_scale``, whose gradients sum a whole
  column or layer of terms that cancel, within 2e-4 of their leaf's max
  |grad| (the card checks' ``LAYER_SUM_TOL``; measured: 2.5e-4 relative
  of one element, 5.7e-5 of the leaf's max, on the noisy step).
- the error feedback after the compressed step: within the gradient
  tolerance, or one int8 step of its leaf's scale where a rounding
  flipped.
- moments after AdamW: ``atol = 1e-6``, ``rtol = 1e-5``.  Parameters:
  the same where the clipped reference gradient is at least ``1e-4``;
  below it the first step's ``m / (sqrt(v) + eps)`` - ``g / (|g| +
  eps)`` - turns the gradients' 1e-5 differences into any value in
  ``[-1, 1]``, so there the parameters agree within ``2 * lr`` (measured:
  2 of 18432 elements of one leaf, 1.5e-5 apart at ``lr = 1e-3``).
"""
import dataclasses
import functools
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.noise import NOISELESS as JNOISELESS  # noqa: E402
from repro.core.noise import NoiseConfig as JNoiseConfig  # noqa: E402
from repro.core.noise import readout_noise as j_readout_noise  # noqa: E402
from repro.data import lm_data as jdata  # noqa: E402
from repro.distributed import fault as jfault  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import checkpoint as JCKPT  # noqa: E402
from repro.train import compression as JC  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.noise import NOISELESS, NoiseConfig, NoiseFeed  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.distributed import fault  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import checkpoint as CKPT  # noqa: E402
from repro_torch.train import compression as C  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

ARCH = "phi4-mini-3.8b"
CFG = configs.get_smoke(ARCH)
JCFG = jconfigs.get_smoke(ARCH)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
LAYER_SUMS = ("w_scale", "gain", "a_scale")
LAYER_SUM_TOL = 2e-4
STATE_TOL = dict(atol=1e-6, rtol=1e-5)
READOUT = 0.7                   # ADC LSB per analog pass, the default
SEQ, BATCH = 16, 2


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _pairs(a, b, path=""):
    """(path, a-leaf, b-leaf) over two nested dicts with the same keys."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def _runs(mode="split", noisy=False):
    """(reference RunConfig, port RunConfig): faithful analog, fp32
    activations, readout noise when ``noisy`` (two-pass split)."""
    jn = JNoiseConfig(gain_std=0.0, offset_std=0.0, readout_std=READOUT,
                      mode="rank1") if noisy else JNOISELESS
    tn = NoiseConfig(gain_std=0.0, offset_std=0.0, readout_std=READOUT,
                     mode="rank1") if noisy else NOISELESS
    kw = dict(mode="analog_faithful", signed_input=mode,
              deterministic=not noisy)
    common = dict(activation_dtype="float32", learning_rate=1e-3,
                  warmup_steps=1)
    return (JRunConfig(analog=JAnalogConfig(noise=jn, **kw), **common),
            RunConfig(analog=AnalogConfig(noise=tn, **kw), **common))


@functools.lru_cache(maxsize=None)
def _jstate_np(compression=False):
    """The reference's ``init_state`` (NOISELESS fixed pattern) as numpy."""
    jrun, _ = _runs()
    jrun = dataclasses.replace(jrun, grad_compression=compression)
    saved = JT.NOISE
    JT.NOISE = JNOISELESS
    try:
        st = JTS.init_state(jax.random.PRNGKey(0), JCFG, jrun)
    finally:
        JT.NOISE = saved
    return jax.tree.map(np.asarray, st)


def _batch(step=0, seq=SEQ):
    b = jdata.SyntheticLM(jdata.DataConfig(
        vocab_size=JCFG.vocab_size, seq_len=seq, global_batch=BATCH)
    ).batch(step)
    return b, {k: torch.as_tensor(v, dtype=torch.int64) for k, v in b.items()}


def _jloss_fn(jrun, batch, rng):
    def loss_fn(params):
        model = japi.compile(JT.lm_module_spec(JCFG, params), params, jrun)
        return JT.lm_loss(model.lower(), batch, JCFG, jrun, rng=rng)
    return loss_fn


def _ref_draws(rng, jrun, seq=SEQ):
    """The reference's readout-noise draws in the port's call order: per
    group (key ``split(rng, n_groups)[g]``, layer key ``fold_in(., 0)``)
    the fused QKV (``split(key, 4)[0]``), wo (``[3]``), then up, gate and
    down (``split(key, 3)``), then the lm_head (``rng``); each layer's
    key split once more into its positive and negative pass."""
    nq = JCFG.n_heads * JCFG.hd
    nkv = JCFG.n_kv_heads * JCFG.hd
    d, ff, cr = JCFG.d_model, JCFG.d_ff, jrun.analog.chunk_rows

    def layer(key, k, n):
        shape = (BATCH, seq, -(-k // cr), n)
        return [j_readout_noise(kk, shape, jrun.analog.noise)
                for kk in jax.random.split(key)]

    draws = []
    for gk in jax.random.split(rng, JT.n_groups(JCFG)):
        lk = jax.random.fold_in(gk, 0)
        ka, km = jax.random.split(lk, 4), jax.random.split(lk, 3)
        draws += layer(ka[0], d, nq + 2 * nkv) + layer(ka[3], nq, d)
        draws += layer(km[0], d, ff) + layer(km[1], d, ff)
        draws += layer(km[2], ff, d)
    draws += layer(rng, d, JCFG.vocab_size)
    return [torch.tensor(np.asarray(x)) for x in draws]


def _check_grads(jg, grads):
    for path, want, got in _pairs(jg, grads):
        want = np.asarray(want)
        if path.rsplit("/", 1)[1] in LAYER_SUMS:
            lim = LAYER_SUM_TOL * max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(_np(got) - want).max()) <= lim, path
        else:
            np.testing.assert_allclose(_np(got), want, err_msg=path,
                                       **GRAD_TOL)


# ------------------------------------------------------------------ data
class TestLMData:
    @pytest.mark.parametrize("vocab,seq,batch,seed", [
        (512, 64, 4, 0), (50304, 33, 2, 7), (3, 8, 3, 1)])
    def test_tokens_bit_identical(self, vocab, seq, batch, seed):
        kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch,
                  seed=seed)
        j = jdata.SyntheticLM(jdata.DataConfig(**kw))
        t = lm_data.SyntheticLM(lm_data.DataConfig(**kw))
        np.testing.assert_array_equal(t.motifs, j.motifs)
        for step in (0, 5):
            for shard, n in ((0, 1), (1, batch if batch > 1 else 1)):
                jb, tb = j.batch(step, shard, n), t.batch(step, shard, n)
                for k in ("tokens", "labels"):
                    assert tb[k].dtype == jb[k].dtype
                    np.testing.assert_array_equal(tb[k], jb[k])


# ------------------------------------------------------------------ loss
class TestLMLoss:
    @pytest.mark.parametrize("masked", [False, True])
    def test_loss_and_metrics_match(self, masked):
        jrun, run = _runs()
        st = _jstate_np()
        jb, tb = _batch()
        if masked:
            mask = (np.arange(SEQ)[None, :] % 3 != 0).astype(np.float32)
            mask = np.broadcast_to(mask, (BATCH, SEQ)).copy()
            jb = {**jb, "mask": mask}
            tb = {**tb, "mask": torch.tensor(mask)}
        jl, jm = jax.jit(_jloss_fn(jrun, jb, None))(
            jax.tree.map(jnp.asarray, st["params"]))
        params = state_from_numpy(st, "cpu")["params"]
        from repro_torch import api
        model = api.compile(T.lm_module_spec(CFG, params), params, run,
                            device="cpu")
        loss, metrics = T.lm_loss(model.lower(), tb, CFG, run)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
        assert set(metrics) == set(jm) == {"nll", "aux", "logit_z"}
        for k in jm:
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                       rtol=1e-6, err_msg=k)


# ----------------------------------------------------- split HIL backward
class TestSplitHIL:
    @pytest.mark.parametrize("faithful", [True, False])
    @pytest.mark.parametrize("integer", [True, False])
    def test_gradients_match_reference(self, faithful, integer):
        rng = np.random.default_rng(3)
        m, k, n = 6, 256, 40
        a_pos = rng.integers(0, 32, (m, k)).astype(np.float32)
        a_neg = rng.integers(0, 32, (m, k)).astype(np.float32)
        w = rng.integers(-63, 64, (k, n)).astype(np.float32)
        if not integer:
            w = w * (1 + 0.02 * rng.standard_normal((k, n))).astype(
                np.float32)
        gain = rng.uniform(0.02, 0.05, n).astype(np.float32)
        off = rng.normal(0, 1, (k // 128, n)).astype(np.float32)
        r = np.linspace(0.5, 1.5, m * n, dtype=np.float32).reshape(m, n)

        def jf(ap, an, w_, g_):
            return jnp.sum(jops.analog_mvm_split(
                ap, an, w_, g_, jnp.asarray(off), 128, faithful, False,
                True) * r)

        jy = jops.analog_mvm_split(*map(jnp.asarray, (a_pos, a_neg, w, gain,
                                                      off)), 128, faithful,
                                   False, True)
        jg = jax.grad(jf, argnums=(0, 1, 2, 3))(
            *map(jnp.asarray, (a_pos, a_neg, w, gain)))
        ts = [torch.tensor(x, requires_grad=True)
              for x in (a_pos, a_neg, w, gain)]
        y = ops.analog_mvm_split(*ts, torch.tensor(off), chunk_rows=128,
                                 faithful=faithful)
        np.testing.assert_array_equal(_np(y), np.asarray(jy))
        (y * torch.tensor(r)).sum().backward()
        for want, t in zip(jg, ts):
            np.testing.assert_allclose(_np(t.grad), np.asarray(want),
                                       **GRAD_TOL)
        assert not ts[3].grad.any()      # gain is frozen calibration state

    def test_epilogue_under_grad_raises(self):
        a = torch.zeros((2, 128), requires_grad=True)
        with pytest.raises(ValueError, match="inference-only"):
            ops.analog_mvm_split(a, a, torch.zeros((128, 4)),
                                 torch.ones(4), None,
                                 epilogue=("relu_shift", 3))


class TestRank1Rebuild:
    def test_store_rebuild_gradients_equal_autograd(self):
        """A rank-1 store lowered under autograd rebuilds ``w_eff`` without
        keeping ``codes * col_gain`` (``exec.plan._Rank1``): the values
        and the gradients to the codes and both gain vectors equal plain
        autograd's, bit for bit."""
        from repro_torch.exec.plan import WeightStore
        g = torch.Generator().manual_seed(0)
        codes = torch.randint(-63, 64, (256, 24), generator=g).float()
        col = 1 + 0.02 * torch.randn((24,), generator=g)
        row = 1 + 0.02 * torch.randn((1, 256), generator=g)
        r = torch.randn((256, 24), generator=g)
        got, want = [], []
        for out, fn in ((got, lambda c, a, b: WeightStore(  # verify: allow-packed-weights
                codes=c, w_scale=torch.ones((1, 24)), gain=torch.ones(()),
                col_gain=a, row_gain=b).w_eff),
                (want, lambda c, a, b: (c * a[None, :]) * b[0, :, None])):
            ts = [t.clone().requires_grad_(True) for t in (codes, col, row)]
            w = fn(*ts)
            (w * r).sum().backward()
            out += [w.detach()] + [t.grad for t in ts]
        for a, b in zip(got, want):
            assert torch.equal(a, b)


# ------------------------------------------------------------ train step
def _jstep(jrun, compression, jbatch, rng):
    """One reference step: (loss, grads, new state as numpy)."""
    st = jax.tree.map(jnp.asarray, _jstate_np(compression))
    loss_fn = _jloss_fn(jrun, jbatch, None if jrun.analog.deterministic
                        else rng)
    (jl, _), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        st["params"])
    jrun = dataclasses.replace(jrun, grad_compression=compression)
    step = JTS.make_train_step(JCFG, jrun)
    new, jm = step(st, jax.tree.map(jnp.asarray, jbatch), rng)
    return jl, jg, jax.tree.map(np.asarray, new), jm


class TestTrainStep:
    @pytest.mark.parametrize("case", ["split", "noisy_two_pass",
                                      "compression"])
    def test_step_matches_reference(self, case):
        noisy = case == "noisy_two_pass"
        compression = case == "compression"
        jrun, run = _runs(noisy=noisy)
        run = dataclasses.replace(run, grad_compression=compression)
        jb, tb = _batch(step=1)
        rng = jax.random.PRNGKey(11)
        jl, jg, jnew, jm = _jstep(jrun, compression, jb, rng)

        st = state_from_numpy(_jstate_np(compression), "cpu")
        noise = NoiseFeed(_ref_draws(rng, jrun)) if noisy else None
        loss, _, grads = TS.loss_and_grads(st["params"], tb, noise,
                                           cfg=CFG, run=run)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
        _check_grads(jg, grads)
        if noisy:
            # every draw read once, the remat recompute replayed them
            assert noise.pos == len(noise.draws)
            noise.rewind()
        step = TS.make_train_step(CFG, run)
        new, metrics = step(st, tb, noise)
        assert new is st                       # donated: updated in place
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                                   rtol=1e-6)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
        assert int(new["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
        for path, want, got in _pairs(jnew["opt"], new["opt"]):
            np.testing.assert_allclose(_np(got), want, err_msg=path,
                                       **STATE_TOL)
        if compression:
            for (path, want, got), (_, g, _) in zip(
                    _pairs(jnew["ef"], new["ef"]), _pairs(jg, new["ef"])):
                step = np.abs(np.asarray(g)).max() / 127.0   # int8 LSB
                lim = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(want)
                assert np.all(np.abs(_np(got) - want)
                              <= lim + 1.001 * step), path
        clip = min(1.0, run.grad_clip / (float(jm["grad_norm"]) + 1e-9))
        for (path, want, got), (_, g, _) in zip(
                _pairs(jnew["params"], new["params"]),
                _pairs(jg, new["params"])):
            well = np.abs(np.asarray(g)) * clip >= 1e-4
            np.testing.assert_allclose(_np(got)[well], want[well],
                                       err_msg=path, **STATE_TOL)
            assert np.all(np.abs(_np(got) - want)
                          <= 2 * run.learning_rate + 1e-6), path

    def test_remat_replays_generator_noise(self):
        """A noisy step with ``cfg.remat`` on and a ``torch.Generator``:
        the recompute replays the first forward's draws, so the gradients
        equal those of the same step without remat; the generator ends
        where the first forward left it."""
        import dataclasses
        _, run = _runs(noisy=True)
        _, tb = _batch()
        params = state_from_numpy(_jstate_np(), "cpu")["params"]
        out = {}
        for remat in (True, False):
            cfg = dataclasses.replace(CFG, remat=remat)
            gen = torch.Generator().manual_seed(5)
            loss, _, grads = TS.loss_and_grads(params, tb, gen, cfg=cfg,
                                               run=run)
            out[remat] = (loss, grads, gen.get_state())
        assert float(out[True][0]) == float(out[False][0])
        for path, a, b in _pairs(out[True][1], out[False][1]):
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)
        assert torch.equal(out[True][2], out[False][2])


# ----------------------------------------------------------- compression
class TestCompression:
    def test_round_trip_and_error_feedback(self):
        rng = np.random.default_rng(0)
        grads = [{"a": rng.standard_normal((5, 7)).astype(np.float32),
                  "b": {"c": (1e-3 * rng.standard_normal(9)).astype(
                      np.float32), "z": np.zeros(3, np.float32)}}
                 for _ in range(3)]
        jef = JC.ef_init(jax.tree.map(jnp.asarray, grads[0]))
        tef = C.ef_init(jax.tree.map(torch.tensor, grads[0]))
        for g in grads:
            jcomp, jef = JC.compress_grads(jax.tree.map(jnp.asarray, g), jef)
            tcomp, tef = C.compress_grads(jax.tree.map(torch.tensor, g), tef)
            jdec = JC.decompress_grads(jcomp)
            tdec = C.decompress_grads(tcomp)
            for path, want, got in _pairs(
                    jax.tree.map(np.asarray, jdec), tdec):
                np.testing.assert_array_equal(_np(got), want, err_msg=path)
            for path, want, got in _pairs(jax.tree.map(np.asarray, jef),
                                          tef):
                np.testing.assert_array_equal(_np(got), want, err_msg=path)
        # the codes are int8 within [-127, 127]; the residual is below
        # half a step of each leaf's scale
        codes, scale = C.compress(torch.tensor(grads[0]["a"]))
        assert codes.dtype == torch.int8 and int(codes.abs().max()) == 127
        rec = C.decompress(codes, scale)
        assert float((rec - torch.tensor(grads[0]["a"])).abs().max()) \
            <= float(scale) / 2 + 1e-7
        assert C.compression_ratio(tdec) == JC.compression_ratio(jdec)


# ----------------------------------------------------------------- fault
class TestFault:
    def test_heartbeat(self, tmp_path):
        d = str(tmp_path / "hb")
        for w in (0, 3):
            fault.Heartbeat(d, w).beat(7)
        hb = fault.Heartbeat(d, 1, timeout_s=60.0)
        assert hb.alive_workers() == [0, 3]
        assert hb.alive_workers(now=1e12) == []
        # the file format is the reference's: its heartbeat reads ours
        assert jfault.Heartbeat(d, 9).alive_workers() == [0, 3]

    def test_retry_and_straggler(self):
        calls, fails = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        pol = fault.RetryPolicy(max_retries=3, backoff_s=0.0)
        assert pol.run(flaky, on_failure=lambda a, e: fails.append(a)) == "ok"
        assert fails == [0, 1]
        with pytest.raises(RuntimeError, match="2 attempts"):
            fault.RetryPolicy(max_retries=1, backoff_s=0.0).run(
                lambda: 1 / 0)
        times = [1.0, 1.1, 0.9, 1.0, 1.05, 5.0, 1.0, 3.5]
        tc, jc = fault.StragglerClock(), jfault.StragglerClock()
        assert [tc.record(t) for t in times] == [jc.record(t) for t in times]
        assert tc.median == jc.median

    @pytest.mark.parametrize("n,mp,pod", [(256, 16, 256), (1024, 16, 256),
                                          (48, 16, 256), (17, 4, 8)])
    def test_elastic_mesh_shape(self, n, mp, pod):
        assert fault.elastic_mesh_shape(n, mp, pod) == \
            jfault.elastic_mesh_shape(n, mp, pod)
        with pytest.raises(ValueError):
            fault.elastic_mesh_shape(mp - 1, mp, pod)


# ------------------------------------------------------ loop, checkpoints
class TestLoopAndCheckpoints:
    def test_train_loop_resumes_from_checkpoint(self, tmp_path):
        kw = dict(smoke=True, steps=4, batch=2, seq_len=16,
                  mode="analog_faithful", log_every=0, device="cpu",
                  ckpt_every=2)
        full = tlaunch.train_loop("stablelm-3b", ckpt_dir=str(tmp_path / "a"),
                                  **kw)
        d = str(tmp_path / "b")
        tlaunch.train_loop("stablelm-3b", ckpt_dir=d, **kw)
        # the run "crashed" after step 2: only its first checkpoint is left
        shutil.rmtree(os.path.join(d, "step_000000004"))
        resumed = tlaunch.train_loop("stablelm-3b", ckpt_dir=d, **kw)
        assert len(resumed["losses"]) == 2
        assert resumed["losses"] == full["losses"][2:]
        assert full["losses"][-1] < full["losses"][0]
        for path, a, b in _pairs(full["state"]["params"],
                                 resumed["state"]["params"]):
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)
        # the host mesh: one gloo rank computes what no mesh computes, bit
        # for bit, and the group it started is ended
        mkw = dict(kw, steps=2)
        plain = tlaunch.train_loop("stablelm-3b", **mkw)
        meshed = tlaunch.train_loop("stablelm-3b", use_mesh=True, **mkw)
        assert meshed["losses"] == plain["losses"]
        for path, a, b in _pairs(plain["state"]["params"],
                                 meshed["state"]["params"]):
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)
        assert not torch.distributed.is_initialized()

    def test_train_loop_retries_only_the_gradients(self, monkeypatch):
        """A failure in the differentiated half is retried on the unchanged
        state (the losses and the state equal an unfailed run's); a failure
        in the in-place update is not retried (it would write the leaves
        already updated a second time) and ends the loop."""
        kw = dict(smoke=True, steps=2, batch=2, seq_len=16,
                  mode="analog_faithful", log_every=0, device="cpu")
        clean = tlaunch.train_loop("stablelm-3b", **kw)
        real = TS.loss_and_grads
        calls = []

        def flaky(*a, **k):
            calls.append(1)
            out = real(*a, **k)
            if len(calls) == 2:       # the second step's first attempt
                raise RuntimeError("injected")
            return out

        monkeypatch.setattr(TS, "loss_and_grads", flaky)
        got = tlaunch.train_loop("stablelm-3b", **kw)
        assert len(calls) == 3
        assert got["losses"] == clean["losses"]
        for path, a, b in _pairs(clean["state"], got["state"]):
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)
        monkeypatch.setattr(TS, "loss_and_grads", real)
        updates = []

        def broken(*a, **k):
            updates.append(1)
            raise RuntimeError("injected")

        monkeypatch.setattr(TS.O, "adamw_update_", broken)
        with pytest.raises(RuntimeError, match="injected"):
            tlaunch.train_loop("stablelm-3b", **kw)
        assert len(updates) == 1

    def test_checkpoints_cross_packages(self, tmp_path):
        st = _jstate_np()
        jst = jax.tree.map(jnp.asarray, st)
        tst = state_from_numpy(st, "cpu")
        tst["params"]["lm_head"]["w"].add_(1.0)   # tell the two apart
        CKPT.save(str(tmp_path / "t"), 3, tst["params"], tst["opt"],
                  extra={"by": "port"})
        JCKPT.save(str(tmp_path / "j"), 5, jst["params"], jst["opt"],
                   extra={"by": "reference"})
        # the reference restores the port's checkpoint ...
        jp, jo, step, extra = JCKPT.restore_latest(
            str(tmp_path / "t"), jst["params"], jst["opt"])
        assert (step, extra) == (3, {"by": "port"})
        for path, want, got in _pairs({"p": tst["params"], "o": tst["opt"]},
                                      {"p": jp, "o": jo}):
            np.testing.assert_array_equal(np.asarray(got), _np(want),
                                          err_msg=path)
            assert np.asarray(got).dtype == _np(want).dtype, path
        # ... and the port the reference's
        tp, to, step, extra = CKPT.restore_latest(
            str(tmp_path / "j"), tst["params"], tst["opt"])
        assert (step, extra) == (5, {"by": "reference"})
        for path, want, got in _pairs({"p": st["params"], "o": st["opt"]},
                                      {"p": tp, "o": to}):
            np.testing.assert_array_equal(_np(got), want, err_msg=path)
        # a corrupt newest checkpoint is skipped
        CKPT.save(str(tmp_path / "j"), 6, tst["params"], tst["opt"])
        with open(os.path.join(str(tmp_path / "j"), "step_000000006",
                               "shard-00000.npz"), "r+b") as f:
            f.write(b"garbage")
        assert CKPT.restore_latest(str(tmp_path / "j"), tst["params"],
                                   tst["opt"])[2] == 5
