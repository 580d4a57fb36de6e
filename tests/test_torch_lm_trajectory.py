"""Six LM training steps in both packages side by side, on the CPU:
``stablelm-3b``'s SMOKE config (2 layers, d_model 128, d_ff 256, vocab
512) at the reference's ``RunConfig`` defaults (AdamW at 3e-4, warmup
100 of 10 000 steps, weight decay 0.1, clip 1.0, dynamic activation
calibration, the default rank-1 fixed pattern), ``analog_faithful``,
through each package's ``make_train_step``.

Both start from one numpy state: the reference's ``init_state`` carried
across by ``convert.state_from_numpy``.  The batches are
``data.lm_data``'s, bit-identical between the packages.  The readout
noise of the noisy case is the reference's own draw for each step's key,
replayed through a ``NoiseFeed``.  After every step the loss,
``grad_norm`` and ``lr`` are held against the reference's, and a
held-out batch's loss through the no-grad path before the first step and
after each; after the last step, the parameters and moments.

Where a case leaves the defaults, and why
(``test_torch_lm_trajectory_ties.py`` shows each cause):

- every case runs at ``activation_dtype="float32"``.  At bf16 the port
  computes the reference's operations one by one bit for bit, but the
  reference's compiled program (its groups under ``lax.scan``) rounds
  bf16 elsewhere than its own op-by-op arithmetic, and the next dynamic
  5-bit encode moves with the ulps (0.26 % on the held-out loss before
  any step).
- ``warmup`` (``warmup_steps=2``: the schedule's cosine decay is crossed
  from step 3 on) runs at static activation calibration.  At dynamic
  calibration its second step's forward puts one lm_head input on a
  5-bit rounding tie, which the compiled reference's fused LayerNorm
  rounds up and the port (like the reference op by op) down.
- ``noisy`` runs on integer effective weights (the fixed pattern
  ``NOISELESS``, as the one-step noisy test).  With the default float
  gain tables a noisy readout can fall within an ulp of an ADC rounding
  boundary, and the two frameworks sum a chunk's fp32 products in
  another order: measured, the default pattern's noisy run at static
  calibration parted at step 3 (group 1's first encode read one other
  code at an input 0.5 % apart, every encode of group 0 equal: one ADC
  readout of group 0 had rounded the other way).

Tolerances.  Step 1: the loss within 1e-6 relative, ``grad_norm`` and
``lr`` within 1e-5 (the one-step test's, ``test_torch_lm_train.py``).
Later steps: the loss and the held-out loss within 1e-5 relative: the
parameters carry the first step's fp32 differences (sums in another
order, ``STATE_TOL``) into every later forward and grow with each update
(measured: below 2e-7 relative on every loss).  After the last step:
the moments within ``STATE_TOL``; the parameters within ``STATE_TOL``
where the last clipped gradient is at least 1e-4 (elsewhere AdamW's
``m / (sqrt(v) + eps)`` is ill-conditioned, so there within 2 x the
summed learning rates).
"""
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
from repro.core.noise import NOISELESS as JNOISELESS  # noqa: E402
from repro.core.noise import readout_noise as j_readout_noise  # noqa: E402
from repro.data import lm_data as jdata  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.noise import NoiseFeed  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

ARCH = "stablelm-3b"
CFG = configs.get_smoke(ARCH)
JCFG = jconfigs.get_smoke(ARCH)
STEPS = 6
SEQ, BATCH = 16, 2
HELD_OUT = 1000             # the held-out batch's step index
STEP1_LOSS_REL = 1e-6
STEP1_METRIC_REL = 1e-5
LATER_LOSS_REL = 1e-5
STATE_TOL = dict(atol=1e-6, rtol=1e-5)
CASES = {
    # name: (readout noise, act_calib, warmup_steps)
    "deterministic": (False, "dynamic", 100),
    "noisy": (True, "dynamic", 100),       # on integer effective weights
    "warmup": (False, "static", 2),
}


def _np(x):
    return x.detach().cpu().numpy()


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def _runs(noisy=False, act_calib="dynamic", warmup=100,
          activation_dtype="float32"):
    """(reference RunConfig, port RunConfig): the defaults but for the
    activation dtype, the readout noise, the activation calibration and
    the warmup."""
    kw = dict(mode="analog_faithful", deterministic=not noisy,
              act_calib=act_calib)
    common = dict(warmup_steps=warmup, activation_dtype=activation_dtype)
    return (JRunConfig(analog=JAnalogConfig(**kw), **common),
            RunConfig(analog=AnalogConfig(**kw), **common))


@functools.lru_cache(maxsize=None)
def _jstate_np(integer=False):
    """The reference's ``init_state`` at the defaults, as numpy;
    ``integer``: the fixed pattern ``NOISELESS`` (every effective weight
    an integer code)."""
    saved = JT.NOISE
    if integer:
        JT.NOISE = JNOISELESS
    try:
        st = JTS.init_state(jax.random.PRNGKey(0), JCFG, JRunConfig())
    finally:
        JT.NOISE = saved
    return jax.tree.map(np.asarray, st)


def _batch(step):
    b = jdata.SyntheticLM(jdata.DataConfig(
        vocab_size=JCFG.vocab_size, seq_len=SEQ, global_batch=BATCH)
    ).batch(step)
    return b, {k: torch.as_tensor(v, dtype=torch.int64) for k, v in b.items()}


def _ref_draws(rng, jrun):
    """The reference's readout-noise draws in the port's call order: per
    group (key ``split(rng, n_groups)[g]``, layer key ``fold_in(., 0)``)
    the attention's q, k, v (``split(key, 4)[:3]``; one fused draw under
    dynamic calibration) and wo (``[3]``), the MLP's up, gate and down
    (``split(key, 3)``), then the lm_head (``rng``); each layer's key
    split once more into its positive and negative pass."""
    nq, nkv = JCFG.n_heads * JCFG.hd, JCFG.n_kv_heads * JCFG.hd
    d, ff, cr = JCFG.d_model, JCFG.d_ff, jrun.analog.chunk_rows
    fused = jrun.analog.act_calib == "dynamic"

    def layer(key, k, n):
        shape = (BATCH, SEQ, -(-k // cr), n)
        return [j_readout_noise(kk, shape, jrun.analog.noise)
                for kk in jax.random.split(key)]

    draws = []
    for gk in jax.random.split(rng, JT.n_groups(JCFG)):
        lk = jax.random.fold_in(gk, 0)
        ka, km = jax.random.split(lk, 4), jax.random.split(lk, 3)
        if fused:
            draws += layer(ka[0], d, nq + 2 * nkv)
        else:
            draws += (layer(ka[0], d, nq) + layer(ka[1], d, nkv)
                      + layer(ka[2], d, nkv))
        draws += layer(ka[3], nq, d)
        draws += layer(km[0], d, ff) + layer(km[1], d, ff)
        draws += layer(km[2], ff, d)
    draws += layer(rng, d, JCFG.vocab_size)
    return [torch.tensor(np.asarray(x)) for x in draws]


def _held_out(jrun, run):
    """The held-out batch's loss through each package's no-grad path
    (compile, then ``lm_loss`` on the lowered tree, no readout noise)."""
    jb, tb = _batch(HELD_OUT)

    @jax.jit
    def ref(p):
        model = japi.compile(JT.lm_module_spec(JCFG, p), p, jrun)
        return JT.lm_loss(model.lower(), jb, JCFG, jrun)[0]

    def port(p):
        with torch.no_grad():
            plan = api.compile(T.lm_module_spec(CFG, p), p, run,
                               device="cpu").lower()
            return float(T.lm_loss(plan, tb, CFG, run)[0])

    return lambda p: float(ref(p)), port


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_reference(case):
    noisy, act_calib, warmup = CASES[case]
    jrun, run = _runs(noisy, act_calib, warmup)
    jheld, held = _held_out(jrun, run)
    jst = jax.tree.map(jnp.asarray, _jstate_np(noisy))
    st = state_from_numpy(_jstate_np(noisy), "cpu")
    jstep = JTS.make_train_step(JCFG, jrun)
    step = TS.make_train_step(CFG, run)
    readings = [("held-out", 0, held(st["params"]), jheld(jst["params"]))]
    lrs = []
    for i in range(STEPS):
        jb, tb = _batch(i)
        rng = jax.random.PRNGKey(100 + i)
        noise = NoiseFeed(_ref_draws(rng, jrun)) if noisy else None
        if i == STEPS - 1:
            # the last step's gradient, for the well-conditioned mask
            grads = TS.loss_and_grads(st["params"], tb, noise, cfg=CFG,
                                      run=run)[2]
            if noisy:
                noise.rewind()
        jst, jm = jstep(jst, jax.tree.map(jnp.asarray, jb), rng)
        st, m = step(st, tb, noise)
        if noisy:
            # every draw read, the remat recompute replaying them
            assert noise.pos == len(noise.draws)
        lrs.append(float(jm["lr"]))
        readings += [(k, i + 1, float(m[k]), float(jm[k]))
                     for k in ("loss", "grad_norm", "lr")]
        readings.append(("held-out", i + 1, held(st["params"]),
                         jheld(jst["params"])))
    bad = []
    for what, i, got, want in readings:
        lim = (LATER_LOSS_REL if i > 1 else STEP1_LOSS_REL) \
            if what in ("loss", "held-out") else STEP1_METRIC_REL
        if what in ("grad_norm", "lr") and i > 1:
            continue
        if not np.isfinite(got) or _rel(got, want) > lim:
            bad.append(f"step {i} {what}: port {got!r} reference {want!r}")
    assert not bad, "; ".join(bad)

    jnew = jax.tree.map(np.asarray, jst)
    assert int(st["opt"]["step"]) == int(jnew["opt"]["step"]) == STEPS
    for path, want, got in _pairs(jnew["opt"]["m"], st["opt"]["m"]):
        np.testing.assert_allclose(_np(got), want, err_msg=path, **STATE_TOL)
    for path, want, got in _pairs(jnew["opt"]["v"], st["opt"]["v"]):
        np.testing.assert_allclose(_np(got), want, err_msg=path, **STATE_TOL)
    # the last step's clipped gradient marks where AdamW is well
    # conditioned (the one-step test's mask; the port's gradient, which
    # the one-step test holds to the reference's within 1e-5)
    clip = min(1.0, run.grad_clip / (float(jm["grad_norm"]) + 1e-9))
    grad_of = {path: g for path, g, _ in _pairs(grads, grads)}
    for path, want, got in _pairs(jnew["params"], st["params"]):
        well = np.abs(_np(grad_of[path])) * clip >= 1e-4
        np.testing.assert_allclose(_np(got)[well], want[well], err_msg=path,
                                   **STATE_TOL)
        assert np.all(np.abs(_np(got) - want)
                      <= 2 * sum(lrs) + 1e-6), path
