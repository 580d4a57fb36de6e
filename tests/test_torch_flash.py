"""The port's flash attention (repro_torch.models.flash) against the JAX
package's, on the CPU: the blockwise forward, the custom blockwise
backward against ``jax.grad`` of the reference's ``custom_vjp``, padded
lengths, a sliding window, grouped queries (G > 1), a query offset, and
``attention_apply`` past a lowered ``flash_threshold``.

The same numpy inputs go through both; both walk the same blocks in the
same order with the same ``-1e30`` additive penalty.  Tolerances:

- output and gradients against the reference: ``atol = 2e-6``, ``rtol =
  1e-5`` (fp32 exponentials and einsum contractions in another order).
- output and gradients against the port's own plain dense attention and
  its autograd: ``atol = 2e-5`` (the reference's
  ``test_flash_matches_dense``).
- ``attention_apply`` through the analog projections (phi4-mini smoke,
  NOISELESS, fp32 activations): within ``1e-5 * max|out|``.
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
from repro.models import attention as JA  # noqa: E402
from repro.models import flash as JF  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.noise import NOISELESS  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import flash as F  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

REF_TOL = dict(atol=2e-6, rtol=1e-5)
DENSE_ATOL = 2e-5


def _inputs(b, sq, sk, kvh, g, dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, kvh, g, dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, dh)).astype(np.float32)
    r = rng.uniform(0.5, 1.5, (b, sq, kvh, g, dh)).astype(np.float32)
    return q, k, v, r


def _dense_windowed(q, k, v, *, window):
    """The plain dense causal attention, ``window`` positions back at
    most (the port's ``_dense_attention`` has no window: nothing in the
    port's dense path passes one)."""
    if window is None:
        return A._dense_attention(q, k, v, causal=True)
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k) / np.sqrt(q.shape[-1])
    pos = torch.arange(sq)[:, None] - torch.arange(sk)[None, :]
    s = torch.where((pos >= 0) & (pos < window), s, A.NEG_INF)
    return torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), v)


def _torch_run(fn, q, k, v, r):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = fn(*ts)
    (o * torch.tensor(r)).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


# (b, sq, sk, kvh, g, dh, block_q, block_kv, window, q_offset)
CASES = {
    "blocks_even": (1, 64, 64, 2, 1, 16, 16, 32, None, 0),
    "padded": (2, 50, 50, 2, 1, 8, 16, 32, None, 0),
    "gqa_g3": (1, 48, 48, 2, 3, 16, 16, 16, None, 0),
    "window": (1, 64, 64, 1, 2, 8, 16, 16, 20, 0),
    "padded_window_gqa": (2, 37, 37, 1, 4, 8, 8, 16, 9, 0),
    "q_offset": (1, 16, 48, 2, 1, 8, 8, 16, None, 32),
}


class TestFlashAgainstReference:
    @pytest.mark.parametrize("name", list(CASES))
    def test_forward_and_gradients(self, name):
        b, sq, sk, kvh, g, dh, bq, bk, window, q_off = CASES[name]
        q, k, v, r = _inputs(b, sq, sk, kvh, g, dh)
        kw = dict(causal=True, q_offset=q_off, block_q=bq, block_kv=bk,
                  window=window)

        def jloss(q_, k_, v_):
            return jnp.sum(JF.flash_attention(q_, k_, v_, **kw) * r)

        jo = JF.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
        jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        o, grads = _torch_run(functools.partial(F.flash_attention, **kw),
                              q, k, v, r)
        np.testing.assert_allclose(o, np.asarray(jo), **REF_TOL)
        for name_, want, got in zip("qkv", jg, grads):
            np.testing.assert_allclose(got, np.asarray(want), err_msg=name_,
                                       **REF_TOL)


class TestFlashAgainstDense:
    @pytest.mark.parametrize("name", ["blocks_even", "padded", "gqa_g3",
                                      "window", "padded_window_gqa"])
    def test_matches_dense_attention(self, name):
        b, sq, sk, kvh, g, dh, bq, bk, window, _ = CASES[name]
        q, k, v, r = _inputs(b, sq, sk, kvh, g, dh, seed=1)
        o, grads = _torch_run(functools.partial(
            F.flash_attention, block_q=bq, block_kv=bk, window=window),
            q, k, v, r)
        od, gd = _torch_run(functools.partial(
            _dense_windowed, window=window), q, k, v, r)
        np.testing.assert_allclose(o, od, atol=DENSE_ATOL)
        for want, got in zip(gd, grads):
            np.testing.assert_allclose(got, want, atol=DENSE_ATOL)

    def test_saves_no_per_block_scores(self):
        """The autograd graph holds q, k, v, o, lse and the positions: no
        [Sq, Sk] tensor survives the forward."""
        q, k, v, _ = _inputs(1, 64, 64, 2, 1, 8)
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
            F.flash_attention(*ts, block_q=16, block_kv=16)
        assert max(int(np.prod(s)) for s in saved) <= 64 * 2 * 8
        assert (1, 64, 2, 1) in saved            # lse


# ----------------------------------------------------- attention_apply
ARCH = "phi4-mini-3.8b"


@functools.lru_cache(maxsize=None)
def _attn_models():
    jcfg = jconfigs.get_smoke(ARCH)
    saved = JT.NOISE
    JT.NOISE = JNOISELESS
    try:
        jp = JT.lm_init(jax.random.PRNGKey(0), jcfg)
    finally:
        JT.NOISE = saved
    jrun = JRunConfig(analog=JAnalogConfig(mode="analog_faithful",
                                           noise=JNOISELESS),
                      activation_dtype="float32")
    run = RunConfig(analog=AnalogConfig(mode="analog_faithful",
                                        noise=NOISELESS),
                    activation_dtype="float32")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jm = japi.compile(JT.lm_module_spec(jcfg, jp), jp, jrun)
    tm = api.compile(T.lm_module_spec(configs.get_smoke(ARCH), tp), tp, run,
                     device="cpu")
    slice0 = lambda tree: jax.tree.map(lambda x: x[0], tree)  # noqa: E731
    jattn = slice0(jm.lower()["layers"]["l0"]["attn"])
    tattn = T.stack_index(tm.lower()["layers"], 0)["l0"]["attn"]
    return jcfg, jrun, run, jattn, tattn


class TestAttentionApplyFlash:
    @pytest.mark.parametrize("seq,threshold", [(24, 8), (40, 16)])
    def test_long_prefill_routes_to_flash(self, seq, threshold):
        jcfg, jrun, run, jattn, tattn = _attn_models()
        x = np.random.default_rng(seq).standard_normal(
            (2, seq, jcfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (2, seq))
        kw = dict(n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads,
                  head_dim=jcfg.hd, rope_theta=jcfg.rope_theta,
                  flash_threshold=threshold)
        want, _ = JA.attention_apply(jattn, jnp.asarray(x),
                                     positions=jnp.asarray(pos),
                                     acfg=jrun.analog, **kw)
        calls = []
        orig = A.flash_attention
        A.flash_attention = lambda *a, **k: calls.append(1) or orig(*a, **k)
        try:
            got, cache = A.attention_apply(
                tattn, torch.tensor(x), positions=torch.tensor(pos),
                acfg=run.analog, **kw)
        finally:
            A.flash_attention = orig
        assert calls == [1] and cache is None
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * float(np.abs(want).max()))
