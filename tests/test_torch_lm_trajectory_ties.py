"""The two causes that keep ``test_torch_lm_trajectory.py`` off two of
the reference's defaults, each shown on the CPU (torch + jax):

- at dynamic activation calibration the warmup case's second step parts
  at one 5-bit code on a rounding tie, named here by layer and element;
- at bf16 activations the port's layers equal the reference's computed
  op by op, bit for bit, while the reference's compiled forward does not.

Both compare the compiled reference (what ``make_train_step`` and a
jitted loss run) with its own op-by-op arithmetic
(``jax.disable_jit``, or a layer called eagerly), which the port follows.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.convert import params_from_numpy, state_from_numpy  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

from test_torch_lm_trajectory import (  # noqa: E402
    BATCH, CFG, JCFG, HELD_OUT, JT, JTS, LATER_LOSS_REL, SEQ, STATE_TOL, T,
    TS, _batch, _jstate_np, _np, _pairs, _rel, _runs, api, japi)

# the tie: the lm_head's negative pass (the 22nd and last encode of the
# forward), element (batch 0, position 12, feature 43), its code in the
# compiled reference and in the port
TIE_CALL, TIE_ELEMENT, TIE_CODES = 21, (0, 12, 43), (4.0, 3.0)


def test_dynamic_tie_at_step_two():
    """At dynamic calibration the warmup case parts at its second step,
    and the cause is one 5-bit code on a rounding tie.  After step 1 the
    parameters agree (``STATE_TOL``) and the port's forward on the
    reference's own parameters gives the port's loss, so the parameters
    are not the cause.  On the step-2 batch every analog encode of the
    forward reads the same codes in both packages but one: the lm_head's
    negative pass at (batch 0, position 12, feature 43), where x / scale
    is 3.5 within 1e-5 - the compiled reference's fused final LayerNorm
    is two ulps off the op-by-op value - and the reference encodes 4, the
    port 3.  Op by op (``jax.disable_jit``, no remat) the reference
    encodes 3 and its loss is the port's within 1e-7."""
    jrun, run = _runs(warmup=2)
    jst = jax.tree.map(jnp.asarray, _jstate_np())
    st = state_from_numpy(_jstate_np(), "cpu")
    jb, tb = _batch(0)
    jst, _ = JTS.make_train_step(JCFG, jrun)(
        jst, jax.tree.map(jnp.asarray, jb), jax.random.PRNGKey(100))
    st, _ = TS.make_train_step(CFG, run)(st, tb, None)
    jparams = jax.tree.map(np.asarray, jst["params"])
    for path, want, got in _pairs(jparams, st["params"]):
        close = np.isclose(_np(got), want, **STATE_TOL)
        assert close.mean() > 0.999, path
    jb, tb = _batch(1)
    jplan = japi.compile(JT.lm_module_spec(JCFG, jst["params"]),
                         jst["params"], jrun).lower()
    codes = {"ref": [], "port": []}
    orig_j, orig_t = jquant.quantize_act, quant.quantize_act

    def spy_j(x, s):
        jax.debug.callback(lambda a, b: codes["ref"].append(
            (np.asarray(a), np.asarray(b))), x, s, ordered=True)
        return orig_j(x, s)

    def spy_t(x, s):
        codes["port"].append((_np(x), _np(s)))
        return orig_t(x, s)

    jquant.quantize_act, quant.quantize_act = spy_j, spy_t
    try:
        j_loss = float(jax.jit(
            lambda p: JT.lm_loss(p, jb, JCFG, jrun)[0])(jplan))
        with torch.no_grad():
            losses = {}
            # the port's codes of the last run, on its own parameters
            for who, p in (("port on ref params",
                            params_from_numpy(jparams, "cpu")),
                           ("port", st["params"])):
                codes["port"] = []
                plan = api.compile(T.lm_module_spec(CFG, p), p, run,
                                   device="cpu").lower()
                losses[who] = float(T.lm_loss(plan, tb, CFG, run)[0])
        codes["op"] = []
        jquant.quantize_act = lambda x, s: (codes["op"].append(
            (np.asarray(x), np.asarray(s))), orig_j(x, s))[1]
        with jax.disable_jit():
            op_loss = float(JT.lm_loss(jplan, jb, dataclasses.replace(
                JCFG, remat=False), jrun)[0])
    finally:
        jquant.quantize_act, quant.quantize_act = orig_j, orig_t
    assert _rel(losses["port"], j_loss) > LATER_LOSS_REL
    assert _rel(losses["port on ref params"], losses["port"]) < 1e-7
    assert _rel(op_loss, losses["port"]) < 1e-7

    def enc(x, s):
        return np.clip(np.round(x / s), 0, 31)

    assert len(codes["ref"]) == len(codes["port"]) == len(codes["op"]) == 22
    differing = []
    for i, ((xr, sr), (xt, st_), (xo, so)) in enumerate(
            zip(codes["ref"], codes["port"], codes["op"])):
        np.testing.assert_array_equal(enc(xt, st_), enc(xo, so))
        for ix in zip(*np.nonzero(enc(xr, sr) != enc(xt, st_))):
            ix = tuple(int(v) for v in ix)
            differing.append((i, ix, float(enc(xr, sr)[ix]),
                              float(enc(xt, st_)[ix]),
                              float(xr[ix] / sr), float(xt[ix] / st_)))
    assert [d[:4] for d in differing] == [(TIE_CALL, TIE_ELEMENT,
                                           *TIE_CODES)]
    assert all(abs(v - 3.5) < 1e-5 for v in differing[0][4:])


def test_bf16_port_is_the_reference_op_by_op():
    """At bf16 activations the port's layers equal the reference's
    computed op by op, bit for bit, on the same input (the SwiGLU's SiLU
    included: ``F.silu`` differed in the last bit of a third of its
    outputs); the reference's compiled forward (its groups under
    ``lax.scan``) does not equal its own op-by-op layers, which is why the
    trajectory is held at fp32 activations."""
    jrun, run = _runs(activation_dtype="bfloat16")
    p_np = _jstate_np()["params"]
    jp = jax.tree.map(jnp.asarray, p_np)
    jb, tb = _batch(HELD_OUT)
    jplan = japi.compile(JT.lm_module_spec(JCFG, jp), jp, jrun).lower()
    tp = params_from_numpy(p_np, "cpu")
    torch.set_grad_enabled(False)
    try:
        tplan = api.compile(T.lm_module_spec(CFG, tp), tp, run,
                            device="cpu").lower()
        x = JL.embedding_apply(jp["embed"], jnp.asarray(jb["tokens"])
                               ).astype(jnp.bfloat16)
        pos = jnp.broadcast_to(jnp.arange(SEQ, dtype=jnp.int32)[None],
                               (BATCH, SEQ))

        def to_t(a):
            return torch.tensor(np.asarray(a.astype(jnp.float32))).to(
                torch.bfloat16)

        def equal(a, t):
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(a.astype(jnp.float32)))

        for g in range(JT.n_groups(JCFG)):
            jl = jax.tree.map(lambda a: a[g], jplan["layers"])["l0"]
            tl = T.stack_index(tplan["layers"], g)["l0"]
            h = JL.norm_apply(jl["ln2"], x, JCFG.norm)
            up = JL.linear_apply(jl["mlp"]["up"], h, jrun.analog)
            equal(jax.nn.silu(up), L.silu(to_t(up)))
            jx = JT._layer_apply(jl, "attn_mlp", x, cfg=JCFG, run=jrun,
                                 positions=pos, cache=None, key=None)[0]
            tx = T._layer_apply(tl, "attn_mlp", to_t(x), cfg=CFG, run=run,
                                positions=torch.tensor(np.asarray(pos)),
                                cache=None)[0]
            equal(jx, tx)
            x = jx
        x = JL.norm_apply(jplan["final_norm"], x, JCFG.norm)
        op_logits = JL.linear_apply(jplan["lm_head"], x, jrun.analog)
        equal(op_logits, L.linear_apply(tplan["lm_head"], to_t(x),
                                        run.analog))
        compiled = JT.lm_apply(jplan, jb, JCFG, jrun)[0]
        assert not np.array_equal(np.asarray(compiled.astype(jnp.float32)),
                                  np.asarray(op_logits.astype(jnp.float32)))
    finally:
        torch.set_grad_enabled(True)
