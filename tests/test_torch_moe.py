"""The port's MoE layer (``repro_torch.models.moe``) and its expert
stacks (``lower_expert_stack`` / ``run_expert_stack``, the split kernel's
expert axis) against the JAX package's, on the CPU.

The expert weights are integer codes (LSB 2^-6, each column's largest
|code| 63), so every quantity of the expert products is exact in any
order: codes, column scales, the statistical gain (a mean of integer
squares) and every chunk sum.  Tolerances:

- the expert products (per-call and pre-lowered, both packages, both
  modes): bit-exact.
- the dispatch and the combine, with both packages' expert FFN replaced
  by the same exact stand-in and the reference's routing passed in:
  bit-exact (dense fallback: bit-exact at top-1; at top-k > 1 within
  1e-6 * max|y|, the einsum over the experts sums in another order).
- ``moe_apply`` whole, the reference's routing passed in: within
  1e-5 * max|y| (SiLU and the shared expert's transcendentals round
  differently in the two frameworks).  Its own routing: the same top-k
  indices; the weights and the aux loss within 1e-6 relative (the
  softmax and the mean over the tokens round in another order).
- ties in top-k go to the lower expert index, as ``jax.lax.top_k``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.noise import NOISELESS as JNOISELESS  # noqa: E402
from repro.exec.lower import lower_expert_stack as jlower_expert_stack  # noqa: E402
from repro.exec.plan import GroupPlan as JGroupPlan  # noqa: E402
from repro.exec.run import run_expert_stack as jrun_expert_stack  # noqa: E402
from repro.models import moe as JM  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.analog import AnalogConfig, analog_matmul  # noqa: E402
from repro_torch.exec import lower as tlower  # noqa: E402
from repro_torch.exec import run as trun  # noqa: E402
from repro_torch.exec import store  # noqa: E402
from repro_torch.exec.plan import GroupPlan, PlanStack  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

D, FF, E, S = 64, 32, 8, 6
MODES = ("analog_faithful", "analog_fast")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _code_weights(rng, shape):
    """Integer-code weights: codes in [-20, 20], one row of 63 (every
    column's max), LSB 2^-6 - exact scales, gains and chunk sums."""
    codes = rng.integers(-20, 21, shape)
    codes[..., 3, :] = 63
    return (codes * 2.0 ** -6).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _layer(act: str, n_shared: int):
    """The reference's MoE layer draw (NOISELESS shared expert), its
    expert stacks swapped for integer-code weights, as numpy."""
    jp = JM.moe_init(jax.random.PRNGKey(0), D, FF, E, n_shared=n_shared,
                     act=act, noise=JNOISELESS)
    p = jax.tree.map(np.array, jp)        # writable copies
    rng = np.random.default_rng(1)
    for name in ("up", "gate", "down"):
        if name in p:
            p[name] = _code_weights(rng, p[name].shape)
    return p


def _x(seed=2, b=2, s=S):
    return (np.random.default_rng(seed).standard_normal((b, s, D)) * 0.7
            ).astype(np.float32)


def _j_routing(p, x, k):
    """The reference's routing, computed as its ``moe_apply`` does."""
    logits = jnp.asarray(x) @ jnp.asarray(p["router"]["w"])
    probs = jax.nn.softmax(logits, axis=-1)
    topw, topi = jax.lax.top_k(probs, k)
    topw = topw / jnp.maximum(topw.sum(-1, keepdims=True), 1e-9)
    return np.array(topw), np.array(topi)


def _replay(jw, ji):
    return M.Routes(replay=[(torch.from_numpy(jw),
                             torch.from_numpy(ji).long())])


class TestRouting:
    def test_top_k_ties_go_to_the_lower_index(self):
        probs = np.array([[0.2, 0.3, 0.3, 0.1, 0.3, 0.3, 0.0, 0.1]],
                         np.float32)
        for k in (1, 2, 3, 5, 8):
            jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
            tv, ti = M.top_k_lower_index(torch.from_numpy(probs), k)
            np.testing.assert_array_equal(_np(ti), np.asarray(ji))
            np.testing.assert_array_equal(_np(tv), np.asarray(jv))

    def test_positions_come_from_a_stable_sort(self):
        # many copies of few experts: each expert's copies are numbered in
        # token order, the reference's segment-start arithmetic
        topi = torch.tensor([[[2, 0], [2, 1], [0, 2], [2, 0], [1, 2]]])
        eg, pos_c, keep, slot_order = M.dispatch_layout(topi, 3, 2)
        np.testing.assert_array_equal(_np(eg[0]),
                                      [2, 0, 2, 1, 0, 2, 2, 0, 1, 2])
        np.testing.assert_array_equal(_np(pos_c[0]),
                                      [0, 0, 1, 0, 1, 1, 1, 1, 1, 1])
        np.testing.assert_array_equal(
            _np(keep[0]), [1, 1, 1, 1, 1, 0, 0, 0, 1, 0])
        # each token's slots in ascending expert order
        np.testing.assert_array_equal(_np(slot_order[0]),
                                      [[1, 0], [1, 0], [0, 1], [1, 0],
                                       [0, 1]])

    @pytest.mark.parametrize("k", [1, 2, 8])
    def test_routing_and_aux_match(self, k):
        p = _layer("swiglu", 0)
        x = _x()
        jw, ji = _j_routing(p, x, k)
        probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(
            p["router"]["w"]), dim=-1)
        tw, ti, aux = M.route(probs, k)
        np.testing.assert_array_equal(_np(ti), ji)
        np.testing.assert_allclose(_np(tw), jw, rtol=1e-6, atol=0)
        _, jaux = JM.moe_apply(p, jnp.asarray(x), acfg=JAnalogConfig(
            mode="digital"), top_k=k)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def _exact_ffn(params, xe, act, acfg):
    """A stand-in expert FFN both packages compute exactly: expert e
    scales its rows by 2^e."""
    e = xe.shape[-3]
    scale = 2.0 ** np.arange(e, dtype=np.float32)
    shape = (e,) + (1,) * 2
    if isinstance(xe, torch.Tensor):
        return xe * torch.from_numpy(scale).reshape(shape).to(xe.dtype)
    return xe * jnp.asarray(scale).reshape(shape).astype(xe.dtype)


class TestDispatch:
    @pytest.mark.parametrize("dense", [False, True])
    @pytest.mark.parametrize("k", [1, 2, 8])
    def test_dispatch_and_combine_exact(self, monkeypatch, k, dense):
        """Over-capacity drops at top-1 and top-2 (capacity 1 and 2 for 6
        tokens over 8 experts), none at top-8."""
        monkeypatch.setattr(JM, "_expert_ffn", _exact_ffn)
        monkeypatch.setattr(M, "_expert_ffn", _exact_ffn)
        p = _layer("swiglu", 0)
        x = _x()
        jw, ji = _j_routing(p, x, k)
        jy, _ = JM.moe_apply(p, jnp.asarray(x), acfg=JAnalogConfig(),
                             top_k=k, dense=dense)
        ty, _ = M.moe_apply(params_from_numpy(p, "cpu"), torch.from_numpy(x),
                            acfg=AnalogConfig(), top_k=k, dense=dense,
                            routes=_replay(jw, ji))
        want = np.asarray(jy)
        if dense and k > 1:
            np.testing.assert_allclose(_np(ty), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
        else:
            np.testing.assert_array_equal(_np(ty), want)
        if not dense and k < 8:
            # some copies were dropped: their tokens lost a contribution
            cap = int(max(k, 1.25 * S * k / E))
            counts = np.stack([np.bincount(r.ravel(), minlength=E)
                               for r in ji])
            assert (counts > cap).any()


class TestMoeApply:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("dense", [False, True])
    @pytest.mark.parametrize("k", [1, 2, 8])
    def test_moe_apply_matches_the_reference(self, k, dense, mode):
        """With a shared expert (its NOISELESS analog MLP) and the
        reference's routing passed in."""
        p = _layer("swiglu", 1)
        x = _x()
        jw, ji = _j_routing(p, x, k)
        jy, jaux = JM.moe_apply(p, jnp.asarray(x),
                                acfg=JAnalogConfig(mode=mode), top_k=k,
                                dense=dense)
        ty, aux = M.moe_apply(
            params_from_numpy(p, "cpu"), torch.from_numpy(x),
            acfg=AnalogConfig(mode=mode), top_k=k, dense=dense,
            routes=_replay(jw, ji))
        want = np.asarray(jy)
        assert np.isfinite(want).all() and np.abs(want).max() > 0
        np.testing.assert_allclose(_np(ty), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)

    def test_gelu_experts_and_the_mesh_dispatch(self):
        p = _layer("gelu", 0)
        x = _x()
        jw, ji = _j_routing(p, x, 2)
        jy, _ = JM.moe_apply(p, jnp.asarray(x), acfg=JAnalogConfig(),
                             top_k=2, act="gelu")
        ty, _ = M.moe_apply(params_from_numpy(p, "cpu"), torch.from_numpy(x),
                            acfg=AnalogConfig(), top_k=2, act="gelu",
                            routes=_replay(jw, ji))
        want = np.asarray(jy)
        np.testing.assert_allclose(_np(ty), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        # without a mesh the expert-parallel dispatch is the gspmd_ep path
        sy, saux = M.moe_apply(params_from_numpy(p, "cpu"),
                               torch.from_numpy(x), acfg=AnalogConfig(),
                               top_k=2, act="gelu", dispatch="shard_map",
                               routes=_replay(jw, ji))
        gy, gaux = M.moe_apply(params_from_numpy(p, "cpu"),
                               torch.from_numpy(x), acfg=AnalogConfig(),
                               top_k=2, act="gelu", dispatch="gspmd_ep",
                               routes=_replay(jw, ji))
        assert torch.equal(sy, gy) and torch.equal(saux, gaux)


class TestExpertProducts:
    @pytest.mark.parametrize("mode", MODES)
    def test_per_call_and_pre_lowered_bit_exact(self, mode):
        """The reference's per-call and pre-lowered products, the port's
        per-call and pre-lowered ones: one value, bit for bit; one
        dispatch and one lowering per per-call product."""
        rng = np.random.default_rng(3)
        w = _code_weights(rng, (E, 200, 24))
        xe = (rng.standard_normal((E, 5, 200)) * 0.5).astype(np.float32)
        jacfg, acfg = JAnalogConfig(mode=mode), AnalogConfig(mode=mode)
        want = np.asarray(JM._analog_expert_matmul(jnp.asarray(xe),
                                                   jnp.asarray(w), jacfg))
        jgp = JGroupPlan(kind="expert_stack",
                         fused=jlower_expert_stack(jnp.asarray(w), jacfg),
                         member_names=("up",), member_ns=(24,))
        np.testing.assert_array_equal(
            np.asarray(jrun_expert_stack(jgp, jnp.asarray(xe), jacfg)), want)
        tlower.reset_lowering_count()
        trun.reset_dispatch_count()
        got = M._analog_expert_matmul(torch.from_numpy(xe),
                                      torch.from_numpy(w), acfg)
        assert (tlower.lowering_count(), trun.dispatch_count()) == (1, 1)
        np.testing.assert_array_equal(_np(got), want)
        gp = GroupPlan(kind="expert_stack",
                       fused=tlower.lower_expert_stack(torch.from_numpy(w),
                                                       acfg),
                       member_names=("up",), member_ns=(24,))
        assert gp.fused.store.codes.dtype == torch.int8
        assert tuple(gp.fused.store.codes.shape) == (E, 256, 24)
        np.testing.assert_array_equal(
            _np(trun.run_expert_stack(gp, torch.from_numpy(xe), acfg)), want)
        # leading group dims fold into the capacity axis
        x4 = np.stack([xe, xe[:, ::-1]])
        got4 = M._expert_matmul(torch.from_numpy(x4.copy()),
                                torch.from_numpy(w), acfg, plan=gp)
        want4 = np.asarray(JM._expert_matmul(jnp.asarray(x4),
                                             jnp.asarray(w), jacfg))
        np.testing.assert_array_equal(_np(got4), want4)

    @pytest.mark.parametrize("faithful", [True, False])
    def test_expert_axis_plain_version_is_a_per_expert_loop(self, faithful):
        """The split kernel's expert-axis plain version against a loop of
        the 2-D plain route over the experts (``analog_matmul`` of each
        pass, the reference's expert product)."""
        rng = np.random.default_rng(4)
        e, m, k, n = 5, 7, 384, 40
        a_pos = torch.from_numpy(rng.integers(0, 32, (e, m, k))).float()
        a_neg = torch.from_numpy(rng.integers(0, 32, (e, m, k))).float()
        w = torch.from_numpy(rng.integers(-63, 64, (e, k, n))).float()
        g = torch.from_numpy(rng.uniform(0.005, 0.05, (e,))
                             .astype(np.float32))
        gain = g[:, None].expand(e, n).contiguous()
        cfg = AnalogConfig(mode="analog_faithful" if faithful
                           else "analog_fast")
        want = torch.stack([
            analog_matmul(a_pos[i], w[i], g[i], None, cfg)
            - analog_matmul(a_neg[i], w[i], g[i], None, cfg)
            for i in range(e)])
        post = None if faithful else gain
        got = tref.analog_mvm_split_experts_ref(
            a_pos, a_neg, w, gain if faithful else torch.ones_like(gain),
            post_gain=post, faithful=faithful)
        np.testing.assert_array_equal(_np(got), _np(want))
        # the ops wrapper picks the same semantics from the mode alone
        via_ops = ops.analog_mvm_split(a_pos, a_neg, w, gain, None,
                                       faithful=faithful)
        np.testing.assert_array_equal(_np(via_ops), _np(want))
        # one dispatch through a 2-D call per expert gives the same too
        # in faithful mode (the chunk readouts do not depend on E)
        if faithful:
            loop = torch.stack([ops.analog_mvm_split(
                a_pos[i], a_neg[i], w[i], gain[i], None) for i in range(e)])
            np.testing.assert_array_equal(_np(got), _np(loop))


class TestExpertBlocks:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_blockwise_lowering_bit_identical(self, monkeypatch, dtype):
        """A stack lowered ``EXPERT_BLOCK`` experts at a time (a ragged
        block: E = 7 in blocks of 3) equals the whole stack lowered at
        once, bit for bit: the int8 codes, ``w_scale``, the gains and the
        plan's geometry; and the reference's lowering of the same float
        weights (codes and scales equal, gains within 1e-6); the STE codes of the path
        under autograd hold the same integers."""
        rng = np.random.default_rng(7)
        w = torch.from_numpy((rng.standard_normal((7, 200, 24)) * 0.05)
                             .astype(np.float32)).to(dtype)
        acfg = AnalogConfig()
        monkeypatch.setattr(M, "EXPERT_BLOCK", 64)
        whole = tlower.lower_expert_stack(w, acfg)
        monkeypatch.setattr(M, "EXPERT_BLOCK", 3)
        blocks = tlower.lower_expert_stack(w, acfg)
        for name in ("codes", "w_scale", "gain"):
            a, b = getattr(whole.store, name), getattr(blocks.store, name)
            assert a.dtype == b.dtype and torch.equal(a, b), name
        assert blocks.store.codes.dtype == torch.int8
        assert (blocks.k, blocks.n, tuple(blocks.store.codes.shape)) == \
            (whole.k, whole.n, (7, 256, 24))
        jl = jlower_expert_stack(jnp.asarray(w.float().numpy()),
                                 JAnalogConfig())
        np.testing.assert_array_equal(_np(blocks.store.codes),
                                      np.asarray(jl.store.codes))
        np.testing.assert_array_equal(_np(blocks.store.w_scale),
                                      np.asarray(jl.store.w_scale))
        # the gain's mean of float squares sums in another order
        np.testing.assert_allclose(_np(blocks.store.gain),
                                   np.asarray(jl.store.gain), rtol=1e-6)
        ste = tlower.lower_expert_stack(w.float().requires_grad_(True), acfg)
        assert ste.store.codes.dtype == torch.float32
        np.testing.assert_array_equal(
            _np(ste.store.codes.detach()), _np(blocks.store.codes.float()))

    @pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                      "llama4-maverick-400b-a17b"])
    def test_moe_init_unchanged_at_smoke_size(self, arch):
        """At SMOKE sizes one block is the whole stack: ``moe_init`` draws
        the numbers it drew before the blocks, the whole stack at once in
        fp32 and then cast."""
        cfg = configs.get_smoke(arch)
        assert cfg.n_experts <= M.EXPERT_BLOCK
        got = M.moe_init(torch.Generator().manual_seed(3), cfg.d_model,
                         cfg.moe_d_ff, cfg.n_experts, act=cfg.act,
                         device="cpu", dtype=torch.bfloat16)
        g = torch.Generator().manual_seed(3)
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        router = torch.randn((d, e), generator=g) * d ** -0.5
        want = {"up": (torch.randn((e, d, f), generator=g) * d ** -0.5),
                "down": (torch.randn((e, f, d), generator=g) * f ** -0.5),
                "gate": (torch.randn((e, d, f), generator=g) * d ** -0.5)}
        assert torch.equal(got["router"]["w"], router)
        for name, t in want.items():
            assert got[name].dtype == torch.bfloat16
            assert torch.equal(got[name], t.to(torch.bfloat16)), name


class TestCompiled:
    @pytest.mark.parametrize("mode", MODES)
    def test_moe_module_spec_compiles_once(self, mode):
        p = _layer("swiglu", 1)
        x = _x()
        jrun = JAnalogConfig(mode=mode)
        acfg = AnalogConfig(mode=mode)
        jm = japi.compile(JM.moe_module_spec(D, FF, E, top_k=2, n_shared=1,
                                             noise=JNOISELESS), p, jrun)
        tlower.reset_lowering_count()
        tm = api.compile(M.moe_module_spec(D, FF, E, top_k=2, n_shared=1),
                         params_from_numpy(p, "cpu"), acfg, device="cpu")
        assert tlower.lowering_count() == 3 + 3   # 3 stacks, 3 shared
        gps = tm.lower()["_groups"]
        assert sorted(gps) == ["down", "gate", "up"]
        assert all(gp.kind == "expert_stack" for gp in gps.values())
        tlower.reset_lowering_count()
        ty, aux = tm.apply(torch.from_numpy(x))
        assert tlower.lowering_count() == 0
        raw, raw_aux = M.moe_apply(params_from_numpy(p, "cpu"),
                                   torch.from_numpy(x), acfg=acfg, top_k=2)
        np.testing.assert_array_equal(_np(ty), _np(raw))
        assert float(aux) == float(raw_aux)
        jy, _ = jm.apply(jnp.asarray(x))
        want = np.asarray(jy)
        np.testing.assert_allclose(_np(ty), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())

    def test_module_spec_validation(self):
        with pytest.raises(ValueError, match="one expert_stack group"):
            api.ModuleSpec(
                name="bad", kind="tree",
                layers=(api.LayerSpec("up", 4, 8, stacked=2),
                        api.LayerSpec("gate", 4, 8, stacked=2)),
                groups=(api.GroupSpec("g", "expert_stack", ("up", "gate")),))
        with pytest.raises(ValueError, match="stacked"):
            api.ModuleSpec(
                name="bad", kind="tree",
                layers=(api.LayerSpec("up", 4, 8),),
                groups=(api.GroupSpec("up", "expert_stack", ("up",)),))


class TestScanStackedTree:
    def test_lm_tree_lowers_each_member_once_and_round_trips(self,
                                                             tmp_path):
        """A scan-stacked MoE LM tree lowers every member's stacks into a
        PlanStack of expert_stack plans at compile time (the reference
        re-derives them per call): the same logits bit for bit as the
        raw per-call tree, no lowering per call, and the plan store keeps
        it live."""
        cfg = configs.get_smoke("qwen3-moe-30b-a3b")
        run = RunConfig(analog=AnalogConfig(mode="analog_faithful"),
                        activation_dtype="float32")
        params = T.lm_init(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
        tokens = {"tokens": torch.randint(
            0, cfg.vocab_size, (2, 5), generator=torch.Generator()
            .manual_seed(1))}
        raw, _, raw_aux = T.lm_apply(params, tokens, cfg, run)
        model = api.compile(T.lm_module_spec(cfg, params), params, run,
                            device="cpu")
        gp = model.lower()["layers"]["l0"]["moe"]["_groups"]["up"]
        assert isinstance(gp, PlanStack) and len(gp) == cfg.n_layers
        assert tuple(gp[0].fused.store.codes.shape) == (8, 128, 32)
        tlower.reset_lowering_count()
        trun.reset_dispatch_count()
        got, _, aux = model.apply(tokens)
        assert tlower.lowering_count() == 0
        # per layer: fused QKV, o, three expert stacks; then the lm_head
        assert trun.dispatch_count() == 5 * cfg.n_layers + 1
        np.testing.assert_array_equal(_np(got), _np(raw))
        assert float(aux) == float(raw_aux)
        path = str(tmp_path / "moe_lm.npz")
        store.save_plan(path, model.lower())
        loaded = store.load_plan(path, device="cpu")
        assert tlower.lowering_count() == 0
        again, _, _ = T.lm_apply(loaded, tokens, cfg, run)
        np.testing.assert_array_equal(_np(again), _np(raw))

    def test_recorded_routing_replays(self):
        cfg = configs.get_smoke("llama4-maverick-400b-a17b")
        run = RunConfig(analog=AnalogConfig(mode="analog_faithful"),
                        activation_dtype="float32")
        params = T.lm_init(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
        tokens = {"tokens": torch.randint(0, cfg.vocab_size, (2, 4))}
        rec = M.Routes()
        want, _, _ = T.lm_apply(params, tokens, cfg, run, routes=rec)
        assert len(rec.taken) == T.n_groups(cfg)   # one MoE layer a group
        got, _, _ = T.lm_apply(params, tokens, cfg, run,
                               routes=M.Routes(replay=rec.taken))
        np.testing.assert_array_equal(_np(got), _np(want))
