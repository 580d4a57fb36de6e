"""The port's mesh (``repro_torch.distributed.sharding``'s mesh half,
``launch.mesh``, the mesh branches of flash attention, the MoE dispatch,
the train step and the serve engine) against the JAX package, the twin of
``tests/test_distributed.py`` and ``test_api.py::TestMeshShardedPlans``.

Three processes carry the multi-device cases, each started once for the
module (the ``world`` fixture):

- one JAX subprocess with ``--xla_force_host_platform_device_count=4``
  writes the reference's spec resolutions over a table of names, shapes
  and meshes, and its context-parallel flash attention on a (2, 2) mesh;
- four gloo ranks (``test_torch_mesh_workers.py``) run the port's CP
  flash and the expert-parallel MoE dispatch on a (2, 2) ``(data,
  model)`` mesh, one glm4-9b SMOKE train step on a 4-rank ``("data",)``
  host mesh, and the SMOKE LM served under (2, 2);
- this process holds the references that need no mesh (the reference's
  ``gspmd_ep`` MoE output and its no-mesh train step), and resolves the
  port's specs on a fake group of 4 ranks.

Tolerances: specs equal; CP flash within the reference test's 3e-5 of
the reference's output (it is 0), its gradients within 1e-5 of the
port's ``flash_attention``'s (dk / dv sum the ranks' blocks in another
order); the expert-parallel dispatch bit-exact against the port's
``gspmd_ep`` path and within 1e-6 x max of the reference's, its aux loss
equal, the tokens' gradient within 1e-6 x max; the 4-rank train step's
loss, grad norm and parameters after AdamW within 1e-6 of their max of
the reference's no-mesh step (fp32 activations; the batch split sums
the gradients in another order); served tokens equal to no mesh, the
logits within 1e-6 x max|logit|.  On a 1-rank mesh everything is
bit-identical to no mesh.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import RunConfig as JRunConfig  # noqa: E402
from repro.core.analog import AnalogConfig as JAnalogConfig  # noqa: E402
from repro.core.noise import NOISELESS as JNOISELESS  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402

from repro_torch import api, configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.core.noise import NOISELESS  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.exec.lower import lowering_count  # noqa: E402
from repro_torch.launch import mesh as MM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

from test_torch_mesh_workers import spawn  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TRAIN_MODES = ("digital", "analog_faithful")
# (logical names, shape, mesh shape, mesh axes, fsdp)
SPEC_CASES = [
    (("batch", "kv_seq", "kv_heads", None), (4, 8, 3, 16), (2, 2),
     ("data", "model"), True),
    (("batch", "kv_seq", "kv_heads", None), (4, 8, 4, 16), (2, 2),
     ("data", "model"), True),
    (("batch", "seq", "mlp"), (16, 8), (2, 2), ("data", "model"), True),
    (("batch", None), (8, 4), (2, 2, 1), ("pod", "data", "model"), True),
    (("embed", "mlp"), (64, 256), (2, 2), ("data", "model"), True),
    (("embed", "mlp"), (64, 256), (2, 2), ("data", "model"), False),
    (("layers", "embed", "heads"), (2, 64, 96), (2, 2), ("data", "model"),
     True),
    (("expert", "embed", None), (4, 32, 16), (2, 2), ("data", "model"),
     True),
    (("vocab", "embed"), (1000, 64), (4,), ("data",), True),
    (("batch", "seq_sp", None), (4, 6, 8), (2, 2), ("data", "model"), True),
    (("batch",), (3,), (2, 2), ("data", "model"), True),
    (("stage", None, None), (2, 8, 8), (2, 2), ("pod", "data"), True),
]

_JAX_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro.configs.base import RunConfig
from repro.distributed import sharding as shd
from repro.models.flash import flash_attention_cp

def norm(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

cases = json.load(open(sys.argv[1]))
specs = []
for names, shape, mshape, axes, fsdp in cases:
    names = tuple(names)
    with shd.use_mesh(jax.make_mesh(tuple(mshape), tuple(axes)),
                      rules=shd.rules_for(RunConfig(fsdp=fsdp))):
        specs.append([norm(shd.resolve_spec(names, tuple(shape))),
                      norm(shd.logical_to_spec(names)),
                      norm(shd.logical_to_spec_multi(names))])
d = np.load(sys.argv[2])
with shd.use_mesh(jax.make_mesh((2, 2), ("data", "model"))):
    o = flash_attention_cp(d["q"], d["k"], d["v"], block_q=16, block_kv=16)
np.save(sys.argv[3], np.asarray(o))
json.dump(specs, open(sys.argv[4], "w"))
"""


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return np.asarray(tree.detach()) if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def _glm_params():
    """glm4-9b SMOKE drawn in the port (NOISELESS fixed pattern), as
    numpy, for both packages."""
    saved = T.NOISE
    T.NOISE = NOISELESS
    try:
        p = T.lm_init(torch.Generator().manual_seed(0),
                      configs.get_smoke("glm4-9b"), device="cpu")
    finally:
        T.NOISE = saved
    return _tree_np(p)


def _ref_train_step(p_np, batch, mode):
    jcfg = jconfigs.get_smoke("glm4-9b")
    acfg = (JAnalogConfig(mode=mode, noise=JNOISELESS) if mode != "digital"
            else JRunConfig().analog)
    jrun = JRunConfig(analog=acfg, activation_dtype="float32")
    # copies: the jitted step donates its state, which must not reach
    # the numpy draw the ranks start from
    params = jax.tree.map(lambda a: jnp.array(np.array(a)), p_np)
    opt_cfg = JTS.make_opt_config(jrun)
    state = {"params": params, "opt": JO.adamw_init(params, opt_cfg)}
    step = JTS.make_train_step(jcfg, jrun, opt_cfg)
    new, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                  jax.random.PRNGKey(0))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": jax.tree.map(np.asarray, new["params"])}


def _moe_inputs():
    """The reference's MoE draw (D 32, FF 16, 4 experts) and tokens, its
    routing, and its gspmd_ep outputs per mode."""
    jp = JM.moe_init(jax.random.PRNGKey(0), 32, 16, 4, noise=JNOISELESS)
    p = jax.tree.map(np.array, jp)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 8, 32)).astype(np.float32)
    logits = jnp.asarray(x) @ jnp.asarray(p["router"]["w"])
    probs = jax.nn.softmax(logits, axis=-1)
    topw, topi = jax.lax.top_k(probs, 2)
    topw = topw / jnp.maximum(topw.sum(-1, keepdims=True), 1e-9)
    want = {}
    for mode in ("digital", "analog_faithful"):
        acfg = JAnalogConfig(mode=mode) if mode != "digital" \
            else JRunConfig().analog
        y, aux = JM.moe_apply(jp, jnp.asarray(x), acfg=acfg, top_k=2,
                              dispatch="gspmd_ep")
        want[mode] = (np.asarray(y), float(aux))
    return ({"params": p, "x": x, "topw": np.array(topw),
             "topi": np.array(topi)}, want)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every multi-device result of the module: the JAX subprocess and
    the gloo ranks run once, side by side."""
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    cp = {"q": rng.standard_normal((2, 64, 2, 3, 16)).astype(np.float32),
          "k": rng.standard_normal((2, 64, 2, 16)).astype(np.float32),
          "v": rng.standard_normal((2, 64, 2, 16)).astype(np.float32)}
    np.savez(d / "cp.npz", **cp)
    (d / "cases.json").write_text(json.dumps(SPEC_CASES))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(d / "cases.json"),
         str(d / "cp.npz"), str(d / "cp_out.npy"), str(d / "specs.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        moe, moe_want = _moe_inputs()
        p_np = _glm_params()
        cfg = configs.get_smoke("glm4-9b")
        tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 16))
        batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
        train_want = {m: _ref_train_step(p_np, batch, m)
                      for m in TRAIN_MODES}
        scfg = configs.get_smoke("phi4-mini-3.8b")
        serve = {"arch": "phi4-mini-3.8b",
                 "params": _tree_np(T.lm_init(
                     torch.Generator().manual_seed(0), scfg, device="cpu")),
                 "prompts": [np.arange(3 + 2 * i) % scfg.vocab_size
                             for i in range(4)],
                 "tokens": rng.integers(0, scfg.vocab_size, (4, 6))}
        inputs = {"cp": cp, "moe": moe,
                  "train": {"params": p_np, "batch": batch,
                            "modes": TRAIN_MODES},
                  "serve": serve}
        ranks = spawn(("cp_flash", "moe_ep", "train_step", "serve_2x2"),
                      inputs, str(d / "ranks"))
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out.decode()[-3000:]
    return {"ranks": ranks, "moe_want": moe_want, "train_want": train_want,
            "cp_ref": np.load(d / "cp_out.npy"),
            "specs": json.loads((d / "specs.json").read_text())}


@pytest.fixture()
def fake4():
    """A fake group of 4 ranks (this process is rank 0) to build meshes
    whose specs are resolved here; ended after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0,
                                         world_size=4)
    try:
        yield
    finally:
        MM.destroy()


@pytest.fixture()
def mesh11():
    """A (1, 1) (data, model) mesh over a gloo group of one."""
    MM.init_single("cpu")
    try:
        with shd.use_mesh(MM.make_mesh((1, 1), ("data", "model"))) as m:
            yield m
    finally:
        MM.destroy()


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


# ------------------------------------------------------- spec resolution
class TestSpecResolution:
    def test_no_mesh_is_noop(self):
        assert shd.resolve_spec(("batch", "mlp"), (4, 8)) == shd.P()
        assert shd.sharding_like({"w": ("embed", "mlp")},
                                 {"w": torch.ones(4, 8)}) is None
        x = torch.ones((4, 4))
        assert shd.constrain(x, "batch", None) is x

    @pytest.mark.parametrize("i", range(len(SPEC_CASES)))
    def test_specs_match_the_reference(self, world, fake4, i):
        names, shape, mshape, axes, fsdp = SPEC_CASES[i]
        want = world["specs"][i]
        with shd.use_mesh(MM.make_mesh(mshape, axes),
                          rules=shd.rules_for(RunConfig(fsdp=fsdp))):
            got = [_spec_json(shd.resolve_spec(names, shape)),
                   _spec_json(shd.logical_to_spec(names)),
                   _spec_json(shd.logical_to_spec_multi(names))]
        assert got == want

    def test_rules_for_run_overrides(self):
        rules = shd.rules_for(RunConfig(fsdp=False, seq_sp=False))
        assert rules["embed"] == () and rules["seq_sp"] == ()
        assert shd.rules_for(RunConfig())["embed"] == ("data",)
        assert shd.rules_for(RunConfig()) == jshd.rules_for(JRunConfig())

    def test_production_mesh_blocks(self, fake4):
        """shard_tree on a (2, 2) mesh: each rank's block of a leaf split
        over both axes, by the reference's layout."""
        with shd.use_mesh(MM.make_mesh((2, 2), ("data", "model"))):
            w = torch.arange(64.).reshape(8, 8)
            ns = shd.sharding_like(("embed", "mlp"), w)
            assert ns.spec == shd.P("data", "model")
            blk = shd.shard_tree(w, ns)
            assert torch.equal(blk, w[:4, :4])          # rank 0's block


class TestSpecTrees:
    @pytest.mark.parametrize("name", ["glm4-9b", "rwkv6-7b", "zamba2-2.7b",
                                      "qwen3-moe-30b-a3b"])
    def test_state_batch_and_cache_specs_are_the_reference(self, name):
        cfg, jcfg = configs.get_smoke(name), jconfigs.get_smoke(name)
        run = RunConfig(grad_compression=True)
        jrun = JRunConfig(grad_compression=True)
        assert TS.state_specs(cfg, run) == JTS.state_specs(jcfg, jrun)
        assert TS.batch_specs(cfg) == JTS.batch_specs(jcfg)
        assert O.opt_state_specs(T.lm_specs(cfg)) == \
            JO.opt_state_specs(JT.lm_specs(jcfg))
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                         (torch.int8, jnp.int8)):
            assert T.lm_cache_specs(cfg, tdt) == JT.lm_cache_specs(jcfg, jdt)

    def test_cache_sharding_covers_the_port_cache(self, mesh11):
        from repro_torch.serve.serve_step import cache_sharding

        cfg = configs.get_smoke("glm4-9b")
        cache = T.init_lm_cache(cfg, 2, 16, device="cpu")
        sh = shd.sharding_like(T.lm_cache_specs(cfg), cache)
        assert shd.shard_tree(cache, sh) is cache   # 1-rank: no copy
        assert cache_sharding(cfg)["layers"]["l0"]["attn"]["k"].spec == \
            shd.P(None, "data", "model", None, None)


class TestMeshInvariance:
    def test_fpn_independent_of_mesh(self, mesh11):
        """The fixed pattern is drawn for the logical shape from the
        generator, whatever mesh is active."""
        from repro_torch.core.analog import analog_linear_init

        with shd.use_mesh(None):
            p1 = analog_linear_init(torch.Generator().manual_seed(3), 256,
                                    64, device="cpu")
        p2 = analog_linear_init(torch.Generator().manual_seed(3), 256, 64,
                                device="cpu")
        for path, a, b in _pairs(p1, p2):
            assert torch.equal(a, b), path


# ------------------------------------------------- the 2 x 2 and 4-rank runs
class TestMeshRuns:
    def test_ranks_agree(self, world):
        """Every rank ends with the same values (the outputs are the
        whole batch's on each)."""
        r0 = world["ranks"][0]
        for r in world["ranks"][1:]:
            np.testing.assert_array_equal(r["cp_flash"]["o_cp"],
                                          r0["cp_flash"]["o_cp"])
            for mode in TRAIN_MODES:
                assert r["train_step"][mode]["loss"] == \
                    r0["train_step"][mode]["loss"]
            assert r["serve_2x2"]["mesh"]["tokens"] == \
                r0["serve_2x2"]["mesh"]["tokens"]

    def test_cp_flash_matches_the_reference(self, world):
        got = world["ranks"][0]["cp_flash"]
        np.testing.assert_allclose(got["o_cp"], world["cp_ref"], rtol=0,
                                   atol=3e-5)
        np.testing.assert_allclose(got["o_cp"], got["o_plain"], rtol=0,
                                   atol=3e-5)

    def test_cp_flash_gradients(self, world):
        got = world["ranks"][0]["cp_flash"]
        for a, b in zip(got["g_cp"], got["g_plain"]):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-5 * np.abs(b).max())

    @pytest.mark.parametrize("mode", ["digital", "analog_faithful"])
    def test_moe_shard_map_matches_gspmd(self, world, mode):
        got = world["ranks"][0]["moe_ep"][mode]
        ep, gs = got["shard_map"], got["gspmd_ep"]
        np.testing.assert_array_equal(ep["y"], gs["y"])
        assert ep["aux"] == gs["aux"]
        want_y, want_aux = world["moe_want"][mode]
        np.testing.assert_allclose(ep["y"], want_y, rtol=0,
                                   atol=1e-6 * np.abs(want_y).max())
        np.testing.assert_allclose(ep["aux"], want_aux, rtol=1e-6)

    def test_moe_shard_map_gradients(self, world):
        got = world["ranks"][0]["moe_ep"]["digital"]
        want = got["gspmd_ep"]["dx"]
        np.testing.assert_allclose(got["shard_map"]["dx"], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())

    @pytest.mark.parametrize("mode", TRAIN_MODES)
    def test_train_step_on_host_mesh(self, world, mode):
        got = world["ranks"][0]["train_step"][mode]
        want = world["train_want"][mode]
        assert np.isfinite(got["loss"])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-6)
        for path, w, g in _pairs(want["params"], got["params"]):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-6 * max(np.abs(w).max(), 1e-30),
                err_msg=path)

    def test_serve_under_2x2_matches_no_mesh(self, world):
        got = world["ranks"][0]["serve_2x2"]
        assert got["mesh"]["tokens"] == got["plain"]["tokens"]
        want = got["plain"]["logits"]
        np.testing.assert_allclose(got["mesh"]["logits"], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


# ------------------------------------------------ a 1-rank mesh, in process
TINY = "phi4-mini-3.8b"


def _tiny():
    cfg = configs.get_smoke(TINY)
    params = T.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, params, RunConfig(analog=AnalogConfig(mode="analog_fast"))


class TestMeshShardedPlans:
    def test_sharding_specs_cover_plan_leaves(self, mesh11):
        """The spec tree mirrors the lowered tree, so every plan leaf
        resolves to a NamedSharding."""
        cfg, params, run = _tiny()
        model = api.compile(T.lm_module_spec(cfg, params), params, run,
                            device="cpu")
        lowered = model.lower()
        shardings = shd.sharding_like(model.sharding_specs(), lowered)
        seen = []
        shd._map_tree(lambda t, ns: seen.append(ns) or t, lowered, shardings)
        from repro_torch.verify.invariants import leaves_with_path
        n = sum(isinstance(v, torch.Tensor)
                for _, v in leaves_with_path(lowered))
        assert len(seen) == n and all(s.mesh is mesh11 for s in seen)

    def test_sharded_compiled_model_bit_exact(self, mesh11):
        cfg, params, run = _tiny()
        model = api.compile(T.lm_module_spec(cfg, params), params, run,
                            device="cpu")
        tokens = {"tokens": torch.arange(16).reshape(2, 8) % cfg.vocab_size}
        with torch.no_grad():
            want, _, _ = model.apply(tokens)
            sharded = shd.shard_tree(model.lower(), shd.sharding_like(
                model.sharding_specs(), model.lower()))
            got, _, _ = T.lm_apply(sharded, tokens, cfg, run)
        assert torch.equal(want, got)

    def test_serve_engine_prelowers_under_mesh(self, mesh11):
        """Pre-lowered plans replay: nothing is lowered between batches."""
        cfg, params, run = _tiny()
        prompt = np.arange(6) % cfg.vocab_size
        eng = ServeEngine(cfg, run, params, batch_size=2, max_len=32,
                          device="cpu")
        assert "_groups" in eng.params["layers"]["l0"]["attn"]
        r1 = eng.serve([Request(0, prompt, 4)])[0]
        n1 = lowering_count()
        r2 = eng.serve([Request(1, prompt, 4)])[0]
        assert lowering_count() == n1
        np.testing.assert_array_equal(r1.output, r2.output)

    def test_serve_engine_mesh_matches_no_mesh(self, mesh11):
        cfg, params, run = _tiny()
        prompt = np.arange(6) % cfg.vocab_size
        with shd.use_mesh(None):
            r_plain = ServeEngine(cfg, run, params, batch_size=2, max_len=32,
                                  device="cpu").serve([Request(0, prompt,
                                                               4)])[0]
        r_mesh = ServeEngine(cfg, run, params, batch_size=2, max_len=32,
                             device="cpu").serve([Request(0, prompt, 4)])[0]
        np.testing.assert_array_equal(r_plain.output, r_mesh.output)

    def test_serve_engine_forced_walk_matches_no_mesh(self, mesh11):
        """On a 1-rank mesh ``shard_tree`` / ``gather_tree`` return the
        tree unwalked; force the walk they skip (every leaf a new view, so
        every plan dataclass is copied, then rebuilt through ``__init__``)
        on each step call: an analog_faithful engine's tokens and prefill
        logits equal the no-mesh engine's bit for bit (the card's phase 48
        at full width)."""
        cfg, params, _ = _tiny()
        run = RunConfig(analog=AnalogConfig(mode="analog_faithful"))
        prompts = [np.arange(6) % cfg.vocab_size,
                   (np.arange(9) * 5 + 1) % cfg.vocab_size]
        toks = {"tokens": torch.arange(24).reshape(2, 12) % cfg.vocab_size}

        def serve(eng):
            out = [r.output for r in eng.serve(
                [Request(i, p, 4) for i, p in enumerate(prompts)])]
            cache = T.init_lm_cache(cfg, 2, 32, dtype=torch.float32,
                                    device="cpu")
            return out, eng.prefill(eng.params, toks, cache)[0]

        with shd.use_mesh(None):
            want_out, want_logits = serve(ServeEngine(
                cfg, run, params, batch_size=2, max_len=32, device="cpu"))
        eng = ServeEngine(cfg, run, params, batch_size=2, max_len=32,
                          device="cpu")
        rebuilt = []

        def walked(step):
            def call(tree, batch, cache):
                def view(t, ns):
                    return t.view(t.shape)
                local = shd._map_tree(view, tree, eng.param_shardings)
                full = shd._map_tree(view, local, eng.param_shardings)
                rebuilt.append(full["lm_head"]["_plan"]
                               is not tree["lm_head"]["_plan"])
                return step(full, batch, cache)
            return call

        eng.prefill, eng.decode = walked(eng.prefill), walked(eng.decode)
        got_out, got_logits = serve(eng)
        assert rebuilt and all(rebuilt)
        for a, b in zip(want_out, got_out):
            np.testing.assert_array_equal(a, b)
        assert torch.equal(want_logits, got_logits)

    def test_stack_sharding_specs_cover_mega_leaves(self, mesh11):
        """A compiled code-domain ECG model's specs cover its megakernel
        packing (replicated), and its sharded plan replays bit for bit."""
        from repro_torch.exec.run import run as run_plan
        from repro_torch.models import ecg as ECG

        cfg = ECG.ECGConfig()
        params = ECG.ecg_init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
        model = api.compile(ECG.ecg_module_spec(cfg, epilogue="relu_shift"),
                            params, AnalogConfig(), device="cpu")
        plan = model.lower()
        assert plan.mega is not None
        sharded = shd.shard_tree(plan, shd.sharding_like(
            model.sharding_specs(), plan))
        x = torch.round(torch.rand((4, 2, 126), generator=torch.Generator()
                                   .manual_seed(1)) * 31)
        cols = ECG._im2col(x, 64, 2)
        assert torch.equal(run_plan(sharded, cols), run_plan(plan, cols))

    def test_cp_flash_one_rank_bit_identical(self, mesh11):
        """On a 1-way model axis CP flash is ``flash_attention``: the
        output and every gradient bit for bit."""
        from repro_torch.models.flash import (flash_attention,
                                              flash_attention_cp)

        g = torch.Generator().manual_seed(4)
        qkv = [torch.randn(s, generator=g) for s in
               ((2, 48, 2, 3, 16), (2, 48, 2, 16), (2, 48, 2, 16))]
        outs = []
        for fn in (flash_attention_cp, flash_attention):
            leaves = [t.clone().requires_grad_(True) for t in qkv]
            o = fn(*leaves, block_q=16, block_kv=32)
            o.square().sum().backward()
            outs.append([o.detach()] + [t.grad for t in leaves])
        for a, b in zip(*outs):
            assert torch.equal(a, b)

    def test_moe_expert_parallel_one_rank_bit_identical(self, mesh11):
        """The expert-parallel dispatch on a 1-way model axis, through a
        compiled layer's pre-lowered expert stacks: ``gspmd_ep``'s values
        bit for bit (the card's phase 49 at full width)."""
        from repro_torch.models import moe as M

        acfg = AnalogConfig(mode="analog_faithful")
        params = M.moe_init(torch.Generator().manual_seed(0), 32, 16, 4,
                            device="cpu")
        tree = api.compile(M.moe_module_spec(32, 16, 4, top_k=2), params,
                           acfg, device="cpu").lower()
        x = torch.randn((4, 1, 32), generator=torch.Generator()
                        .manual_seed(1))
        with torch.no_grad():
            y_sm, aux_sm = M.moe_apply(tree, x, acfg=acfg, top_k=2,
                                       dispatch="shard_map")
            with shd.use_mesh(None):
                y_gs, aux_gs = M.moe_apply(tree, x, acfg=acfg, top_k=2,
                                           dispatch="gspmd_ep")
        assert torch.equal(y_sm, y_gs) and torch.equal(aux_sm, aux_gs)

    def test_train_step_one_rank_bit_identical(self, mesh11):
        cfg = configs.get_smoke("glm4-9b")
        run = RunConfig(activation_dtype="float32")
        tok = torch.arange(64).reshape(4, 16) % cfg.vocab_size
        batch = {"tokens": tok, "labels": (tok * 7 + 3) % cfg.vocab_size}

        def state():
            return TS.init_state(torch.Generator().manual_seed(0), cfg, run,
                                 device="cpu")

        with shd.use_mesh(None):
            want, wm = TS.make_train_step(cfg, run)(state(), batch)
        step = TS.make_train_step(cfg, run)
        got, gm = step(shd.shard_tree(state(), step.state_shardings),
                       shd.shard_tree(batch, step.batch_shardings))
        for k in ("loss", "grad_norm", "nll", "aux"):
            assert torch.equal(wm[k], gm[k]), k
        for path, a, b in _pairs(want, got):
            assert torch.equal(a, b), path
