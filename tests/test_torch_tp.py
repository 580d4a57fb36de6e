"""Tensor parallelism over the mesh's ``model`` axis
(``repro_torch.distributed.tensor_parallel``, the block and per-layer
gather machinery of ``repro_torch.distributed.sharding``) against no mesh
and against the JAX package's mesh-free train step.

Four gloo ranks are spawned once for the module (the ``world`` fixture,
``tests/test_torch_tp_workers.py`` holds their cases):

- stablelm-3b SMOKE (4 heads, 4 KV heads) on a (1, 4) ``(data, model)``
  mesh and phi4-mini SMOKE (6 heads, 2 KV heads) on (2, 2), served at
  ``analog_faithful``: tokens and prefill logits bit-identical to the
  no-mesh engine (each rank's heads and MLP columns launch the split
  kernel's plain version on their column blocks; ``wo`` / ``down`` and
  their inputs are gathered whole);
- glm4-9b SMOKE (2 KV heads) on (1, 4): the cache splits over
  ``kv_seq`` and decoding runs split-KV (flash-decoding's max and sum
  all-reduced), within 1e-6 x max|logit| with equal greedy tokens;
- phi4-mini SMOKE in digital mode on (2, 2): ``wo`` / ``down``
  row-parallel (a sum all-reduce), within 1e-6 x max|logit|;
- rwkv6-7b SMOKE on (1, 4), qwen3-moe SMOKE and zamba2 SMOKE on (2, 2):
  the RWKV and Mamba layers and the MoE router gathered whole per layer,
  the expert stacks' blocks kept for the expert-parallel dispatch,
  Zamba2's shared attention on its heads: bit-identical;
- one glm4-9b SMOKE train step on (2, 2) per mode: within the
  tolerances of ``test_torch_family_train.check_step`` of the no-mesh
  step and of the reference's mesh-free step; one qwen3-moe SMOKE step
  (the expert-parallel dispatch on the stored expert blocks) within them
  of the no-mesh step.

Every case also checks each rank's resident parameter, plan and cache
bytes (at most a quarter of the whole plus the leaves no axis splits),
that no single all-gather exceeds the largest leaf, and the whole tree
freed.  Single-process tests below cut blocks by hand (``axis_index``
patched per rank on a fake group of 4): every plan kind's block is a
valid store that launches to its block of the whole output.
"""
import concurrent.futures

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch import api, configs  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.analog import AnalogConfig  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.exec.plan import (GROUP_BATCH_CONCAT,  # noqa: E402
                                   GROUP_COLUMN_CONCAT, GROUP_EXPERT_STACK,
                                   GroupPlan, LayerPlan, PlanStack)
from repro_torch.exec.run import run_group, run_layer  # noqa: E402
from repro_torch.launch import mesh as MM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

from repro_torch.core.noise import NOISELESS  # noqa: E402

from test_torch_distributed import (_pairs, _ref_train_step,  # noqa: E402
                                    _tree_np)
from test_torch_family_train import GRAD_REL  # noqa: E402
from test_torch_mesh_workers import spawn  # noqa: E402
from test_torch_tp_workers import plain_serve  # noqa: E402

TRAIN_MODES = ("digital", "analog_faithful")
SERVE = {  # name -> (arch, mesh, mode, bit-identical)
    "stablelm_1x4": ("stablelm-3b", (1, 4), "analog_faithful", True),
    "phi4_2x2": ("phi4-mini-3.8b", (2, 2), "analog_faithful", True),
    "glm4_kv_seq_1x4": ("glm4-9b", (1, 4), "analog_faithful", False),
    "phi4_digital_2x2": ("phi4-mini-3.8b", (2, 2), "digital", False),
    # gathered whole per layer: the RWKV layer, the MoE router with the
    # expert stacks' blocks kept for the expert-parallel dispatch, the
    # Mamba layers with Zamba2's shared attention block on its heads
    "rwkv_1x4": ("rwkv6-7b", (1, 4), "analog_faithful", True),
    "qwen3_moe_2x2": ("qwen3-moe-30b-a3b", (2, 2), "analog_faithful", True),
    "zamba2_2x2": ("zamba2-2.7b", (2, 2), "analog_faithful", True),
    # at fp32 activations, as every comparison with the reference is (at
    # bf16 its compiled scan rounds elsewhere: ROADMAP, differences)
    "glm4_kv_seq_fp32_1x4": ("glm4-9b", (1, 4), "analog_faithful", False),
}


TRAIN = ("glm4-9b", "qwen3-moe-30b-a3b")
# the serve cases whose arithmetic departs from the port's no-mesh order
# (split-KV decoding, row-parallel sums), held against the reference too
REF_SERVE = ("glm4_kv_seq_fp32_1x4", "phi4_digital_2x2")
REF_REL = 1e-5          # tests/test_torch_glm_minitron.py's REL


def _noiseless_params(arch):
    """A SMOKE config's parameters drawn in the port on the NOISELESS
    fixed pattern, as numpy."""
    saved = T.NOISE
    T.NOISE = NOISELESS
    try:
        return _tree_np(T.lm_init(torch.Generator().manual_seed(0),
                                  configs.get_smoke(arch), device="cpu"))
    finally:
        T.NOISE = saved


def _serve_case(name, seed):
    arch, mesh, mode, _ = SERVE[name]
    cfg = configs.get_smoke(arch)
    rng = np.random.default_rng(seed)
    return {"arch": arch, "mesh": mesh, "mode": mode,
            "fp32": "fp32" in name,
            "params": _tree_np(T.lm_init(torch.Generator().manual_seed(seed),
                                         cfg, device="cpu")),
            "prompts": [rng.integers(0, cfg.vocab_size, 3 + 2 * i)
                        for i in range(4)],
            "tokens": rng.integers(0, cfg.vocab_size, (4, 6))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    train = {}
    for arch in TRAIN:
        cfg = configs.get_smoke(arch)
        tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 16))
        train[arch] = {"arch": arch, "params": _noiseless_params(arch),
                       "batch": {"tokens": tok,
                                 "labels": np.roll(tok, -1, axis=1)},
                       "modes": TRAIN_MODES}
    serve = {name: _serve_case(name, i) for i, name in enumerate(SERVE)}
    # the ranks run beside this process's references, which keep to a
    # few threads meanwhile
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(spawn, ("serve", "train"),
                                {"serve": serve, "train": train},
                                str(d / "ranks"),
                                module="test_torch_tp_workers")
            plain = {name: plain_serve(case)
                     for name, case in serve.items()}
            ref = {name: _ref_serve(serve[name]) for name in REF_SERVE}
            want = {(arch, mode): {"plain": _plain_train_step(c, mode)}
                    for arch, c in train.items() for mode in TRAIN_MODES}
            for mode in TRAIN_MODES:
                c = train["glm4-9b"]
                want["glm4-9b", mode]["ref"] = _ref_train_step(
                    c["params"], c["batch"], mode)
            ranks = ranks.result()
    finally:
        torch.set_num_threads(threads)
    return {"ranks": ranks, "train_want": want, "train": train,
            "plain": plain, "ref": ref}


def _ref_serve(case):
    """The reference's mesh-free ``ServeEngine`` on the same draw, prompts
    and run config: greedy tokens and one prefill's logits.  (Its own
    mesh serve does not run on this JAX: the reference's
    ``tests/test_api.py::TestMeshShardedPlans`` fails at the embedding's
    sharded gather.)"""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.configs.base import RunConfig as JRunConfig
    from repro.core.analog import AnalogConfig as JAnalogConfig
    from repro.models import transformer as JT
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine

    jcfg = jconfigs.get_smoke(case["arch"])
    jrun = JRunConfig(activation_dtype="float32") \
        if case["mode"] == "digital" else \
        JRunConfig(analog=JAnalogConfig(mode=case["mode"]),
                   activation_dtype="float32" if case["fp32"]
                   else "bfloat16")
    jp = jax.tree.map(lambda a: jnp.array(np.array(a)), case["params"])
    eng = JServeEngine(jcfg, jrun, jp, batch_size=4, max_len=32)
    done = eng.serve([JRequest(uid=i, prompt=p, max_new_tokens=4)
                      for i, p in enumerate(case["prompts"])])
    cache = JT.init_lm_cache(jcfg, case["tokens"].shape[0], 32,
                             dtype=jnp.float32)
    logits, _ = eng.prefill(eng.params,
                            {"tokens": jnp.asarray(case["tokens"])}, cache)
    return {"tokens": [r.output.tolist() for r in done],
            "logits": np.asarray(logits)}


def _plain_train_step(case, mode):
    """The port's no-mesh step from the same draw."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.train import optimizer as O

    p_np, batch = case["params"], case["batch"]
    cfg = configs.get_smoke(case["arch"])
    acfg = AnalogConfig(mode=mode, noise=NOISELESS) \
        if mode != "digital" else RunConfig().analog
    run = RunConfig(analog=acfg, activation_dtype="float32")
    params = params_from_numpy(p_np, "cpu")
    state = {"params": params,
             "opt": O.adamw_init(params, TS.make_opt_config(run))}
    state, m = TS.make_train_step(cfg, run)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _tree_np(state["params"])}


# ------------------------------------------------------------- the ranks
class TestServe:
    @pytest.mark.parametrize("name", SERVE)
    def test_tokens_and_logits(self, world, name):
        exact = SERVE[name][3]
        plain = world["plain"][name]
        for r in world["ranks"]:
            got = r["serve"][name]
            assert got["mesh"]["tokens"] == plain["tokens"]
            want = plain["logits"]
            if exact:
                np.testing.assert_array_equal(got["mesh"]["logits"], want)
            else:
                np.testing.assert_allclose(got["mesh"]["logits"], want,
                                           rtol=0,
                                           atol=1e-6 * np.abs(want).max())

    @pytest.mark.parametrize("name", REF_SERVE)
    def test_against_the_reference(self, world, name):
        """Split-KV decoding and the row-parallel sums against the
        reference's mesh-free engine on the same draw: equal greedy
        tokens, prefill logits within the port's no-mesh tolerance to
        the reference."""
        want = world["ref"][name]
        for r in world["ranks"]:
            got = r["serve"][name]["mesh"]
            assert got["tokens"] == want["tokens"]
            np.testing.assert_allclose(
                got["logits"], want["logits"], rtol=0,
                atol=REF_REL * np.abs(want["logits"]).max())

    def test_kv_seq_split_where_the_kv_heads_do_not_divide(self, world):
        """glm4's 2 KV heads on a 4-way model axis: the cache is split
        over its sequence; the others split over KV heads."""
        assert world["ranks"][0]["serve"]["glm4_kv_seq_1x4"]["kv_block"]
        assert not world["ranks"][0]["serve"]["stablelm_1x4"]["kv_block"]

    @pytest.mark.parametrize("name", SERVE)
    def test_resident_bytes(self, world, name):
        """Each rank holds at most a quarter of the parameters, plans and
        cache plus the leaves that no axis splits; the whole tree is
        gone."""
        plain = world["plain"][name]
        for r in world["ranks"]:
            got = r["serve"][name]
            b = got["bytes"]
            assert b["params"] <= plain["params_bytes"] / 4 + \
                b["params_replicated"], (b, plain)
            assert b["cache"] <= plain["cache_bytes"] / 4 + \
                b["cache_replicated"], (b, plain)
            assert b["params"] < plain["params_bytes"] / 2
            assert got["whole_tree_dropped"]

    @pytest.mark.parametrize("name", SERVE)
    def test_no_all_gather_exceeds_the_largest_leaf(self, world, name):
        log = world["ranks"][0]["serve"][name]["collectives"]
        assert log["counts"].get("all-gather", 0) > 0
        assert log["largest"]["all-gather"] <= \
            world["plain"][name]["largest_leaf"]

    @pytest.mark.parametrize("name", ["stablelm_1x4", "phi4_2x2"])
    def test_k_split_leaf_and_qkv_group_gathered_bit_identical(self, world,
                                                               name):
        for r in world["ranks"]:
            g = r["serve"][name]["gathered"]
            assert g["wo_split"] and g["wo"] and g["qkv"] and g["no_w_eff"]


class TestTrainStep:
    @pytest.mark.parametrize("mode", TRAIN_MODES)
    @pytest.mark.parametrize("arch, against", [
        ("glm4-9b", "plain"), ("glm4-9b", "ref"),
        ("qwen3-moe-30b-a3b", "plain")])
    def test_step_matches(self, world, arch, mode, against):
        got = world["ranks"][0]["train"][arch][mode]
        want = world["train_want"][arch, mode][against]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=GRAD_REL)
        for path, w, g in _pairs(want["params"], got["params"]):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-6 * max(np.abs(w).max(), 1e-30),
                err_msg=path)

    @pytest.mark.parametrize("arch", TRAIN)
    def test_ranks_agree_and_gathers_stay_per_leaf(self, world, arch):
        p_np = world["train"][arch]["params"]
        largest = max(a.nbytes for _, a, _ in _pairs(p_np, p_np))
        r0 = world["ranks"][0]["train"][arch]
        for r in world["ranks"]:
            for mode in TRAIN_MODES:
                got = r["train"][arch][mode]
                assert got["loss"] == r0[mode]["loss"]
                assert 0 < got["largest_gather"] <= largest


# ----------------------------------------------- blocks, in one process
@pytest.fixture()
def fake14():
    """A (1, 4) (data, model) mesh over a fake group of 4 (this process
    is rank 0); ``axis_index`` is patched to walk the ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0,
                                         world_size=4)
    try:
        with shd.use_mesh(MM.make_mesh((1, 4), ("data", "model"))) as m:
            yield m
    finally:
        MM.destroy()


def _blocks(monkeypatch, tree, shardings):
    """Every rank's block of ``tree``."""
    out = []
    for r in range(4):
        monkeypatch.setattr(shd, "axis_index",
                            lambda axis, r=r: r if axis == "model" else 0)
        out.append(shd.shard_tree(tree, shardings))
    return out


def _lowered(arch, mode="analog_faithful"):
    cfg = configs.get_smoke(arch)
    params = T.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    run = RunConfig(analog=AnalogConfig(mode=mode))
    model = api.compile(T.lm_module_spec(cfg, params), params, run,
                        device="cpu")
    return cfg, run, model.lower(), model.sharding_specs()


def _plans(tree, path=""):
    """(path, plan) of every LayerPlan and GroupPlan of a tree (a
    PlanStack's member 0)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _plans(v, f"{path}/{k}")
    elif isinstance(tree, PlanStack):
        yield from _plans(tree[0], path)
    elif isinstance(tree, (LayerPlan, GroupPlan)):
        yield path, tree


def _run(plan, x, acfg):
    if isinstance(plan, GroupPlan):
        if plan.kind == GROUP_COLUMN_CONCAT:
            return torch.cat(run_group(plan, x, acfg), dim=-1)
        if plan.kind == GROUP_BATCH_CONCAT:
            return torch.stack(run_group(plan, [x] * len(plan.member_names),
                                         acfg))
        return run_group(plan, x, acfg)
    return run_layer(plan, x, acfg)


def _x(plan, rows=5):
    fused = plan.fused if isinstance(plan, GroupPlan) else plan
    g = torch.Generator().manual_seed(3)
    if isinstance(plan, GroupPlan) and plan.kind == GROUP_EXPERT_STACK:
        return torch.randn((fused.store.codes.shape[0], rows, fused.k),
                           generator=g)
    return torch.randn((rows, fused.k), generator=g)


def _col_split(ns) -> bool:
    return "model" in shd.split_axes(tuple(ns.spec)[-1])


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "rwkv6-7b",
                                  "qwen3-moe-30b-a3b"])
def test_every_plan_kind_block_is_a_valid_store(fake14, monkeypatch, arch):
    """A rank's block of each column-split plan - a solo layer, the fused
    QKV group (member by member), an RWKV batch_concat group, an MoE
    expert stack - is a store of its own: its tables cut by the axes they
    index, ``col_blocks`` / ``member_ns`` / ``n`` its own, no ``w_eff``
    derived, and its launch (the split kernel's plain version here) the
    whole launch's columns of this rank, bit for bit."""
    cfg, run, tree, specs = _lowered(arch)
    sh = shd.sharding_like(specs, tree)
    blocks = _blocks(monkeypatch, tree, sh)
    seen = set()
    for (path, plan), *ranks in zip(_plans(tree), *(_plans(b)
                                                    for b in blocks)):
        fused = plan.fused if isinstance(plan, GroupPlan) else plan
        kind = plan.kind if isinstance(plan, GroupPlan) else "layer"
        ns = ranks[0][1]
        ns_f = ns.fused if isinstance(ns, GroupPlan) else ns
        n = fused.store.codes.shape[-1]
        if ns_f.store.codes.shape[-1] == n:
            continue                                   # not column-split
        seen.add(kind)
        want = _run(plan, _x(plan), run.analog)
        parts = []
        for _, blk in ranks:
            bf = blk.fused if isinstance(blk, GroupPlan) else blk
            assert "_w_eff" not in bf.store.__dict__, path
            assert bf.n == bf.store.codes.shape[-1] == n // 4, path
            for t in (bf.store.w_scale, bf.store.col_gain,
                      bf.store.chunk_gain, bf.chunk_offset):
                assert t is None or t.shape[-1] == n // 4, path
            if bf.store.row_gain is not None:
                assert bf.store.row_gain.shape == fused.store.row_gain.shape
            if kind == GROUP_COLUMN_CONCAT:
                assert bf.store.col_blocks == tuple(
                    w // 4 for w in fused.store.col_blocks)
                assert blk.member_ns == tuple(w // 4 for w in plan.member_ns)
            parts.append(_run(blk, _x(plan), run.analog))
        if kind == GROUP_COLUMN_CONCAT:
            # each block holds q | k | v of its heads: regroup by member
            per = [w // 4 for w in plan.member_ns]
            cols = [p.split(per, dim=-1) for p in parts]
            got = torch.cat([c[j] for j in range(len(per)) for c in cols],
                            dim=-1)
        else:
            got = torch.cat(parts, dim=-1)
        assert torch.equal(got, want), path
    assert seen >= {"layer", {"phi4-mini-3.8b": GROUP_COLUMN_CONCAT,
                              "rwkv6-7b": GROUP_BATCH_CONCAT,
                              "qwen3-moe-30b-a3b": "layer"}[arch]}, seen


def test_k_split_blocks_uncut_bit_identical(fake14, monkeypatch):
    """The blocks of a K-split leaf (``wo``: codes, row gains by ``K``)
    side by side give the whole plan back, each tensor bit for bit; a
    column_concat group's per-member blocks, regrouped, too."""
    _, _, tree, specs = _lowered("stablelm-3b")
    sh = shd.sharding_like(specs, tree)
    blocks = _blocks(monkeypatch, tree, sh)
    whole = T.stack_index(tree["layers"], 0)["l0"]["attn"]
    wsh = shd.stack_shardings(sh["layers"], 0)["l0"]["attn"]
    blk = [T.stack_index(b["layers"], 0)["l0"]["attn"] for b in blocks]
    wo = whole["wo"]["_plan"]
    assert wsh["wo"]["_plan"].store.codes.spec[0] == "model"
    codes = torch.cat([b["wo"]["_plan"].store.codes for b in blk], dim=0)
    row = torch.cat([b["wo"]["_plan"].store.row_gain for b in blk], dim=-1)
    assert torch.equal(codes, wo.store.codes)
    assert torch.equal(row, wo.store.row_gain)
    name = next(iter(whole["_groups"]))
    gp = whole["_groups"][name]
    per = [w // 4 for w in gp.member_ns]
    got = shd._uncut(torch.cat([b["_groups"][name].fused.store.codes
                                for b in blk], dim=-1), 1, 4, per)
    assert torch.equal(got, gp.fused.store.codes)


def test_gathered_split_store_derives_no_w_eff(fake14, monkeypatch):
    """The whole lowered tree, a rank's block, and a store rebuilt from
    gathered tensors derive no fp32 ``w_eff`` until a call reads it: the
    card's split kernel reads the int8 codes and never does
    (``exec.run._split_weights`` hands the wrapper None); the CPU's plain
    version derives it at its read, as the offset route's ``analog_mvm``
    does on every device, with the bits of ``_derive_w_eff()``."""
    from repro_torch.exec import run as R

    _, run, tree, specs = _lowered("stablelm-3b")
    whole = T.stack_index(tree["layers"], 0)["l0"]["mlp"]["up"]["_plan"]
    assert not whole.store.derived
    assert not tree["lm_head"]["_plan"].store.derived
    sh = shd.sharding_like(specs, tree)
    blk = _blocks(monkeypatch, tree, sh)[1]
    up = T.stack_index(blk["layers"], 0)["l0"]["mlp"]["up"]["_plan"]
    assert "_w_eff" not in up.store.__dict__
    rebuilt = shd._rebuild(up.store, {"codes": up.store.codes.clone()})
    assert "_w_eff" not in rebuilt.__dict__
    x = torch.randn((3, up.k))
    assert R._split_weights(up, x) is None   # the wrapper picks the operand
    y = run_layer(up, x, run.analog)         # the CPU's plain version reads it
    assert "_w_eff" in up.store.__dict__ and y.shape == (3, up.n)
    assert torch.equal(up.store.w_eff, up.store._derive_w_eff())


def test_a_leaf_the_shardings_do_not_name_raises(fake14):
    """Every entry of a tree needs its sharding: a leaf that the sharding
    tree leaves out raises, rather than stays whole on every rank.  A
    decode cache's ``"kv_block"`` is named (None) by the cache's own
    sharding tree, so the cache walks."""
    from repro_torch.serve import serve_step as SS

    ns = shd.NamedSharding(fake14, shd.P(None, "model"))
    tree = {"a": torch.zeros(2, 8), "b": torch.zeros(2, 8)}
    assert shd.shard_tree(tree, {"a": ns, "b": ns})["b"].shape == (2, 2)
    with pytest.raises(KeyError):
        shd.shard_tree(tree, {"a": ns})
    cfg = configs.get_smoke("glm4-9b")
    sh = SS.cache_sharding(cfg, torch.float32, 4, 32)
    cache = SS.init_cache(cfg, 4, 32, device="cpu")
    attn = cache["layers"]["l0"]["attn"]
    assert attn["kv_block"] == (0, 4, ("model",))
    assert sh["layers"]["l0"]["attn"]["kv_block"] is None
    whole = shd.gather_tree(cache, sh)["layers"]["l0"]["attn"]
    assert whole["k"].shape[2] == 32 == 4 * attn["k"].shape[2]
    assert whole["kv_block"] == attn["kv_block"]


def test_block_plans_stay_whole_under_a_mesh(fake14):
    """A tree with fused block plans resolves its shardings under a mesh
    that splits, its ``_block_plan`` whole on every rank (the packing
    interleaves the block's four layers), the layers beside it cut."""
    cfg = configs.get_smoke("phi4-mini-3.8b")
    acfg = AnalogConfig(mode="analog_faithful", act_calib="static")
    tree = T.attach_block_plans(api.lower_tree(T.lm_init(
        torch.Generator().manual_seed(0), cfg, device="cpu"), RunConfig(
        analog=acfg, activation_dtype="float32")), cfg, acfg, seq=6)
    specs = shd.plan_specs_like(T.lm_specs(cfg), tree)
    local = shd.shard_tree(tree, shd.sharding_like(specs, tree))
    whole, blk = tree["layers"]["l0"], local["layers"]["l0"]
    assert blk["_block_plan"] is whole["_block_plan"]
    assert blk["mlp"]["up"]["w"].shape[-1] * 4 == \
        whole["mlp"]["up"]["w"].shape[-1]
