"""The ranks' side of ``tests/test_torch_tp.py``: tensor parallelism over
the mesh's ``model`` axis on 4 gloo ranks (spawned by
``test_torch_mesh_workers.spawn``).  Imports torch and the port only (no
JAX); holds no tests itself.
"""
import torch

from test_torch_mesh_workers import _np, _tree_np


def _tensors(tree):
    """Every tensor of a tree of dicts, lists and plan dataclasses."""
    from repro_torch.exec.plan import PYTREE_FIELDS

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif type(tree) in PYTREE_FIELDS:
        for f in PYTREE_FIELDS[type(tree)][0]:
            yield from _tensors(getattr(tree, f))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _largest_leaf(tree) -> int:
    return max(t.numel() * t.element_size() for t in _tensors(tree))


def _replicated_bytes(tree, shardings) -> int:
    """Bytes of this rank's leaves that some mesh axis of size > 1 does
    not split (norms and scalars; on a (2, 2) mesh also a leaf split over
    one axis only)."""
    from repro_torch.distributed import sharding as shd

    total = []
    axes = {a for a, n in shd.axis_sizes().items() if n > 1}

    def one(t, ns):
        split = {a for _, ax in shd.split_dims(ns, t.ndim) for a in ax}
        if split != axes:
            total.append(t.numel() * t.element_size())
        return t

    shd._map_tree(one, tree, shardings)
    return sum(total)


def _same(a, b) -> bool:
    """Two plans (or tensors) equal leaf for leaf, bit for bit."""
    from repro_torch.exec.plan import PYTREE_FIELDS

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and \
            torch.equal(a, b)
    if type(a) in PYTREE_FIELDS:
        names = PYTREE_FIELDS[type(a)]
        return type(a) is type(b) and all(
            _same(getattr(a, f), getattr(b, f)) for f in names[0]) and all(
            getattr(a, f) == getattr(b, f) for f in names[1])
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _engine(case, mesh):
    """A ``ServeEngine`` of ``case`` built and served under ``mesh`` (None:
    no mesh): the engine, greedy tokens, one prefill's logits and cache,
    and the collectives of the serve."""
    from repro_torch import configs
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import sharding as shd
    from repro_torch.serve import serve_step as SS
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = configs.get_smoke(case["arch"])
    toks = torch.from_numpy(case["tokens"])
    with shd.use_mesh(mesh), torch.no_grad():
        eng = ServeEngine(cfg, _run(case), params_from_numpy(case["params"],
                                                             "cpu"),
                          batch_size=4, max_len=32, device="cpu")
        with shd.record_collectives() as log:
            done = eng.serve([Request(uid=i, prompt=p, max_new_tokens=4)
                              for i, p in enumerate(case["prompts"])])
            cache = SS.init_cache(cfg, toks.shape[0], 32,
                                  dtype=torch.float32, device="cpu")
            logits, _ = eng.prefill(eng.params, {"tokens": toks}, cache)
    return eng, {"tokens": [r.output.tolist() for r in done],
                 "logits": _np(logits), "log": log, "cache": cache}


def _run(case):
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.analog import AnalogConfig

    # digital at fp32 activations: row-parallel sums run in another order
    if case["mode"] == "digital":
        return RunConfig(activation_dtype="float32")
    return RunConfig(analog=AnalogConfig(mode=case["mode"]),
                     activation_dtype="float32" if case["fp32"]
                     else "bfloat16")


def plain_serve(case):
    """The no-mesh engine's tokens and prefill logits, and its whole
    tree's bytes and largest leaf and its cache's bytes (the module
    computes these beside the ranks)."""
    eng, got = _engine(case, None)
    return {"tokens": got["tokens"], "logits": got["logits"],
            "params_bytes": _nbytes(eng.params),
            "largest_leaf": _largest_leaf(eng.params),
            "cache_bytes": _nbytes(got["cache"])}


def _serve(case):
    """One SMOKE config served under ``case["mesh"]``: greedy tokens, one
    prefill's logits, each rank's resident bytes and those no axis
    splits, the collectives of the serve, and (analog) block 0's K-split
    ``wo`` and its QKV group gathered back against the whole compiled
    tree's plans."""
    from repro_torch import api, configs
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serve import serve_step as SS

    cfg = configs.get_smoke(case["arch"])
    mesh = make_mesh(case["mesh"], ("data", "model"))
    eng, got = _engine(case, mesh)
    with shd.use_mesh(mesh):
        out = {
            "mesh": {k: got[k] for k in ("tokens", "logits")},
            "bytes": {
                "params": _nbytes(eng.params),
                "params_replicated": _replicated_bytes(eng.params,
                                                       eng.param_shardings),
                "cache": _nbytes(got["cache"]),
                "cache_replicated": _replicated_bytes(
                    got["cache"], SS.cache_sharding(
                        cfg, torch.float32, case["tokens"].shape[0], 32))},
            "collectives": got["log"],
            "whole_tree_dropped": eng.model is None or
            eng.model.lowered is None,
            "kv_block": _has_kv_block(got["cache"]),
        }
        attn = eng.params["layers"]["l0"].get("attn", {})
        if case["mode"] != "digital" and "_groups" in attn:
            params = params_from_numpy(case["params"], "cpu")
            whole = api.compile(T.lm_module_spec(cfg, params), params,
                                _run(case), device="cpu").lower()
            out["gathered"] = _gathered(eng, whole)
    return out


def _has_kv_block(tree) -> bool:
    """Does an attention cache of the tree hold its ``kv_seq`` block?"""
    return isinstance(tree, dict) and ("kv_block" in tree or any(
        _has_kv_block(v) for v in tree.values()))


def _gathered(eng, whole):
    """Block 0's ``wo`` plan (its ``K`` on ``model``) and QKV group (its
    columns, member by member) all-gathered from this rank's blocks,
    against the whole tree's: bit for bit, and no ``w_eff`` derived."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.transformer import stack_index

    blk = stack_index(eng.params["layers"], 0)["l0"]["attn"]
    sh = shd.stack_shardings(eng.param_shardings["layers"], 0)["l0"]["attn"]
    ref = stack_index(whole["layers"], 0)["l0"]["attn"]
    wo = shd.gather_leaf(blk["wo"]["_plan"], sh["wo"]["_plan"])
    name = next(iter(blk["_groups"]))
    grp = shd.gather_leaf(blk["_groups"][name], sh["_groups"][name])
    return {"wo": _same(wo, ref["wo"]["_plan"]),
            "wo_split": tuple(blk["wo"]["_plan"].store.codes.shape) !=
            tuple(ref["wo"]["_plan"].store.codes.shape),
            "qkv": _same(grp, ref["_groups"][name]),
            "no_w_eff": "_w_eff" not in wo.store.__dict__ and
            "_w_eff" not in grp.fused.store.__dict__}


def serve(inputs):
    """Every serving case of the module."""
    torch.manual_seed(0)
    return {name: _serve(case) for name, case in inputs["serve"].items()}


def train(inputs):
    """One train step per case of the module (glm4-9b SMOKE; qwen3-moe
    SMOKE, its expert stacks' blocks kept for the expert-parallel
    dispatch) on a (2, 2) ``(data, model)`` mesh from the module's
    parameters, per mode: the loss, the grad norm and the whole
    parameters after AdamW (gathered), and the largest single all-gather
    of the step."""
    return {name: _train(d) for name, d in inputs["train"].items()}


def _train(d):
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.noise import NOISELESS
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    cfg = configs.get_smoke(d["arch"])
    batch = {k: torch.from_numpy(v) for k, v in d["batch"].items()}
    out = {}
    with shd.use_mesh(make_mesh((2, 2), ("data", "model"))):
        for mode in d["modes"]:
            acfg = AnalogConfig(mode=mode, noise=NOISELESS) \
                if mode != "digital" else RunConfig().analog
            run = RunConfig(analog=acfg, activation_dtype="float32")
            params = params_from_numpy(d["params"], "cpu")
            state = {"params": params,
                     "opt": O.adamw_init(params, TS.make_opt_config(run))}
            step = TS.make_train_step(cfg, run, abstract_state=state)
            local = shd.shard_tree(state, step.state_shardings)
            del state, params
            with shd.record_collectives() as log:
                local, m = step(local, shd.shard_tree(
                    batch, step.batch_shardings))
            whole = shd.gather_tree(local, step.state_shardings)
            out[mode] = {"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "params": _tree_np(whole["params"]),
                         "largest_gather": log["largest"].get("all-gather",
                                                              0.0)}
    return out
