"""The ranks' side of the port's CPU mesh tests: a group of gloo ranks
spawned once per test module (:func:`spawn`), each running every case it
is handed and saving its results for the module's tests to read.  Imports
torch and the port only (no JAX), so each spawned rank starts fast; holds
no tests itself.

A case is ``name -> fn(inputs) -> results``; ``inputs`` is what the
module wrote before the spawn (numpy arrays and trees of them), the
results are saved per rank as ``<out>/rank<r>.pt``.
"""
import os
import time

import torch
import torch.distributed as dist


def spawn(cases, inputs, out_dir, world: int = 4, timeout: float = 240.0,
          module: str = __name__):
    """Run ``cases`` (names of functions of ``module``, this one by
    default) on ``world`` gloo ranks over a ``FileStore`` under
    ``out_dir`` (no fixed port: several test processes spawn at once);
    returns each rank's results."""
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    torch.save(inputs, os.path.join(out_dir, "inputs.pt"))
    ctx = mp.start_processes(_rank_main,
                             args=(world, out_dir, tuple(cases), module),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _rank_main(rank, world, out_dir, cases, module=__name__):
    import importlib

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"),
                        weights_only=False)
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        fns = importlib.import_module(module)
        results = {name: getattr(fns, name)(inputs) for name in cases}
    finally:
        dist.destroy_process_group()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


# ------------------------------------------------------------------ cases
def cp_flash(inputs):
    """CP flash on a (2, 2) (data, model) mesh against the port's
    ``flash_attention``: outputs and the gradients of sum(o^2)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.flash import flash_attention, flash_attention_cp

    qkv = [torch.from_numpy(inputs["cp"][k]) for k in ("q", "k", "v")]
    plain = [t.clone().requires_grad_(True) for t in qkv]
    cp = [t.clone().requires_grad_(True) for t in qkv]
    o_plain = flash_attention(*plain, block_q=16, block_kv=16)
    o_plain.square().sum().backward()
    with shd.use_mesh(make_mesh((2, 2), ("data", "model"))):
        o_cp = flash_attention_cp(*cp, block_q=16, block_kv=16)
    o_cp.square().sum().backward()
    return {"o_cp": _np(o_cp), "o_plain": _np(o_plain),
            "g_cp": [_np(t.grad) for t in cp],
            "g_plain": [_np(t.grad) for t in plain]}


def moe_ep(inputs):
    """The expert-parallel dispatch on a (2, 2) mesh against the port's
    ``gspmd_ep`` path, the reference's routes replayed, per mode (and the
    token gradients in digital mode)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as M

    d = inputs["moe"]
    params = params_from_numpy(d["params"], "cpu")
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for mode in ("digital", "analog_faithful"):
        acfg = AnalogConfig(mode=mode)
        got = {}
        for dispatch in ("gspmd_ep", "shard_map"):
            x = torch.from_numpy(d["x"]).requires_grad_(True)
            routes = M.Routes(replay=[(torch.from_numpy(d["topw"]),
                                       torch.from_numpy(d["topi"]).long())])
            with shd.use_mesh(mesh):
                y, aux = M.moe_apply(params, x, acfg=acfg, top_k=2,
                                     dispatch=dispatch, routes=routes)
            if mode == "digital":
                y.square().sum().backward()
            got[dispatch] = {"y": _np(y), "aux": float(aux.detach()),
                             "dx": None if x.grad is None else _np(x.grad)}
        out[mode] = got
    return out


def train_step(inputs):
    """One glm4-9b SMOKE train step on the 4-rank ``("data",)`` host mesh
    from the module's parameters: the loss, the grad norm and the whole
    parameters after AdamW (gathered), per mode."""
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.noise import NOISELESS
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    d = inputs["train"]
    cfg = configs.get_smoke("glm4-9b")
    batch = {k: torch.from_numpy(v) for k, v in d["batch"].items()}
    out = {}
    with shd.use_mesh(make_host_mesh("cpu")):
        for mode in d["modes"]:
            acfg = AnalogConfig(mode=mode, noise=NOISELESS) \
                if mode != "digital" else RunConfig().analog
            run = RunConfig(analog=acfg, activation_dtype="float32")
            params = params_from_numpy(d["params"], "cpu")
            state = {"params": params,
                     "opt": O.adamw_init(params, TS.make_opt_config(run))}
            step = TS.make_train_step(cfg, run, abstract_state=state)
            local = shd.shard_tree(state, step.state_shardings)
            local, m = step(local, shd.shard_tree(batch, step.batch_shardings))
            whole = shd.gather_tree(local, step.state_shardings)
            out[mode] = {"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "params": _tree_np(whole["params"])}
    return out


def serve_2x2(inputs):
    """The SMOKE LM served under a (2, 2) mesh at dynamic calibration
    against no mesh: the engine's greedy tokens, and one prefill's
    logits through the steps."""
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.serve_step import init_cache

    d = inputs["serve"]
    cfg = configs.get_smoke(d["arch"])
    run = RunConfig(analog=AnalogConfig(mode="analog_faithful"))
    params = params_from_numpy(d["params"], "cpu")

    def requests():
        return [Request(uid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(d["prompts"])]

    toks = torch.from_numpy(d["tokens"])
    out = {}
    for meshed in (False, True):
        ctx = shd.use_mesh(make_mesh((2, 2), ("data", "model"))) if meshed \
            else shd.use_mesh(None)
        with ctx, torch.no_grad():
            eng = ServeEngine(cfg, run, params, batch_size=4, max_len=32,
                              device="cpu")
            done = eng.serve(requests())
            cache = init_cache(cfg, toks.shape[0], 32, dtype=torch.float32,
                               device="cpu")
            logits, _ = eng.prefill(eng.params, {"tokens": toks}, cache)
        out["mesh" if meshed else "plain"] = {
            "tokens": [r.output.tolist() for r in done],
            "logits": _np(logits)}
    return out


def pipeline(inputs):
    """``pipeline_apply`` over the ``pod`` axis of a (2, 2) (pod, data)
    mesh: the outputs, and this rank's stage gradients of sum(out^2)
    beside the sequential composition's."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh

    d = inputs["pipe"]
    out = {}
    for name, case in d.items():
        params = {k: torch.from_numpy(v) for k, v in case["params"].items()}
        x = torch.from_numpy(case["x"])
        mesh = make_mesh((2, 2), ("pod", "data"))
        with shd.use_mesh(mesh):
            sh = shd.sharding_like({"w": ("stage", None, None),
                                    "b": ("stage", None)}, params)
            local = {k: t.clone().requires_grad_(True)
                     for k, t in shd.shard_tree(params, sh).items()}
            y = pipeline_apply(_stage_fn, local, x)
            (y ** 2).sum().backward()
            stage = shd.axis_index("pod")
        whole = {k: t.clone().requires_grad_(True) for k, t in params.items()}
        want = x
        for s in range(whole["w"].shape[0]):
            want = _stage_fn({"w": whole["w"][s], "b": whole["b"][s]}, want)
        (want ** 2).sum().backward()
        out[name] = {"y": _np(y), "stage": stage,
                     "gw": _np(local["w"].grad[0]),
                     "gw_seq": _np(whole["w"].grad[stage]),
                     "gb": _np(local["b"].grad[0]),
                     "gb_seq": _np(whole["b"].grad[stage])}
    return out


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])



