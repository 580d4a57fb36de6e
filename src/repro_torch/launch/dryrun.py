"""Multi-pod dry run (port of ``repro.launch.dryrun``): trace every
(architecture x input shape) cell on the production mesh and record its
roofline terms, without the devices.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \
        --shape decode_32k --mesh single [--mode digital]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]

How: a fake process group (``FakeStore``) of 256 or 512 ranks stands in
for the pod, this process is its rank 0, and the production mesh spans it
(:func:`repro_torch.launch.mesh.make_production_mesh`).  Every tensor
lives on the ``meta`` device: parameters, caches and batches have their
whole shapes, each rank's blocks are views of them (``shard_tree``), and
the step runs its plain PyTorch versions to trace the shapes - no kernel
launches on meta, and the fake group's collectives move nothing.  Per
cell one JSON under ``experiments/dryrun/`` with the reference's keys:

- ``collectives``: per-op count and bytes per rank, counted by the port's
  collective helpers (``sharding.record_collectives``) - the twin of the
  reference's ``parse_collectives``, which reads them from HLO;
- ``cost.flops``: :class:`torch.utils.flop_counter.FlopCounterMode` over
  the traced step (matmuls and attention products, per rank);
- ``memory.argument_size_in_bytes`` / ``output_size_in_bytes``: the bytes
  of this rank's blocks of the step's inputs and outputs.

What meta tensors cannot know is ``null``: ``temp_size_in_bytes`` (no
allocator runs), ``alias_size_in_bytes``, ``generated_code_size_in_bytes``
(no compiler), ``cost["bytes accessed"]`` and ``transcendentals``, and
``hlo_lines``.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.noise import NoiseConfig
from repro_torch.distributed import sharding as shd
from repro_torch.exec.plan import PYTREE_FIELDS
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import serve_step as SS
from repro_torch.train import train_step as TS

OUT_DIR = "experiments/dryrun"
META = torch.device("meta")


# ------------------------------------------------------------ input specs
def input_specs(arch: str, shape: str, run: RunConfig,
                kv_dtype=torch.bfloat16):
    """Meta-tensor stand-ins, whole shapes, for every input of the cell's
    step: ``(cfg, shape, args)`` with ``args`` ``(state, batch, None)``
    for a train cell (the third is the noise source), ``(params, batch,
    cache)`` for a prefill and ``(params, tokens, cache)`` for a decode
    cell (one new token against a ``seq_len``-deep cache)."""
    cfg = configs.get_arch(arch)
    sh = SHAPES[shape]
    b, s = sh.global_batch, sh.seq_len

    def tokens_or_embeds(batch, seqlen):
        if cfg.embed_inputs:
            return {"tokens": torch.empty((batch, seqlen), dtype=torch.int64,
                                          device=META)}
        return {"embeds": torch.empty((batch, seqlen, cfg.d_model),
                                      dtype=torch.bfloat16, device=META)}

    if sh.kind == "train":
        state = TS.init_state(torch.Generator(), cfg, run, device=META)
        batch = {**tokens_or_embeds(b, s),
                 "labels": torch.empty((b, s), dtype=torch.int64,
                                       device=META)}
        return cfg, sh, (state, batch, None)

    params = T.lm_init(torch.Generator(), cfg, device=META)
    cache = T.init_lm_cache(cfg, b, s, dtype=kv_dtype, device=META)
    if sh.kind == "prefill":
        return cfg, sh, (params, tokens_or_embeds(b, s), cache)
    tok = tokens_or_embeds(b, 1)
    return cfg, sh, (params, next(iter(tok.values())), cache)


def _fake_group(world: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _trace(sh, cfg, run, args, kv_dtype):
    """Shard the inputs, run the step once on meta; returns ``(in_bytes,
    out_bytes)`` of this rank's blocks."""
    if sh.kind == "train":
        state, batch, _ = args
        step = TS.make_train_step(cfg, run, abstract_state=state,
                                  abstract_batch=batch)
        st = shd.shard_tree(state, step.state_shardings)
        bt = shd.shard_tree(batch, step.batch_shardings)
        in_bytes = _nbytes(st) + _nbytes(bt)
        st, metrics = step(st, bt)
        return in_bytes, _nbytes(st) + _nbytes(metrics)
    params, inputs, _ = args
    prefill, decode = SS.make_serve_steps(cfg, run, abstract_params=params)
    fn = prefill if sh.kind == "prefill" else decode
    local = shd.shard_tree(params, fn.param_shardings)
    cache = SS.init_cache(cfg, sh.global_batch, sh.seq_len, dtype=kv_dtype,
                          device=META)
    in_bytes = _nbytes(local) + _nbytes(cache) + _nbytes(inputs)
    logits, cache = fn(local, inputs, cache)
    return in_bytes, _nbytes(logits) + _nbytes(cache)


def _nbytes(tree) -> int:
    """Bytes of the tensors of a tree of this rank's blocks (plan
    dataclasses included); shapes only, so meta tensors count."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if type(tree) in PYTREE_FIELDS:
        return sum(_nbytes(getattr(tree, f))
                   for f in PYTREE_FIELDS[type(tree)][0])
    return 0


# ------------------------------------------------------------------ runner
def run_cell(arch: str, shape: str, mesh_kind: str, mode: str,
             out_dir: str = OUT_DIR, tag: str = "", signed: str = "split",
             **run_overrides) -> dict:
    """Trace one cell on a fake group of the production mesh's size and
    write its JSON; returns the record.  The group is ended after."""
    acfg = (AnalogConfig(mode=mode, noise=NoiseConfig(mode="rank1"),
                         signed_input=signed)
            if mode != "digital" else RunConfig().analog)
    # bf16-param archs (the 400B MoE) also keep Adam moments in bf16
    optim_dtype = run_overrides.pop("optim_dtype", None) or (
        "bfloat16" if configs.get_arch(arch).dtype == torch.bfloat16
        else "float32")
    kv_dtype = torch.int8 if run_overrides.pop("kv_int8", False) \
        else torch.bfloat16
    run = RunConfig(analog=acfg, optim_dtype=optim_dtype, **run_overrides)
    multi = mesh_kind == "multi"
    _fake_group(512 if multi else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi)
        t0 = obs_trace.clock_us()
        with shd.use_mesh(mesh, rules=shd.rules_for(run)):
            cfg, sh, args = input_specs(arch, shape, run, kv_dtype)
            t_setup = (obs_trace.clock_us() - t0) / 1e6
            with shd.record_collectives() as coll, \
                    FlopCounterMode(display=False) as flops, \
                    torch.no_grad() if sh.kind != "train" else \
                    torch.enable_grad():
                in_bytes, out_bytes = _trace(sh, cfg, run, args, kv_dtype)
            t_trace = (obs_trace.clock_us() - t0) / 1e6 - t_setup
        n_devices = mesh.size()
    finally:
        dist.destroy_process_group()
    result = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_kind,
        "mode": mode,
        "kind": sh.kind,
        "n_devices": n_devices,
        "lower_s": round(t_setup, 1),
        "compile_s": round(t_trace, 1),
        "memory": {
            "temp_size_in_bytes": None,
            "argument_size_in_bytes": in_bytes,
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": None,
            "generated_code_size_in_bytes": None,
        },
        "cost": {"flops": float(flops.get_total_flops()),
                 "bytes accessed": None, "transcendentals": None},
        "collectives": coll,
        "hlo_lines": None,
        "tag": tag,
    }
    os.makedirs(out_dir, exist_ok=True)
    cell = f"{arch}__{shape}__{mesh_kind}__{mode}"
    if tag:
        cell += "__" + tag
    with open(os.path.join(out_dir, cell + ".json"), "w") as f:
        json.dump(result, f, indent=2, default=str)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--mode", default="digital",
                    choices=["digital", "analog_faithful", "analog_fast"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--tag", default="", help="suffix for variant artifacts")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-seq-sp", action="store_true",
                    help="the reference's flag; no site of the port "
                    "splits the residual's sequence, so the cells do "
                    "not change")
    ap.add_argument("--moe-dispatch", default="shard_map",
                    choices=["gspmd_ep", "replicated_buf", "shard_map"])
    ap.add_argument("--optim-bf16", action="store_true")
    ap.add_argument("--signed", default="split",
                    choices=["split", "offset", "none"])
    ap.add_argument("--kv-int8", action="store_true")
    args = ap.parse_args(argv)
    overrides = dict(fsdp=not args.no_fsdp, seq_sp=not args.no_seq_sp,
                     moe_dispatch=args.moe_dispatch, kv_int8=args.kv_int8)
    if args.optim_bf16:
        overrides["optim_dtype"] = "bfloat16"
    if args.all:
        cells = configs.all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch, shape in cells:
        for mesh_kind in meshes:
            tag = f"{arch} x {shape} x {mesh_kind} x {args.mode}"
            try:
                r = run_cell(arch, shape, mesh_kind, args.mode, args.out,
                             tag=args.tag, signed=args.signed, **overrides)
                obs_trace.log(
                    f"[OK] {tag}: trace={r['compile_s']}s "
                    f"args/dev={r['memory']['argument_size_in_bytes'] / 2**30:.2f}GiB "
                    f"flops={r['cost']['flops']:.3g} "
                    f"coll={r['collectives']['total_bytes']:.3g}B")
            except Exception as e:  # noqa: BLE001 - a failed cell is reported and the sweep goes on
                failures.append(tag)
                obs_trace.log(f"[FAIL] {tag}: {e}")
                traceback.print_exc()
    if failures:
        obs_trace.log(f"\n{len(failures)} FAILURES:\n" + "\n".join(failures))
        raise SystemExit(1)
    obs_trace.log("\nall cells traced")


if __name__ == "__main__":
    main()
