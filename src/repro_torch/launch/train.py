"""Training launcher: the fault-tolerant training loop (port of
``repro.launch.train``).

``PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --smoke --steps 50 --ckpt-dir build/ckpt [--device cpu]``

Config registry -> synthetic data pipeline (stateless, step-indexed) ->
train step -> atomic checkpointing -> heartbeat + straggler clock +
bounded-retry rollback.  The step updates its state in place, so the
retry covers only its differentiated half (``loss_and_grads``, which
leaves the state as it was, like the reference's pure step); the update
is applied once, and a failure inside it ends the loop.  It runs on the
CUDA device unless ``device`` says otherwise.  ``use_mesh=True`` trains
under the host mesh (:func:`repro_torch.launch.mesh.make_host_mesh`, pure
data parallel over the running process group, or a group of one started
for ``device``): the state is stored as this rank's blocks, and each
checkpoint is gathered whole first.
"""
from __future__ import annotations

import argparse
import functools

import torch

from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.core.analog import AnalogConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.data.lm_data import DataConfig, SyntheticLM
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault import (Heartbeat, RetryPolicy,
                                           StragglerClock)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs import trace as obs_trace
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import train_step as TS


def _batch_on(batch_np: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
            for k, v in batch_np.items()}


def train_loop(arch: str, *, smoke: bool = True, steps: int = 50,
               ckpt_dir: str = "", ckpt_every: int = 20, batch: int = 8,
               seq_len: int = 64, lr: float = 1e-3, mode: str = "digital",
               log_every: int = 10, use_mesh: bool = False,
               device: DeviceLike = None) -> dict:
    """Train ``arch`` for ``steps`` steps, resuming from the newest intact
    checkpoint in ``ckpt_dir`` when there is one.  Returns ``{"losses",
    "state", "final_metrics"}`` (under the mesh, this rank's blocks of the
    state)."""
    dev = resolve_device(device)
    if not use_mesh:
        return _loop(arch, smoke, steps, ckpt_dir, ckpt_every, batch,
                     seq_len, lr, mode, log_every, dev)
    started = not torch.distributed.is_initialized()
    mesh = mesh_lib.make_host_mesh(dev)
    try:
        with shd.use_mesh(mesh):
            return _loop(arch, smoke, steps, ckpt_dir, ckpt_every, batch,
                         seq_len, lr, mode, log_every, dev)
    finally:
        if started:
            mesh_lib.destroy()


def _loop(arch, smoke, steps, ckpt_dir, ckpt_every, batch, seq_len, lr,
          mode, log_every, dev) -> dict:
    cfg = configs.get_smoke(arch) if smoke else configs.get_arch(arch)
    run = RunConfig(
        learning_rate=lr, warmup_steps=max(steps // 10, 1),
        analog=AnalogConfig(mode=mode) if mode != "digital"
        else RunConfig().analog,
    )
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch,
    ))
    gen = torch.Generator(device=dev).manual_seed(run.seed)
    state = TS.init_state(gen, cfg, run, device=dev)
    opt_cfg = TS.make_opt_config(run, total_steps=steps)

    start_step = 0
    if ckpt_dir:
        restored = CKPT.restore_latest(ckpt_dir, state["params"],
                                       state["opt"])
        if restored is not None:
            params, opt, start_step, _ = restored
            state = {"params": params, "opt": opt}
            obs_trace.log(f"resumed from step {start_step}")

    if shd.get_mesh() is None:
        grads_fn = functools.partial(TS.loss_and_grads, cfg=cfg, run=run)
        shard_batch = gather_state = lambda t: t
        pshard = None
    else:
        step_fn = TS.make_train_step(cfg, run, opt_cfg,
                                     abstract_state=state)
        state = shd.shard_tree(state, step_fn.state_shardings)
        pshard = step_fn.state_shardings["params"]

        def grads_fn(params, batch_dev, noise):
            return step_fn.loss_and_grads({"params": params}, batch_dev,
                                          noise)

        def shard_batch(b):
            return shd.shard_tree(b, step_fn.batch_shardings)

        def gather_state(s):
            return shd.gather_tree(s, step_fn.state_shardings)

    def save(step, **extra):
        whole = gather_state({"params": state["params"],
                              "opt": state["opt"]})
        CKPT.save(ckpt_dir, step, whole["params"], whole["opt"],
                  extra={"arch": cfg.name, **extra})

    hb = Heartbeat(ckpt_dir + "/hb", CKPT._process_index()) \
        if ckpt_dir else None
    clock = StragglerClock()
    retry = RetryPolicy(max_retries=2)
    noisy = not (run.analog.deterministic or run.analog.mode == "digital")
    metrics = {}
    losses = []

    for step in range(start_step, steps):
        batch_dev = shard_batch(_batch_on(data.batch(step), dev))

        def do_grads(state=state, batch_dev=batch_dev, step=step):
            noise = (torch.Generator(device=dev).manual_seed(step)
                     if noisy else None)
            out = grads_fn(state["params"], batch_dev, noise)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out

        def rollback(attempt, exc, step=step):
            obs_trace.log(f"step {step} failed ({exc}); rolling back "
                          f"(attempt {attempt + 1})")

        with obs_trace.span("train.step", step=step) as sp:
            loss, metrics, grads = retry.run(do_grads, on_failure=rollback)
            metrics = {**metrics, **TS.apply_update(state, grads,
                                                    opt_cfg=opt_cfg,
                                                    shardings=pshard),
                       "loss": loss}
            del grads
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = sp.dur_us / 1e6
        if clock.record(dt):
            obs_trace.log(f"step {step}: straggler ({dt:.2f}s vs median "
                          f"{clock.median:.2f}s)")
        losses.append(float(metrics["loss"]))
        if hb is not None:
            hb.beat(step)
        if log_every and step % log_every == 0:
            obs_trace.log(f"step {step:5d}: loss={losses[-1]:.4f} "
                          f"lr={float(metrics['lr']):.2e} "
                          f"gnorm={float(metrics['grad_norm']):.2f} "
                          f"({dt * 1e3:.0f} ms)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save(step + 1, loss=losses[-1])
    if ckpt_dir:
        save(steps, final=True)
    return {"losses": losses, "state": state, "final_metrics": metrics}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--mode", default="digital",
                    choices=["digital", "analog_faithful", "analog_fast"])
    ap.add_argument("--mesh", action="store_true",
                    help="use the host device mesh (pure DP)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    a = ap.parse_args(argv)
    out = train_loop(
        a.arch, smoke=a.smoke, steps=a.steps, ckpt_dir=a.ckpt_dir,
        ckpt_every=a.ckpt_every, batch=a.batch, seq_len=a.seq_len,
        lr=a.lr, mode=a.mode, use_mesh=a.mesh, device=a.device,
    )
    obs_trace.log(f"final loss: {out['losses'][-1]:.4f} "
                  f"(first: {out['losses'][0]:.4f})")


if __name__ == "__main__":
    main()
