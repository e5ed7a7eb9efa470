"""Training driver: the port of ``repro.launch.train``: the end-to-end
loop with sharding, checkpointing, fault tolerance, straggler monitoring
and deterministic data.

Without a mesh the state lives on one device, the card unless
``--device`` names another.  With one (``train(run, steps, mesh=...)``)
the parameters and the optimizer state are laid out over it by
``launch.sharding``'s specs, each rank draws its rows of the batch
(``pipeline.sharded_batch``) and the step is ``steps.ShardedTrainStep``
(data-parallel compute over the sharded state; see ``launch/steps.py``).
A checkpoint is the whole state, gathered to save and resharded onto the
mesh on restore; the lead rank writes it.  Under ``torchrun`` the CLI
initialises the process group (NCCL on the card, gloo on the host) and
trains on ``mesh.make_host_mesh()`` over the whole world:

    torchrun --nproc-per-node 1 -m repro_torch.launch.train \\
        --arch olmo_1b --steps 5 --layers 2 --d-model 64 --vocab 256

A step is retried through ``faults.run_step_with_retries``; only its
forward and backward are retried, and the AdamW update, which changes the
parameters in place, runs once they have succeeded.

Usage (host, reduced size):
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch olmo_1b --steps 5 --layers 2 --d-model 64 --vocab 256
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import pipeline as dp
from repro_torch.kernels import backend
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.launch import steps as steps_lib
from repro_torch.models import stacked
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.optim import adamw
from repro_torch.runtime import faults


@dataclasses.dataclass
class TrainRun:
    cfg: ArchConfig
    shape: ShapeConfig
    ocfg: adamw.AdamWConfig
    remat: str = "none"
    accum: int = 1
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    seed: int = 0


def _gathered(state):
    """The whole value of every leaf: DTensors gathered (on every rank of
    their mesh), plain tensors as they are."""
    return tree.map_with_path(lambda _, t: steps_lib.whole(t), state)


def _barrier(mesh) -> None:
    """Wait for every rank of ``mesh``: an all-reduce over each of its
    dims in turn."""
    flag = torch.zeros((), device=sharding.mesh_device(mesh))
    for axis in mesh.mesh_dim_names:
        dist.all_reduce(flag, group=mesh.get_group(axis))


def train(run: TrainRun, steps: int, mesh=None, log_every: int = 10,
          on_step=None, device=None):
    """``steps`` steps from the newest checkpoint in ``run.ckpt_dir`` (or
    from a random init drawn from ``run.seed``), saving every
    ``run.ckpt_every`` steps in the background and the last step at the
    end (unless the periodic save just wrote it: the reference starts
    both, which race).  On ``mesh`` (a DeviceMesh; every rank of it calls
    this) the state is sharded over it and the returned params and
    optimizer state are DTensors; without one, on ``device`` (None: the
    card).  Returns (params, opt_state, history of losses)."""
    cfg = run.cfg
    dev = (sharding.mesh_device(mesh) if mesh is not None
           else backend.resolve_device(device))
    lead = mesh is None or dist.get_rank() == 0
    wf = bool(cfg.frontend_tokens)

    params = stacked.init_params(
        cfg, torch.Generator(device=dev).manual_seed(run.seed), dev)
    if mesh is None:
        opt_state = adamw.init(params, run.ocfg)
        step_fn = steps_lib.make_train_step(cfg, run.ocfg, remat=run.remat,
                                            accum=run.accum)
    else:
        data_axes = mesh_lib.data_axes(mesh)
        params = sharding.place(params, mesh,
                                sharding.param_specs(mesh, params))
        opt_state = steps_lib.init_sharded_opt_state(params, run.ocfg, mesh)
        step_fn = steps_lib.make_sharded_train_step(
            cfg, run.ocfg, mesh, remat=run.remat, accum=run.accum)

    mgr = CheckpointManager(run.ckpt_dir) if run.ckpt_dir else None
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        if mesh is None:
            (params, opt_state), start_step = mgr.restore((params,
                                                           opt_state))
        else:
            state, start_step = mgr.restore(_gathered((params, opt_state)))
            params, opt_state = faults.reshard_state(
                state, mesh, lambda path, leaf: sharding.spec_for(
                    mesh, path, leaf))
            del state
        if lead:
            print(f"[train] resumed from step {start_step}")
    if not lead:
        mgr = None                   # the lead rank writes the checkpoints

    hb = faults.Heartbeat(interval_s=2.0, timeout_s=30.0)
    hb.start_self_beat()
    straggler = faults.StragglerMonitor()
    fe = dp.frontend_stub(cfg, run.shape.global_batch, dev) if wf else None
    if fe is not None and mesh is not None:
        fe = fe[sharding.local_rows(mesh, run.shape.global_batch, data_axes)]
    history: List[float] = []
    saved = None
    try:
        for step in range(start_step, start_step + steps):
            t0 = time.monotonic()
            if mesh is None:
                x, y = dp.host_batch(cfg, run.shape, step, seed=run.seed,
                                     device=dev)
            else:
                x, y = dp.sharded_batch(cfg, run.shape, step, mesh,
                                        data_axes, seed=run.seed)

            def grads():
                out = step_fn.grads(params, x, y, fe)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)   # a failure shows here
                return out

            g, loss_t, metrics = faults.run_step_with_retries(
                grads, retries=2, rng=np.random.default_rng(run.seed + step))
            params, opt_state, metrics = step_fn.apply(
                params, opt_state, g, loss_t, metrics)
            del g
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            straggler.observe(dt)
            hb.beat()
            history.append(loss)
            if on_step:
                on_step(step, metrics)
            if lead and step % log_every == 0:
                print(f"[train] step {step}: loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"{dt*1000:.0f}ms"
                      + (" STRAGGLER" if straggler.flagged_steps else ""))
            if run.ckpt_dir and (step + 1) % run.ckpt_every == 0:
                whole = _gathered((params, opt_state))
                if mgr:
                    mgr.save_async(step + 1, whole)
                del whole
                saved = step + 1
        if run.ckpt_dir and saved != start_step + steps:
            whole = _gathered((params, opt_state))
            if mgr:
                mgr.save(start_step + steps, whole)
        if run.ckpt_dir and mesh is not None:
            _barrier(mesh)           # every rank returns after the commit
    finally:
        if mgr:
            mgr.wait()
        hb.stop()
    return params, opt_state, history


def main(argv=None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA "
                         "device; 'cpu' trains on the host)")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch)
    if args.layers or args.d_model or args.vocab:
        cfg = cfg.reduced(n_layers=args.layers or 4,
                          d_model=args.d_model or 256,
                          vocab=args.vocab or 1024)
        if cfg.ssm_state:
            cfg = dataclasses.replace(
                cfg, ssm_chunk=min(cfg.ssm_chunk, args.seq))
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    run = TrainRun(cfg=cfg, shape=shape,
                   ocfg=adamw.AdamWConfig(lr=args.lr,
                                          compress=args.compress_grads),
                   remat=args.remat, accum=args.accum,
                   ckpt_dir=args.ckpt_dir)
    if "WORLD_SIZE" not in os.environ:
        _, _, hist = train(run, args.steps, device=args.device)
    else:
        # launched by torchrun: one process a rank, the group from its
        # environment, the whole world one (data, model) mesh
        dev = backend.resolve_device(args.device)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        try:
            _, _, hist = train(run, args.steps,
                               mesh=mesh_lib.make_host_mesh())
        finally:
            dist.destroy_process_group()
    print(f"[train] done: loss {hist[0]:.4f} -> {hist[-1]:.4f}")
    return hist


if __name__ == "__main__":
    main()
