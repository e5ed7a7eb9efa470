"""Training driver on one device: the port of ``repro.launch.train``: the
end-to-end loop with checkpointing, fault tolerance, straggler monitoring
and deterministic data.

The reference lays the state out over a mesh (``device_put`` with
shardings); here it lives on one device, the card unless ``--device``
names another.  The mesh, the sharded batch and the resharding restore
come with the multi-chip launch layer (``ROADMAP.md``, A12d).

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
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import pipeline as dp
from repro_torch.kernels import backend
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


def train(run: TrainRun, steps: int, device=None, log_every: int = 10,
          on_step=None):
    """``steps`` steps from the newest checkpoint in ``run.ckpt_dir`` (or
    from a random init drawn from ``run.seed``) on ``device`` (None: the
    card), saving every ``run.ckpt_every`` steps in the background and the
    last step at the end (unless the periodic save just wrote it: the
    reference starts both, which race).  Returns (params, opt_state,
    history of losses)."""
    cfg = run.cfg
    dev = backend.resolve_device(device)
    wf = bool(cfg.frontend_tokens)

    params = stacked.init_params(
        cfg, torch.Generator(device=dev).manual_seed(run.seed), dev)
    opt_state = adamw.init(params, run.ocfg)
    step_fn = steps_lib.make_train_step(cfg, run.ocfg, remat=run.remat,
                                        accum=run.accum)

    mgr = CheckpointManager(run.ckpt_dir) if run.ckpt_dir else None
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        (params, opt_state), start_step = mgr.restore((params, opt_state))
        print(f"[train] resumed from step {start_step}")

    hb = faults.Heartbeat(interval_s=2.0, timeout_s=30.0)
    hb.start_self_beat()
    straggler = faults.StragglerMonitor()
    fe = dp.frontend_stub(cfg, run.shape.global_batch, dev) if wf else None
    history: List[float] = []
    saved = None
    try:
        for step in range(start_step, start_step + steps):
            t0 = time.monotonic()
            x, y = dp.host_batch(cfg, run.shape, step, seed=run.seed,
                                 device=dev)

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
            if step % log_every == 0:
                print(f"[train] step {step}: loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"{dt*1000:.0f}ms"
                      + (" STRAGGLER" if straggler.flagged_steps else ""))
            if mgr and (step + 1) % run.ckpt_every == 0:
                mgr.save_async(step + 1, (params, opt_state))
                saved = step + 1
        if mgr and saved != start_step + steps:
            mgr.save(start_step + steps, (params, opt_state))
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
    _, _, hist = train(run, args.steps, device=args.device)
    print(f"[train] done: loss {hist[0]:.4f} -> {hist[-1]:.4f}")
    return hist


if __name__ == "__main__":
    main()
