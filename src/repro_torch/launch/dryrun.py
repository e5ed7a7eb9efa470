"""Multi-pod dry run: build every (architecture x input shape) cell on the
production meshes, run one step of it on fake tensors, and write its
memory and roofline terms: the port of ``repro.launch.dryrun``.

It runs as its own process, and one process stands for rank 0 of a fake
process group of 256 ranks (16 x 16) or 512 (2 x 16 x 16, ``--multi-pod``):
``torch.distributed``'s ``fake`` backend over a ``FakeStore``, whose
collectives return at once.  Every tensor is made under
``FakeTensorMode``: shapes, dtypes and placements, no memory.  The cell is
the port's own sharded step (``launch/steps.py``) on state placed by
``launch/sharding.py``'s specs, so what is counted is what this rank of
the port would run: its rows of the batch, each layer's leaves gathered
over the data axes while the layer runs, and its own share of the model
axis's heads, FFN columns, experts and vocabulary.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_14b \
        --shape train_4k [--multi-pod] [--out experiments/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Where the reference asks XLA, the port counts:

* ``compile_s``: the seconds to build the cell and run its step once.
* FLOPs, bytes and collectives: :func:`repro_torch.launch.roofline.count`
  over the step, for this rank; the collectives' bytes by the function
  that issued them (``Counts.sites``) are printed.
* ``memory``: ``argument_bytes`` and ``output_bytes`` are the local shard
  sizes of the step's arguments and outputs; ``temp_bytes`` is the peak of
  ``MemTracker`` over the step less the arguments; ``alias_bytes`` the
  donated arguments the step updates in place (train: params and optimizer
  state; prefill and decode: the caches); ``peak_est_bytes`` is computed as
  the reference computes it.

The card's code paths: the fake tensors lie on the CPU (the fake group's
mesh is a CPU mesh, ``mesh.device_type()``).  One site of the model
branches on the device: ``layers.matmul_f32`` widens bfloat16 operands to
float32 off the card, where the card takes one product with a float32
output (``aten::mm.dtype`` / ``aten::bmm.dtype``).  The step runs inside
``layers.card_form()``, which gives that site its card branch, so the
bytes and FLOPs are the card's.  The router runs the cell's
``router_impl``, ``radix`` unless ``--router-impl`` says ``lax``: both are
plain PyTorch, so no fake tensor reaches a ``ctypes`` kernel.

``--unroll`` means nothing in eager mode (every layer runs and is counted,
as the reference's unrolled costing would); it is accepted and recorded.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import configs, tree
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps as steps_lib
from repro_torch.models import accounting, layers, stacked
from repro_torch.models.config import (ALL_SHAPES, ArchConfig, ShapeConfig,
                                       shapes_for)
from repro_torch.optim import adamw


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh=None
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins (shape and dtype, no memory) for every model
    input of this cell."""
    B, S = shape.global_batch, shape.seq_len
    sds = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    out = {}
    if shape.kind == "train":
        out["tokens"] = sds((B, S), torch.int32)
        out["labels"] = sds((B, S), torch.int32)
    elif shape.kind == "prefill":
        out["tokens"] = sds((B, S), torch.int32)
    else:  # decode: one new token against a seq_len-deep cache
        out["token"] = sds((B, 1), torch.int32)
        out["pos"] = sds((B,), torch.int32)
    if cfg.frontend_tokens:
        out["frontend"] = sds(
            (B, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model),
            cfg.dtype())
    return out


def _accum_for(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Gradient-accumulation microbatches: bound per-device activation
    memory for the big training cells.  The thresholds are the
    reference's, set for a 16 GB TPU chip, and kept so that the cells are
    the reference's (an H100 has 80 GB)."""
    if shape.kind != "train":
        return 1
    tokens = shape.seq_len * shape.global_batch
    act_cost = tokens * cfg.d_model
    if accounting.param_count(cfg) > 5e10 or act_cost > 2 ** 32:
        return 8
    if act_cost > 2 ** 31:
        return 4
    return 1


def _ssm_chunk_fix(cfg: ArchConfig, shape: ShapeConfig) -> ArchConfig:
    if cfg.ssm_state and shape.seq_len % cfg.ssm_chunk != 0:
        return dataclasses.replace(cfg, ssm_chunk=shape.seq_len)
    return cfg


class SkipCell(Exception):
    pass


def cell_config(arch: str, shape_name: str, *,
                router_impl: Optional[str] = None,
                attn_impl: Optional[str] = None,
                depth: Optional[int] = None
                ) -> Tuple[ArchConfig, ShapeConfig]:
    """The cell's config and shape; :class:`SkipCell` where the reference
    skips it (``long_500k`` for a full-attention arch)."""
    cfg = configs.get_config(arch)
    shape = {s.name: s for s in ALL_SHAPES}[shape_name]
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        raise SkipCell(f"{arch} is full-attention: long_500k skipped "
                       "(DESIGN.md §Arch-applicability)")
    cfg = _ssm_chunk_fix(cfg, shape)
    if router_impl:
        cfg = dataclasses.replace(cfg, router_impl=router_impl)
    if attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    if depth:
        pat = cfg.layer_pattern[:depth] if cfg.layer_pattern else None
        cfg = dataclasses.replace(cfg, n_layers=depth, layer_pattern=pat)
    return cfg, shape


@dataclasses.dataclass
class Cell:
    """One step ready to run: ``fn(*args)`` on this rank's placed state.
    ``donate`` indexes the arguments the step updates in place."""
    cfg: ArchConfig
    shape: ShapeConfig
    fn: Callable
    args: Tuple
    donate: Tuple[int, ...]


def make_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
              remat: str = "full", accum: Optional[int] = None,
              serve_params: bool = False, accum_bf16: bool = False,
              seq_shard_cache: bool = False) -> Cell:
    """The cell's state placed on ``mesh`` and its sharded step.  Call it
    under ``FakeTensorMode``: the state is drawn at full size.

    ``serve_params``: tensor-parallel-only parameter specs (replicated over
    the data axes), the serving layout of the reference."""
    dp_axes = mesh_lib.data_axes(mesh)
    dev = sh.mesh_device(mesh)
    wf = bool(cfg.frontend_tokens)
    params = stacked.init_params(cfg, None, dev)
    params = sh.place(params, mesh, sh.param_specs(
        mesh, params, dp=None if serve_params else "data"))
    ins = input_specs(cfg, shape, mesh)

    def batch(name):
        t = ins[name]
        t = torch.zeros(t.shape, dtype=t.dtype, device=dev)
        return sh.place(t, mesh, sh.batch_spec(mesh, t.shape, dp_axes))

    if shape.kind == "train":
        ocfg = adamw.AdamWConfig()
        opt = steps_lib.init_sharded_opt_state(params, ocfg, mesh)
        acc = accum if accum is not None else _accum_for(cfg, shape)
        fn = steps_lib.make_sharded_train_step(
            cfg, ocfg, mesh, remat=remat, accum=acc,
            accum_dtype=torch.bfloat16 if accum_bf16 else torch.float32)
        args = [params, opt, batch("tokens"), batch("labels")]
        donate = (0, 1)
    else:
        caches = stacked.init_cache(cfg, shape.global_batch, shape.seq_len,
                                    dev)
        caches = sh.place(caches, mesh, sh.cache_specs(
            mesh, caches, dp_axes, seq_shard=seq_shard_cache))
        if shape.kind == "prefill":
            fn = steps_lib.make_sharded_prefill_step(cfg, mesh,
                                                     with_frontend=wf)
            args = [params, batch("tokens"), caches]
            donate = (2,)
        else:
            fn = steps_lib.make_sharded_decode_step(cfg, mesh,
                                                    with_frontend=wf)
            args = [params, batch("token"), batch("pos"), caches]
            donate = (3,)
    if wf:
        args.append(batch("frontend"))
    return Cell(cfg, shape, fn, tuple(args), donate)


def build_cell(arch: str, shape_name: str, mesh, *, remat: str = "full",
               accum: Optional[int] = None, router_impl: Optional[str] = None,
               attn_impl: Optional[str] = None, serve_params: bool = False,
               unroll: bool = False, depth: Optional[int] = None,
               accum_bf16: bool = False, seq_shard_cache: bool = False
               ) -> Cell:
    """The named cell on ``mesh`` (:func:`cell_config`, :func:`make_cell`).
    ``unroll`` is accepted for the reference's signature: eager mode runs
    every layer.  ``depth``: override n_layers."""
    cfg, shape = cell_config(arch, shape_name, router_impl=router_impl,
                             attn_impl=attn_impl, depth=depth)
    return make_cell(cfg, shape, mesh, remat=remat, accum=accum,
                     serve_params=serve_params, accum_bf16=accum_bf16,
                     seq_shard_cache=seq_shard_cache)


def local_bytes(tree_) -> int:
    """Bytes this rank holds of a tree's tensors (a DTensor's local
    shard)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for _, t in tree.flatten_with_path(tree_):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def measure(cell: Cell) -> Tuple[rl.Counts, Dict[str, int]]:
    """One step of ``cell`` counted (:func:`roofline.count`) in the card's
    form (``layers.card_form``), with ``MemTracker`` over it: (counts,
    the reference's ``memory`` dict)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    args = [t for _, t in tree.flatten_with_path(list(cell.args))
            if isinstance(t, torch.Tensor)]
    mt = MemTracker()
    mt.track_external(*args)
    entry = sum(d["Total"] for d in mt.get_tracker_snapshot().values())
    with mt, layers.card_form():
        counts = rl.count(cell.fn, *cell.args)
    peak = sum(d["Total"] for d in mt.get_tracker_snapshot("peak").values())
    arg_b = local_bytes(list(cell.args))
    out_b = local_bytes(list(counts.result))
    alias_b = local_bytes([cell.args[i] for i in cell.donate])
    temp_b = max(peak - entry, 0)
    return counts, {"argument_bytes": arg_b, "output_bytes": out_b,
                    "temp_bytes": temp_b, "alias_bytes": alias_b,
                    "peak_est_bytes": arg_b + temp_b + out_b - alias_b}


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0:
    its collectives return at once, touching no device and no network."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None, remat: str = "full",
             accum: Optional[int] = None, router_impl: Optional[str] = None,
             attn_impl: Optional[str] = None, serve_params: bool = False,
             unroll: bool = False, depth=None, accum_bf16: bool = False,
             seq_shard_cache: bool = False, tag: str = "") -> dict:
    """One cell on the production mesh (the fake group must be up at its
    world size: :func:`fake_group`), its record printed and written."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    mesh_name = "2x16x16" if multi_pod else "16x16"
    t0 = time.monotonic()
    with FakeTensorMode():
        cell = build_cell(
            arch, shape_name, mesh, remat=remat, accum=accum,
            router_impl=router_impl, attn_impl=attn_impl,
            serve_params=serve_params, unroll=unroll, depth=depth,
            accum_bf16=accum_bf16, seq_shard_cache=seq_shard_cache)
        counts, mem = measure(cell)
    compile_s = time.monotonic() - t0
    cfg, shape = cell.cfg, cell.shape
    roof = rl.analyze(counts, chips, accounting.model_flops(cfg, shape))
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "chips": chips,
        "compile_s": round(compile_s, 1),
        "params_total": accounting.param_count(cfg),
        "params_active": accounting.active_param_count(cfg),
        "memory": mem,
        "collectives": counts.collectives,
        "roofline": roof.to_dict(),
        "unroll": unroll,
        "depth": depth,
        "remat": remat,
        "tag": tag,
    }
    print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
          f"build+step {compile_s:.0f}s, "
          f"bottleneck={roof.bottleneck}, "
          f"terms(s)=C{roof.compute_s:.4f}/M{roof.memory_s:.4f}/"
          f"X{roof.collective_s:.4f}, "
          f"peak/dev={mem['peak_est_bytes'] / 2 ** 30:.2f}GiB", flush=True)
    print(f"  memory: {mem}")
    print(f"  counts: flops={counts.flops:.3e} "
          f"bytes={counts.bytes_accessed:.3e} useful_ratio="
          f"{roof.useful_ratio:.4f} collectives="
          f"{counts.collectives['counts']}", flush=True)
    print(f"  collective bytes by site: "
          f"{dict(sorted(counts.sites.items(), key=lambda kv: -kv[1]))}",
          flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{arch}__{shape_name}__{mesh_name}{tag}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full",
                    choices=["none", "dots", "full"])
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--router-impl", default=None, choices=["radix", "lax"])
    ap.add_argument("--attn-impl", default=None, choices=["naive", "chunked"])
    ap.add_argument("--serve-params", action="store_true")
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--accum-bf16", action="store_true")
    ap.add_argument("--seq-shard-cache", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted and recorded; eager mode counts every "
                         "layer with or without it")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in configs.ARCH_IDS:
            for s in shapes_for(configs.get_config(arch)):
                cells.append((arch, s.name))
    else:
        cells.append((args.arch, args.shape))

    failures = []
    t0 = time.monotonic()
    with fake_group(512 if args.multi_pod else 256):
        for arch, shape_name in cells:
            try:
                run_cell(arch, shape_name, args.multi_pod, args.out,
                         remat=args.remat, accum=args.accum,
                         router_impl=args.router_impl,
                         attn_impl=args.attn_impl,
                         serve_params=args.serve_params, unroll=args.unroll,
                         depth=args.depth, accum_bf16=args.accum_bf16,
                         seq_shard_cache=args.seq_shard_cache, tag=args.tag)
            except SkipCell as e:
                print(f"[dryrun] SKIP {arch} x {shape_name}: {e}")
            except Exception:
                failures.append((arch, shape_name))
                print(f"[dryrun] FAIL {arch} x {shape_name}")
                traceback.print_exc()
    print(f"[dryrun] {len(cells)} cells in {time.monotonic() - t0:.1f} s",
          flush=True)
    if failures:
        raise SystemExit(f"dry-run failures: {failures}")


if __name__ == "__main__":
    main()
