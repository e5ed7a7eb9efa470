"""Rank programs for the port's sharded tests.  A test module starts a
program once on every rank of a gloo group (``spawn``: one process a rank,
``torch.multiprocessing.spawn``, rendezvous through a file under the
test's temporary directory, so no port is fixed); each rank saves what it
computed and the test compares those results.  Nothing here imports JAX:
the tests run the reference in their own process.

Programs:

* ``mesh8`` (8 ranks, a (4, 2) data x model mesh): the sharded train step
  with and without int8 compression, two sharded decode steps,
  ``train(mesh=...)`` with a checkpoint's gather-save and reshard-restore,
  ``serve(mesh=...)``, ``sharded_batch``, ``elastic_remesh`` /
  ``reshard_state`` onto five survivors, DTensor placements of specs on a
  (2, 2, 2) pod x data x model mesh, and ``constrain`` on a DTensor;
* ``mesh1`` (1 rank, a (1, 1) mesh): the sharded steps, ``train`` and
  ``serve`` beside the unsharded ones in the same process;
* ``tp8`` (8 ranks, a (2, 4) data x model mesh): for each of
  :data:`TP_CASES`, a tensor-parallel train step counted by
  ``roofline.count`` (and, for the cases that count FLOPs, the unsharded
  step on the rank's rows beside it) and two sharded decode steps; the
  decode steps again against sequence-sharded caches for
  :data:`SEQ_SHARD_CASES`; and olmo's case on a (2, 2, 2) pod x data x
  model mesh.
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

OCFG = dict(lr=1e-3, warmup_steps=1)
BATCH, SEQ, CACHE_LEN = 8, 16, 32
# DTensor placements against jax's devices_indices_map on a (2, 2, 2) mesh
PLACED_SHAPE = (8, 8, 4)
PLACED_SPECS = [(("pod", "data"), None, "model"),
                ("data", "model", None),
                (None, ("pod", "data", "model"), None),
                ("model", None, "pod"),
                ()]


def spawn(program: str, world: int, tmp_path, inputs=None):
    """Run ``program`` on ``world`` ranks; returns each rank's results."""
    torch.multiprocessing.spawn(_main, nprocs=world, join=True,
                                args=(program, world, str(tmp_path), inputs))
    return [torch.load(os.path.join(tmp_path, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _main(rank, program, world, out, inputs):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out, "store"),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        res = PROGRAMS[program](rank, out, inputs)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def moe_cfg():
    """The reference's sharded-test model: qwen2-moe reduced, 8 experts."""
    from repro_torch import configs
    return dataclasses.replace(
        configs.get_config("qwen2_moe_a2_7b").reduced(), n_routed_experts=8)


def _np(t):
    from repro_torch.launch import steps
    return steps.whole(t).detach().float().numpy().copy()


def _tree_np(tree_):
    from repro_torch import tree
    return {tree.keystr(p): _np(t) for p, t in tree.flatten_with_path(tree_)}


def _local_shapes(tree_):
    from repro_torch import tree
    return {tree.keystr(p): tuple(t.to_local().shape)
            for p, t in tree.flatten_with_path(tree_)}


def _train_steps(cfg, mesh, params0, batches, compress):
    """The sharded train step from ``params0``, one step a batch."""
    from repro_torch import tree
    from repro_torch.launch import mesh as mesh_lib, sharding, steps
    from repro_torch.optim import adamw
    ocfg = adamw.AdamWConfig(**OCFG, compress=compress)
    # a replicated leaf is placed without a copy: keep params0 unchanged
    params0 = tree.map_with_path(lambda _, t: t.clone(), params0)
    params = sharding.place(params0, mesh,
                            sharding.param_specs(mesh, params0))
    state = steps.init_sharded_opt_state(params, ocfg, mesh)
    step = steps.make_sharded_train_step(cfg, ocfg, mesh)
    rows = sharding.local_rows(mesh, BATCH, mesh_lib.data_axes(mesh))
    metrics = []
    for x, y in batches:
        params, state, m = step(params, state, x[rows], y[rows])
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": _tree_np(params),
            "m": _tree_np(state.m), "v": _tree_np(state.v),
            "count": int(steps.whole(state.count)),
            "local": _local_shapes(params),
            "local_m": _local_shapes(state.m)}


def _decode_steps(cfg, mesh, params0, toks):
    """A sharded decode step at position 0 and one at position 1; the
    logits of the whole batch (gathered)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import mesh as mesh_lib, sharding, steps
    from repro_torch.models import stacked
    axes = mesh_lib.data_axes(mesh)
    params = sharding.place(params0, mesh,
                            sharding.param_specs(mesh, params0))
    caches = stacked.init_cache(cfg, BATCH, CACHE_LEN, "cpu")
    caches = sharding.place(caches, mesh,
                            sharding.cache_specs(mesh, caches, axes))
    decode = steps.make_sharded_decode_step(cfg, mesh)
    rows = sharding.local_rows(mesh, BATCH, axes)
    out = []
    for t in range(2):
        pos = torch.full((BATCH,), t, dtype=torch.int32)
        lg, caches = decode(params, toks[rows, t:t + 1], pos[rows], caches)
        where = sharding.placements(mesh, sharding.batch_spec(
            mesh, (BATCH,) + tuple(lg.shape[1:]), axes))
        out.append(DTensor.from_local(lg, mesh, where,
                                      run_check=False).full_tensor().numpy())
    return {"logits": out, "cache_local": _local_shapes(caches)}


def _train_loop(cfg, mesh, ckpt_dir):
    """``train(mesh=...)``: 2 steps straight; 1 step saving its checkpoint,
    then 1 step resumed from it."""
    from repro_torch.launch import train as trainer
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    run = trainer.TrainRun(cfg=cfg, shape=ShapeConfig("t", SEQ, BATCH,
                                                      "train"),
                           ocfg=adamw.AdamWConfig(**OCFG))
    params, state, hist = trainer.train(run, 2, mesh=mesh, log_every=100)
    crun = dataclasses.replace(run, ckpt_dir=ckpt_dir)
    _, _, head = trainer.train(crun, 1, mesh=mesh, log_every=100)
    _, cstate, tail = trainer.train(crun, 1, mesh=mesh, log_every=100)
    return {"hist": hist, "params": _tree_np(params),
            "resumed": head + tail,
            "resumed_count": int(cstate.count.full_tensor())}


def _serve(cfg, mesh):
    from repro_torch.launch import serve
    return serve.serve(cfg, BATCH, 4, 3, top_k=4, device="cpu",
                       mesh=mesh)["tokens"]


def mesh8(rank, out, inp):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import tree
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh as mesh_lib, sharding
    from repro_torch.models import shard
    from repro_torch.launch import steps
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime import faults
    res = {}
    cfg = moe_cfg()
    mesh = mesh_lib.make_host_mesh(model_parallel=2)
    res["mesh"] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names),
                   mesh_lib.data_axes(mesh))
    params0 = tree.params_from_numpy(inp["params"], "cpu")
    batches = [tuple(torch.from_numpy(a) for a in b) for b in inp["batches"]]
    for compress in (False, True):
        res[f"train_compress{compress}"] = _train_steps(
            cfg, mesh, params0, batches, compress)
    # the global norm over local shards, made whole by the reduction hook
    placed = sharding.place(params0, mesh,
                            sharding.param_specs(mesh, params0))
    res["norm"] = (float(adamw.global_norm(
        steps._locals(placed), steps.shard_reduce(mesh, placed))),
        float(adamw.global_norm(params0)))
    res["decode"] = _decode_steps(cfg, mesh, params0,
                                  torch.from_numpy(inp["toks"]))
    res["loop"] = _train_loop(cfg, mesh, os.path.join(out, "ckpt"))
    res["serve"] = _serve(cfg, mesh)

    # the rank's rows of a batch, plain and as DTensors
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    x, y = pipeline.sharded_batch(cfg, shape, 3, mesh, ("data",), seed=5)
    dx, dy = pipeline.sharded_batch(cfg, shape, 3, mesh, ("data",), seed=5,
                                    dtensor=True)
    res["batch"] = {"x": x.numpy(), "y": y.numpy(),
                    "rows": sharding.local_rows(mesh, BATCH, ("data",)),
                    "whole_x": dx.full_tensor().numpy(),
                    "whole_y": dy.full_tensor().numpy()}

    # the reference's elastic sequence: (2, 4) -> five survivors -> (5, 1)
    grid = faults.elastic_remesh(list(range(8)), model_parallel=4)
    w = torch.arange(64.0).reshape(8, 8)
    placed = faults.reshard_state({"w": w}, grid,
                                  lambda p, l: ("data", "model"))
    survivors = faults.elastic_remesh(list(range(5)), model_parallel=4)
    w2 = torch.arange(40.0).reshape(5, 8)
    fresh = faults.reshard_state({"w": w2}, survivors,
                                 lambda p, l: ("data", None))
    old = faults.reshard_state({"w": w2}, grid, lambda p, l: (None, "model"))
    moved = faults.reshard_state(old, survivors, lambda p, l: ("data", None))
    res["remesh"] = {
        "grid": dict(zip(grid.mesh_dim_names, grid.shape)),
        "placed_local": placed["w"].to_local().numpy(),
        "placed_whole": placed["w"].full_tensor().numpy(),
        "survivors": dict(zip(survivors.mesh_dim_names, survivors.shape)),
        "survivor_coord": survivors.get_coordinate(),
        "fresh_local": fresh["w"].to_local().numpy(),
        "moved_local": moved["w"].to_local().numpy()}
    if rank < 5:
        res["remesh"]["fresh_whole"] = fresh["w"].full_tensor().numpy()
        res["remesh"]["moved_whole"] = moved["w"].full_tensor().numpy()

    # specs' placements on a (2, 2, 2) mesh
    cube = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    whole = torch.arange(float(np.prod(PLACED_SHAPE))).reshape(PLACED_SHAPE)
    res["placed"] = [distribute_tensor(
        whole, cube, sharding.placements(cube, spec),
        src_data_rank=None).to_local().numpy() for spec in PLACED_SPECS]
    res["cube_coord"] = cube.get_coordinate()

    # constrain: a DTensor goes to its rule's spec, values unchanged
    act = torch.randn(BATCH, 4, 6, 8, generator=torch.Generator()
                      .manual_seed(0))
    dt = distribute_tensor(act, mesh, sharding.placements(mesh, ()),
                           src_data_rank=None)
    with shard.mesh_axes(("data",), "model", mesh):
        got = shard.constrain(dt, "act_heads")
        spec = shard.choose_spec(tuple(act.shape), "act_heads")
        plain = shard.constrain(act, "act_heads")
    def names(where):
        return [(type(p).__name__, getattr(p, "dim", None)) for p in where]

    from repro_torch.kernels import ops
    try:
        ops.topk(dt, 2)
        res["kernel_took_dtensor"] = True
    except TypeError:
        res["kernel_took_dtensor"] = False
    res["constrain"] = {
        "placements": names(got.placements),
        "want": names(sharding.placements(mesh, spec)),
        "equal": bool(torch.equal(got.full_tensor(), act)),
        "plain_is_same": plain is act}
    return res


# name -> (arch, config overrides, layers, whether the FLOPs test reads it)
# on a model axis of 4: heads that divide, KV heads that do not (their
# head_dim sharded), 6 query heads (blocks of 2, the last rank none),
# experts that divide and do not (the FFN-width fallback), MLA, the SSD
# (4 heads; a vocabulary of 250, blocks of 63), zamba2's shared block and
# cross-attention
TP_CASES = {
    "olmo": ("olmo_1b", {}, 2, True),
    "qwen3_kv2": ("qwen3_14b", {"n_kv_heads": 2}, 2, False),
    "heads6": ("olmo_1b", {"n_heads": 6, "n_kv_heads": 6, "head_dim": 16},
               2, True),
    "moe_e8": ("qwen2_moe_a2_7b", {"n_routed_experts": 8}, 2, False),
    "moe_e6": ("qwen2_moe_a2_7b", {"n_routed_experts": 6}, 2, False),
    "deepseek_v2": ("deepseek_v2_236b", {}, 2, False),
    "mamba2": ("mamba2_1_3b", {"ssm_head_dim": 32, "vocab": 250}, 2,
               False),
    "zamba2": ("zamba2_2_7b", {}, 4, False),
    "llama_vision": ("llama_3_2_vision_90b", {}, 4, False),
}


# decode against caches whose sequence the model axis shards (attention
# and MLA's latent cache)
SEQ_SHARD_CASES = ("olmo", "deepseek_v2")


def tp_cfg(name):
    from repro_torch import configs
    arch, over, layers, _ = TP_CASES[name]
    return dataclasses.replace(
        configs.get_config(arch).reduced(n_layers=layers), **over)


def _tp_case(cfg, mesh, case, count_plain):
    from repro_torch import tree
    from repro_torch.launch import mesh as mesh_lib, roofline as rl
    from repro_torch.launch import sharding, steps
    from repro_torch.optim import adamw
    ocfg = adamw.AdamWConfig(**OCFG)
    params0 = tree.params_from_numpy(case["params"], "cpu")
    axes = mesh_lib.data_axes(mesh)
    rows = sharding.local_rows(mesh, BATCH, axes)
    fe = case["frontend"]
    fe = () if fe is None else (torch.from_numpy(fe),)
    x, y = (torch.from_numpy(a) for a in case["batch"])
    params = sharding.place(
        tree.map_with_path(lambda _, t: t.clone(), params0), mesh,
        sharding.param_specs(mesh, params0))
    state = steps.init_sharded_opt_state(params, ocfg, mesh)
    step = steps.make_sharded_train_step(cfg, ocfg, mesh)
    c = rl.count(step, params, state, x[rows], y[rows],
                 *(f[rows] for f in fe))
    params, state, m = c.result
    res = {"metrics": {k: float(v) for k, v in m.items()},
           "flops": c.flops, "collectives": c.collectives["counts"],
           "sites": c.sites, "params": _tree_np(params)}
    if count_plain:
        p = tree.map_with_path(lambda _, t: t.clone(), params0)
        res["plain_flops"] = rl.count(
            steps.make_train_step(cfg, ocfg), p, adamw.init(p, ocfg),
            x[rows], y[rows], *(f[rows] for f in fe)).flops
    res["decode"] = _tp_decode(cfg, mesh, case, params0)
    return res


def _tp_decode(cfg, mesh, case, params0, seq_shard=False):
    """Two sharded decode steps against the cache (laid out by
    ``cache_specs``, the sequence over the model axis with
    ``seq_shard``), the whole batch's logits."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import mesh as mesh_lib, sharding, steps
    from repro_torch.models import stacked
    axes = mesh_lib.data_axes(mesh)
    rows = sharding.local_rows(mesh, BATCH, axes)
    fe = case["frontend"]
    fe = () if fe is None else (torch.from_numpy(fe),)
    params = sharding.place(params0, mesh,
                            sharding.param_specs(mesh, params0))
    caches = stacked.init_cache(cfg, BATCH, CACHE_LEN, "cpu")
    caches = sharding.place(caches, mesh, sharding.cache_specs(
        mesh, caches, axes, seq_shard=seq_shard))
    decode = steps.make_sharded_decode_step(cfg, mesh, with_frontend=True)
    toks = torch.from_numpy(case["toks"])
    out = []
    for t in range(2):
        pos = torch.full((BATCH,), t, dtype=torch.int32)
        lg, caches = decode(params, toks[rows, t:t + 1], pos[rows], caches,
                            *(f[rows] for f in fe))
        where = sharding.placements(mesh, sharding.batch_spec(
            mesh, (BATCH,) + tuple(lg.shape[1:]), axes))
        out.append(DTensor.from_local(
            lg, mesh, where, run_check=False).full_tensor().numpy())
    return out


def tp8(rank, out, inp):
    """Tensor-parallel compute on a (2, 4) data x model mesh, and olmo's
    case again on a (2, 2, 2) pod x data x model mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_host_mesh(model_parallel=4)
    res = {"mesh": (tuple(mesh.shape), tuple(mesh.mesh_dim_names)),
           "coord": tuple(mesh.get_coordinate())}
    for name, case in inp.items():
        res[name] = _tp_case(tp_cfg(name), mesh, case, TP_CASES[name][3])
    from repro_torch import tree
    for name in SEQ_SHARD_CASES:
        res[f"{name}_seq"] = {"decode": _tp_decode(
            tp_cfg(name), mesh, inp[name],
            tree.params_from_numpy(inp[name]["params"], "cpu"),
            seq_shard=True)}
    cube = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    res["olmo_pod"] = _tp_case(tp_cfg("olmo"), cube, inp["olmo"], False)
    if rank:                         # every rank holds the same params
        for r in res.values():
            if isinstance(r, dict):
                r.pop("params", None)
    return res


def mesh1(rank, out, inp):
    """World 1: the sharded paths beside the unsharded ones."""
    from repro_torch import tree
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh as mesh_lib, steps
    from repro_torch.launch import train as trainer
    from repro_torch.models import stacked
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    res = {}
    cfg = moe_cfg()
    mesh = mesh_lib.make_host_mesh()
    res["mesh"] = tuple(mesh.shape)
    params0 = stacked.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    batches = [pipeline.host_batch(cfg, shape, s, device="cpu")
               for s in range(2)]
    for compress in (False, True):
        ocfg = adamw.AdamWConfig(**OCFG, compress=compress)
        p = tree.map_with_path(lambda _, t: t.clone(), params0)
        s = adamw.init(p, ocfg)
        step = steps.make_train_step(cfg, ocfg)
        metrics = []
        for x, y in batches:
            p, s, m = step(p, s, x, y)
            metrics.append({k: float(v) for k, v in m.items()})
        res[f"plain_compress{compress}"] = {
            "metrics": metrics, "params": _tree_np(p), "m": _tree_np(s.m),
            "v": _tree_np(s.v)}
        res[f"sharded_compress{compress}"] = _train_steps(
            cfg, mesh, params0, batches, compress)

    toks = batches[0][0]
    caches = stacked.init_cache(cfg, BATCH, CACHE_LEN, "cpu")
    decode = steps.make_decode_step(cfg)
    logits = []
    for t in range(2):
        pos = torch.full((BATCH,), t, dtype=torch.int32)
        lg, caches = decode(params0, toks[:, t:t + 1], pos, caches)
        logits.append(lg.numpy())
    res["plain_decode"] = logits
    res["sharded_decode"] = _decode_steps(cfg, mesh, params0, toks)

    run = trainer.TrainRun(cfg=cfg, shape=shape,
                           ocfg=adamw.AdamWConfig(**OCFG))
    p, _, hist = trainer.train(run, 2, device="cpu", log_every=100)
    res["plain_loop"] = {"hist": hist, "params": _tree_np(p)}
    res["sharded_loop"] = _train_loop(cfg, mesh, os.path.join(out, "ckpt"))
    res["plain_serve"] = _serve(cfg, None)
    res["sharded_serve"] = _serve(cfg, mesh)
    return res


PROGRAMS = {"mesh8": mesh8, "mesh1": mesh1, "tp8": tp8}
