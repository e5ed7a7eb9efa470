"""Train / prefill / decode step builders over the stacked model: the port
of ``repro.launch.steps``.  PyTorch runs them eagerly, so there is nothing
to compile.

A train step is two halves, so that a driver can retry the first alone:
:meth:`TrainStep.grads` (forward and backward, nothing changed) and
:meth:`TrainStep.apply` (the AdamW update, in place).  Calling the step
runs both, as the reference's jitted step does.

Under a mesh (:class:`ShardedTrainStep`, :func:`make_sharded_prefill_step`,
:func:`make_sharded_decode_step`) the state is sharded and the compute is
data-parallel over the data axes and tensor-parallel over the model axis,
as the reference's GSPMD-partitioned steps.  Every leaf of the parameters,
the optimizer state and the caches is a DTensor placed by
``launch.sharding``'s spec for it.  Each rank runs the steps above on
plain local tensors: its rows of the batch, its shards of the parameters
(each leaf gathered over the data axes only while its layer runs, its
model-axis shard kept: ``shard.gathered``) and of the caches (read and
written in place, in their stored layout).  Along the model axis each
rank computes its own heads, FFN columns, experts and vocabulary block
(``models/shard.py``).  The backward of a layer's gather averages each
gradient over the data axes straight onto its leaf's shard (a
reduce-scatter), and AdamW runs in place on the local shards, its
whole-leaf reductions made whole over the ranks.  The kernels never see a
DTensor.  On a mesh of one rank every collective is the identity, and the
steps equal the unsharded ones bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch import tree
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.models import shard, stacked
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw


class TrainStep:
    """(params, opt_state, tokens, labels[, frontend]) -> (params,
    opt_state, metrics {loss, nll, aux, grad_norm, lr}).  ``accum`` > 1
    takes the batch as that many microbatches of consecutive rows, summing
    their gradients in ``accum_dtype`` (``torch.bfloat16`` halves the
    buffer; the optimizer still keeps float32 ``m`` / ``v``)."""

    def __init__(self, cfg: ArchConfig, ocfg: adamw.AdamWConfig,
                 remat: str = "full", accum: int = 1,
                 accum_dtype: torch.dtype = torch.float32):
        self.cfg, self.ocfg = cfg, ocfg
        self.remat, self.accum, self.accum_dtype = remat, accum, accum_dtype

    def _value_and_grad(self, params, tokens, labels, frontend):
        """(loss, metrics, {path: gradient}): the gradient of the loss with
        respect to detached aliases of the parameters' leaves, so the
        caller's tensors never join a graph."""
        paths = [path for path, _ in tree.flatten_with_path(params)]
        live = tree.map_with_path(
            lambda _, t: t.detach().requires_grad_(True), params)
        leaves = [t for _, t in tree.flatten_with_path(live)]
        with torch.enable_grad():
            loss, metrics = stacked.loss_fn(live, self.cfg, tokens, labels,
                                            frontend=frontend,
                                            remat=self.remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {path: torch.zeros_like(p) if g is None else g
                 for path, p, g in zip(paths, leaves, grads)}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def grads(self, params, tokens: torch.Tensor, labels: torch.Tensor,
              frontend: Optional[torch.Tensor] = None
              ) -> Tuple[Dict, torch.Tensor, Dict]:
        """The forward and backward half: (grads tree, loss, metrics);
        nothing is changed, so it may be retried."""
        if self.accum == 1:
            loss, metrics, g = self._value_and_grad(params, tokens, labels,
                                                    frontend)
        else:
            B = tokens.shape[0]
            assert B % self.accum == 0
            mb = B // self.accum
            g, l_sum = None, 0.0
            for i in range(self.accum):
                rows = slice(i * mb, (i + 1) * mb)
                l, _, gi = self._value_and_grad(
                    params, tokens[rows], labels[rows],
                    None if frontend is None else frontend[rows])
                if g is None:
                    g = {k: x.to(self.accum_dtype) for k, x in gi.items()}
                else:
                    for k, x in gi.items():
                        g[k].add_(x.to(self.accum_dtype))
                l_sum = l_sum + l
                del gi
            if self.accum_dtype == torch.float32:
                g = {k: x.div_(self.accum) for k, x in g.items()}
            else:
                g = {k: x.float() / self.accum for k, x in g.items()}
            loss = l_sum / self.accum
            metrics = {"nll": loss, "aux": torch.zeros(
                (), dtype=torch.float32, device=loss.device)}
        return tree.map_with_path(lambda path, _: g[path], params), loss, \
            metrics

    def apply(self, params, opt_state: adamw.OptState, grads,
              loss: torch.Tensor, metrics: Dict):
        """The update half: AdamW on ``grads``, params and state changed in
        place.  Returns (params, opt_state, metrics)."""
        params, opt_state, om = adamw.update(params, grads, opt_state,
                                             self.ocfg)
        return params, opt_state, {"loss": loss, **metrics, **om}

    def __call__(self, params, opt_state: adamw.OptState,
                 tokens: torch.Tensor, labels: torch.Tensor,
                 frontend: Optional[torch.Tensor] = None):
        grads, loss, metrics = self.grads(params, tokens, labels, frontend)
        return self.apply(params, opt_state, grads, loss, metrics)


def make_train_step(cfg: ArchConfig, ocfg: adamw.AdamWConfig,
                    remat: str = "full", accum: int = 1,
                    accum_dtype: torch.dtype = torch.float32) -> TrainStep:
    """The train step (:class:`TrainStep`).  It takes the frontend stub as
    its last argument for the VLM and audio archs, where the reference's
    builder asks for ``with_frontend=True``."""
    return TrainStep(cfg, ocfg, remat=remat, accum=accum,
                     accum_dtype=accum_dtype)


def make_prefill_step(cfg: ArchConfig, with_frontend: bool = False):
    """(params, tokens, caches[, frontend]) -> (logits, caches): batched
    prefill through the serving path (writes the KV / SSM caches).  The
    frontend argument is taken when ``with_frontend``."""

    def prefill(params, tokens, caches, frontend=None):
        logits, caches, _ = stacked.forward(params, cfg, tokens,
                                            frontend=frontend, caches=caches)
        return logits, caches

    if with_frontend:
        return prefill
    return lambda p, t, c: prefill(p, t, c, None)


def make_decode_step(cfg: ArchConfig, with_frontend: bool = False):
    """(params, token (B,1), pos (B,), caches[, frontend]) -> (logits,
    caches): one serving step against the cache."""

    def decode(params, token, pos, caches, frontend=None):
        positions = pos[:, None].to(torch.int32)
        logits, caches, _ = stacked.forward(params, cfg, token,
                                            frontend=frontend,
                                            positions=positions,
                                            caches=caches)
        return logits, caches

    if with_frontend:
        return decode
    return lambda p, t, z, c: decode(p, t, z, c, None)


# ---------------------------------------------------------------------------
# Under a mesh
# ---------------------------------------------------------------------------


def whole(t):
    """A leaf's whole value: a DTensor gathered over its mesh (on every
    rank of it), a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _local(t):
    """This rank's shard of a DTensor (the tensor it holds, so writes to it
    land in the DTensor); anything else as it is."""
    if isinstance(t, DTensor):
        with torch.no_grad():
            return t.to_local()
    return t


def _locals(tree_):
    return tree.map_with_path(lambda _, t: _local(t), tree_)


def shard_reduce(mesh, like) -> adamw.Reduce:
    """AdamW's reduction hook for a tree laid out as ``like`` (DTensors on
    ``mesh``): a value taken over a leaf's local shard, combined over the
    mesh dims that shard the leaf (sum or max), is the whole leaf's."""
    names = mesh.mesh_dim_names
    spread = {path: [names[i] for i, pl in enumerate(t.placements)
                     if isinstance(pl, Shard) and mesh.shape[i] > 1]
              for path, t in tree.flatten_with_path(like)}
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

    def reduce(path, value, op):
        for axis in spread[path]:
            dist.all_reduce(value, op=ops[op], group=mesh.get_group(axis))
        return value

    return reduce


def _in_mesh(mesh) -> shard.mesh_axes:
    return shard.mesh_axes(mesh_lib.data_axes(mesh),
                           mesh_lib.model_axis(mesh), mesh)


def _layout(mesh, params) -> Dict:
    """{path: ``shard.data_plan``} of every DTensor leaf of ``params``."""
    axes = mesh_lib.data_axes(mesh)
    return {path: shard.data_plan(mesh, t, axes)
            for path, t in tree.flatten_with_path(params)
            if isinstance(t, DTensor)}


class ShardedTrainStep:
    """The train step over a mesh: (params, opt_state, tokens, labels[,
    frontend]) -> (params, opt_state, metrics), params and the optimizer
    state's leaves DTensors (changed in place), the batch this rank's rows
    (plain tensors, or DTensors of the whole batch).  The metrics are the
    whole batch's: the loss and ``nll`` averaged over the data ranks, the
    routers' ``aux`` already global (``shard.data_mean``), ``grad_norm``
    over every leaf's whole value."""

    def __init__(self, cfg: ArchConfig, ocfg: adamw.AdamWConfig, mesh,
                 remat: str = "full", accum: int = 1,
                 accum_dtype: torch.dtype = torch.float32):
        self.step = TrainStep(cfg, ocfg, remat=remat, accum=accum,
                              accum_dtype=accum_dtype)
        self.mesh = mesh

    def grads(self, params, tokens, labels, frontend=None):
        """The forward and backward half: (grads, loss, metrics), the grads
        DTensors placed as the params are; nothing is changed.  Each leaf
        is gathered over the data axes where its layer runs, and its
        gradient comes back averaged over them onto its own shard."""
        with _in_mesh(self.mesh), shard.placed(_layout(self.mesh, params)):
            g, loss, metrics = self.step.grads(
                _locals(params), _local(tokens), _local(labels),
                _local(frontend))
            loss = shard.data_mean(loss)
            metrics = dict(metrics, nll=shard.data_mean(metrics["nll"]))
        g = tree.map_with_path(
            lambda path, p: DTensor.from_local(
                tree.at(g, path), self.mesh, p.placements, run_check=False),
            params)
        return g, loss, metrics

    def apply(self, params, opt_state: adamw.OptState, grads, loss, metrics):
        """The update half: AdamW on every rank's local shards, in place."""
        local = adamw.OptState(_locals(opt_state.m), _locals(opt_state.v),
                               _locals(opt_state.err),
                               _local(opt_state.count))
        _, new, om = adamw.update(_locals(params), _locals(grads), local,
                                  self.step.ocfg,
                                  shard_reduce(self.mesh, params))
        count = new.count
        if isinstance(opt_state.count, DTensor):
            count = DTensor.from_local(count, self.mesh,
                                       opt_state.count.placements,
                                       run_check=False)
        return params, opt_state._replace(count=count), \
            {"loss": loss, **metrics, **om}

    def __call__(self, params, opt_state, tokens, labels, frontend=None):
        grads, loss, metrics = self.grads(params, tokens, labels, frontend)
        return self.apply(params, opt_state, grads, loss, metrics)


def make_sharded_train_step(cfg: ArchConfig, ocfg: adamw.AdamWConfig, mesh,
                            remat: str = "full", accum: int = 1,
                            accum_dtype: torch.dtype = torch.float32
                            ) -> ShardedTrainStep:
    """The train step over ``mesh`` (:class:`ShardedTrainStep`).  With
    ``accum`` > 1 each rank takes its own rows as that many microbatches,
    so the routers' load-balance loss groups rows unlike the unsharded
    step's microbatches (the dense loss is the same)."""
    return ShardedTrainStep(cfg, ocfg, mesh, remat=remat, accum=accum,
                            accum_dtype=accum_dtype)


def init_sharded_opt_state(params, ocfg: adamw.AdamWConfig, mesh
                           ) -> adamw.OptState:
    """AdamW's state for params laid out on ``mesh``: m, v (and err) zeros
    of each local shard, placed as the param is, with no whole-leaf
    temporary; ``count`` replicated."""
    local = adamw.init(_locals(params), ocfg)

    def like(tr):
        return tree.map_with_path(
            lambda path, t: DTensor.from_local(
                t, mesh, tree.at(params, path).placements, run_check=False),
            tr)

    return adamw.OptState(like(local.m), like(local.v), like(local.err),
                          DTensor.from_local(local.count, mesh,
                                             sharding.placements(mesh, ()),
                                             run_check=False))


def _seq_sharded(mesh, caches) -> bool:
    """Whether the model axis shards the caches' sequence dim
    (``sharding.cache_specs(seq_shard=True)``)."""
    model = list(mesh.mesh_dim_names).index(mesh_lib.model_axis(mesh))
    for path, c in tree.flatten_with_path(caches):
        pl = c.placements[model]
        seq = {"k": 3, "v": 3, "c_kv": 2, "k_rope": 2}.get(path[-1])
        if isinstance(pl, Shard) and seq and pl.dim == c.dim() - seq:
            return True
    return False


def _serving_step(mesh, cfg: ArchConfig, fn):
    """``fn(params, caches, *rows)`` run on this rank's local shards: the
    params gathered over the data axes layer by layer, the caches read and
    written in place in their stored layout, this rank's rows of the other
    inputs.  Returns (the last position's logits of the rank's rows over
    the whole vocabulary (B, 1, V), caches)."""

    def step(params, caches, *inputs):
        with _in_mesh(mesh), shard.placed(_layout(mesh, params),
                                          _seq_sharded(mesh, caches)):
            logits, _ = fn(_locals(params), _locals(caches),
                           *map(_local, inputs))
            logits = T.last_logits(logits, cfg.vocab)
        return logits, caches

    return step


def make_sharded_prefill_step(cfg: ArchConfig, mesh,
                              with_frontend: bool = False):
    """(params, tokens, caches[, frontend]) -> (logits, caches) over
    ``mesh``: the caches DTensors placed by ``sharding.cache_specs``, the
    tokens (and frontend) this rank's rows or DTensors of the whole batch,
    the logits the last position's (B, 1, V) of this rank's rows."""
    prefill = make_prefill_step(cfg, with_frontend=True)
    step = _serving_step(mesh, cfg,
                         lambda p, c, t, fe: prefill(p, t, c, fe))

    def run(params, tokens, caches, frontend=None):
        return step(params, caches, tokens, frontend)

    if with_frontend:
        return run
    return lambda p, t, c: run(p, t, c, None)


def make_sharded_decode_step(cfg: ArchConfig, mesh,
                             with_frontend: bool = False):
    """(params, token (B,1), pos (B,), caches[, frontend]) -> (logits,
    caches) over ``mesh``, laid out as :func:`make_sharded_prefill_step`'s."""
    decode = make_decode_step(cfg, with_frontend=True)
    step = _serving_step(mesh, cfg,
                         lambda p, c, t, z, fe: decode(p, t, z, c, fe))

    def run(params, token, pos, caches, frontend=None):
        return step(params, caches, token, pos, frontend)

    if with_frontend:
        return run
    return lambda p, t, z, c: run(p, t, z, c, None)
