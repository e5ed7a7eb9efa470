"""Train / prefill / decode step builders over the stacked model: the port
of ``repro.launch.steps``.  PyTorch runs them eagerly, so there is nothing
to compile.

A train step is two halves, so that a driver can retry the first alone:
:meth:`TrainStep.grads` (forward and backward, nothing changed) and
:meth:`TrainStep.apply` (the AdamW update, in place).  Calling the step
runs both, as the reference's jitted step does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.models import stacked
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
