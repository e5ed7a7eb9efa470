"""Parameter / FLOP accounting without allocating any memory: the port of
``repro.models.accounting``.  The shapes come from the port's
``transformer.init_params`` on the meta device (the counterpart of
``jax.eval_shape``)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import tree
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig, ShapeConfig


def param_shapes(cfg: ArchConfig) -> Dict:
    """The layerwise param tree as meta tensors: shapes and dtypes only."""
    return T.init_params(cfg, None, torch.device("meta"))


def _leaves(shapes):
    return [t for _, t in tree.flatten_with_path(shapes)]


def param_count(cfg: ArchConfig) -> int:
    return sum(int(t.numel()) for t in _leaves(param_shapes(cfg)))


def param_bytes(cfg: ArchConfig) -> int:
    return sum(int(t.numel()) * t.element_size()
               for t in _leaves(param_shapes(cfg)))


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters touched per token: MoE counts only top-k routed experts
    (+ shared), everything else counts fully."""
    total = param_count(cfg)
    if not cfg.moe:
        return total
    shapes = param_shapes(cfg)
    routed = 0
    for blk in shapes["blocks"]:
        if "moe" in blk:
            routed += int(blk["moe"]["wi"].numel()) + int(
                blk["moe"]["wo"].numel())
    E, k = cfg.n_routed_experts, cfg.moe_top_k
    return total - routed + int(routed * k / E)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6*N(active)*D for training, 2*N(active)*D for a
    forward-only serve step (D = tokens processed)."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    # decode: one new token per sequence
    return 2.0 * n * shape.global_batch
