"""Sort-engine front door of the port: one ``sort()`` over the port's own
engine registry.

    from repro_torch import sort
    res = sort.sort(x, k=4)                       # the tns machine (card)
    res = sort.sort(x, engine="fused-tns", k=4)   # CUDA kernel, on the card
    res = sort.sort(xb, engine="radix")           # throughput, batched
    vals, idx = sort.topk(logits, 6, engine="fused-topk")   # in-model
    sort.engines()                                # the registry
"""
from repro_torch.sort.api import (TOPK_ENGINES, engines, prune_mask, sort,
                                  topk, topk_mask)
from repro_torch.sort.registry import (EngineSpec, available_engines,
                                       get_engine, register)
from repro_torch.sort.result import SortResult

__all__ = [
    "EngineSpec", "SortResult", "TOPK_ENGINES", "available_engines",
    "engines", "get_engine", "prune_mask", "register", "sort", "topk",
    "topk_mask",
]
