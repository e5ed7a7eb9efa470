"""Sort-engine front door of the port: one ``sort()`` over the port's own
engine registry.

    from repro_torch import sort
    res = sort.sort(x, engine="fused-tns", k=4)   # CUDA kernel, on the card
    sort.engines()                                # the registry
"""
from repro_torch.sort.api import engines, sort
from repro_torch.sort.registry import (EngineSpec, available_engines,
                                       get_engine, register)
from repro_torch.sort.result import SortResult

__all__ = [
    "EngineSpec", "SortResult", "available_engines", "engines",
    "get_engine", "register", "sort",
]
