"""PyTorch/CUDA port of the sort-in-memory system (the JAX package
``repro`` is the reference it is held against).

Layout mirrors ``repro``: ``core/`` (bit-plane encoding, the event-driven
TNS oracle, the Table-S5 cost model), ``kernels/`` (hand-written CUDA
kernels for Hopper, each beside its plain PyTorch version) and ``sort/``
(engine registry + ``sort()`` facade).  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""
