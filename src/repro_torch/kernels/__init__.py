"""Hand-written CUDA kernels for Hopper (``csrc/``), each wrapped beside
its plain PyTorch version.  The tensor's device picks the implementation
(:mod:`repro_torch.kernels.backend`)."""
