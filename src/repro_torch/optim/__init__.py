"""Optimizers of the port: AdamW (``repro_torch.optim.adamw``)."""
