"""Checkpoints of a training state (``repro_torch.checkpoint.manager``)."""
