"""Launch layer of the port: the serving CLI (``python -m
repro_torch.launch.serve``), the training driver (``python -m
repro_torch.launch.train``) and the step builders they run."""
