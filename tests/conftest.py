import os


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (runs the port's hand-written kernels); "
        "skips without one")
    # an xdist worker shares the usable cores with its siblings: it gives
    # torch's intra-op pool its share, so that n workers do not run n
    # pools of every core each
    if os.environ.get("PYTEST_XDIST_WORKER"):
        import torch
        usable = len(os.sched_getaffinity(0))
        workers = int(os.environ["PYTEST_XDIST_WORKER_COUNT"])
        torch.set_num_threads(max(1, usable // workers))
