"""Which implementation runs, and on what.

The tensor's device decides, and nothing else: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to the kernel's plain PyTorch version.
There is no override that sends CUDA tensors to the plain version — that
would hide the kernel (the reference's ``REPRO_PALLAS`` switch has no
counterpart here).  Entry points resolve a ``device=None`` argument to the
card and raise when there is none.
"""
from __future__ import annotations

import subprocess
from typing import Optional

import torch


def uses_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no implementation for device {t.device}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Asking for the card without one raises — an entry point never
    carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def env_stamp() -> dict:
    """Provenance of a measurement: torch and CUDA versions, the card's
    name, compute capability and power limit (None without a card)."""
    stamp = {"torch_version": torch.__version__,
             "cuda_version": torch.version.cuda,
             "device_name": None, "capability": None, "power_limit": None}
    if torch.cuda.is_available():
        stamp["device_name"] = torch.cuda.get_device_name(0)
        stamp["capability"] = "sm_%d%d" % torch.cuda.get_device_capability(0)
        stamp["power_limit"] = _power_limit()
    return stamp
