"""Plain PyTorch versions of the digit-read kernel (the counterpart of
``repro.kernels.ref``).  The fused TNS kernel's plain version lives beside
its wrapper in :mod:`repro_torch.kernels.fused_tns`."""
from __future__ import annotations

import torch


def min_search_ref(planes: torch.Tensor, ascending: bool = True):
    """Plain version of :func:`repro_torch.kernels.digit_read.min_search`
    on (B, W, N) uint8 planes: (mask (B, N) bool, useful DRs (B,) int32)."""
    b, w, n = planes.shape
    shifts = torch.arange(w - 1, -1, -1, dtype=torch.int64,
                          device=planes.device)
    keys = (planes.to(torch.int64) << shifts[None, :, None]).sum(dim=1)
    target = keys.amin(dim=1) if ascending else keys.amax(dim=1)
    mask = keys == target[:, None]
    # useful DRs: walk the planes, count the mixed reads
    valid = torch.ones((b, n), dtype=torch.bool, device=planes.device)
    exc = 1 if ascending else 0
    useful = torch.zeros((b,), dtype=torch.int32, device=planes.device)
    for col in range(w):
        row = planes[:, col, :]
        hit = valid & (row == exc)
        keep = valid & (row != exc)
        mixed = hit.any(dim=1) & keep.any(dim=1)
        valid = torch.where(mixed[:, None], keep, valid)
        useful = useful + mixed.to(torch.int32)
    return mask, useful
