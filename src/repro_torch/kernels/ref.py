"""Plain PyTorch versions of the digit-read, top-k, key-pack and
pruned-matmul kernels (the counterpart of ``repro.kernels.ref``).  The
fused TNS kernel's plain version lives beside its wrapper in
:mod:`repro_torch.kernels.fused_tns`.  Keys are int32 tensors holding
uint32 key bits (:mod:`repro_torch.core.bitplane`)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bitplane as bp
from repro_torch.core import radix_select as rs


def topk_keys_ref(keys: torch.Tensor, k: int, r: int = 4):
    """Plain version of :func:`repro_torch.kernels.radix_topk.topk_keys`:
    (min keys, first-tie indices), each (B, k) int32, of the k smallest
    32-bit keys per row, via the throughput engine's iterated min-search.
    It walks the kernel's digit shifts ``32-r, 32-2r, ..., >= 0``, so for
    an ``r`` that does not divide 32 the low ``32 mod r`` key bits are
    never read and the returned keys lack them, as the reference kernel's
    do; for every other ``r`` the keys are those of
    :func:`repro_torch.core.radix_select.extract_topk`."""
    return rs.min_search_rounds(keys, k, r, 32)


def topk_keys_select_ref(keys: torch.Tensor, k: int, r: int = 4,
                         stats: Optional[dict] = None):
    """The same (min keys, indices) as :func:`topk_keys_ref`, by the radix
    select that the CUDA kernel runs on rows past its warp form, step for
    step on each row: keys masked to the bits the digit walk reads; 8-bit
    histogram passes, MSB first, over the keys whose higher digits equal
    the prefix found so far, until the count at the prefix is exactly what
    is still needed or the last digit is read; every key below the prefix
    and the first ``k - c_less`` keys at it in index order; a sort of the
    (key, index) pairs.  ``stats``, if given, gains ``passes``, the
    histogram passes summed over the rows."""
    read_mask = ~((1 << (32 % r)) - 1) & 0xFFFFFFFF
    lane = torch.arange(keys.shape[1], device=keys.device)
    out_key, out_idx, passes = [], [], 0
    for row in (keys.long() & read_mask).unbind(0):
        prefix, need, c_less = 0, k, 0
        for shift in (24, 16, 8, 0):
            active = (torch.ones_like(row, dtype=torch.bool) if shift == 24
                      else (row >> (shift + 8)) == prefix)
            hist = torch.bincount((row[active] >> shift) & 255, minlength=256)
            incl = torch.cumsum(hist, 0)
            digit = int(torch.searchsorted(incl, need))   # incl >= need
            below = int(incl[digit] - hist[digit])
            prefix = (prefix << 8) | digit
            c_less += below
            need -= below
            at = int(hist[digit])
            passes += 1
            if at == need:
                break
        hi = row >> shift
        at_prefix = hi == prefix
        take = (hi < prefix) | (
            at_prefix if at == need
            else at_prefix & (torch.cumsum(at_prefix, 0) <= need))
        # the (key << 32 | index) words in unsigned order: the taken lanes
        # ascend, so a stable sort by key orders equal keys by index
        kept, order = torch.sort(row[take], stable=True)
        out_key.append(kept)
        out_idx.append(lane[take][order])
    if stats is not None:
        stats["passes"] = stats.get("passes", 0) + passes
    mk = torch.stack(out_key)
    mk = mk - ((mk >> 31) << 32)                 # unsigned -> int32 bits
    return mk.to(torch.int32), torch.stack(out_idx).to(torch.int32)


def min_search_ref(planes: torch.Tensor, ascending: bool = True):
    """Plain version of :func:`repro_torch.kernels.digit_read.min_search`
    on (B, W, N) uint8 planes: (mask (B, N) bool, useful DRs (B,) int32).

    It is the walk that ``repro.kernels.digit_read._dr_kernel`` runs, and
    its counterpart is that kernel (``repro.kernels.digit_read.min_search``):
    column by column, a lane is a hit where its byte equals the excluded
    digit (1 ascending, 0 descending) and kept elsewhere; a read with both
    hits and kept lanes among the survivors is mixed, counts as a useful
    DR and leaves the kept lanes.  The mask is the survivor set.  On 0/1
    planes it marks every element attaining the min (the max when
    descending); on other bytes it follows the walk, not the planes read
    as numbers, as the reference kernel does."""
    b, w, n = planes.shape
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
    return valid, useful


def pack_keys_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.bitplane_pack.pack_keys`:
    uint32 sort keys (int32 bits) of float32 / bfloat16 / int32 input;
    bfloat16 is widened to float32 first (exact)."""
    if x.dtype == torch.bfloat16:
        x = x.float()
    return bp.sort_key_t(x)[0]


def unpack_keys_f32_ref(keys: torch.Tensor) -> torch.Tensor:
    return bp.key_to_value_t(keys, torch.float32)


def pruned_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                      keep_mask: torch.Tensor) -> torch.Tensor:
    """``(x * keep_mask) @ w``: the masked input in x's dtype, the product
    accumulated in float32, the result cast back to x's dtype."""
    xm = x * keep_mask.to(x.dtype)[None, :]
    return torch.matmul(xm.float(), w.float()).to(x.dtype)
