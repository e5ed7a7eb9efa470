"""Throughput-mode comparison-free selection, in plain PyTorch on the
tensor's device: the port of the reference's ``repro.core.radix_select``.

The paper's digit-read machinery vectorised over a batch:

* a digit read over radix-2^r digits == a digit slice of the
  order-preserving sort key (the multi-level strategy, §2.3.3);
* the number-exclusion register == a boolean lane mask;
* the "all 0's / all 1's" periphery == presence / histogram reductions.

Primitives, batched over leading dims:

* ``min_mask`` / ``extract_topk``: exact top-k with indices by iterated
  digit-plane min-search (the router path; its fused kernel is
  :mod:`repro_torch.kernels.radix_topk`);
* ``topk_threshold_mask``: histogram radix-select of the top-k mask
  (threshold + first ties), for vocab-sized axes and in-situ pruning;
* ``radix_sort_keys``: full LSB-first counting radix sort (stable).

Keys are int32 tensors holding unsigned key bits (the convention of
:mod:`repro_torch.core.bitplane`), so each function takes the key width
(8, 16 or 32; 32 when not given) where the reference reads it from the
key's dtype.  The reference computes all of this outside any Pallas
kernel, so plain torch ops are the port too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import bitplane as bp


def _key_width(keys: torch.Tensor, width: Optional[int]) -> int:
    if keys.dtype != torch.int32:
        raise ValueError(f"keys must be int32 key bits, got {keys.dtype}")
    if width is None:
        return 32
    if width not in (8, 16, 32):
        raise ValueError(f"key width must be 8, 16 or 32, got {width}")
    return width


def _check_radix(w: int, r: int) -> None:
    if r < 1 or w % r:
        raise ValueError(f"radix 2^{r} does not divide a {w}-bit key")


def _digit(keys: torch.Tensor, shift: int, r: int) -> torch.Tensor:
    return ((keys >> shift) & ((1 << r) - 1)).to(torch.int32)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True on the last axis (0 when none), int32."""
    return mask.to(torch.uint8).argmax(dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Exact small-N top-k by iterated digit-plane min search (router path).
# ---------------------------------------------------------------------------


def _digit_walk(keys, valid, r: int, w: int):
    """One min-search over the digits at shifts ``w-r, w-2r, ..., >= 0``:
    (mask of the survivors, min key rebuilt from the chosen digits).  For
    an ``r`` that does not divide ``w`` the low ``w mod r`` bits are never
    read, as in the reference's top-k kernel."""
    vals = torch.arange(1 << r, dtype=torch.int32, device=keys.device)
    min_key = torch.zeros(keys.shape[:-1], dtype=torch.int64,
                          device=keys.device)
    for shift in range(w - r, -1, -r):
        dig = _digit(keys, shift, r)
        # presence[v] = any(valid & dig==v): the DR + all-0s/1s periphery
        eq = dig[..., None] == vals                          # (..., N, R)
        presence = (valid[..., None] & eq).any(dim=-2)       # (..., R)
        dmin = _first_true(presence)                         # first present
        valid = valid & (dig == dmin[..., None])
        min_key = min_key | (dmin.to(torch.int64) << shift)
    return valid, min_key


def min_mask(keys: torch.Tensor, valid: torch.Tensor, r: int = 4, *,
             width: Optional[int] = None) -> torch.Tensor:
    """Mask of elements equal to min(keys[valid]) on the last axis: one
    full min-search of the paper (MSB->LSB digit reads with number
    exclusion); ``r`` is the multi-level cell width."""
    w = _key_width(keys, width)
    _check_radix(w, r)
    return _digit_walk(keys, valid, r, w)[0]


def min_search_rounds(keys, k: int, r: int, w: int):
    """k rounds of min-search with first-tie exclusion: (min keys rebuilt
    from the walked digits, as int32 bits; indices), each (..., k)."""
    n = keys.shape[-1]
    lane = torch.arange(n, device=keys.device)
    valid = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    idxs, mins = [], []
    for _ in range(k):
        m, min_key = _digit_walk(keys, valid, r, w)
        chosen = _first_true(m)                              # first of ties
        idxs.append(chosen)
        mins.append(min_key)
        valid = valid & (lane != chosen[..., None])
    mk = torch.stack(mins, dim=-1)
    mk = mk - ((mk >> 31) << 32)                 # unsigned -> int32 bits
    return mk.to(torch.int32), torch.stack(idxs, dim=-1)


def extract_topk(keys: torch.Tensor, k: int, r: int = 4, *,
                 width: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (keys, indices) of the k smallest along the last axis, emitted
    in ascending order — iterated comparison-free min search."""
    w = _key_width(keys, width)
    _check_radix(w, r)
    _, idx = min_search_rounds(keys, k, r, w)
    return torch.gather(keys, -1, idx.long()), idx


def gather_values(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` gathered at ``idx`` along the last axis, bit for bit: a
    bfloat16 gather writes every NaN as 0xFFFF, so bfloat16 goes through
    its int16 view."""
    if x.dtype == torch.bfloat16:
        return torch.gather(x.view(torch.int16), -1,
                            idx.long()).view(torch.bfloat16)
    return torch.gather(x, -1, idx.long())


def topk_values(x: torch.Tensor, k: int, r: int = 4,
                largest: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.topk``-compatible comparison-free top-k (values desc when
    ``largest``); indices int32."""
    keys, w = bp.sort_key_t(x)
    if largest:
        keys = bp.flip_key_t(keys, w)
    _, idx = extract_topk(keys, k, r=r, width=w)
    return gather_values(x, idx), idx


# ---------------------------------------------------------------------------
# Histogram radix-select threshold mask (vocab-scale path).
# ---------------------------------------------------------------------------


def topk_threshold_mask(keys: torch.Tensor, k, r: int = 8,
                        smallest: bool = True, *,
                        width: Optional[int] = None) -> torch.Tensor:
    """Boolean mask selecting exactly k elements: all strictly better than
    the threshold key plus the first ties in index order.  ``k`` may be a
    0-d tensor (run-time tunable sparsity, §3.2).  O(W/r) histogram
    passes."""
    w = _key_width(keys, width)
    _check_radix(w, r)
    if not smallest:
        keys = bp.flip_key_t(keys, w)
    dev = keys.device
    vals = torch.arange(1 << r, dtype=torch.int32, device=dev)
    cand = torch.ones(keys.shape, dtype=torch.bool, device=dev)
    below = torch.zeros(keys.shape, dtype=torch.bool, device=dev)
    confirmed = torch.zeros(keys.shape[:-1], dtype=torch.int32, device=dev)
    k_arr = torch.as_tensor(k, dtype=torch.int32, device=dev)
    for shift in range(w - r, -1, -r):
        dig = _digit(keys, shift, r)
        eq = dig[..., None] == vals                            # (..., N, R)
        hist = (cand[..., None] & eq).sum(dim=-2, dtype=torch.int32)
        cum = torch.cumsum(hist, dim=-1, dtype=torch.int32)    # inclusive
        ge = (confirmed[..., None] + cum) >= k_arr[..., None]
        t = _first_true(ge)                                    # threshold
        prev = torch.gather(cum, -1, (t - 1).clamp(min=0)[..., None].long())
        confirmed = confirmed + torch.where(t > 0, prev[..., 0], 0)
        below = below | (cand & (dig < t[..., None]))
        cand = cand & (dig == t[..., None])
    # ties: first (k - confirmed) candidates in index order
    tie_rank = torch.cumsum(cand, dim=-1, dtype=torch.int32)
    need = (k_arr - confirmed)[..., None]
    return below | (cand & (tie_rank <= need))


def prune_smallest_mask(x: torch.Tensor, k, r: int = 8) -> torch.Tensor:
    """In-situ pruning mask (§3.2): True for the k smallest |x| along the
    last axis — the weights TNS would locate and discard."""
    keys, w = bp.sort_key_t(torch.abs(x))
    return topk_threshold_mask(keys, k, r=r, smallest=True, width=w)


def topk_logits_mask(logits: torch.Tensor, k, r: int = 8) -> torch.Tensor:
    """True for the k largest logits (decode-time top-k sampling filter)."""
    keys, w = bp.sort_key_t(logits)
    return topk_threshold_mask(keys, k, r=r, smallest=False, width=w)


# ---------------------------------------------------------------------------
# Full comparison-free radix sort (stable, LSB-first counting passes).
# ---------------------------------------------------------------------------


def radix_sort_keys(keys: torch.Tensor, r: int = 4,
                    descending: bool = False, *,
                    width: Optional[int] = None) -> torch.Tensor:
    """Permutation (int32) sorting ``keys`` ascending along the last axis;
    stable.  Counting sort per radix-2^r digit: ranks from per-digit
    cumsums, placed with a scatter.  Holds a (..., N, 2^r) int32 rank
    tensor per pass."""
    w = _key_width(keys, width)
    _check_radix(w, r)
    dev = keys.device
    vals = torch.arange(1 << r, dtype=torch.int32, device=dev)
    n = keys.shape[-1]
    ar = torch.arange(n, dtype=torch.int32, device=dev).expand(keys.shape)
    perm = ar
    cur = keys
    for shift in range(0, w, r):
        dig = _digit(cur, shift, r)
        eq = dig[..., None] == vals                           # (..., N, R)
        within = torch.cumsum(eq, dim=-2, dtype=torch.int32)  # rank in bin
        del eq
        hist = within[..., -1, :]                             # (..., R)
        offs = torch.cumsum(hist, dim=-1, dtype=torch.int32) - hist
        d = dig[..., None].long()
        pos = (torch.gather(offs, -1, dig.long())
               + torch.gather(within, -1, d)[..., 0] - 1)
        del within
        inv = torch.zeros(keys.shape, dtype=torch.int32,
                          device=dev).scatter(-1, pos.long(), ar)
        cur = torch.gather(cur, -1, inv.long())
        perm = torch.gather(perm, -1, inv.long())
    if descending:
        return torch.flip(perm, dims=(-1,))
    return perm


def sort_values(x: torch.Tensor, r: int = 4, descending: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted values, permutation) along the last axis, comparison-free."""
    keys, w = bp.sort_key_t(x)
    perm = radix_sort_keys(keys, r=r, descending=descending, width=w)
    return gather_values(x, perm), perm
