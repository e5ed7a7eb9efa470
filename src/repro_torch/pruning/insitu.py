"""In-situ pruning with run-time tunable sparsity (paper §3.2, Alg. S2).

The paper stores layer weights in the CIM array, uses TNS to locate the p%
smallest |weights|, and masks the corresponding *inputs* before the MVM.
For a weight matrix, masking input lane i is identical to zeroing row
W[i, :]; we score each input lane by its largest |weight| (so a masked
lane only ever removes weights that are all among the smallest) and select
the p% smallest lanes with the comparison-free radix machinery — the same
digit-read selection the hardware performs, at tensor scale.

Two paths:

* ``prune_params`` — throughput mode: radix threshold-select per layer over
  a nested parameter tree of tensors (:mod:`repro_torch.tree`), on the
  tensors' device; ``rate`` may be a 0-d tensor — run-time tunable.
* ``tns_prune`` — cycle-faithful mode: quantize weights to 8-bit
  sign-magnitude (like the paper's PointNet++ demo), run the TNS engine
  with ``stop_after = p%% * N``, and report located indices + DR counts
  (feeds the Fig. 6f benchmark and the BER study).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import sort as sort_engine
from repro_torch import tree
from repro_torch.core import bitplane as bp
from repro_torch.core import device_model as dm


# ---------------------------------------------------------------------------
# Throughput mode (serving path)
# ---------------------------------------------------------------------------


def lane_keep_mask(wi: torch.Tensor, rate) -> torch.Tensor:
    """wi: (..., d_in, d_out).  Returns (..., d_in) keep mask with the
    round(rate*d_in) smallest-magnitude lanes dropped (the count rounded
    half to even in float32)."""
    # |w| and its max are exact in wi's dtype, so widening after them
    # gives the float32 scores of widening first
    scores = wi.abs().amax(dim=-1).float()
    d = wi.shape[-2]
    k = torch.round(torch.as_tensor(rate, dtype=torch.float32) * d)
    flat = scores.reshape(-1, d)
    pruned = sort_engine.prune_mask(flat, k.to(torch.int32))
    return ~pruned.reshape(scores.shape)


def prune_params(params: Dict, cfg, rate) -> Tuple[Dict, Dict]:
    """Zero the TNS-located smallest input lanes of every MLP ``wi`` in a
    stacked (or layerwise) param tree.  Returns (new_params, stats);
    ``stats["masks"]`` is keyed by the leaf's path as :func:`tree.keystr`
    prints it.  ``cfg`` (the model's config) is not read: the tree's paths
    say which leaves are MLP inputs."""
    masks, pruned_w, kept_w = {}, 0.0, 0.0

    def visit(path, leaf):
        nonlocal pruned_w, kept_w
        # dense MLPs and MoE *shared* experts are pruned; routed expert
        # banks (moe/wi with a leading E axis) are already sparse by routing
        if not (len(path) >= 2 and path[-1] == "wi"
                and path[-2] in ("mlp", "shared")):
            return leaf
        keep = lane_keep_mask(leaf, rate)
        masks[tree.keystr(path)] = keep
        total = int(np.prod(leaf.shape))
        # the float32 mean of the dropped lanes, as the reference takes it
        frac = float(np.float32(int((~keep).sum()))
                     / np.float32(keep.numel()))
        pruned_w += frac * total
        kept_w += (1 - frac) * total
        return leaf * keep[..., None].to(leaf.dtype)

    # visited in the flattening order (sorted dict keys), so the sums add
    # up in the reference's order
    new_leaves = {path: visit(path, leaf)
                  for path, leaf in tree.flatten_with_path(params)}
    new_params = tree.map_with_path(lambda path, _: new_leaves[path],
                                    params)
    stats = {"masks": masks,
             "weight_sparsity": pruned_w / max(pruned_w + kept_w, 1)}
    return new_params, stats


# ---------------------------------------------------------------------------
# Cycle-faithful mode (hardware benchmark, Fig. 6f)
# ---------------------------------------------------------------------------


def quantize_8bit_signmag(w: np.ndarray) -> np.ndarray:
    """Paper: 'we quantify the weights into 8-bit sign-and-magnitude
    numbers' — symmetric scale to +-127."""
    scale = np.max(np.abs(w)) / 127.0 if np.max(np.abs(w)) > 0 else 1.0
    return np.clip(np.round(w / scale), -127, 127).astype(np.int64)


def tns_prune(weights: np.ndarray, rate: float, k: int = 2,
              ber: float = 0.0, seed: int = 0, engine: str = "tns",
              device=None):
    """Locate the p% smallest |weights| with a cycle-faithful engine from
    the sort registry (sorting |w| as unsigned magnitudes, ascending) on
    ``device`` (``None``: the card), optionally under device bit errors.
    Returns (indices, cycles, drs)."""
    q = quantize_8bit_signmag(np.asarray(weights).reshape(-1))
    mag = np.abs(q)
    n = mag.shape[0]
    m = int(round(rate * n))
    if ber > 0:
        # program the array, flip bits at the device BER, read back the
        # (possibly corrupted) dataset the controller will actually see
        planes = dm.apply_ber(bp.to_bitplanes(mag, 8, bp.UNSIGNED), ber,
                              seed=seed)
        mag = bp.from_bitplanes(planes, bp.UNSIGNED)
    res = sort_engine.sort(mag.astype(np.uint8), engine=engine, width=8,
                           fmt=bp.UNSIGNED, k=k, stop_after=m,
                           device=device)
    return (np.asarray(res.indices), int(np.asarray(res.cycles)),
            int(np.asarray(res.drs)))
