"""The one traffic generator: it reads a mix's data file
(``traffic/<mix>.json``) and makes that mix's inputs from the seed.  The
same seed gives the same inputs; every seed gives the same sizes.

``dataset`` is a copy of the paper's five sorting datasets (§5.4), after
``benchmarks/datasets.py``, kept here so that the yardstick does not move
with the repository's own copy."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream of the seed for each use."""
    return np.random.default_rng([int(seed), int(stream)])


def dataset(name: str, shape, width: int, r: np.random.Generator
            ) -> np.ndarray:
    """W-bit unsigned keys of one of the paper's datasets, as uint64."""
    n = int(np.prod(shape))
    hi = 2 ** width
    if name == "random":
        v = r.integers(0, hi, n)
    elif name == "normal":
        mean, std = 2 ** (width - 1), 2 ** (width - 1) / 3
        v = np.clip(r.normal(mean, std, n), 0, hi - 1)
    elif name == "clustered":
        centers, std = (([100, 200], 10) if width == 8
                        else ([2 ** 15, 2 ** 25], 2 ** 13))
        c = r.integers(0, len(centers), n)
        v = np.clip(r.normal(np.asarray(centers)[c], std), 0, hi - 1)
    elif name == "kruskal":
        pts, other = r.random((n, 2)), r.random((n, 2))
        d = np.sqrt(((pts - other) ** 2).sum(1)) / np.sqrt(2)
        v = d * (hi - 1)
    elif name == "mapreduce":
        v = np.minimum(r.zipf(1.3, n).astype(np.float64), hi - 1)
    else:
        raise ValueError(f"unknown dataset {name!r}")
    return v.astype(np.uint64).reshape(shape)


def key_dtype(width: int):
    return np.uint8 if width <= 8 else np.uint16 if width <= 16 else np.uint32


def prompts(r: np.random.Generator, vocab: int, shape) -> np.ndarray:
    """Token ids drawn uniformly from the vocabulary, int64."""
    return r.integers(0, vocab, shape, dtype=np.int64)
