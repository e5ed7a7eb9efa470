"""Determinism lint (DET3xx): anything that would make ``SortResult``
cycles, quality metrics, retry timing or a model's sampled tokens
non-reproducible per seed.

* DET301 — stdlib ``random`` module calls (``random.random()``,
  ``random.randint(...)``, ...): global, unseeded-by-default state.  Thread
  a seeded ``np.random.Generator`` instead.
* DET302 — legacy ``np.random`` global-state calls (``np.random.rand``,
  ``np.random.seed``, ...) and ``np.random.default_rng()`` with no seed
  argument.
* DET303 — ``time.time()``: wall clock steps under NTP; use
  ``time.monotonic()`` for elapsed measurements (``--fix``-able).
  ``time.time_ns()`` used purely as a nonce is fine and not flagged.
* DET304 — iteration over an engine-registry mapping or listing
  (``engines()``, ``available_engines()``, ``_REGISTRY``) without
  ``sorted(...)``: dict order is insertion order, which depends on import
  order — dispatch and reporting must not.
* DET305 — torch's global generator: a sampler (``torch.rand`` /
  ``randn`` / ``randint`` / ``randperm`` / their ``*_like`` forms /
  ``multinomial`` / ``normal`` / ``bernoulli`` / ``poisson``, the in-place
  ``.uniform_`` / ``.normal_`` / ``.random_`` / ``.bernoulli_`` /
  ``.exponential_``, the ``torch.nn.init`` samplers) called without
  ``generator=``, and any reseeding of the global generator
  (``torch.manual_seed``, ``torch.seed``, ``torch.cuda.manual_seed[_all]``):
  the draws then depend on whatever else consumed or reseeded that state
  in the process.  Thread a seeded ``torch.Generator`` instead.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.core import Finding, ModuleInfo

# random-module functions that read/advance the hidden global state
_RANDOM_FNS = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "sample", "shuffle", "gauss", "normalvariate", "betavariate",
    "expovariate", "seed", "getrandbits", "triangular",
}

_NP_RANDOM_LEGACY = {
    "rand", "randn", "randint", "random", "random_sample", "uniform",
    "choice", "shuffle", "permutation", "seed", "normal", "standard_normal",
    "binomial", "poisson", "exponential", "get_state", "set_state",
}

# names whose call result / value is a registry view with insertion order
_REGISTRY_ITER_NAMES = {"engines", "available_engines"}
_REGISTRY_MAPS = {"_REGISTRY"}

# torch samplers that draw from the global generator unless given one
_TORCH_SAMPLERS = {
    "torch." + f for f in (
        "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
        "randint_like", "multinomial", "normal", "bernoulli", "poisson")}
_TORCH_INPLACE_SAMPLERS = {"uniform_", "normal_", "random_", "bernoulli_",
                           "exponential_"}
_TORCH_INIT = "torch.nn.init."
_TORCH_INIT_SAMPLERS = {
    "uniform_", "normal_", "trunc_normal_", "xavier_uniform_",
    "xavier_normal_", "kaiming_uniform_", "kaiming_normal_", "orthogonal_",
    "sparse_"}
# calls that reseed the global generator(s)
_TORCH_RESEEDS = {"torch.manual_seed", "torch.seed", "torch.random.seed",
                  "torch.random.manual_seed", "torch.cuda.manual_seed",
                  "torch.cuda.manual_seed_all", "torch.cuda.seed",
                  "torch.cuda.seed_all"}


def _registry_source(node: ast.AST, mod: ModuleInfo) -> Optional[str]:
    """If ``node`` evaluates to an engine-registry listing/mapping (or its
    ``.items()``/``.keys()``/``.values()`` view), return a display name."""
    if isinstance(node, ast.Call):
        qual = mod.qualname(node.func)
        if qual is not None:
            leaf = qual.rsplit(".", 1)[-1]
            if leaf in _REGISTRY_ITER_NAMES:
                return leaf + "()"
            if leaf in ("items", "keys", "values") \
                    and isinstance(node.func, ast.Attribute):
                inner = _registry_source(node.func.value, mod)
                if inner is not None:
                    return f"{inner}.{leaf}()"
    qual = mod.qualname(node)
    if qual is not None and qual.rsplit(".", 1)[-1] in _REGISTRY_MAPS:
        return qual.rsplit(".", 1)[-1]
    if isinstance(node, ast.Call) and mod.qualname(node.func) == "list" \
            and node.args:
        return _registry_source(node.args[0], mod)
    return None


def _is_sorted_call(node: ast.AST, mod: ModuleInfo) -> bool:
    return isinstance(node, ast.Call) \
        and mod.qualname(node.func) in ("sorted", "dict", "set", "len")


def _torch_global_draw(node: ast.Call, qual: Optional[str]
                       ) -> Optional[str]:
    """DET305's message for a call that draws from or reseeds torch's
    global generator; None for any other call."""
    if qual in _TORCH_RESEEDS:
        return (f"`{qual}()` reseeds torch's global generator; seed a "
                "torch.Generator and pass it as generator=")
    if any(kw.arg == "generator" for kw in node.keywords):
        return None
    if qual in _TORCH_SAMPLERS:
        what = f"`{qual}()`"
    elif qual is not None and qual.startswith(_TORCH_INIT) \
            and qual[len(_TORCH_INIT):] in _TORCH_INIT_SAMPLERS:
        what = f"`{qual}()`"
    elif isinstance(node.func, ast.Attribute) \
            and node.func.attr in _TORCH_INPLACE_SAMPLERS \
            and not (qual or "").startswith(_TORCH_INIT):
        what = f"in-place sampler `.{node.func.attr}()`"
    else:
        return None
    return (f"{what} without generator= draws from torch's global "
            "generator; pass a seeded torch.Generator")


def check(mod: ModuleInfo) -> List[Finding]:
    findings: List[Finding] = []
    path = str(mod.path)

    # comprehensions feeding a sorted()/set()/dict() call are order-safe
    ordered: set = set()
    for node in ast.walk(mod.tree):
        if _is_sorted_call(node, mod):
            for sub in ast.walk(node):
                if isinstance(sub, ast.comprehension):
                    ordered.add(id(sub))

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            qual = mod.qualname(node.func)

            # DET305: torch's global generator (in-place samplers are
            # methods of any tensor, so they need no resolvable name)
            msg = _torch_global_draw(node, qual)
            if msg is not None:
                findings.append(Finding(
                    "DET305", path, node.lineno, node.col_offset, msg))
            if qual is None:
                continue

            # DET301: stdlib random
            if qual.startswith("random.") \
                    and qual.split(".", 1)[1] in _RANDOM_FNS:
                findings.append(Finding(
                    "DET301", path, node.lineno, node.col_offset,
                    f"global-state `{qual}()`; thread a seeded "
                    "np.random.Generator through the call path instead"))

            # DET302: np.random legacy globals / unseeded default_rng
            elif qual.startswith("numpy.random."):
                leaf = qual.rsplit(".", 1)[-1]
                if leaf in _NP_RANDOM_LEGACY:
                    findings.append(Finding(
                        "DET302", path, node.lineno, node.col_offset,
                        f"legacy global-state `np.random.{leaf}()`; use a "
                        "seeded np.random.default_rng(seed)"))
                elif leaf == "default_rng" and not node.args \
                        and not node.keywords:
                    findings.append(Finding(
                        "DET302", path, node.lineno, node.col_offset,
                        "np.random.default_rng() without a seed draws "
                        "OS entropy; pass an explicit seed"))

            # DET303: wall clock in elapsed measurements (fixable)
            elif qual == "time.time":
                end = getattr(node, "end_col_offset", None)
                fix = None
                if end is not None \
                        and node.lineno == getattr(node, "end_lineno",
                                                   node.lineno):
                    seg = ast.get_source_segment(mod.source, node) or ""
                    if seg in ("time.time()", "time()"):
                        repl = "time.monotonic()" if seg.startswith("time.") \
                            else "monotonic()"
                        fix = (node.lineno, node.col_offset,
                               node.end_lineno, end, repl)
                findings.append(Finding(
                    "DET303", path, node.lineno, node.col_offset,
                    "wall-clock time.time() is not monotonic under NTP "
                    "steps; use time.monotonic() for elapsed/retry timing",
                    fix=fix))

        # DET304: unsorted iteration over registry views
        iters: List[ast.AST] = []
        if isinstance(node, (ast.For, ast.comprehension)) \
                and id(node) not in ordered:
            iters.append(node.iter)
        for it in iters:
            if _is_sorted_call(it, mod):
                continue
            src = _registry_source(it, mod)
            if src is not None:
                line = getattr(node, "lineno", None) or it.lineno
                col = getattr(node, "col_offset", None)
                if col is None:
                    col = it.col_offset
                findings.append(Finding(
                    "DET304", path, line, col,
                    f"iteration over `{src}` depends on registration "
                    "(import) order; wrap in sorted(...)"))
    return findings
