"""Engine-contract checker (CON4xx): cross-check every ``@register`` site
of the port's registry against :class:`repro_torch.sort.registry.EngineSpec`,
the README's port engine table and the port's parity suite.

* CON401 — invalid ``@register`` site: ``mode`` literal outside
  {"latency", "throughput"}, a kwarg :class:`EngineSpec` does not define,
  or a ``formats`` entry that is not a ``bp.*`` bit-plane constant.
* CON402 — registered engine with no row in the README's port engine table.
* CON403 — README port engine table naming an unregistered engine.
* CON404 — registered engine with no parity coverage in
  ``tests/test_torch_sort.py`` (a dynamic ``engines()`` /
  ``available_engines()`` sweep in that file counts as covering every
  engine).
* CON405 — ``"resilient:<engine>"`` literal whose base engine is never
  registered anywhere in the scanned tree.
* CON406 — the same engine name registered at two different sites.

The README table read is the one with a ``port engine`` column (any
position): each backticked name in that column is an engine claim, so a
cell may name several (`` `ml`, `mb`, `bts` ``); a backticked pattern
such as `` `resilient:<e>` `` names no engine and is not read (the
wrappers are registered under computed names, which no site declares).

This family is project-level: per-module :func:`collect` gathers register
sites and ``resilient:`` literals into a :class:`ContractContext`, and
:func:`finalize` runs the cross-checks once all files are parsed.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import (Finding, ModuleInfo, const_str,
                                       is_suppressed, keyword_map,
                                       parse_suppressions)

REGISTER_QUALNAMES = {
    "repro_torch.sort.registry.register",
    "repro_torch.sort.register",
}

VALID_MODES = ("latency", "throughput")
SPEC_KWARGS = {"mode", "strategy", "formats", "supports_stop_after",
               "supports_batch", "description"}
FORMAT_CONSTANTS = {"UNSIGNED", "TWOS", "SIGNMAG", "FLOAT"}
FORMAT_CONTAINERS = {"ALL_FORMATS"}

RESILIENT_PREFIX = "resilient:"

PARITY_TEST = Path("tests") / "test_torch_sort.py"
_DYNAMIC_SWEEP = re.compile(r"\b(?:available_engines|engines)\s*\(")
#: the header of the README table's engine column
ENGINE_COLUMN = "port engine"
_ENGINE_NAME = re.compile(r"`([a-z0-9_:-]+)`")


@dataclasses.dataclass
class RegisterSite:
    name: Optional[str]             # None when the name arg is dynamic
    path: str
    line: int
    col: int
    call: ast.Call
    mod: ModuleInfo


class ContractContext:
    def __init__(self) -> None:
        self.sites: List[RegisterSite] = []
        # ("resilient:x" literal, path, line, col)
        self.resilient_refs: List[Tuple[str, str, int, int]] = []
        # path -> parsed suppression tables, so finalize() honours them
        self.suppressions: Dict[str, Tuple[Dict[int, Set[str]],
                                           Set[str]]] = {}


def _is_register(node: ast.Call, mod: ModuleInfo) -> bool:
    qual = mod.qualname(node.func)
    return qual in REGISTER_QUALNAMES


def collect(mod: ModuleInfo, ctx: ContractContext) -> None:
    path = str(mod.path)
    ctx.suppressions[path] = parse_suppressions(mod.source)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and _is_register(node, mod):
            name = const_str(node.args[0]) if node.args else None
            ctx.sites.append(RegisterSite(
                name, path, node.lineno, node.col_offset, node, mod))
        elif isinstance(node, ast.Constant) \
                and isinstance(node.value, str) \
                and node.value.startswith(RESILIENT_PREFIX) \
                and len(node.value) > len(RESILIENT_PREFIX):
            ctx.resilient_refs.append(
                (node.value, path, node.lineno, node.col_offset))


def _check_site(site: RegisterSite) -> List[Finding]:
    findings: List[Finding] = []
    kw = keyword_map(site.call)

    for arg in kw:
        if arg not in SPEC_KWARGS:
            findings.append(Finding(
                "CON401", site.path, site.line, site.col,
                f"@register kwarg `{arg}` is not an EngineSpec field "
                f"(expected one of {sorted(SPEC_KWARGS)})"))

    if "mode" not in kw and len(site.call.args) < 2:
        findings.append(Finding(
            "CON401", site.path, site.line, site.col,
            "@register without mode=; every engine must declare "
            "\"latency\" or \"throughput\""))
    else:
        mode = const_str(kw.get("mode")) if "mode" in kw else None
        if "mode" in kw and const_str(kw["mode"]) is None \
                and isinstance(kw["mode"], ast.Constant):
            mode = "<non-string>"
        if mode is not None and mode not in VALID_MODES:
            findings.append(Finding(
                "CON401", site.path, site.line, site.col,
                f"@register mode={mode!r} is not one of {VALID_MODES}"))

    fmts = kw.get("formats")
    if isinstance(fmts, (ast.Tuple, ast.List)):
        for el in fmts.elts:
            qual = site.mod.qualname(el)
            leaf = qual.rsplit(".", 1)[-1] if qual else None
            if leaf in FORMAT_CONSTANTS or leaf in FORMAT_CONTAINERS:
                continue
            if const_str(el) in ("unsigned", "twos", "signmag", "float"):
                continue
            findings.append(Finding(
                "CON401", site.path, site.line, site.col,
                "formats entry is not a bp.* bit-plane constant "
                f"(got `{ast.dump(el) if qual is None else qual}`)"))
    return findings


def _cells(line: str) -> List[str]:
    return [c.strip() for c in line.strip().strip("|").split("|")]


def readme_engines(root: Path) -> Dict[str, int]:
    """Engine name -> line number of its first row in the README's port
    engine table(s): the tables whose header has a ``port engine``
    column.  Other README tables (the reference's capability matrix,
    budget fields, ...) are not claims about the port's registry."""
    rows: Dict[str, int] = {}
    try:
        lines = (root / "README.md").read_text().splitlines()
    except OSError:
        return rows
    column: Optional[int] = None
    for i, text in enumerate(lines, start=1):
        if not text.strip().startswith("|"):
            column = None
            continue
        cells = _cells(text)
        heads = [c.strip("`").lower() for c in cells]
        if column is None:
            if ENGINE_COLUMN in heads:
                column = heads.index(ENGINE_COLUMN)
            continue
        if column >= len(cells) or set(cells[column]) <= set("-: "):
            continue                 # the header's separator row
        for name in _ENGINE_NAME.findall(cells[column]):
            rows.setdefault(name, i)
    return rows


def finalize(ctx: ContractContext, root: Optional[Path]) -> List[Finding]:
    findings: List[Finding] = []

    by_name: Dict[str, RegisterSite] = {}
    for site in ctx.sites:
        findings.extend(_check_site(site))
        if site.name is None:
            continue
        prior = by_name.get(site.name)
        if prior is not None and prior.path != site.path:
            findings.append(Finding(
                "CON406", site.path, site.line, site.col,
                f"engine {site.name!r} already registered at "
                f"{prior.path}:{prior.line}"))
        else:
            by_name[site.name] = site

    registered = set(by_name)

    # CON405: resilient:<x> literals must name a registered base engine
    for literal, path, line, col in ctx.resilient_refs:
        base = literal[len(RESILIENT_PREFIX):]
        if registered and base not in registered:
            findings.append(Finding(
                "CON405", path, line, col,
                f"{literal!r} wraps engine {base!r}, which is never "
                "registered"))

    # README + parity-suite cross-checks need a project root and only make
    # sense when the scan actually saw register sites
    if root is not None and registered:
        rows = readme_engines(root)
        if rows:
            for name in sorted(registered - set(rows)):
                site = by_name[name]
                findings.append(Finding(
                    "CON402", site.path, site.line, site.col,
                    f"engine {name!r} has no row in the README's port "
                    "engine table"))
            for name in sorted(set(rows) - registered):
                findings.append(Finding(
                    "CON403", str(root / "README.md"), rows[name], 0,
                    f"README port engine table names {name!r}, an "
                    "unregistered engine"))

        parity = root / PARITY_TEST
        if parity.is_file():
            text = parity.read_text()
            if not _DYNAMIC_SWEEP.search(text):
                for name in sorted(registered):
                    if f'"{name}"' not in text \
                            and f"'{name}'" not in text:
                        site = by_name[name]
                        findings.append(Finding(
                            "CON404", site.path, site.line, site.col,
                            f"engine {name!r} has no parity coverage in "
                            f"{PARITY_TEST}"))

    return [f for f in findings if not _suppressed(f, ctx)]


def _suppressed(f: Finding, ctx: ContractContext) -> bool:
    tables = ctx.suppressions.get(f.path)
    if tables is None:
        return False
    return is_suppressed(f, *tables)
