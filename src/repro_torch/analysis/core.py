"""Shared infrastructure for the port's checkers: findings, suppressions,
import-alias resolution, the file walker and the --fix rewriter.

Checkers are plain functions ``check(module) -> Iterable[Finding]`` over a
parsed :class:`ModuleInfo` (Python) or a ``*.cu`` file's text;
project-level checkers (the engine-contract family needs every file plus
README/tests) run once per project root after all files are parsed.  The
entry point is :func:`analyze_paths`.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# ---------------------------------------------------------------------------
# Findings + suppression comments.
# ---------------------------------------------------------------------------

#: (lineno, col, end_lineno, end_col, replacement) — 1-based lines, 0-based
#: columns, same convention as the ast node attributes.
FixEdit = Tuple[int, int, int, int, str]


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str                       # e.g. "DET303"
    path: str                       # file (or "<project>" for root-level)
    line: int
    col: int
    message: str
    fix: Optional[FixEdit] = None   # present iff mechanically fixable

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: " \
               f"{self.rule} {self.message}"


#: comment leader of a suppression, by source language: ``#`` in Python,
#: ``//`` in CUDA C++
PY_COMMENT = "#"
CU_COMMENT = "//"

ALL_RULES = "*"


def parse_suppressions(source: str, comment: str = PY_COMMENT
                       ) -> Tuple[Dict[int, Set[str]], Set[str]]:
    """(per-line rule sets, file-wide rule set); ``"*"`` means every rule.
    ``comment`` is the language's comment leader (``#`` or ``//``)."""
    lead = re.escape(comment)
    line_re = re.compile(lead + r"\s*lint:\s*disable(?:=([\w\s,]+))?")
    file_re = re.compile(lead + r"\s*lint:\s*disable-file(?:=([\w\s,]+))?")
    per_line: Dict[int, Set[str]] = {}
    per_file: Set[str] = set()

    def rules_of(match: re.Match) -> Set[str]:
        spec = match.group(1)
        if spec is None:
            return {ALL_RULES}
        return {r.strip() for r in spec.split(",") if r.strip()}

    for i, text in enumerate(source.splitlines(), start=1):
        m = file_re.search(text)
        if m:
            per_file |= rules_of(m)
            continue
        m = line_re.search(text)
        if m:
            per_line.setdefault(i, set()).update(rules_of(m))
    return per_line, per_file


def is_suppressed(f: Finding, per_line: Dict[int, Set[str]],
                  per_file: Set[str]) -> bool:
    if ALL_RULES in per_file or f.rule in per_file:
        return True
    rules = per_line.get(f.line, ())
    return ALL_RULES in rules or f.rule in rules


# ---------------------------------------------------------------------------
# Parsed module + import-alias resolution.
# ---------------------------------------------------------------------------


class ModuleInfo:
    """One parsed file plus the alias map the checkers resolve names with."""

    def __init__(self, path: Path, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        # alias -> canonical dotted prefix, e.g. {"np": "numpy",
        # "F": "torch.nn.functional"}
        self.aliases: Dict[str, str] = {}
        # from-imports: local name -> canonical dotted name, e.g.
        # {"register": "repro_torch.sort.registry.register"}
        self.from_imports: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    self.from_imports[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def qualname(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of a Name/Attribute chain, with import
        aliases resolved (``_build.load`` ->
        ``repro_torch.kernels._build.load``); None if not a name."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = node.id
        if head in self.aliases:
            head = self.aliases[head]
        elif head in self.from_imports:
            head = self.from_imports[head]
        parts.append(head)
        return ".".join(reversed(parts))


def parse_module(path: Path) -> Optional[ModuleInfo]:
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
    except (OSError, SyntaxError):
        return None
    return ModuleInfo(path, source, tree)


# ---------------------------------------------------------------------------
# Literal helpers shared by the checkers.
# ---------------------------------------------------------------------------


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def const_int(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    return None


def keyword_map(call: ast.Call) -> Dict[str, ast.expr]:
    return {kw.arg: kw.value for kw in call.keywords if kw.arg}


# ---------------------------------------------------------------------------
# The walker and the entry point.
# ---------------------------------------------------------------------------

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "build", "dist"}


def _iter_files(paths: Sequence[Path], suffix: str) -> List[Path]:
    """``paths``' files of ``suffix``, directories walked; a skipped
    directory counts only below the path given (a checkout may itself lie
    under a directory named ``build``)."""
    files: List[Path] = []
    for p in paths:
        if p.is_file() and p.suffix == suffix:
            files.append(p)
        elif p.is_dir():
            files.extend(
                f for f in sorted(p.rglob("*" + suffix))
                if not any(part in _SKIP_DIRS
                           for part in f.relative_to(p).parts))
    return files


def iter_python_files(paths: Sequence[Path]) -> List[Path]:
    return _iter_files(paths, ".py")


def iter_cuda_files(paths: Sequence[Path]) -> List[Path]:
    return _iter_files(paths, ".cu")


def find_project_root(start: Path) -> Optional[Path]:
    """Nearest ancestor holding README.md — where the engine table and
    tests/ live.  None means the contract checks that need them are
    skipped (e.g. linting a loose fixture directory)."""
    cur = start.resolve()
    if cur.is_file():
        cur = cur.parent
    for cand in (cur, *cur.parents):
        if (cand / "README.md").is_file():
            return cand
    return None


def analyze_paths(paths: Sequence[Path], select: Optional[Set[str]] = None
                  ) -> Tuple[List[Finding], int]:
    """Run every checker over ``paths``: the Python files through DET3xx,
    CON4xx and the Python side of CUD2xx, the ``*.cu`` files through the
    CUDA lint.  ``select`` filters by rule-family prefix ("DET", "CON",
    "CUD") or full rule id.  Returns (unsuppressed findings sorted by
    location, number of files scanned)."""
    from repro_torch.analysis import contracts, cuda_lint, determinism

    files = iter_python_files(paths)
    modules = [m for m in (parse_module(f) for f in files) if m is not None]
    sources = []
    for f in iter_cuda_files(paths):
        try:
            sources.append((f, f.read_text()))
        except OSError:
            continue

    findings: List[Finding] = []
    ctx = contracts.ContractContext()
    for mod in modules:
        per_line, per_file = parse_suppressions(mod.source)
        local = [*determinism.check(mod), *cuda_lint.check(mod)]
        contracts.collect(mod, ctx)
        findings.extend(f for f in local
                        if not is_suppressed(f, per_line, per_file))
    for path, source in sources:
        per_line, per_file = parse_suppressions(source, CU_COMMENT)
        findings.extend(f for f in cuda_lint.check_cuda(path, source)
                        if not is_suppressed(f, per_line, per_file))

    roots = {r for r in (find_project_root(p) for p in paths)
             if r is not None}
    root = min(roots, key=lambda r: len(r.parts)) if roots else None
    findings.extend(contracts.finalize(ctx, root))

    if select:
        findings = [f for f in findings
                    if f.rule in select or f.rule[:3] in select]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, len(modules) + len(sources)


def format_findings(findings: Sequence[Finding]) -> str:
    return "\n".join(f.format() for f in findings)


def apply_fixes(findings: Iterable[Finding]) -> int:
    """Rewrite every finding that carries a fix edit; returns the number of
    edits applied.  Edits are applied bottom-up per file so earlier offsets
    stay valid."""
    by_path: Dict[str, List[Finding]] = {}
    for f in findings:
        if f.fix is not None:
            by_path.setdefault(f.path, []).append(f)
    applied = 0
    for path, fixes in by_path.items():
        lines = Path(path).read_text().splitlines(keepends=True)
        for f in sorted(fixes, key=lambda f: f.fix[:2], reverse=True):
            lo, co, le, ce, repl = f.fix
            if lo != le:                 # multi-line edits: not attempted
                continue
            line = lines[lo - 1]
            lines[lo - 1] = line[:co] + repl + line[ce:]
            applied += 1
        Path(path).write_text("".join(lines))
    return applied
