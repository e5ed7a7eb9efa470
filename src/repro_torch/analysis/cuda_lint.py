"""CUDA-kernel lint (CUD2xx): the resource limits of a Hopper block and the
launch hygiene of the port's hand-written kernels (``kernels/csrc/*.cu``)
and of their Python wrappers.

* CUD201 — static shared memory: the ``__shared__`` arrays a
  ``__global__`` kernel declares, where every size resolves from literals,
  ``sizeof`` of a known type and file-level ``constexpr`` integers, must
  total at most 48 KiB (a block gets more only as dynamic shared memory).
  Sizes that depend on a template argument are exempt, as are runtime
  sizes (the kernel's caller sizes them; this catches hardcoded tiles).
* CUD202 — dynamic shared memory: a resolvable value handed to
  ``cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize,
  v)`` or a launch's resolvable dynamic bytes plus the kernel's static
  bytes, and every file-level ``constexpr`` budget whose name says it is
  one (``*Smem*``, ``*SharedMem*``), must stay within the opt-in limit.
* CUD203 — opt-in present: a kernel with ``extern __shared__`` whose
  launch can pass 48 KiB (a runtime or larger dynamic size) needs that
  ``cudaFuncSetAttribute`` call for it in the same file, or the launch is
  refused.
* CUD204 — thread limit: a resolvable ``__launch_bounds__`` thread count
  or a launch's resolvable block size must be at most 1024.
* CUD205 — plain-version dispatch: a Python module that calls
  ``_build.load`` must import :mod:`repro_torch.kernels.backend` and
  branch on ``backend.uses_kernel``, so that a CPU tensor runs the
  kernel's plain version and only a CUDA tensor reaches the library.
* CUD206 — launch status: every ``<<<...>>>`` launch must be followed, in
  the function that issues it, by ``cudaGetLastError()`` (or
  ``cudaPeekAtLastError()``), so that a launch refused for its
  configuration reaches the wrapper, which raises.
* CUD207 — a CUDA runtime call (``cuda*(...)``) inside a ``__global__``
  body: the kernels build without relocatable device code, so the device
  runtime is not linked.

Against the reference's Pallas lint (PAL2xx): PAL201 (BlockSpec
divisibility) and PAL202 (index-map arity) have no counterpart — a CUDA
kernel has no BlockSpec or index map; it computes its own offsets from
``blockIdx`` and masks its ragged edge itself.  PAL203 (the backend's
``interpret=`` decision threaded through every call) becomes CUD206, the
launch status every wrapper reads; PAL204 (ops that cannot run in a kernel
body) becomes CUD207; PAL205 (the interpret-mode fallback imported)
becomes CUD205; PAL206 (the VMEM budget) becomes CUD201–CUD203, and
CUD204 is new.  Suppress with ``// lint: disable=CUD2xx`` on the line.

The parser is a small reader of the C++ the port writes, not a compiler:
comments and string literals are blanked, braces matched, and sizes
evaluated by a little integer-expression evaluator.  Whatever it cannot
resolve it leaves alone.  :func:`ptxas_smem` and :func:`compare_ptxas`
hold its static figures to ``ptxas -v``'s on the card.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.core import Finding, ModuleInfo

# ---------------------------------------------------------------------------
# The card's limits: NVIDIA H100 SXM, sm_90a (compute capability 9.0's
# technical specifications in NVIDIA's CUDA C++ documentation).
# ---------------------------------------------------------------------------

#: static shared memory a block may declare
STATIC_SMEM_LIMIT = 48 * 1024
#: shared memory a block may use after opting in (227 KiB)
OPTIN_SMEM_LIMIT = 232448
#: threads a block
MAX_THREADS_PER_BLOCK = 1024

BACKEND_MODULE = "repro_torch.kernels.backend"
USES_KERNEL = BACKEND_MODULE + ".uses_kernel"
BUILD_LOAD = "repro_torch.kernels._build.load"

_OPTIN_ATTR = "cudaFuncAttributeMaxDynamicSharedMemorySize"
_BUDGET_NAME = re.compile(r"smem|sharedmem", re.I)
_LAUNCH_STATUS = re.compile(r"\bcuda(?:GetLastError|PeekAtLastError)\s*\(")
_RUNTIME_CALL = re.compile(r"\b(cuda[A-Z]\w*)\s*\(")

#: bytes (and alignment) of the scalar and vector types the kernels use
TYPE_BYTES = {
    "char": 1, "signed char": 1, "unsigned char": 1, "bool": 1,
    "int8_t": 1, "uint8_t": 1,
    "short": 2, "unsigned short": 2, "int16_t": 2, "uint16_t": 2,
    "half": 2, "__half": 2, "__nv_bfloat16": 2,
    "int": 4, "unsigned": 4, "unsigned int": 4, "int32_t": 4,
    "uint32_t": 4, "float": 4, "__half2": 4, "__nv_bfloat162": 4,
    "long long": 8, "unsigned long long": 8, "int64_t": 8, "uint64_t": 8,
    "size_t": 8, "double": 8, "uint2": 8, "int2": 8, "float2": 8,
    "uint4": 16, "int4": 16, "float4": 16, "double2": 16,
}


# ---------------------------------------------------------------------------
# Text: comments and literals blanked, braces matched.
# ---------------------------------------------------------------------------


def blank(source: str) -> str:
    """``source`` with comments and the insides of string and character
    literals replaced by spaces (newlines kept), so that offsets, lines
    and columns stay those of the file."""
    out = list(source)
    i, n = 0, len(source)
    while i < n:
        c = source[i]
        if source.startswith("//", i):
            j = source.find("\n", i)
            j = n if j < 0 else j
            out[i:j] = " " * (j - i)
            i = j
        elif source.startswith("/*", i):
            j = source.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out[i:j] = [ch if ch == "\n" else " " for ch in source[i:j]]
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and source[j] != c and source[j] != "\n":
                j += 2 if source[j] == "\\" else 1
            out[i + 1:j] = " " * (j - i - 1)
            i = j + 1
        else:
            i += 1
    return "".join(out)


@dataclasses.dataclass(frozen=True)
class Scope:
    open: int
    close: int
    kind: str                       # "ns" | "type" | "code"


def _scopes(text: str) -> List[Scope]:
    """Every ``{...}`` of blanked ``text``: namespaces and ``extern "C"``
    blocks ("ns"), struct / class / union / enum bodies ("type") and the
    rest ("code": function bodies and the blocks inside them)."""
    scopes: List[Scope] = []
    stack: List[Tuple[int, str]] = []
    last = -1                        # the last ; { or } seen
    for i, c in enumerate(text):
        if c == "{":
            head = text[last + 1:i]
            if re.search(r"\bnamespace\b[\w\s:]*$", head) \
                    or re.search(r'\bextern\s+"[^"]*"\s*$', head):
                kind = "ns"
            elif re.search(r"\b(?:struct|class|union|enum)\b[^()]*$", head):
                kind = "type"
            else:
                kind = "code"
            stack.append((i, kind))
            last = i
        elif c == "}":
            if stack:
                start, kind = stack.pop()
                scopes.append(Scope(start, i, kind))
            last = i
        elif c == ";":
            last = i
    return sorted(scopes, key=lambda s: s.open)


def _balanced(text: str, i: int) -> int:
    """Index just past the parenthesis that closes the one at ``text[i]``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == "(":
            depth += 1
        elif text[j] == ")":
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


def _split_top(s: str, sep: str = ",") -> List[str]:
    """``s`` split at ``sep`` outside brackets and template argument
    lists (a ``<`` right after a name opens one; a comparison has a space
    or an operator before it)."""
    parts, depth, angle, cur = [], 0, 0, []
    for i, ch in enumerate(s):
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        elif ch == "<" and i and (s[i - 1].isalnum() or s[i - 1] == "_") \
                and s[i + 1:i + 2] not in ("<", "="):
            angle += 1
        elif ch == ">" and angle and s[i + 1:i + 2] not in (">", "="):
            angle -= 1
        if ch == sep and depth == 0 and angle == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts]


def _line_col(text: str, pos: int) -> Tuple[int, int]:
    line = text.count("\n", 0, pos) + 1
    return line, pos - (text.rfind("\n", 0, pos) + 1)


# ---------------------------------------------------------------------------
# Integer expressions: literals, constants, sizeof, casts, C operators.
# ---------------------------------------------------------------------------


class Unresolved(Exception):
    """An expression names something the lint cannot evaluate."""


_INT_TYPE = (r"(?:const\s+)?(?:(?:unsigned|signed|long|short)\s+)*"
             r"(?:int|char|short|long|size_t|unsigned|u?int(?:8|16|32|64)_t)")
_CAST = re.compile(r"\(\s*" + _INT_TYPE + r"\s*\)")
_STATIC_CAST = re.compile(r"\bstatic_cast\s*<[^<>]*>")
_SIZEOF = re.compile(r"\bsizeof\s*\(\s*([\w\s]+?)\s*\)")
_TOKEN = re.compile(
    r"\s*(?:(0[xX][0-9a-fA-F]+|\d+)[uUlL]*|([A-Za-z_]\w*)"
    r"|(<<|>>|<=|>=|==|!=|&&|\|\||[-+*/%()<>?:!~&|^]))")

_BINARY = [("||",), ("&&",), ("|",), ("^",), ("&",), ("==", "!="),
           ("<", "<=", ">", ">="), ("<<", ">>"), ("+", "-"),
           ("*", "/", "%")]


def _c_div(a: int, b: int) -> int:
    if b == 0:
        raise Unresolved("division by zero")
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _apply(op: str, a: int, b: int) -> int:
    if op == "/":
        return _c_div(a, b)
    if op == "%":
        return a - b * _c_div(a, b)
    return {
        "||": lambda: int(bool(a) or bool(b)),
        "&&": lambda: int(bool(a) and bool(b)),
        "|": lambda: a | b, "^": lambda: a ^ b, "&": lambda: a & b,
        "==": lambda: int(a == b), "!=": lambda: int(a != b),
        "<": lambda: int(a < b), "<=": lambda: int(a <= b),
        ">": lambda: int(a > b), ">=": lambda: int(a >= b),
        "<<": lambda: a << b, ">>": lambda: a >> b,
        "+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b,
    }[op]()


class _Expr:
    def __init__(self, text: str, env: Dict[str, int],
                 types: Dict[str, int]):
        def size_of(m: re.Match) -> str:
            size = type_bytes(m.group(1), types)
            if size is None:
                raise Unresolved(f"sizeof({m.group(1)})")
            return str(size)

        text = _SIZEOF.sub(size_of, text)
        text = _STATIC_CAST.sub("", _CAST.sub("", text))
        self.toks: List[Tuple[str, object]] = []
        pos = 0
        while pos < len(text):
            if not text[pos:].strip():
                break
            m = _TOKEN.match(text, pos)
            if m is None:
                raise Unresolved(f"cannot read {text[pos:]!r}")
            num, name, op = m.groups()
            if num is not None:
                self.toks.append(("num", int(num, 0)))
            elif name is not None:
                if name in ("true", "false"):
                    self.toks.append(("num", int(name == "true")))
                elif name in env:
                    self.toks.append(("num", env[name]))
                else:
                    raise Unresolved(name)
            else:
                self.toks.append(("op", op))
            pos = m.end()
        self.i = 0

    def _peek(self) -> Optional[str]:
        if self.i < len(self.toks) and self.toks[self.i][0] == "op":
            return self.toks[self.i][1]
        return None

    def _take(self, op: str) -> None:
        if self._peek() != op:
            raise Unresolved(f"expected {op!r}")
        self.i += 1

    def value(self) -> int:
        v = self._ternary()
        if self.i != len(self.toks):
            raise Unresolved("trailing tokens")
        return v

    def _ternary(self) -> int:
        cond = self._binary(0)
        if self._peek() == "?":
            self.i += 1
            a = self._ternary()
            self._take(":")
            b = self._ternary()
            return a if cond else b
        return cond

    def _binary(self, level: int) -> int:
        if level == len(_BINARY):
            return self._unary()
        v = self._binary(level + 1)
        while self._peek() in _BINARY[level]:
            op = self._peek()
            self.i += 1
            v = _apply(op, v, self._binary(level + 1))
        return v

    def _unary(self) -> int:
        op = self._peek()
        if op in ("-", "+", "!", "~"):
            self.i += 1
            v = self._unary()
            return {"-": -v, "+": v, "!": int(not v), "~": ~v}[op]
        if op == "(":
            self.i += 1
            v = self._ternary()
            self._take(")")
            return v
        if self.i < len(self.toks) and self.toks[self.i][0] == "num":
            self.i += 1
            return self.toks[self.i - 1][1]
        raise Unresolved("expected a value")


def evaluate(expr: str, env: Dict[str, int],
             types: Optional[Dict[str, int]] = None) -> Optional[int]:
    """The value of C integer expression ``expr`` with names from ``env``
    and type sizes from ``types`` (over :data:`TYPE_BYTES`); None when it
    names anything else."""
    try:
        return _Expr(expr, env, types or {}).value()
    except Unresolved:
        return None


def type_bytes(name: str, types: Dict[str, int]) -> Optional[int]:
    name = re.sub(r"\b(?:const|volatile)\b", " ", name)
    name = " ".join(name.split())
    return types.get(name, TYPE_BYTES.get(name))


# ---------------------------------------------------------------------------
# A parsed .cu file.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Shared:
    name: str
    type: str
    dims: Tuple[str, ...]           # () for a scalar; ("",) for extern []
    align: int
    extern: bool


@dataclasses.dataclass
class Kernel:
    name: str
    params: Tuple[str, ...]         # template parameter names, in order
    pos: int                        # of the name
    bounds: Optional[str]           # __launch_bounds__'s thread count
    bounds_pos: int
    shared: List[Shared]
    body: Tuple[int, int]

    @property
    def extern_shared(self) -> bool:
        return any(s.extern for s in self.shared)


@dataclasses.dataclass
class Launch:
    kernel: str
    block: str
    smem: Optional[str]
    pos: int
    end: int


@dataclasses.dataclass
class OptIn:
    kernel: str
    value: str
    pos: int


class CudaFile:
    """The kernels, launches, opt-in calls, file-level constants and
    typedefs of one ``.cu`` source."""

    def __init__(self, path: Path, source: str):
        self.path = path
        self.source = source
        self.text = blank(source)
        self.scopes = _scopes(self.text)
        self.types: Dict[str, int] = {}
        self.consts: Dict[str, int] = {}
        self.const_pos: Dict[str, int] = {}
        self._read_file_level()
        self.kernels = self._read_kernels()
        self.launches = self._read_launches()
        self.optins = self._read_optins()

    # -- scopes --------------------------------------------------------

    def enclosing(self, pos: int) -> List[Scope]:
        """The scopes around ``pos``, outermost first."""
        return [s for s in self.scopes if s.open < pos < s.close]

    def at_file_level(self, pos: int) -> bool:
        return all(s.kind == "ns" for s in self.enclosing(pos))

    def line_col(self, pos: int) -> Tuple[int, int]:
        return _line_col(self.text, pos)

    # -- file-level constants and typedefs -------------------------------

    def _read_file_level(self) -> None:
        text = self.text
        for m in re.finditer(r"\btypedef\s+([\w\s]+?)\s+(\w+)\s*;", text):
            if self.at_file_level(m.start()):
                size = type_bytes(m.group(1), self.types)
                if size is not None:
                    self.types[m.group(2)] = size
        for m in re.finditer(r"\busing\s+(\w+)\s*=\s*([\w\s]+?)\s*;", text):
            if self.at_file_level(m.start()):
                size = type_bytes(m.group(2), self.types)
                if size is not None:
                    self.types[m.group(1)] = size
        for m in re.finditer(
                r"\b(?:static\s+)?constexpr\s+" + _INT_TYPE
                + r"\s+([^;]*);", text):
            if not self.at_file_level(m.start()):
                continue
            offset = m.start(1)
            for decl in _split_top(m.group(1)):
                d = re.match(r"(\w+)\s*=\s*(.+)$", decl, re.S)
                if d is not None:
                    value = evaluate(d.group(2), self.consts, self.types)
                    if value is not None:
                        self.consts[d.group(1)] = value
                        self.const_pos[d.group(1)] = text.find(
                            d.group(1), offset)

    # -- kernels ---------------------------------------------------------

    def _read_kernels(self) -> List[Kernel]:
        text = self.text
        kernels = []
        for m in re.finditer(r"\b__global__\b", text):
            if not self.at_file_level(m.start()):
                continue
            head = text[:m.start()]
            cut = max(head.rfind(";"), head.rfind("}"), head.rfind("{"))
            tm = re.search(r"\btemplate\s*<(.*)>\s*$", head[cut + 1:], re.S)
            params: Tuple[str, ...] = ()
            if tm is not None:
                params = tuple(
                    re.sub(r"=.*$", "", p, flags=re.S).split()[-1]
                    for p in _split_top(tm.group(1)) if p.split())
            i = m.end()
            bounds, bounds_pos = None, -1
            while True:
                w = re.match(r"\s*(\w+)", text[i:])
                if w is None:
                    break
                word = w.group(1)
                if word == "__launch_bounds__":
                    p = i + w.end()
                    p = text.index("(", p)
                    close = _balanced(text, p)
                    args = _split_top(text[p + 1:close - 1])
                    bounds, bounds_pos = args[0], i + w.start(1)
                    i = close
                elif word in ("void", "static", "inline", "__noinline__",
                              "__forceinline__"):
                    i += w.end()
                else:
                    break
            nm = re.match(r"\s*(\w+)\s*\(", text[i:])
            if nm is None:
                continue
            name_pos = i + nm.start(1)
            close = _balanced(text, i + nm.end() - 1)
            open_ = text.find("{", close)
            scope = next((s for s in self.scopes if s.open == open_), None)
            if scope is None:
                continue
            body = (scope.open, scope.close)
            kernels.append(Kernel(nm.group(1), params, name_pos, bounds,
                                  bounds_pos, self._shared(body), body))
        return kernels

    def _shared(self, body: Tuple[int, int]) -> List[Shared]:
        out = []
        seg = self.text[body[0]:body[1]]
        for m in re.finditer(r"(\bextern\s+)?\b__shared__\b([^;]*);", seg):
            decl = m.group(2)
            align = 1
            for a in re.finditer(
                    r"\b(?:__align__|alignas)\s*\(\s*(\d+)\s*\)", decl):
                align = max(align, int(a.group(1)))
            decl = re.sub(r"\b(?:__align__|alignas)\s*\(\s*\d+\s*\)", " ",
                          decl)
            base_type = None
            for part in _split_top(decl):
                dims = tuple(d.strip() for d in
                             re.findall(r"\[([^\]]*)\]", part))
                words = re.sub(r"\[[^\]]*\]", " ", part).replace(
                    "*", " * ").split()
                if not words:
                    continue
                name = words[-1]
                if base_type is None:
                    base_type = " ".join(words[:-1])
                out.append(Shared(name, base_type, dims, align,
                                  bool(m.group(1))))
        return out

    def static_smem(self, kernel: Kernel,
                    bindings: Optional[Dict[str, int]] = None
                    ) -> Optional[int]:
        """Bytes of static shared memory ``kernel`` declares, laid out in
        declaration order at each array's alignment; None when a size does
        not resolve (with ``bindings`` for its template parameters, those
        resolve too)."""
        env = dict(self.consts)
        env.update(bindings or {})
        total = 0
        for s in kernel.shared:
            if s.extern:
                continue
            size = type_bytes(s.type, self.types)
            if size is None:
                return None
            count = 1
            for d in s.dims:
                v = evaluate(d, env, self.types)
                if v is None:
                    return None
                count *= v
            align = max(s.align, min(size, 16))
            total = -(-total // align) * align + size * count
        return total

    # -- launches and opt-ins ---------------------------------------------

    def _read_launches(self) -> List[Launch]:
        out = []
        for m in re.finditer(
                r"\b(\w+)\s*(?:<[^<>;{}]*>)?\s*<<<(.*?)>>>", self.text,
                re.S):
            args = _split_top(m.group(2))
            if len(args) < 2:
                continue
            out.append(Launch(m.group(1), args[1],
                              args[2] if len(args) > 2 else None,
                              m.start(1), m.end()))
        return out

    def _read_optins(self) -> List[OptIn]:
        out = []
        for m in re.finditer(r"\bcudaFuncSetAttribute\s*\(", self.text):
            close = _balanced(self.text, m.end() - 1)
            args = _split_top(self.text[m.end():close - 1])
            if len(args) == 3 and args[1] == _OPTIN_ATTR:
                kernel = re.match(r"[&\s]*(\w+)", args[0])
                if kernel is not None:
                    out.append(OptIn(kernel.group(1), args[2], m.start()))
        return out


# ---------------------------------------------------------------------------
# The checkers.
# ---------------------------------------------------------------------------


def check_cuda(path: Path, source: str) -> List[Finding]:
    """CUD201–CUD204, CUD206 and CUD207 over one ``.cu`` source."""
    cu = CudaFile(path, source)
    path = str(path)
    findings: List[Finding] = []

    def add(rule: str, pos: int, message: str) -> None:
        line, col = cu.line_col(pos)
        findings.append(Finding(rule, path, line, col, message))

    kernels = {k.name: k for k in cu.kernels}
    for k in cu.kernels:
        static = cu.static_smem(k)
        if static is not None and static > STATIC_SMEM_LIMIT:
            add("CUD201", k.pos,
                f"kernel `{k.name}` declares {static} B of static shared "
                f"memory, over the {STATIC_SMEM_LIMIT} B a block may "
                "declare; move it to dynamic shared memory and opt in")
        if k.bounds is not None:
            threads = evaluate(k.bounds, cu.consts, cu.types)
            if threads is not None and threads > MAX_THREADS_PER_BLOCK:
                add("CUD204", k.bounds_pos,
                    f"__launch_bounds__({threads}) of `{k.name}` is over "
                    f"the {MAX_THREADS_PER_BLOCK} threads a block may "
                    "have")
        for call in _RUNTIME_CALL.finditer(
                cu.text, k.body[0], k.body[1]):
            add("CUD207", call.start(),
                f"CUDA runtime call `{call.group(1)}()` inside kernel "
                f"`{k.name}`: the kernels build without relocatable "
                "device code, so the device runtime is not linked")

    for name, pos in sorted(cu.const_pos.items()):
        value = cu.consts[name]
        if _BUDGET_NAME.search(name) and value > OPTIN_SMEM_LIMIT:
            add("CUD202", pos,
                f"shared-memory budget `{name}` = {value} B is over the "
                f"{OPTIN_SMEM_LIMIT} B a block may opt into")
    opted = {o.kernel for o in cu.optins}
    for o in cu.optins:
        value = evaluate(o.value, cu.consts, cu.types)
        if value is not None and value > OPTIN_SMEM_LIMIT:
            add("CUD202", o.pos,
                f"opt-in of {value} B of dynamic shared memory for "
                f"`{o.kernel}` is over the {OPTIN_SMEM_LIMIT} B limit")

    for ln in cu.launches:
        threads = evaluate(ln.block, cu.consts, cu.types)
        if threads is not None and threads > MAX_THREADS_PER_BLOCK:
            add("CUD204", ln.pos,
                f"launch of `{ln.kernel}` with {threads} threads a block, "
                f"over the {MAX_THREADS_PER_BLOCK} a block may have")
        dyn = None if ln.smem is None else evaluate(ln.smem, cu.consts,
                                                    cu.types)
        k = kernels.get(ln.kernel)
        if dyn is not None and k is not None:
            static = cu.static_smem(k)
            if static is not None and dyn + static > OPTIN_SMEM_LIMIT:
                add("CUD202", ln.pos,
                    f"launch of `{ln.kernel}` asks {dyn} B of dynamic "
                    f"shared memory beside {static} B static, over the "
                    f"{OPTIN_SMEM_LIMIT} B limit")
        can_pass = ln.smem is not None and (dyn is None
                                            or dyn > STATIC_SMEM_LIMIT)
        if k is not None and k.extern_shared and can_pass \
                and ln.kernel not in opted:
            add("CUD203", ln.pos,
                f"`{ln.kernel}` takes dynamic shared memory that can pass "
                f"{STATIC_SMEM_LIMIT} B, but this file never calls "
                f"cudaFuncSetAttribute({ln.kernel}, {_OPTIN_ATTR}, ...): "
                "the launch would be refused")
        outer = [s for s in cu.enclosing(ln.pos) if s.kind == "code"]
        end = outer[0].close if outer else len(cu.text)
        if not _LAUNCH_STATUS.search(cu.text, ln.end, end):
            add("CUD206", ln.pos,
                f"launch of `{ln.kernel}` is not followed by "
                "cudaGetLastError() in its function: a refused launch "
                "would go unreported")
    return findings


def _branches_on(mod: ModuleInfo, qual: str) -> bool:
    """True if some ``if`` (statement or expression) tests a call of
    ``qual``."""
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.If, ast.IfExp, ast.While)):
            for sub in ast.walk(node.test):
                if isinstance(sub, ast.Call) \
                        and mod.qualname(sub.func) == qual:
                    return True
    return False


def check(mod: ModuleInfo) -> List[Finding]:
    """CUD205 over one Python module."""
    loads = [n for n in ast.walk(mod.tree)
             if isinstance(n, ast.Call) and mod.qualname(n.func) == BUILD_LOAD]
    if not loads:
        return []
    path = str(mod.path)
    imports_backend = any(
        v == BACKEND_MODULE or v.startswith(BACKEND_MODULE + ".")
        for v in (*mod.aliases.values(), *mod.from_imports.values()))
    if not imports_backend:
        return [Finding(
            "CUD205", path, 1, 0,
            "module loads a CUDA kernel (_build.load) but never imports "
            f"{BACKEND_MODULE}: a CPU tensor needs the plain version")]
    if not _branches_on(mod, USES_KERNEL):
        first = loads[0]
        return [Finding(
            "CUD205", path, first.lineno, first.col_offset,
            "module loads a CUDA kernel but never branches on "
            "backend.uses_kernel(...): only a CUDA tensor may reach the "
            "kernel, a CPU tensor takes the plain version")]
    return []


# ---------------------------------------------------------------------------
# Against ptxas: the static figures beside the compiler's.
# ---------------------------------------------------------------------------

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_TEMPLATE_ARG = re.compile(r"L([a-z])(n?)(\d+)E")


def ptxas_smem(log: str) -> List[Tuple[str, int]]:
    """(mangled entry name, static shared-memory bytes) of every entry
    function in an ``nvcc -Xptxas -v`` report (0 where ptxas prints no
    ``bytes smem``)."""
    marks = list(_ENTRY.finditer(log))
    out = []
    for i, m in enumerate(marks):
        seg = log[m.end():marks[i + 1].start() if i + 1 < len(marks)
                  else len(log)]
        used = re.search(r"Used \d+ registers[^\n]*", seg)
        smem = re.search(r"(\d+) bytes smem", used.group(0)) if used \
            else None
        out.append((m.group(1), int(smem.group(1)) if smem else 0))
    return out


def template_args(mangled: str, name: str) -> Optional[Tuple[int, ...]]:
    """The integer and bool template arguments of kernel ``name`` in an
    Itanium-mangled entry name (() for a plain function); None when the
    entry is not ``name``'s or an argument is not a literal."""
    m = re.search(str(len(name)) + re.escape(name), mangled)
    if m is None:
        return None
    rest = mangled[m.end():]
    if not rest.startswith("I"):
        return ()
    args, i = [], 1
    while i < len(rest) and rest[i] != "E":
        a = _TEMPLATE_ARG.match(rest, i)
        if a is None:
            return None
        args.append(-int(a.group(3)) if a.group(2) else int(a.group(3)))
        i = a.end()
    return tuple(args)


@dataclasses.dataclass(frozen=True)
class SmemRow:
    label: str                      # kernel<args>
    lint: Optional[int]             # the lint's static figure, if resolved
    ptxas: int


def compare_ptxas(path: Path, log: str) -> List[SmemRow]:
    """For each entry function of ``path``'s ptxas report, the lint's
    static shared memory (its template arguments bound from the mangled
    name) beside ptxas's ``bytes smem``."""
    cu = CudaFile(path, path.read_text())
    rows = []
    for mangled, smem in ptxas_smem(log):
        for k in cu.kernels:
            args = template_args(mangled, k.name)
            if args is None:
                continue
            bindings = dict(zip(k.params, args)) \
                if len(args) == len(k.params) else None
            lint = cu.static_smem(k, bindings) if bindings is not None \
                else None
            label = k.name + (f"<{', '.join(map(str, args))}>"
                              if args else "")
            rows.append(SmemRow(label, lint, smem))
            break
        else:
            rows.append(SmemRow(mangled, None, smem))
    return rows


def kernel_table(paths: Sequence[Path]) -> Dict[str, Dict[str, object]]:
    """kernel -> its file, template parameters, static shared memory
    (None where a size depends on a template argument or the run) and
    whether it takes dynamic shared memory, for every ``.cu`` in
    ``paths``."""
    table: Dict[str, Dict[str, object]] = {}
    for p in paths:
        cu = CudaFile(p, p.read_text())
        for k in cu.kernels:
            table[k.name] = {"file": str(p), "params": k.params,
                             "static_smem": cu.static_smem(k),
                             "dynamic_smem": k.extern_shared}
    return table
