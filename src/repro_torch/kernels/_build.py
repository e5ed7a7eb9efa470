"""Build and load the CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so`` at
the repository root (the hash is of the source, so an edited kernel is
never served from a stale library), then loads through ``ctypes``.  No
PyTorch headers are compiled, which keeps a build to seconds.  Nothing
happens at import: the first CUDA call of a wrapper builds its library,
and :func:`build` builds several at once, one ``nvcc`` each, in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build this
# process ran, by kernel name
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").is_file():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def kernel_names() -> List[str]:
    """Every kernel in ``csrc/``, by name (the ``.cu`` file's stem)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Iterable[str]) -> None:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all started together; raise on the first that
    fails, with the compiler's output."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` report (registers, shared memory, spills) of
    kernel ``name``: this process's build log where it built the library,
    else a report compiled anew from the same source and device flags
    with ``-cubin`` into a temporary directory under ``build/kernels/`` (a
    library loaded from an earlier build leaves no report)."""
    if name in build_logs:
        return build_logs[name]
    host_only = ("-shared", "-Xcompiler", "-fPIC")
    flags = [f for f in NVCC_FLAGS if f not in host_only]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        proc = subprocess.run(
            [_nvcc(), *flags, "-cubin", "-o", str(Path(tmp) / f"{name}.cubin"),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -cubin failed for {name}.cu:\n"
                           f"{proc.stdout}")
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
