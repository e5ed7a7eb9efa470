"""The port's ``sort()`` facade and engines against the reference
package's, on the same seeded numpy inputs, through ``device="cpu"``
(the kernels' plain PyTorch versions); plus the facade's guards, and the
rule that the port imports nothing of JAX or of the reference package."""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import sort as jsort
from repro.sort import api as japi
from repro_torch import sort as tsort
from repro_torch.sort import api as tapi

REPO = Path(__file__).resolve().parent.parent
FMT_DATA = {
    "unsigned": (lambda r, s: r.integers(0, 256, s).astype(np.uint8), 8),
    "twos": (lambda r, s: r.integers(-128, 128, s).astype(np.int8), 8),
    "signmag": (lambda r, s: r.integers(-2**14, 2**14, s), 16),
    "float": (lambda r, s: r.standard_normal(s).astype(np.float16), 16),
}
# reference engine -> the port's engine of the same function
ENGINE_MAP = {"tns": "tns", "ml": "ml", "mb": "mb", "bts": "bts",
              "bitslice": "bitslice",
              "pallas-tns": "fused-tns", "tns-oracle": "tns-oracle",
              "pallas-topk": "fused-topk", "radix": "radix"}


def _data(fmt, shape, seed):
    gen, width = FMT_DATA[fmt]
    return gen(np.random.default_rng(seed), shape), width


def _assert_same_result(got, want):
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.values, want.values)
    for f in ("cycles", "drs", "reload_cycles"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f in ("fmt", "width", "n", "strategy", "k", "level_bits", "banks"):
        assert getattr(got, f) == getattr(want, f), f
    gm, wm = got.metrics(), want.metrics()
    if gm is None or wm is None:      # engines that report no cycles
        assert gm is None and wm is None
        return
    assert dataclasses.asdict(gm) == pytest.approx(dataclasses.asdict(wm),
                                                   rel=1e-12)


@pytest.mark.parametrize("ref_engine", list(ENGINE_MAP))
@pytest.mark.parametrize("fmt", list(FMT_DATA))
@pytest.mark.parametrize("shape, stop_after", [((24,), 6), ((2, 24), 6),
                                               ((12,), None)])
def test_engine_matches_reference(ref_engine, fmt, shape, stop_after):
    x, width = _data(fmt, shape, seed=len(shape) * 7 + len(fmt))
    kw = dict(fmt=fmt, width=width, k=2, stop_after=stop_after)
    if fmt not in jsort.get_engine(ref_engine).formats:
        # bitslice runs unsigned data only, in both packages
        with pytest.raises(ValueError, match="does not support fmt"):
            tsort.sort(x, engine=ENGINE_MAP[ref_engine], device="cpu", **kw)
        with pytest.raises(ValueError, match="does not support fmt"):
            jsort.sort(x, engine=ref_engine, **kw)
        return
    want = jsort.sort(x, engine=ref_engine, **kw)
    got = tsort.sort(x, engine=ENGINE_MAP[ref_engine], device="cpu", **kw)
    assert got.engine == ENGINE_MAP[ref_engine]
    _assert_same_result(got, want)


@pytest.mark.parametrize("ascending", [True, False])
def test_fused_engine_infers_format_and_direction(ascending):
    x, _ = _data("float", (3, 40), seed=3)
    want = jsort.sort(x, engine="pallas-tns", k=0, ascending=ascending,
                      stop_after=5)
    got = tsort.sort(x, engine="fused-tns", k=0, ascending=ascending,
                     stop_after=5, device="cpu")
    _assert_same_result(got, want)
    assert got.fmt == "float" and got.width == 16


@pytest.mark.parametrize("x, kw", [
    (np.zeros(8, np.uint8), dict(level_bits=2)),
    (np.zeros(1 << 15, np.uint8), {}),
    (np.zeros(8, np.float32), {}),
], ids=["level_bits", "n", "width"])
def test_fused_engine_guards(x, kw):
    with pytest.raises(NotImplementedError) as got:
        tsort.sort(x, engine="fused-tns", device="cpu", **kw)
    with pytest.raises(NotImplementedError) as want:
        jsort.sort(x, engine="pallas-tns", **kw)
    # the same bound, named after the port's engine (the reasons given in
    # parentheses are each package's own)
    bound = lambda e: str(e.value).split(" ", 1)[1].split(" (")[0]
    assert bound(got) == bound(want)


@pytest.mark.parametrize("shape, stop_after", [((40,), None),
                                               ((2, 50), 33)])
def test_fused_topk_extracts_at_most_32_minima(shape, stop_after):
    x = np.zeros(shape, np.uint8)
    with pytest.raises(NotImplementedError) as got:
        tsort.sort(x, engine="fused-topk", stop_after=stop_after,
                   device="cpu")
    with pytest.raises(NotImplementedError) as want:
        jsort.sort(x, engine="pallas-topk", stop_after=stop_after)
    assert str(got.value) == str(want.value).replace("pallas-topk",
                                                     "fused-topk")
    res = tsort.sort(x, engine="fused-topk", stop_after=32, device="cpu")
    assert res.indices.shape == shape[:-1] + (32,)


@pytest.mark.parametrize("width", [6, 12])
@pytest.mark.parametrize("ascending", [True, False])
def test_radix_engine_walks_the_key_container(width, ascending):
    # width 6 and 12 with r = 4: the reference sorts the uint8 / uint16
    # container's 8 / 16 bits
    x = np.random.default_rng(width).integers(0, 1 << width, (3, 30))
    kw = dict(fmt="unsigned", width=width, ascending=ascending)
    want = jsort.sort(x, engine="radix", **kw)
    got = tsort.sort(x, engine="radix", device="cpu", **kw)
    _assert_same_result(got, want)
    got_r = tsort.sort(x, engine="radix", device="cpu", r=2, **kw)
    np.testing.assert_array_equal(got_r.indices, want.indices)


def test_fused_engine_takes_no_tpu_grid_knobs():
    with pytest.raises(TypeError):
        tsort.sort(np.zeros(8, np.uint8), engine="fused-tns", device="cpu",
                   block_rows=2)


@pytest.mark.parametrize("x, fmt, width", [
    (np.zeros(4, np.float16), None, None),
    (np.zeros(4, np.float32), None, None),
    (np.zeros(4, np.int8), None, None),
    (np.zeros(4, np.uint16), None, None),
    (np.array([3, -200]), None, None),
    (np.array([70000]), None, None),
    (np.zeros(4, np.int64), "signmag", None),
    (np.zeros(4, np.uint8), None, 12),
])
def test_infer_fmt_width_matches_reference(x, fmt, width):
    assert tapi._infer_fmt_width(x, fmt, width) == \
        japi._infer_fmt_width(x, fmt, width)


def test_infer_fmt_width_refuses_what_the_reference_refuses():
    x = np.array([1 << 40])
    with pytest.raises(ValueError) as got:
        tapi._infer_fmt_width(x, None, None)
    with pytest.raises(ValueError) as want:
        japi._infer_fmt_width(x, None, None)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape", [(30,), (3, 30)])
def test_default_engine_is_tns(shape):
    x, _ = _data("float", shape, seed=11)
    got = tsort.sort(x, device="cpu")
    assert got.engine == "tns" and got.strategy == "tns"
    _assert_same_result(got, jsort.sort(x))


def test_sort_refuses_to_run_without_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsort.sort(np.arange(4, dtype=np.uint8), engine="fused-tns")
    res = tsort.sort(np.arange(4, dtype=np.uint8)[::-1], engine="fused-tns",
                     device="cpu")
    assert res.indices.tolist() == [3, 2, 1, 0]


def test_registry_is_the_ports_own():
    names = sorted(tsort.engines())
    inner = ["bitslice", "bts", "fused-tns", "fused-topk", "mb", "mb-ft",
             "ml", "radix", "tns", "tns-oracle"]
    assert names == sorted(inner + ["resilient:" + n for n in inner])
    assert "fused-topk" not in jsort.engines()
    assert "fused-tns" not in jsort.engines()
    spec = tsort.get_engine("fused-tns")
    assert spec.supports_batch and spec.strategy == "tns"
    with pytest.raises(ValueError):
        tsort.register("x", mode="bogus")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {mod}"


def test_port_runs_with_jax_and_the_reference_blocked():
    code = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np
from repro_torch import sort
from repro_torch.core import (catns, cost, device_model, radix_select,
                              ref_tns, tns)
from repro_torch.kernels import (bitplane_pack, digit_read, fused_tns,
                                 masked_matmul, ops, radix_topk)
from repro_torch.runtime import faults
from repro_torch.sort import resilient
for engine in ("tns", "ml", "mb", "bts", "bitslice", "fused-tns",
               "fused-topk", "radix", "resilient:tns", "mb-ft"):
    res = sort.sort(np.array([3, 1, 2], np.uint8), engine=engine,
                    device="cpu")
    assert res.indices.tolist() == [1, 2, 0], (engine, res.indices)
with faults.inject(faults.FaultSpec(ber=0.05, seed=1)):
    res = sort.sort(np.array([3, 1, 2, 7, 5, 4], np.uint8),
                    engine="resilient:tns", device="cpu")
assert res.indices.tolist() == [1, 2, 0, 5, 4, 3], res.indices
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
