"""The port's static-analysis suite (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

The reference's DET, CON and suppression fixtures go through both
packages (the CON ones with the register import, the README's engine
column and the parity file rewritten to the port's) and must give the same
``(rule, line, col)`` findings and the same ``--fix`` rewrite.  DET305 and
every CUD rule flag a seeded fixture and pass its clean twin; the port's
tree lints clean; the trace gate passes on the CPU, covers every port
engine and format, has a passing case for every case of the reference's
gate, and fails a seeded shape breakage.  The gate's card run is in
``tests/test_torch_kernels_cuda.py``.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis import analyze_paths as ref_analyze
from repro.analysis import trace_gate as ref_gate
from repro.analysis.core import apply_fixes as ref_apply_fixes
from repro.analysis.core import parse_suppressions as ref_suppressions
from repro_torch.analysis import analyze_paths
from repro_torch.analysis import cuda_lint, trace_gate
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.contracts import readme_engines
from repro_torch.analysis.core import apply_fixes, parse_suppressions
from repro_torch.kernels import bitplane_pack
from repro_torch.sort import registry

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"
CSRC = SRC / "repro_torch" / "kernels" / "csrc"
ENV = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}

_REGISTER = """
    from repro.sort.registry import register

    @register("{name}", mode="latency")
    def {fn}(x, **kw):
        return x
"""

# the reference's fixtures (tests/test_analysis.py): name -> files
FIXTURES = {
    "det301_stdlib_random": {"fixture.py": """
        import random

        def backoff():
            return 0.5 * random.random()
    """},
    "det302_np_random_legacy": {"fixture.py": """
        import numpy as np

        def noise(n):
            return np.random.rand(n)
    """},
    "det302_unseeded_default_rng": {"fixture.py": """
        import numpy as np

        def gen():
            return np.random.default_rng()
    """},
    "det302_seeded_default_rng_clean": {"clean.py": """
        import numpy as np

        def gen(seed):
            return np.random.default_rng(seed)
    """},
    "det303_time_time": {"fixture.py": """
        import time

        def measure(fn):
            t0 = time.time()
            fn()
            return time.time() - t0
    """},
    "det304_unsorted_registry_iteration": {"fixture.py": """
        from repro.sort.registry import available_engines

        def report():
            for name in available_engines():
                print(name)
    """},
    "det304_sorted_clean": {"clean.py": """
        from repro.sort.registry import available_engines

        def report():
            for name in sorted(available_engines()):
                print(name)
    """},
    "con401_invalid_register_site": {"fixture.py": """
        from repro.sort.registry import register

        @register("bogus", mode="warpspeed", turbo=True)
        def bogus(x, **kw):
            return x
    """},
    "con405_resilient_unregistered_base": {"fixture.py": """
        from repro.sort.registry import register

        @register("real", mode="latency")
        def real(x, **kw):
            return x

        WRAPPED = "resilient:ghost"
    """},
    "con406_duplicate_registration": {
        "a.py": _REGISTER.format(name="dup", fn="a"),
        "b.py": _REGISTER.format(name="dup", fn="b")},
    "con402_403_404_readme_and_parity": {
        "README.md": "| engine | mode |\n|---|---|\n| `ghost` | latency |\n",
        "tests/test_sort_engine.py": "def test_nothing():\n    pass\n",
        "eng.py": _REGISTER.format(name="real", fn="real")},
    "con404_dynamic_parity_sweep_clean": {
        "README.md": "| engine | mode |\n|---|---|\n| `real` | latency |\n",
        "tests/test_sort_engine.py":
            "from repro.sort.registry import available_engines\n"
            "def test_all():\n"
            "    for name in sorted(available_engines()):\n"
            "        pass\n",
        "eng.py": _REGISTER.format(name="real", fn="real")},
    "line_suppression": {"fixture.py": """
        import random

        def backoff():
            return 0.5 * random.random()  # lint: disable=DET301
    """},
    "file_suppression": {"fixture.py": """
        # lint: disable-file=DET301
        import random

        def a():
            return random.random()

        def b():
            return random.random()
    """},
    "suppression_is_rule_specific": {"fixture.py": """
        import random

        def backoff():
            return 0.5 * random.random()  # lint: disable=DET302
    """},
}


def _to_port(rel: str, text: str):
    """A reference fixture file as the port's lint reads it: the port's
    registry, its README engine column, its parity file."""
    rel = rel.replace("test_sort_engine.py", "test_torch_sort.py")
    text = text.replace("repro.sort", "repro_torch.sort")
    text = text.replace("| engine |", "| port engine |")
    return rel, text


def _write(root: Path, files, port: bool) -> Path:
    for rel, text in files.items():
        text = textwrap.dedent(text)
        if port:
            rel, text = _to_port(rel, text)
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    return root


def _located(findings):
    return sorted((f.rule, Path(f.path).name, f.line, f.col)
                  for f in findings)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reference_fixture_gives_the_same_findings(tmp_path, name):
    ref = _write(tmp_path / "ref", FIXTURES[name], port=False)
    port = _write(tmp_path / "port", FIXTURES[name], port=True)
    want, n_ref = ref_analyze([ref])
    got, n_port = analyze_paths([port])
    assert n_port == n_ref
    got_loc = [(r, "test_sort_engine.py" if p == "test_torch_sort.py"
                else p, ln, c) for r, p, ln, c in _located(got)]
    assert got_loc == _located(want)
    if not name.endswith("clean") and "suppression" not in name:
        assert got, "a seeded fixture must give findings"


def test_fix_rewrites_as_the_reference_does(tmp_path):
    files = FIXTURES["det303_time_time"]
    ref = _write(tmp_path / "ref", files, port=False)
    port = _write(tmp_path / "port", files, port=True)
    assert apply_fixes(analyze_paths([port])[0]) == \
        ref_apply_fixes(ref_analyze([ref])[0]) == 2
    text = (port / "fixture.py").read_text()
    assert text == (ref / "fixture.py").read_text()
    assert "time.monotonic()" in text and "time.time()" not in text
    assert analyze_paths([port])[0] == []


def test_parse_suppressions_as_the_reference_does():
    src = ("x = 1  # lint: disable=TRC101, DET303\n"
           "# lint: disable-file=PAL205\n"
           "y = 2  # lint: disable\n")
    assert parse_suppressions(src) == ref_suppressions(src)
    cu = ("int x = 1;  // lint: disable=CUD204, CUD206\n"
          "// lint: disable-file=CUD201\n"
          "#include <cuda_runtime.h>\n")
    assert parse_suppressions(cu, "//") == ({1: {"CUD204", "CUD206"}},
                                            {"CUD201"})


# ---------------------------------------------------------------------------
# DET305: torch's global generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source, count", [
    ("import torch\nx = torch.randn(3, 4)\n", 1),
    ("import torch\nx = torch.rand(3)\ny = torch.randint(0, 5, (3,))\n"
     "z = torch.randperm(4)\n", 3),
    ("import torch\nt = torch.zeros(3)\nx = torch.rand_like(t)\n"
     "y = torch.multinomial(t, 1)\nz = torch.normal(t, 1.0)\n"
     "w = torch.bernoulli(t)\nv = torch.poisson(t)\n", 5),
    ("import torch\nt = torch.empty(3)\nt.uniform_()\nt.normal_(0, 1)\n"
     "t.random_(5)\nt.bernoulli_(0.5)\nt.exponential_()\n", 5),
    ("import torch\nfrom torch.nn import init\nw = torch.empty(3, 3)\n"
     "init.kaiming_uniform_(w)\ntorch.nn.init.normal_(w)\n", 2),
    ("import torch\ntorch.manual_seed(0)\ntorch.cuda.manual_seed_all(0)\n"
     "torch.seed()\ntorch.cuda.manual_seed(1)\n", 4),
    ("import torch as T\nx = T.randn(2, generator=None)\nT.manual_seed(3)\n",
     1),
])
def test_det305_flags_the_global_generator(tmp_path, source, count):
    (tmp_path / "f.py").write_text(source)
    findings, _ = analyze_paths([tmp_path / "f.py"])
    assert [f.rule for f in findings] == ["DET305"] * count


def test_det305_passes_seeded_generators(tmp_path):
    (tmp_path / "f.py").write_text(textwrap.dedent("""
        import numpy as np
        import torch

        def make(seed, shape):
            g = torch.Generator().manual_seed(seed)
            x = torch.randn(shape, generator=g)
            w = torch.empty(shape).uniform_(-1, 1, generator=g)
            torch.nn.init.normal_(w, generator=g)
            u = torch.rand(shape, generator=g, device="cpu")
            rng = np.random.default_rng(seed)
            return x, w, u, rng.normal(size=3), torch.normal(x, 1.0,
                                                             generator=g)
    """))
    assert analyze_paths([tmp_path / "f.py"])[0] == []


# ---------------------------------------------------------------------------
# CUD2xx: a seeded fixture and its clean twin for every rule
# ---------------------------------------------------------------------------

_CU_HEAD = "#include <cuda_runtime.h>\n"

CUD_FIXTURES = {
    "CUD201": ("""
        constexpr int kTile = 128;
        __global__ void __launch_bounds__(256) big(float* y) {
          __shared__ float a[kTile][kTile];  // 64 KiB
          y[threadIdx.x] = a[0][threadIdx.x];
        }
        int run(float* y, cudaStream_t s) {
          big<<<1, 256, 0, s>>>(y);
          return (int)cudaGetLastError();
        }
    """, """
        constexpr int kTile = 64;
        __global__ void __launch_bounds__(256) big(float* y) {
          __shared__ float a[kTile][kTile];  // 16 KiB
          y[threadIdx.x] = a[0][threadIdx.x];
        }
        template <int T>
        __global__ void sized(float* y) {
          __shared__ float b[T][T];  // a template argument's size: exempt
          y[threadIdx.x] = b[0][threadIdx.x];
        }
        int run(float* y, cudaStream_t s) {
          big<<<1, 256, 0, s>>>(y);
          sized<256><<<1, 256, 0, s>>>(y);
          return (int)cudaGetLastError();
        }
    """, 1),
    "CUD202": ("""
        constexpr int kSmem = 240 * 1024;
        __global__ void dyn(float* y) {
          extern __shared__ float buf[];
          y[threadIdx.x] = buf[threadIdx.x];
        }
        int run(float* y, cudaStream_t s) {
          cudaFuncSetAttribute(dyn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
          dyn<<<1, 256, kSmem, s>>>(y);
          return (int)cudaGetLastError();
        }
    """, """
        constexpr int kSmem = 200 * 1024;
        __global__ void dyn(float* y) {
          extern __shared__ float buf[];
          y[threadIdx.x] = buf[threadIdx.x];
        }
        int run(float* y, cudaStream_t s) {
          cudaFuncSetAttribute(dyn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
          dyn<<<1, 256, kSmem, s>>>(y);
          return (int)cudaGetLastError();
        }
    """, 3),
    "CUD203": ("""
        __global__ void dyn(float* y, int n) {
          extern __shared__ float buf[];
          if (threadIdx.x < n) y[threadIdx.x] = buf[threadIdx.x];
        }
        int run(float* y, int n, cudaStream_t s) {
          const size_t bytes = (size_t)n * sizeof(float);
          dyn<<<1, 256, bytes, s>>>(y, n);
          return (int)cudaGetLastError();
        }
    """, """
        __global__ void dyn(float* y, int n) {
          extern __shared__ float buf[];
          if (threadIdx.x < n) y[threadIdx.x] = buf[threadIdx.x];
        }
        int run(float* y, int n, cudaStream_t s) {
          const size_t bytes = (size_t)n * sizeof(float);
          cudaError_t e = cudaFuncSetAttribute(
              dyn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
          if (e != cudaSuccess) return (int)e;
          dyn<<<1, 256, bytes, s>>>(y, n);
          dyn<<<1, 256, 1024, s>>>(y, n);
          return (int)cudaGetLastError();
        }
    """, 1),
    "CUD204": ("""
        constexpr int kThreads = 2048;
        __global__ void __launch_bounds__(kThreads) wide(float* y) {
          y[threadIdx.x] = 0.f;
        }
        int run(float* y, cudaStream_t s) {
          wide<<<1, kThreads, 0, s>>>(y);
          return (int)cudaGetLastError();
        }
    """, """
        constexpr int kThreads = 1024;
        __global__ void __launch_bounds__(kThreads) wide(float* y) {
          y[threadIdx.x] = 0.f;
        }
        int run(float* y, cudaStream_t s) {
          wide<<<1, kThreads, 0, s>>>(y);
          return (int)cudaGetLastError();
        }
    """, 2),
    "CUD206": ("""
        __global__ void k(float* y) { y[threadIdx.x] = 0.f; }
        int run(float* y, cudaStream_t s) {
          k<<<1, 32, 0, s>>>(y);
          return 0;
        }
    """, """
        __global__ void k(float* y) { y[threadIdx.x] = 0.f; }
        int run(float* y, cudaStream_t s) {
          k<<<1, 32, 0, s>>>(y);
          return (int)cudaPeekAtLastError();
        }
    """, 1),
    "CUD207": ("""
        __global__ void k(float* y) {
          y[threadIdx.x] = 0.f;
          cudaDeviceSynchronize();
        }
        int run(float* y, cudaStream_t s) {
          k<<<1, 32, 0, s>>>(y);
          return (int)cudaGetLastError();
        }
    """, """
        __global__ void k(float* y) {
          const char* s = "cudaDeviceSynchronize()";  // a string, not a call
          y[threadIdx.x] = s[0];
        }
        int run(float* y, cudaStream_t s) {
          k<<<1, 32, 0, s>>>(y);
          cudaError_t e = cudaGetLastError();
          if (e == cudaSuccess) e = cudaStreamSynchronize(s);
          return (int)e;
        }
    """, 1),
}

_WRAPPER_HEAD = """
        import ctypes
        import torch
        from repro_torch.kernels import _build
"""
PY_FIXTURES = {
    "no_backend_import": (_WRAPPER_HEAD + """
        def run(x):
            return _build.load("k").k_launch(x.data_ptr())
    """, 1),
    "no_branch": (_WRAPPER_HEAD + """
        from repro_torch.kernels import backend

        def run(x):
            backend.resolve_device(x.device)
            return _build.load("k").k_launch(x.data_ptr())
    """, 1),
    "clean": (_WRAPPER_HEAD + """
        from repro_torch.kernels import backend

        def run(x):
            if backend.uses_kernel(x):
                return _build.load("k").k_launch(x.data_ptr())
            return x.clone()
    """, 0),
}


def _lint_cu(tmp_path, name, source):
    f = tmp_path / name
    f.write_text(_CU_HEAD + textwrap.dedent(source))
    findings, n = analyze_paths([f])
    assert n == 1
    return findings


@pytest.mark.parametrize("rule", sorted(CUD_FIXTURES))
def test_cud_rule_flags_its_fixture_and_passes_the_twin(tmp_path, rule):
    bad, clean, count = CUD_FIXTURES[rule]
    got = _lint_cu(tmp_path, "bad.cu", bad)
    assert [f.rule for f in got] == [rule] * count, got
    assert _lint_cu(tmp_path, "clean.cu", clean) == []


@pytest.mark.parametrize("name", sorted(PY_FIXTURES))
def test_cud205_plain_version_dispatch(tmp_path, name):
    source, count = PY_FIXTURES[name]
    (tmp_path / "wrapper.py").write_text(textwrap.dedent(source))
    findings, _ = analyze_paths([tmp_path / "wrapper.py"])
    assert [f.rule for f in findings] == ["CUD205"] * count


def test_cud_suppression_and_select(tmp_path):
    bad = CUD_FIXTURES["CUD204"][0].replace(
        "wide<<<1, kThreads, 0, s>>>(y);",
        "wide<<<1, kThreads, 0, s>>>(y);  // lint: disable=CUD204")
    got = _lint_cu(tmp_path, "bad.cu", bad)
    assert [(f.rule, f.line) for f in got] == [("CUD204", 4)]
    f = tmp_path / "bad.cu"
    assert analyze_paths([f], select={"DET"})[0] == []
    assert len(analyze_paths([f], select={"CUD"})[0]) == 1


def test_cuda_parser_reads_the_ports_kernels():
    table = cuda_lint.kernel_table(sorted(CSRC.glob("*.cu")))
    assert {"fused_tns_kernel", "dr_warp_kernel", "dr_block_kernel",
            "pack_kernel", "topk_warp_kernel", "topk_select_kernel",
            "topk_rounds_kernel", "mm_bf16_kernel", "mm_f32_kernel",
            "mm_wgmma_kernel", "decode_scores_kernel",
            "decode_values_kernel", "decode_combine_kernel"} == set(table)
    # bf16 As[128 * 40] + Bs[32 * 136] + float stage[8][256]
    assert table["mm_bf16_kernel"]["static_smem"] == 10240 + 8704 + 8192
    assert table["mm_f32_kernel"]["static_smem"] == 16 * 68 * 4 + 16 * 64 * 4
    assert table["topk_rounds_kernel"]["static_smem"] is None   # NW
    assert table["fused_tns_kernel"]["dynamic_smem"]
    assert table["pack_kernel"]["static_smem"] == 0
    # float wt[GM * 256] + red[4 * GM]: by the group's registers GM
    assert table["decode_values_kernel"]["static_smem"] is None
    assert table["decode_scores_kernel"]["static_smem"] == 0
    cu = cuda_lint.CudaFile(CSRC / "decode_attn.cu",
                            (CSRC / "decode_attn.cu").read_text())
    values = next(k for k in cu.kernels if k.name == "decode_values_kernel")
    assert [cu.static_smem(values, {"DT": 1, "GM": gm})
            for gm in (1, 8)] == [1040, 8320]
    cu = cuda_lint.CudaFile(CSRC / "masked_matmul.cu",
                            (CSRC / "masked_matmul.cu").read_text())
    assert cu.consts["kGemmSmem"] == 230464 <= cuda_lint.OPTIN_SMEM_LIMIT


def test_evaluate_reads_c_integer_expressions():
    env = {"kA": 6, "W": 2}
    assert cuda_lint.evaluate("W == 1 ? 32 * kA : 32", env) == 32
    assert cuda_lint.evaluate("(int)sizeof(uint64_t) * -7 / 2", env) == -28
    assert cuda_lint.evaluate("1u << 4 | 0x3", env) == 19
    assert cuda_lint.evaluate("kA % 4 + (kA > 5 && !0)", env) == 3
    assert cuda_lint.evaluate("n * 4", env) is None


_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{bf16}' for 'sm_90a'
ptxas info    : Function properties for {bf16}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 27136 bytes smem, \
392 bytes cmem[0]
ptxas info    : Compiling entry function '{rounds}' for 'sm_90a'
ptxas info    : Function properties for {rounds}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 512 bytes smem, \
388 bytes cmem[0]
ptxas info    : Compiling entry function '{block}' for 'sm_90a'
ptxas info    : Function properties for {block}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, 380 bytes cmem[0]
""".format(bf16="_ZN12_GLOBAL__N_114mm_bf16_kernelILb1EEEvPK13__nv_bfloat16"
                "S3_PKhPS1_iii",
           rounds="_ZN12_GLOBAL__N_118topk_rounds_kernelILi2EEEvPKjPiS3_iiii",
           block="_ZN12_GLOBAL__N_115dr_block_kernelEPKhPbPiiiih")


def test_ptxas_report_is_read_and_matched_to_the_lint():
    assert [s for _, s in cuda_lint.ptxas_smem(_PTXAS)] == [27136, 512, 0]
    assert cuda_lint.template_args(
        "_ZN12_GLOBAL__N_118topk_rounds_kernelILi2EEEvPKj",
        "topk_rounds_kernel") == (2,)
    assert cuda_lint.template_args(
        "_ZN12_GLOBAL__N_114dr_warp_kernelILi3ELb0EEEvPKh",
        "dr_warp_kernel") == (3, 0)
    # each file's entries matched to its kernels, template arguments bound
    rows = cuda_lint.compare_ptxas(CSRC / "masked_matmul.cu", _PTXAS)
    assert rows[0] == cuda_lint.SmemRow("mm_bf16_kernel<1>", 27136, 27136)
    rows = cuda_lint.compare_ptxas(CSRC / "radix_topk.cu", _PTXAS)
    assert rows[1] == cuda_lint.SmemRow("topk_rounds_kernel<2>", 512, 512)
    rows = cuda_lint.compare_ptxas(CSRC / "digit_read.cu", _PTXAS)
    assert rows[2] == cuda_lint.SmemRow("dr_block_kernel", 0, 0)


# ---------------------------------------------------------------------------
# The port's tree and the CLI
# ---------------------------------------------------------------------------


def test_port_tree_has_zero_findings():
    findings, n_files = analyze_paths([SRC / "repro_torch",
                                       REPO / "chip_smoke.py"])
    assert n_files > 80
    assert findings == [], "\n".join(f.format() for f in findings)


def test_walker_skips_build_dirs_only_below_the_root(tmp_path):
    # a tree unpacked under a directory named build is linted whole; a
    # build directory inside it is skipped
    root = tmp_path / "build" / "tree"
    (root / "build").mkdir(parents=True)
    (root / "a.py").write_text("import random\nx = random.random()\n")
    (root / "k.cu").write_text(_CU_HEAD + "__global__ void k() {}\n")
    (root / "build" / "b.py").write_text("import random\n")
    findings, n = analyze_paths([root])
    assert n == 2 and [f.rule for f in findings] == ["DET301"]


def test_readme_port_table_is_the_registry():
    names = {n for n in registry.available_engines()
             if not n.startswith("resilient:")}
    assert set(readme_engines(REPO)) == names


def test_cli_exit_codes(tmp_path):
    clean = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                           capture_output=True, text=True, cwd=REPO, env=ENV)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "0 finding(s)" in clean.stderr
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\nx = torch.randn(3)\n")
    dirty = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", str(bad)],
        capture_output=True, text=True, cwd=REPO, env=ENV)
    assert dirty.returncode == 1 and "DET305" in dirty.stdout
    gate = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", str(tmp_path),
         "--select", "CUD", "--trace-gate", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=ENV)
    assert gate.returncode == 0, gate.stdout + gate.stderr
    assert "0 failed" in gate.stdout


def test_gate_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--trace-gate", str(SRC / "repro_torch" / "tree.py")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace_gate.run_gate()


# ---------------------------------------------------------------------------
# The trace gate on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gates():
    return ref_gate.run_gate(), trace_gate.run_gate(device="cpu")


def test_gate_passes_on_current_tree(gates):
    _, results = gates
    assert results
    bad = [r for r in results if not r.ok]
    assert bad == [], "\n".join(r.format() for r in bad)


def test_gate_covers_every_engine_and_format(gates):
    _, results = gates
    targets = {r.target for r in results}
    for name, spec in sorted(registry.available_engines().items()):
        assert f"engine:{name}" in targets
        cases = {r.case for r in results if r.target == f"engine:{name}"}
        for fmt in spec.formats:
            assert f"contract fmt={fmt}" in cases


def test_gate_has_every_reference_case(gates):
    ref, port = gates
    assert ref and all(r.ok for r in ref)
    passed = {(r.target, r.case) for r in port if r.ok}
    for r in ref:
        target = r.target.replace("pallas-", "fused-")
        assert (target, r.case) in passed, (r.target, r.case)
    assert len(port) == len(ref)


def test_gate_records_which_way_each_case_ran(gates):
    _, results = gates
    how = {}
    for r in results:
        how.setdefault(r.target.split(":")[0] if r.target.startswith(
            "engine:") else r.target, set()).add(r.how)
    assert how["engine"] == {"contract"}
    # host loops that read data: run for real on the tiny inputs
    for target in ("core:tns", "core:tns-batched", "core:ml",
                   "kernel:fused_tns"):
        assert how[target] == {"host"}, target
    for target in ("core:radix", "kernel:radix_topk", "kernel:min_search",
                   "kernel:pack_keys", "kernel:pruned_matmul"):
        assert how[target] == {"fake"}, target


def test_gate_catches_shape_breakage(monkeypatch):
    def broken():
        raise TypeError("rank mismatch")

    r = trace_gate._run("engine:x", "case", broken)
    assert not r.ok and "rank mismatch" in r.detail

    # a kernel entry whose output lost its batch axis
    pack = bitplane_pack.pack_keys
    monkeypatch.setattr(bitplane_pack, "pack_keys",
                        lambda x: pack(x).reshape(-1))
    results = trace_gate.run_gate(ns=(8,), ks=(2,), device="cpu")
    bad = [r for r in results if not r.ok]
    assert [r.target for r in bad] == ["kernel:pack_keys"]
    assert "keys: shape (16,) != expected (2, 8)" in bad[0].detail
