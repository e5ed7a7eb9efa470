"""The harness on the CPU at tiny sizes: its import guard, its refusal
without a card, discovery of cells by name, and ``correct`` coming out
false when the timed path underneath is broken or the control stands in
for the program.  The card is never looked for here: ``run.run`` is
given the CPU."""
import json
import sys
import types

import pytest
import torch

from portbench import gen, run, trace
from portbench.tests.test_portbench_reference import TINY

ARGS = ["--workload", "sort-random-b4096", "--seed", "1", "--seconds", "1"]
# long enough, on a loaded host, for the checked rounds, answers and banks
WINDOW_S = 3.0


def test_forbidden_names_are_whole_top_level_names():
    assert run.forbidden_loaded(["repro_torch", "repro_torch.sort",
                                 "numpy.linalg", "reprox"]) == []
    assert run.forbidden_loaded(["repro.core.ref_tns", "repro_torch"]) == [
        "repro"]
    assert run.forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen",
                                 "jaxtyping"]) == ["flax", "jax", "jaxlib"]


@pytest.fixture
def quiet_env(monkeypatch):
    """The variables a run sets, put back as they were after the test."""
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "USE_FLAX",
              "OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)


def test_a_loaded_jax_package_gives_no_result(monkeypatch, capsys,
                                              quiet_env):
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    assert run.main(ARGS) == 2
    cap = capsys.readouterr()
    assert cap.out == ""
    assert "repro" in cap.err


def test_no_card_gives_no_result(monkeypatch, capsys, quiet_env):
    monkeypatch.setattr(run, "forbidden_loaded", lambda modules=None: [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) == 2
    cap = capsys.readouterr()
    assert cap.out == ""
    assert "CUDA" in cap.err


@pytest.fixture
def no_guard(monkeypatch):
    """The test process loads JAX and ``repro`` for other test files, which
    a run on the card refuses; the runs here judge everything else.  One
    thread: the tiny steps then keep their pace on a host shared by many
    test workers, and the windows finish what the checks need."""
    monkeypatch.setattr(run, "forbidden_loaded", lambda modules=None: [])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_sort(cfg):
    return dict(cfg, keys_per_bank=64, key_bits=8)


def _tiny_sort_mix(mix):
    return dict(mix, banks_per_call=2, pool=2, keep_per_call=2,
                check_banks=4, trace_units=2)


def test_new_files_are_found_by_name(tmp_path, monkeypatch, no_guard):
    """A configuration, a traffic mix and a per-layer metric added as new
    files, and named in the benchmark's entries, run with no file edited."""
    pb = tmp_path / "portbench"
    for d in ("configs", "traffic", "metrics"):
        (pb / d).mkdir(parents=True)
    cfg = json.loads((run.ROOT / "portbench" / "configs" /
                      "sim-array-n1024-w8.json").read_text())
    (pb / "configs" / "tiny-array.json").write_text(json.dumps(
        _tiny_sort(dict(cfg, name="tiny-array"))))
    (pb / "traffic" / "tiny-mix.json").write_text(json.dumps(
        _tiny_sort_mix(gen.load_mix("random-b4096"))))
    (pb / "metrics" / "calls_traced.tiny.py").write_text(
        "def read(t):\n    return float(t.counters['calls'])\n")
    bench = {
        "configs": [{"name": "tiny-array", "source": "x", "reduced": [],
                     "file": "portbench/configs/tiny-array.json", "why": "x"}],
        "workloads": [{"name": "tiny-cell", "config": "tiny-array",
                       "traffic": "tiny-mix", "chips": 1, "why": "x"}],
        "end_to_end": [
            {"name": "sort_keys_per_s", "unit": "keys/s", "better": "higher",
             "bound": 0.1, "source": "host_clock", "workloads": ["tiny-cell"]},
            {"name": "decode_tok_per_s", "unit": "tokens/s",
             "better": "higher", "bound": 0.1, "source": "host_clock",
             "workloads": ["another-cell"]},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"}],
        "per_layer": [
            {"name": "calls_traced.tiny", "unit": "calls", "better": "higher",
             "source": "program_counter", "layer": "x",
             "moves": "sort_keys_per_s"},
            {"name": "idle_share.decode", "unit": "%", "better": "lower",
             "source": "device_trace", "layer": "device",
             "moves": "decode_tok_per_s"}]}
    monkeypatch.setattr(run, "ROOT", tmp_path)
    monkeypatch.setattr(gen, "HERE", pb)
    monkeypatch.setattr(trace, "HERE", pb)
    out = run.run("tiny-cell", 4, WINDOW_S, False, "cpu", bench=bench)
    assert set(out["metrics"]) == {"sort_keys_per_s", "setup_s"}
    assert out["correct"]
    out = run.run("tiny-cell", 5, WINDOW_S, True, "cpu", bench=bench)
    assert out["metrics"] == {"calls_traced.tiny": {"value": 2.0,
                                                    "unit": "calls"}}
    assert list(out)[-1] == "checks"


def _lm(name, **mix):
    bench = run.load_bench()
    _, cfg, m = run.cell_inputs(bench, name)
    cfg = dict(cfg, **{k: v for k, v in TINY.items()
                       if k not in ("name", "port")}, torch_dtype="bfloat16")
    if m["kind"] == "decode":
        # answers much longer than the prompt, so that a cache left
        # unwritten changes most of what each step attends to
        m = dict(m, rows=4, prompt_len=4, answer_lens=[12, 16],
                 prefill_rows=2, trace_units=3)
    else:
        m = dict(m, lengths=[8, 16], check_from_rounds=4, check_rounds=2,
                 trace_units=2)
    # the tiny model's bf16 runs read a mean gap of 0 to 0.021, and a
    # sampled token's 0 to 0.006 (the cell's limits are set from readings
    # at its own size, PERF.md)
    if "topk_gap_mean_limit" in m:
        m = dict(m, topk_gap_mean_limit=0.03)
    return bench, cfg, dict(m, **dict({"logit_gap_mean_limit": 0.1}, **mix))


def _altered_answers(drv):
    from repro_torch import sort

    real = sort.sort

    def altered(x, **kw):
        res = real(x, **kw)
        res.indices = res.indices[:, ::-1].copy()
        return res

    orig = drv.setup

    def setup():
        orig()
        drv.sort = altered
    drv.setup = setup


def _altered_tokens(drv):
    orig = drv._choose
    drv._choose = lambda lg, greedy: (orig(lg, greedy) + 1) % lg.shape[-1]


def _altered_draws(drv):
    """The sampled rows' tokens moved to the next token id where they are
    drawn; greedy rows keep the argmax, so only sampled answers are wrong."""
    orig = drv._choose

    def choose(lg, greedy):
        out = orig(lg, greedy)
        if greedy is None:
            return out
        return torch.where(greedy, out, (out + 1) % lg.shape[-1])
    drv._choose = choose


def _state_unchanged(drv):
    from repro_torch.launch import steps
    orig = drv.setup

    def setup():
        orig()
        real = steps.make_decode_step(drv.arch)
        clone = lambda c: [{k: v.clone() for k, v in s.items()} for s in c]
        drv.decode = lambda p, t, z, c: real(p, t, z, clone(c))
    drv.setup = setup


@pytest.mark.parametrize("cell,fault", [
    ("sort-random-b4096", _altered_answers),
    ("qwen2moe-decode-b64", _altered_tokens),
    ("qwen2moe-decode-b64", _altered_draws),
    ("qwen2moe-decode-b64", _state_unchanged),
    ("qwen2moe-prefill-8k", _altered_tokens)])
def test_a_broken_timed_path_is_not_correct(cell, fault, no_guard):
    if cell.startswith("sort"):
        bench = run.load_bench()
        _, cfg, mix = run.cell_inputs(bench, cell)
        cfg, mix = _tiny_sort(cfg), _tiny_sort_mix(mix)
    else:
        bench, cfg, mix = _lm(cell)
    good = run.run(cell, 11, WINDOW_S, False, "cpu", bench=bench, cfg=cfg,
                   mix=mix)
    bad = run.run(cell, 11, WINDOW_S, False, "cpu", bench=bench, cfg=cfg,
                  mix=mix, patch=fault)
    assert good["correct"], good["checks"]
    assert not bad["correct"], bad["checks"]


def test_the_sort_control_is_not_correct(no_guard):
    bench = run.load_bench()
    _, cfg, mix = run.cell_inputs(bench, "sort-random-b4096")
    out = run.run("sort-random-b4096", 12, WINDOW_S, False, "cpu", bench=bench,
                  cfg=_tiny_sort(cfg), mix=_tiny_sort_mix(mix), control=True)
    assert not out["correct"]
    assert out["checks"]["banks_wrong_indices"]["value"] > 0


@pytest.mark.parametrize("cell", ["qwen2moe-decode-b64",
                                  "qwen2moe-prefill-8k"])
def test_the_fp8_control_reads_above_the_program(cell, no_guard):
    """The fp8 control's tokens, judged in the program's place, are not
    correct: at a tiny size its mean gap lies well above the bf16
    program's, read beside it in the same run.  A limit between the two
    (0.008 here; the cell's own is set from readings at its size, PERF.md)
    holds the program and fails the control."""
    prog, ctl = [], []
    for seed in (1, 2, 3):
        bench, cfg, mix = _lm(cell, logit_gap_mean_limit=0.008)
        out = run.run(cell, seed, WINDOW_S, False, "cpu", bench=bench,
                      cfg=cfg, mix=mix, control=True)
        c = out["checks"]
        assert not out["correct"], c
        assert c["program_logit_gap_mean"]["value"] <= 0.008, c
        prog.append(c["program_logit_gap_mean"]["value"])
        ctl.append(c["logit_gap_mean"]["value"])
    assert all(c > p for p, c in zip(prog, ctl)), (prog, ctl)
    assert sum(ctl) > 3 * sum(prog)
