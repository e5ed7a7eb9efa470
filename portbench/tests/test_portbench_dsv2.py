"""The DeepSeek-V2 cell on the CPU at a tiny size: the port's served path
(a prefill, then absorbed decode steps through the latent cache, with
group routing, YaRN and a held share of the experts on) against
``reference/deepseek_v2.py``, and that comparison failing a bfloat16
computation; the cell's harness, whose ``correct`` comes out false when
the timed path is broken or the fp8 control stands in for the program; its
work counts and readers."""
import json

import numpy as np
import pytest
import torch

from portbench import accounting_mla, run, span_kernels, trace
from portbench.drivers import lm_mla
from portbench.reference import deepseek_v2
from portbench.tests import test_portbench_harness as harness
from portbench.tests.test_portbench_span_readers import P, _trace
from repro_torch.runtime import spans

CELL = "dsv2-decode-b128-p4k"
CFG = json.loads((run.ROOT / "portbench" / "configs" /
                  "deepseek-v2-236b-ep8.json").read_text())
# every width cut, and the experts: 64 in 8 groups of 8, the top 3 groups,
# 6 experts a token (gates times 16, as published: with fewer experts each
# gate is larger and a bf16 run's near-ties in the router move the logits
# more); this share holds group 1 (experts 8-15); YaRN as published (at
# rope dim 8 its ramp runs over indices 1 to 3)
TINY = dict(CFG, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=4, q_lora_rank=32, kv_lora_rank=16,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            intermediate_size=96, moe_intermediate_size=32,
            n_routed_experts=8, num_experts_per_tok=6, n_group=8,
            topk_group=3, vocab_size=256,
            deployment=dict(CFG["deployment"], routed_experts_per_layer=64,
                            first_expert_held=8))


def _port_logits(cfg, weights, toks, prompt_len):
    """The port's prefill of the prompt, then one decode step a token,
    as the serving steps run them: (T, V) float32 logits."""
    from repro_torch.launch import steps
    from repro_torch.models import stacked
    arch = lm_mla.arch_config(cfg)
    params = lm_mla.port_params(weights, arch)
    T = toks.shape[0]
    cache = stacked.init_cache(arch, 1, T, "cpu")
    logits, _ = steps.make_prefill_step(arch)(params, toks[None, :prompt_len],
                                              cache)
    out = [logits[0].float()]
    decode = steps.make_decode_step(arch)
    for p in range(prompt_len, T):
        lg, _ = decode(params, toks[None, p:p + 1],
                       torch.tensor([p], dtype=torch.int32), cache)
        out.append(lg[0].float())
    return torch.cat(out)


def _ref_logits(cfg, weights, toks, prompt_len, fp8=False):
    h = deepseek_v2.hidden(weights, cfg, toks, prompt_len, fp8=fp8, block=8)
    return torch.cat([lg for _, lg in deepseek_v2.head_rows(weights, h,
                                                            fp8=fp8)])


@pytest.mark.parametrize("prompt_len", [20, 7])
def test_dsv2_reference_matches_port_float32(prompt_len):
    """The absorbed latent attention over the cache (the port's prefill and
    decode) against the expanded form (the reference), the routing on
    logits against on softmax scores, float32 both: equal to float32
    rounding (the two forms sum in other orders; logits reach ~4)."""
    cfg = dict(TINY, torch_dtype="float32")
    w = lm_mla.make_weights(cfg, 5, torch.device("cpu"))
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 256, 28))
    got = _port_logits(cfg, w, toks, prompt_len)
    want = _ref_logits(cfg, w, toks, prompt_len)
    assert want.abs().max() > 1.0
    assert torch.allclose(got, want, atol=1e-4, rtol=0)


def test_dsv2_reference_holds_each_mechanism():
    """The same comparison fails where the port leaves out a part of the
    published model: YaRN, the mscale^2 softmax scale, the group limit,
    the published gates, or the held share's place in the experts."""
    import dataclasses
    cfg = dict(TINY, torch_dtype="float32")
    w = lm_mla.make_weights(cfg, 9, torch.device("cpu"))
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 256, 24))
    want = _ref_logits(cfg, w, toks, 16)
    real = lm_mla.arch_config
    for change in (dict(rope_scaling_factor=1.0),
                   dict(rope_mscale_all_dim=0.0),
                   dict(n_group=1), dict(norm_topk_prob=True),
                   dict(routed_scaling_factor=1.0),
                   dict(first_expert_held=0)):
        lm_mla.arch_config = lambda c, change=change: dataclasses.replace(
            real(c), **change)
        try:
            got = _port_logits(cfg, w, toks, 16)
        finally:
            lm_mla.arch_config = real
        assert (got - want).abs().max() > 1e-3, change


def test_dsv2_reference_fails_a_bfloat16_computation():
    """The port in bfloat16 on the same (bfloat16-representable) weights
    misses the float32 reference by far more than the tolerance, as does
    the reference with its weights rounded to fp8 (the control)."""
    cfg32 = dict(TINY, torch_dtype="float32")
    cfg16 = dict(TINY, torch_dtype="bfloat16")
    w16 = lm_mla.make_weights(cfg16, 6, torch.device("cpu"))
    w32 = {k: v.float() for k, v in w16.items()}
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 256, 20))
    want = _ref_logits(cfg32, w32, toks, 16)
    assert torch.allclose(_port_logits(cfg32, w32, toks, 16), want,
                          atol=1e-4, rtol=0)
    bf16 = (_port_logits(cfg16, w16, toks, 16) - want).abs().max()
    fp8 = (_ref_logits(cfg16, w16, toks, 16, fp8=True) - want).abs().max()
    assert bf16 > 1e-3
    assert fp8 > 1e-3


def test_active_params_count_the_share():
    """2 x active parameters a token: every leaf of the port's tree but the
    token embedding, the held routed experts at top-k over all E."""
    from repro_torch import tree
    from repro_torch.models import stacked
    arch = lm_mla.arch_config(TINY)
    params = stacked.init_params(arch, None, "meta")
    routed = other = 0
    for path, t in tree.flatten_with_path(params):
        if path[-1] == "tok":
            continue
        if "moe" in path and path[-1] in ("wi", "wo") and "shared" not in path:
            routed += t.numel()
        else:
            other += t.numel()
    want = other + routed * 6 / 64
    assert accounting_mla.active_params(TINY) == pytest.approx(want)
    assert accounting_mla.model_flops(TINY, 3, 10) == pytest.approx(
        2 * want * 3 + 2 * 4 * (16 + 8 + 16) * 10 * 3)
    assert accounting_mla.attend_bytes(TINY, 10) == 10 * 3 * (16 + 8) * 2
    # the full configuration: 22.9 GB of bf16 weights, the card's share
    full = stacked.init_params(lm_mla.arch_config(CFG), None, "meta")
    size = sum(t.numel() * t.element_size()
               for _, t in tree.flatten_with_path(full))
    assert 22.5e9 < size < 23.5e9


def _mix(**kw):
    bench = run.load_bench()
    _, _, m = run.cell_inputs(bench, CELL)
    # answers much longer than the prompt, so that a cache left unwritten
    # changes most of what each step attends to; two prompts of 4 rows
    m = dict(m, rows=8, prompts=2, prompt_len=4, answer_lens=[12, 16],
             check_answers=4, trace_units=3,
             # the tiny model's bf16 runs read a mean gap of 0 to 0.009 (the
             # cell's limit is set from readings at its own size, PERF.md)
             logit_gap_mean_limit=0.05)
    return bench, dict(TINY, torch_dtype="bfloat16"), dict(m, **kw)


def test_attended_counts_the_schedule(harness_guard):
    bench, cfg, mix = _mix()
    drv = lm_mla.Cell(cfg, mix, 3, torch.device("cpu"), trace.Spans(False))
    drv.setup()
    pos = np.full(8, 4)
    brute = []
    restart = drv.restart.numpy()
    for s in range(40):
        brute.append(int((pos + 1).sum()))
        pos = np.where(restart[s], 4, pos + 1)
    for s0, s1 in ((0, 3), (5, 40), (11, 12)):
        assert drv.attended(s0, s1) == sum(brute[s0:s1])


@pytest.mark.parametrize("fault", [harness._altered_tokens,
                                   harness._state_unchanged])
def test_a_broken_timed_path_is_not_correct(fault, harness_guard):
    bench, cfg, mix = _mix()
    good = run.run(CELL, 11, harness.WINDOW_S, False, "cpu", bench=bench,
                   cfg=cfg, mix=mix)
    bad = run.run(CELL, 11, harness.WINDOW_S, False, "cpu", bench=bench,
                  cfg=cfg, mix=mix, patch=fault)
    assert good["correct"], good["checks"]
    assert not bad["correct"], bad["checks"]


def test_the_fp8_control_reads_above_the_program(harness_guard):
    """The fp8 control's tokens, judged in the program's place, are not
    correct: at a tiny size its mean gap lies well above the bf16
    program's, read beside it in the same run."""
    prog, ctl = [], []
    for seed in (1, 2, 3):
        bench, cfg, mix = _mix(logit_gap_mean_limit=0.03)
        out = run.run(CELL, seed, harness.WINDOW_S, False, "cpu",
                      bench=bench, cfg=cfg, mix=mix, control=True)
        c = out["checks"]
        assert c["program_logit_gap_mean"]["value"] <= 0.03, c
        prog.append(c["program_logit_gap_mean"]["value"])
        ctl.append(c["logit_gap_mean"]["value"])
    assert sum(ctl) > 3 * sum(prog), (prog, ctl)
    assert sum(c > 0.03 for c in ctl) >= 2, (prog, ctl)


# (reader, its span) of the readers of device time a step
STEP_READERS = [("mla_ms_per_step.dsv2decode", "mla"),
                ("route_ms_per_step.dsv2decode", "moe.route"),
                ("experts_ms_per_step.dsv2decode", "moe.experts")]


@pytest.fixture
def harness_guard(monkeypatch):
    monkeypatch.setattr(run, "forbidden_loaded", lambda modules=None: [])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.reset()
    yield
    spans.reset()
    torch.set_num_threads(threads)


class _Ev:
    """A host op of ``prof.events()``: its name, the device events the
    profiler linked to it (name, device, duration in us) and its parent."""

    def __init__(self, name, parent=None, kernels=()):
        self.name, self.cpu_parent = name, parent
        self.kernels = [type("Kernel", (), {"name": k, "duration": us})()
                        for k, us in kernels]


def test_charge_counts_each_kernel_in_every_enclosing_span():
    mla = _Ev(P + "mla")
    attend = _Ev(P + "mla.attend", mla)
    mm = _Ev("aten::mm", attend, [("gemm", 300.0)])
    soft = _Ev("aten::softmax", attend, [("softmax", 100.0), ("cast", 50.0)])
    proj = _Ev("aten::linear", mla, [("gemm", 250.0)])
    route = _Ev(P + "moe.route")
    topk = _Ev("aten::empty", route, [])
    outside = _Ev("aten::add", None, [("add", 1000.0)])
    got = span_kernels.charge([mla, attend, mm, soft, proj, route, topk,
                               outside])
    assert got == {"mla.attend": pytest.approx(0.45),
                   "mla": pytest.approx(0.70)}


def _eager(**counters):
    """A trace slice whose counters hold an eager slice of 2 steps."""
    return _trace([], dict({"steps": 4, "eager_steps": 2}, **counters))


@pytest.mark.parametrize("metric,span", STEP_READERS)
def test_step_readers(metric, span):
    read = trace.load_reader(metric)
    assert read(_eager()) is None               # no eager slice charged
    assert read(_eager(eager_span_ms={"other": 3.0})) is None
    assert read(_eager(eager_span_ms={span: 64.0, "other": 3.0})) == \
        pytest.approx(64.0 / 2)
    assert read(_trace([], {"eager_span_ms": {span: 64.0}})) is None


def test_attend_roofline_and_cache_fill():
    roof = trace.load_reader("mla_attend_roofline.dsv2decode")
    fill = trace.load_reader("mla_cache_fill.dsv2decode")
    t = _eager(mla_attend_bytes=3.35e9, mla_attended_slots=300)
    assert roof(t) is None and fill(t) is None
    t = _eager(mla_attend_bytes=3.35e9, mla_attended_slots=300,
               eager_span_ms={"mla": 9.0, "mla.attend": 4.0},
               eager_counters={"mla.cache_slots": 1200})
    # 3.35 GB at 3.35 TB/s is 1 ms, over 4 ms
    assert roof(t) == pytest.approx(25.0)
    assert fill(t) == pytest.approx(25.0)
    assert roof(_eager(eager_span_ms={"mla.attend": 4.0})) is None
    assert fill(_eager(eager_counters={"mla.cache_slots": 1200})) is None


def test_expert_slot_fill_reads_the_held_share():
    read = trace.load_reader("expert_slot_fill.dsv2decode")
    assert read(_eager()) is None
    # a step of 15 layers: 128 rows x 6 experts x 20 / 160 held, over 20
    # held experts x 128 rows x 8 slots
    t = _eager(eager_counters={"moe.slots": 15 * 20 * 128 * 8,
                               "moe.assignments": 15 * 128 * 6,
                               "moe.assignments_held": 15 * 96})
    assert read(t) == pytest.approx(100 * 96 / 20480)
    assert read(_eager(eager_counters={"moe.slots": 8})) is None


def test_traced_tiny_cell_reports_what_the_cpu_reads(harness_guard):
    from repro_torch.models import moe
    bench, cfg, mix = _mix()
    out = run.run(CELL, 7, 1.0, True, "cpu", bench=bench, cfg=cfg,
                  mix=mix)["metrics"]
    # the eager slice: steps 3 to 5 from the prompts' end (position 4) of
    # a 4 + 16 cache, after the 3 traced steps
    assert out["mla_cache_fill.dsv2decode"] == {
        "value": pytest.approx(100 * (8 + 9 + 10) / 60), "unit": "%"}
    # 8 rows x 6 experts x 8 / 64 held, over 8 held experts x 8 rows x C
    C = moe._capacity(1, 6, 64, None)
    assert out["expert_slot_fill.dsv2decode"] == {
        "value": pytest.approx(100 * 6 / (8 * 8 * C)), "unit": "%"}
    assert out["mfu.dsv2decode"]["value"] > 0
    assert "idle_share.decode" in out
    # no device time on the CPU
    assert not {m for m, _ in STEP_READERS} & set(out)
    assert "mla_attend_roofline.dsv2decode" not in out
    assert "router_ms_per_step.decode" not in out
