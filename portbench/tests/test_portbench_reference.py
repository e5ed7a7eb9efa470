"""The benchmark's plain references against the port's host paths at tiny
sizes, and the comparisons failing on a lower precision (CPU only)."""
import numpy as np
import pytest
import torch

from portbench.drivers import lm
from portbench.reference import qwen2_moe, tns


@pytest.mark.parametrize("width,n,k", [(4, 17, 0), (6, 48, 1), (8, 64, 2),
                                       (16, 96, 2), (5, 31, 3)])
def test_tns_reference_matches_event_oracle(width, n, k):
    from repro_torch.core import ref_tns
    rng = np.random.default_rng(width * 100 + n)
    for _ in range(4):
        x = rng.integers(0, 2 ** width, n).astype(np.uint16)
        want = ref_tns.tns_sort(x, width=width, k=k)
        got = tns.tns_bank(x, width, k)
        assert got.perm == list(want.perm)
        assert (got.cycles, got.drs, got.reload_cycles) == (
            want.cycles, want.drs, want.reload_cycles)


@pytest.mark.parametrize("width", [6, 16])
def test_tns_reference_matches_port_host_path(width):
    from repro_torch import sort
    x = np.random.default_rng(width).integers(
        0, 2 ** width, (3, 40)).astype(np.uint16)
    res = sort.sort(x, engine="fused-tns", k=2, width=width, device="cpu")
    ref = tns.sort_banks(x, width, 2, range(3))
    np.testing.assert_array_equal(res.indices, ref["indices"])
    np.testing.assert_array_equal(res.values, ref["values"])
    for f in ("cycles", "drs", "reload_cycles"):
        np.testing.assert_array_equal(np.asarray(getattr(res, f)), ref[f])


def test_tns_narrower_keys_differ():
    """The sort's control (the low digit plane dropped) breaks the
    configuration's exact order on banks with near-equal keys."""
    x = np.random.default_rng(3).integers(0, 256, (2, 256)).astype(np.uint16)
    ref = tns.sort_banks(x, 8, 2, [0, 1])
    ctl = tns.sort_banks(x >> 1, 7, 2, [0, 1])
    assert not np.array_equal(ref["indices"], ctl["indices"])
    assert not np.array_equal(ref["cycles"], ctl["cycles"])


TINY = dict(name="tiny-moe", driver="lm", reference="qwen2_moe",
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, head_dim=16, num_experts=8,
            num_experts_per_tok=2, moe_intermediate_size=32,
            shared_expert_intermediate_size=64, vocab_size=256,
            rope_theta=1e6, rms_norm_eps=1e-6,
            port={"moe_capacity_factor": 1.25, "router_impl": "pallas",
                  "attn_impl": "naive"})


def _port_logits(cfg, weights, toks, prompt_len):
    """The port's prefill of the prompt, then one decode step a token,
    as the serving steps run them: (T, V) float32 logits."""
    from repro_torch.launch import steps
    from repro_torch.models import stacked
    arch = lm.arch_config(cfg)
    params = lm.port_params(weights, arch)
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
    h = qwen2_moe.hidden(weights, cfg, toks, prompt_len, fp8=fp8)
    return torch.cat([lg for _, lg in qwen2_moe.head_rows(weights, h,
                                                          fp8=fp8)])


@pytest.mark.parametrize("prompt_len", [24, 9])
def test_qwen_reference_matches_port_float32(prompt_len):
    """Prefill with capacity drops (24 tokens route 2 of 8 experts into 8
    slots) and decode steps without: the float32 port equals the
    reference to float32 rounding."""
    cfg = dict(TINY, torch_dtype="float32")
    w = lm.make_weights(cfg, 5, torch.device("cpu"))
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 256, 28))
    got = _port_logits(cfg, w, toks, prompt_len)
    want = _ref_logits(cfg, w, toks, prompt_len)
    assert torch.allclose(got, want, atol=1e-4, rtol=0)


def test_qwen_reference_fails_a_bfloat16_computation():
    """The same comparison fails when the port computes in bfloat16 on the
    same (bfloat16-representable) weights, as it does for the reference
    with its weights rounded to fp8 (the control)."""
    cfg32 = dict(TINY, torch_dtype="float32")
    cfg16 = dict(TINY, torch_dtype="bfloat16")
    w16 = lm.make_weights(cfg16, 6, torch.device("cpu"))
    w32 = {k: v.float() for k, v in w16.items()}
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 256, 20))
    want = _ref_logits(cfg32, w32, toks, 16)
    assert torch.allclose(_port_logits(cfg32, w32, toks, 16), want,
                          atol=1e-4, rtol=0)
    bf16 = (_port_logits(cfg16, w16, toks, 16) - want).abs().max()
    fp8 = (_ref_logits(cfg16, w16, toks, 16, fp8=True) - want).abs().max()
    assert bf16 > 1e-3
    assert fp8 > 1e-3
