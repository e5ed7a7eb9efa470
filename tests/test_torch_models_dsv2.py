"""DeepSeek-V2's parts of the port on the CPU (``repro_torch.models``):
group-limited greedy routing with the published gates on every top-k
engine against a plain-torch selection, YaRN's inverse frequencies and
MLA's softmax scale against their closed forms, a MoE layer's held share
of the experts against the uncut layer, and the new config fields at
their defaults leaving the router and RoPE bit for bit as they were."""
import dataclasses
import math

import pytest
import torch

from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import moe as M

ENGINES = ("radix", "fused-topk", "torch")


def _plain_group_limited(logits, n_group, topk_group, k, scale):
    """Group-limited greedy routing, plainly: each row's groups ordered by
    their best logit, the top topk_group kept, then the k best experts of
    the kept groups (ties to the lowest index, by a stable sort); gates
    the softmax over all experts at the chosen ones, times ``scale``."""
    n, E = logits.shape
    size = E // n_group
    probs = torch.softmax(logits, dim=-1)
    idx = torch.empty((n, k), dtype=torch.long)
    for r in range(n):
        best = [max(logits[r, g * size:(g + 1) * size].tolist())
                for g in range(n_group)]
        groups = sorted(range(n_group), key=lambda g: (-best[g], g))
        kept = [e for g in groups[:topk_group]
                for e in range(g * size, (g + 1) * size)]
        ranked = sorted(kept, key=lambda e: (-logits[r, e].item(), e))
        idx[r] = torch.tensor(ranked[:k])
    return torch.gather(probs, 1, idx) * scale, idx


def _dsv2_small(**kw):
    """deepseek-v2 reduced, with 16 experts in 4 groups, the top 2 groups
    and 4 experts a token, the published gates and YaRN."""
    cfg = configs.get_config("deepseek_v2_236b").reduced(n_layers=2)
    return dataclasses.replace(
        cfg, n_routed_experts=16, moe_top_k=4, n_group=4, topk_group=2,
        norm_topk_prob=False, routed_scaling_factor=16.0,
        rope_scaling_factor=40.0, rope_original_max_position=4096,
        rope_beta_fast=32.0, rope_beta_slow=1.0, rope_mscale=0.707,
        rope_mscale_all_dim=0.707, **kw)


@pytest.mark.parametrize("engine", ENGINES)
def test_group_limited_routing_matches_plain_selection(engine):
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(48, 16, generator=g)
    gates, idx = M.route_topk(logits, 4, engine, n_group=4, topk_group=2,
                              norm=False, scale=16.0)
    want_g, want_i = _plain_group_limited(logits, 4, 2, 4, 16.0)
    assert torch.equal(idx.long(), want_i)
    assert idx.dtype == torch.int32
    torch.testing.assert_close(gates, want_g, rtol=0, atol=0)
    # every chosen expert lies in one of the row's two kept groups
    assert all(len(set((row // 4).tolist())) <= 2 for row in idx)


@pytest.mark.parametrize("engine", ENGINES)
def test_route_takes_the_config_routing(engine):
    cfg = dataclasses.replace(_dsv2_small(), router_impl=engine)
    g = torch.Generator().manual_seed(4)
    params = {"router": torch.randn(cfg.d_model, 16, generator=g)}
    x = torch.randn(2, 5, cfg.d_model, generator=g)
    logits, gates, idx = M.route(params, x, cfg)
    torch.testing.assert_close(logits, x @ params["router"], rtol=0, atol=0)
    want_g, want_i = _plain_group_limited(logits.reshape(10, 16), 4, 2, 4,
                                          16.0)
    assert torch.equal(idx.reshape(10, 4).long(), want_i)
    torch.testing.assert_close(gates.reshape(10, 4), want_g, rtol=0, atol=0)


@pytest.mark.parametrize("engine", ENGINES)
def test_defaults_keep_the_router_bit_for_bit(engine):
    """qwen2-moe-shaped logits (60 experts, top 4): the defaults are the
    top-k softmax router the port had, bit for bit."""
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(64, 60, generator=g)
    from repro_torch import sort
    vals, want_i = sort.topk(logits, 4, engine=M.router_engine(engine))
    want_g = torch.softmax(vals.float(), dim=-1)
    gates, idx = M.route_topk(logits, 4, engine)
    assert torch.equal(idx, want_i) and torch.equal(gates, want_g)
    cfg = dataclasses.replace(configs.get_config("qwen2_moe_a2_7b"),
                              router_impl=engine)
    params = {"router": torch.randn(2048, 60, generator=g)}
    x = torch.randn(2, 3, 2048, generator=g)
    lg, gates, idx = M.route(params, x, cfg)
    vals, want_i = sort.topk(lg, 4, engine=M.router_engine(engine))
    assert torch.equal(idx, want_i)
    assert torch.equal(gates, torch.softmax(vals.float(), dim=-1))


def _parent_rope(x, positions, theta):
    """RoPE as the port computed it before YaRN."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d))
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_defaults_keep_rope_bit_for_bit(dtype):
    cfg = configs.get_config("qwen2_moe_a2_7b")
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 9, 16, 128, generator=g).to(dtype)
    pos = torch.randint(0, 4096, (2, 9), generator=g, dtype=torch.int32)
    want = _parent_rope(x, pos, cfg.rope_theta)
    assert torch.equal(L.rope(x, pos, cfg.rope_theta), want)
    assert torch.equal(L.rope(x, pos, cfg.rope_theta, cfg), want)
    ds = configs.get_config("deepseek_v2_236b")   # the registry: no YaRN
    assert torch.equal(L.rope(x[..., :64], pos, 1e4, ds),
                       _parent_rope(x[..., :64], pos, 1e4))


def test_yarn_inv_freq_closed_form():
    """At the rope dimension 64, base 1e4, factor 40 over 4096 positions,
    beta_fast 32, beta_slow 1: the ramp runs from index 10 to 23; below
    it the frequencies are RoPE's own, above it divided by 40."""
    cfg = _dsv2_small()
    got = L.rope_inv_freq(64, 1e4, "cpu", cfg).double()
    i = torch.arange(32, dtype=torch.float64)
    extra = 1e4 ** (-2 * i / 64)
    dim = lambda r: (64 * math.log(4096 / (2 * math.pi * r))
                     / (2 * math.log(1e4)))
    assert (math.floor(dim(32)), math.ceil(dim(1))) == (10, 23)
    gamma = ((i - 10) / 13).clamp(0, 1)
    want = extra / 40 * gamma + extra * (1 - gamma)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(got[:11], extra[:11], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[23:], extra[23:] / 40, rtol=1e-6, atol=0)
    # cos and sin are scaled by mscale / mscale_all_dim = 1
    x = torch.randn(1, 3, 2, 64, generator=torch.Generator().manual_seed(7))
    pos = torch.tensor([[0, 1, 4000]], dtype=torch.int32)
    ang = pos[..., None].float() * L.rope_inv_freq(64, 1e4, "cpu", cfg)
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., ::2], x[..., 1::2]
    want = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)
    assert torch.equal(L.rope(x, pos, 1e4, cfg), want)


def test_mla_softmax_scale():
    """The softmax scale sqrt(key width)^-1 times mscale(40, 0.707)^2 =
    1.5896 under YaRN, and the plain divisor exactly without it."""
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m * m == pytest.approx(1.5896, abs=1e-4)
    assert math.sqrt(8 + 16) / L.mla_score_div(_dsv2_small()) == \
        pytest.approx(m * m, rel=1e-12)
    full = dataclasses.replace(configs.get_config("deepseek_v2_236b"),
                               rope_scaling_factor=40.0,
                               rope_mscale_all_dim=0.707)
    assert 1 / L.mla_score_div(full) == pytest.approx(
        1.5896 / math.sqrt(192), rel=1e-4)
    assert L.mla_score_div(configs.get_config("deepseek_v2_236b")) == \
        math.sqrt(192)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_held_shares_sum_to_the_uncut_layer(dispatch):
    """The guide's share test: a layer over 16 experts cut into 8 shares
    of 2 (a share per group of 4 would hold 4); each share routes over all
    16 and adds its own experts' part.  The 8 shares' parts, with the
    shared expert counted once, sum to the uncut layer within float32
    rounding."""
    cfg = dataclasses.replace(_dsv2_small(), router_impl="radix")
    g = torch.Generator().manual_seed(8)
    params = M.init_moe(cfg, g, torch.device("cpu"))
    x = torch.randn(3, 7, cfg.d_model, generator=g)
    whole, _ = M.apply_moe(params, x, cfg, dispatch=dispatch)
    shared = L.apply_mlp(params["shared"], x, cfg,
                         d_ff=cfg.n_shared_experts * cfg.d_ff_expert)
    total = shared.clone()
    for j in range(8):
        part = dataclasses.replace(cfg, n_experts_held=2,
                                   first_expert_held=2 * j)
        held = dict(params, wi=params["wi"][2 * j:2 * j + 2],
                    wo=params["wo"][2 * j:2 * j + 2])
        assert M.init_moe(part, g, torch.device("meta"))["wi"].shape[0] == 2
        y, _ = M.apply_moe(held, x, part, dispatch=dispatch)
        dense = M.apply_moe_dense_ref(held, x, part)
        torch.testing.assert_close(y, dense, rtol=1e-5, atol=1e-5)
        total += y - shared
    assert whole.abs().max() > 0.1
    torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-5)



def test_decode_graphs_on_the_host_run_the_step():
    """``decode_graphs`` on host tensors: the step runs as it is, bit for
    bit the step without graphs, and exposes that step as ``eager``."""
    from repro_torch.launch import steps
    from repro_torch.models import stacked
    cfg = _dsv2_small(n_experts_held=4, first_expert_held=4)
    params = stacked.init_params(cfg, torch.Generator().manual_seed(0),
                                 torch.device("cpu"))
    B, S = 3, 8
    caches = [stacked.init_cache(cfg, B, S, "cpu") for _ in range(2)]
    plain = steps.make_decode_step(cfg)
    graphed = steps.make_decode_step(dataclasses.replace(cfg,
                                                         decode_graphs=True))
    assert graphed.eager is not graphed
    tok = torch.tensor([[1], [2], [3]], dtype=torch.int32)
    pos = torch.arange(B, dtype=torch.int32)
    for _ in range(2):
        want = plain(params, tok, pos, caches[0])[0]
        got, c = graphed(params, tok, pos, caches[1])
        assert torch.equal(got, want) and c is caches[1]
        pos = pos + 1
    assert not graphed.graphs


@pytest.mark.cuda
def test_graphed_decode_step_is_the_eager_step():
    """On the card: the decode step replayed from its CUDA graphs
    (``decode_graphs``) gives the eager step's logits and cache writes bit
    for bit, step after step, at a reduced deepseek-v2 with group routing
    through the fused top-k, YaRN and a held share on; a call with other
    caches, other parameters or another batch raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs record its kernels")
    from repro_torch.launch import steps
    from repro_torch.models import stacked
    dev = torch.device("cuda")
    cfg = dataclasses.replace(_dsv2_small(n_experts_held=4,
                                          first_expert_held=4),
                              router_impl="fused-topk",
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    params = stacked.init_params(cfg, torch.Generator(device=dev)
                                 .manual_seed(0), dev)
    B, S = 8, 16
    caches = [stacked.init_cache(cfg, B, S, dev) for _ in range(3)]
    eager = steps.make_decode_step(cfg)
    graphed = steps.make_decode_step(dataclasses.replace(cfg,
                                                         decode_graphs=True))
    tok = torch.randint(0, cfg.vocab, (B, 1), dtype=torch.int32, device=dev)
    pos = torch.arange(B, dtype=torch.int32, device=dev)
    for _ in range(4):
        want = eager(params, tok, pos, caches[0])[0].clone()
        got = graphed(params, tok, pos, caches[1])[0]
        assert torch.equal(got, want)
        tok = want[:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = pos + 1
    assert len(graphed.graphs) == 2
    for a, b in zip(caches[0], caches[1]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    other = stacked.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(1), dev)
    for args in ((params, tok, pos, caches[2]), (other, tok, pos, caches[1]),
                 (params, tok[:4], pos[:4], caches[1])):
        with pytest.raises(ValueError, match="recorded"):
            graphed(*args)


@pytest.mark.cuda
def test_group_routing_on_the_card_is_the_plain_selection():
    """On the card, at the cell's router shape (128 rows of 160 float32
    logits, 8 groups, the top 3, 6 experts, gates x 16): the fused top-k's
    two selections equal the plain group-limited greedy selection, gates
    included, and its packed keys of the masked logits (100 of each row's
    160 at -inf) equal the plain pack's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused top-k kernels")
    from repro_torch.kernels import bitplane_pack
    from repro_torch.kernels.ref import pack_keys_ref
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(128, 160, generator=g)
    logits[1] = 0.5                              # every expert tied
    logits[2, 40:60] = logits[2, :20]            # two groups tied
    want_g, want_i = _plain_group_limited(logits, 8, 3, 6, 16.0)
    dev = torch.device("cuda")
    gates, idx = M.route_topk(logits.to(dev), 6, "fused-topk", n_group=8,
                              topk_group=3, norm=False, scale=16.0)
    assert torch.equal(idx.cpu().long(), want_i)
    # the card's float32 softmax over 160 may round its last bit otherwise
    torch.testing.assert_close(gates.cpu(), want_g, rtol=1e-6, atol=0)
    best = logits.reshape(128, 8, 20).amax(-1)
    keep = torch.zeros(128, 8, dtype=torch.bool).scatter_(
        1, torch.stack([torch.tensor(sorted(range(8), key=lambda j: (
            -best[r, j].item(), j))[:3]) for r in range(128)]), True)
    masked = logits.masked_fill(~keep.repeat_interleave(20, 1),
                                float("-inf")).to(dev)
    assert torch.equal(bitplane_pack.pack_keys(masked), pack_keys_ref(masked))
