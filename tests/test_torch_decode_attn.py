"""The decode-attention wrapper (``repro_torch.kernels.decode_attn``) on
the CPU: its plain version against the port's ``_sdpa`` bit for bit and
the reference's ``_sdpa`` at the layer tests' tolerance, over grouped
heads and every filled length of the cache; ``apply_attn`` sends a cached
one-token call through the wrapper and every other call through
``_sdpa``, and counts the decode rows and cache slots; the split rule and
the wrapper's checks.  The kernel itself is held to the plain version on
the card in ``tests/test_torch_kernels_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro import configs as ref_configs
from repro.models import layers as RL
from repro_torch import configs, tree
from repro_torch.kernels import decode_attn
from repro_torch.models import layers as L
from repro_torch.runtime import spans

TOL = dict(rtol=1e-5, atol=1e-5)
KV, HD, S = 2, 16, 12


def _qkv(group, dtype, rows, seed=0):
    rng = np.random.default_rng(seed)
    shapes = ((rows, 1, KV * group, HD), (rows, S, KV, HD), (rows, S, KV, HD))
    return [torch.tensor(rng.standard_normal(sh), dtype=torch.float32)
            .to(dtype) for sh in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("group", [1, 5, 8])
def test_plain_version_is_sdpa_bit_for_bit(group, dtype):
    # one row at each position from -1 (nothing filled: a uniform softmax
    # over -1e30 scores) through S + 1 (past the cache's end: all of it)
    pos = torch.arange(-1, S + 2, dtype=torch.int32)
    q, k, v = _qkv(group, dtype, pos.numel())
    got = decode_attn.decode_attention(q, k, v, pos)
    want = L._sdpa(q, k, v, True, q_pos=pos[:, None], kv_len=pos + 1,
                   impl="naive")
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("group", [1, 5, 8])
def test_plain_version_matches_the_reference(group):
    # kv_len 1 .. S, one row each
    pos = torch.arange(S, dtype=torch.int32)
    q, k, v = _qkv(group, torch.float32, S, seed=group)
    got = decode_attn.decode_attention(q, k, v, pos)
    want = RL._sdpa(*(jnp.asarray(t.numpy()) for t in (q, k, v)), True,
                    jnp.asarray(pos.numpy())[:, None],
                    jnp.asarray((pos + 1).numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_stale_entries_past_the_position_change_nothing():
    # a rewound row: whatever lies past its position has weight exactly 0
    pos = torch.tensor([0, 4, 11], dtype=torch.int32)
    q, k, v = _qkv(5, torch.float32, 3, seed=3)
    k2, v2 = k.clone(), v.clone()
    for b, p in enumerate(pos.tolist()):
        k2[b, p + 1:] = 1e4
        v2[b, p + 1:] = -1e4
    assert torch.equal(decode_attn.decode_attention(q, k, v, pos),
                       decode_attn.decode_attention(q, k2, v2, pos))


@pytest.mark.parametrize("blocks,group,s,want", [
    (1024, 1, 2560, (1, 2560)),     # qwen2-moe's decode cell: one chunk
    (512, 8, 2560, (1, 2560)),      # a GQA-8 group does 8x the arithmetic
    (512, 1, 2560, (2, 1280)),
    (256, 1, 2560, (4, 640)),
    (32, 8, 4096, (16, 256)),       # chunks no shorter than MIN_CHUNK
    (2, 1, 300, (1, 300)),
    (6, 1, 4100, (16, 257)),
    (1, 1, 100, (1, 100)),
])
def test_split_for(blocks, group, s, want):
    p, chunk = decode_attn.split_for(blocks, group, s)
    assert (p, chunk) == want
    assert (p - 1) * chunk < s <= p * chunk


@pytest.mark.parametrize("bad,err", [
    ("q_tokens", ValueError), ("heads", ValueError),
    ("positions", ValueError), ("dtype", TypeError)])
def test_wrapper_refuses_what_it_does_not_take(bad, err):
    q, k, v = _qkv(2, torch.float32, 3)
    pos = torch.zeros(3, dtype=torch.int32)
    if bad == "q_tokens":
        q = torch.cat([q, q], dim=1)
    elif bad == "heads":
        q = q[:, :, :3]
    elif bad == "positions":
        pos = pos[:2]
    else:
        v = v.to(torch.bfloat16)
    with pytest.raises(err):
        decode_attn.decode_attention(q, k, v, pos)


def _attn(arch="qwen3_14b"):
    cfg = configs.get_config(arch).reduced()
    return cfg, L.init_attn(cfg, torch.Generator().manual_seed(0),
                            torch.device("cpu"))


@pytest.mark.parametrize("cached,T,through", [
    (True, 1, "wrapper"), (True, 3, "sdpa"), (False, 1, "sdpa"),
    (False, 4, "sdpa")])
def test_apply_attn_sends_one_cached_token_through_the_wrapper(
        monkeypatch, cached, T, through):
    cfg, p = _attn()
    calls = {"wrapper": 0, "sdpa": 0}
    wrapper, sdpa = decode_attn.decode_attention, L._sdpa
    inside = []

    def spy(name, fn):
        # only the calls apply_attn makes itself count: on the CPU the
        # wrapper's plain version is _sdpa
        def call(*a, **kw):
            calls[name] += not inside
            inside.append(name)
            try:
                return fn(*a, **kw)
            finally:
                inside.pop()
        return call

    monkeypatch.setattr(decode_attn, "decode_attention",
                        spy("wrapper", wrapper))
    monkeypatch.setattr(L, "_sdpa", spy("sdpa", sdpa))
    x = torch.randn((2, T, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    pos = torch.tensor([[3], [6]], dtype=torch.int32) + torch.arange(T)
    cache = L.init_attn_cache(cfg, 2, 10, torch.device("cpu")) \
        if cached else None
    out, _ = L.apply_attn(p, x, cfg, pos, cache)
    assert out.shape == x.shape
    assert calls == {"wrapper": int(through == "wrapper"),
                     "sdpa": int(through == "sdpa")}


@pytest.mark.parametrize("arch", ["qwen3_14b", "gemma_7b", "olmo_1b"])
def test_one_token_decode_matches_the_reference(arch):
    # each row one token at its own position over a cache holding earlier
    # k/v (a row at 0, a row at the last slot), through the wrapper
    rcfg = ref_configs.get_config(arch).reduced()
    cfg = configs.get_config(arch).reduced()
    rp = RL.init_attn(rcfg, jax.random.PRNGKey(2))
    tp = tree.params_from_numpy(rp, "cpu")
    rng = np.random.default_rng(5)
    shape = (3, 10, rcfg.n_kv_heads, rcfg.hd)
    ck, cv = rng.standard_normal(shape), rng.standard_normal(shape)
    rc = {"k": jnp.asarray(ck, jnp.float32), "v": jnp.asarray(cv, jnp.float32)}
    tc = {"k": torch.tensor(ck, dtype=torch.float32),
          "v": torch.tensor(cv, dtype=torch.float32)}
    x = rng.standard_normal((3, 1, rcfg.d_model))
    pos = np.asarray([[0], [4], [9]])
    want, rc = RL.apply_attn(rp, jnp.asarray(x, jnp.float32), rcfg,
                             jnp.asarray(pos, jnp.int32), rc)
    got, _ = L.apply_attn(tp, torch.tensor(x, dtype=torch.float32), cfg,
                          torch.tensor(pos, dtype=torch.int32), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(rc["k"]), **TOL)


def test_apply_attn_counts_decode_rows_and_cache_slots():
    cfg, p = _attn("olmo_1b")
    cache = L.init_attn_cache(cfg, 2, 10, torch.device("cpu"))
    x = torch.randn((2, 4, cfg.d_model))
    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            # a 4-token prefill through the cache counts nothing
            L.apply_attn(p, x, cfg, torch.arange(4).expand(2, 4), cache)
            assert spans.report()["counters"] == {}
            for i in range(3):
                L.apply_attn(p, x[:, :1], cfg,
                             torch.full((2, 1), 4 + i), cache)
        assert spans.report()["counters"] == {
            "attn.decode_rows": 3 * 2, "attn.cache_slots": 3 * 2 * 10}
    finally:
        spans.reset()
