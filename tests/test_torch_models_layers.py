"""The port's model configs and attention-and-MLP layers
(``repro_torch.configs``, ``repro_torch.models.config`` / ``layers``)
against the reference's on the CPU: the same numpy inputs and the
reference's weights (carried across with ``tree.params_from_numpy``)
through both.  Configs compare exactly; the layers at rtol = atol = 1e-5
(float32: the two frameworks sum in other orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import config as RC
from repro.models import layers as RL
from repro.models import mamba2 as RM
from repro_torch import configs, tree
from repro_torch.models import config as C
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M

CPU = "cpu"
KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)
# all ten archs; the attention tests take those with attention heads
ARCHS = list(ref_configs.ARCH_IDS)
ATTN_ARCHS = [a for a in ARCHS if ref_configs.get_config(a).n_heads]


def _cfgs(arch, **kw):
    """(reference config, port config), reduced alike."""
    return (ref_configs.get_config(arch).reduced(**kw),
            configs.get_config(arch).reduced(**kw))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------


def test_registry_matches_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        for name in (arch, arch.replace("_", "-")):
            assert dataclasses.asdict(configs.get_config(name)) == \
                dataclasses.asdict(ref_configs.get_config(name))
    assert list(configs.all_configs()) == list(ref_configs.all_configs())


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
@pytest.mark.parametrize("kw", [{}, dict(n_layers=3, d_model=96, vocab=512),
                                dict(n_layers=2, d_model=64, vocab=128,
                                     d_ff=80)])
def test_reduced_matches_reference(arch, kw):
    want, got = _cfgs(arch, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hd == want.hd and got.layers() == want.layers()
    assert [dataclasses.asdict(s) for s in C.shapes_for(got)] == \
        [dataclasses.asdict(s) for s in RC.shapes_for(want)]


def test_reduced_d_ff_precedence_quirk():
    # `d_ff=d_ff or max(...) if self.d_ff else 0` parses as
    # `(d_ff or max(...)) if self.d_ff else 0`: an explicit d_ff is dropped
    # for a config without an MLP width
    assert configs.get_config("mamba2_1_3b").reduced(d_ff=96).d_ff == 0
    assert configs.get_config("olmo_1b").reduced(d_ff=96).d_ff == 96


def test_dtypes_are_torch():
    cfg = configs.get_config("qwen2_moe_a2_7b")
    assert cfg.dtype() is torch.bfloat16 and cfg.pdtype() is torch.bfloat16
    red = cfg.reduced()
    assert red.dtype() is torch.float32 and red.pdtype() is torch.float32
    assert (C.ATTN, C.MLA, C.SSM, C.XATTN) == ("attn", "mla", "ssm", "xattn")


# ---------------------------------------------------------------------------
# Norms, RoPE, init.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmo_1b", "qwen3_14b"])
def test_apply_norm_matches_reference(arch):
    # olmo-1b: the non-parametric LayerNorm (population variance);
    # qwen3: RMSNorm with a weight
    rcfg, cfg = _cfgs(arch)
    x = np.random.default_rng(1).standard_normal((2, 5, 64)) * 3 + 0.5
    w = np.random.default_rng(2).standard_normal(64)
    rp = {} if rcfg.norm == "nonparam_ln" else {"w": jnp.asarray(w,
                                                                 jnp.float32)}
    want = RL.apply_norm(rp, jnp.asarray(x, jnp.float32), rcfg)
    got = L.apply_norm(tree.params_from_numpy(rp, CPU),
                       torch.tensor(x, dtype=torch.float32), cfg)
    _close(got, want)


def test_nonparam_ln_uses_population_variance():
    _, cfg = _cfgs("olmo_1b")
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    mu, var = 2.5, 1.25                        # ddof 0; ddof 1 is 5/3
    want = (x - mu) / np.sqrt(var + 1e-5)
    np.testing.assert_allclose(L.apply_norm({}, x, cfg).numpy(),
                               want.numpy(), rtol=1e-6)


def test_head_rms_matches_reference():
    x = np.random.default_rng(3).standard_normal((2, 3, 4, 32))
    w = np.random.default_rng(4).standard_normal(32)
    want = RL._head_rms(jnp.asarray(x, jnp.float32), jnp.asarray(w,
                                                                 jnp.float32))
    _close(L._head_rms(torch.tensor(x, dtype=torch.float32),
                       torch.tensor(w, dtype=torch.float32)), want)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 16))
    pos = rng.integers(0, 50, (2, 7))
    want = RL.rope(jnp.asarray(x, jnp.float32), jnp.asarray(pos, jnp.int32),
                   theta)
    got = L.rope(torch.tensor(x, dtype=torch.float32),
                 torch.tensor(pos, dtype=torch.int32), theta)
    _close(got, want)


def test_rope_rotates_interleaved_pairs():
    # position 1, D = 2: one pair (x0, x1) rotated by angle 1
    x = torch.tensor([[[[1.0, 0.0]]]])
    got = L.rope(x, torch.tensor([[1]]), 1e4)[0, 0, 0]
    np.testing.assert_allclose(got.numpy(), [np.cos(1.0), np.sin(1.0)],
                               rtol=1e-6)


def test_init_scale_uses_leading_dim():
    gen = torch.Generator().manual_seed(0)
    w = L._init(gen, (4, 4096, 8), torch.float32, torch.device(CPU))
    # fan-in is shape[0] = 4, not 4096 (the reference's rule, kept)
    assert abs(float(w.std()) - 0.5) < 0.01
    emb = L.init_embed(configs.get_config("olmo_1b").reduced(), gen,
                       torch.device(CPU))
    assert abs(float(emb["tok"].std()) - 0.02) < 0.002
    meta = L._init(None, (60, 2048, 2816), torch.bfloat16,
                   torch.device("meta"))
    assert meta.is_meta and meta.dtype is torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference_layout(arch):
    rcfg, cfg = _cfgs(arch)
    gen = torch.Generator().manual_seed(0)
    pairs = [(RL.init_attn, L.init_attn), (RL.init_mlp, L.init_mlp),
             (RL.init_embed, L.init_embed), (RL.init_norm, L.init_norm)]
    # and the arch's own layer kinds: MLA, cross-attention, the SSM block
    if cfg.kv_lora_rank:
        pairs.append((RL.init_mla, L.init_mla))
    if cfg.frontend_tokens:
        pairs.append((RL.init_xattn, L.init_xattn))
    if cfg.ssm_state:
        pairs.append((RM.init_ssm, M.init_ssm))
    for rfn, fn in pairs:
        want = jax.tree_util.tree_flatten_with_path(rfn(rcfg, KEY))[0]
        got = tree.flatten_with_path(fn(cfg, gen, torch.device(CPU)))
        assert [tree.keystr(p) for p, _ in got] == \
            [jax.tree_util.keystr(p) for p, _ in want]
        for (_, a), (_, b) in zip(want, got):
            assert tuple(b.shape) == a.shape and b.dtype is torch.float32


# ---------------------------------------------------------------------------
# Attention.
# ---------------------------------------------------------------------------


def _attn_pair(arch, seed=0):
    rcfg, cfg = _cfgs(arch)
    rp = RL.init_attn(rcfg, jax.random.PRNGKey(seed))
    return rcfg, cfg, rp, tree.params_from_numpy(rp, CPU)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_apply_attn_matches_reference(arch):
    rcfg, cfg, rp, tp = _attn_pair(arch)
    x = np.random.default_rng(6).standard_normal((2, 9, rcfg.d_model))
    pos = np.broadcast_to(np.arange(9), (2, 9))
    want, _ = RL.apply_attn(rp, jnp.asarray(x, jnp.float32), rcfg,
                            jnp.asarray(pos, jnp.int32))
    got, cache = L.apply_attn(tp, torch.tensor(x, dtype=torch.float32), cfg,
                              torch.tensor(pos, dtype=torch.int32))
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("arch", ["qwen3_14b", "gemma_7b"])
def test_apply_attn_with_cache_matches_reference(arch):
    # a 3-token step at per-row positions 2 and 5 into a 10-slot cache
    # holding earlier k/v; then a step whose start is clamped (8 + 3 > 10)
    rcfg, cfg, rp, tp = _attn_pair(arch, seed=1)
    rng = np.random.default_rng(7)
    shape = (2, 10, rcfg.n_kv_heads, rcfg.hd)
    ck, cv = rng.standard_normal(shape), rng.standard_normal(shape)
    rc = {"k": jnp.asarray(ck, jnp.float32), "v": jnp.asarray(cv, jnp.float32)}
    tc = {"k": torch.tensor(ck, dtype=torch.float32),
          "v": torch.tensor(cv, dtype=torch.float32)}
    for starts in ((2, 5), (8, 0)):
        x = rng.standard_normal((2, 3, rcfg.d_model))
        pos = np.asarray(starts)[:, None] + np.arange(3)
        want, rc = RL.apply_attn(rp, jnp.asarray(x, jnp.float32), rcfg,
                                 jnp.asarray(pos, jnp.int32), rc)
        got, tc2 = L.apply_attn(tp, torch.tensor(x, dtype=torch.float32),
                                cfg, torch.tensor(pos, dtype=torch.int32), tc)
        assert tc2 is tc                 # written in place
        _close(got, want)
        _close(tc["k"], rc["k"])
        _close(tc["v"], rc["v"])


@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("decode", [False, True])
def test_sdpa_chunked_matches_naive(kv_heads, decode):
    rng = np.random.default_rng(8)
    T, S = (1, 32) if decode else (32, 32)
    q = torch.tensor(rng.standard_normal((2, T, 4, 16)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((2, S, kv_heads, 16)),
                     dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((2, S, kv_heads, 16)),
                     dtype=torch.float32)
    if decode:
        q_pos = torch.tensor([[20], [9]], dtype=torch.int32)
        kv_len = q_pos[:, 0] + 1
    else:
        q_pos = torch.arange(T, dtype=torch.int32)[None, :].expand(2, T)
        kv_len = None
    naive = L._sdpa(q, k, v, True, q_pos, kv_len)
    chunked = L._sdpa(q, k, v, True, q_pos, kv_len, impl="chunked", chunk=8)
    np.testing.assert_allclose(chunked.numpy(), naive.numpy(), **TOL)
    want = RL._sdpa(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                    jnp.asarray(v.numpy()), True, jnp.asarray(q_pos.numpy()),
                    None if kv_len is None else jnp.asarray(kv_len.numpy()),
                    impl="chunked", chunk=8)
    _close(chunked, want)


def test_sdpa_masks_with_minus_1e30_not_inf():
    # a query row that sees no key (position -1) gets a uniform softmax
    # over -1e30 scores, as the reference's; -inf would give NaN
    q = torch.ones((1, 1, 1, 4))
    k = torch.randn((1, 3, 1, 4), generator=torch.Generator().manual_seed(0))
    v = torch.arange(12, dtype=torch.float32).reshape(1, 3, 1, 4)
    out = L._sdpa(q, k, v, True, torch.tensor([[-1]]))
    np.testing.assert_allclose(out[0, 0, 0].numpy(),
                               v[0, :, 0].mean(0).numpy(), rtol=1e-6)


def test_init_attn_cache_matches_reference():
    rcfg, cfg = _cfgs("qwen3_14b")
    want = RL.init_attn_cache(rcfg, 3, 11)
    got = L.init_attn_cache(cfg, 3, 11, CPU)
    for k in ("k", "v"):
        assert tuple(got[k].shape) == want[k].shape
        assert not bool(got[k].any())
    assert tuple(L.init_attn_cache(cfg, 3, 11, CPU, (5,))["k"].shape) == \
        (5,) + want["k"].shape


# ---------------------------------------------------------------------------
# MLP, embedding, head.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmo_1b", "gemma_7b"])   # SwiGLU, GeGLU
def test_apply_mlp_matches_reference(arch):
    rcfg, cfg = _cfgs(arch)
    rp = RL.init_mlp(rcfg, KEY)
    x = np.random.default_rng(9).standard_normal((2, 6, rcfg.d_model)) * 2
    want = RL.apply_mlp(rp, jnp.asarray(x, jnp.float32), rcfg)
    got = L.apply_mlp(tree.params_from_numpy(rp, CPU),
                      torch.tensor(x, dtype=torch.float32), cfg)
    _close(got, want)


def test_gelu_is_the_tanh_form():
    g = torch.linspace(-4, 4, 101)
    want = np.asarray(jax.nn.gelu(jnp.asarray(g.numpy())))
    _, cfg = _cfgs("gemma_7b")
    np.testing.assert_allclose(L.glu_act(g, cfg).numpy(), want, **TOL)


def test_embed_and_head_match_reference():
    rcfg, cfg = _cfgs("qwen3_14b")
    rp = RL.init_embed(rcfg, KEY)
    tp = tree.params_from_numpy(rp, CPU)
    toks = np.random.default_rng(10).integers(0, rcfg.vocab, (2, 5))
    want = RL.embed_tokens(rp, jnp.asarray(toks, jnp.int32))
    got = L.embed_tokens(tp, torch.tensor(toks, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    logits = L.lm_logits(tp, got)
    assert logits.dtype is torch.float32
    _close(logits, RL.lm_logits(rp, want))


def test_matmul_f32_keeps_bfloat16_products_in_float32():
    # on the host a bfloat16 product is widened: the float32 sum of the
    # exact products, not a sum rounded to bfloat16
    rng = np.random.default_rng(11)
    a = torch.tensor(rng.standard_normal((3, 5, 64)), dtype=torch.bfloat16)
    b = torch.tensor(rng.standard_normal((64, 7)), dtype=torch.bfloat16)
    got = L.matmul_f32(a, b)
    assert got.dtype is torch.float32
    want = a.double() @ b.double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    want_j = jnp.einsum("btd,dv->btv", jnp.asarray(a.float().numpy(),
                                                   jnp.bfloat16),
                        jnp.asarray(b.float().numpy(), jnp.bfloat16),
                        preferred_element_type=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_j), **TOL)
