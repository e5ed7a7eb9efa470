"""The port's multi-head latent attention (``repro_torch.models.layers``:
``init_mla``, ``apply_mla``, ``init_mla_cache``) against the reference's
on the CPU, on the reference's weights, for both query paths (the
low-rank ``wq_a`` / ``wq_b`` of deepseek-v2, and a full ``wq`` when
``q_lora_rank`` is 0): the naive prefill, and the weight-absorbed decode
over the latent cache at T = 1 and T = 4.  rtol = atol = 1e-4 (float32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as RL
from repro_torch import configs, tree
from repro_torch.models import layers as L

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)
Q_PATHS = ["q_lora", "wq"]


def _cfgs(q_path):
    """(reference config, port config): deepseek-v2 reduced, its query
    low-rank (q_lora_rank 32) or full (q_lora_rank 0)."""
    rcfg = ref_configs.get_config("deepseek_v2_236b").reduced()
    cfg = configs.get_config("deepseek_v2_236b").reduced()
    if q_path == "wq":
        rcfg = dataclasses.replace(rcfg, q_lora_rank=0)
        cfg = dataclasses.replace(cfg, q_lora_rank=0)
    return rcfg, cfg


def _pair(q_path, seed=0):
    rcfg, cfg = _cfgs(q_path)
    rp = RL.init_mla(rcfg, jax.random.PRNGKey(seed))
    return rcfg, cfg, rp, tree.params_from_numpy(rp, CPU)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("q_path", Q_PATHS)
def test_init_mla_layout_matches_reference(q_path):
    rcfg, cfg = _cfgs(q_path)
    want = jax.tree_util.tree_flatten_with_path(
        RL.init_mla(rcfg, jax.random.PRNGKey(0)))[0]
    got = tree.flatten_with_path(
        L.init_mla(cfg, torch.Generator().manual_seed(0), torch.device(CPU)))
    assert [tree.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (_, a), (_, b) in zip(want, got):
        assert tuple(b.shape) == a.shape and b.dtype is torch.float32
    names = {p[-1] for p, _ in got}
    assert ({"wq_a", "q_norm", "wq_b"} <= names) == (q_path == "q_lora")
    assert ("wq" in names) == (q_path == "wq")
    # bfloat16 at full width, on the meta device: no memory
    full = configs.get_config("deepseek_v2_236b")
    meta = L.init_mla(full, None, torch.device("meta"))
    assert tuple(meta["wq_b"].shape) == (1536, 128 * 192)
    assert tuple(meta["wkv_a"].shape) == (5120, 512 + 64)
    assert all(t.is_meta and t.dtype is torch.bfloat16
               for _, t in tree.flatten_with_path(meta))


@pytest.mark.parametrize("q_path", Q_PATHS)
def test_apply_mla_prefill_matches_reference(q_path):
    rcfg, cfg, rp, tp = _pair(q_path)
    x = np.random.default_rng(1).standard_normal((2, 7, rcfg.d_model))
    pos = np.broadcast_to(np.arange(7), (2, 7))
    want, _ = RL.apply_mla(rp, jnp.asarray(x, jnp.float32), rcfg,
                           jnp.asarray(pos, jnp.int32))
    got, cache = L.apply_mla(tp, torch.tensor(x, dtype=torch.float32), cfg,
                             torch.tensor(pos, dtype=torch.int32))
    assert cache is None and tuple(got.shape) == (2, 7, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("q_path", Q_PATHS)
@pytest.mark.parametrize("T", [1, 4])
def test_apply_mla_absorbed_decode_matches_reference(q_path, T):
    """A T-token step at per-row positions 3 and 6 into a 12-slot latent
    cache that holds earlier entries, then the next step: the absorbed
    attention's output and the cache written in place."""
    rcfg, cfg, rp, tp = _pair(q_path, seed=2)
    rng = np.random.default_rng(3)
    B, S = 2, 12
    cc = rng.standard_normal((B, S, rcfg.kv_lora_rank))
    cr = rng.standard_normal((B, S, rcfg.qk_rope_head_dim))
    rc = {"c_kv": jnp.asarray(cc, jnp.float32),
          "k_rope": jnp.asarray(cr, jnp.float32)}
    tc = {"c_kv": torch.tensor(cc, dtype=torch.float32),
          "k_rope": torch.tensor(cr, dtype=torch.float32)}
    starts = np.array([3, 6])
    for step in range(2):
        x = rng.standard_normal((B, T, rcfg.d_model))
        pos = (starts + step * T)[:, None] + np.arange(T)
        want, rc = RL.apply_mla(rp, jnp.asarray(x, jnp.float32), rcfg,
                                jnp.asarray(pos, jnp.int32), rc)
        got, tc2 = L.apply_mla(tp, torch.tensor(x, dtype=torch.float32),
                               cfg, torch.tensor(pos, dtype=torch.int32), tc)
        assert tc2 is tc                       # written in place
        _close(got, want)
        _close(tc["c_kv"], rc["c_kv"])
        _close(tc["k_rope"], rc["k_rope"])


def test_absorbed_decode_matches_the_naive_prefill():
    """Token by token through the latent cache == the naive expansion over
    the whole sequence (the port against itself: both paths of MLA)."""
    _, cfg, _, tp = _pair("q_lora", seed=4)
    x = torch.tensor(np.random.default_rng(5).standard_normal(
        (2, 9, cfg.d_model)), dtype=torch.float32)
    pos = torch.arange(9, dtype=torch.int32).expand(2, 9)
    full, _ = L.apply_mla(tp, x, cfg, pos)
    cache = L.init_mla_cache(cfg, 2, 9, CPU)
    outs = [L.apply_mla(tp, x[:, t:t + 1], cfg, pos[:, t:t + 1], cache)[0]
            for t in range(9)]
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **TOL)


def test_init_mla_cache_matches_reference():
    rcfg, cfg = _cfgs("q_lora")
    want = RL.init_mla_cache(rcfg, 3, 11)
    got = L.init_mla_cache(cfg, 3, 11, CPU)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype is torch.float32 and not bool(got[k].any())
    stacked = L.init_mla_cache(cfg, 3, 11, CPU, (4, 5))
    assert tuple(stacked["c_kv"].shape) == (4, 5) + want["c_kv"].shape
    bf = L.init_mla_cache(configs.get_config("deepseek_v2_236b"), 4, 48,
                          "meta")
    assert tuple(bf["c_kv"].shape) == (4, 48, 512)
    assert tuple(bf["k_rope"].shape) == (4, 48, 64)
    assert bf["c_kv"].dtype is torch.bfloat16


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_sdpa_with_key_wider_than_value(impl):
    """MLA's attention: keys of dn + dr = 24, values of dv = 16, scaled by
    sqrt(24); the chunked form equals the naive one and the reference's."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 16, 4, 24))
    k = rng.standard_normal((2, 16, 4, 24))
    v = rng.standard_normal((2, 16, 4, 16))
    qp = np.broadcast_to(np.arange(16), (2, 16))
    args = [torch.tensor(a, dtype=torch.float32) for a in (q, k, v)]
    got = L._sdpa(*args, True, torch.tensor(qp), impl=impl, chunk=4)
    want = RL._sdpa(*[jnp.asarray(a, jnp.float32) for a in (q, k, v)], True,
                    jnp.asarray(qp, jnp.int32), impl=impl, chunk=4)
    assert tuple(got.shape) == (2, 16, 4, 16)
    _close(got, want)
