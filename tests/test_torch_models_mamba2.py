"""The port's Mamba2 SSD block (``repro_torch.models.mamba2``) against the
reference's ``repro.models.mamba2`` on the CPU, on the reference's
weights: the parameter layout and dtypes, the chunked scan, the causal
conv's streaming state, one cached step, token-by-token decode against
the forward, and the cached multi-token prefill, which the port
reproduces as the reference writes it (only token 0 enters the SSM
state).  rtol = atol = 1e-4 unless a test says otherwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import mamba2 as RM
from repro_torch import configs, tree
from repro_torch.models import mamba2 as M

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch="mamba2_1_3b", **kw):
    return (ref_configs.get_config(arch).reduced(**kw),
            configs.get_config(arch).reduced(**kw))


def _pair(arch="mamba2_1_3b", seed=0):
    rcfg, cfg = _cfgs(arch)
    rp = RM.init_ssm(rcfg, jax.random.PRNGKey(seed))
    return rcfg, cfg, rp, tree.params_from_numpy(rp, CPU)


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_dims_match_reference():
    for arch in ("mamba2_1_3b", "zamba2_2_7b"):
        for red in (False, True):
            rcfg, cfg = (ref_configs.get_config(arch),
                         configs.get_config(arch))
            if red:
                rcfg, cfg = rcfg.reduced(), cfg.reduced()
            assert M._dims(cfg) == RM._dims(rcfg)
    assert M._dims(configs.get_config("mamba2_1_3b")) == (4096, 64, 64, 128)


@pytest.mark.parametrize("full", [False, True])
def test_init_ssm_layout_and_dtypes(full):
    arch = "zamba2_2_7b"
    if full:
        # bfloat16 at full width: A_log, D, dt_bias stay float32
        rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
        want = jax.eval_shape(lambda k: RM.init_ssm(rcfg, k),
                              jax.random.PRNGKey(0))
        got = M.init_ssm(cfg, None, torch.device("meta"))
    else:
        rcfg, cfg = _cfgs(arch)
        want = RM.init_ssm(rcfg, jax.random.PRNGKey(0))
        got = M.init_ssm(cfg, torch.Generator().manual_seed(0),
                         torch.device(CPU))
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    got = tree.flatten_with_path(got)
    assert [tree.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (_, a), (_, b) in zip(want, got):
        assert tuple(b.shape) == a.shape
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
    if not full:
        # the deterministic leaves equal the reference's
        ref = RM.init_ssm(rcfg, jax.random.PRNGKey(0))
        mine = dict((p[-1], t) for p, t in got)
        for name in ("A_log", "D", "dt_bias", "conv_b", "gate_norm"):
            np.testing.assert_allclose(mine[name].numpy(),
                                       np.asarray(ref[name]), rtol=1e-6)


def test_causal_conv_streaming_matches_reference():
    """The whole sequence at once == three chunks through the streaming
    state, and both == the reference's, state included."""
    rcfg, cfg, rp, tp = _pair()
    d_in, H, P, S = M._dims(cfg)
    C = d_in + 2 * S
    xbc = np.random.default_rng(1).standard_normal((2, 10, C))
    w, b = tp["conv_w"], torch.tensor(np.random.default_rng(2)
                                      .standard_normal(C),
                                      dtype=torch.float32)
    t = torch.tensor(xbc, dtype=torch.float32)
    full, st_full = M._causal_conv(t, w, b)
    want, want_st = RM._causal_conv(jnp.asarray(xbc, jnp.float32),
                                    rp["conv_w"], jnp.asarray(b.numpy()))
    _close(full, want)
    _close(st_full, want_st)
    state = torch.zeros((2, cfg.conv_kernel - 1, C))
    parts = []
    for a, z in ((0, 3), (3, 4), (4, 10)):
        y, state = M._causal_conv(t[:, a:z], w, b, state)
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), full.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(state.numpy(), st_full.numpy())


@pytest.mark.parametrize("arch,L", [("mamba2_1_3b", 32), ("zamba2_2_7b", 16),
                                    ("mamba2_1_3b", 8)])
def test_chunked_ssd_matches_reference(arch, L):
    # L 32 and 16 run two and one chunks of 16; L 8 one chunk of 8
    rcfg, cfg, rp, tp = _pair(arch, seed=3)
    x = _x(cfg, (2, L), 4)
    want, _ = RM.apply_ssm(rp, jnp.asarray(x, jnp.float32), rcfg)
    got, cache = M.apply_ssm(tp, torch.tensor(x, dtype=torch.float32), cfg)
    assert cache is None
    _close(got, want)


def test_chunked_ssd_matches_the_sequential_oracle():
    """As the reference's ``TestSSD.test_chunked_matches_sequential``
    (2e-3), and the port's oracle against the reference's (1e-4)."""
    rcfg, cfg, rp, tp = _pair()
    x = torch.tensor(_x(cfg, (2, 32), 5), dtype=torch.float32)
    y_chunk, _ = M.apply_ssm(tp, x, cfg)
    y_seq = M.apply_ssm_ref(tp, x, cfg)
    np.testing.assert_allclose(y_chunk.numpy(), y_seq.numpy(), rtol=2e-3,
                               atol=2e-3)
    _close(y_seq, RM.apply_ssm_ref(rp, jnp.asarray(x.numpy()), rcfg))


def test_chunk_must_divide_the_sequence():
    _, cfg, _, tp = _pair()
    with pytest.raises(ValueError, match="chunk"):
        M.apply_ssm(tp, torch.zeros((1, 20, cfg.d_model)), cfg)


def _cache_pair(rcfg, cfg, seed):
    """A cache holding earlier conv and SSM state, in both packages."""
    rng = np.random.default_rng(seed)
    rc = RM.init_ssm_cache(rcfg, 2)
    conv = rng.standard_normal(rc["conv"].shape)
    ssm = rng.standard_normal(rc["ssm"].shape)
    return ({"conv": jnp.asarray(conv, jnp.float32),
             "ssm": jnp.asarray(ssm, jnp.float32)},
            {"conv": torch.tensor(conv, dtype=torch.float32),
             "ssm": torch.tensor(ssm, dtype=torch.float32)})


def test_one_cached_step_matches_reference():
    rcfg, cfg, rp, tp = _pair(seed=6)
    rc, tc = _cache_pair(rcfg, cfg, 7)
    for step in range(2):
        x = _x(cfg, (2, 1), 8 + step)
        want, rc = RM.apply_ssm(rp, jnp.asarray(x, jnp.float32), rcfg, rc)
        got, tc2 = M.apply_ssm(tp, torch.tensor(x, dtype=torch.float32),
                               cfg, tc)
        assert tc2 is tc                       # written in place
        _close(got, want)
        _close(tc["conv"], rc["conv"])
        _close(tc["ssm"], rc["ssm"])


def test_init_ssm_cache_matches_reference():
    rcfg, cfg = _cfgs()
    want = RM.init_ssm_cache(rcfg, 3)
    got = M.init_ssm_cache(cfg, 3, CPU)
    for k in ("conv", "ssm"):
        assert tuple(got[k].shape) == want[k].shape
        assert not bool(got[k].any())
    assert tuple(M.init_ssm_cache(cfg, 3, CPU, (2, 5))["ssm"].shape) == \
        (2, 5) + want["ssm"].shape
    full = M.init_ssm_cache(configs.get_config("mamba2_1_3b"), 4, "meta")
    assert full["conv"].dtype is torch.bfloat16
    assert full["ssm"].dtype is torch.float32
    assert tuple(full["ssm"].shape) == (4, 64, 64, 128)


def test_decode_matches_forward():
    """Token by token through the cache == the chunked forward (the
    reference's ``TestSSD.test_decode_matches_forward``, 2e-3)."""
    _, cfg, _, tp = _pair(seed=9)
    x = torch.tensor(_x(cfg, (1, 16), 10), dtype=torch.float32)
    full, _ = M.apply_ssm(tp, x, cfg)
    cache = M.init_ssm_cache(cfg, 1, CPU)
    outs = [M.apply_ssm(tp, x[:, t:t + 1], cfg, cache)[0] for t in range(16)]
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_cached_prefill_reproduces_the_reference():
    """A 4-token prompt through a zero cache, as ``launch/serve.py``
    prefills: the port equals the reference (output, conv and SSM state),
    and both differ from the forward at positions >= 1: the cached branch
    lets only token 0 into the SSM state (ROADMAP queue C)."""
    rcfg, cfg, rp, tp = _pair(seed=11)
    x = _x(cfg, (1, 4), 12)
    rc = RM.init_ssm_cache(rcfg, 1)
    want, rc = RM.apply_ssm(rp, jnp.asarray(x, jnp.float32), rcfg, rc)
    tx = torch.tensor(x, dtype=torch.float32)
    tc = M.init_ssm_cache(cfg, 1, CPU)
    got, _ = M.apply_ssm(tp, tx, cfg, tc)
    _close(got, want)
    _close(tc["conv"], rc["conv"])
    _close(tc["ssm"], rc["ssm"])
    full, _ = M.apply_ssm(tp, tx, cfg)
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, 0].numpy(),
                               **TOL)
    assert float((got[:, 1:] - full[:, 1:]).abs().max()) > 1e-2
    # the SSM state holds token 0 alone; the conv state all four tokens
    steps = M.init_ssm_cache(cfg, 1, CPU)
    for t in range(4):
        M.apply_ssm(tp, tx[:, t:t + 1], cfg, steps)
    assert float((tc["ssm"] - steps["ssm"]).abs().max()) > 1e-2
    np.testing.assert_allclose(tc["conv"].numpy(), steps["conv"].numpy(),
                               rtol=1e-6, atol=1e-6)
    one = M.init_ssm_cache(cfg, 1, CPU)
    M.apply_ssm(tp, tx[:, :1], cfg, one)
    np.testing.assert_allclose(tc["ssm"].numpy(), one["ssm"].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_bfloat16_keeps_float32_state():
    """A bfloat16 block: dt, the SSM state and A_log / D / dt_bias stay
    float32; the output is bfloat16."""
    cfg = dataclasses.replace(configs.get_config("mamba2_1_3b").reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    p = M.init_ssm(cfg, torch.Generator().manual_seed(0), torch.device(CPU))
    assert p["A_log"].dtype is torch.float32
    assert p["in_proj"].dtype is torch.bfloat16
    x = torch.randn((1, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).to(torch.bfloat16)
    y, _ = M.apply_ssm(p, x, cfg)
    assert y.dtype is torch.bfloat16 and bool(torch.isfinite(y).all())
    cache = M.init_ssm_cache(cfg, 1, CPU)
    y1, _ = M.apply_ssm(p, x[:, :1], cfg, cache)
    assert y1.dtype is torch.bfloat16 and cache["ssm"].dtype is torch.float32
    assert bool(cache["ssm"].any())
