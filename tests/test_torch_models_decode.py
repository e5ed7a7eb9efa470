"""The port's serving path over the stacked and layerwise backbones
(``repro_torch.models.stacked`` / ``transformer``, ``launch/steps.py``)
against the reference's on the CPU, on the reference's weights: the KV
caches' layout, a teacher-forced decode (prefill, then ``decode_step`` on
the reference's own sampled tokens) at rtol = atol = 1e-4 step by step,
and the port's token-by-token decode against its own forward at 3e-3, the
reference's tolerance (``tests/test_models.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import sampling as RSm
from repro.models import stacked as RS
from repro.models import transformer as RT
from repro_torch import configs, tree
from repro_torch.launch import steps
from repro_torch.models import stacked as S
from repro_torch.models import transformer as T

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["olmo_1b", "qwen3_14b", "gemma_7b", "deepseek_7b",
         "qwen2_moe_a2_7b"]


def _cfgs(arch, **kw):
    return (ref_configs.get_config(arch).reduced(**kw),
            configs.get_config(arch).reduced(**kw))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


# ---------------------------------------------------------------------------
# Serving path: caches, teacher-forced decode, decode vs forward.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmo_1b", "qwen2_moe_a2_7b"])
def test_init_cache_matches_reference(arch):
    rcfg, cfg = _cfgs(arch, n_layers=3)
    for rfn, fn in ((RS.init_cache, S.init_cache),
                    (RT.init_cache, T.init_cache)):
        want = jax.tree_util.tree_flatten_with_path(rfn(rcfg, 2, 9))[0]
        got = tree.flatten_with_path(fn(cfg, 2, 9, CPU))
        assert [(tree.keystr(p), tuple(t.shape)) for p, t in got] == \
            [(jax.tree_util.keystr(p), a.shape) for p, a in want]
        assert not any(bool(t.any()) for _, t in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_reference(arch):
    """Prefill, then ``decode_step`` on the reference's own tokens, the
    logits compared step by step."""
    rcfg, cfg = _cfgs(arch)
    rp = RS.init_params(rcfg, jax.random.PRNGKey(0))
    tp = tree.params_from_numpy(rp, CPU)
    B, P, N = 2, 5, 6
    prompt = _tokens(rcfg, (B, P), 8)
    rc = RS.init_cache(rcfg, B, P + N)
    lg_r, rc, _ = RS.forward(rp, rcfg, jnp.asarray(prompt, jnp.int32),
                            caches=rc)
    tc = S.init_cache(cfg, B, P + N, CPU)
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)
    lg, tc = prefill(tp, torch.tensor(prompt), tc)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r), **TOL)
    key = jax.random.PRNGKey(9)
    for step in range(N):
        # the reference's token: a top-8 sample from its own logits
        key, sk = jax.random.split(key)
        tok = np.asarray(RSm.sample_logits(lg_r[:, -1, :], sk, 8))[:, None]
        pos = np.full((B,), P + step, np.int32)
        lg_r, rc = RS.decode_step(rp, rcfg, jnp.asarray(tok),
                                  jnp.asarray(pos), rc)
        lg, tc = decode(tp, torch.tensor(tok), torch.tensor(pos), tc)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r), **TOL,
                                   err_msg=f"decode step {step}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", ["stacked", "layerwise"])
def test_decode_path_matches_forward(arch, layout):
    """Token-by-token decode through the cache reproduces the forward
    logits (as the reference's ``test_decode_path_matches_forward``)."""
    _, cfg = _cfgs(arch)
    mod = S if layout == "stacked" else T
    params = mod.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    toks = torch.tensor(_tokens(cfg, (1, 12), 10))
    full, _, _ = mod.forward(params, cfg, toks)
    caches = mod.init_cache(cfg, 1, 16, CPU)
    outs = []
    for t in range(12):
        lg, caches = mod.decode_step(params, cfg, toks[:, t:t + 1],
                                     torch.full((1,), t), caches)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               rtol=3e-3, atol=3e-3)
