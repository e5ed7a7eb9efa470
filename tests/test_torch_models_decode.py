"""The port's serving path over the stacked and layerwise backbones
(``repro_torch.models.stacked`` / ``transformer``, ``launch/steps.py``)
against the reference's on the CPU, on the reference's weights: the KV
caches' layout, a teacher-forced decode (prefill, then ``decode_step`` on
the reference's own sampled tokens) at rtol = atol = 1e-4 step by step,
and the port's token-by-token decode against its own forward at 3e-3, the
reference's tolerance (``tests/test_models.py``), for all ten archs.  The
VLM and audio archs get the frontend stub at every step, their
cross-attention gates opened to 0.5; the periodic archs run at 4 layers
(see ``test_torch_models_stacked.py``).  The SSM archs prefill through the
cache as the reference does, which lets only the prompt's first token
into the SSM state (``test_torch_models_mamba2.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import pipeline as RP
from repro.models import sampling as RSm
from repro.models import stacked as RS
from repro.models import transformer as RT
from repro_torch import configs, tree
from repro_torch.data import pipeline as P
from repro_torch.launch import steps
from repro_torch.models import stacked as S
from repro_torch.models import transformer as T

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = list(ref_configs.ARCH_IDS)
LAYERS = {"zamba2_2_7b": 4, "llama_3_2_vision_90b": 4,
          "musicgen_medium": 4, "deepseek_v2_236b": 4}


def _cfgs(arch, **kw):
    kw.setdefault("n_layers", LAYERS.get(arch, 2))
    return (ref_configs.get_config(arch).reduced(**kw),
            configs.get_config(arch).reduced(**kw))


def _open_gates(params):
    """The reference's params with every cross-attention gate at 0.5."""
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.full_like(a, 0.5)
        if getattr(p[-1], "key", None) == "gate" else a, params)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


# ---------------------------------------------------------------------------
# Serving path: caches, teacher-forced decode, decode vs forward.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmo_1b", "qwen2_moe_a2_7b",
                                  "deepseek_v2_236b", "zamba2_2_7b",
                                  "mamba2_1_3b", "musicgen_medium"])
def test_init_cache_matches_reference(arch):
    # zamba2 and musicgen at 4 layers: a periodic segment's cache list
    rcfg, cfg = _cfgs(arch, n_layers=LAYERS.get(arch, 3))
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
    rp = _open_gates(RS.init_params(rcfg, jax.random.PRNGKey(0)))
    tp = tree.params_from_numpy(rp, CPU)
    B, Pn, N = 2, 5, 6
    prompt = _tokens(rcfg, (B, Pn), 8)
    wf = bool(cfg.frontend_tokens)
    fe_r = RP.frontend_stub(rcfg, B)
    fe = (P.frontend_stub(cfg, B, CPU),) if wf else ()
    rc = RS.init_cache(rcfg, B, Pn + N)
    lg_r, rc, _ = RS.forward(rp, rcfg, jnp.asarray(prompt, jnp.int32),
                            frontend=fe_r, caches=rc)
    tc = S.init_cache(cfg, B, Pn + N, CPU)
    prefill = steps.make_prefill_step(cfg, with_frontend=wf)
    decode = steps.make_decode_step(cfg, with_frontend=wf)
    lg, tc = prefill(tp, torch.tensor(prompt), tc, *fe)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r), **TOL)
    key = jax.random.PRNGKey(9)
    for step in range(N):
        # the reference's token: a top-8 sample from its own logits
        key, sk = jax.random.split(key)
        tok = np.asarray(RSm.sample_logits(lg_r[:, -1, :], sk, 8))[:, None]
        pos = np.full((B,), Pn + step, np.int32)
        lg_r, rc = RS.decode_step(rp, rcfg, jnp.asarray(tok),
                                  jnp.asarray(pos), rc, frontend=fe_r)
        lg, tc = decode(tp, torch.tensor(tok), torch.tensor(pos), tc, *fe)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_r), **TOL,
                                   err_msg=f"decode step {step}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", ["stacked", "layerwise"])
def test_decode_path_matches_forward(arch, layout):
    """Token-by-token decode through the cache reproduces the forward
    logits (as the reference's ``test_decode_path_matches_forward``)."""
    _, cfg = _cfgs(arch)
    mod = S if layout == "stacked" else T
    params = tree.map_with_path(
        lambda path, t: torch.full_like(t, 0.5) if path[-1] == "gate" else t,
        mod.init_params(cfg, torch.Generator().manual_seed(0), CPU))
    toks = torch.tensor(_tokens(cfg, (1, 12), 10))
    fe = P.frontend_stub(cfg, 1, CPU)
    full, _, _ = mod.forward(params, cfg, toks, frontend=fe)
    caches = mod.init_cache(cfg, 1, 16, CPU)
    outs = []
    for t in range(12):
        lg, caches = mod.decode_step(params, cfg, toks[:, t:t + 1],
                                     torch.full((1,), t), caches,
                                     frontend=fe)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               rtol=3e-3, atol=3e-3)
