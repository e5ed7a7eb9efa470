"""The port's cross-attention layer (``repro_torch.models.layers``:
``init_xattn``, ``apply_xattn``) and its frontend stub
(``repro_torch.data.pipeline.frontend_stub``) against the reference's on
the CPU.  The gate starts at 0, which makes the layer add exactly 0, so
every parity test opens it to 0.5 in the reference's params before
carrying them across.  rtol = atol = 1e-4 (float32); the stub's bits
exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import pipeline as RP
from repro.models import layers as RL
from repro_torch import configs, tree
from repro_torch.data import pipeline as P
from repro_torch.models import layers as L

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)
FRONTEND_ARCHS = ["llama_3_2_vision_90b", "musicgen_medium"]


def _cfgs(arch, **kw):
    return (ref_configs.get_config(arch).reduced(**kw),
            configs.get_config(arch).reduced(**kw))


def _pair(arch, gate=0.5, seed=0):
    """(reference config, port config, reference params with the gate set,
    the same as tensors)."""
    rcfg, cfg = _cfgs(arch)
    rp = RL.init_xattn(rcfg, jax.random.PRNGKey(seed))
    rp["gate"] = jnp.full((), gate, rp["gate"].dtype)
    return rcfg, cfg, rp, tree.params_from_numpy(rp, CPU)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_init_xattn_layout_matches_reference(arch):
    rcfg, cfg = _cfgs(arch)
    want = jax.tree_util.tree_flatten_with_path(
        RL.init_xattn(rcfg, jax.random.PRNGKey(0)))[0]
    got = tree.flatten_with_path(L.init_xattn(
        cfg, torch.Generator().manual_seed(0), torch.device(CPU)))
    assert [tree.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (_, a), (_, b) in zip(want, got):
        assert tuple(b.shape) == a.shape and b.dtype is torch.float32
    gate = dict((p[-1], t) for p, t in got)["gate"]
    assert gate.shape == () and float(gate) == 0.0


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_apply_xattn_matches_reference(arch):
    # llama: 4 heads over 1 kv head, frontend_dim 32 != d_model;
    # musicgen: 4 over 4, frontend_dim 32
    rcfg, cfg, rp, tp = _pair(arch)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, rcfg.d_model))
    enc = rng.standard_normal((2, rcfg.frontend_tokens,
                               rcfg.frontend_dim or rcfg.d_model))
    want = RL.apply_xattn(rp, jnp.asarray(x, jnp.float32),
                          jnp.asarray(enc, jnp.float32), rcfg)
    got = L.apply_xattn(tp, torch.tensor(x, dtype=torch.float32),
                        torch.tensor(enc, dtype=torch.float32), cfg)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2   # not gated off
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_closed_gate_adds_exactly_zero():
    """At init the gate is 0: tanh(0) * out == 0, whatever the inputs."""
    _, cfg = _cfgs("llama_3_2_vision_90b")
    p = L.init_xattn(cfg, torch.Generator().manual_seed(2),
                     torch.device(CPU))
    x = torch.randn((2, 3, cfg.d_model))
    enc = torch.randn((2, cfg.frontend_tokens, cfg.frontend_dim))
    assert not bool(L.apply_xattn(p, x, enc, cfg).any())


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_frontend_stub_bits_match_reference(arch, reduced):
    """The stub's bits equal the reference's, float32 when reduced and
    bfloat16 at full size (llama: the whole 1601 x 8192 of one row)."""
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    if reduced:
        rcfg, cfg = rcfg.reduced(), cfg.reduced()
    want = np.asarray(RP.frontend_stub(rcfg, 1 if not reduced else 3))
    got = P.frontend_stub(cfg, 1 if not reduced else 3, CPU)
    assert got.dtype is cfg.dtype() and tuple(got.shape) == want.shape
    width = np.uint16 if got.dtype is torch.bfloat16 else np.uint32
    itype = torch.int16 if got.dtype is torch.bfloat16 else torch.int32
    np.testing.assert_array_equal(got.view(itype).numpy().view(width),
                                  want.view(width))


def test_frontend_stub_rounds_through_float32():
    """The reference's float64 -> bfloat16 cast rounds through float32: a
    single rounding from float64 differs from it in a few elements."""
    cfg = configs.get_config("llama_3_2_vision_90b")
    fe = np.random.default_rng(1234).standard_normal(
        (1, cfg.frontend_tokens, cfg.frontend_dim))
    m, e = np.frexp(fe)                        # nearest bf16, ties to even
    once = torch.from_numpy(np.ldexp(np.rint(np.ldexp(m, 8)), e - 8)
                            .astype(np.float32)).to(torch.bfloat16)
    got = P.frontend_stub(cfg, 1, CPU)
    differ = int((got.view(torch.int16) != once.view(torch.int16)).sum())
    assert 0 < differ < 1000


def test_frontend_stub_is_none_without_a_frontend():
    for arch in ("olmo_1b", "deepseek_v2_236b", "zamba2_2_7b"):
        assert P.frontend_stub(configs.get_config(arch), 2, CPU) is None
    cfg = configs.get_config("musicgen_medium").reduced()
    assert P.frontend_stub(cfg, 2, CPU, torch.float64).dtype is torch.float64
