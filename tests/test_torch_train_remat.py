"""Training-path details of the port on the CPU: gradient checkpointing
(``remat`` ``full`` and ``dots``) gives gradients bit-equal to ``none``;
the stacked loop's ``unbind`` gives gradients bit-equal to the indexed
loop it replaced; ``transformer.loss_fn`` (the layerwise layout) matches
the reference's for the dense and MoE families; a bfloat16 loss matches
the reference's within 2e-2; no bfloat16 tensor on the gradient's path
goes through ``radix_select.gather_values``'s int16 view (which cuts the
graph); ``layers.matmul_f32``'s backward on the card keeps each gradient
in its operand's type (checked here for shapes and types on the meta
device: the card's float32-output product has no CPU kernel)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import stacked as RS
from repro.models import transformer as RT
from repro_torch import configs, tree
from repro_torch.core import radix_select as rs
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import stacked as S
from repro_torch.models import transformer as T

CPU = "cpu"
# a run of layers, two runs (dense then MoE), two periodic patterns
REMAT_ARCHS = {"olmo_1b": 3, "qwen2_moe_a2_7b": 3, "deepseek_v2_236b": 4,
               "zamba2_2_7b": 4, "llama_3_2_vision_90b": 4}


def _cfg(arch, n_layers, **kw):
    cfg = configs.get_config(arch).reduced(n_layers=n_layers)
    return dataclasses.replace(cfg, **kw)


def _params(cfg, seed=0):
    p = S.init_params(cfg, torch.Generator().manual_seed(seed), CPU)
    # open the cross-attention gates (0 at init: the layer adds nothing)
    return tree.map_with_path(
        lambda path, t: torch.full_like(t, 0.5) if path[-1] == "gate" else t,
        p)


def _batch(cfg, seed=0, batch=2, seq=8):
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, seq)))
    labels = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, seq)))
    fe = None
    if cfg.frontend_tokens:
        fe = torch.as_tensor(rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model)),
            dtype=cfg.dtype())
    return toks, labels, fe


def _grads(loss_of, params):
    live = tree.map_with_path(lambda _, t: t.detach().requires_grad_(True),
                              params)
    flat = tree.flatten_with_path(live)
    loss = loss_of(live)
    gs = torch.autograd.grad(loss, [t for _, t in flat], allow_unused=True)
    return loss.detach(), {p: g for (p, _), g in zip(flat, gs)}


def _assert_same(a, b):
    la, ga = a
    lb, gb = b
    assert torch.equal(la, lb)
    assert list(ga) == list(gb)
    for k in ga:
        assert (ga[k] is None) == (gb[k] is None), tree.keystr(k)
        if ga[k] is not None:
            assert torch.equal(ga[k], gb[k]), tree.keystr(k)


@pytest.mark.parametrize("arch", sorted(REMAT_ARCHS))
@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_grads_bit_equal_to_none(arch, mode):
    cfg = _cfg(arch, REMAT_ARCHS[arch], router_impl="pallas")
    p = _params(cfg)
    toks, labels, fe = _batch(cfg)
    run = lambda remat: _grads(lambda q: S.loss_fn(
        q, cfg, toks, labels, frontend=fe, remat=remat)[0], p)
    _assert_same(run(mode), run("none"))


def test_dots_saves_the_batch_free_products():
    # ops the backward runs: "full" recomputes every product of a layer,
    # "dots" only those with a batch dimension (bmm), as the reference's
    # dots_with_no_batch_dims_saveable
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    cfg = _cfg("olmo_1b", 3)
    p = _params(cfg)
    toks, labels, _ = _batch(cfg)
    n = {}
    for mode in ("none", "full", "dots"):
        live = tree.map_with_path(
            lambda _, t: t.detach().requires_grad_(True), p)
        loss, _ = S.loss_fn(live, cfg, toks, labels, remat=mode)
        with Count() as c:
            torch.autograd.grad(loss, [t for _, t in
                                       tree.flatten_with_path(live)])
        n[mode] = c.n
    assert n["full"]["mm"] > n["none"]["mm"] == n["dots"]["mm"]
    assert n["full"]["bmm"] == n["dots"]["bmm"] > n["none"]["bmm"]


def test_unknown_remat_raises():
    cfg = _cfg("olmo_1b", 2)
    with pytest.raises(ValueError, match="remat"):
        S.loss_fn(_params(cfg), cfg, *_batch(cfg)[:2], remat="some")


def _indexed_forward(params, cfg, tokens, frontend):
    """The stacked forward as it looped before ``unbind``: every layer's
    parameters taken by ``leaf[i]``."""
    B, Tn = tokens.shape
    positions = torch.arange(Tn, dtype=torch.int32).expand(B, Tn)
    x = L.embed_tokens(params["embed"], tokens)
    shared = params.get("shared_attn")
    aux = torch.zeros(())

    def run_layers(run, blk, x, aux):
        blks = [blk] if run.count == 1 else [S._index(blk, i)
                                             for i in range(run.count)]
        for b in blks:
            x, _, a = T.apply_block(shared, b, run.sig.kind, cfg, x,
                                    positions, frontend, None)
            aux = aux + a
        return x, aux

    for seg, sp in zip(S.segments(cfg), params["segments"]):
        if isinstance(seg, S.Run):
            x, aux = run_layers(seg, sp, x, aux)
            continue
        for r in range(seg.reps):
            for j, run in enumerate(seg.inner):
                x, aux = run_layers(run, S._index(sp["inner"][j], r), x, aux)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.lm_logits(params["embed"], x), aux


@pytest.mark.parametrize("arch", ["olmo_1b", "qwen2_moe_a2_7b",
                                  "zamba2_2_7b", "llama_3_2_vision_90b"])
def test_unbind_loop_grads_equal_indexed_loop(arch):
    cfg = _cfg(arch, REMAT_ARCHS[arch])
    p = _params(cfg, seed=1)
    toks, labels, fe = _batch(cfg, seed=1)

    def indexed(q):
        logits, aux = _indexed_forward(q, cfg, toks, fe)
        return T.nll_loss(logits, labels, aux, 0.01)[0]

    _assert_same(
        _grads(lambda q: S.loss_fn(q, cfg, toks, labels, frontend=fe)[0], p),
        _grads(indexed, p))


@pytest.mark.parametrize("arch", ["olmo_1b", "qwen2_moe_a2_7b"])
def test_transformer_loss_fn_matches_reference(arch):
    rcfg = ref_configs.get_config(arch).reduced()
    cfg = configs.get_config(arch).reduced()
    rp = RT.init_params(rcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, 8))
    labels = rng.integers(0, cfg.vocab, (2, 8))
    (rloss, rm), rg = jax.jit(jax.value_and_grad(
        lambda q: RT.loss_fn(q, rcfg, jnp.asarray(toks, jnp.int32),
                             jnp.asarray(labels, jnp.int32)),
        has_aux=True))(rp)
    loss, g = _grads(lambda q: T.loss_fn(q, cfg, torch.as_tensor(toks),
                                         torch.as_tensor(labels))[0],
                     tree.params_from_numpy(rp, CPU))
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    want = jax.tree_util.tree_flatten_with_path(rg)[0]
    assert [tree.keystr(k) for k in g] == \
        [jax.tree_util.keystr(k) for k, _ in want]
    for (k, t), (_, a) in zip(g.items(), want):
        a = np.asarray(a)
        np.testing.assert_allclose(
            t.numpy(), a, rtol=1e-4,
            atol=1e-6 * max(1.0, float(np.abs(a).max())),
            err_msg=tree.keystr(k))


def test_bfloat16_loss_matches_reference():
    rcfg = dataclasses.replace(ref_configs.get_config("olmo_1b").reduced(),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_config("olmo_1b").reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    rp = RS.init_params(rcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 16))
    labels = rng.integers(0, cfg.vocab, (2, 16))
    rloss, _ = RS.loss_fn(rp, rcfg, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(labels, jnp.int32))
    loss, g = _grads(lambda q: S.loss_fn(q, cfg, torch.as_tensor(toks),
                                         torch.as_tensor(labels))[0],
                     tree.params_from_numpy(rp, CPU))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(rloss), rtol=2e-2)
    # each gradient in its parameter's type, all finite
    for k, t in g.items():
        assert t.dtype == torch.bfloat16 and bool(torch.isfinite(t).all())


def test_no_bfloat16_gather_on_the_gradient_path(monkeypatch):
    # a bfloat16 MoE training step: every value gather that autograd
    # differentiates is float32 (the router's logits), so the int16 view
    # never cuts the graph
    seen = []
    real = rs.gather_values

    def spy(x, idx):
        seen.append((x.dtype, x.requires_grad))
        return real(x, idx)

    monkeypatch.setattr(rs, "gather_values", spy)
    monkeypatch.setattr(ops, "gather_values", spy)
    for router in ("radix", "pallas", "lax"):
        cfg = _cfg("qwen2_moe_a2_7b", 2, router_impl=router,
                   param_dtype="bfloat16", compute_dtype="bfloat16")
        p = S.init_params(cfg, torch.Generator().manual_seed(4), CPU)
        toks, labels, _ = _batch(cfg, seed=4)
        _, g = _grads(lambda q: S.loss_fn(q, cfg, toks, labels)[0], p)
        router_g = g[("segments", 0, "moe", "router")]
        assert router_g is not None and bool(router_g.abs().sum() > 0)
    assert seen and all(dt == torch.float32 for dt, grad in seen if grad)
    assert any(grad for _, grad in seen)


@pytest.mark.parametrize("a_shape,b_shape", [((6, 8), (8, 5)),
                                             ((3, 6, 8), (3, 8, 5))])
def test_matmul_f32_backward_keeps_operand_types(a_shape, b_shape):
    meta = torch.device("meta")
    a = torch.empty(a_shape, dtype=torch.bfloat16, device=meta,
                    requires_grad=True)
    b = torch.empty(b_shape, dtype=torch.bfloat16, device=meta,
                    requires_grad=True)
    out = L._MatmulF32.apply(a, b)
    assert out.dtype == torch.float32
    assert tuple(out.shape) == a_shape[:-1] + b_shape[-1:]
    da, db = torch.autograd.grad(out, (a, b), torch.ones_like(out))
    assert da.dtype == db.dtype == torch.bfloat16
    assert da.shape == a.shape and db.shape == b.shape
    # only the operand that asks for a gradient gets one
    (da,) = torch.autograd.grad(L._MatmulF32.apply(a, b.detach()), (a,),
                                torch.ones_like(out))
    assert da.shape == a.shape
