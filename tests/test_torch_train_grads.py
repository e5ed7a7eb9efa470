"""The port's training loss and its gradients (``stacked.loss_fn`` under
autograd) against the reference's (``jax.grad`` of ``stacked.loss_fn``) on
the CPU, on the reference's weights, for all ten archs in ``reduced()``
configs (float32, the stacked layout; the periodic archs and deepseek-v2 at
4 layers; cross-attention gates opened to 0.5; the frontend stub given to
the VLM and audio archs).

The loss agrees within rtol 1e-5 and every leaf's gradient within rtol
1e-4 and atol 1e-6 in units of the leaf's largest gradient where that
exceeds 1: the token embedding's gradient reaches 4-9 (its rows are drawn
at scale 0.02, and the first norm divides by their rms), where one float32
ulp is 4.8e-7-9.5e-7, and its few entries that are differences of such
terms carry that much of XLA's and torch's different summation orders.

The MoE archs run under the three router engines (``radix``, ``pallas``,
``lax``); the reference's ``pallas`` top-k runs through its plain
reference (``REPRO_PALLAS=jnp``: its interpret mode has no derivative
rule), as its own tests run it on the CPU, and the port's three engines
give identical gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import pipeline as RP
from repro.kernels import backend as ref_backend
from repro.models import stacked as RS
from repro_torch import configs, tree
from repro_torch.data import pipeline as P
from repro_torch.models import stacked as S

CPU = "cpu"
ARCHS = list(ref_configs.ARCH_IDS)
LAYERS = {"zamba2_2_7b": 4, "llama_3_2_vision_90b": 4,
          "musicgen_medium": 4, "deepseek_v2_236b": 4}
MOE_ARCHS = [a for a in ARCHS if ref_configs.get_config(a).moe]
ROUTERS = ["radix", "pallas", "lax"]
CASES = [(a, r) for a in ARCHS
         for r in (ROUTERS if a in MOE_ARCHS else [None])]
BATCH, SEQ = 2, 8


@pytest.fixture(autouse=True, scope="module")
def _reference_topk_plain():
    """The reference's Pallas kernels through their plain jnp references
    for this module (its interpret mode has no JVP)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PALLAS", "jnp")
    ref_backend.reset()
    yield
    mp.undo()
    ref_backend.reset()


def cfgs(arch, router=None):
    n = LAYERS.get(arch, 2)
    rcfg = ref_configs.get_config(arch).reduced(n_layers=n)
    cfg = configs.get_config(arch).reduced(n_layers=n)
    if router:
        rcfg = dataclasses.replace(rcfg, router_impl=router)
        cfg = dataclasses.replace(cfg, router_impl=router)
    return rcfg, cfg


def open_gates(params):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.full_like(a, 0.5)
        if getattr(p[-1], "key", None) == "gate" else a, params)


def inputs(rcfg, cfg, seed=0):
    """(tokens, labels) as numpy, and the two packages' frontend stubs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ))
    labels = rng.integers(0, cfg.vocab, (BATCH, SEQ))
    if not cfg.frontend_tokens:
        return toks, labels, None, None
    return (toks, labels, RP.frontend_stub(rcfg, BATCH),
            P.frontend_stub(cfg, BATCH, CPU))


def port_loss_and_grads(params, cfg, toks, labels, fe, **kw):
    """(loss, metrics, {keystr: gradient}) of ``stacked.loss_fn``."""
    live = tree.map_with_path(lambda _, t: t.detach().requires_grad_(True),
                              params)
    flat = tree.flatten_with_path(live)
    loss, metrics = S.loss_fn(live, cfg, torch.as_tensor(toks),
                              torch.as_tensor(labels), frontend=fe, **kw)
    gs = torch.autograd.grad(loss, [t for _, t in flat], allow_unused=True)
    return loss.detach(), metrics, {
        tree.keystr(p): (torch.zeros_like(t) if g is None else g)
        for (p, t), g in zip(flat, gs)}


def assert_grads_close(got, want_tree):
    want = [(jax.tree_util.keystr(p), np.asarray(a)) for p, a in
            jax.tree_util.tree_flatten_with_path(want_tree)[0]]
    assert list(got) == [k for k, _ in want]
    for k, a in want:
        atol = 1e-6 * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(got[k].numpy(), a, rtol=1e-4, atol=atol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def reference():
    """(arch, router) -> (reference config, port config, the reference's
    params, its loss, metrics and gradients): one jax.grad a case."""
    out = {}

    def get(arch, router):
        if (arch, router) not in out:
            rcfg, cfg = cfgs(arch, router)
            rp = open_gates(RS.init_params(rcfg, jax.random.PRNGKey(0)))
            toks, labels, fer, _ = inputs(rcfg, cfg)
            (loss, metrics), g = jax.jit(jax.value_and_grad(
                lambda p: RS.loss_fn(p, rcfg, jnp.asarray(toks, jnp.int32),
                                     jnp.asarray(labels, jnp.int32),
                                     frontend=fer), has_aux=True))(rp)
            out[arch, router] = (rcfg, cfg, rp, loss, metrics, g)
        return out[arch, router]

    return get


@pytest.mark.parametrize("arch,router", CASES)
def test_loss_and_grads_match_reference(arch, router, reference):
    rcfg, cfg, rp, rloss, rmetrics, rg = reference(arch, router)
    toks, labels, _, fe = inputs(rcfg, cfg)
    loss, metrics, g = port_loss_and_grads(
        tree.params_from_numpy(rp, CPU), cfg, toks, labels, fe)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    metrics = {k: float(v.detach()) for k, v in metrics.items()}
    for k in ("nll", "aux"):
        np.testing.assert_allclose(metrics[k], float(rmetrics[k]),
                                   rtol=1e-5, atol=1e-7)
    assert (metrics["aux"] > 0) == bool(cfg.moe)
    assert_grads_close(g, rg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_engines_give_identical_grads(arch, reference):
    _, _, rp, _, _, _ = reference(arch, "radix")
    runs = {}
    for router in ROUTERS:
        rcfg, cfg = cfgs(arch, router)
        toks, labels, _, fe = inputs(rcfg, cfg)
        runs[router] = port_loss_and_grads(tree.params_from_numpy(rp, CPU),
                                           cfg, toks, labels, fe)
    loss, _, g = runs["radix"]
    for router in ("pallas", "lax"):
        assert torch.equal(runs[router][0], loss), router
        for k, t in g.items():
            assert torch.equal(runs[router][2][k], t), (router, k)
