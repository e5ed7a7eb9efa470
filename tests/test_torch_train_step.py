"""The port's train step (``launch.steps.make_train_step``) and training
inputs (``data.pipeline.TokenSource`` / ``host_batch``) against the
reference's on the CPU, on the reference's weights (float32 ``reduced()``
configs): 3 steps at lr 1e-2 with one warm-up step, with ``accum`` 1 and
with 2 microbatches summed in float32 and in bfloat16, with and without a
frontend.  The metrics (loss, nll, aux, grad_norm, lr) agree within rtol
1e-5 (the gradient norm of a bfloat16 sum within 1e-4: see below).  After each step the optimizer's moments ``m`` and ``v`` and the
parameters agree within rtol 1e-4 and atol 1e-6 in units of the leaf's
largest value where that exceeds 1 (the tolerance of
``test_torch_train_grads.py``), but for at most one element in 1000 of a
leaf, which stays within rtol 1e-2; where the microbatches' gradients are
summed in bfloat16 every element is held within 1e-2 of the leaf's
largest value (such a sum may round to the neighbouring bfloat16 value,
2^-8 of it apart, in one package and not the other).  The parameters are held leaf by leaf:
the distance to the reference's within 1e-3 of the distance the reference
moved them from their init, and every element within lr of the
reference's for each step taken.  (AdamW divides by sqrt(v), so an
element whose gradient lies at float32's noise floor moves by up to lr
whatever its exact value, in either package: up to 1 % of an attention
projection's elements differ by more than rtol 1e-4 after 3 steps, by at
most 6e-4.)  Batches are bit-equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import pipeline as RP
from repro.kernels import backend as ref_backend
from repro.launch import steps as RSteps
from repro.models import stacked as RS
from repro.models.config import ShapeConfig as RShape
from repro.optim import adamw as RA
from repro_torch import configs, tree
from repro_torch.data import pipeline as P
from repro_torch.launch import steps
from repro_torch.models import stacked as S
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw as A

CPU = "cpu"
OCFG = dict(lr=1e-2, warmup_steps=1)


@pytest.fixture(autouse=True, scope="module")
def _reference_topk_plain():
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PALLAS", "jnp")
    ref_backend.reset()
    yield
    mp.undo()
    ref_backend.reset()


def _cfgs(arch, n_layers, **kw):
    return (dataclasses.replace(
                ref_configs.get_config(arch).reduced(n_layers=n_layers), **kw),
            dataclasses.replace(
                configs.get_config(arch).reduced(n_layers=n_layers), **kw))


def _pairs(got, want):
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    got = tree.flatten_with_path(got)
    assert [tree.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    return [(tree.keystr(p), t.float().numpy(),
             np.asarray(a).astype(np.float32))
            for (p, t), (_, a) in zip(got, want)]


def _close_moments(got, want, what, bf16_sum):
    """All but one element in 1000 of a leaf within rtol 1e-4 and atol
    1e-6 (scaled to the leaf), the rest within rtol 1e-2; after a bfloat16
    sum, every element within 1e-2 of the leaf's largest value."""
    for k, b, a in _pairs(got, want):
        top = float(np.abs(a).max(initial=0.0))
        diff = np.abs(b - a)
        if bf16_sum:
            assert np.all(diff <= 1e-2 * top), (what, k)
            continue
        atol = 1e-6 * max(1.0, top)
        assert np.all(diff <= atol + 1e-2 * np.abs(a)), (what, k)
        out = diff > atol + 1e-4 * np.abs(a)
        assert out.sum() <= max(1, a.size // 1000), (what, k)


def _close_params(got, want, init, steps, what):
    """The distance to the reference's within 1e-3 of the reference's move
    from ``init``, and every element within lr a step."""
    for (k, b, a), (_, _, a0) in zip(_pairs(got, want), _pairs(got, init)):
        moved = np.linalg.norm(a - a0)
        assert np.linalg.norm(b - a) <= 1e-3 * moved, (what, k)
        assert np.abs(b - a).max(initial=0.0) <= OCFG["lr"] * steps, \
            (what, k)


CASES = {
    "accum1": dict(arch="qwen2_moe_a2_7b", layers=2, accum=1),
    "accum2-f32": dict(arch="qwen2_moe_a2_7b", layers=2, accum=2),
    "accum2-bf16": dict(arch="qwen2_moe_a2_7b", layers=2, accum=2,
                        accum_dtype="bfloat16"),
    "frontend-accum2": dict(arch="llama_3_2_vision_90b", layers=4, accum=2),
    "dense-remat-full": dict(arch="olmo_1b", layers=2, accum=1,
                             remat="full"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_reference(case):
    c = CASES[case]
    rcfg, cfg = _cfgs(c["arch"], c["layers"])
    remat = c.get("remat", "none")
    adt = c.get("accum_dtype", "float32")
    wf = bool(cfg.frontend_tokens)
    rstep = jax.jit(RSteps.make_train_step(
        rcfg, RA.AdamWConfig(**OCFG), remat=remat, accum=c["accum"],
        with_frontend=wf, accum_dtype=getattr(jnp, adt)))
    tstep = steps.make_train_step(
        cfg, A.AdamWConfig(**OCFG), remat=remat, accum=c["accum"],
        accum_dtype=getattr(torch, adt))
    rp = RS.init_params(rcfg, jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, rp)
    rs = RA.init(rp, RA.AdamWConfig(**OCFG))
    tp = tree.params_from_numpy(rp, CPU)
    ts = A.init(tp, A.AdamWConfig(**OCFG))
    fe = (RP.frontend_stub(rcfg, 4),) if wf else ()
    tfe = (P.frontend_stub(cfg, 4, CPU),) if wf else ()
    shape = ShapeConfig("t", 8, 4, "train")
    for step in range(3):
        x, y = P.TokenSource(cfg.vocab, 0).batch(step, 0, 4, 8)
        rp, rs, rm = rstep(rp, rs, jnp.asarray(x), jnp.asarray(y), *fe)
        tx, ty = P.host_batch(cfg, shape, step, device=CPU)
        tp, ts, tm = tstep(tp, ts, tx, ty, *tfe)
        assert sorted(tm) == sorted(rm) == ["aux", "grad_norm", "loss",
                                            "lr", "nll"]
        for k in rm:
            rtol = 1e-4 if k == "grad_norm" and adt == "bfloat16" else 1e-5
            np.testing.assert_allclose(float(tm[k]), float(rm[k]),
                                       rtol=rtol, atol=1e-7,
                                       err_msg=f"{case} step {step} {k}")
        bf16_sum = adt == "bfloat16"
        _close_moments(ts.m, rs.m, f"{case} m step {step}", bf16_sum)
        _close_moments(ts.v, rs.v, f"{case} v step {step}", bf16_sum)
        _close_params(tp, rp, init, step + 1, f"{case} step {step}")
    assert int(ts.count) == 3


def test_step_halves_compose_and_leave_params_until_applied():
    _, cfg = _cfgs("qwen2_moe_a2_7b", 2)
    step = steps.make_train_step(cfg, A.AdamWConfig(**OCFG), remat="none")
    p = S.init_params(cfg, torch.Generator().manual_seed(1), CPU)
    before = tree.map_with_path(lambda _, t: t.clone(), p)
    s = A.init(p, A.AdamWConfig(**OCFG))
    x, y = P.host_batch(cfg, ShapeConfig("t", 8, 2, "train"), 0, device=CPU)
    g, loss, metrics = step.grads(p, x, y)
    # the forward and backward change nothing (a driver may retry them)
    for (path, t), (_, b) in zip(tree.flatten_with_path(p),
                                 tree.flatten_with_path(before)):
        assert torch.equal(t, b) and not t.requires_grad, path
    assert [q for q, _ in tree.flatten_with_path(g)] == \
        [q for q, _ in tree.flatten_with_path(p)]
    p2, s2, m = step.apply(p, s, g, loss, metrics)
    assert p2 is p and int(s2.count) == 1
    changed = [not torch.equal(t, b) for (_, t), (_, b) in
               zip(tree.flatten_with_path(p), tree.flatten_with_path(before))]
    assert all(changed)
    # the same step in one call, from the same start
    q = tree.map_with_path(lambda _, t: t.clone(), before)
    q, sq, mq = step(q, A.init(q, A.AdamWConfig(**OCFG)), x, y)
    for k in m:
        assert torch.equal(m[k], mq[k]), k
    for (_, a), (_, b) in zip(tree.flatten_with_path(p),
                              tree.flatten_with_path(q)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_descends(compress):
    # the reference's descent setting (tests/test_substrate.py: olmo
    # reduced, lr 1e-2, warmup 1, no weight decay, 20 steps on one batch,
    # with and without int8 compression) through the stacked train step
    _, cfg = _cfgs("olmo_1b", 2)
    ocfg = A.AdamWConfig(lr=1e-2, warmup_steps=1, weight_decay=0.0,
                         compress=compress)
    step = steps.make_train_step(cfg, ocfg, remat="none")
    p = S.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    s = A.init(p, ocfg)
    x, y = P.host_batch(cfg, ShapeConfig("t", 32, 8, "train"), 0, device=CPU)
    losses = []
    for _ in range(20):
        p, s, m = step(p, s, x, y)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses[::5]


@pytest.mark.parametrize("seed,step,start,count,seq,vocab", [
    (0, 0, 0, 4, 16, 256), (3, 7, 4, 4, 16, 100), (11, 123, 0, 2, 33, 151936),
    (2, 5, 17, 3, 1, 7)])
def test_token_source_matches_reference(seed, step, start, count, seq, vocab):
    want = RP.TokenSource(vocab, seed).batch(step, start, count, seq)
    got = P.TokenSource(vocab, seed).batch(step, start, count, seq)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("step,batch,seq,seed", [(0, None, None, 0),
                                                 (9, 3, 5, 4)])
def test_host_batch_matches_reference(step, batch, seq, seed):
    rcfg, cfg = _cfgs("olmo_1b", 2)
    shape = ShapeConfig("t", 12, 4, "train")
    want = RP.host_batch(rcfg, RShape("t", 12, 4, "train"), step,
                         batch=batch, seq=seq, seed=seed)
    got = P.host_batch(cfg, shape, step, batch=batch, seq=seq, seed=seed,
                       device=CPU)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_host_batch_defaults_to_the_card():
    _, cfg = _cfgs("olmo_1b", 2)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.host_batch(cfg, ShapeConfig("t", 4, 2, "train"), 0)
