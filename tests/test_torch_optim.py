"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
``repro.optim.adamw`` on the CPU: the same numpy parameters, gradients and
state through 3 steps, with and without int8 compression, give the same
parameters, ``m``, ``v``, ``err`` and ``count`` within rtol 1e-6 and atol
1e-7; the int8 round trip within scale / 2; error feedback moves a 1e-4
component over 80 steps (``tests/test_substrate.py``'s case); the pieces
a large leaf is cut into leave the arithmetic unchanged.  (The reference's
descent setting, with and without compression, runs through the train
step in ``test_torch_train_step.py``.)"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro_torch import tree
from repro_torch.optim import adamw as A

TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(seed, dtype=np.float32):
    """A small nested tree: a stacked (3, 4, 5) leaf, a matrix, a vector
    and a scalar, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return {"segments": [{"w": rng.standard_normal((3, 4, 5)).astype(dtype)}],
            "embed": {"tok": rng.standard_normal((7, 6)).astype(dtype)},
            "norm": rng.standard_normal(6).astype(dtype),
            "gate": np.asarray(rng.standard_normal(), dtype)}


def _close(got, want, what):
    want = dict((jax.tree_util.keystr(p), np.asarray(a)) for p, a in
                jax.tree_util.tree_flatten_with_path(want)[0])
    got = dict((tree.keystr(p), x.detach().numpy()) for p, x in
               tree.flatten_with_path(got))
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                   **TOL)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("clip", [1.0, 1e9])
def test_update_matches_reference(compress, clip):
    ocfg = dict(lr=1e-2, warmup_steps=2, compress=compress, clip_norm=clip)
    rcfg, cfg = RA.AdamWConfig(**ocfg), A.AdamWConfig(**ocfg)
    p0 = _tree(0)
    rp = jax.tree.map(jnp.asarray, p0)
    tp = tree.params_from_numpy(p0, "cpu")
    rs, ts = RA.init(rp, rcfg), A.init(tp, cfg)
    for step in range(3):
        g = _tree(10 + step)
        rp, rs, rm = RA.update(rp, jax.tree.map(jnp.asarray, g), rs, rcfg)
        tg = tree.params_from_numpy(g, "cpu")
        tp2, ts, tm = A.update(tp, tg, ts, cfg)
        assert tp2 is tp                                   # in place
        # the gradients are read, never written
        _close(tg, g, "grads")
        _close(tp, rp, f"params step {step}")
        _close(ts.m, rs.m, f"m step {step}")
        _close(ts.v, rs.v, f"v step {step}")
        if compress:
            _close(ts.err, rs.err, f"err step {step}")
        else:
            assert ts.err is None and rs.err is None
        assert int(ts.count) == int(rs.count) == step + 1
        assert ts.count.dtype == torch.int32
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), **TOL)


def test_update_continues_the_reference_state():
    # a state the reference made (its m, v, err, count) carried across
    cfg = dict(lr=3e-3, warmup_steps=5, compress=True)
    rcfg, tcfg = RA.AdamWConfig(**cfg), A.AdamWConfig(**cfg)
    rp = jax.tree.map(jnp.asarray, _tree(1))
    rs = RA.init(rp, rcfg)
    for step in range(2):
        rp, rs, _ = RA.update(rp, jax.tree.map(jnp.asarray, _tree(20 + step)),
                              rs, rcfg)
    tp = tree.params_from_numpy(rp, "cpu")
    ts = A.OptState(*(tree.params_from_numpy(getattr(rs, f), "cpu")
                      for f in ("m", "v", "err", "count")))
    g = _tree(30)
    rp, rs, _ = RA.update(rp, jax.tree.map(jnp.asarray, g), rs, rcfg)
    A.update(tp, tree.params_from_numpy(g, "cpu"), ts, tcfg)
    _close(tp, rp, "params")
    _close(ts.m, rs.m, "m")
    _close(ts.err, rs.err, "err")


def test_bfloat16_params_keep_their_type_and_match_reference():
    cfg = dict(lr=1e-2, warmup_steps=1)
    rcfg, tcfg = RA.AdamWConfig(**cfg), A.AdamWConfig(**cfg)
    p = _tree(2)
    rp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    tp = tree.params_from_numpy(rp, "cpu")
    g = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), _tree(3))
    rs, ts = RA.init(rp, rcfg), A.init(tp, tcfg)
    rp, rs, _ = RA.update(rp, g, rs, rcfg)
    A.update(tp, tree.params_from_numpy(g, "cpu"), ts, tcfg)
    for (path, t), (_, a) in zip(tree.flatten_with_path(tp),
                                 jax.tree_util.tree_flatten_with_path(rp)[0]):
        assert t.dtype == torch.bfloat16
        # the same float32 update rounded once to bfloat16: bit for bit
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(a).view(np.int16)), path
    _close(ts.m, rs.m, "m")


def test_pieces_leave_the_arithmetic_unchanged(monkeypatch):
    # a stacked leaf cut into its layers, an embedding into rows: the same
    # parameters and state as the update of whole leaves
    cfg = A.AdamWConfig(lr=1e-2, warmup_steps=1, compress=True)
    p, g = _tree(4), _tree(5)
    whole = tree.params_from_numpy(p, "cpu")
    cut = tree.params_from_numpy(p, "cpu")
    sw, sc = A.init(whole, cfg), A.init(cut, cfg)
    A.update(whole, tree.params_from_numpy(g, "cpu"), sw, cfg)
    monkeypatch.setattr(A, "PIECE_ELEMENTS", 6)
    assert len(list(A._split(cut["segments"][0]["w"]))) == 3
    assert len(list(A._split(cut["embed"]["tok"]))) == 7
    A.update(cut, tree.params_from_numpy(g, "cpu"), sc, cfg)
    for (_, a), (_, b) in zip(tree.flatten_with_path((whole, sw)),
                              tree.flatten_with_path((cut, sc))):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_roundtrip_error_bounded(seed):
    g = np.random.default_rng(seed).standard_normal(512).astype(np.float32)
    q, s = A.quantize_int8(torch.from_numpy(g))
    deq = A.dequantize_int8(q, s)
    assert q.dtype == torch.int8
    assert float((deq - torch.from_numpy(g)).abs().max()) <= float(s) / 2 + 1e-7
    rq, rs = RA.quantize_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(s), float(rs), rtol=1e-7)


def test_global_norm_matches_reference():
    t = _tree(6)
    np.testing.assert_allclose(
        float(A.global_norm(tree.params_from_numpy(t, "cpu"))),
        float(RA.global_norm(jax.tree.map(jnp.asarray, t))), rtol=1e-6)


def test_error_feedback_accumulates():
    # a gradient too small for one int8 step still applies over many steps
    # through the residual
    cfg = A.AdamWConfig(lr=1.0, b1=0.0, b2=0.0, eps=1.0, weight_decay=0.0,
                        clip_norm=1e9, warmup_steps=1, compress=True)
    p = {"w": torch.zeros(4)}
    s = A.init(p, cfg)
    g = {"w": torch.tensor([1.0, 1e-4, 0.0, 0.0])}
    for _ in range(80):
        p, s, _ = A.update(p, g, s, cfg)
    assert abs(float(p["w"][1])) > 0.0
    assert float(s.err["w"].abs().max()) > 0.0


def test_config_fields_match_reference():
    assert [f.name for f in dataclasses.fields(A.AdamWConfig)] == \
        [f.name for f in dataclasses.fields(RA.AdamWConfig)]
    assert A.AdamWConfig() == A.AdamWConfig(
        **dataclasses.asdict(RA.AdamWConfig()))
    assert A.OptState._fields == RA.OptState._fields
