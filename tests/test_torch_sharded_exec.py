"""The port's sharded execution on 8 gloo ranks on the CPU, a (4, 2) data x
model mesh (``make_host_mesh(model_parallel=2)``), against the port's
unsharded steps and the reference's unsharded jitted steps, as
``tests/test_launch.py::TestShardedExecution`` holds the reference's:
qwen2-moe reduced with 8 experts, ``aux_weight`` 0.01, batch (8, 16),
AdamW lr 1e-3 with one warm-up step, remat full.  The ranks start once
for the module (``_torch_ranks.mesh8``) and run every case.

Tolerances.  Against the port's unsharded step (2 steps, with and without
int8 compression): loss, nll and aux within 1e-5, the gradient norm
within a relative 1e-5, every parameter by the leaf-distance rule of
``test_torch_train_step.py`` (the distance to the unsharded parameters
within 1e-3 of the distance they moved, every element within lr a step).
Against the reference's jitted step: its own bounds, 1e-3 on the loss and
2e-2 on the parameters.  Two decode steps: within 1e-5 of the port's,
2e-2 of the reference's.  ``train(mesh=...)``: losses within 1e-5 of the
unsharded ``train()``, a checkpoint resumed to the same losses within
1e-6.  Batches, tokens, reshards and placements are exact."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro import configs as ref_configs
from repro.kernels import backend as ref_backend
from repro.launch import sharding as RSh
from repro.launch import steps as RSteps
from repro.models import stacked as RS
from repro.optim import adamw as RA
from repro_torch import tree
from repro_torch.data import pipeline as P
from repro_torch.launch import serve, steps
from repro_torch.launch import train as trainer
from repro_torch.models import stacked as S
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw as A

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
STEPS = 2


@pytest.fixture(scope="module")
def ref():
    """The reference's config, weights and batches (numpy)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PALLAS", "jnp")   # interpret-mode Pallas has no JVP
    ref_backend.reset()
    rcfg = dataclasses.replace(
        ref_configs.get_config("qwen2_moe_a2_7b").reduced(),
        n_routed_experts=8)
    rp = RS.init_params(rcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(
        0, rcfg.vocab, (R.BATCH, R.SEQ)).astype(np.int32)
    batches = [P.TokenSource(rcfg.vocab, 0).batch(s, 0, R.BATCH, R.SEQ)
               for s in range(STEPS)]
    yield {"cfg": rcfg, "params": jax.tree.map(np.asarray, rp),
           "toks": toks, "batches": batches}
    mp.undo()
    ref_backend.reset()


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    return R.spawn("mesh8", WORLD, tmp_path_factory.mktemp("mesh8"),
                   {k: ref[k] for k in ("params", "toks", "batches")})


def _flat(params):
    return {tree.keystr(p): t.float().numpy()
            for p, t in tree.flatten_with_path(params)}


def _ref_flat(params):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_flatten_with_path(params)[0]}


def _leaf_distance(got, want, init, steps_, lr, what):
    for k, a in want.items():
        moved = np.linalg.norm(a - init[k])
        assert np.linalg.norm(got[k] - a) <= 1e-3 * moved, (what, k)
        assert np.abs(got[k] - a).max(initial=0.0) <= lr * steps_, (what, k)


def test_mesh_is_data_by_model(ranks):
    for r in ranks:
        assert r["mesh"] == ((4, 2), ("data", "model"), ("data",))


@pytest.mark.parametrize("compress", [False, True])
def test_state_is_laid_out_by_the_reference_specs(ranks, ref, compress):
    from types import SimpleNamespace
    sizes = {"data": 4, "model": 2}
    specs = RSh.param_specs(SimpleNamespace(shape=sizes), ref["params"])
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    shapes = _ref_flat(ref["params"])
    for path, spec in flat:
        k = jax.tree_util.keystr(path)
        want = list(shapes[k].shape)
        for d, entry in enumerate(spec):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    want[d] //= sizes[axis]
        for r in ranks:
            got = r[f"train_compress{compress}"]
            assert list(got["local"][k]) == want, k
            assert list(got["local_m"][k]) == want, k
    # the state really is spread: the token embedding over all 8 ranks
    tok = ranks[0]["train_compressFalse"]["local"]["['embed']['tok']"]
    assert np.prod(tok) * WORLD == shapes["['embed']['tok']"].size


def _port_steps(ref, compress):
    cfg = R.moe_cfg()
    ocfg = A.AdamWConfig(**R.OCFG, compress=compress)
    p = tree.params_from_numpy(ref["params"], "cpu")
    s = A.init(p, ocfg)
    step = steps.make_train_step(cfg, ocfg)
    metrics = []
    for x, y in ref["batches"]:
        p, s, m = step(p, s, torch.from_numpy(x), torch.from_numpy(y))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _flat(p)


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_unsharded_port(ranks, ref, compress):
    want_m, want_p = _port_steps(ref, compress)
    init = _ref_flat(ref["params"])
    for r in ranks:
        got = r[f"train_compress{compress}"]
        assert got["count"] == STEPS
        for step, (g, w) in enumerate(zip(got["metrics"], want_m)):
            for k in ("loss", "nll", "aux"):
                assert abs(g[k] - w[k]) <= 1e-5, (step, k, g[k], w[k])
            assert abs(g["grad_norm"] - w["grad_norm"]) <= \
                1e-5 * w["grad_norm"], (step, g["grad_norm"], w["grad_norm"])
            assert g["lr"] == w["lr"]
        _leaf_distance(got["params"], want_p, init, STEPS, R.OCFG["lr"],
                       f"compress {compress}")
    # every rank holds the same whole values
    for r in ranks[1:]:
        got = r[f"train_compress{compress}"]
        assert got["metrics"] == ranks[0][f"train_compress{compress}"][
            "metrics"]


def test_global_norm_over_shards_is_the_whole_norm(ranks):
    # each rank sums its shards' squares, the hook sums them over the
    # dims that shard each leaf: float32 order noise only
    for r in ranks:
        sharded, whole = r["norm"]
        assert abs(sharded - whole) <= 1e-6 * whole, (sharded, whole)


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_reference(ranks, ref, compress):
    ocfg = RA.AdamWConfig(**R.OCFG, compress=compress)
    step = jax.jit(RSteps.make_train_step(ref["cfg"], ocfg))
    rp = jax.tree.map(jnp.asarray, ref["params"])
    rs = RA.init(rp, ocfg)
    losses = []
    for x, y in ref["batches"]:
        rp, rs, m = step(rp, rs, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(m["loss"]))
    got = ranks[0][f"train_compress{compress}"]
    for g, w in zip(got["metrics"], losses):
        assert abs(g["loss"] - w) < 1e-3, (g["loss"], w)
    want = _ref_flat(rp)
    for k, a in want.items():
        assert np.abs(got["params"][k] - a).max() < 2e-2, k


def test_decode_matches_unsharded(ranks, ref):
    cfg = R.moe_cfg()
    p = tree.params_from_numpy(ref["params"], "cpu")
    caches = S.init_cache(cfg, R.BATCH, R.CACHE_LEN, "cpu")
    decode = steps.make_decode_step(cfg)
    rdec = jax.jit(RSteps.make_decode_step(ref["cfg"]))
    rp = jax.tree.map(jnp.asarray, ref["params"])
    rc = RS.init_cache(ref["cfg"], R.BATCH, R.CACHE_LEN)
    toks = torch.from_numpy(ref["toks"])
    for t in range(2):
        pos = torch.full((R.BATCH,), t, dtype=torch.int32)
        lg, caches = decode(p, toks[:, t:t + 1], pos, caches)
        rlg, rc = rdec(rp, jnp.asarray(ref["toks"][:, t:t + 1]),
                       jnp.asarray(pos.numpy()), rc)
        for r in ranks:
            got = r["decode"]["logits"][t]
            assert got.shape == tuple(lg.shape)
            assert np.abs(got - lg.numpy()).max() <= 1e-5, t
            assert np.abs(got - np.asarray(rlg, np.float32)).max() < 2e-2
    # the caches hold their rows over data and their heads over model
    local = ranks[0]["decode"]["cache_local"]
    whole = {tree.keystr(q): tuple(c.shape)
             for q, c in tree.flatten_with_path(
                 S.init_cache(cfg, R.BATCH, R.CACHE_LEN, "meta"))}
    for k, shape in whole.items():
        assert local[k][-4] * 4 == shape[-4], k          # batch over data
        assert np.prod(local[k]) * WORLD == np.prod(shape), k


def test_train_loop_with_a_mesh(ranks):
    cfg = R.moe_cfg()
    run = trainer.TrainRun(cfg=cfg, shape=ShapeConfig("t", R.SEQ, R.BATCH,
                                                      "train"),
                           ocfg=A.AdamWConfig(**R.OCFG))
    p, _, hist = trainer.train(run, 2, device="cpu", log_every=100)
    want = _flat(p)
    for r in ranks:
        got = r["loop"]
        np.testing.assert_allclose(got["hist"], hist, rtol=0, atol=1e-5)
        _leaf_distance(got["params"], want, _flat(S.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu")), 2,
            R.OCFG["lr"], "train()")
        # the lead rank's checkpoint, gathered at step 1 and resharded on
        # restore, continues to the uninterrupted losses
        np.testing.assert_allclose(got["resumed"], got["hist"], rtol=0,
                                   atol=1e-6)
        assert got["resumed_count"] == 2


def test_serve_with_a_mesh_samples_the_unsharded_tokens(ranks):
    want = serve.serve(R.moe_cfg(), R.BATCH, 4, 3, top_k=4,
                       device="cpu")["tokens"]
    for r in ranks:
        np.testing.assert_array_equal(r["serve"], want)


def test_sharded_batch_rows(ranks):
    cfg = R.moe_cfg()
    x, y = P.host_batch(cfg, ShapeConfig("t", R.SEQ, R.BATCH, "train"), 3,
                        seed=5, device="cpu")
    for rank, r in enumerate(ranks):
        b = r["batch"]
        block = rank // 2                     # the data coordinate
        assert b["rows"] == slice(2 * block, 2 * block + 2)
        np.testing.assert_array_equal(b["x"], x[b["rows"]].numpy())
        np.testing.assert_array_equal(b["y"], y[b["rows"]].numpy())
        np.testing.assert_array_equal(b["whole_x"], x.numpy())
        np.testing.assert_array_equal(b["whole_y"], y.numpy())


def test_reshard_onto_the_survivors(ranks):
    w = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    w2 = np.arange(40.0, dtype=np.float32).reshape(5, 8)
    for rank, r in enumerate(ranks):
        m = r["remesh"]
        assert m["grid"] == {"data": 2, "model": 4}
        np.testing.assert_array_equal(m["placed_whole"], w)
        d, c = divmod(rank, 4)
        np.testing.assert_array_equal(m["placed_local"],
                                      w[4 * d:4 * d + 4, 2 * c:2 * c + 2])
        assert m["survivors"] == {"data": 5, "model": 1}
        if rank < 5:
            assert tuple(m["survivor_coord"]) == (rank, 0)
            np.testing.assert_array_equal(m["fresh_local"], w2[rank:rank + 1])
            np.testing.assert_array_equal(m["moved_local"], w2[rank:rank + 1])
            np.testing.assert_array_equal(m["fresh_whole"], w2)
            np.testing.assert_array_equal(m["moved_whole"], w2)
        else:                         # outside the new mesh: holds nothing
            assert m["survivor_coord"] is None
            assert m["fresh_local"].size == m["moved_local"].size == 0


_JAX_MAP = r"""
import json, sys
import numpy as np, jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
shape, specs = json.loads(sys.argv[1])
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
def entry(e):
    return tuple(e) if isinstance(e, list) else e
out = []
for spec in specs:
    idx = NamedSharding(mesh, P(*map(entry, spec))).devices_indices_map(
        tuple(shape))
    out.append([[list(s.indices(n))[:2] for s, n in zip(idx[d], shape)]
                for d in mesh.devices.flat])
print(json.dumps(out))
"""


def test_placements_match_jax_named_sharding(ranks):
    """DTensor's shards of each spec on a (2, 2, 2) mesh are the blocks
    ``NamedSharding(mesh, spec)`` gives the device at the same mesh
    coordinates (JAX in a subprocess with 8 host devices)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    arg = json.dumps([list(R.PLACED_SHAPE), R.PLACED_SPECS])
    out = subprocess.run([sys.executable, "-c", _JAX_MAP, arg], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    blocks = json.loads(out.stdout.strip().splitlines()[-1])
    whole = np.arange(np.prod(R.PLACED_SHAPE),
                      dtype=np.float32).reshape(R.PLACED_SHAPE)
    for rank, r in enumerate(ranks):
        assert tuple(r["cube_coord"]) == (rank // 4, rank // 2 % 2, rank % 2)
        for spec, got, per_device in zip(R.PLACED_SPECS, r["placed"], blocks):
            want = whole[tuple(slice(a, b) for a, b in per_device[rank])]
            np.testing.assert_array_equal(got, want, err_msg=str(spec))


def test_constrain_redistributes_a_dtensor(ranks):
    for r in ranks:
        c = r["constrain"]
        assert c["placements"] == c["want"] == [("Shard", 0), ("Shard", 2)]
        assert c["equal"] and c["plain_is_same"]


def test_kernels_refuse_a_dtensor(ranks):
    # a kernel launches on raw pointers: each rank hands it local values
    assert not any(r["kernel_took_dtensor"] for r in ranks)
