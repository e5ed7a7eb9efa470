"""The port's tensor-parallel compute on 8 gloo ranks on the CPU, a (2, 4)
data x model mesh (``make_host_mesh(model_parallel=4)``): each rank
gathers a layer's leaves over the data axis only, when the layer runs, and
computes its own heads, FFN columns, experts and vocabulary block.  The
ranks start once for the module (``_torch_ranks.tp8``) and run every case
of ``_torch_ranks.TP_CASES``: a model axis of 4 that divides the heads
(olmo-1b), does not divide the KV heads (qwen3-14b with 2, so their
``head_dim`` is sharded), leaves 6 query heads uneven (blocks of 2, the
last rank none), divides the experts (8) and does not (6: the FFN-width
fallback), and covers MLA with its MoE (deepseek-v2), the SSD (mamba2 with
4 heads), zamba2's shared block and cross-attention (llama-3.2-vision,
the tanh gates opened to 0.5).  Every case starts from the reference's
weights (reduced configs, float32) and the same batch (8, 16).

Tolerances, ``test_torch_sharded_exec.py``'s own.  Against the port's
unsharded step (one step, remat full, AdamW lr 1e-3 with one warm-up
step): loss, nll and aux within 1e-5; every parameter by the leaf-distance
rule (the distance to the unsharded parameters within 1e-3 of the distance
they moved, every element within lr).  Two decode steps: within 1e-5 of
the unsharded decode.  Against the reference's GSPMD-partitioned jitted
step on the same (2, 4) mesh (JAX in a subprocess with 8 host devices, as
``tests/test_launch.py`` runs it): 1e-3 on the loss, 2e-2 on the
parameters.  FLOPs (``roofline.count``) are exact integers."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro import configs as ref_configs
from repro.kernels import backend as ref_backend
from repro.models import stacked as RS
from repro_torch import tree
from repro_torch.data import pipeline as P
from repro_torch.launch import steps
from repro_torch.models import stacked as S
from repro_torch.optim import adamw as A

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, MODEL = 8, 4
CASES = list(R.TP_CASES)


def _ref_cfg(name):
    arch, over, layers, _ = R.TP_CASES[name]
    return dataclasses.replace(
        ref_configs.get_config(arch).reduced(n_layers=layers), **over)


def _open_gates(params):
    """The cross-attention gates at 0.5 (0 at init adds nothing)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.full_like(a, 0.5)
        if jax.tree_util.keystr(path).endswith("['gate']") else a, params)


@pytest.fixture(scope="module")
def ref():
    """Each case's reference weights, batch, decode tokens and frontend
    (numpy)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PALLAS", "jnp")   # interpret-mode Pallas has no JVP
    ref_backend.reset()
    out = {}
    for name in CASES:
        rcfg = _ref_cfg(name)
        rng = np.random.default_rng(0)
        fe = None
        if rcfg.frontend_tokens:
            fe = rng.standard_normal(
                (R.BATCH, rcfg.frontend_tokens,
                 rcfg.frontend_dim or rcfg.d_model)).astype(np.float32)
        out[name] = {
            "params": _open_gates(jax.tree.map(
                np.asarray, RS.init_params(rcfg, jax.random.PRNGKey(0)))),
            "batch": P.TokenSource(rcfg.vocab, 0).batch(0, 0, R.BATCH,
                                                        R.SEQ),
            "toks": rng.integers(0, rcfg.vocab,
                                 (R.BATCH, 2)).astype(np.int32),
            "frontend": fe}
    yield out
    mp.undo()
    ref_backend.reset()


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    return R.spawn("tp8", WORLD, tmp_path_factory.mktemp("tp8"), ref)


def _flat(params):
    return {tree.keystr(p): t.float().numpy()
            for p, t in tree.flatten_with_path(params)}


def _ref_flat(params):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_flatten_with_path(params)[0]}


def _frontend(case):
    fe = case["frontend"]
    return () if fe is None else (torch.from_numpy(fe),)


def test_mesh_is_data_by_model(ranks):
    for rank, r in enumerate(ranks):
        assert r["mesh"] == ((2, MODEL), ("data", "model"))
        assert r["coord"] == divmod(rank, MODEL)
    # the pod axis's gradients travel too
    assert ranks[0]["olmo_pod"]["collectives"]["all-reduce"] > \
        ranks[0]["olmo"]["collectives"]["all-reduce"]


@pytest.mark.parametrize("name", CASES + ["olmo_pod"])
def test_tp_train_step_matches_unsharded(ranks, ref, name):
    """``olmo_pod``: olmo's case on a (2, 2, 2) pod x data x model mesh,
    where the pod axis splits the batch but not the parameters (their
    gradients are averaged over it)."""
    case = ref[name.removesuffix("_pod")]
    cfg = R.tp_cfg(name.removesuffix("_pod"))
    ocfg = A.AdamWConfig(**R.OCFG)
    p = tree.params_from_numpy(case["params"], "cpu")
    x, y = (torch.from_numpy(a) for a in case["batch"])
    p, _, m = steps.make_train_step(cfg, ocfg)(p, A.init(p, ocfg), x, y,
                                               *_frontend(case))
    for r in ranks:
        got = r[name]["metrics"]
        for k in ("loss", "nll", "aux"):
            assert abs(got[k] - float(m[k])) <= 1e-5, (k, got[k], m[k])
    init, want = _ref_flat(case["params"]), _flat(p)
    got = ranks[0][name]["params"]
    for k, a in want.items():
        moved = np.linalg.norm(a - init[k])
        assert np.linalg.norm(got[k] - a) <= 1e-3 * moved, k
        assert np.abs(got[k] - a).max(initial=0.0) <= R.OCFG["lr"], k


@pytest.mark.parametrize(
    "name", CASES + ["olmo_pod"] + [f"{n}_seq" for n in R.SEQ_SHARD_CASES])
def test_tp_decode_matches_unsharded(ranks, ref, name):
    """``_seq``: against caches whose sequence the model axis shards
    (``cache_specs(seq_shard=True)``), gathered for each step."""
    base = name.removesuffix("_pod").removesuffix("_seq")
    case = ref[base]
    cfg = R.tp_cfg(base)
    p = tree.params_from_numpy(case["params"], "cpu")
    caches = S.init_cache(cfg, R.BATCH, R.CACHE_LEN, "cpu")
    decode = steps.make_decode_step(cfg, with_frontend=True)
    toks = torch.from_numpy(case["toks"])
    for t in range(2):
        pos = torch.full((R.BATCH,), t, dtype=torch.int32)
        lg, caches = decode(p, toks[:, t:t + 1], pos, caches,
                            *_frontend(case))
        for r in ranks:
            got = r[name]["decode"][t]
            assert got.shape == tuple(lg.shape)
            assert np.abs(got - lg.numpy()).max() <= 1e-5, (name, t)


@pytest.mark.parametrize("name", [n for n in CASES if R.TP_CASES[n][3]])
def test_model_axis_splits_the_work(ranks, name):
    """Each rank's counted FLOPs (every product of the step, forward,
    backward and remat) against the unsharded step on its own rows: a
    quarter where the model axis divides the heads; with 6 heads, blocks
    of 2 heads (a third of the attention) and 0 on the last rank, the
    ranks' FLOPs summing to the unsharded step's: no product is repeated
    along the model axis."""
    plain = ranks[0][name]["plain_flops"]
    for data in range(WORLD // MODEL):
        row = ranks[data * MODEL:(data + 1) * MODEL]
        assert all(r[name]["plain_flops"] == plain for r in row)
        flops = [r[name]["flops"] for r in row]
        assert sum(flops) == plain, (flops, plain)
        if name == "olmo":
            assert flops == [plain / MODEL] * MODEL
        else:
            assert max(flops) < plain / 3 and min(flops) < max(flops)
        # the model-axis collectives are counted
        assert row[0][name]["collectives"]["all-to-all"] > 0


def test_collectives_counted_by_site(ranks):
    """``roofline.count`` tallies each collective's bytes by the model code
    that issued it.  olmo's step (remat full): the leaves' data-axis
    gathers in the layer bodies, the row-parallel sums, and one re-lay, the
    GLU's ``[gate | up]`` columns, whose all-to-all runs in the forward
    and in the remat recompute, and once back in the backward."""
    for r in ranks:
        sites = r["olmo"]["sites"]
        assert sites["all-gather stacked.py:body"] > 0
        assert sites["all-reduce layers.py:apply_attn"] > 0
        assert sites["all-reduce layers.py:apply_mlp"] > 0
        relays = {k: v for k, v in sites.items()
                  if k.startswith("all-to-all")}
        assert set(relays) == {"all-to-all layers.py:mlp_partial",
                               "all-to-all steps.py:_value_and_grad"}
        assert relays["all-to-all layers.py:mlp_partial"] == \
            2 * relays["all-to-all steps.py:_value_and_grad"]


_GSPMD = r"""
import dataclasses, json, sys
sys.path.insert(0, "src")
import numpy as np, jax, jax.numpy as jnp
from repro import compat, configs
from repro.launch import sharding as sh, steps as steps_lib
from repro.models import shard, stacked
from repro.optim import adamw
cases, folder = json.loads(sys.argv[1]), sys.argv[2]
mesh = compat.make_mesh((2, 4), ("data", "model"))
ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
for name, (arch, over, layers) in cases.items():
    cfg = dataclasses.replace(configs.get_config(arch).reduced(
        n_layers=layers), **over)
    data = np.load(f"{folder}/{name}.npz")
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        stacked.init_params(cfg, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(data["p" + jax.tree_util.keystr(k)]) for k, _ in flat])
    opt = adamw.init(params, ocfg)
    batch = [jnp.asarray(data[k]) for k in ("x", "y", "fe") if k in data]
    wf = "fe" in data
    step = steps_lib.make_train_step(cfg, ocfg, with_frontend=wf)
    ps, os_ = sh.param_specs(mesh, params), sh.opt_specs(mesh, opt)
    rows = [sh.named(mesh, sh.batch_spec(mesh, b.shape, ("data",)))
            for b in batch]
    with mesh, shard.mesh_axes(("data",), "model"):
        p, _, m = jax.jit(step, in_shardings=(
            sh.named(mesh, ps), sh.named(mesh, os_), *rows),
            out_shardings=(sh.named(mesh, ps), sh.named(mesh, os_), None))(
            params, opt, *batch)
    np.savez(f"{folder}/{name}.out.npz", loss=np.float32(m["loss"]), **{
        "p" + jax.tree_util.keystr(k): np.asarray(a, np.float32)
        for k, a in jax.tree_util.tree_flatten_with_path(p)[0]})
print("OK")
"""


@pytest.fixture(scope="module")
def gspmd(ref, tmp_path_factory):
    """The reference's jitted train step of every case, partitioned by
    GSPMD over a (2, 4) mesh of 8 host devices, in one subprocess."""
    folder = tmp_path_factory.mktemp("gspmd")
    for name in CASES:
        case = ref[name]
        arrays = {"x": case["batch"][0], "y": case["batch"][1],
                  **{"p" + k: a for k, a in _ref_flat(case["params"]).items()}}
        if case["frontend"] is not None:
            arrays["fe"] = case["frontend"]
        np.savez(folder / f"{name}.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_PALLAS="jnp",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    arg = json.dumps({n: R.TP_CASES[n][:3] for n in CASES})
    out = subprocess.run([sys.executable, "-c", _GSPMD, arg, str(folder)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return {n: dict(np.load(folder / f"{n}.out.npz")) for n in CASES}


@pytest.mark.parametrize("name", CASES)
def test_tp_train_step_matches_gspmd(ranks, gspmd, name):
    want = gspmd[name]
    got = ranks[0][name]
    assert abs(got["metrics"]["loss"] - float(want["loss"])) < 1e-3
    for k, a in got["params"].items():
        assert np.abs(a - want["p" + k]).max() < 2e-2, k
