"""The port's sharding policy (``launch/sharding.py``), activation rules
(``models/shard.py``), mesh helpers (``launch/mesh.py``) and the
deprecated ``runtime/fault.py`` shim against the reference's, on the CPU
with no process group in this process.

Specs are compared exactly, leaf for leaf by path: ``param_specs``,
``opt_specs``, ``cache_specs`` (with and without ``seq_shard``, at a batch
the data axes divide and at a batch of 1) and ``batch_spec`` for all ten
archs at their published sizes on the meshes (2, 4), (1, 7), (16, 16) and
(2, 16, 16).  The reference's functions read only ``mesh.shape``, so a
namespace holding the axis sizes stands for its mesh, and its trees are
``jax.eval_shape``'s; the port's trees live on the meta device.
``constrain``'s choice is compared exactly for every rule name, on shapes
that divide and that do not (the reference's spec is captured from
``jax.lax.with_sharding_constraint``).  The production meshes are built
at world 256 and 512 on a fake process group in a subprocess."""
import importlib
import json
import os
import subprocess
import sys
import warnings
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro import configs as ref_configs
from repro.launch import sharding as RSh
from repro.models import shard as RShard
from repro.models import stacked as RS
from repro.optim import adamw as RA
from repro_torch import configs, tree
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.models import shard
from repro_torch.models import stacked as S
from repro_torch.optim import adamw as A
from repro_torch.runtime import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x4": {"data": 2, "model": 4}, "1x7": {"data": 1, "model": 7},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
KINDS = ("params", "opt", "cache", "cache_seq", "batch")


def _data_axes(sizes):
    return tuple(a for a in sizes if a != "model")


_abstract = {}


def _trees(arch):
    """(reference params, opt state, caches at batch 32 and 1) as shape
    structs; the port's as meta tensors."""
    if arch not in _abstract:
        rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
        rp = jax.eval_shape(lambda k: RS.init_params(rcfg, k),
                            jax.random.PRNGKey(0))
        ro = jax.eval_shape(lambda p: RA.init(p, RA.AdamWConfig(
            compress=True)), rp)
        rc = [jax.eval_shape(lambda b=b: RS.init_cache(rcfg, b, 64))
              for b in (32, 1)]
        tp = S.init_params(cfg, None, "meta")
        to = A.init(tp, A.AdamWConfig(compress=True))
        tc = [S.init_cache(cfg, b, 64, "meta") for b in (32, 1)]
        _abstract[arch] = ((rp, ro, rc), (tp, to, tc))
    return _abstract[arch]


def _same(ref_specs, port_specs, like, what):
    """Every leaf of ``like`` (the port's tree) has the reference's spec."""
    want = {jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                ref_specs, is_leaf=lambda x: isinstance(x, P))[0]}
    got = {tree.keystr(p): tree.at(port_specs, p)
           for p, _ in tree.flatten_with_path(like)}
    assert got == want, (what, {k: (got.get(k), want.get(k))
                                for k in set(got) | set(want)
                                if got.get(k) != want.get(k)})


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(configs.ARCH_IDS))
def test_specs_match_reference(arch, mesh, kind):
    sizes = MESHES[mesh]
    m = SimpleNamespace(shape=sizes)
    axes = _data_axes(sizes)
    (rp, ro, rc), (tp, to, tc) = _trees(arch)
    if kind == "params":
        _same(RSh.param_specs(m, rp), sh.param_specs(m, tp), tp, kind)
    elif kind == "opt":
        _same(RSh.opt_specs(m, ro), sh.opt_specs(m, to), to, kind)
    elif kind in ("cache", "cache_seq"):
        seq = kind == "cache_seq"
        for r, t in zip(rc, tc):
            _same(RSh.cache_specs(m, r, axes, seq_shard=seq),
                  sh.cache_specs(m, t, axes, seq_shard=seq), t, kind)
    else:
        cfg = configs.get_config(arch)
        shapes = [(32, 128), (1, 128), (24, 4096), (32,)]
        if cfg.frontend_tokens:
            shapes.append((32, cfg.frontend_tokens,
                           cfg.frontend_dim or cfg.d_model))
        for s in shapes:
            assert sh.batch_spec(m, s, axes) == \
                tuple(RSh.batch_spec(m, s, axes)), s


def test_specs_accept_a_device_mesh_like_object():
    # a DeviceMesh is read through its dim names and shape
    dm = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 4))
    assert sh.axis_sizes(dm) == {"data": 2, "model": 4}
    (_, _, _), (tp, _, _) = _trees("qwen2_moe_a2_7b")
    specs = sh.param_specs(dm, tp)
    assert tree.at(specs, ("segments", 0, "moe", "wi")) == \
        (None, "model", "data", None)
    assert tree.at(specs, ("embed", "tok")) == ("model", "data")


def _shapes(ndim):
    return [(64, 96, 32, 128)[:ndim], (3, 5, 7, 9)[:ndim],
            (64, 3, 64, 5)[:ndim], (3, 64, 5, 64)[:ndim],
            (32, 60, 16, 8)[:ndim]]


@pytest.mark.parametrize("name", sorted(RShard._RULES))
def test_constrain_picks_the_reference_spec(name, monkeypatch):
    seen = []

    def capture(x, spec):
        seen.append(tuple(spec))
        return x

    monkeypatch.setattr(jax.lax, "with_sharding_constraint", capture)
    ndim = len(RShard._RULES[name][0][0]("d", "m"))
    assert sorted(shard._RULES) == sorted(RShard._RULES)
    for sizes in list(MESHES.values()) + [None]:
        axes = _data_axes(sizes or {"data": 1, "model": 1})
        for shape in _shapes(ndim) + _shapes(ndim - 1):
            seen.clear()
            with RShard.mesh_axes(axes, "model", sizes):
                RShard.constrain(jax.numpy.zeros(shape), name)
            want = seen[0] if seen else None
            with shard.mesh_axes(axes, "model", sizes):
                assert shard.choose_spec(shape, name) == want, (sizes, shape)
                x = torch.zeros(shape)
                assert shard.constrain(x, name) is x   # plain: unchanged
    # no active axes: nothing is chosen, and the tensor comes back
    assert shard.choose_spec((4, 4, 4, 4)[:ndim], name) is None


def test_mesh_axes_nest_and_restore():
    assert shard.get_mesh_axes() == (None, None) and shard.get_mesh() is None
    with shard.mesh_axes(("data",), "model", {"data": 2, "model": 4}):
        assert shard.get_axis_sizes() == {"data": 2, "model": 4}
        with shard.mesh_axes(("pod", "data"), "model"):
            assert shard.get_mesh_axes() == (("pod", "data"), "model")
        assert shard.get_mesh_axes() == (("data",), "model")
    assert shard.get_mesh_axes() == (None, None)
    x = torch.ones(3)
    assert shard.data_mean(x) is x        # no mesh: the identity


def test_placements_map_specs_in_mesh_order():
    m = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sh.placements(m, ()) == [Replicate()] * 3
    assert sh.placements(m, (("pod", "data"), None, "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert sh.placements(m, (None, "model", "data")) == \
        [Replicate(), Shard(2), Shard(1)]
    with pytest.raises(ValueError):       # not the mesh's order
        sh.placements(m, (("data", "pod"),))
    with pytest.raises(ValueError):       # no such axis
        sh.placements(m, ("expert",))


def test_path_str_matches_reference_keys():
    rp = jax.eval_shape(
        lambda k: RS.init_params(ref_configs.get_config("zamba2_2_7b")
                                 .reduced(n_layers=4), k),
        jax.random.PRNGKey(0))
    ro = jax.eval_shape(lambda p: RA.init(p, RA.AdamWConfig()), rp)
    tp = S.init_params(configs.get_config("zamba2_2_7b").reduced(n_layers=4),
                       None, "meta")
    to = A.init(tp, A.AdamWConfig())
    for ref, port in ((rp, tp), (ro, to)):
        want = [RSh._path_str(p) for p, _ in
                jax.tree_util.tree_flatten_with_path(ref)[0]]
        got = [sh._path_str(p) for p, _ in tree.flatten_with_path(port)]
        assert got == want


def test_mesh_module_touches_no_process_group():
    import torch.distributed as dist
    assert callable(mesh_lib.make_production_mesh)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        mesh_lib.make_host_mesh()
    assert mesh_lib.data_axes(SimpleNamespace(
        mesh_dim_names=("pod", "data", "model"))) == ("pod", "data")
    assert mesh_lib.model_axis(None) == "model"


_FAKE_WORLD = r"""
import json, sys
sys.path.insert(0, "src")
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import mesh as mesh_lib
out = {}
for world, multi in ((256, False), (512, True), (8, None), (6, None)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    if multi is None:
        m = [mesh_lib.make_host_mesh(mp) for mp in (1, 4, 3, 16)]
        out[world] = [[list(x.shape), list(x.mesh_dim_names)] for x in m]
    else:
        m = mesh_lib.make_production_mesh(multi_pod=multi)
        out[world] = [list(m.shape), list(m.mesh_dim_names),
                      list(mesh_lib.data_axes(m)), mesh_lib.device_type()]
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_meshes_on_a_fake_process_group():
    out = subprocess.run([sys.executable, "-c", _FAKE_WORLD], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH="src"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["256"] == [[16, 16], ["data", "model"], ["data"], "cpu"]
    assert got["512"] == [[2, 16, 16], ["pod", "data", "model"],
                          ["pod", "data"], "cpu"]
    # the model axis halves until it divides the world
    assert got["8"] == [[[8, 1], ["data", "model"]], [[2, 4], ["data", "model"]],
                        [[8, 1], ["data", "model"]], [[1, 8], ["data", "model"]]]
    assert got["6"][1] == [[3, 2], ["data", "model"]]


def test_fault_shim_warns_and_reexports():
    sys.modules.pop("repro_torch.runtime.fault", None)
    with pytest.warns(DeprecationWarning, match="repro_torch.runtime.faults"):
        shim = importlib.import_module("repro_torch.runtime.fault")
    import repro.runtime.faults  # noqa: F401  (the reference's, no warning)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref_shim = importlib.import_module("repro.runtime.fault")
    assert sorted(shim.__all__) == sorted(ref_shim.__all__)
    for name in shim.__all__:
        assert getattr(shim, name) is getattr(faults, name), name


def test_device_grid_keeps_its_old_name():
    assert faults.DeviceMesh is faults.DeviceGrid
    grid = faults.elastic_remesh(["cpu"] * 6, 4)
    assert isinstance(grid, faults.DeviceGrid)
    assert grid.shape == {"data": 3, "model": 2}
    assert np.all(grid.devices == torch.device("cpu"))
