"""The port's dry run (``launch/dryrun.py``) against the reference's
``repro.launch.dryrun``.

The pure functions (``shapes_for``, ``SkipCell``, ``_accum_for``,
``_ssm_chunk_fix``, ``input_specs``) and the record's parameter counts
equal the reference's for all ten archs and all four shapes.  Cells run in
subprocesses, each on a fake process group of 256 ranks (no process group
starts in a test worker): the olmo-1b ``decode_32k`` cell through the CLI,
with exactly the reference record's keys, and a reduced dense train cell
at (16, 16) whose FLOPs a rank are reckoned by hand.

Importing the reference's module sets ``XLA_FLAGS`` to 512 host devices
for its own process; the fixture restores the variable at once, before
any JAX backend starts, so this worker and its subprocesses keep theirs.
"""
import json
import os
import subprocess
import sys

import pytest

from repro import configs as ref_configs
from repro.models import accounting as ref_accounting
from repro.models import config as ref_config
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.models import accounting
from repro_torch.models.config import ALL_SHAPES, shapes_for

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [s.name for s in ALL_SHAPES]
# the record of repro/launch/dryrun.py:run_cell
REF_KEYS = ["arch", "shape", "mesh", "kind", "chips", "compile_s",
            "params_total", "params_active", "memory", "collectives",
            "roofline", "unroll", "depth", "remat", "tag"]
REF_MEMORY = ["argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
              "peak_est_bytes"]


@pytest.fixture(scope="module")
def ref():
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def _shape(shapes, name):
    return {s.name: s for s in shapes}[name]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_shapes_and_skipped_cells_match(ref, arch):
    rcfg = ref_configs.get_config(arch)
    assert [s.name for s in shapes_for(configs.get_config(arch))] == \
        [s.name for s in ref_config.shapes_for(rcfg)]
    for name in SHAPES:
        if name == "long_500k" and not rcfg.sub_quadratic:
            # the reference skips before it reads the mesh
            with pytest.raises(ref.SkipCell) as want:
                ref.build_cell(arch, name, None)
            with pytest.raises(dryrun.SkipCell) as got:
                dryrun.cell_config(arch, name)
            assert str(got.value) == str(want.value)
        else:
            cfg, shape = dryrun.cell_config(arch, name)
            assert shape.name == name


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_accum_and_ssm_chunk_match(ref, arch):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    for name in SHAPES:
        s = _shape(ALL_SHAPES, name)
        rs = _shape(ref_config.ALL_SHAPES, name)
        assert dryrun._accum_for(cfg, s) == ref._accum_for(rcfg, rs), name
        assert dryrun._ssm_chunk_fix(cfg, s).ssm_chunk == \
            ref._ssm_chunk_fix(rcfg, rs).ssm_chunk, name


class _AxisNames:
    axis_names = ("data", "model")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_match(ref, arch):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    for name in SHAPES:
        got = dryrun.input_specs(cfg, _shape(ALL_SHAPES, name))
        want = ref.input_specs(rcfg, _shape(ref_config.ALL_SHAPES, name),
                               _AxisNames())
        assert list(got) == list(want), name
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (name, k)
            assert str(t.dtype).removeprefix("torch.") == \
                str(want[k].dtype), (name, k)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_counts_match(arch):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    assert accounting.param_count(cfg) == ref_accounting.param_count(rcfg)
    assert accounting.active_param_count(cfg) == \
        ref_accounting.active_param_count(rcfg)


def test_cell_config_overrides():
    cfg, shape = dryrun.cell_config("qwen2_moe_a2_7b", "train_4k",
                                    router_impl="lax", attn_impl="chunked",
                                    depth=3)
    assert (cfg.router_impl, cfg.attn_impl, cfg.n_layers) == \
        ("lax", "chunked", 3)
    cfg, _ = dryrun.cell_config("mamba2_1_3b", "long_500k", depth=5)
    assert cfg.n_layers == 5 and cfg.layer_pattern == \
        ref_configs.get_config("mamba2_1_3b").layer_pattern[:5]


def _run(args, timeout=240):
    out = subprocess.run([sys.executable, *args], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH="src"),
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_dryrun_cell_subprocess_smallest(tmp_path):
    """The olmo-1b decode_32k cell through the CLI on a fake 256-rank
    group: the reference's record, keys for keys."""
    stdout = _run(["-m", "repro_torch.launch.dryrun", "--arch", "olmo_1b",
                   "--shape", "decode_32k", "--out", str(tmp_path),
                   "--unroll"])
    assert "bottleneck=" in stdout
    assert "FAIL" not in stdout
    rec = json.loads((tmp_path / "olmo_1b__decode_32k__16x16.json")
                     .read_text())
    assert list(rec) == REF_KEYS
    assert list(rec["memory"]) == REF_MEMORY
    assert list(rec["roofline"]) == list(rl.Roofline(
        *[0.0] * 6, 1, 0.0, 0.0).to_dict())
    assert list(rec["collectives"]) == ["bytes", "counts", "total_bytes"]
    assert (rec["chips"], rec["mesh"], rec["kind"], rec["unroll"]) == \
        (256, "16x16", "decode", True)
    cfg = configs.get_config("olmo_1b")
    assert rec["params_total"] == accounting.param_count(cfg)
    m = rec["memory"]
    assert m["peak_est_bytes"] == (m["argument_bytes"] + m["temp_bytes"]
                                   + m["output_bytes"] - m["alias_bytes"])
    # the caches (2 x 16 layers of (128, 32768, 16, 128) bf16) over 16
    # data ranks and 16 heads a model rank are the donated arguments
    assert m["alias_bytes"] == 2 * 16 * 128 * 32768 * 16 * 128 * 2 // 256
    roof = rec["roofline"]
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert roof["flops_per_device"] > 0 and roof["useful_ratio"] > 0


_TRAIN_CELL = r"""
import json, sys
sys.path.insert(0, "src")
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch import configs
from repro_torch.launch import dryrun, mesh as mesh_lib
from repro_torch.models.config import ShapeConfig
out = {}
with dryrun.fake_group(256):
    mesh = mesh_lib.make_production_mesh()
    cfg = configs.get_config("olmo_1b").reduced(n_layers=2, d_model=64,
                                                vocab=256)
    for remat in ("none", "full"):
        with FakeTensorMode():
            cell = dryrun.make_cell(cfg, ShapeConfig("t", 32, 32, "train"),
                                    mesh, remat=remat, accum=1)
            counts, mem = dryrun.measure(cell)
        out[remat] = {"flops": counts.flops, "mem": mem,
                      "coll": counts.collectives["counts"],
                      "params": dryrun.local_bytes(cell.args[0]),
                      "opt": dryrun.local_bytes(cell.args[1])}
print(json.dumps(out))
"""


def test_dense_train_cell_flops_by_hand():
    """olmo-1b reduced (2 layers, d 64, 4 heads of 16, ff 256, vocab 256,
    float32) at batch 32 x seq 32 on (16, 16): rank 0 computes its 2 rows
    tensor-parallel over the 16-wide model axis.  Its share: the first
    of the ceil(4 / 16) = 1-head blocks of the query heads (ranks 4-15
    hold none), one column of each KV head's head_dim (4 KV heads do not
    divide 16: ``act_kv_heads`` falls back to head_dim, gathered for the
    scores), its head's scores and values, ``wo``'s rows of its head, 16
    of the 256 FFN columns and 16 of the 256 vocabulary columns.  Forward
    and backward are three forwards (each product's two gradients).
    Remat full recomputes each layer in the backward up to the last tensor
    the backward saved: all but the MLP's output product
    (``torch.utils.checkpoint`` stops early).  The head is outside the
    remat."""
    got = json.loads(_run(["-c", _TRAIN_CELL]).strip().splitlines()[-1])
    b, S, d, H, hd, ff, V, L, tp = 2, 32, 64, 4, 16, 256, 256, 2, 16
    T = b * S
    mlp_out = 2 * T * (ff // tp) * d
    layer = (2 * T * d * hd                                   # q: one head
             + 2 * 2 * T * d * (H * hd // tp)                 # k, v columns
             + 2 * 2 * b * S * S * hd                         # scores, pv
             + 2 * T * hd * d                                 # o: its rows
             + 2 * T * d * 2 * (ff // tp) + mlp_out)          # GLU MLP
    head = 2 * T * d * (V // tp)
    assert got["none"]["flops"] == 3 * (L * layer + head)
    assert got["full"]["flops"] == \
        3 * (L * layer + head) + L * (layer - mlp_out)
    cfg = configs.get_config("olmo_1b").reduced(n_layers=2, d_model=64,
                                                vocab=256)
    n = accounting.param_count(cfg)
    for r in got.values():
        mem = r["mem"]
        # every leaf divides 16 x 16 but the norms, which replicate
        assert r["params"] < 4 * n // 16
        assert r["opt"] == 2 * r["params"] + 4      # m, v and the count
        assert mem["argument_bytes"] == r["params"] + r["opt"] + 2 * T * 4
        assert mem["alias_bytes"] == r["params"] + r["opt"]
        # a layer's leaves are gathered over the data axis only, with
        # their model-axis shard: never the whole params
        assert mem["temp_bytes"] < 4 * n
        coll = r["coll"]
        assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
        assert coll["reduce-scatter"] > 0 and coll["all-to-all"] > 0
