"""The port's roofline (``launch/roofline.py``) against the reference's
``repro.launch.roofline``, and its counter against hand reckonings.

``Roofline``'s derived properties equal the reference's for equal fields
(``model_flops_util`` scaled by the ratio of the two peaks, the H100's
989e12 against the TPU v5e's 197e12).  ``count`` is held to 2*M*K*N a
product (``mm``, ``bmm`` and their float32-output ``.dtype`` forms, which
run on fake tensors here as the card runs them for real), to hand-summed
input and output bytes with views left out, and to ``FlopCounterMode``
on a program it covers.  DTensor products and collectives are counted on
a fake 256-rank group in a subprocess: no process group starts in a test
worker."""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import roofline as RR
from repro_torch.launch import roofline as rl
from repro_torch.models import layers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIELDS = [
    dict(compute_s=0.1, memory_s=0.2, collective_s=0.05,
         flops_per_device=1, bytes_per_device=1, coll_bytes_per_device=1,
         chips=256, model_flops=1e12, useful_ratio=0.5),
    dict(compute_s=0.3, memory_s=0.2, collective_s=0.05,
         flops_per_device=3e13, bytes_per_device=7e11,
         coll_bytes_per_device=2e10, chips=512, model_flops=4e18,
         useful_ratio=0.04),
    dict(compute_s=0.01, memory_s=0.02, collective_s=0.5,
         flops_per_device=2.5e12, bytes_per_device=6e10,
         coll_bytes_per_device=2e11, chips=1, model_flops=2e12,
         useful_ratio=0.8),
    dict(compute_s=0.0, memory_s=0.0, collective_s=0.0,
         flops_per_device=0, bytes_per_device=0, coll_bytes_per_device=0,
         chips=16, model_flops=0, useful_ratio=0.0),
]


@pytest.mark.parametrize("fields", FIELDS, ids=range(len(FIELDS)))
def test_roofline_properties_match_reference(fields):
    port, ref = rl.Roofline(**fields), RR.Roofline(**fields)
    assert port.bottleneck == ref.bottleneck
    assert port.step_time_s == ref.step_time_s
    assert port.roofline_fraction == ref.roofline_fraction
    assert port.model_flops_util == pytest.approx(
        ref.model_flops_util * RR.PEAK_FLOPS / rl.PEAK_FLOPS, rel=1e-12)
    pd, rd = port.to_dict(), ref.to_dict()
    assert list(pd) == list(rd)
    assert {k: v for k, v in pd.items() if k != "model_flops_util"} == \
        {k: v for k, v in rd.items() if k != "model_flops_util"}


def test_h100_constants():
    assert rl.PEAK_FLOPS == 989e12
    assert rl.HBM_BW == 3.35e12
    assert rl.LINK_BW == 450e9


def test_analyze_matches_reference_formulas():
    flops, byts = 3.7e14, 9.1e11
    hlo = "  %ag = bf16[1024,4096]{1,0} all-gather(bf16[64,4096]{1,0} %x)\n"
    coll = RR.parse_collectives(hlo)
    compiled = SimpleNamespace(
        cost_analysis=lambda: {"flops": flops, "bytes accessed": byts},
        as_text=lambda: hlo)
    ref = RR.analyze(compiled, 256, 5e16, hlo_text=hlo)
    counts = rl.Counts(flops=flops, bytes_accessed=byts, collectives=coll,
                       op_bytes={}, op_calls={})
    port = rl.analyze(counts, 256, 5e16)
    assert port.compute_s == pytest.approx(
        ref.compute_s * RR.PEAK_FLOPS / rl.PEAK_FLOPS, rel=1e-12)
    assert port.memory_s == pytest.approx(
        ref.memory_s * RR.HBM_BW / rl.HBM_BW, rel=1e-12)
    assert port.collective_s == pytest.approx(
        ref.collective_s * RR.ICI_BW / rl.LINK_BW, rel=1e-12)
    for k in ("flops_per_device", "bytes_per_device",
              "coll_bytes_per_device", "chips", "model_flops",
              "useful_ratio"):
        assert getattr(port, k) == getattr(ref, k), k


def _nb(*shapes_dtypes):
    return sum(torch.Size(s).numel() * torch.empty((), dtype=d).element_size()
               for s, d in shapes_dtypes)


def test_count_products_and_bytes_by_hand():
    """An mm (bf16), a bmm (float32) and a transpose (a view): 2*M*K*N
    each, bytes in + out of the two products only."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 128, generator=g).to(torch.bfloat16)
    b = torch.randn(32, 128, generator=g).to(torch.bfloat16)
    x = torch.randn(3, 16, 8, generator=g)
    y = torch.randn(3, 8, 4, generator=g)
    c = rl.count(lambda: (a @ b.t(), torch.bmm(x, y)))
    assert c.flops == 2 * 64 * 128 * 32 + 2 * 3 * 16 * 8 * 4
    bf, f = torch.bfloat16, torch.float32
    assert c.bytes_accessed == _nb(((64, 128), bf), ((128, 32), bf),
                                   ((64, 32), bf), ((3, 16, 8), f),
                                   ((3, 8, 4), f), ((3, 16, 4), f))
    assert c.op_calls == {"aten.mm": 1, "aten.bmm": 1}
    assert torch.equal(c.result[0], a @ b.t())
    assert rl.op_byte_profile(c) == [
        ("aten.mm", _nb(((64, 32), bf)), 1),
        ("aten.bmm", _nb(((3, 16, 4), f)), 1)]
    assert rl.op_byte_profile(c, top=1) == rl.op_byte_profile(c)[:1]
    with FlopCounterMode(display=False) as fc:
        a @ b.t()
        torch.bmm(x, y)
    assert c.flops == fc.get_total_flops()


def test_count_leaves_out_views_and_allocations():
    """A batched-by-2-D product folds into one ``mm`` and an
    ``_unsafe_view`` of its result (a view whose schema does not say so);
    ``empty`` writes nothing.  Only the product's bytes count."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 16, 32, generator=g)
    w = torch.randn(32, 8, generator=g)
    c = rl.count(lambda: (x @ w, torch.empty(1000)))
    assert c.flops == 2 * 64 * 32 * 8
    assert c.bytes_accessed == 4 * (64 * 32 + 32 * 8 + 64 * 8)
    assert set(c.op_calls) == {"aten.mm"}


def test_count_float32_output_products():
    """``mm(..., out_dtype=float32)`` and ``bmm(..., out_dtype=float32)``:
    2*M*K*N each, bf16 operands in and float32 out (the registry's bmm
    formula rejects the dtype argument)."""
    with FakeTensorMode():
        a = torch.empty(64, 128, dtype=torch.bfloat16)
        b = torch.empty(128, 32, dtype=torch.bfloat16)
        p = torch.empty(2, 64, 128, dtype=torch.bfloat16)
        q = torch.empty(2, 128, 32, dtype=torch.bfloat16)
        c = rl.count(lambda: (torch.mm(a, b, out_dtype=torch.float32),
                              torch.bmm(p, q, out_dtype=torch.float32)))
    assert c.flops == 2 * 64 * 128 * 32 * 3
    bf, f = torch.bfloat16, torch.float32
    assert c.bytes_accessed == _nb(((64, 128), bf), ((128, 32), bf),
                                   ((64, 32), f), ((2, 64, 128), bf),
                                   ((2, 128, 32), bf), ((2, 64, 32), f))
    assert c.result[0].dtype == f and c.result[1].dtype == f


def test_card_form_counts_the_cards_product():
    """On host tensors ``matmul_f32`` widens bfloat16 to float32 (two
    copies, a float32 product); under ``card_form`` it takes the card's
    one float32-output product: the same FLOPs, the card's bytes."""
    with FakeTensorMode():
        a = torch.empty(4, 16, 64, dtype=torch.bfloat16)
        w = torch.empty(64, 256, dtype=torch.bfloat16)
        host = rl.count(layers.matmul_f32, a, w)
        with layers.card_form():
            card = rl.count(layers.matmul_f32, a, w)
    assert host.flops == card.flops == 2 * 64 * 64 * 256
    assert "aten._to_copy" in host.op_calls
    assert card.op_calls == {"aten.mm": 1}
    bf, f = torch.bfloat16, torch.float32
    assert card.bytes_accessed == _nb(((64, 64), bf), ((64, 256), bf),
                                      ((64, 256), f))
    assert card.result.shape == (4, 16, 256) and card.result.dtype == f


def test_collective_dict_has_the_references_shape():
    c = rl.count(lambda: None)
    ref = RR.parse_collectives("")
    assert c.collectives == ref
    assert rl.COLLECTIVES == tuple(ref["bytes"])


_FAKE_256 = r"""
import json, sys
sys.path.insert(0, "src")
import torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import roofline as rl
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
out = {}

def put(name, c):
    out[name] = {"flops": c.flops, "bytes": c.bytes_accessed,
                 "coll": c.collectives,
                 "local": [list(t.to_local().shape) for t in
                           (c.result if isinstance(c.result, tuple)
                            else (c.result,)) if hasattr(t, "to_local")]}

with FakeTensorMode():
    x = torch.empty(64, 2048, dtype=torch.bfloat16)
    w = torch.empty(2048, 8192, dtype=torch.bfloat16)
    place = lambda t, p: distribute_tensor(t, mesh, p, src_data_rank=None)
    R = Replicate()
    # rows over data, columns over model: each rank (4, 2048) @ (2048, 512)
    xd, wd = place(x, [Shard(0), R]), place(w, [R, Shard(1)])
    for i in range(2):      # the second call hits DTensor's sharding cache
        put(f"rows_cols_{i}", rl.count(lambda: xd @ wd))
    # the contraction over model: (64, 128) @ (128, 8192), a partial sum
    put("contraction", rl.count(lambda: place(x, [R, Shard(1)])
                                @ place(w, [R, Shard(0)])))
    # replicated everywhere: every rank computes the whole product
    put("replicated", rl.count(lambda: place(x, [R, R]) @ place(w, [R, R])))
    # full_tensor() of a (Shard(0), Shard(1)) leaf: two all-gathers
    ws = place(w, [Shard(0), Shard(1)])
    put("full_tensor", rl.count(lambda: ws.full_tensor()))
    # in place over the data axis, as shard_reduce / data_mean issue it
    t = torch.empty(1000, dtype=torch.float32)
    put("all_reduce", rl.count(
        lambda: dist.all_reduce(t, group=mesh.get_group("data"))))
    # a DTensor to a plain product through full_tensor(): what the sharded
    # train step does with every weight
    put("gather_then_mm", rl.count(lambda: x @ ws.full_tensor()))
print(json.dumps(out))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def fake256():
    out = subprocess.run([sys.executable, "-c", _FAKE_256], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH="src"),
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _coll(**kw):
    b = dict.fromkeys(rl.COLLECTIVES, 0)
    n = dict.fromkeys(rl.COLLECTIVES, 0)
    for name, (nbytes, calls) in kw.items():
        b[name.replace("_", "-")] = nbytes
        n[name.replace("_", "-")] = calls
    return {"bytes": b, "counts": n, "total_bytes": sum(b.values())}


@pytest.mark.parametrize("i", [0, 1])
def test_dtensor_product_counted_by_its_local_shard(fake256, i):
    got = fake256[f"rows_cols_{i}"]
    assert got["flops"] == 2 * 4 * 2048 * 512
    assert got["local"] == [[4, 512]]
    assert got["bytes"] == 2 * (4 * 2048 + 2048 * 512 + 4 * 512)
    assert got["coll"] == _coll()


def test_dtensor_contraction_and_replicated_products(fake256):
    assert fake256["contraction"]["flops"] == 2 * 64 * 128 * 8192
    assert fake256["contraction"]["local"] == [[64, 8192]]
    assert fake256["replicated"]["flops"] == 2 * 64 * 2048 * 8192


def test_full_tensor_and_in_place_all_reduce(fake256):
    # each all-gather outputs the gathered axis's blocks: (16 * 128, 512)
    # over model or (16 * 128, 8192) after it, 2 and 32 MiB in bf16
    got = fake256["full_tensor"]
    assert got["coll"] == _coll(all_gather=(2 * (2048 * 512 + 2048 * 8192),
                                            2))
    assert got["flops"] == 0
    assert fake256["all_reduce"]["coll"] == _coll(all_reduce=(4000, 1))
    both = fake256["gather_then_mm"]
    assert both["flops"] == 2 * 64 * 2048 * 8192
    assert both["coll"] == got["coll"]
