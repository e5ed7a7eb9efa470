"""The port's autotune table (``repro_torch.kernels.autotune``): keys by
device, the one-candidate sweep on the host, save / load round trips, the
nearest-cell lookup, the committed table and the serving dispatcher's wall
prior read from it.  On the CPU the sweep times the fused engine's plain
version; the kernel's own rows come from a card run."""
import json

import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune, backend
from repro_torch.serving import dispatch

CPU = "cpu"
CARD = "NVIDIA H100 80GB HBM3/sm_90"


def _table():
    return {
        f"float|N1024|m1|B64|{CARD}": {"us": 640.0, "sweep": []},
        f"float|N256|m8|B64|{CARD}": {"us": 5120.0, "sweep": []},
        "float|N1024|m1|B64|cpu": {"unroll": 2, "us": 9.0, "sweep": []},
        "float|N256|m32|B64|cpu": {"unroll": 4, "us": 9.0, "sweep": []},
        "unsigned|N4096|m1|B16|cpu": {"unroll": 8, "us": 9.0, "sweep": []},
        "broken|key|cpu": {"unroll": 16, "us": 9.0},
    }


def test_keys_end_in_the_device():
    assert autotune.device_tag(CPU) == "cpu"
    assert autotune.cell_key("float", 1024, 1, 64, CPU) == \
        "float|N1024|m1|B64|cpu"
    assert autotune.cell_key("unsigned", 256, 32, 64, torch.device(CPU)) \
        == "unsigned|N256|m32|B64|cpu"


def test_keys_name_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.cell_key("float", 1024, 1, 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda dev=None: (9, 0))
    assert autotune.cell_key("float", 1024, 1, 64) == \
        f"float|N1024|m1|B64|{CARD}"


def test_one_empty_candidate():
    for b in (1, 16, 64):
        assert autotune.candidate_params(b) == [{}]
    assert autotune.DEFAULT_PARAMS == {}


@pytest.mark.parametrize("fmt,width", [("unsigned", 16), ("twos", 8),
                                       ("signmag", 12), ("float", 16)])
def test_measure_cell_on_the_host(fmt, width):
    row = autotune.measure_cell(fmt=fmt, width=width, n=32, m=2, b=2,
                                reps=2, device=CPU)
    assert set(row) == {"us", "sweep"} and row["us"] > 0
    assert row["sweep"] == [{"us": row["us"]}]


def test_sweep_keys_its_cells():
    cells = [dict(fmt="unsigned", width=16, n=32, m=1, b=2),
             dict(fmt="float", width=16, n=16, m=16, b=1, k=3)]
    table = autotune.sweep(cells, reps=1, device=CPU)
    assert sorted(table) == ["float|N16|m16|B1|cpu",
                             "unsigned|N32|m1|B2|cpu"]
    assert all(row["us"] > 0 for row in table.values())


def test_save_load_round_trip(tmp_path):
    path = tmp_path / "t.json"
    autotune.save_table(_table(), path)
    doc = json.loads(path.read_text())
    assert doc["env"] == backend.env_stamp() and doc["autotune"] == _table()
    assert autotune.load_table(path) == _table()
    # a bare table (no "autotune" key) loads as it is
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps(_table()))
    assert autotune.load_table(bare) == _table()


def test_default_table_is_cached_on_mtime(tmp_path, monkeypatch):
    import os
    path = tmp_path / "BENCH.json"
    monkeypatch.setattr(autotune, "BENCH_ARTIFACT", str(path))
    monkeypatch.setattr(autotune, "_DEFAULT_CACHE", {})
    assert autotune.default_table() == {}
    autotune.save_table(_table(), path)
    assert autotune.default_table() == _table()
    path.write_text("not json")
    os.utime(path, ns=(1, 1))
    assert autotune.default_table() == {}


@pytest.mark.parametrize("cell,want", [
    (("float", 1024, 1, 64), "float|N1024|m1|B64|cpu"),      # exact
    (("float", 1024, 2, 64), "float|N1024|m1|B64|cpu"),      # nearest
    (("float", 256, 16, 32), "float|N256|m32|B64|cpu"),
    (("unsigned", 16, 1, 1), "unsigned|N4096|m1|B16|cpu"),
    (("twos", 1024, 1, 64), None),                            # no such fmt
])
def test_nearest_cell(cell, want):
    assert autotune.nearest_cell(*cell, device=CPU, table=_table()) == want


def test_nearest_cell_keeps_to_its_device(monkeypatch):
    monkeypatch.setattr(autotune, "device_tag", lambda device=None: CARD)
    assert autotune.nearest_cell("float", 512, 4, 64, table=_table()) == \
        f"float|N256|m8|B64|{CARD}"
    assert autotune.nearest_cell("unsigned", 512, 4, 64,
                                 table=_table()) is None


def test_best_params():
    t = _table()
    assert autotune.best_params("float", 1024, 1, 64, device=CPU,
                                table=t) == {"unroll": 2}
    assert autotune.best_params("float", 300, 30, 60, device=CPU,
                                table=t) == {"unroll": 4}
    assert autotune.best_params("twos", 8, 1, 1, device=CPU, table=t) == {}
    assert autotune.best_params("float", 1024, 1, 64, device=CPU,
                                table={}) == autotune.DEFAULT_PARAMS


def test_committed_table_is_a_card_run():
    doc = json.loads((autotune.Path(autotune.__file__).resolve().parents[3]
                      / autotune.BENCH_ARTIFACT).read_text())
    env, table = doc["env"], doc["autotune"]
    tag = f"{env['device_name']}/{env['capability']}"
    assert env["device_name"] and env["power_limit"]
    assert len(table) == 6
    for key, row in table.items():
        fmt, n, m, b, dev = key.split("|")
        assert dev == tag and fmt == "unsigned"
        assert row["us"] > 0 and row["sweep"] == [{"us": row["us"]}]
    assert sorted((k.split("|")[1], k.split("|")[2]) for k in table) == \
        sorted([("N1024", "m1"), ("N1024", "m2"), ("N256", "m1"),
                ("N256", "m8"), ("N256", "m32"), ("N4096", "m1")])


def test_dispatcher_prior_reads_the_table(monkeypatch):
    monkeypatch.setattr(autotune, "default_table", _table)
    # cpu rows: 9 us over m * B = 64, 2048 and 16 instance-emissions;
    # the median of the three per-emission times
    assert dispatch._fused_tns_wall_prior(CPU) == float(
        np.median([9.0 / 64, 9.0 / 2048, 9.0 / 16]))
    monkeypatch.setattr(autotune, "device_tag", lambda device=None: CARD)
    assert dispatch._fused_tns_wall_prior() == float(
        np.median([640.0 / 64, 5120.0 / 512]))
    monkeypatch.setattr(autotune, "device_tag", lambda device=None: "x/sm_1")
    assert dispatch._fused_tns_wall_prior() is None


def test_committed_table_gives_the_card_a_prior(monkeypatch):
    # no host rows: on the CPU the generic throughput prior stands
    assert dispatch._fused_tns_wall_prior(CPU) is None
    table = autotune.default_table()
    tag = next(iter(table)).split("|")[-1]
    monkeypatch.setattr(autotune, "device_tag", lambda device=None: tag)
    per_emission = sorted(row["us"] / (int(k.split("|")[2][1:])
                                       * int(k.split("|")[3][1:]))
                          for k, row in table.items())
    assert dispatch._fused_tns_wall_prior() == per_emission[3]
    # above the generic throughput prior: a wall-class request's first
    # pick goes to fused-topk, not fused-tns
    assert per_emission[3] > dispatch._WALL_PRIOR_US["throughput"]
