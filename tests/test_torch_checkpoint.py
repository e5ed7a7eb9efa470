"""The port's checkpoints (``repro_torch.checkpoint.manager``) on the CPU:
the reference's ``TestCheckpoint`` cases (``tests/test_substrate.py``)
ported (the round trip with bfloat16, keep-last-k, a corrupt step skipped,
the async save), the on-disk format shared with ``repro.checkpoint``
(either package restores the other's checkpoint, key for key and bit for
bit), and a training state carried across: a state the reference's
``train()`` wrote after 2 steps restores into the port's ``train()``,
whose next 2 losses equal the reference's uninterrupted steps 3-4 within
rtol 1e-5, and the reverse; the port's own resume is bit-equal to an
uninterrupted run."""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import manager as RM
from repro.kernels import backend as ref_backend
from repro.launch import train as RT
from repro.models.config import ShapeConfig as RShape
from repro.optim import adamw as RA
from repro_torch import configs, tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import train as TT
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw as A


@pytest.fixture(autouse=True, scope="module")
def _reference_topk_plain():
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PALLAS", "jnp")
    ref_backend.reset()
    yield
    mp.undo()
    ref_backend.reset()


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}


def _like(t):
    return tree.map_with_path(lambda _, x: torch.zeros_like(x), t)


# ---------------------------------------------------------------------------
# The reference's TestCheckpoint cases.
# ---------------------------------------------------------------------------


def test_save_restore_roundtrip_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    mgr.save(1, t)
    mgr.save(5, tree.map_with_path(lambda _, x: x * 2, t))
    like = _like(t)
    restored, step = mgr.restore(like)
    assert step == 5 and restored is like           # written in place
    assert torch.equal(restored["a"], t["a"] * 2)
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], t["b"]["c"] * 2)
    restored, step = mgr.restore(_like(t), step=1)
    assert step == 1 and torch.equal(restored["a"], t["a"])


def test_keep_last_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, {"x": torch.zeros(3)})
    assert mgr.all_steps() == [3, 4]


def test_dead_writers_tmp_dirs_are_collected(tmp_path):
    dead = tmp_path / "step_000000009.tmp-999999999-1"
    dead.mkdir()
    live = tmp_path / f"step_000000008.tmp-{os.getpid()}-1"
    live.mkdir()
    CheckpointManager(str(tmp_path)).save(1, {"x": torch.zeros(3)})
    assert not dead.exists() and live.exists()


def test_corrupted_checkpoint_skipped(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    t = {"x": torch.arange(4.0)}
    mgr.save(1, t)
    mgr.save(2, {"x": t["x"] + 1})
    with open(os.path.join(str(tmp_path), "step_000000002", "arrays.npz"),
              "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 32)
    restored, step = mgr.restore({"x": torch.zeros(4)})
    assert step == 1
    assert torch.equal(restored["x"], torch.arange(4.0))


def test_mismatched_tree_is_not_loaded(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.arange(4.0)})
    like = {"x": torch.zeros(2, 4)}
    with pytest.raises(FileNotFoundError):
        mgr.restore(like)
    assert torch.equal(like["x"], torch.zeros(2, 4))   # untouched


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = {"x": torch.ones(128, 128)}
    mgr.save_async(7, t)
    t["x"].add_(1)                  # the caller goes on changing it
    mgr.wait()
    assert mgr.latest_step() == 7
    restored, _ = mgr.restore({"x": torch.zeros(128, 128)})
    assert torch.equal(restored["x"], torch.ones(128, 128))


def test_async_save_failure_surfaces_on_wait(tmp_path, monkeypatch):
    from repro_torch.checkpoint import manager

    def full_disk(path, leaves):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(manager, "_write_npz", full_disk)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"x": torch.ones(3)})
    with pytest.raises(OSError, match="No space"):
        mgr.wait()
    mgr.wait()                      # raised once
    assert mgr.all_steps() == []


# ---------------------------------------------------------------------------
# One format for both packages.
# ---------------------------------------------------------------------------


def _state_tree(seed):
    """(params, OptState) the reference's way: bfloat16 and float32
    leaves, float32 moments, an int32 count, no residual."""
    rng = np.random.default_rng(seed)
    params = {"embed": {"tok": rng.standard_normal((5, 4)).astype(np.float32)},
              "segments": [{"w": rng.standard_normal((2, 4, 3))}]}
    rp = {"embed": {"tok": jnp.asarray(params["embed"]["tok"], jnp.bfloat16)},
          "segments": [{"w": jnp.asarray(params["segments"][0]["w"],
                                         jnp.float32)}]}
    rs = RA.OptState(jax.tree.map(lambda a: a.astype(jnp.float32) * 0.5, rp),
                     jax.tree.map(lambda a: a.astype(jnp.float32) ** 2, rp),
                     None, jnp.asarray(7, jnp.int32))
    return rp, rs


def _port_like(rp):
    """Zeros of the port's state of the reference's params: bfloat16 and
    float32 leaves, float32 moments."""
    tp = _like(tree.params_from_numpy(rp, "cpu"))
    return tp, A.init(tp, A.AdamWConfig())


def test_port_restores_a_reference_checkpoint(tmp_path):
    rp, rs = _state_tree(0)
    RM.CheckpointManager(str(tmp_path)).save(3, (rp, rs))
    like = _port_like(rp)
    (tp, ts), step = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 3
    want = jax.tree_util.tree_flatten_with_path((rp, rs))[0]
    got = tree.flatten_with_path((tp, ts))
    assert [tree.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (_, t), (_, a) in zip(got, want):
        if t.dtype == torch.bfloat16:
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_reference_restores_a_port_checkpoint(tmp_path):
    rp, rs = _state_tree(1)
    tp = tree.params_from_numpy(rp, "cpu")
    ts = A.OptState(tree.params_from_numpy(rs.m, "cpu"),
                    tree.params_from_numpy(rs.v, "cpu"), None,
                    torch.tensor(7, dtype=torch.int32))
    CheckpointManager(str(tmp_path)).save(4, (tp, ts))
    zero = jax.tree.map(jnp.zeros_like, (rp, rs))
    (gp, gs), step = RM.CheckpointManager(str(tmp_path)).restore(zero)
    assert step == 4 and int(gs.count) == 7
    for a, b in zip(jax.tree.leaves((gp, gs)), jax.tree.leaves((rp, rs))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    # byte for byte the reference's own npz: same keys, same hash
    with np.load(str(tmp_path / "step_000000004" / "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.load(open(tmp_path / "step_000000004" / "manifest.json"))
    assert manifest["sha256"] == RM._sha(arrays)
    assert sorted(arrays) == sorted(RM._flatten((rp, rs)))


# ---------------------------------------------------------------------------
# A training state across packages, through train().
# ---------------------------------------------------------------------------

ARCH, LAYERS = "qwen2_moe_a2_7b", 2
OCFG = dict(lr=1e-2, warmup_steps=1)


def _runs(ckpt_dir, ckpt_every=2):
    rcfg = ref_configs.get_config(ARCH).reduced(n_layers=LAYERS)
    cfg = configs.get_config(ARCH).reduced(n_layers=LAYERS)
    return (RT.TrainRun(cfg=rcfg, shape=RShape("t", 16, 4, "train"),
                        ocfg=RA.AdamWConfig(**OCFG), ckpt_dir=ckpt_dir,
                        ckpt_every=ckpt_every),
            TT.TrainRun(cfg=cfg, shape=ShapeConfig("t", 16, 4, "train"),
                        ocfg=A.AdamWConfig(**OCFG), ckpt_dir=ckpt_dir,
                        ckpt_every=ckpt_every))


def _branch(src, dst, keep_step):
    """A copy of checkpoint dir ``src`` holding only ``keep_step``."""
    shutil.copytree(src, dst)
    for name in os.listdir(dst):
        if name != f"step_{keep_step:09d}":
            shutil.rmtree(os.path.join(dst, name))
    return str(dst)


def test_reference_state_continues_in_the_port(tmp_path):
    # the reference's train() saves step 2 (and would race its own async
    # and final saves of one step if both fell on the last step, so the
    # uninterrupted run is a second run from the same seed)
    rrun, _ = _runs(None)
    _, _, hist = RT.train(rrun, 4, log_every=100)
    rrun, _ = _runs(str(tmp_path / "ref"), ckpt_every=100)
    _, _, head = RT.train(rrun, 2, log_every=100)
    assert head == hist[:2]
    _, trun = _runs(str(tmp_path / "ref"))
    _, state, got = TT.train(trun, 2, device="cpu", log_every=100)
    assert int(state.count) == 4
    np.testing.assert_allclose(got, hist[2:], rtol=1e-5)


def test_port_state_continues_in_the_reference(tmp_path):
    _, trun = _runs(str(tmp_path / "port"))
    _, _, hist = TT.train(trun, 4, device="cpu", log_every=100)
    # no checkpoint on the reference's last step: its async and final
    # saves of one step race each other (as above)
    rrun, _ = _runs(_branch(tmp_path / "port", tmp_path / "ref", 2),
                    ckpt_every=100)
    _, state, got = RT.train(rrun, 2, log_every=100)
    assert int(state.count) == 4
    np.testing.assert_allclose(got, hist[2:], rtol=1e-5)


def test_port_resume_is_bit_equal(tmp_path):
    _, trun = _runs(str(tmp_path / "a"))
    params, state, hist = TT.train(trun, 4, device="cpu", log_every=100)
    assert CheckpointManager(trun.ckpt_dir).all_steps() == [2, 4]
    _, again = _runs(_branch(tmp_path / "a", tmp_path / "b", 2))
    p2, s2, tail = TT.train(again, 2, device="cpu", log_every=100)
    assert tail == hist[2:]
    for (_, a), (_, b) in zip(tree.flatten_with_path((params, state)),
                              tree.flatten_with_path((p2, s2))):
        assert torch.equal(a, b)
    # the resumed run committed its own step 4, once
    assert CheckpointManager(again.ckpt_dir).all_steps() == [2, 4]
