"""The port's training driver (``repro_torch.launch.train``: ``train()``
and the CLI) against the reference's ``repro.launch.train`` on the CPU:
both start from one initial state (the reference's ``train()`` writes it
as step 0 and each package resumes from a copy), and the losses of 6
steps at the CLI's reduced size agree within rtol 1e-5; a failing forward
and backward is retried without the update applied twice; the CLI commits
a checkpoint and refuses to run without a card unless asked for the
host."""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.kernels import backend as ref_backend
from repro.launch import train as RT
from repro.models.config import ShapeConfig as RShape
from repro.optim import adamw as RA
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import steps
from repro_torch.launch import train as TT
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw as A

# the CLI's reduced size: --layers 2 --d-model 64 --vocab 256, batch 4,
# seq 16, its lr and warm-up
CLI = ["--steps", "6", "--layers", "2", "--d-model", "64", "--vocab", "256",
       "--batch", "4", "--seq", "16"]


@pytest.fixture(autouse=True, scope="module")
def _reference_topk_plain():
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PALLAS", "jnp")
    ref_backend.reset()
    yield
    mp.undo()
    ref_backend.reset()


def _ref_run(arch, ckpt_dir, **kw):
    cfg = ref_configs.get_config(arch).reduced(n_layers=2, d_model=64,
                                               vocab=256)
    return RT.TrainRun(cfg=cfg, shape=RShape("cli", 16, 4, "train"),
                       ocfg=RA.AdamWConfig(), ckpt_dir=ckpt_dir, **kw)


@pytest.mark.parametrize("arch", ["olmo_1b", "qwen2_moe_a2_7b"])
def test_cli_losses_match_reference_train(arch, tmp_path):
    RT.train(_ref_run(arch, str(tmp_path / "init")), 0)    # the step-0 state
    shutil.copytree(tmp_path / "init", tmp_path / "port")
    _, _, want = RT.train(_ref_run(arch, str(tmp_path / "init")), 6,
                          log_every=100)
    got = TT.main(["--arch", arch, "--device", "cpu", *CLI,
                   "--ckpt-dir", str(tmp_path / "port")])
    assert len(got) == 6 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the CLI committed its last step, restorable
    assert CheckpointManager(str(tmp_path / "port")).latest_step() == 6


def test_train_from_scratch_is_deterministic(tmp_path):
    cfg = configs.get_config("qwen2_moe_a2_7b").reduced(n_layers=2)
    run = TT.TrainRun(cfg=cfg, shape=ShapeConfig("t", 16, 4, "train"),
                      ocfg=A.AdamWConfig(lr=1e-2, warmup_steps=1),
                      remat="full", accum=2)
    seen = []
    _, s1, h1 = TT.train(run, 3, device="cpu",
                         on_step=lambda step, m: seen.append(step))
    _, s2, h2 = TT.train(run, 3, device="cpu")
    assert h1 == h2 and seen == [0, 1, 2] and int(s1.count) == 3
    assert h1[-1] < h1[0]


def test_a_failed_backward_is_retried_and_the_update_applied_once(
        monkeypatch):
    cfg = configs.get_config("olmo_1b").reduced(n_layers=2)
    run = TT.TrainRun(cfg=cfg, shape=ShapeConfig("t", 8, 2, "train"),
                      ocfg=A.AdamWConfig(lr=1e-2, warmup_steps=1))
    _, _, want = TT.train(run, 2, device="cpu")
    calls = {"grads": 0}
    real = steps.TrainStep.grads

    def flaky(self, *a, **kw):
        calls["grads"] += 1
        if calls["grads"] == 2:           # the second step's first try
            raise RuntimeError("transient")
        return real(self, *a, **kw)

    monkeypatch.setattr(steps.TrainStep, "grads", flaky)
    monkeypatch.setattr(TT.faults.time, "sleep", lambda s: None)
    _, state, got = TT.train(run, 2, device="cpu")
    assert calls["grads"] == 3 and int(state.count) == 2
    assert got == want


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = configs.get_config("olmo_1b").reduced(n_layers=2)
    run = TT.TrainRun(cfg=cfg, shape=ShapeConfig("t", 8, 2, "train"),
                      ocfg=A.AdamWConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.train(run, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.main(["--arch", "olmo_1b", *CLI])


def test_cli_flags_and_run_fields_match_reference():
    import inspect
    import re
    flags = lambda f: re.findall(r'add_argument\("(--[a-z-]+)"',
                                 inspect.getsource(f))
    assert flags(TT.main) == flags(RT.main) + ["--device"]
    assert [f.name for f in dataclasses.fields(TT.TrainRun)] == \
        [f.name for f in dataclasses.fields(RT.TrainRun)]
