"""On a mesh of one rank (a gloo group of world 1, ``make_host_mesh()``:
(1, 1)) every collective is the identity, so the port's sharded paths
equal its unsharded ones bit for bit, in one process: the sharded train
step (2 steps, with and without int8 compression: metrics, parameters,
``m`` and ``v``), two sharded decode steps (logits), ``train(mesh=...)``
(losses and parameters, and a checkpoint's resume) and ``serve(mesh=...)``
(tokens).  qwen2-moe reduced with 8 experts, batch (8, 16); the rank runs
once for the module (``_torch_ranks.mesh1``)."""
import numpy as np
import pytest

import _torch_ranks as R


@pytest.fixture(scope="module")
def rank(tmp_path_factory):
    return R.spawn("mesh1", 1, tmp_path_factory.mktemp("mesh1"))[0]


def _equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def test_mesh_of_one(rank):
    assert rank["mesh"] == (1, 1)


@pytest.mark.parametrize("compress", [False, True])
def test_sharded_step_is_the_unsharded_step(rank, compress):
    got, want = rank[f"sharded_compress{compress}"], \
        rank[f"plain_compress{compress}"]
    assert got["metrics"] == want["metrics"]
    for part in ("params", "m", "v"):
        _equal(got[part], want[part], part)


def test_sharded_decode_is_the_unsharded_decode(rank):
    for got, want in zip(rank["sharded_decode"]["logits"],
                         rank["plain_decode"]):
        np.testing.assert_array_equal(got, want)


def test_train_with_a_mesh_is_train(rank):
    got, want = rank["sharded_loop"], rank["plain_loop"]
    assert got["hist"] == want["hist"]
    _equal(got["params"], want["params"], "params")
    assert got["resumed"] == want["hist"]
    assert got["resumed_count"] == 2


def test_serve_with_a_mesh_is_serve(rank):
    np.testing.assert_array_equal(rank["sharded_serve"], rank["plain_serve"])
