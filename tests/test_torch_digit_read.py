"""The port's digit read (``repro_torch.kernels.digit_read.min_search``)
against the kernel it replaces, ``repro.kernels.digit_read.min_search``
(the Pallas kernel, in interpret mode), on seeded planes that hold bytes
outside {0, 1}; and the shape rule by which the wrapper picks the CUDA
kernel's form.  On the CPU the wrapper runs the plain version
(``kernels/ref.py::min_search_ref``); the CUDA kernel is held against it on
the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import digit_read as jdr
from repro_torch.kernels import digit_read


def _planes(shape, seed):
    """0/1 planes with a fifth of the bytes set to 2 or 255."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 2, shape).astype(np.uint8)
    odd = rng.random(shape)
    planes[odd < 0.1] = 2
    planes[odd > 0.9] = 255
    return planes


def _both(planes, ascending):
    mask, drs = digit_read.min_search(torch.from_numpy(planes), ascending)
    jmask, jdrs = jdr.min_search(jnp.asarray(planes), ascending=ascending,
                                 interpret=True)
    return (mask.numpy(), drs.numpy()), (np.asarray(jmask), np.asarray(jdrs))


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("shape", [(1, 2, 4), (3, 8, 5), (2, 16, 130),
                                   (4, 1, 33), (2, 32, 40)])
def test_min_search_matches_reference_kernel_on_bytes_2_and_255(ascending,
                                                                shape):
    planes = _planes(shape, seed=sum(shape) + ascending)
    planes[0, :, :3] = planes[0, :, 3:4]            # ties at the edge
    (mask, drs), (jmask, jdrs) = _both(planes, ascending)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(drs, jdrs)


@pytest.mark.parametrize("ascending,survivors", [
    (True, [False, True, False, False]),
    (False, [False, True, True, False])])
def test_min_search_survivors_follow_the_walk(ascending, survivors):
    # planes [[0, 2, 1, 0], [1, 0, 0, 1]]: the walk's survivor set, not the
    # planes read as numbers (which would give lanes 0 and 3 ascending,
    # lane 1 alone descending)
    planes = np.array([[[0, 2, 1, 0], [1, 0, 0, 1]]], np.uint8)
    (mask, drs), (jmask, jdrs) = _both(planes, ascending)
    assert mask[0].tolist() == survivors == jmask[0].tolist()
    assert drs.tolist() == jdrs.tolist()


@pytest.mark.parametrize("ascending", [True, False])
def test_min_search_on_binary_planes_marks_the_extremes(ascending):
    # on 0/1 planes the survivors are every element attaining the min (the
    # max descending), ties included
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 64, (5, 70))
    keys[1] = keys[1, 0]
    planes = ((keys[:, None, :] >> np.arange(5, -1, -1)[None, :, None]) & 1
              ).astype(np.uint8)
    mask, _ = digit_read.min_search(torch.from_numpy(planes), ascending)
    target = (keys.min if ascending else keys.max)(axis=1, keepdims=True)
    np.testing.assert_array_equal(mask.numpy(), keys == target)


@pytest.mark.parametrize("w,n,form", [
    (16, 1, "warp"), (16, 1024, "warp"), (32, 2048, "warp"),
    (16, 2049, "block"), (33, 64, "block"), (1, 65536, "block")])
def test_form_by_shape(w, n, form):
    assert digit_read.form_for(w, n) == form


def test_cpu_tensors_launch_nothing():
    planes = torch.from_numpy(_planes((2, 4, 9), seed=1))
    launches = digit_read.LAUNCHES
    forms = dict(digit_read.FORM_LAUNCHES)
    digit_read.min_search(planes)
    assert digit_read.LAUNCHES == launches
    assert digit_read.FORM_LAUNCHES == forms
