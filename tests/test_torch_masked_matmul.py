"""The port's pruned matmul (``repro_torch.kernels.masked_matmul``): the
NaN rule of its mask against the reference kernel
(``repro.kernels.masked_matmul.pruned_matmul``, the Pallas kernel in
interpret mode), and the shape rule by which the wrapper picks the CUDA
kernel's form.  The wgmma form multiplies the pruned rows of w by 0 where
the reference multiplies the pruned lanes of x: ``(x * keep) @ w`` and
``x @ (keep * w)`` are NaN in the same places, which these cells pin on
the plain version and ``chip_smoke.py`` and the ``cuda`` tests on the
card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import masked_matmul as jmm
from repro_torch.kernels import masked_matmul


def _case(where, seed):
    """x (6, 16), w (16, 5), a keep mask, and a NaN or an infinity in a
    pruned lane of x or a pruned row of w."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    w = rng.standard_normal((16, 5)).astype(np.float32)
    keep = rng.random(16) > 0.3
    keep[[2, 9]] = False
    if where == "x-nan":
        x[1, 2] = np.nan
    elif where == "x-inf":
        x[4, 9] = -np.inf
    elif where == "w-nan":
        w[2, 3] = np.nan
    else:
        w[9, 0] = np.inf
    return x, w, keep


@pytest.mark.parametrize("where", ["x-nan", "x-inf", "w-nan", "w-inf"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_non_finite_pruned_lane_gives_nan_as_the_reference(where, dtype):
    x, w, keep = _case(where, seed=len(where))
    tx = torch.from_numpy(x).to(dtype)
    tw = torch.from_numpy(w).to(dtype)
    got = masked_matmul.pruned_matmul(tx, tw, torch.from_numpy(keep))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jmm.pruned_matmul(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                             jnp.asarray(keep), interpret=True)
    nan = np.isnan(np.asarray(want, np.float32))
    np.testing.assert_array_equal(torch.isnan(got.float()).numpy(), nan)
    # a whole row of y (x's lane) or a whole column (w's row)
    assert nan.sum() in (5, 6)
    # the same cells through x @ (keep * w), the wgmma form's order
    order = torch.from_numpy(x).double() @ (
        torch.from_numpy(keep).double()[:, None]
        * torch.from_numpy(w).double())
    np.testing.assert_array_equal(torch.isnan(order).numpy(), nan)


def _bf16(shape, offset=0):
    """A bfloat16 tensor of ``shape`` whose data starts ``offset`` elements
    into a fresh allocation."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(shape)


@pytest.mark.parametrize("xs,ws,offset,form", [
    ((4, 64), (64, 8), 0, "wgmma"),
    ((1, 72), (72, 264), 0, "wgmma"),
    ((130, 2056), (2056, 120), 0, "wgmma"),
    ((4, 257), (257, 120), 0, "wmma"),         # K not a multiple of 8
    ((4, 64), (64, 12), 0, "wmma"),            # N not a multiple of 8
    ((4, 0), (0, 16), 0, "wmma"),              # K = 0: no tensor map
    ((4, 64), (64, 8), 1, "wmma"),             # x not 16-byte aligned
], ids=["one-step", "one-row", "ragged", "k257", "n12", "k0", "misaligned"])
def test_matmul_form_by_shape(xs, ws, offset, form):
    assert masked_matmul.form_for(_bf16(xs, offset), _bf16(ws)) == form


def test_float32_takes_the_ffma_form():
    assert masked_matmul.form_for(torch.zeros(4, 64),
                                  torch.zeros(64, 8)) == "ffma"


def test_cpu_tensors_launch_nothing():
    launches = masked_matmul.LAUNCHES
    forms = dict(masked_matmul.FORM_LAUNCHES)
    masked_matmul.pruned_matmul(_bf16((4, 64)), _bf16((64, 8)),
                                torch.ones(64, dtype=torch.bool))
    assert masked_matmul.LAUNCHES == launches
    assert masked_matmul.FORM_LAUNCHES == forms
