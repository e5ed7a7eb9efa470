"""Static-analysis suite of the PyTorch/CUDA port
(``python -m repro_torch.analysis``), the counterpart of the reference's
``repro.analysis``: the same ``Finding`` / suppression format, CLI and
exit codes, over the port's tree, registry and CUDA sources.

* **determinism lint** (DET3xx): unseeded ``random`` / ``np.random``,
  wall-clock ``time.time()`` in measured or retry paths, unsorted registry
  iteration, and (DET305) torch's global generator — a sampler without
  ``generator=`` or a reseed of the global state; anything that would make
  ``SortResult`` cycles / quality or sampled tokens non-reproducible per
  seed.
* **engine contracts** (CON4xx): every ``@register`` site of
  :mod:`repro_torch.sort.registry` cross-checked against ``EngineSpec``,
  the README's port engine table and ``tests/test_torch_sort.py``;
  ``resilient:<engine>`` literals must name a registered base engine.
* **CUDA-kernel lint** (CUD2xx, in the reference's PAL2xx place): static
  and opt-in shared memory, the opt-in call, the thread limit of a block,
  the launch status read after every launch, runtime calls in kernel
  bodies, and the wrappers' plain-version dispatch.  The limits are the
  H100's (sm_90a), in one place in :mod:`.cuda_lint`.

The reference's tracer-safety family (TRC1xx) has no counterpart: the
port runs eagerly, with no ``jit`` trace in which a Python branch on a
value could concretize.  The nearest check is the trace gate's own:
under ``FakeTensorMode`` a host branch on data raises
``DataDependentOutputException``, caught at run time, and the case runs
for real instead.

Suppression: a trailing ``# lint: disable=RULE[,RULE]`` comment silences a
line (``// lint: disable=...`` in a ``.cu`` file); ``# lint:
disable-file=RULE[,RULE]`` anywhere silences a whole file.  ``--fix``
rewrites the mechanically-safe findings (``time.time()`` ->
``time.monotonic()``).

:mod:`repro_torch.analysis.trace_gate` runs every registered engine's core
and every kernel entry over a (fmt x N x k x B) grid: on the CPU under
``FakeTensorMode`` (or for real where a host loop reads data), on the card
with every kernel launched.
"""
from repro_torch.analysis.core import (Finding, analyze_paths,
                                       format_findings, iter_python_files)

__all__ = ["Finding", "analyze_paths", "format_findings",
           "iter_python_files"]
