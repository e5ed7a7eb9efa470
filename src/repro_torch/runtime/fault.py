"""Deprecated alias: the fault-tolerance runtime lives in
:mod:`repro_torch.runtime.faults`, which owns both halves of the fault
story (device-fault injection and the recovery runtime).  This shim
re-exports the old names and will be removed in a future release."""
from __future__ import annotations

import warnings

from repro_torch.runtime.faults import (Heartbeat, StragglerMonitor,
                                        best_mesh_shape, elastic_remesh,
                                        reshard_state, run_step_with_retries)

__all__ = ["Heartbeat", "StragglerMonitor", "best_mesh_shape",
           "elastic_remesh", "reshard_state", "run_step_with_retries"]

warnings.warn(
    "repro_torch.runtime.fault is deprecated; import from "
    "repro_torch.runtime.faults instead (the modules were consolidated)",
    DeprecationWarning, stacklevel=2)
