# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Fault injection and the serving reaction, port (see plan.py and
reactor.py).

Copy of ``container_engine_accelerators_tpu/faults/__init__.py``:
``from container_engine_accelerators_tpu_torch import faults`` is the
hook surface the port's engine uses: ``faults.tick(site)`` /
``faults.fire(site)`` are free no-ops until a :class:`FaultPlan` is
armed. The port's armed plan is its own, independent of the JAX
package's."""

from container_engine_accelerators_tpu_torch.faults.plan import (  # noqa: F401
    FAULT_KINDS,
    CollectiveTimeoutFault,
    FaultPlan,
    FaultSpec,
    HostVanishFault,
    InjectedFault,
    PreemptionFault,
    WedgedChipFault,
    active,
    arm,
    arm_from_flag,
    disarm,
    fire,
    tick,
)
