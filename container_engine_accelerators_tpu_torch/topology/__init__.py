# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""TPU slice / ICI topology model and placement search, port: copies of
the JAX package's ``topology/labels.py`` and ``topology/slice.py``, and
the sub-mesh search of ``topology/placement.py`` (a subset), which the
fleet's gang placement runs (``scheduler/gang.py``)."""

from container_engine_accelerators_tpu_torch.topology.slice import (  # noqa: F401
    GENERATIONS,
    SliceSpec,
    TpuGeneration,
    parse_accelerator_type,
)
