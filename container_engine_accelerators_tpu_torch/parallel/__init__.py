# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Parallel layers of the port: the mixture-of-experts FFN (``moe``, on
one device), the multi-process bootstrap from the stack's env contract
(``bootstrap``), device meshes over its ranks (``mesh``), ring attention
over a sequence-parallel axis on the flash kernels (``ring_attention``)
and the data-parallel step (``data_parallel``). The JAX package's
pipeline and collective-matmul modules, and expert parallelism, are not
ported yet (ROADMAP.md)."""
