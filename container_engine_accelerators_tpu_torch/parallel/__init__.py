# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Parallel layers of the port: the mixture-of-experts FFN (``moe``, on
one device), the multi-process bootstrap from the stack's env contract
(``bootstrap``), device meshes over its ranks (``mesh``), ring attention
over a sequence-parallel axis on the flash kernels (``ring_attention``),
the data-parallel step (``data_parallel``) and pipeline parallelism
(``pipeline``: the 1F1B training schedule and the GPipe forward over
point-to-point transfers). The JAX package's collective-matmul module
and expert parallelism are not ported yet (ROADMAP.md)."""
