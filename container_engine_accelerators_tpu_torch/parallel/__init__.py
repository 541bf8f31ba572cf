# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Parallel layers of the port: the mixture-of-experts FFN and its
expert-parallel form (``moe``), the multi-process bootstrap from the
stack's env contract (``bootstrap``), device meshes over its ranks
(``mesh``), ring attention over a sequence-parallel axis on the flash
kernels (``ring_attention``), the data-parallel step
(``data_parallel``), pipeline parallelism (``pipeline``: the 1F1B
training schedule and the GPipe forward over point-to-point transfers),
the ring collective matmuls of tensor parallelism (``overlap``) and the
tensor- and expert-parallel collectives, shard layouts and gradient
groups (``tensor_parallel``)."""
