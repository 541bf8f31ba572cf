# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Parallel layers of the port: the mixture-of-experts FFN (``moe``), on
one device. The JAX package's mesh, ring attention, pipeline and
collective-matmul modules are not ported yet (ROADMAP.md)."""
