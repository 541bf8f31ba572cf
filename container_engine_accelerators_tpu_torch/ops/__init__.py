# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Attention ops: hand-written CUDA kernels and their plain PyTorch
versions. Kernels are built on first use (ops/_ext.py), never at import."""
