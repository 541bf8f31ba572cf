# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Helpers shared by the port's command-line entry points: profiling
and checkpointing."""
