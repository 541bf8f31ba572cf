# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Test doubles with production semantics, the port's copy.

Copy of ``container_engine_accelerators_tpu/testing``'s ``kubeapi``, a
conformant-subset Kubernetes API server (stdlib only), so the port's
hermetic drills (``fleet/linksim.py``'s reactor phase) run without the
JAX package.
"""
