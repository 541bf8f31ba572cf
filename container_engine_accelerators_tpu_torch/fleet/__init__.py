# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Fleet serving tier, port: only :mod:`.tenants` (tenant classes,
weighted queue shares and token-rate quotas at the engine's admission),
a copy of the JAX package's module. The router, the autoscaler and the
fleet simulator are not ported yet (ROADMAP.md)."""
