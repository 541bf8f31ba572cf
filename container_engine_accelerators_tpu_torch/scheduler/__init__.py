# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Gang placement for the fleet's scale-out, port: a subset of the JAX
package's ``scheduler`` (whose gang scheduler daemon and its passes need
no copy: they are jax-free control plane).

  * :mod:`.gang` — the placement closure the autoscaler's ``GangPlacer``
    runs (``node_info``, ``pod_info``, ``find_gate``,
    ``place_gang_on_slice``);
  * :mod:`.incremental` — the cached cluster view and sub-mesh
    inventory, a copy, on which the replica lifecycle's live-cluster
    placer runs;
  * :mod:`.k8s` — the thin Kubernetes REST client, a copy, through which
    the replica lifecycle and the autoscaler CLI act.

``GATE_PREFIX`` is JAX's ``scheduler.GATE_PREFIX``; ``RESOURCE_NAME`` is
the device plugin's extended resource (JAX ``deviceplugin.RESOURCE_NAME``).
"""

GATE_PREFIX = "gke.io/topology-aware-auto-"
RESOURCE_NAME = "google.com/tpu"
