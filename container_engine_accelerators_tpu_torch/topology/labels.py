# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Node label vocabulary for TPU slice topology.

The reference labels nodes with datacenter topology parsed from GCE metadata
``physical_host`` (label-nodes-daemon.py:26-57:
cloud.google.com/gce-topology-{block,subblock,host}). TPU locality is
two-level: the DCN level keeps those same labels, and the ICI level adds the
slice identity + host coordinate labels below.

Copy of ``container_engine_accelerators_tpu/topology/labels.py``.
"""

# ICI-level labels (ours).
SLICE_LABEL = "tpu-topology.gke.io/slice"
ACCELERATOR_TYPE_LABEL = "tpu-topology.gke.io/accelerator-type"
WORKER_ID_LABEL = "tpu-topology.gke.io/worker-id"
HOST_COORDS_LABEL = "tpu-topology.gke.io/host-coords"

# DCN-level labels (same vocabulary as the reference).
BLOCK_LABEL = "cloud.google.com/gce-topology-block"
SUBBLOCK_LABEL = "cloud.google.com/gce-topology-subblock"
HOST_LABEL = "cloud.google.com/gce-topology-host"

DCN_LEVELS = (BLOCK_LABEL, SUBBLOCK_LABEL, HOST_LABEL)


def format_coords(coords):
    return "-".join(str(c) for c in coords)


def parse_coords(value):
    return tuple(int(c) for c in value.split("-"))


def ici_labels(slice_name, accelerator_type, worker_id, host_coords):
    return {
        SLICE_LABEL: slice_name,
        ACCELERATOR_TYPE_LABEL: accelerator_type,
        WORKER_ID_LABEL: str(worker_id),
        HOST_COORDS_LABEL: format_coords(host_coords),
    }


def dcn_labels(physical_host):
    """Split GCE metadata physical_host "/block/subblock/host" into labels
    (reference label-nodes-daemon.py:38-48)."""
    parts = [p for p in physical_host.split("/") if p]
    out = {}
    for label, part in zip(DCN_LEVELS, parts):
        out[label] = part
    return out
