# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""NCCL/PyTorch environment profiles, the port of the JAX package's
``collectives/env_profiles.py``.

The reference tunes its transport through env profiles sourced into every
workload (gpudirect-tcpxo nccl-env-profile.sh, nccl-config.yaml:30-62:
algorithms, protocols, channel counts, buffer sizes). The JAX package
carries the TPU's counterpart (libtpu's XLA flags); on GPUs the tuning
surface is NCCL's own environment again, plus a few of PyTorch's
``torch.distributed`` variables. The profile names, their purposes,
:func:`profile_env` and the ConfigMap layout of
:func:`render_configmap` are the JAX package's.

Sources of the knobs: NVIDIA's NCCL documentation, "Environment
Variables" (each ``NCCL_*`` below), and PyTorch's documentation,
"torch.distributed" / "PyTorch environment variables" (each
``TORCH_*``). The values are starting points, as JAX's are: measure a
profile against the default with ``python -m
container_engine_accelerators_tpu_torch.collectives`` before adopting
it.
"""

PROFILES = {
    # Balanced defaults for dense training: more channels and larger
    # buffers for bandwidth, communication kept off the allocator's
    # cross-stream bookkeeping so it overlaps the products.
    "high-throughput": {
        # NCCL docs: minimum channels (one CTA each) a collective uses.
        "NCCL_MIN_NCHANNELS": "16",
        # NCCL docs: per-peer buffer of the Simple protocol (default 4 MiB).
        "NCCL_BUFFSIZE": "8388608",
        # NCCL docs: NVLink SHARP (NVSwitch multicast) for all-reduce and
        # all-gather where the fabric has it.
        "NCCL_NVLS_ENABLE": "1",
        # PyTorch docs: free collective buffers by stream sync, not
        # recordStream, so the caching allocator does not hold them.
        "TORCH_NCCL_AVOID_RECORD_STREAMS": "1",
    },
    # Latency-sensitive serving: small messages on the low-latency
    # protocols, the ring and tree algorithms, on a high-priority stream.
    "low-latency": {
        # NCCL docs: the protocols allowed (LL, LL128, Simple).
        "NCCL_PROTO": "LL,LL128",
        # NCCL docs: the algorithms allowed (Ring, Tree, NVLS, ...).
        "NCCL_ALGO": "Ring,Tree",
        # PyTorch docs: create the NCCL streams at high priority.
        "TORCH_NCCL_HIGH_PRIORITY": "1",
    },
    # Sequence/context-parallel workloads: the point-to-point ring hops
    # of ring attention and the collective matmuls, in larger chunks.
    "sequence-parallel": {
        # NCCL docs: chunk size of P2P operations over NVLink (default
        # 512 KiB).
        "NCCL_P2P_NVL_CHUNKSIZE": "1048576",
        # NCCL docs: chunk size of P2P operations over the network
        # (default 128 KiB).
        "NCCL_P2P_NET_CHUNKSIZE": "524288",
        # NCCL docs: use P2P transport between GPUs joined by NVLink.
        "NCCL_P2P_LEVEL": "NVL",
        "TORCH_NCCL_AVOID_RECORD_STREAMS": "1",
    },
    # Multi-node (the DCN tier's counterpart: hosts joined by the data
    # center network): GPUDirect RDMA where the NIC allows it, more
    # queue pairs and socket threads for bandwidth.
    "multislice-dcn": {
        # NCCL docs: GPU Direct RDMA when the NIC and GPU share a PCI host
        # bridge.
        "NCCL_NET_GDR_LEVEL": "PHB",
        # NCCL docs: queue pairs per connection between two ranks.
        "NCCL_IB_QPS_PER_CONNECTION": "4",
        # NCCL docs: the socket transport's helper threads and sockets per
        # thread (the reference's gpudirect-tcpx settings).
        "NCCL_SOCKET_NTHREADS": "4",
        "NCCL_NSOCKS_PERTHREAD": "4",
        # NCCL docs: keep a ring on the same NIC across nodes.
        "NCCL_CROSS_NIC": "0",
    },
    "debug": {
        # NCCL docs: log level and the subsystems logged.
        "NCCL_DEBUG": "INFO",
        "NCCL_DEBUG_SUBSYS": "INIT,COLL,P2P,NET,GRAPH",
        # PyTorch docs: collective-consistency checks and their logs.
        "TORCH_DISTRIBUTED_DEBUG": "DETAIL",
        "TORCH_CPP_LOG_LEVEL": "INFO",
    },
}


def profile_env(name):
    if name not in PROFILES:
        raise KeyError(
            f"unknown env profile {name!r}; available: {sorted(PROFILES)}"
        )
    return dict(PROFILES[name])


def render_configmap(name="tpu-env-profiles", namespace="default"):
    """Render all profiles as a ConfigMap manifest (one key per profile,
    lines of KEY=VALUE, consumable via a projected file or an init script)."""
    lines = [
        "apiVersion: v1",
        "kind: ConfigMap",
        "metadata:",
        f"  name: {name}",
        f"  namespace: {namespace}",
        "data:",
    ]
    for profile in sorted(PROFILES):
        lines.append(f"  {profile}.env: |")
        for key in sorted(PROFILES[profile]):
            lines.append(f"    {key}={PROFILES[profile][key]}")
    return "\n".join(lines) + "\n"
