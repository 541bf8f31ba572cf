# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The stack's metrics-port registry — one module, every assignment.

Copy of ``container_engine_accelerators_tpu/obs/ports.py``, its imports
rewritten to the port's package; the contracts are the same.

Before this existed, :2112 lived in ``deviceplugin/metrics.py`` and
:2114 in ``tpumetrics/exporter.py`` as unrelated literals; a third
exporter picking either number would have failed at runtime with a bare
``EADDRINUSE`` and no hint who owns the port. Every exposition surface
now imports its default here, and the bind helpers turn a conflict into
an error that names the stack's known assignments.
"""

import errno

# Per-container chip metrics (duty cycle / HBM via kubelet PodResources).
DEVICE_PLUGIN_METRICS_PORT = 2112
# Node interconnect metrics (NIC rates + per-chip ICI error counters).
NODE_EXPORTER_METRICS_PORT = 2114
# Workload metrics (serving TTFT/TPOT, training steps, scheduler passes).
WORKLOAD_METRICS_PORT = 2116
# Fleet health/events (per-chip health gauge, health-transition counters,
# structured-event rates from obs.events).
FLEET_EVENTS_PORT = 2118
# Goodput/SLO tier (goodput ratio + badput-by-cause from obs.goodput's
# report server; alert-state gauges from obs.alerts ride the workload
# registries they monitor).
GOODPUT_SLO_PORT = 2120
# Fleet serving router (tpu_router_* rotation/affinity/re-issue
# instruments from fleet/router.py --metrics-port).
FLEET_ROUTER_PORT = 2122
# Request-journey tier (per-stage critical-path rollups from
# obs.journey's stitched-waterfall report server).
JOURNEY_PORT = 2124
# Chip-accounting/capacity tier (per-tenant device-seconds, MFU and
# HBM-watermark rollups from obs.capacity's report server).
CAPACITY_PORT = 2126
# Flight-recorder tier (dump/drop counters from obs.flight's armed
# recorder; postmortem bundles are files, only the recorder's own
# health is scraped).
FLIGHT_PORT = 2128

KNOWN_PORTS = {
    DEVICE_PLUGIN_METRICS_PORT:
        "device-plugin container metrics (deviceplugin/metrics.py)",
    NODE_EXPORTER_METRICS_PORT:
        "node interconnect exporter (tpumetrics/exporter.py)",
    WORKLOAD_METRICS_PORT:
        "workload metrics (obs.metrics — serve_cli/train_cli/scheduler)",
    FLEET_EVENTS_PORT:
        "fleet health/events (obs.events — device-plugin health checker)",
    GOODPUT_SLO_PORT:
        "goodput/SLO tier (obs.goodput report --serve-port / obs.alerts)",
    FLEET_ROUTER_PORT:
        "fleet serving router (fleet.router --metrics-port)",
    JOURNEY_PORT:
        "request-journey tier (obs.journey --serve-port)",
    CAPACITY_PORT:
        "chip-accounting/capacity tier (obs.capacity --serve-port)",
    FLIGHT_PORT:
        "flight-recorder tier (obs.flight --flight-recorder)",
}


class PortConflictError(RuntimeError):
    """A metrics port was already bound; message names known owners."""


def describe(port):
    """Human-readable owner of ``port`` per this registry."""
    return KNOWN_PORTS.get(port, "unassigned in obs.ports")


def conflict_message(port, owner, err=None):
    assignments = "; ".join(
        f":{p} = {who}" for p, who in sorted(KNOWN_PORTS.items())
    )
    detail = f" ({err})" if err is not None else ""
    return (
        f"cannot bind metrics port :{port} for {owner}{detail}. "
        f"Registered assignments: {assignments}. If another exporter is "
        f"already serving this port, pick a free one (obs/ports.py is "
        f"the authoritative map)."
    )


def _is_bind_conflict(err):
    return isinstance(err, OSError) and err.errno in (
        errno.EADDRINUSE, errno.EACCES,
    )


def start_prometheus_server(port, owner, registry=None):
    """``prometheus_client.start_http_server`` with fail-fast conflicts.

    Used by the two node-tier exporters (which already depend on
    prometheus_client); the workload tier serves its own registry via
    ``obs.metrics.serve``. Returns whatever start_http_server returns
    (an (httpd, thread) tuple on current prometheus_client).
    """
    from prometheus_client import start_http_server

    kwargs = {"registry": registry} if registry is not None else {}
    try:
        return start_http_server(port, **kwargs)
    except OSError as e:
        if _is_bind_conflict(e):
            raise PortConflictError(conflict_message(port, owner, e)) from e
        raise
