# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Replica lifecycle: the autoscaler's hands on the real cluster.

Until now the autoscaler's scale decisions moved either nothing
(advisory mode) or hermetic in-process fakes (``fleet/sim.py``). This
module closes the k8s actuation loop: a scale-out becomes real serving
pods created through the :class:`~container_engine_accelerators_tpu_torch
.scheduler.k8s.KubeClient` — **gated** (``gke.io/topology-aware-auto-*``,
the gang scheduler's contract), requesting the device plugin's
``google.com/tpu`` extended resource, carrying the NRI device-injector
annotation for the TPU device nodes — and **bound** to the contiguous
sub-mesh the :class:`~container_engine_accelerators_tpu_torch.fleet
.autoscaler.GangPlacer` chose (``bind_gated_pod`` stamps the rank /
slice annotations exactly like the topology scheduler daemon). A
scale-in drives the existing lossless path: cordon →
``router.mark_draining`` → engine drain → deregister → pod deletion.

**Crash safety is the label.** Every pod a lifecycle creates carries
``tpu-topology.gke.io/fleet-replica: <replica-id>``; the pods ARE the
durable record of what was launched. A restarted autoscaler calls
:meth:`ReplicaLifecycle.reconcile` first: labeled pods whose serving
process still answers are **adopted** back into the fleet (never
re-launched — no double pods), and labeled pods whose process is gone
are **orphans** and get deleted (never leaked). ``launch`` re-checks
the label before creating, so a crash between pod creation and router
registration converges the same way.

The *process* half (actually running an engine and producing a
:class:`~container_engine_accelerators_tpu_torch.fleet.router.ReplicaHandle`)
is pluggable via ``backend``: the hermetic day drill plugs fake-jit
``SimReplica`` processes, a production deployment plugs an HTTP-probe
backend that waits for the pod's ``/healthz``. The k8s half — pod
creation, gang binding, label reconciliation, deletion — is this
module and runs unchanged against the conformant fake kubeapi in
tier-1.

Copy of ``container_engine_accelerators_tpu/fleet/lifecycle.py``, its
imports pointed at the port's copies (``fleet``, ``scheduler``). The
replica pods it creates run the port's ``serve_cli``.
"""

import logging
import threading
import time

log = logging.getLogger(__name__)

EVENT_SOURCE = "fleet.lifecycle"

# The durable launch record: every pod a lifecycle creates carries this
# label with the replica id as its value. Reconciliation reads the
# world back through it.
FLEET_REPLICA_LABEL = "tpu-topology.gke.io/fleet-replica"

# Gang job identity + scheduling gate (the gang scheduler groups pods
# by job-name and only touches pods gated under its prefix).
FLEET_JOB_NAME = "fleet-replica"
FLEET_GATE = "gke.io/topology-aware-auto-fleet-replica"

# NRI device-injector annotation (nri_device_injector): the serving
# container's TPU device nodes, injected at pod start.
NRI_ANNOTATION = "devices.gke.io/container.serve"


def replica_pod(replica_id, rank, namespace="default",
                image="tpu-workload:latest", tpu_per_pod=4, port=8000):
    """The raw manifest of one gang member of a serving replica."""
    device_lines = "".join(
        f"- path: /dev/accel{i}\n" for i in range(tpu_per_pod)
    )
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"{replica_id}-{rank}",
            "namespace": namespace,
            "labels": {
                FLEET_REPLICA_LABEL: replica_id,
                "job-name": FLEET_JOB_NAME,
                "app": "tpu-serving",
            },
            "annotations": {NRI_ANNOTATION: device_lines},
        },
        "spec": {
            "containers": [{
                "name": "serve",
                "image": image,
                "command": [
                    "python", "-m",
                    "container_engine_accelerators_tpu_torch.models"
                    ".serve_cli",
                    "--continuous-batching", "--port", str(port),
                    "--replica-id", replica_id,
                ],
                "resources": {
                    # Extended resources: limits are the REQUIRED form
                    # (requests must equal limits); the device plugin
                    # advertises google.com/tpu per node.
                    "requests": {
                        "cpu": "1", "memory": "1Gi",
                        "google.com/tpu": str(tpu_per_pod),
                    },
                    "limits": {"google.com/tpu": str(tpu_per_pod)},
                },
            }],
            "schedulingGates": [{"name": FLEET_GATE}],
        },
        "status": {"phase": "Pending"},
    }


def cluster_placer(kube, gang_size=1, tpu_per_pod=4,
                   namespace="default"):
    """A :class:`~container_engine_accelerators_tpu_torch.fleet.autoscaler
    .GangPlacer` over the LIVE cluster: nodes read back through the
    KubeClient each pass (schedulable, topology-labeled), the gang
    being the pods :func:`replica_pod` would create.

    State between ``place()`` calls rides the scheduler's incremental
    tier (``scheduler/incremental.py``): a ClusterCache diffs the pod/
    node lists by uid+resourceVersion (free capacity still counts pods
    BOUND via the gated-pod nodeSelector pin — our own launches sit
    Pending with a hostname selector until kubelet picks them up, or a
    second scale-out would land on an already-claimed node; deleting
    pods are excluded, their capacity is coming back), and a shared
    SubmeshInventory serves the sub-mesh search from cached per-slice
    views — an autoscaler launch on a quiet fleet no longer triggers a
    full rescan."""
    from container_engine_accelerators_tpu_torch.fleet import (
        autoscaler as fleet_autoscaler,
    )
    from container_engine_accelerators_tpu_torch.scheduler import (
        incremental as sched_incremental,
    )
    from container_engine_accelerators_tpu_torch.scheduler import gang

    cache = sched_incremental.ClusterCache(
        exclude_phases=(), exclude_deleting=True,
    )
    inventory = sched_incremental.SubmeshInventory()

    def nodes_fn():
        cache.update(
            kube.list_pods(namespace=namespace), kube.list_nodes()
        )
        nodes = cache.node_infos()
        inventory.observe(nodes, dirty=cache.take_dirty())
        return nodes

    def gang_fn():
        out = []
        for rank in range(gang_size):
            pod = replica_pod(
                "placer-probe", rank, namespace=namespace,
                tpu_per_pod=tpu_per_pod,
            )
            out.append(gang.pod_info(pod, gang.find_gate(pod)))
        return out

    return fleet_autoscaler.GangPlacer(
        nodes_fn, gang_fn, inventory=inventory
    )


def _no_transport(payload):
    from container_engine_accelerators_tpu_torch.fleet.router import (
        TransportError,
    )

    raise TransportError(
        "router-less lifecycle handle has no transport (traffic "
        "routing lives with the fleet router process)"
    )


class PodBackend:
    """Process half for the router-less autoscaler CLI: the pods ARE
    the replica, and process liveness is the deployment's job.
    ``url_template`` (e.g. ``http://{replica}:8000``) arms real
    /healthz probes — with one, :meth:`adopt` verifies the process
    before adopting (a dead replica's pods reconcile as orphans);
    without one, adoption trusts the pod record."""

    def __init__(self, url_template=""):
        self.url_template = url_template

    def _handle(self, replica_id):
        from container_engine_accelerators_tpu_torch.fleet import (
            router as fleet_router,
        )

        url = (
            self.url_template.format(replica=replica_id)
            if self.url_template else ""
        )
        return fleet_router.ReplicaHandle(
            replica_id,
            fleet_router.http_transport(url) if url else _no_transport,
            probe=fleet_router.http_probe(url) if url else None,
            host=replica_id,
        )

    def start(self, replica_id, pods):
        del pods
        return self._handle(replica_id)

    def adopt(self, replica_id, pods):
        del pods
        handle = self._handle(replica_id)
        if handle.probe is not None:
            try:
                handle.probe()
            except Exception:  # noqa: BLE001 - process gone = orphan
                return None
        return handle

    def stop(self, replica_id):
        """Nothing to stop in-process: deleting the pods (the
        lifecycle's next step) is what stops a pod-backed replica."""


class ReplicaLifecycle:
    """Launch/terminate serving replicas as real pods; reconcile from
    pod labels after a controller restart.

    ``backend`` supplies the process half:

    * ``start(replica_id, pods) -> ReplicaHandle`` — bring up (or
      connect to) the replica's serving process;
    * ``adopt(replica_id, pods) -> ReplicaHandle | None`` — re-attach
      to a replica that outlived the controller (None = the process is
      gone, the pods are orphans);
    * ``stop(replica_id)`` — kill the process;
    * ``drain(replica_id, reason) -> int`` (optional) — lossless
      engine drain; without it :meth:`drain` polls the handle's probe
      until idle.
    """

    def __init__(self, kube, backend, namespace="default", placer=None,
                 events=None, image="tpu-workload:latest",
                 gang_size=1, tpu_per_pod=4, port=8000,
                 drain_timeout_s=30.0, clock=time.monotonic,
                 sleep=time.sleep):
        self.kube = kube
        self.backend = backend
        self.namespace = namespace
        self.placer = placer
        self.events = events
        self.image = image
        self.gang_size = gang_size
        self.tpu_per_pod = tpu_per_pod
        self.port = port
        self.drain_timeout_s = drain_timeout_s
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self.handles = {}   # replica_id -> ReplicaHandle
        self.drained = []   # (replica_id, reason) — drill assertions

    # -- the durable record ---------------------------------------------------

    def labeled_pods(self):
        """{replica_id: [pod, ...]} for every pod carrying the fleet
        label — the world as the cluster records it."""
        out = {}
        for pod in self.kube.list_pods(
            namespace=self.namespace,
            label_selector=FLEET_REPLICA_LABEL,
        ):
            meta = pod.get("metadata", {})
            if meta.get("deletionTimestamp"):
                continue  # already on its way out
            rid = meta.get("labels", {}).get(FLEET_REPLICA_LABEL)
            if rid:
                out.setdefault(rid, []).append(pod)
        return out

    def _unique_id(self, hint, existing):
        """A replica id free in BOTH the live handle map and the
        cluster's labeled pods: a restarted controller re-counting
        from zero must never collide with a surviving replica's
        name."""
        rid = hint
        n = 1
        with self._lock:
            taken = set(self.handles)
        taken |= set(existing)
        while rid in taken:
            n += 1
            rid = f"{hint}-r{n}"
        return rid

    # -- launch ---------------------------------------------------------------

    def launch(self, replica_id, placement=None):
        """Create one replica's gang pods, bind them to the placement,
        start the serving process; returns the ReplicaHandle (or None
        when the launch failed — the autoscaler treats that as
        ``scale_blocked`` and retries next tick)."""
        existing = self.labeled_pods()
        replica_id = self._unique_id(replica_id, existing)
        if placement is None and self.placer is not None:
            placement = self.placer.place()
            if placement is None:
                log.warning(
                    "launch of %s blocked: no intact sub-mesh",
                    replica_id,
                )
                return None
        pods = []
        try:
            for rank in range(self.gang_size):
                pod = replica_pod(
                    replica_id, rank, namespace=self.namespace,
                    image=self.image, tpu_per_pod=self.tpu_per_pod,
                    port=self.port,
                )
                self.kube.create_pod(self.namespace, pod)
                pods.append(pod)
            # Bind each gang member to the placer's sub-mesh node
            # (rank-ordered) and lift the gate — the same rank/slice
            # annotation stamping the topology scheduler daemon does.
            nodes = []
            if placement:
                from container_engine_accelerators_tpu_torch.scheduler import (
                    gang,
                )

                for rank, binding in enumerate(
                    placement[: self.gang_size]
                ):
                    self.kube.bind_gated_pod(
                        self.namespace, f"{replica_id}-{rank}",
                        binding.node, FLEET_GATE,
                        extra_env={
                            gang.RANK_ANNOTATION: str(rank),
                            gang.SLICE_ANNOTATION: binding.slice_name,
                            gang.GATE_ANNOTATION: FLEET_GATE,
                        },
                    )
                    nodes.append(binding.node)
            handle = self.backend.start(replica_id, pods)
        except Exception:  # noqa: BLE001 - a failed launch must not leak pods
            log.exception("launch of %s failed; removing its pods",
                          replica_id)
            self._delete_pods(replica_id)
            return None
        if handle is None:
            self._delete_pods(replica_id)
            return None
        if nodes:
            # The handle's node is what scale-in cordons: it must be
            # the REAL bound node, whatever placeholder the backend
            # stamped.
            handle.node = nodes[0]
        with self._lock:
            self.handles[replica_id] = handle
        if self.events is not None:
            self.events.emit(
                "replica_launched", replica=replica_id,
                node=(nodes[0] if nodes else ""), pods=len(pods),
            )
        log.info("replica %s launched (%d pod(s), node %s)",
                 replica_id, len(pods), nodes[0] if nodes else "<unbound>")
        return handle

    # -- drain / terminate ----------------------------------------------------

    def drain(self, handle, reason):
        """Lossless drain of a replica's in-flight work (the scale-in
        gate): backend drain when available, else poll the probe until
        the replica reports idle."""
        rid = handle.replica_id
        migrated = 0
        backend_drain = getattr(self.backend, "drain", None)
        if backend_drain is not None:
            migrated = backend_drain(rid, reason)
        deadline = self._clock() + self.drain_timeout_s
        while self._clock() < deadline:
            try:
                info = handle.probe() if handle.probe else {}
            except Exception:  # noqa: BLE001 - a dead replica is drained
                break
            if not info or (
                not info.get("queue_depth")
                and not info.get("occupied_slots")
            ):
                break
            self._sleep(0.005)
        self.drained.append((rid, reason))
        return migrated

    def _delete_pods(self, replica_id):
        from container_engine_accelerators_tpu_torch.scheduler.k8s import (
            KubeError,
        )

        for pod in self.labeled_pods().get(replica_id, []):
            meta = pod.get("metadata", {})
            try:
                self.kube.delete_pod(
                    self.namespace, meta.get("name"),
                    uid=meta.get("uid"), grace_seconds=0,
                )
            except KubeError as err:
                if err.status not in (404, 409):
                    raise
                # 404: already gone; 409: uid changed under us — the
                # name now belongs to a replacement we must not touch.

    def terminate(self, handle):
        """Stop the process and delete the replica's pods (the drained
        replica's last step — or an orphan sweep's only one)."""
        rid = handle.replica_id
        try:
            self.backend.stop(rid)
        except Exception:  # noqa: BLE001 - the pods must still go
            log.exception("backend stop of %s failed", rid)
        self._delete_pods(rid)
        with self._lock:
            self.handles.pop(rid, None)
        if self.events is not None:
            self.events.emit("replica_terminated", replica=rid)
        log.info("replica %s terminated (pods deleted)", rid)

    # -- crash-safe reconciliation --------------------------------------------

    def reconcile(self):
        """Converge desired-vs-actual from the cluster's labels after
        a controller restart.

        Labeled pods whose process still answers are ADOPTED (the
        handle map and — via the caller — the router learn them back);
        labeled pods whose process is gone are ORPHANS and are
        deleted. Returns ``{"adopted": [ids], "orphaned": [ids]}``;
        the caller registers the adopted handles with its router. A
        lifecycle that never crashed reconciles to a no-op."""
        adopted, orphaned = [], []
        for rid, pods in sorted(self.labeled_pods().items()):
            with self._lock:
                known = rid in self.handles
            if known:
                continue
            handle = None
            backend_adopt = getattr(self.backend, "adopt", None)
            if backend_adopt is not None:
                handle = backend_adopt(rid, pods)
            if handle is None:
                # No process behind the pods: an orphaned launch
                # (crash between create and register, or the process
                # died with the old controller). Delete, never leak.
                self._delete_pods(rid)
                orphaned.append(rid)
                if self.events is not None:
                    self.events.emit(
                        "replica_terminated", severity="warning",
                        replica=rid, orphan=True,
                    )
                continue
            bound = (
                pods[0].get("spec", {}).get("nodeSelector") or {}
            ).get("kubernetes.io/hostname") or pods[0].get(
                "spec", {}
            ).get("nodeName")
            if bound:
                handle.node = bound
            with self._lock:
                self.handles[rid] = handle
            adopted.append(rid)
            if self.events is not None:
                self.events.emit(
                    "replica_adopted", replica=rid, pods=len(pods),
                )
        if adopted or orphaned:
            log.info(
                "reconcile: adopted %d replica(s) %s, removed %d "
                "orphan(s) %s", len(adopted), adopted, len(orphaned),
                orphaned,
            )
        return {"adopted": adopted, "orphaned": orphaned}
