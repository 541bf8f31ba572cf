# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Gang-scheduling core: job grouping, resource fit, slice-aware placement.

Pure logic (no I/O) so it is fully unit-testable — the reference's
schedule-daemon.py has zero tests (SURVEY.md §4); this module is the fix.
The daemon wrapper in gke-topology-scheduler/schedule-daemon.py wires it to
the K8s API.

Pipeline per scheduling pass (reference schedule-daemon.py:568-748):
  1. find Pending pods carrying a scheduling gate with our prefix
  2. group them into jobs (job-name / jobset / kubeflow / ownerRef labels)
  3. compute free resources per node (allocatable − running usage)
  4. place each complete gang:
       - TPU gangs: contiguous sub-mesh of one slice, ranks matched to ICI
         host coordinates (topology/placement.find_submesh)
       - non-slice gangs: DCN-compact node pick (pick_compact_nodes)
  5. emit bind decisions (pod → node); all-or-nothing per gang

Port: a subset of ``container_engine_accelerators_tpu/scheduler/gang.py``,
the closure of ``place_gang_on_slice`` (the types, resource parsing,
``find_gate``, ``pod_info``, ``node_info``, the fit and the sub-mesh
search) and ``bound_gang_members`` (the fleet reactor's drain), copied as
JAX has it. The scheduling pass, the DCN path, units
and preemption are not copied: the gang scheduler daemon that runs them
is jax-free control plane.
"""

import collections
import dataclasses
import logging

from container_engine_accelerators_tpu_torch.scheduler import GATE_PREFIX, RESOURCE_NAME
from container_engine_accelerators_tpu_torch.topology import labels as topo_labels
from container_engine_accelerators_tpu_torch.topology import placement

log = logging.getLogger(__name__)

JOB_NAME_LABEL = "job-name"
COMPLETION_INDEX_LABEL = "batch.kubernetes.io/job-completion-index"
JOBSET_NAME_LABEL = "jobset.sigs.k8s.io/jobset-name"
KUBEFLOW_JOB_LABEL = "training.kubeflow.org/job-name"
KUBEFLOW_REPLICA_INDEX_LABEL = "training.kubeflow.org/replica-index"

RANK_ANNOTATION = "tpu-topology.gke.io/rank"
SLICE_ANNOTATION = "tpu-topology.gke.io/assigned-slice"
# Stamped on every bound gang member: comma-separated node hostnames in rank
# order, and the gang's world size. Together with the rank annotation these
# are sufficient for a workload to bootstrap jax.distributed (the downward
# API + tpu-run materialize them as TPU_WORKER_ID / TPU_WORKER_HOSTNAMES).
WORKER_HOSTNAMES_ANNOTATION = "tpu-topology.gke.io/worker-hostnames"
WORKER_COUNT_ANNOTATION = "tpu-topology.gke.io/worker-count"
# Optional pod annotation declaring the gang's full size; a gang is held
# until that many member pods are visible (guards against binding a
# partially-created pod set with wrong ranks/world-size).
GANG_SIZE_ANNOTATION = "tpu-topology.gke.io/gang-size"
# Priority annotation fallback for pods without spec.priority (no
# PriorityClass admission on dev clusters). spec.priority — what the real
# priority admission plugin materializes from priorityClassName — wins.
PRIORITY_ANNOTATION = "tpu-topology.gke.io/priority"
# Stamped at bind time alongside the rank/world annotations: the gate the
# scheduler removed. Preemption reads it to restore the EXACT gate when
# evicting a bound gang (a bound pod no longer carries the gate itself).
GATE_ANNOTATION = "tpu-topology.gke.io/scheduling-gate"
# Comma-separated list of sibling GATE names (including the pod's own)
# forming one co-admission unit: a multislice job's per-slice gangs declare
# each other here so the scheduler places ALL slices' sub-meshes before
# binding ANY (all-or-nothing across slices, not just within one slice).
# Gangs sharing a jobset-name label co-admit implicitly without it.
COSCHEDULE_ANNOTATION = "tpu-topology.gke.io/coscheduled"


@dataclasses.dataclass
class PodInfo:
    name: str
    namespace: str
    uid: str
    labels: dict
    annotations: dict
    gate: str
    requests: dict  # resource name -> quantity (float)
    # True when the pod has an ownerReference with controller: true
    # (Job/JobSet/StatefulSet…): deleting it is safe compensation because
    # the controller recreates it. Pods without a *controller* owner
    # (bare, or GC-only ownerReferences) must never be compensated by
    # deletion — nothing would bring them back.
    controller_owned: bool = False
    # From spec.priority (priority admission) or PRIORITY_ANNOTATION.
    priority: int = 0
    # For BOUND pods only (bound_gang_members): the node holding them.
    bound_node: str = ""
    # spec.nodeSelector, honored during placement (a multislice job pins
    # each per-slice Job to its slice with cloud.google.com/gke-tpu-slice).
    node_selector: dict = dataclasses.field(default_factory=dict)

    @property
    def completion_index(self):
        for key in (COMPLETION_INDEX_LABEL, KUBEFLOW_REPLICA_INDEX_LABEL):
            v = self.labels.get(key) or self.annotations.get(key)
            if v is not None:
                try:
                    return int(v)
                except ValueError:
                    pass
        return 0

    @property
    def tpu_request(self):
        return int(self.requests.get(RESOURCE_NAME, 0))


@dataclasses.dataclass
class NodeInfo:
    name: str
    labels: dict
    allocatable: dict
    free: dict  # allocatable − usage by running pods

    @property
    def slice_name(self):
        return self.labels.get(topo_labels.SLICE_LABEL)

    @property
    def host_coords(self):
        # Memoized: label dicts are never mutated after construction,
        # and the incremental cache re-uses NodeInfo objects across
        # passes — re-parsing 1k coordinate labels per pass was a
        # measurable slice of the steady-state pass.
        memo = self.__dict__.get("_host_coords_memo")
        if memo is None:
            v = self.labels.get(topo_labels.HOST_COORDS_LABEL)
            memo = (topo_labels.parse_coords(v) if v else None,)
            self.__dict__["_host_coords_memo"] = memo
        return memo[0]

    @property
    def dcn_levels(self):
        return tuple(
            self.labels.get(level) for level in topo_labels.DCN_LEVELS
        )


@dataclasses.dataclass
class Binding:
    pod: PodInfo
    node: str
    rank: int
    slice_name: str = ""


# -- parsing from raw API objects ---------------------------------------------

_SUFFIX = {
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
}


def parse_quantity(q):
    """Parse a K8s resource quantity ("2", "500m", "1Gi") to float
    (reference schedule-daemon.py:176-201)."""
    if isinstance(q, (int, float)):
        return float(q)
    s = str(q)
    if s.endswith("m"):
        return float(s[:-1]) / 1000.0
    for suffix in sorted(_SUFFIX, key=len, reverse=True):
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * _SUFFIX[suffix]
    return float(s)


def pod_requests(pod_spec):
    """Sum container resource requests across containers.

    Per-resource fallback to limits mirrors API-server defaulting:
    requests default to limits when only limits are set — and for
    extended resources (google.com/tpu) limits are the REQUIRED form, so
    a limits-only TPU pod must count against capacity here exactly as a
    kube-scheduler would count it."""
    totals = collections.defaultdict(float)
    for container in pod_spec.get("containers", []):
        resources = container.get("resources", {}) or {}
        requests = resources.get("requests", {}) or {}
        limits = resources.get("limits", {}) or {}
        for name in set(requests) | set(limits):
            q = requests.get(name, limits.get(name))
            totals[name] += parse_quantity(q)
    return dict(totals)


def find_gate(pod, prefix=GATE_PREFIX):
    for gate in pod.get("spec", {}).get("schedulingGates", []) or []:
        name = gate.get("name", "")
        if name.startswith(prefix):
            return name
    return None


def pod_priority(pod, trust_annotation=True):
    """spec.priority (what PriorityClass admission materializes) wins;
    the stack annotation is the no-admission fallback.

    The annotation is self-assigned by the pod author — on a multi-tenant
    cluster it bypasses the PriorityClass RBAC/quota model, so the daemon
    only honors it behind the opt-in --trust-priority-annotation flag
    (trust_annotation=False drops the fallback entirely)."""
    spec_priority = pod.get("spec", {}).get("priority")
    if spec_priority is not None:
        try:
            return int(spec_priority)
        except (TypeError, ValueError):
            pass
    if not trust_annotation:
        return 0
    anno = (pod.get("metadata", {}).get("annotations") or {}).get(
        PRIORITY_ANNOTATION
    )
    if anno is not None:
        try:
            return int(anno)
        except (TypeError, ValueError):
            pass
    return 0


def pod_info(pod, gate, trust_priority_annotation=True):
    meta = pod.get("metadata", {})
    return PodInfo(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        uid=meta.get("uid", ""),
        labels=meta.get("labels", {}) or {},
        annotations=meta.get("annotations", {}) or {},
        gate=gate,
        requests=pod_requests(pod.get("spec", {})),
        controller_owned=any(
            ref.get("controller")
            for ref in meta.get("ownerReferences") or []
        ),
        priority=pod_priority(pod, trust_annotation=trust_priority_annotation),
        node_selector=dict(pod.get("spec", {}).get("nodeSelector") or {}),
    )


def usage_by_node(all_pods):
    """One pass over pods → {node_name: {resource: used}} (parse each pod's
    requests exactly once; node_info over N nodes then stays O(N + pods))."""
    usage = collections.defaultdict(lambda: collections.defaultdict(float))
    for pod in all_pods:
        spec = pod.get("spec", {})
        # A pod we bound last pass may not have nodeName yet (kube-scheduler
        # hasn't run): its hostname nodeSelector is already a commitment, so
        # count it — otherwise two gangs can be bound onto the same hosts.
        node_name = spec.get("nodeName") or (
            (spec.get("nodeSelector") or {}).get("kubernetes.io/hostname")
        )
        if not node_name:
            continue
        if pod.get("status", {}).get("phase") in ("Succeeded", "Failed"):
            continue
        for resource, amount in pod_requests(spec).items():
            usage[node_name][resource] += amount
    return usage


def node_info(node, running_pods=None, usage=None):
    """Build NodeInfo with free = allocatable − sum(running pod requests)
    (reference schedule-daemon.py:245-332). Pass `usage` from usage_by_node
    when parsing many nodes."""
    meta = node.get("metadata", {})
    name = meta.get("name", "")
    allocatable = {
        k: parse_quantity(v)
        for k, v in node.get("status", {}).get("allocatable", {}).items()
    }
    if usage is None:
        usage = usage_by_node(running_pods or [])
    used = usage.get(name, {})
    free = {k: v - used.get(k, 0.0) for k, v in allocatable.items()}
    return NodeInfo(
        name=name,
        labels=meta.get("labels", {}) or {},
        allocatable=allocatable,
        free=free,
    )


def node_ready_and_schedulable(node):
    if node.get("spec", {}).get("unschedulable"):
        return False
    for taint in node.get("spec", {}).get("taints", []) or []:
        if taint.get("effect") in ("NoSchedule", "NoExecute"):
            # google.com/tpu taint is tolerated by TPU workloads by
            # convention (GKE adds it to every TPU node).
            if taint.get("key") != RESOURCE_NAME:
                return False
    for cond in node.get("status", {}).get("conditions", []) or []:
        if cond.get("type") == "Ready":
            return cond.get("status") == "True"
    return False


# -- job grouping -------------------------------------------------------------

def job_key(pod: PodInfo):
    """Group pods into gangs by the reference's label heuristics
    (schedule-daemon.py:594-647): jobset > kubeflow > batch Job > ownerRef
    fallback (the gate name itself carries the job identity suffix).

    Unlike the reference (which folds a whole jobset into one gang and so
    can never express a multislice jobset — every pod would need one
    slice), a jobset's pods sub-group by child Job: each per-slice Job is
    its own gang with per-slice ranks, and the jobset identity makes the
    gangs one co-admission unit (group_units)."""
    labels = pod.labels
    if JOBSET_NAME_LABEL in labels:
        child = labels.get(JOB_NAME_LABEL) or pod.gate
        return (pod.namespace, "jobset", labels[JOBSET_NAME_LABEL], child)
    if KUBEFLOW_JOB_LABEL in labels:
        return (pod.namespace, "kubeflow", labels[KUBEFLOW_JOB_LABEL])
    if JOB_NAME_LABEL in labels:
        return (pod.namespace, "job", labels[JOB_NAME_LABEL])
    return (pod.namespace, "gate", pod.gate)


def group_gangs(pods):
    gangs = collections.defaultdict(list)
    for pod in pods:
        gangs[job_key(pod)].append(pod)
    for members in gangs.values():
        members.sort(key=lambda p: (p.completion_index, p.name))
    return dict(gangs)


# -- placement ----------------------------------------------------------------

def _homogeneous(gang):
    """True when every member is placement-equivalent (same requests and
    node selector): any-fit == all-fit, so the fast scanners apply."""
    return all(
        pod.requests == gang[0].requests
        and pod.node_selector == gang[0].node_selector
        for pod in gang
    )


def _fits(pod: PodInfo, node: NodeInfo):
    # nodeSelector is a hard constraint exactly as kube-scheduler treats
    # it: a pod pinned to a slice (cloud.google.com/gke-tpu-slice in the
    # multislice manifests) must never be placed onto another slice —
    # the bind's hostname selector would conflict and the pod would hang.
    for key, want in pod.node_selector.items():
        if node.labels.get(key) != want:
            return False
    for resource, amount in pod.requests.items():
        if amount > node.free.get(resource, 0.0) + 1e-9:
            return False
    return True


def slice_grid(members, free_coords):
    """Host grid bounds for a slice: the accelerator-type label when it
    parses, else a bounding box of the observed coordinates (shared with
    the cached sub-mesh inventory — scheduler/incremental.py — so both
    placement paths derive identical grids)."""
    acc_type = members[0].labels.get(topo_labels.ACCELERATOR_TYPE_LABEL)
    try:
        from container_engine_accelerators_tpu_torch.topology import slice as topo

        return topo.parse_accelerator_type(acc_type or "").host_bounds
    except ValueError:
        # Unknown type: derive a bounding grid from observed coords.
        dims = len(next(iter(free_coords)))
        return tuple(
            max(c[d] for c in free_coords) + 1 for d in range(dims)
        )


def place_gang_on_slice(gang, nodes, inventory=None, pack=False):
    """Try to place a TPU gang onto a contiguous sub-mesh of one slice.

    Returns list[Binding] or None. Requires every node of the gang to come
    from the same slice, and ranks follow sub-mesh row-major order.

    ``inventory`` (scheduler/incremental.SubmeshInventory) serves
    homogeneous gangs from the cached per-slice free sub-mesh views
    instead of rescanning every node — results are pinned equivalent to
    this from-scratch path (tests/test_sched_incremental.py). ``pack``
    selects the anti-fragmentation position policy
    (topology/placement.find_submesh).
    """
    n = len(gang)
    homogeneous = _homogeneous(gang)
    if inventory is not None and homogeneous:
        return inventory.place(gang, pack=pack)
    by_slice = collections.defaultdict(list)
    for node in nodes:
        if node.slice_name and node.host_coords is not None:
            by_slice[node.slice_name].append(node)

    # Smallest slice first (leave big contiguous meshes for big gangs);
    # name tiebreak so the scan order is independent of node list order.
    for slice_name in sorted(
            by_slice, key=lambda s: (len(by_slice[s]), s)):
        members = by_slice[slice_name]
        if len(members) < n:
            continue
        # Candidate hosts: each node hosts exactly ONE gang pod, so a node
        # is eligible if at least one pod fits it; rank→host positional fit
        # is enforced by the sub-mesh search below.
        free_nodes = {
            node.host_coords: node
            for node in members
            if any(_fits(pod, node) for pod in gang)
        }
        if len(free_nodes) < n:
            continue
        grid = slice_grid(members, free_nodes)
        if homogeneous:
            # any-fit == all-fit here, so the fast (native) scanner applies.
            sub = placement.find_submesh(
                grid, free_nodes.keys(), n, pack=pack
            )
        else:
            sub = placement.find_submesh_matching(
                grid,
                free_nodes.keys(),
                n,
                fits=lambda i, coords: _fits(gang[i], free_nodes[coords]),
                pack=pack,
            )
        if sub is None:
            continue
        return [
            Binding(pod, free_nodes[coords].name, rank, slice_name)
            for rank, (pod, coords) in enumerate(zip(gang, sub.hosts))
        ]
    return None


def _match_pods_to_nodes(gang, nodes):
    """Assign one node per pod (heterogeneous requests); returns the node
    list aligned to gang order, or None. Gangs are small, so backtracking
    with most-constrained-pod-first ordering is exact and fast."""
    fit_sets = [
        [j for j, node in enumerate(nodes) if _fits(pod, node)]
        for pod in gang
    ]
    order = sorted(range(len(gang)), key=lambda i: len(fit_sets[i]))
    used = set()
    assign = [None] * len(gang)

    def backtrack(k):
        if k == len(order):
            return True
        i = order[k]
        for j in fit_sets[i]:
            if j not in used:
                used.add(j)
                assign[i] = j
                if backtrack(k + 1):
                    return True
                used.remove(j)
        return False

    if not backtrack(0):
        return None
    return [nodes[j] for j in assign]


def bound_gang_members(all_pods, trust_priority_annotation=True):
    """Parse BOUND gang members out of the full pod list: pods we stamped
    rank/gate annotations on that are still active (the preemption victim
    candidates). Returns {gang_key: [PodInfo...]}; each PodInfo.gate is
    the ORIGINAL gate restored on eviction (from GATE_ANNOTATION)."""
    gangs = collections.defaultdict(list)
    for pod in all_pods:
        meta = pod.get("metadata", {})
        anno = meta.get("annotations") or {}
        if RANK_ANNOTATION not in anno or GATE_ANNOTATION not in anno:
            continue
        if pod.get("status", {}).get("phase") in ("Succeeded", "Failed"):
            continue
        if meta.get("deletionTimestamp"):
            continue
        spec = pod.get("spec", {})
        node = spec.get("nodeName") or (
            (spec.get("nodeSelector") or {}).get("kubernetes.io/hostname")
        )
        if not node:
            continue
        info = pod_info(pod, anno[GATE_ANNOTATION],
                        trust_priority_annotation=trust_priority_annotation)
        info.bound_node = node
        gangs[job_key(info)].append(info)
    return dict(gangs)
