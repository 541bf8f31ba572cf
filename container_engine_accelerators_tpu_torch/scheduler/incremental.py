# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Incremental thousand-node scheduling state (docs/scheduler-scale.md).

The reference's scheduler re-reads and re-scores the entire cluster on
every pass (schedule-daemon.py:135 re-lists and re-parses every pod and
node) and "can only wait" when no contiguous sub-mesh exists. At 1k
nodes / 100 gangs the placement pass itself becomes the serving-path
bottleneck. This module makes the steady-state pass proportional to
WHAT CHANGED instead of the world:

* :class:`ClusterCache` — diffs raw pod/node lists between passes by
  uid + resourceVersion into a dirty-node set; per-node usage and the
  parsed node views are incrementally maintained, so an unchanged pod
  is never re-parsed (``pod_requests``/``parse_quantity``/label copies
  are the full-rescan pass's dominant cost).
* :class:`SubmeshInventory` — per-slice cached free sub-mesh views:
  which hosts are eligible for a given gang shape and which contiguous
  ICI sub-meshes are open, memoized per slice content-version and
  invalidated on bind/unbind/cordon/preemption (``note_change``)
  instead of recomputed by backtracking per gang per pass. Placement
  through the inventory is pinned equivalent to the from-scratch
  ``gang.place_gang_on_slice`` path (tests/test_sched_incremental.py).
* :func:`fragmentation_score` + :func:`plan_defrag` — an
  anti-fragmentation compactor: a budgeted planner that simulates
  lossless gang moves (evict → re-place with the pack placement policy
  the next pass will actually run) and keeps only moves that strictly
  improve the fleet fragmentation score, so large contiguous sub-meshes
  stay available for large gangs.

Float caveat: incrementally maintained usage applies additions and
subtractions in event order, not list order, so sums can differ from a
from-scratch parse by IEEE rounding when requests are not binary-exact
(``_fits`` carries a 1e-9 epsilon for exactly this class of noise).

Copy of ``container_engine_accelerators_tpu/scheduler/incremental.py``:
the replica lifecycle's live-cluster placer (``fleet/lifecycle.cluster_placer``)
runs on it.
"""

import collections
import dataclasses
import logging

from container_engine_accelerators_tpu_torch.scheduler import GATE_PREFIX, RESOURCE_NAME, gang
from container_engine_accelerators_tpu_torch.topology import placement

log = logging.getLogger(__name__)


@dataclasses.dataclass
class _PodRec:
    """Everything one pass needs from one pod, parsed once per
    resourceVersion."""

    uid: str
    rv: object
    usage_node: str = ""      # "" = contributes no usage
    requests: dict = None     # usage contribution (usage_node set)
    gated: object = None      # PodInfo for Pending+gated pods
    bound: object = None      # PodInfo for bound gang members
    bound_key: tuple = None   # job_key(bound), computed at parse time


@dataclasses.dataclass
class _NodeRec:
    name: str
    rv: object
    labels: dict
    allocatable: dict
    ready: bool
    # The NodeInfo view re-used across passes; None until first built,
    # and reset by every re-parse (a fresh record must never serve a
    # stale labels/allocatable view, whatever dict objects the client
    # re-uses).
    info: object = None


class ClusterCache:
    """Parse pods/nodes once per resourceVersion; answer every pass's
    questions (gated pods, bound gangs, node free views) from the
    incrementally maintained state.

    :meth:`update` takes the raw ``list_pods()``/``list_nodes()``
    results and returns the set of node names whose capacity/usage/
    labels/readiness changed since the previous update — the dirty set
    a :class:`SubmeshInventory` uses to invalidate only the slices
    that moved. Objects without a resourceVersion are re-parsed every
    pass (correct, just not fast).

    ``exclude_phases``/``exclude_deleting`` configure which pods count
    against node usage: the scheduler daemon mirrors
    ``gang.usage_by_node`` (skip Succeeded/Failed, count deleting);
    the fleet lifecycle's placer mirrors its historical view (count
    any phase, skip deleting).
    """

    def __init__(self, gate_prefix=GATE_PREFIX,
                 trust_priority_annotation=False,
                 exclude_phases=("Succeeded", "Failed"),
                 exclude_deleting=False):
        self.gate_prefix = gate_prefix
        self.trust_priority_annotation = trust_priority_annotation
        self.exclude_phases = tuple(exclude_phases)
        self.exclude_deleting = exclude_deleting
        self._pods = {}        # uid -> _PodRec
        self._nodes = {}       # name -> _NodeRec
        self._usage = {}       # node name -> {resource: amount}
        self._pod_order = []   # uids in last list order
        self._node_order = []  # names in last list order
        self.pods_parsed = 0   # monotone: pods actually (re)parsed
        self.nodes_parsed = 0
        self.last_parsed = 0   # pods parsed by the latest update
        self.last_dirty = set()
        # Dirty names accumulated across updates until a consumer
        # (the SubmeshInventory) takes them: an extra update() between
        # passes must never silently swallow an invalidation.
        self._dirty_accum = set()
        self._priority_anno_warned = False

    # -- parsing ---------------------------------------------------------------

    @staticmethod
    def _pod_uid(pod):
        meta = pod.get("metadata", {})
        return meta.get("uid") or "{}/{}".format(
            meta.get("namespace", "default"), meta.get("name", "")
        )

    def _parse_pod(self, pod, uid, rv):
        meta = pod.get("metadata", {})
        spec = pod.get("spec", {})
        phase = pod.get("status", {}).get("phase")
        deleting = bool(meta.get("deletionTimestamp"))
        node = spec.get("nodeName") or (
            (spec.get("nodeSelector") or {}).get("kubernetes.io/hostname")
        )
        rec = _PodRec(uid=uid, rv=rv)
        if (
            node
            and phase not in self.exclude_phases
            and not (self.exclude_deleting and deleting)
        ):
            rec.usage_node = node
            rec.requests = gang.pod_requests(spec)
        if phase == "Pending":
            gate = gang.find_gate(pod, self.gate_prefix)
            if gate:
                rec.gated = gang.pod_info(
                    pod, gate,
                    trust_priority_annotation=self.trust_priority_annotation,
                )
                self._maybe_warn_priority_annotation(pod, rec.gated)
        anno = meta.get("annotations") or {}
        if (
            gang.RANK_ANNOTATION in anno
            and gang.GATE_ANNOTATION in anno
            and phase not in ("Succeeded", "Failed")
            and not meta.get("deletionTimestamp")
            and node
        ):
            info = gang.pod_info(
                pod, anno[gang.GATE_ANNOTATION],
                trust_priority_annotation=self.trust_priority_annotation,
            )
            info.bound_node = node
            rec.bound = info
            rec.bound_key = gang.job_key(info)
        return rec

    def _maybe_warn_priority_annotation(self, pod, info):
        if (
            self.trust_priority_annotation
            or self._priority_anno_warned
            or gang.PRIORITY_ANNOTATION not in info.annotations
            or pod.get("spec", {}).get("priority") is not None
        ):
            return
        self._priority_anno_warned = True
        log.warning(
            "ignoring %s on %s/%s (and any further pods): the annotation "
            "is only honored with --trust-priority-annotation",
            gang.PRIORITY_ANNOTATION, info.namespace, info.name,
        )

    # -- incremental usage -----------------------------------------------------

    def _usage_add(self, rec, dirty, sign=1.0):
        if not rec.usage_node:
            return
        per = self._usage.setdefault(rec.usage_node, {})
        for resource, amount in rec.requests.items():
            per[resource] = per.get(resource, 0.0) + sign * amount
        if sign < 0 and all(abs(v) < 1e-12 for v in per.values()):
            # Keep the map bounded on long-lived daemons: a node whose
            # every contribution left again carries no usage entry.
            self._usage.pop(rec.usage_node, None)
        dirty.add(rec.usage_node)

    # -- the per-pass diff -----------------------------------------------------

    def update(self, all_pods, all_nodes):
        """Diff the raw lists against the cached state; returns the set
        of dirty node names (usage, capacity, labels, readiness, or
        membership changed since the last update)."""
        dirty = set()
        parsed = 0
        order = []
        seen = set()
        for pod in all_pods:
            uid = self._pod_uid(pod)
            rv = pod.get("metadata", {}).get("resourceVersion")
            order.append(uid)
            seen.add(uid)
            old = self._pods.get(uid)
            if old is not None and rv is not None and old.rv == rv:
                continue
            rec = self._parse_pod(pod, uid, rv)
            parsed += 1
            if old is not None and (
                old.usage_node != rec.usage_node
                or old.requests != rec.requests
            ):
                self._usage_add(old, dirty, sign=-1.0)
                self._usage_add(rec, dirty)
            elif old is None:
                self._usage_add(rec, dirty)
            self._pods[uid] = rec
        for uid in [u for u in self._pods if u not in seen]:
            old = self._pods.pop(uid)
            self._usage_add(old, dirty, sign=-1.0)
        self._pod_order = order

        node_order = []
        node_seen = set()
        for raw in all_nodes:
            meta = raw.get("metadata", {})
            name = meta.get("name", "")
            rv = meta.get("resourceVersion")
            node_order.append(name)
            node_seen.add(name)
            old = self._nodes.get(name)
            if old is not None and rv is not None and old.rv == rv:
                continue
            self._nodes[name] = _NodeRec(
                name=name, rv=rv,
                labels=meta.get("labels", {}) or {},
                allocatable={
                    k: gang.parse_quantity(v)
                    for k, v in raw.get("status", {})
                    .get("allocatable", {}).items()
                },
                ready=gang.node_ready_and_schedulable(raw),
            )
            self.nodes_parsed += 1
            dirty.add(name)
        for name in [n for n in self._nodes if n not in node_seen]:
            del self._nodes[name]
            dirty.add(name)
        self._node_order = node_order
        self.pods_parsed += parsed
        self.last_parsed = parsed
        self.last_dirty = dirty
        self._dirty_accum |= dirty
        return dirty

    def take_dirty(self):
        """Dirty node names accumulated since the last take — what an
        inventory must invalidate. Consuming, so exactly one consumer
        sees each change however many update() calls happened in
        between."""
        dirty = self._dirty_accum
        self._dirty_accum = set()
        return dirty

    # -- pass views ------------------------------------------------------------

    def gated(self):
        """Pending gated PodInfos in pod-list order — gather_state's
        ``gated`` equivalent."""
        out = []
        for uid in self._pod_order:
            info = self._pods[uid].gated
            if info is not None:
                out.append(info)
        return out

    def bound(self):
        """{gang_key: [PodInfo...]} of bound gang members —
        ``bound_gang_members`` equivalent (keys memoized at parse
        time)."""
        gangs = {}
        for uid in self._pod_order:
            rec = self._pods[uid]
            if rec.bound is not None:
                gangs.setdefault(rec.bound_key, []).append(rec.bound)
        return gangs

    def node_infos(self):
        """NodeInfo views for every ready+schedulable node, in
        node-list order, each with a FRESH ``free`` dict (passes debit
        free in place; a fresh dict per pass makes any debit — bound or
        compensated, applied or dry-run — self-healing). The NodeInfo
        OBJECTS are re-used across passes while the node record is
        unchanged, so per-node label parsing (host coordinates) is paid
        once, not per pass. Labels/allocatable dicts are shared with
        the cache: passes never mutate them."""
        out = []
        for name in self._node_order:
            rec = self._nodes[name]
            if not rec.ready:
                continue
            used = self._usage.get(name, ())
            free = {
                k: v - (used.get(k, 0.0) if used else 0.0)
                for k, v in rec.allocatable.items()
            }
            if rec.info is None:
                rec.info = gang.NodeInfo(
                    name=name, labels=rec.labels,
                    allocatable=rec.allocatable, free=free,
                )
            else:
                rec.info.free = free
            out.append(rec.info)
        return out


# -- cached per-slice sub-mesh views ------------------------------------------


class _SliceState:
    __slots__ = ("name", "version", "members", "sig", "memo_eligible",
                 "memo_place", "memo_frag")

    def __init__(self, name):
        self.name = name
        self.version = 0
        self.members = []
        self.sig = None
        self.memo_eligible = {}  # fp -> (version, {coords: node_name})
        self.memo_place = {}     # (fp, n, pack) -> (version, hosts|None)
        self.memo_frag = None    # (version, free_count, largest)

    def bump(self):
        self.version += 1
        if len(self.memo_eligible) > 64:
            self.memo_eligible.clear()
        if len(self.memo_place) > 256:
            self.memo_place.clear()


class SubmeshInventory:
    """Cached per-slice free sub-mesh views for homogeneous TPU gangs.

    :meth:`observe` refreshes the per-slice node groupings at pass
    start, bumping a slice's content version only when one of its nodes
    is in the dirty set (or its membership changed); :meth:`note_change`
    bumps mid-pass on every debit/credit (bind, unbind, preemption
    simulation kept, defrag move). Eligibility scans and contiguous
    sub-mesh searches are memoized per (slice version, gang shape) — a
    steady-state pass asking "does this still-unplaceable gang fit?"
    costs a dict lookup instead of a backtracking search.

    Placement answers are pinned equivalent to the from-scratch
    ``gang.place_gang_on_slice`` (same slice order, same eligibility
    rule, same grid derivation, same ``find_submesh``)."""

    def __init__(self):
        self._slices = {}
        self._node_slice = {}
        # Slices mutated mid-pass (note_change). Per-pass debits are
        # TRANSIENT — node_infos() rebuilds free from usage next pass —
        # so memos recorded after a mid-pass debit are only valid until
        # the pass ends: a compensated bind failure, a definite reject,
        # or a dry run discards the debits without any pod changing,
        # and the next update() then reports nothing dirty. observe()
        # therefore re-bumps every touched slice unconditionally.
        self._touched = set()
        self.hits = 0
        self.misses = 0

    def observe(self, nodes, dirty=None):
        """Refresh slice groupings from this pass's node list. ``dirty``
        is the ClusterCache's dirty-name set; None invalidates
        everything (the full-rescan posture)."""
        by_slice = {}
        for node in nodes:
            if node.slice_name and node.host_coords is not None:
                by_slice.setdefault(node.slice_name, []).append(node)
        self._node_slice = {}
        for name, members in by_slice.items():
            st = self._slices.get(name)
            if st is None:
                st = self._slices[name] = _SliceState(name)
            sig = tuple(n.name for n in members)
            if (
                dirty is None
                or st.sig != sig
                or name in self._touched
                or any(n.name in dirty for n in members)
            ):
                st.bump()
            st.sig = sig
            st.members = members
            for n in members:
                self._node_slice[n.name] = name
        for gone in [s for s in self._slices if s not in by_slice]:
            del self._slices[gone]
        self._touched.clear()

    def note_change(self, node_name):
        """A node's free view changed mid-pass (debit/credit): the
        slice's cached views are stale — now, and again at the next
        observe() (the debit is transient; see ``_touched``)."""
        slice_name = self._node_slice.get(node_name)
        if slice_name is not None:
            self._slices[slice_name].bump()
            self._touched.add(slice_name)

    @staticmethod
    def _fingerprint(pod):
        return (
            tuple(sorted(pod.requests.items())),
            tuple(sorted(pod.node_selector.items())),
        )

    def _eligible(self, st, pod, fp):
        hit = st.memo_eligible.get(fp)
        if hit is not None and hit[0] == st.version:
            self.hits += 1
            return hit[1]
        self.misses += 1
        eligible = {
            n.host_coords: n.name
            for n in st.members
            if gang._fits(pod, n)
        }
        st.memo_eligible[fp] = (st.version, eligible)
        return eligible

    def place(self, gang_pods, pack=False):
        """Place a homogeneous TPU gang — ``gang.place_gang_on_slice``
        through the cached views. Returns list[Binding] or None."""
        n = len(gang_pods)
        pod0 = gang_pods[0]
        fp = self._fingerprint(pod0)
        for st in sorted(
            self._slices.values(), key=lambda s: (len(s.members), s.name)
        ):
            if len(st.members) < n:
                continue
            eligible = self._eligible(st, pod0, fp)
            if len(eligible) < n:
                continue
            key = (fp, n, pack)
            hit = st.memo_place.get(key)
            if hit is not None and hit[0] == st.version:
                self.hits += 1
                hosts = hit[1]
            else:
                self.misses += 1
                grid = gang.slice_grid(st.members, eligible)
                sub = placement.find_submesh(
                    grid, eligible.keys(), n, pack=pack
                )
                hosts = sub.hosts if sub is not None else None
                st.memo_place[key] = (st.version, hosts)
            if hosts is None:
                continue
            return [
                gang.Binding(pod, eligible[coords], rank, st.name)
                for rank, (pod, coords) in enumerate(
                    zip(gang_pods, hosts)
                )
            ]
        return None

    # -- fragmentation ---------------------------------------------------------

    def fragmentation(self):
        """Fleet fragmentation score over the observed slices, with the
        per-slice (free hosts, largest contiguous sub-mesh) memoized per
        content version. See :func:`fragmentation_score`."""
        free_total = 0
        largest_total = 0
        for st in self._slices.values():
            memo = st.memo_frag
            if memo is not None and memo[0] == st.version:
                _, free_count, largest = memo
            else:
                free_count, largest = _slice_frag(st.members)
                st.memo_frag = (st.version, free_count, largest)
            free_total += free_count
            largest_total += largest
        if free_total == 0:
            return 0.0
        return 1.0 - largest_total / free_total


def _fully_free(node):
    """A host counts as free inventory when its TPU capacity is wholly
    unclaimed (gangs place one pod per host; a partially claimed host
    cannot anchor a new sub-mesh)."""
    alloc = node.allocatable.get(RESOURCE_NAME, 0.0)
    return alloc > 0 and node.free.get(RESOURCE_NAME, 0.0) >= alloc - 1e-9


def largest_free_submesh(grid, free_coords):
    """Volume of the largest contiguous axis-aligned sub-grid whose
    hosts are all free. Descending scan: contiguity is not monotone in
    volume, so each candidate volume is checked independently."""
    free = set(free_coords)
    for volume in range(len(free), 0, -1):
        if placement.find_submesh(grid, free, volume) is not None:
            return volume
    return 0


def _slice_frag(members):
    free_coords = [n.host_coords for n in members if _fully_free(n)]
    if not free_coords:
        return 0, 0
    grid = gang.slice_grid(members, free_coords)
    return len(free_coords), largest_free_submesh(grid, free_coords)


def fragmentation_score(nodes):
    """0.0 = every slice's free hosts form one contiguous sub-mesh
    (or nothing is free); →1.0 = free capacity is shattered into
    fragments no large gang can use. Defined as
    ``1 − Σ_slices largest_free_submesh / Σ_slices free_hosts``."""
    by_slice = {}
    for node in nodes:
        if node.slice_name and node.host_coords is not None:
            by_slice.setdefault(node.slice_name, []).append(node)
    free_total = 0
    largest_total = 0
    for members in by_slice.values():
        free_count, largest = _slice_frag(members)
        free_total += free_count
        largest_total += largest
    if free_total == 0:
        return 0.0
    return 1.0 - largest_total / free_total


# -- budgeted defragmentation --------------------------------------------------


@dataclasses.dataclass
class DefragMove:
    """One planned lossless gang relocation: evict (the same lossless
    delete/recreate-gated machinery preemption uses — the controller or
    recreate restores the pods Pending+gated) and let the next pass's
    pack placement land the gang on ``bindings``' nodes."""

    gang_key: tuple
    members: list          # bound PodInfos, gang order
    from_nodes: list       # nodes vacated
    to_nodes: list         # predicted re-placement, rank order
    score_before: float
    score_after: float


def plan_defrag(nodes, bound, budget=1, pack=True):
    """Plan up to ``budget`` gang moves that strictly improve the fleet
    fragmentation score.

    Simulates, against a scratch copy of ``nodes``: evict one bound TPU
    gang (credit its usage back), re-place it with the SAME pack
    placement policy the next scheduling pass runs, and keep the move
    only when the resulting fragmentation score strictly improves.
    Smallest gangs first — they are the cheapest to move and the usual
    fragmenters. Accepted moves compound: each next candidate is judged
    against the already-compacted simulation.

    The daemon executes a move by evicting the gang (lossless: pods
    return Pending+gated); the next pass re-places it — deterministic
    pack placement reproduces the simulated target unless the cluster
    changed meanwhile, in which case the gang simply competes like any
    pending gang (it can never be lost, only requeued)."""
    if budget <= 0 or not bound:
        return []
    scratch = gang._copy_nodes(nodes)
    by_name = {n.name: n for n in scratch}
    # Per-slice (free hosts, largest contiguous sub-mesh) maintained
    # incrementally: a move only touches the slice it vacates and the
    # slice it lands on, so only those are re-scored per candidate —
    # a full-fleet rescan per candidate would re-add O(fleet) work to
    # every defrag-armed pass.
    by_slice = {}
    slice_of = {}
    for node in scratch:
        if node.slice_name and node.host_coords is not None:
            by_slice.setdefault(node.slice_name, []).append(node)
            slice_of[node.name] = node.slice_name
    stats = {name: _slice_frag(ms) for name, ms in by_slice.items()}
    free_total = sum(f for f, _ in stats.values())
    largest_total = sum(l for _, l in stats.values())

    def current_score():
        if free_total == 0:
            return 0.0
        return 1.0 - largest_total / free_total

    score = current_score()
    if score <= 1e-9:
        return []
    moves = []
    candidates = sorted(bound.items(), key=lambda kv: (len(kv[1]), kv[0]))
    for key, members in candidates:
        if len(moves) >= budget:
            break
        members = sorted(
            members, key=lambda p: (p.completion_index, p.name)
        )
        if not any(p.tpu_request for p in members):
            continue  # DCN gangs don't fragment ICI meshes
        if not all(p.bound_node in by_name for p in members):
            continue  # partially off-inventory (cordoned/vanished node)
        # The lossless eviction recreates pods WITHOUT the bind-time
        # hostname pin (k8s.recreate_gated_pod strips it); the move
        # simulation must place the same unpinned pods, or every gang
        # would be stuck to its current node.
        unpinned = [
            dataclasses.replace(p, node_selector={
                k: v for k, v in p.node_selector.items()
                if k != "kubernetes.io/hostname"
            })
            for p in members
        ]
        journal = []
        gang._credit_victims([(key, members)], by_name, journal=journal)
        bindings = gang._place_gang(unpinned, scratch, pack=pack)
        if bindings is None:
            gang._rollback(journal)
            continue
        if {b.node for b in bindings} == {p.bound_node for p in members}:
            gang._rollback(journal)
            continue  # placement keeps it where it is: no-op move
        gang._debit(bindings, by_name, journal=journal)
        touched = {
            slice_of[n]
            for p in members for n in (p.bound_node,)
            if n in slice_of
        } | {
            slice_of[b.node] for b in bindings if b.node in slice_of
        }
        old_stats = {name: stats[name] for name in touched}
        for name in touched:
            fresh = _slice_frag(by_slice[name])
            free_total += fresh[0] - stats[name][0]
            largest_total += fresh[1] - stats[name][1]
            stats[name] = fresh
        new_score = current_score()
        if new_score < score - 1e-9:
            moves.append(DefragMove(
                gang_key=key,
                members=members,
                from_nodes=[p.bound_node for p in members],
                to_nodes=[b.node for b in bindings],
                score_before=score,
                score_after=new_score,
            ))
            score = new_score
            journal.clear()  # keep the simulated state
        else:
            gang._rollback(journal)
            for name, old in old_stats.items():
                free_total += old[0] - stats[name][0]
                largest_total += old[1] - stats[name][1]
                stats[name] = old
    return moves
