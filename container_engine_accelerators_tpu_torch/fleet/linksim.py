# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Hermetic multi-rank lockstep-link harness and the link chaos drill.

Port of ``container_engine_accelerators_tpu/fleet/linksim.py`` on the
port's engines. The lockstep engine link
(``models/serve_cli.LockstepEngineLink``) is the one place a
tensor-parallel world can fail silently: a vanished or wedged rank would
leave every other rank blocked inside a broadcast. This module drives the
supervised link end to end with no second process: N in-process ranks (a
real ``ContinuousEngine`` scheduling on rank 0 and
``engine_follower_loop`` replaying on the others, each over the fake
device seams of ``fleet/sim.make_fake_engine``) over a
:class:`LoopbackTransport`, which has the real broadcast's collective
property (one rank not consuming eventually blocks the leader) plus
bounded waits, so wedges are detectable in the process.

The **link chaos drill** (:func:`run_link_drill`) has JAX's four phases:

  * **byte identity**: leader and follower ranks serve a shared-prefix
    mix (radix-hit re-admissions included) with greedy outputs equal to
    a single-rank paged engine's, and every follower's mirrored page
    tables, pool and radix counters equal the leader's after quiesce;
  * **follower kill**: a ``follower_vanish`` fault at the
    ``serving.link`` site kills a follower mid-decode: the leader is
    never blocked past ``timeout_s`` (``link_wedged{rank, op_seq}``,
    badput charged by the goodput ledger), the request in flight
    completes, the fleet reactor (``faults/reactor.FleetReactor``)
    cordons the dead rank's node and drains its gang against the
    in-process Kubernetes API (``testing/kubeapi.py``), the gang re-places
    on healthy capacity, and a bounded restart re-joins the rank
    (handshake and announced pool reset);
  * **corrupt broadcast**: a ``corrupt_payload`` fault delivers bytes
    that no longer match the announced digest: every follower detects
    ``link_desync`` and aborts before any divergent dispatch;
  * **leader wedge**: a ``delay`` fault stalls a collective past the
    watchdog's deadline: ``link_wedged`` fires from the watchdog thread
    (the real transport's path, where the blocked call cannot report).

Deterministic in ``CHAOS_SEED`` (requests run one after another; fault
schedules are hit-indexed). CLI::

    python -m container_engine_accelerators_tpu_torch.fleet.linksim \
        --followers 2 --requests 12 --json /tmp/link-verdict.json
"""

import argparse
import json
import logging
import os
import queue
import sys
import threading
import time

import numpy as np

from container_engine_accelerators_tpu_torch import faults
from container_engine_accelerators_tpu_torch.fleet import sim
from container_engine_accelerators_tpu_torch.models import serve_cli
from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import goodput as obs_goodput
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger(__name__)

# Per-rank node names (the TPU_WORKER_HOSTNAMES contract): link events
# carry them so the fleet reactor can cordon the culprit's node.
def _node_name(rank):
    return f"link-node-{rank}"


class _FollowerKilled(Exception):
    """The harness killed this rank (follower_vanish): its thread stops
    consuming — exactly what the leader's wedge detection must bound."""


class _FollowerView:
    """One follower rank's receive side of the loopback transport."""

    def __init__(self, transport, rank):
        self._t = transport
        self.rank = rank

    def recv(self, template, timeout_s=None):
        """Blocking receive; ``timeout_s`` (the link passes it only on
        the mid-op payload phase, at 5x the link timeout) bounds a
        vanished-leader wait with a typed
        :class:`~container_engine_accelerators_tpu_torch.models.serve_cli
        .LinkWedgedError` — the watchdog's ``link_wedged`` event has
        already fired by then (4x backstop)."""
        del template  # loopback delivers the real arrays
        q = self._t._queue(self.rank)
        deadline = (
            time.monotonic() + timeout_s if timeout_s else None
        )
        while True:
            if self._t.is_killed(self.rank):
                raise _FollowerKilled(f"rank {self.rank} killed")
            if deadline is not None and time.monotonic() > deadline:
                raise serve_cli.LinkWedgedError(
                    f"rank {self.rank}: no payload within "
                    f"{timeout_s:.2f}s (leader vanished mid-op)"
                )
            try:
                return q.get(timeout=0.05)
            except queue.Empty:
                continue


class LoopbackTransport:
    """In-process broadcast with the real link's collective property.

    ``send`` delivers one payload to every live follower's bounded
    queue: a rank that stops consuming blocks the leader within
    ``maxsize`` broadcasts — bounded by ``timeout_s``, after which the
    rank is marked dead (returned to the link, which emits
    ``link_wedged`` and keeps serving the live ranks; the supervisor
    restarts the dead one). ``handles_timeout`` tells the link its
    watchdog thread is only the 4x backstop here (a send legitimately
    blocks ~timeout per dead rank before the culprit report lands) —
    the transport itself names the culprit rank."""

    handles_timeout = True

    def __init__(self, n_followers, maxsize=8):
        self.n_followers = n_followers
        self._maxsize = maxsize
        # Keyed by LINK rank (followers are ranks 1..N).
        self._queues = {
            r: queue.Queue(maxsize=maxsize)
            for r in range(1, n_followers + 1)
        }
        self._alive = {r: True for r in range(1, n_followers + 1)}
        self._killed = {r: False for r in range(1, n_followers + 1)}
        self._lock = threading.Lock()

    def _queue(self, rank):
        with self._lock:
            return self._queues[rank]

    def is_killed(self, rank):
        return self._killed.get(rank, False)

    def kill(self, rank):
        """follower_vanish: the rank stops consuming (its thread exits
        at its next recv poll); the leader discovers the wedge at the
        queue bound."""
        if rank in self._killed:
            self._killed[rank] = True

    def revive(self, rank):
        """Supervisor restart: fresh queue, rank live again; the new
        replayer adopts the stream at the next announced op."""
        with self._lock:
            self._queues[rank] = queue.Queue(maxsize=self._maxsize)
        self._killed[rank] = False
        self._alive[rank] = True

    def follower_view(self, rank):
        return _FollowerView(self, rank)

    def send(self, payload, timeout_s):
        """Deliver to every live rank; returns the ranks that timed
        out (newly dead — dropped from future delivery)."""
        wedged = []
        for r in sorted(self._queues):
            if not self._alive[r]:
                continue
            q = self._queue(r)
            try:
                q.put(payload, timeout=timeout_s)
            except queue.Full:
                self._alive[r] = False
                wedged.append(r)
        return wedged


class LinkRank:
    """One follower rank: a real paged ``ContinuousEngine`` (fake-jit
    device calls, loop NOT started) driven by the real
    ``engine_follower_loop`` over its loopback link view."""

    def __init__(self, rank, transport, timeout_s, n_ranks,
                 max_slots=4, chunk_sleep_s=0.0):
        self.rank = rank
        self.registry = obs_metrics.Registry()
        self.events = obs_events.EventStream(
            "serve", host=_node_name(rank), registry=self.registry,
        )
        self.engine = sim.make_fake_engine(
            kv_cache="paged", max_slots=max_slots,
            chunk_sleep_s=chunk_sleep_s, start_loop=False,
        )
        self.link = serve_cli.LockstepEngineLink(
            self.engine.cfg, max_slots,
            transport=transport.follower_view(rank),
            timeout_s=timeout_s, rank=rank,
            rank_hosts=[_node_name(r) for r in range(n_ranks)],
            events=self.events, registry=self.registry,
        )
        self.outcome = None  # "shutdown" | "killed" | "desync" | ...
        self.error = None
        self.thread = threading.Thread(
            target=self._run, daemon=True, name=f"link-rank-{rank}"
        )

    def start(self):
        self.thread.start()
        return self

    def _run(self):
        try:
            serve_cli.engine_follower_loop(self.engine, self.link)
            self.outcome = "shutdown"
        except _FollowerKilled:
            self.outcome = "killed"
        except serve_cli.LinkWedgedError as e:
            self.outcome = "wedged"
            self.error = str(e)
        except serve_cli.LinkDesyncError as e:
            self.outcome = "desync"
            self.error = str(e)
        except serve_cli.LinkConfigMismatch as e:
            self.outcome = "config_mismatch"
            self.error = str(e)
        except Exception as e:  # noqa: BLE001 - verdict records it
            self.outcome = "error"
            self.error = str(e)


class LinkHarness:
    """Leader + N follower ranks over one loopback transport.

    The leader is a real paged ``ContinuousEngine`` (fake-jit) with the
    supervised :class:`~container_engine_accelerators_tpu_torch.models
    .serve_cli.LockstepEngineLink` attached — every page-table delta
    and device dispatch is announced; followers replay them."""

    def __init__(self, n_followers=2, timeout_s=0.5, max_slots=4,
                 max_restarts=3, chunk_sleep_s=0.0):
        n_ranks = n_followers + 1
        self.n_ranks = n_ranks
        self.timeout_s = timeout_s
        self.max_slots = max_slots
        self.max_restarts = max_restarts
        self.chunk_sleep_s = chunk_sleep_s
        self.restarts = 0
        self.wedges = []  # (rank, op_seq) from on_wedge
        self.transport = LoopbackTransport(n_followers)
        self.registry = obs_metrics.Registry()
        self.events = obs_events.EventStream(
            "serve", host=_node_name(0), registry=self.registry,
        )
        self.ranks = {
            r: LinkRank(r, self.transport, timeout_s, n_ranks,
                        max_slots=max_slots,
                        chunk_sleep_s=chunk_sleep_s).start()
            for r in range(1, n_ranks)
        }
        self.link = serve_cli.LockstepEngineLink(
            sim._sim_cfg(), max_slots, transport=self.transport,
            timeout_s=timeout_s, rank=0,
            rank_hosts=[_node_name(r) for r in range(n_ranks)],
            events=self.events, registry=self.registry,
            on_wedge=self._on_wedge,
        )
        self.engine = sim.make_fake_engine(
            kv_cache="paged", max_slots=max_slots, link=self.link,
            events=self.events, registry=self.registry,
            chunk_sleep_s=chunk_sleep_s,
        )
        # Event streams of replaced (dead) rank incarnations: their
        # desync/wedge records stay in the verdict.
        self._archived = []

    def _on_wedge(self, rank, op_seq):
        self.wedges.append((rank, op_seq))

    def generate(self, prompt, max_new):
        return self.engine.generate([list(prompt)], max_new)[0]

    def link_events(self, kind=None):
        out = []
        streams = [self.events] + [
            lr.events for lr in self.ranks.values()
        ] + self._archived
        for kd in ([kind] if kind else ["link_wedged", "link_desync"]):
            for stream in streams:
                out.extend(stream.events(kind=kd))
        return sorted(out, key=lambda r: r.get("ts", 0.0))

    def quiesce(self, timeout=10.0):
        """Wait until the leader is idle and every live follower has
        drained its queue (mirror-state comparisons need both sides at
        the same stream position)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = self.engine.stats()
            busy = st["occupied_slots"] or st["queue_depth"]
            lag = any(
                not self.transport._queue(r).empty()
                for r, lr in self.ranks.items()
                if lr.outcome is None
            )
            if not busy and not lag:
                # One settle tick: the follower may still be inside
                # its last dispatch after the queue emptied.
                time.sleep(0.05)
                return True
            time.sleep(0.01)
        return False

    def live_ranks(self):
        return {r: lr for r, lr in self.ranks.items()
                if lr.outcome is None}

    def mirror_errors(self):
        """Compare every live follower's replayed KV/device state with
        the leader's: page tables, pool free count, radix index size,
        and the device token mirror must be byte-identical — the
        evidence the replay ran byte-identical paged programs.
        (Structural state only: cumulative hit counters legitimately
        differ across a rank restart.)"""
        errors = []
        lead = self.engine
        for r, lr in sorted(self.live_ranks().items()):
            eng = lr.engine
            if not np.array_equal(np.asarray(lead.kv.tables),
                                  np.asarray(eng.kv.tables)):
                errors.append(f"rank {r}: page tables diverged")
            if lead.kv.free_blocks() != eng.kv.free_blocks():
                errors.append(
                    f"rank {r}: pool free {eng.kv.free_blocks()} != "
                    f"leader {lead.kv.free_blocks()}"
                )
            if lead.kv.cached_blocks() != eng.kv.cached_blocks():
                errors.append(
                    f"rank {r}: radix index size diverged "
                    f"({eng.kv.cached_blocks()} != "
                    f"{lead.kv.cached_blocks()})"
                )
            if not np.array_equal(np.asarray(lead.last_dev),
                                  np.asarray(eng.last_dev)):
                errors.append(f"rank {r}: last_dev diverged")
        return errors

    def restart_rank(self, rank, timeout=10.0):
        """Bounded supervisor-style restart. Order matters: FIRST the
        leader announces the re-handshake + pool reset (delivered to
        the ranks still live; the dead rank is skipped), THEN the rank
        revives with a fresh queue and a fresh engine — so the new
        incarnation's empty manager matches the leader's just-reset
        one and it adopts the stream with no mid-stream hazard
        window."""
        if self.restarts >= self.max_restarts:
            raise RuntimeError(
                f"restart budget ({self.max_restarts}) exhausted"
            )
        self.restarts += 1
        done = self.engine._link_rejoins_done
        self.engine.rejoin_link()
        deadline = time.monotonic() + timeout
        while (self.engine._link_rejoins_done == done
               and time.monotonic() < deadline):
            time.sleep(0.01)
        if self.engine._link_rejoins_done == done:
            raise RuntimeError("link rejoin never applied")
        old = self.ranks[rank]
        self._archived.append(old.events)
        self.transport.revive(rank)
        self.ranks[rank] = LinkRank(
            rank, self.transport, self.timeout_s, self.n_ranks,
            max_slots=self.max_slots,
            chunk_sleep_s=self.chunk_sleep_s,
        ).start()
        return self.ranks[rank]

    def shutdown(self):
        self.link.announce(serve_cli._OP_SHUTDOWN)
        for lr in self.ranks.values():
            lr.thread.join(timeout=2.0)


# -- the reactor / re-place phase (conformant in-process kube API) ------------


def _raw_gang_pod(name, rank, node, size):
    """A BOUND bare gang member (the lossless-drain hard case),
    annotated exactly as the gang scheduler binds."""
    from container_engine_accelerators_tpu_torch.scheduler import gang

    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {
            "name": name, "namespace": "default",
            "labels": {gang.JOB_NAME_LABEL: "link-serve",
                       gang.COMPLETION_INDEX_LABEL: str(rank)},
            "annotations": {
                gang.RANK_ANNOTATION: str(rank),
                gang.GATE_ANNOTATION:
                    "gke.io/topology-aware-auto-link-serve",
                gang.WORKER_COUNT_ANNOTATION: str(size),
            },
        },
        "spec": {
            "containers": [{
                "name": "main",
                "resources": {"requests": {
                    "cpu": "1", "memory": "1Gi",
                    "google.com/tpu": "4",
                }},
            }],
            "nodeSelector": {"kubernetes.io/hostname": node},
        },
        "status": {"phase": "Running"},
    }


def _raw_link_node(name, coords):
    from container_engine_accelerators_tpu_torch.topology import (
        labels as topo_labels,
    )

    return {
        "apiVersion": "v1", "kind": "Node",
        "metadata": {
            "name": name,
            "labels": dict(topo_labels.ici_labels(
                "link-slice", "v5litepod-16", 0, coords,
            )),
        },
        "spec": {},
        "status": {
            "allocatable": {
                "cpu": "8", "memory": "64Gi", "google.com/tpu": "4",
            },
            "conditions": [{"type": "Ready", "status": "True"}],
        },
    }


def _replace_gangs(client):
    """Minimal re-place pass (the daemon's placement core): bind every
    complete gated gang onto a contiguous sub-mesh of the healthy
    (un-cordoned) inventory. Returns the bound node names."""
    from container_engine_accelerators_tpu_torch.scheduler import gang

    infos = []
    for pod in client.list_pods():
        gate = gang.find_gate(pod)
        if gate:
            infos.append(gang.pod_info(pod, gate))
    nodes = [
        gang.node_info(n) for n in client.list_nodes()
        if gang.node_ready_and_schedulable(n)
    ]
    placed = []
    for _key, members in sorted(gang.group_gangs(infos).items()):
        bindings = gang.place_gang_on_slice(members, nodes)
        if not bindings:
            continue
        for b in bindings:
            client.bind_gated_pod(
                b.pod.namespace, b.pod.name, b.node, b.pod.gate,
            )
            placed.append(b.node)
    return placed


def _reactor_phase(link_records, wedged_rank, gang_size, failures,
                   tag):
    """Feed the drill's link events to a real FleetReactor against the
    conformant in-process kube API: the wedged rank's node is
    cordoned, its whole gang drains losslessly, and the re-place pass
    lands it on healthy capacity."""
    from container_engine_accelerators_tpu_torch.faults import reactor
    from container_engine_accelerators_tpu_torch.scheduler.k8s import (
        KubeClient,
    )
    from container_engine_accelerators_tpu_torch.testing import kubeapi

    server = kubeapi.KubeApiServer().start()
    try:
        for i in range(4):
            server.apply(_raw_link_node(_node_name(i),
                                        (i // 2, i % 2)))
        for rank in range(gang_size):
            server.apply(_raw_gang_pod(
                f"w-{rank}", rank, _node_name(rank), gang_size,
            ))
        client = KubeClient(base_url=server.url, ca_cert=False)
        r = reactor.FleetReactor(client)
        actions = [r.process(rec) for rec in link_records]
        if "cordoned" not in actions:
            failures.append(f"reactor never cordoned on link events "
                            f"{tag}")
            return
        node = server.get("nodes", _node_name(wedged_rank))
        if not node["spec"].get("unschedulable"):
            failures.append(
                f"wedged rank's node not cordoned {tag}"
            )
        for rank in range(gang_size):
            pod = server.get("pods", f"w-{rank}", namespace="default")
            if pod is None:
                failures.append(f"pod w-{rank} lost in drain {tag}")
                continue
            gates = [g["name"] for g in
                     pod["spec"].get("schedulingGates", [])]
            if not gates:
                failures.append(
                    f"pod w-{rank} not re-gated by the drain {tag}"
                )
        placed = _replace_gangs(client)
        if len(placed) != gang_size:
            failures.append(
                f"gang not re-placed ({placed}) {tag}"
            )
        if _node_name(wedged_rank) in placed:
            failures.append(
                f"gang re-placed onto the cordoned node {tag}"
            )
    finally:
        server.stop()


# -- the drill ----------------------------------------------------------------


def _verdict_counts(records):
    """Fold the link events into the verdict (the consumer side of the
    link event contract: rank + op_seq attribution, stalled seconds)."""
    out = {"wedges": 0, "desyncs": 0, "wedged_ranks": [],
           "desync_ranks": [], "stalled_s": 0.0}
    for rec in records:
        kind = rec.get("kind") or rec.get("event")
        if kind == "link_wedged":
            out["wedges"] += 1
            out["wedged_ranks"].append(rec.get("rank"))
            out["stalled_s"] += float(rec.get("stalled_s") or 0.0)
            out["last_wedged_op_seq"] = rec.get("op_seq")
        elif kind == "link_desync":
            out["desyncs"] += 1
            out["desync_ranks"].append(rec.get("rank"))
            out["last_desync_op_seq"] = rec.get("op_seq")
    return out


def _drill_cases(rng, n):
    """Shared-prefix mix with REPEATS (radix-hit re-admissions), inside
    the sim engine's 64-token budget."""
    prefix = [(j % 9) + 1 for j in range(16)]  # 4 full blocks (bs=4)
    cases = []
    for i in range(n):
        kind = rng.randint(3)
        if kind == 0:
            p = prefix + rng.randint(1, 30, 1 + rng.randint(4)).tolist()
        elif kind == 1 and cases:
            p = list(cases[rng.randint(len(cases))])  # exact repeat
        else:
            p = rng.randint(1, 30, 2 + rng.randint(8)).tolist()
        cases.append(p[:40])
    return cases


def run_link_drill(n_followers=2, requests=12, max_new=6,
                   timeout_s=0.5, seed=None):
    """The link chaos drill; returns the verdict dict
    (``verdict["pass"]`` is the acceptance bit; failed checks are in
    ``verdict["failures"]`` with the seed)."""
    seed = int(os.environ.get("CHAOS_SEED", "0")) if seed is None \
        else seed
    tag = f"(chaos seed={seed}; rerun with CHAOS_SEED={seed})"
    failures = []
    faults.disarm()
    rng = np.random.RandomState(seed)
    cases = _drill_cases(rng, requests)

    # Single-host paged oracle: the byte-identity reference the
    # acceptance names (ROADMAP: "multi-host drill byte-exact in paged
    # mode").
    solo = sim.make_fake_engine(kv_cache="paged", max_slots=4)
    solo_out = [solo.generate([c], max_new)[0] for c in cases]

    h = LinkHarness(n_followers=n_followers, timeout_s=timeout_s)

    # -- phase A: byte identity + mirrored replay -------------------------
    link_out = [h.generate(c, max_new) for c in cases]
    for i, (want, got) in enumerate(zip(solo_out, link_out)):
        if want != got or got != sim.expected_output(cases[i],
                                                    max_new):
            failures.append(
                f"case {i}: multi-host output diverged from the "
                f"single-host paged engine {tag}"
            )
    if h.engine.kv.hit_tokens == 0:
        failures.append(f"no radix-hit re-admissions exercised {tag}")
    if solo.kv.hit_tokens != h.engine.kv.hit_tokens:
        failures.append(
            f"leader radix hits {h.engine.kv.hit_tokens} != "
            f"single-host {solo.kv.hit_tokens} {tag}"
        )
    if not h.quiesce():
        failures.append(f"phase A never quiesced {tag}")
    failures.extend(h.mirror_errors())

    # -- phase B: follower killed mid-decode ------------------------------
    victim = 1
    faults.arm(faults.FaultPlan([
        {"kind": "follower_vanish", "site": serve_cli.LINK_FAULT_SITE,
         "at": 6, "count": 1, "node": str(victim)},
    ], seed=seed))
    res = {}
    t = threading.Thread(
        target=lambda: res.update(out=h.generate([3, 4, 5], 24)),
        daemon=True,
    )
    t0 = time.monotonic()
    t.start()
    t.join(timeout=60)
    wall = time.monotonic() - t0
    faults.disarm()
    if t.is_alive() or res.get("out") != sim.expected_output(
        [3, 4, 5], 24
    ):
        failures.append(
            f"request through the killed-follower window hung or "
            f"diverged {tag}"
        )
    wedged = h.link_events("link_wedged")
    if not any(rec.get("rank") == victim for rec in wedged):
        failures.append(f"no link_wedged for rank {victim} {tag}")
    # The whole stall the leader ever paid for the vanished rank is
    # bounded by the per-collective timeout (plus live serving time).
    if wedged and wall > 30 * timeout_s + 10:
        failures.append(
            f"leader blocked {wall:.1f}s — not bounded by "
            f"timeout {tag}"
        )
    # Badput: the goodput ledger charges the stall to `wedged`.
    totals = obs_goodput.build_ledger(
        h.events.events()
    ).ledger.totals()
    if not totals["wedged"] > 0:
        failures.append(f"link_wedged not charged to badput {tag}")
    # Reactor: cordon + lossless gang drain + re-place, driven by the
    # culprit-attributed events (an observer self-report — the
    # watchdog backstop under extreme host load — names its own node;
    # cordoning it too would be a different, load-dependent drill).
    _reactor_phase(
        [rec for rec in h.link_events("link_wedged")
         if rec.get("rank") == victim],
        victim, 2, failures, tag,
    )
    # Bounded supervisor restart: the rank re-joins via handshake +
    # announced reset, then serves again.
    h.restart_rank(victim)
    rejoin_out = h.generate([7, 8], 6)
    if rejoin_out != sim.expected_output([7, 8], 6):
        failures.append(f"post-restart output diverged {tag}")
    if not h.quiesce():
        failures.append(f"post-restart never quiesced {tag}")
    failures.extend(
        f"post-restart {e}" for e in h.mirror_errors()
    )
    if h.ranks[victim].outcome is not None:
        failures.append(
            f"restarted rank died again: "
            f"{h.ranks[victim].outcome} {tag}"
        )

    # -- phase C: corrupted broadcast -> desync before dispatch -----------
    faults.arm(faults.FaultPlan([
        {"kind": "corrupt_payload", "site": serve_cli.LINK_FAULT_SITE,
         "at": 4, "count": 1},
    ], seed=seed))
    out_c = h.generate([9, 10, 11], 12)
    faults.disarm()
    if out_c != sim.expected_output([9, 10, 11], 12):
        failures.append(
            f"leader output diverged under the corrupt broadcast "
            f"{tag}"
        )
    desyncs = h.link_events("link_desync")
    if not desyncs:
        failures.append(f"corrupt broadcast not detected {tag}")
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not all(
        lr.outcome is not None for lr in h.ranks.values()
    ):
        time.sleep(0.02)
    desynced = [r for r, lr in sorted(h.ranks.items())
                if lr.outcome == "desync"]
    if not desynced:
        failures.append(
            f"no follower aborted fail-fast on the corrupt "
            f"broadcast {tag}"
        )
    # Restart every dead rank (still within the bounded budget).
    for r, lr in sorted(h.ranks.items()):
        if lr.outcome is not None:
            h.restart_rank(r)
    out_after = h.generate([12, 13], 6)
    if out_after != sim.expected_output([12, 13], 6):
        failures.append(f"post-desync-restart output diverged {tag}")
    if not h.quiesce():
        failures.append(f"post-desync never quiesced {tag}")
    failures.extend(
        f"post-desync {e}" for e in h.mirror_errors()
    )

    # -- phase D: the leader's own collective stalls ----------------------
    wedges_before = len(h.link_events("link_wedged"))
    faults.arm(faults.FaultPlan([
        # 6x the timeout: comfortably past the loopback watchdog's 4x
        # backstop deadline, so the fire is deterministic.
        {"kind": "delay", "site": serve_cli.LINK_FAULT_SITE,
         "at": 3, "count": 1, "delay_s": 6.0 * timeout_s},
    ], seed=seed))
    out_d = h.generate([14, 15, 16], 8)
    faults.disarm()
    if out_d != sim.expected_output([14, 15, 16], 8):
        failures.append(f"output diverged under the delay fault {tag}")
    leader_wedges = [
        rec for rec in h.link_events("link_wedged")[wedges_before:]
        if rec.get("rank") == 0
    ]
    if not leader_wedges:
        failures.append(
            f"stalled leader collective never tripped the watchdog "
            f"{tag}"
        )

    h.shutdown()
    # Re-ledger over the FULL run: phase C/D wedges landed after the
    # phase-B badput check above, and the verdict must account them.
    final_totals = obs_goodput.build_ledger(
        h.events.events()
    ).ledger.totals()
    verdict = {
        "pass": not failures,
        "failures": failures,
        "seed": seed,
        "requests": requests,
        "followers": n_followers,
        "restarts": h.restarts,
        "rank_outcomes": {
            r: lr.outcome for r, lr in sorted(h.ranks.items())
        },
        "radix_hit_tokens": int(h.engine.kv.hit_tokens),
        "link": _verdict_counts(
            h.link_events()
        ),
        "badput_wedged_s": round(final_totals["wedged"], 6),
    }
    return verdict


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--followers", type=int, default=2,
                   help="follower ranks replaying the leader's op "
                        "stream (leader is rank 0)")
    p.add_argument("--requests", type=int, default=12,
                   help="byte-identity request mix size (shared-prefix "
                        "cases with exact repeats, vs the single-host "
                        "paged oracle)")
    p.add_argument("--max-new", type=int, default=6,
                   help="tokens generated per byte-identity request")
    p.add_argument("--timeout-s", type=float, default=0.5,
                   help="the drill link's --link-timeout-s: a killed "
                        "follower must never block the leader past it")
    p.add_argument("--json", default="",
                   help="write the verdict JSON here as well")
    args = p.parse_args(argv)
    verdict = run_link_drill(
        n_followers=args.followers, requests=args.requests,
        max_new=args.max_new, timeout_s=args.timeout_s,
    )
    print(json.dumps(verdict, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(verdict, f, indent=2)
    if not verdict["pass"]:
        for failure in verdict["failures"]:
            log.error("FAIL: %s", failure)
        return 1
    log.info(
        "link chaos drill passed: %d wedges, %d desyncs, %d restarts, "
        "%d radix-hit tokens",
        verdict["link"]["wedges"], verdict["link"]["desyncs"],
        verdict["restarts"], verdict["radix_hit_tokens"],
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
