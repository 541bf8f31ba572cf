# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Hermetic multi-replica harness: the whole fleet tier, zero compiles.

Port of ``container_engine_accelerators_tpu/fleet/sim.py``. Runs N real
port ``ContinuousEngine`` replicas with their device seams replaced by a
deterministic decode (next token = (previous + 1) mod vocab), following
the port's seam contracts as ``kvcache/hostbench.py`` does, a real
:class:`~container_engine_accelerators_tpu_torch.fleet.router.ReplicaRouter`
over in-process transports, a real burn-rate
:class:`~container_engine_accelerators_tpu_torch.obs.alerts.AlertEvaluator`
on a simulated clock, and a real
:class:`~container_engine_accelerators_tpu_torch.fleet.autoscaler.Autoscaler`
whose scale-out placement goes through the gang scheduler's
``place_gang_on_slice`` over a synthetic node inventory
(``scheduler/gang.py``).

The engines run on the CPU, by this module's own choice and not as a
fallback: every device seam is a fake, so they do no device work at all.
What stays real is the engine's host side (slots, retirement,
migration, sheds; paged: the block pool, the radix prefix index, the
page tables and the async double-buffered loop) and its small paged
pools, which a KV handoff exports and installs byte for byte (the
port's handoff refuses a block without device bytes).

The **storm drill** (:func:`run_drill`) is the tier's acceptance
scenario: a request storm across 3 replicas, one replica killed
mid-flight by a ``fault_plan`` at the ``fleet.replica`` site, asserting

  * every accepted request retires **exactly once** (zero lost, no
    duplicate retires — re-issue is at-most-once and idempotency-keyed)
    with byte-exact greedy output;
  * the router **ejects** the dead replica and **re-admits** it on
    recovery;
  * the autoscaler **scales out** on the fired burn-rate alert, then
    **drains and scales in** on sustained idle.

A killed replica fails on the port's own paths: a seam that raises at
dispatch fails the call's rows and keeps the pools, and the router
re-issues them elsewhere (JAX's engine likewise fails the rows; the
verdict counts agree, ``tests/test_torch_fleet_sim.py``).

:func:`run_membership_storm` is the membership churn drill (prefix hits
survive through KV handoff). Deterministic under ``CHAOS_SEED`` (the
fault plan's schedule and the simulated alert/autoscaler clock are
seeded/scripted; assertions are structural, not timing-based).

CLI::

    python -m container_engine_accelerators_tpu_torch.fleet.sim \
        --replicas 3 --requests 24 --json /tmp/fleet-verdict.json
"""

import argparse
import json
import logging
import os
import sys
import threading
import time
import types

import numpy as np
import torch

from container_engine_accelerators_tpu_torch import faults
from container_engine_accelerators_tpu_torch.fleet import (
    autoscaler as fleet_autoscaler,
)
from container_engine_accelerators_tpu_torch.fleet import (
    router as fleet_router,
)
from container_engine_accelerators_tpu_torch.obs import alerts as obs_alerts
from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger(__name__)

# Fault site: one tick per routed dispatch; a host_vanish/chip_wedge
# spec firing here kills the named (or busiest) replica mid-storm.
FAULT_SITE = "fleet.replica"

SIM_VOCAB = 32
SIM_SEQ_LEN = 64


class _StubModel:
    """What the engine reads of a ``serve_cli.Model``: the config, the
    device (the CPU: the seams are fakes) and a ``model`` the graphs
    keep and never call."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.device = torch.device("cpu")
        self.model = types.SimpleNamespace(device=self.device)


def _sim_cfg():
    from container_engine_accelerators_tpu_torch.models import (
        transformer as tf,
    )

    return tf.TransformerConfig(
        vocab_size=SIM_VOCAB, d_model=16, n_layers=1, n_heads=2,
        n_kv_heads=1, d_ff=32, max_seq_len=SIM_SEQ_LEN, dtype="float32",
    )


class FakeDraftProposer:
    """The draft proposer's hermetic twin: proposes the +1 rule the
    fake target decodes (perfect acceptance), except every
    ``wrong_every``-th round, where the first proposal is corrupted —
    a deterministic partial-rejection generator so tests exercise the
    correction path without a real draft model."""

    source = "draft"

    def __init__(self, vocab=SIM_VOCAB, wrong_every=0):
        self.vocab = vocab
        self.wrong_every = wrong_every
        self._slots = {}
        self._rounds = 0

    def admit(self, slot, ctx):
        self._slots[slot] = list(ctx)

    def observe(self, slot, tokens):
        if slot in self._slots:
            self._slots[slot].extend(int(t) for t in tokens)

    def propose(self, slot, k):
        toks = self._slots.get(slot)
        if not toks or k < 1:
            return []
        self._rounds += 1
        props = [(toks[-1] + i) % self.vocab for i in range(1, k + 1)]
        if self.wrong_every and self._rounds % self.wrong_every == 0:
            props[0] = (props[0] + 1) % self.vocab
        return props

    def release(self, slot):
        self._slots.pop(slot, None)


def make_fake_engine(alive=None, chunk_sleep_s=0.0, max_slots=4,
                     compile_sim=None, kv_cache="paged",
                     kv_block_size=4, speculate="off",
                     spec_proposer=None, start_loop=True,
                     prefill_sleep_s=0.0, **engine_kwargs):
    """A port ContinuousEngine on the CPU whose device seams are a
    deterministic fake (the port's contracts: dense ``_prefill``,
    ``_prefill_seg``, ``_chunk``; paged ``_paged_prefill`` writing the
    first token into ``last_dev``, ``_paged_chunk`` advancing
    ``last_dev`` in place, ``_paged_verify``): prefill of a context
    ending in t yields (t+1) % V; each decode step advances by +1. All
    engine-side contracts (slots, retirement, migration, sheds — and in
    paged mode the block pool, its small real pools, the copy-on-write
    copies, radix prefix index, page tables and the async
    double-buffered loop) are the real code. ``alive()`` false makes
    every seam raise — the killed-replica failure mode.

    ``kv_cache`` defaults to "paged": the fleet drills run the engine
    the flagship config runs (``--kv-cache=paged``); pass "dense" for
    the fallback twin (the byte-identity tests drive both and compare).

    ``speculate`` ("off" | "ngram" | "draft") arms the speculation
    state machine with a fake verify (the +1 rule scored at every
    segment position — exactly what the real ``paged_verify_chunk``
    computes); "draft" injects :class:`FakeDraftProposer` unless
    ``spec_proposer`` overrides it.

    ``start_loop=False`` leaves the engine loop unstarted (the link
    harness, ``fleet/linksim.py``, drives its follower engines so).

    ``prefill_sleep_s`` charges a simulated device cost of that many
    seconds PER PREFILLED TOKEN (cached prefix tokens skip prefill, so
    radix hits and handed-off KV blocks genuinely shrink the stall) —
    the knob that makes prefill/decode interference measurable in the
    disaggregation bench (``fleet/disagg.py``): prefill segments run
    on the engine loop between decode chunks, so every prefilled token
    directly delays in-flight decodes.

    ``compile_sim(label)``, when given, is invoked with the static
    shape label of every device call (``prefill/b<len>``,
    ``decode/s<steps>/w<window>/m<mask>`` dense;
    ``pprefill/c<seg>/w<window>/...``, ``pdecode/s<steps>/w<window>``,
    ``verify/b<B>/c<C>/w<window>`` paged — JAX's names) so a
    hermetic drill can charge a simulated first-compile cost per
    distinct shape through the persistent compile-cache memo
    (``CompileCache.memo``) exactly where a first build would be paid."""
    from container_engine_accelerators_tpu_torch.models import serve_cli

    cfg = _sim_cfg()
    if speculate == "draft" and spec_proposer is None:
        # The real DraftProposer would build a real model; the hermetic
        # twin drives the SAME engine plumbing on the fake decode rule.
        spec_proposer = FakeDraftProposer()
    eng = serve_cli.ContinuousEngine(
        _StubModel(cfg), max_slots=max_slots, chunk=4,
        prefill_chunk=SIM_SEQ_LEN, start_loop=False,
        kv_cache=kv_cache,
        **(dict(kv_block_size=kv_block_size,
                speculate=speculate, spec_proposer=spec_proposer)
           if kv_cache == "paged" else {}),
        **engine_kwargs,
    )
    V = cfg.vocab_size

    def check_alive():
        if alive is not None and not alive():
            raise ConnectionError("replica down")

    def tokens_after(last, active, steps):
        # (steps, slots) tokens: each active row advances by +1 a step.
        incr = np.arange(1, steps + 1)[:, None]
        toks = np.where(active[None, :], (last[None, :] + incr) % V, 0)
        return (torch.from_numpy(toks),
                np.where(active, (last + steps) % V, last))

    def fake_prefill(model, cache, padded, plen, slot):
        check_alive()
        if compile_sim is not None:
            compile_sim(f"prefill/b{padded.shape[-1]}")
        if prefill_sleep_s:
            time.sleep(prefill_sleep_s * int(plen))
        return torch.tensor((int(padded[0, int(plen) - 1]) + 1) % V)

    def fake_prefill_seg(model, cache, seg, offset, slot, true_pos,
                         window, want_logits):
        check_alive()
        if compile_sim is not None:
            compile_sim(f"prefill_seg/w{window}/"
                        f"{'logits' if want_logits else 'mid'}")
        if prefill_sleep_s:
            n_tok = (max(1, int(true_pos) - int(offset) + 1)
                     if want_logits else seg.shape[-1])
            time.sleep(prefill_sleep_s * n_tok)
        if not want_logits:
            return torch.zeros(())
        return torch.tensor(
            (int(seg[0, int(true_pos) - int(offset)]) + 1) % V)

    def fake_chunk(last_tok, positions, active, steps, window,
                   mask_writes):
        check_alive()
        if compile_sim is not None:
            compile_sim(f"decode/s{steps}/w{window}/m{int(mask_writes)}")
        if chunk_sleep_s:
            time.sleep(chunk_sleep_s)
        toks, _ = tokens_after(np.asarray(last_tok), np.asarray(active),
                               steps)
        return toks

    def fake_paged_prefill(model, cache, seg, offset, seg_ids, table_row,
                           true_pos, last_dev, slot, window, want_logits):
        check_alive()
        if compile_sim is not None:
            compile_sim(
                f"pprefill/c{seg.shape[-1]}/w{window}/"
                f"{'logits' if want_logits else 'mid'}"
            )
        if prefill_sleep_s:
            # Per real token, not per padded segment: the final
            # segment's true extent is true_pos - offset + 1, so a
            # request whose prefix came from the radix cache (or a KV
            # handoff) pays only for its uncached suffix.
            if want_logits:
                n_tok = max(1, int(true_pos) - int(offset) + 1)
            else:
                n_tok = int(seg.shape[-1])
            time.sleep(prefill_sleep_s * n_tok)
        if not want_logits:
            return None
        tok = (int(seg[0, int(true_pos) - int(offset)]) + 1) % V
        last_dev[int(slot)] = tok
        return torch.tensor(tok)

    def fake_paged_chunk(tables, positions, active, steps, window):
        check_alive()
        if compile_sim is not None:
            compile_sim(f"pdecode/s{steps}/w{window}")
        if chunk_sleep_s:
            time.sleep(chunk_sleep_s)
        toks, last = tokens_after(eng.last_dev.numpy(), np.asarray(active),
                                  steps)
        eng.last_dev.copy_(torch.from_numpy(last))
        return toks

    def fake_paged_verify(segs, poss, bids, offs, tables, window):
        check_alive()
        s = np.asarray(segs)  # (B, W): the batched verify contract
        if compile_sim is not None:
            compile_sim(f"verify/b{s.shape[0]}/c{s.shape[-1]}/w{window}")
        # The fake greedy rule, scored at every position of every row —
        # what the real batched verify computes.
        return torch.from_numpy((s + 1) % V)

    if kv_cache == "paged":
        eng._paged_prefill = fake_paged_prefill
        eng._paged_chunk = fake_paged_chunk
        if speculate != "off":
            eng._paged_verify = fake_paged_verify
        loop = eng._loop_paged
    else:
        eng._prefill = fake_prefill
        eng._prefill_seg = fake_prefill_seg
        eng._chunk = fake_chunk
        loop = eng._loop
    if start_loop:
        # As the engine's own loop thread, so shutdown() stops it.
        eng._thread = threading.Thread(target=loop, daemon=True)
        eng._thread.start()
    return eng


def expected_output(prompt, max_new, vocab=SIM_VOCAB):
    """The fake decode's exact greedy continuation (lost/corrupted
    requests are caught by comparing against this)."""
    out = list(prompt)
    for _ in range(max_new):
        out.append((out[-1] + 1) % vocab)
    return out


class SimReplica:
    """One in-process replica: real engine (fake device calls), its own
    event stream (``host`` = the replica id, so tailed records route
    back) and registry, and transport/probe callables for the router's
    :class:`~container_engine_accelerators_tpu_torch.fleet.router
    .ReplicaHandle`."""

    def __init__(self, replica_id, chunk_sleep_s=0.002, max_slots=4,
                 max_queue=0, compile_sim=None, kv_cache="paged",
                 tenants=None, slo=None, role="unified",
                 prefill_sleep_s=0.0, devicetime=None):
        self.replica_id = replica_id
        self.role = role
        self.alive = True
        # Transport-level straggler injection (seconds): the day
        # drill's hedging window slows ONE replica's replies without
        # touching its engine, so budgeted hedges fire and the peer
        # serves the client.
        self.straggle_s = 0.0
        self.registry = obs_metrics.Registry()
        self.events = obs_events.EventStream(
            "serve", host=replica_id, registry=self.registry,
        )
        self.compile_sim = compile_sim
        if callable(slo):
            # A factory taking the replica's registry: each replica
            # gets its own ServingSLO whose instruments render in the
            # replica's scrape (the serve_cli wiring).
            slo = slo(self.registry)
        self.slo = slo
        if callable(devicetime):
            # Same factory shape as slo: a chip-accounting ledger per
            # replica, its gauges on the replica's own registry and its
            # fairness baseline read off the replica's tenant queue.
            devicetime = devicetime(self.registry, tenants)
        self.devicetime = devicetime
        self.engine = make_fake_engine(
            alive=lambda: self.alive, chunk_sleep_s=chunk_sleep_s,
            max_slots=max_slots, max_queue=max_queue,
            events=self.events, registry=self.registry,
            compile_sim=compile_sim, kv_cache=kv_cache,
            tenants=tenants, slo=slo,
            prefill_sleep_s=prefill_sleep_s,
            devicetime=devicetime,
        )
        self.max_slots = max_slots

    def warm(self, labels):
        """AOT warmup, sim edition: pre-pay every ``labels`` shape
        through :attr:`compile_sim` before taking traffic — the same
        before-ready contract as ``serve_cli --warmup=all``, with the
        simulated compiles flowing through the armed persistent-cache
        memo, so a replacement replica of a config the fleet already
        compiled starts warm. Emits the ``warmup_done`` record the
        goodput ledger charges to ``compile``; returns the summary."""
        t0 = time.perf_counter()
        from container_engine_accelerators_tpu_torch.warmstart import (
            cache as ws_cache,
            warmup as ws_warmup,
        )

        labels = list(labels)
        # Account against the cache the compile_sim hook actually
        # writes to (make_compile_sim stamps it on the hook); the
        # process-global armed cache is only the fallback — a caller
        # that never armed it would otherwise read all-zero deltas.
        sim_cache = getattr(self.compile_sim, "cache", None)
        snap = (sim_cache.snapshot if sim_cache is not None
                else ws_cache.snapshot)
        snap0 = snap()
        compiled = 0
        if self.compile_sim is not None:
            for label in labels:
                self.compile_sim(label)
                compiled += 1
        summary = ws_warmup.build_summary(
            "all", len(labels), compiled, len(labels) - compiled, 0,
            time.perf_counter() - t0, snap0, snap(),
        )
        ws_warmup.emit_done(self.events, summary)
        return summary

    def kill(self):
        """Replica death: every in-flight and future device call
        raises; probes fail. The engine object survives for
        :meth:`revive` (the process came back)."""
        self.alive = False

    def revive(self):
        self.alive = True

    def transport(self, payload):
        from container_engine_accelerators_tpu_torch.models import serve_cli

        if not self.alive:
            raise fleet_router.TransportError(
                f"{self.replica_id}: connection refused"
            )
        if self.straggle_s:
            time.sleep(self.straggle_s)
        tokens = payload.get("tokens") or [[1, 2, 3]]
        max_new = int(payload.get("max_new_tokens", 16))
        extra = {}
        if payload.get("tenant") is not None:
            # The router forwards the resolved tenant class in the
            # payload — the same wire contract as serve_cli's POST
            # body field.
            extra["tenant"] = payload["tenant"]
        if payload.get("traceparent") is not None:
            # Distributed-trace context: same wire contract as the
            # serve_cli POST body / traceparent header.
            extra["traceparent"] = payload["traceparent"]
        try:
            out = self.engine.generate(tokens, max_new, **extra)
        except serve_cli.ShedError as e:
            raise fleet_router.BackendShed(
                str(e), reason=e.reason,
                tenant=getattr(e, "tenant", ""),
            ) from e
        except Exception as e:  # noqa: BLE001 - transport failure class
            raise fleet_router.TransportError(
                f"{self.replica_id}: {e}"
            ) from e
        return {"tokens": out}

    def kv_export(self, tokens, traceparent=None):
        """The serve_cli POST /kv/export contract in-process: framed
        handoff stream of the longest cached prefix (engine-loop
        marshalled, single-writer safe). A dead replica refuses —
        the router falls back to re-prefill."""
        if not self.alive:
            raise fleet_router.TransportError(
                f"{self.replica_id}: kv export refused"
            )
        return self.engine.kv_export(tokens, traceparent=traceparent)

    def kv_install(self, frames):
        """The serve_cli POST /kv/install contract in-process."""
        if not self.alive:
            raise fleet_router.TransportError(
                f"{self.replica_id}: kv install refused"
            )
        return self.engine.kv_install(frames)

    def probe(self):
        if not self.alive:
            raise fleet_router.TransportError(
                f"{self.replica_id}: probe refused"
            )
        stats = self.engine.stats()
        info = {
            "status": "ok",
            "queue_depth": stats["queue_depth"],
            "occupied_slots": stats["occupied_slots"],
            "max_slots": self.max_slots,
            "role": self.role,
        }
        kvs = self.engine.kv_stats()
        if kvs is not None:
            # The serve_cli /healthz contract: the router's spill
            # guard steers on the reported hit ratio.
            info["prefix_hit_ratio"] = kvs["prefix_hit_ratio"]
            info["free_blocks"] = kvs["free_blocks"]
        if self.engine.tenants is not None:
            # Per-class queue depths (serve_cli /healthz contract):
            # class-level pressure for the router and day drill.
            info["tenant_queues"] = stats["tenant_queues"]
        return info

    def handle(self):
        return fleet_router.ReplicaHandle(
            self.replica_id, self.transport, probe=self.probe,
            host=self.replica_id, node=f"node-{self.replica_id}",
            capacity=self.max_slots, role=self.role,
            kv_export=self.kv_export, kv_install=self.kv_install,
        )

    def idle(self):
        stats = self.engine.stats()
        return (
            stats["queue_depth"] == 0 and stats["occupied_slots"] == 0
        )


class SimBackend:
    """The :class:`~container_engine_accelerators_tpu_torch.fleet.lifecycle
    .ReplicaLifecycle` process half over in-process fake-seam replicas:
    the k8s half (pod creation, gang binding, label reconciliation)
    runs REAL against the conformant kubeapi while the serving process
    is a :class:`SimReplica`. Replicas survive a lifecycle/autoscaler
    "restart" (the backend object persists, like processes outliving
    their controller), which is exactly what reconciliation adopts."""

    def __init__(self, chunk_sleep_s=0.002, max_slots=4,
                 kv_cache="paged", max_queue=0, make_tenants=None,
                 make_slo=None, make_devicetime=None):
        self.chunk_sleep_s = chunk_sleep_s
        self.max_slots = max_slots
        self.kv_cache = kv_cache
        self.max_queue = max_queue
        # Factories, not instances: each replica needs its OWN tenant
        # queue, SLO classifier and chip-accounting ledger (per-engine
        # state / registries).
        self.make_tenants = make_tenants
        self.make_slo = make_slo
        self.make_devicetime = make_devicetime
        self.replicas = {}

    def _new_replica(self, replica_id):
        return SimReplica(
            replica_id, chunk_sleep_s=self.chunk_sleep_s,
            max_slots=self.max_slots, kv_cache=self.kv_cache,
            max_queue=self.max_queue,
            tenants=(self.make_tenants() if self.make_tenants
                     else None),
            slo=self.make_slo,
            devicetime=self.make_devicetime,
        )

    def start(self, replica_id, pods):
        del pods
        sr = self._new_replica(replica_id)
        self.replicas[replica_id] = sr
        return sr.handle()

    def adopt(self, replica_id, pods):
        del pods
        sr = self.replicas.get(replica_id)
        if sr is None or not sr.alive:
            return None  # process gone: the pods are orphans
        return sr.handle()

    def stop(self, replica_id):
        sr = self.replicas.get(replica_id)
        if sr is not None:
            sr.kill()

    def drain(self, replica_id, reason):
        sr = self.replicas.get(replica_id)
        if sr is None:
            return 0
        migrated = sr.engine.drain(reason=reason)
        deadline = time.monotonic() + 10
        while not sr.idle() and time.monotonic() < deadline:
            time.sleep(0.005)
        return migrated


class SimLifecycle:
    """Replica lifecycle for the autoscaler: launch builds a fresh
    fake-engine replica, drain drives the engine's lossless slot
    migration (a drain reason, never a health transition), terminate
    kills the process."""

    def __init__(self, chunk_sleep_s=0.002, max_slots=4,
                 kv_cache="paged"):
        self.chunk_sleep_s = chunk_sleep_s
        self.max_slots = max_slots
        self.kv_cache = kv_cache
        self.replicas = {}
        self.drained = []

    def adopt(self, sim_replica):
        self.replicas[sim_replica.replica_id] = sim_replica
        return sim_replica.handle()

    def launch(self, replica_id, placement):
        del placement  # bindings informational in the hermetic sim
        sr = SimReplica(
            replica_id, chunk_sleep_s=self.chunk_sleep_s,
            max_slots=self.max_slots, kv_cache=self.kv_cache,
        )
        self.replicas[replica_id] = sr
        return sr.handle()

    def drain(self, handle, reason):
        sr = self.replicas.get(handle.replica_id)
        if sr is None:
            return 0
        migrated = sr.engine.drain(reason=reason)
        self.drained.append((handle.replica_id, reason))
        deadline = time.monotonic() + 10
        while not sr.idle() and time.monotonic() < deadline:
            time.sleep(0.005)
        return migrated

    def terminate(self, handle):
        sr = self.replicas.get(handle.replica_id)
        if sr is not None:
            sr.kill()


# -- gang-scheduler placement over a synthetic inventory ----------------------


def _raw_pod(name, tpu=4):
    return {
        "metadata": {
            "name": name, "namespace": "default", "uid": f"uid-{name}",
            "labels": {"job-name": "fleet-replica"},
            "ownerReferences": [{
                "apiVersion": "batch/v1", "kind": "Job",
                "name": "fleet-replica", "uid": "uid-owner",
                "controller": True,
            }],
        },
        "spec": {
            "containers": [{
                "name": "main",
                "resources": {"requests": {
                    "cpu": "1", "memory": "1Gi",
                    "google.com/tpu": str(tpu),
                }},
            }],
            "schedulingGates": [
                {"name": "gke.io/topology-aware-auto-fleet-replica"}
            ],
        },
        "status": {"phase": "Pending"},
    }


def _raw_node(name, coords, slice_name="sim-slice",
              acc_type="v5litepod-16", tpu=4):
    from container_engine_accelerators_tpu_torch.topology import (
        labels as topo_labels,
    )

    return {
        "metadata": {
            "name": name,
            "labels": dict(topo_labels.ici_labels(
                slice_name, acc_type, 0, coords,
            )),
        },
        "spec": {},
        "status": {
            "allocatable": {
                "cpu": "8", "memory": "64Gi",
                "google.com/tpu": str(tpu),
            },
            "conditions": [{"type": "Ready", "status": "True"}],
        },
    }


def sim_placer(n_nodes=4, gang_size=2):
    """A :class:`~container_engine_accelerators_tpu_torch.fleet.autoscaler
    .GangPlacer` over a synthetic 1×N slice inventory — the REAL
    ``place_gang_on_slice`` pass decides whether a new replica has an
    intact contiguous sub-mesh to land on."""
    from container_engine_accelerators_tpu_torch.scheduler import gang

    def nodes_fn():
        # v5litepod-16 hosts form a 2x2 grid (host_bounds); coords must
        # stay inside it for the contiguous sub-mesh scan.
        return [
            gang.node_info(_raw_node(f"sim-node-{i}", (i // 2, i % 2)))
            for i in range(n_nodes)
        ]

    def gang_fn():
        out = []
        for i in range(gang_size):
            pod = _raw_pod(f"fleet-replica-{i}")
            out.append(gang.pod_info(pod, gang.find_gate(pod)))
        return out

    return fleet_autoscaler.GangPlacer(nodes_fn, gang_fn)


# -- the storm drill ----------------------------------------------------------


def drill_verdict(records):
    """Summarize a drill's merged event records into the acceptance
    counts (the consumer side of the fleet tier's event contract:
    retires, re-issues, ejections/re-admissions, scale actions)."""
    out = {
        "retired": 0, "reissued": 0, "reissued_keys": [],
        "ejections": 0, "readmissions": 0,
        "scale_outs": 0, "scale_ins": 0, "migrated": 0,
        "kv_handoffs": 0, "kv_handoff_failures": 0,
    }
    for rec in records:
        kind = rec.get("kind") or rec.get("event")
        if kind == "request_retired":
            out["retired"] += 1
        elif kind == "request_reissued":
            out["reissued"] += 1
            out["reissued_keys"].append(rec.get("key"))
        elif kind == "replica_ejected":
            out["ejections"] += 1
        elif kind == "replica_readmitted":
            out["readmissions"] += 1
        elif kind == "scale_out":
            out["scale_outs"] += 1
            out["last_scale_out_replicas"] = rec.get("replicas")
        elif kind == "scale_in":
            out["scale_ins"] += 1
            out["last_scale_in_replicas"] = rec.get("replicas")
        elif kind == "request_migrated":
            out["migrated"] += 1
        elif kind == "kv_handoff":
            out["kv_handoffs"] += 1
        elif kind == "kv_handoff_failed":
            out["kv_handoff_failures"] += 1
    return out


def fleet_kv_totals(replicas):
    """Fleet-wide cumulative prefix-cache counters: summed
    (hit_tokens, miss_tokens) across every replica's paged manager.
    Snapshot before/after a phase and difference for a windowed
    fleet-wide ``prefix_hit_ratio`` — the membership-storm acceptance
    metric (per-replica ratios reset when a replica's cache goes cold;
    the FLEET ratio is what KV handoff preserves)."""
    hit = miss = 0
    for sr in replicas:
        kvs = sr.engine.kv_stats()
        if kvs is not None:
            hit += kvs["prefix_hit_tokens"]
            miss += kvs["prefix_miss_tokens"]
    return hit, miss


def _burn_rule():
    """The drill's scale-out rule: any degraded routing outcome
    (re-issued after a replica failure, shed, or outright error)
    burning more than the 1% budget over both windows."""
    return obs_alerts.AlertRule.from_dict({
        "name": "fleet-routing-burn", "kind": "burn_rate",
        "bad_metric": "tpu_router_requests_total",
        "bad_labels": {"outcome": ["reissued_ok", "error", "shed"]},
        "total_metric": "tpu_router_requests_total",
        "objective": 0.99,
        "windows": [[60.0, 1.0], [5.0, 1.0]],
        "severity": "error",
    })


def run_membership_storm(n_replicas=3, families=4, warm_repeats=3,
                         storm_repeats=2, rounds=3, seed=None,
                         handoff=True, chunk_sleep_s=0.0, max_new=4):
    """The membership-storm drill: prefix-heavy traffic while the
    fleet churns (each round ejects the replica holding the most
    cached prefixes and registers a brand-new cold one). With
    ``handoff`` armed the router ships the ejected holder's KV blocks
    to wherever the ring remaps each prefix — the ejected replica's
    cache is warm, only unreachable by dispatch — so the FLEET-WIDE
    ``prefix_hit_ratio`` over the storm window stays near the steady
    state instead of resetting per replica. ``handoff=False`` runs the
    re-prefill baseline the disaggregation bench contrasts against.

    Deterministic in ``seed`` (the churn schedule is derived from the
    directory's contents, which sequential traffic makes exact).
    Returns the verdict dict; ``verdict["pass"]`` only applies
    acceptance thresholds when ``handoff`` is armed."""
    seed = int(os.environ.get("CHAOS_SEED", "0")) if seed is None \
        else seed
    tag = f"(chaos seed={seed}; rerun with CHAOS_SEED={seed})"
    registry = obs_metrics.Registry()
    events = obs_events.EventStream(
        fleet_router.EVENT_SOURCE, registry=registry,
    )
    router = fleet_router.ReplicaRouter(
        events=events, registry=registry, handoff=handoff,
    )
    replicas = [
        SimReplica(f"replica-{i}", chunk_sleep_s=chunk_sleep_s)
        for i in range(n_replicas)
    ]
    for sr in replicas:
        router.register(sr.handle())

    # Family f's prompt is identical on every request: 12 shared
    # prefix tokens (3 blocks at the sim's block size of 4) + a family
    # tail — the whole prompt is the affinity/directory key.
    def _prompt(f):
        return [((f * 7 + j) % (SIM_VOCAB - 1)) + 1
                for j in range(12)] + [(f % (SIM_VOCAB - 1)) + 1]

    outcomes = []

    def _submit(f):
        prompt = _prompt(f)
        try:
            out = router.submit(
                {"tokens": [prompt], "max_new_tokens": max_new},
            )
            ok = out["tokens"][0] == expected_output(prompt, max_new)
            outcomes.append("ok" if ok else "corrupt")
        except Exception as e:  # noqa: BLE001 - verdict counts errors
            log.warning("membership storm submit failed: %s", e)
            outcomes.append("error")

    # Warm phase: every family retires a few times, its blocks cache
    # on the ring owner, and the directory learns the holders.
    for _ in range(warm_repeats):
        for f in range(families):
            _submit(f)
    warm_hit, warm_miss = fleet_kv_totals(replicas)

    # Storm phase: churn membership, keep the prefix traffic flowing.
    ejected_log = []
    for r in range(rounds):
        # Evict the replica the directory leans on hardest — the
        # worst-case churn for prefix locality (seeded fallback when
        # the directory is cold/disabled keeps the schedule
        # deterministic either way).
        holders = {}
        for f in range(families):
            holder = router.prefix_holder(_prompt(f))
            if holder is not None:
                holders[holder] = holders.get(holder, 0) + 1
        ready = {h.replica_id for h in router.replicas(
            state=fleet_router.READY)}
        victim = max(
            sorted(h for h in holders if h in ready),
            key=lambda h: holders[h],
            default=None,
        ) if holders else None
        if victim is None:
            victim = f"replica-{(seed + r) % len(replicas)}"
        router.eject(victim, reason="membership storm")
        ejected_log.append(victim)
        # A brand-new, cold replica joins mid-storm (the autoscaler /
        # lifecycle path): the ring remaps onto it.
        fresh = SimReplica(f"replica-{len(replicas)}",
                           chunk_sleep_s=chunk_sleep_s)
        replicas.append(fresh)
        router.register(fresh.handle())
        for _ in range(storm_repeats):
            for f in range(families):
                _submit(f)
        router.readmit(victim)

    storm_hit, storm_miss = fleet_kv_totals(replicas)
    storm_hit -= warm_hit
    storm_miss -= warm_miss
    denom = storm_hit + storm_miss
    storm_ratio = storm_hit / denom if denom else 0.0
    warm_denom = warm_hit + warm_miss
    warm_ratio = warm_hit / warm_denom if warm_denom else 0.0

    records = list(events.events())
    for sr in replicas:
        records.extend(sr.events.events())
    verdict = drill_verdict(records)

    errors = outcomes.count("error")
    corrupt = outcomes.count("corrupt")
    failures = []
    if errors:
        failures.append(f"{errors} requests failed outright {tag}")
    if corrupt:
        failures.append(f"{corrupt} corrupted outputs {tag}")
    if handoff:
        if verdict["kv_handoffs"] < rounds:
            failures.append(
                f"membership churn triggered only "
                f"{verdict['kv_handoffs']} KV handoffs across "
                f"{rounds} rounds {tag}"
            )
        if storm_ratio < 0.85:
            failures.append(
                f"fleet prefix_hit_ratio collapsed to "
                f"{storm_ratio:.3f} under membership churn (handoff "
                f"should have preserved it) {tag}"
            )
    verdict.update({
        "seed": seed,
        "handoff": handoff,
        "families": families,
        "rounds": rounds,
        "requests": len(outcomes),
        "served": outcomes.count("ok"),
        "errors": errors,
        "ejected": ejected_log,
        "warm_hit_ratio": round(warm_ratio, 6),
        "storm_hit_ratio": round(storm_ratio, 6),
        "storm_hit_tokens": storm_hit,
        "storm_miss_tokens": storm_miss,
        "failures": failures,
        "pass": not failures,
    })
    return verdict


def run_drill(n_replicas=3, requests=24, max_new=6, kill_at=8,
              seed=None, chunk_sleep_s=0.004, workers=8,
              probe_interval_s=0.02, idle_for_s=5.0,
              min_replicas=2, max_replicas=5, kv_cache="paged"):
    """The replica-kill storm drill; returns the verdict dict
    (``verdict["pass"]`` is the acceptance bit; every failed check is
    listed in ``verdict["failures"]`` with the seed). ``kv_cache``
    selects the engine mode the replicas run — "paged" (the flagship
    config) by default; the byte-identity tests run both and compare
    the served outputs."""
    seed = int(os.environ.get("CHAOS_SEED", "0")) if seed is None \
        else seed
    tag = f"(chaos seed={seed}; rerun with CHAOS_SEED={seed})"
    faults.arm(faults.FaultPlan([
        {"kind": "host_vanish", "site": FAULT_SITE, "at": kill_at,
         "count": 1},
    ], seed=seed))
    try:
        return _run_drill_armed(
            n_replicas, requests, max_new, seed, tag, chunk_sleep_s,
            workers, probe_interval_s, idle_for_s, min_replicas,
            max_replicas, kv_cache=kv_cache,
        )
    finally:
        faults.disarm()


def _run_drill_armed(n_replicas, requests, max_new, seed, tag,
                     chunk_sleep_s, workers, probe_interval_s,
                     idle_for_s, min_replicas, max_replicas,
                     kv_cache="paged"):
    lifecycle = SimLifecycle(chunk_sleep_s=chunk_sleep_s,
                             kv_cache=kv_cache)
    router_registry = obs_metrics.Registry()
    router_events = obs_events.EventStream(
        fleet_router.EVENT_SOURCE, registry=router_registry,
    )
    router = fleet_router.ReplicaRouter(
        events=router_events, registry=router_registry,
        eject_after=2, readmit_after=2,
    )
    sims = [SimReplica(f"replica-{i}", chunk_sleep_s=chunk_sleep_s,
                       kv_cache=kv_cache)
            for i in range(n_replicas)]
    for sr in sims:
        router.register(lifecycle.adopt(sr))

    # Simulated control-plane clock: the burn-rate evaluator and the
    # autoscaler tick at SCRIPTED instants, so alert firing/resolution
    # and cooldown/idle arithmetic are deterministic regardless of how
    # long the storm takes on the wall clock.
    simclock = [0.0]
    alert_events = obs_events.EventStream(
        obs_alerts.EVENT_SOURCE, registry=router_registry,
    )
    evaluator = obs_alerts.AlertEvaluator(
        [router_registry], [_burn_rule()], events=alert_events,
        clock=lambda: simclock[0], registry=router_registry,
    )
    scaler = fleet_autoscaler.Autoscaler(
        router=router, lifecycle=lifecycle, events=router_events,
        registry=router_registry, min_replicas=min_replicas,
        max_replicas=max_replicas, scale_out_cooldown_s=1.0,
        scale_in_cooldown_s=1.0, idle_for_s=idle_for_s,
        idle_occupancy=0.05, placer=sim_placer(),
        clock=lambda: simclock[0],
    )
    evaluator.tick()  # baseline sample at t=0

    killed = []

    def _inflight():
        return {
            snap["replica"]: snap["inflight"]
            for snap in router.snapshot()
        }

    def _maybe_kill():
        for spec in faults.tick(FAULT_SITE):
            if spec.kind not in ("host_vanish", "chip_wedge"):
                continue
            # The kill must land while the victim holds in-flight work
            # (a replica dying with nothing in flight exercises no
            # re-issue and burns no budget — a different, easier
            # drill). The storm is still flowing on the other worker
            # threads, so waiting here for in-flight work is bounded.
            target = None
            deadline = time.monotonic() + 2.0
            while target is None and time.monotonic() < deadline:
                inflight = _inflight()
                live = [s for s in sims if s.alive]
                if not live:
                    return
                if spec.node:
                    named = next(
                        (s for s in live
                         if s.replica_id == spec.node), None,
                    )
                    if named is None:
                        return
                    if inflight.get(named.replica_id, 0) > 0:
                        target = named
                else:
                    busy = [
                        s for s in live
                        if inflight.get(s.replica_id, 0) > 0
                    ]
                    if busy:
                        target = max(
                            busy,
                            key=lambda s: inflight[s.replica_id],
                        )
                if target is None:
                    time.sleep(0.001)
            if target is None:
                # Deadline fallback: busiest live replica regardless.
                target = max(
                    [s for s in sims if s.alive],
                    key=lambda s: _inflight().get(s.replica_id, 0),
                )
            target.kill()
            killed.append(target)
            log.warning("drill: killed %s mid-storm %s",
                        target.replica_id, tag)

    # Probe loop runs through the storm so the router ejects the dead
    # replica while traffic is still flowing.
    stop_probes = threading.Event()

    def _probe_loop():
        while not stop_probes.wait(probe_interval_s):
            # Every replica exactly once per sweep (the lifecycle map
            # holds both the adopted originals and scaled launches):
            # double-probing would halve the effective eject_after.
            for sr in list(lifecycle.replicas.values()):
                try:
                    info = sr.probe()
                except Exception:  # noqa: BLE001 - dead replica = signal
                    router.observe_probe(sr.replica_id, ok=False)
                else:
                    router.observe_probe(
                        sr.replica_id, ok=True, info=info,
                    )

    threading.Thread(target=_probe_loop, daemon=True).start()

    # The storm: `workers` client threads, `requests` total, a shared
    # prefix on half of them (the affinity population).
    outcomes = [None] * requests

    def _client(i):
        if i % 2:
            prompt = [7, 7, (i % 11) + 1]
        else:
            prompt = [(i % 13) + 1, (i % 5) + 1]
        _maybe_kill()
        try:
            out = router.submit(
                {"tokens": [prompt], "max_new_tokens": max_new},
            )
            outcomes[i] = ("ok", out["tokens"][0], prompt)
        except fleet_router.BackendShed as e:
            outcomes[i] = ("shed", e.reason, prompt)
        except Exception as e:  # noqa: BLE001 - verdict counts errors
            outcomes[i] = ("error", str(e), prompt)

    def _worker(ids):
        for i in ids:
            _client(i)

    threads = [
        threading.Thread(
            target=_worker, args=(range(w, requests, workers),),
            daemon=True,
        )
        for w in range(workers)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)

    # Post-storm control-plane script: alert fires on the storm's
    # degraded outcomes -> scale-out; replica revives -> re-admission;
    # the alert resolves and the fleet idles -> drain + scale-in.
    simclock[0] = 1.0
    evaluator.tick()
    scaler.poll(alert_events)
    # Guarantee the dead replica's ejection is on the record before
    # revival (a kill landing at the storm's very end can beat the
    # probe loop's consecutive-failure count): explicit failing probe
    # rounds are idempotent when the loop already ejected it.
    for _ in range(2):
        for sr in killed:
            try:
                sr.probe()
            except Exception:  # noqa: BLE001 - the expected dead path
                router.observe_probe(sr.replica_id, ok=False)
    for sr in killed:
        sr.revive()
    for _ in range(4):
        for sr in sims:
            try:
                info = sr.probe()
            except Exception:  # noqa: BLE001 - still down
                router.observe_probe(sr.replica_id, ok=False)
            else:
                router.observe_probe(sr.replica_id, ok=True, info=info)
    simclock[0] = 10.0
    evaluator.tick()          # short window clear -> alert resolves
    scaler.poll(alert_events)  # idle run starts
    simclock[0] = 10.0 + idle_for_s + 1.0
    scaler.poll(alert_events)  # sustained idle -> drain + scale-in
    stop_probes.set()

    # Merge every stream's ring into one record list for the verdict.
    records = []
    for sr in list(lifecycle.replicas.values()):
        records.extend(sr.events.events())
    records.extend(router_events.events())
    records.extend(alert_events.events())
    verdict = drill_verdict(records)

    hung = sum(1 for o in outcomes if o is None)
    ok = [o for o in outcomes if o and o[0] == "ok"]
    shed = [o for o in outcomes if o and o[0] == "shed"]
    errors = [o for o in outcomes if o and o[0] == "error"]
    corrupted = [
        o for o in ok if o[1] != expected_output(o[2], max_new)
    ]
    failures = []
    if hung:
        failures.append(f"{hung} requests hung {tag}")
    if corrupted:
        failures.append(
            f"{len(corrupted)} corrupted outputs {tag}"
        )
    if verdict["retired"] != len(ok):
        failures.append(
            f"retire events ({verdict['retired']}) != served "
            f"requests ({len(ok)}): lost or double-retired {tag}"
        )
    keys = verdict["reissued_keys"]
    if len(keys) != len(set(keys)):
        failures.append(f"a request was re-issued twice {tag}")
    if killed and verdict["ejections"] < 1:
        failures.append(f"dead replica was never ejected {tag}")
    if killed and verdict["readmissions"] < 1:
        failures.append(
            f"revived replica was never re-admitted {tag}"
        )
    if verdict["scale_outs"] < 1:
        failures.append(
            f"burn alert did not scale the fleet out {tag}"
        )
    if verdict["scale_ins"] < 1:
        failures.append(
            f"sustained idle did not scale the fleet in {tag}"
        )
    if not lifecycle.drained:
        failures.append(f"scale-in skipped the drain step {tag}")

    verdict.update({
        "seed": seed,
        "requests": requests,
        "served": len(ok),
        "shed": len(shed),
        "errors": len(errors),
        "replicas_final": len(router.replicas()),
        "failures": failures,
        "pass": not failures,
    })
    return verdict


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--replicas", type=int, default=3,
                   help="fleet size the storm starts with")
    p.add_argument("--requests", type=int, default=24,
                   help="storm size (client requests)")
    p.add_argument("--max-new", type=int, default=6,
                   help="tokens decoded per request")
    p.add_argument("--kill-at", type=int, default=8,
                   help="dispatch index at which the fault plan kills "
                        "a replica")
    p.add_argument("--seed", type=int, default=None,
                   help="chaos seed (default: CHAOS_SEED env, else 0)")
    p.add_argument("--kv-cache", choices=["dense", "paged"],
                   default="paged",
                   help="engine mode the drill's replicas run "
                        "(paged = block-pool cache + radix prefix "
                        "reuse + async host loop, the flagship "
                        "serving config)")
    p.add_argument("--json", default="",
                   help="write the machine-readable verdict here")
    args = p.parse_args(argv)
    verdict = run_drill(
        n_replicas=args.replicas, requests=args.requests,
        max_new=args.max_new, kill_at=args.kill_at, seed=args.seed,
        kv_cache=args.kv_cache,
    )
    out = json.dumps(verdict, indent=2, sort_keys=True)
    print(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out + "\n")
    if not verdict["pass"]:
        for failure in verdict["failures"]:
            log.error("drill failure: %s", failure)
        return 1
    log.info(
        "fleet storm drill passed: %d/%d served, %d re-issued, "
        "%d ejection(s), %d re-admission(s), scale out->in complete",
        verdict["served"], verdict["requests"], verdict["reissued"],
        verdict["ejections"], verdict["readmissions"],
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
