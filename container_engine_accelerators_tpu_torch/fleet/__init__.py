# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Fleet serving tier, port. Copies of the JAX package's modules, their
imports pointed at the port's:

  * :mod:`.tenants` — tenant classes, weighted queue shares and
    token-rate quotas at the engine's admission;
  * :mod:`.router` — the replica router (consistent-hash prefix
    affinity, probes, ejection and re-admission, idempotent re-issue,
    the prefix directory and KV handoff between replicas);
  * :mod:`.autoscaler` — the burn-rate driven scale-out/scale-in loop
    and its gang placer;
  * :mod:`.lifecycle` — the autoscaler's hands on the cluster (replica
    pods, gang binding, reconciliation);

and the hermetic tier on the port's engines (fake device seams, the CPU):

  * :mod:`.sim` — replicas, the replica-kill chaos drill and the
    membership storm;
  * :mod:`.disagg` — the disaggregated prefill/decode bench;
  * :mod:`.journeydrill` — the request-journey drill: every retired
    request stitches into one journey (``obs/journey.py``), hedges and
    handoffs carry their legs, a slow request's TTFT exemplar resolves
    to the stage to blame;
  * :mod:`.linksim` — the lockstep engine link's multi-rank harness and
    its chaos drill (byte identity, follower kill with the fleet
    reactor, corrupt broadcast, leader stall);
  * :mod:`.flightdrill` — the flight-recorder drill: a wedged link, one
    bundle, and the postmortem analyzer (``obs/postmortem.py``) naming
    the wedge first;
  * :mod:`.daysim` — the tenant-SLO day: three tenant classes through
    a scripted day of bursts, replica kills, hedging, an autoscaler
    restart and a fairness audit, on real pods of the in-process kube
    API server.
"""
