# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Transformer serving daemon, PyTorch port.

Port of ``container_engine_accelerators_tpu/models/serve_cli.py``. Three
ways to serve:

  * ``Model``: one request at a time through ``transformer.generate``
    (bucketed batched prefill through the flash kernel, then decode
    steps on a dense cache kept per batch size (at most
    ``serving_graphs.MAX_CACHED_ROWS`` rows in all), each the replay of a
    CUDA graph captured per (batch, window) on the card);
  * ``BatchingModel`` (``--batch-window-ms``): a micro-batcher in front
    of ``Model`` that coalesces concurrent greedy requests of one shape
    into one ``generate`` call;
  * ``ContinuousEngine`` (``--continuous-batching``): slot-based
    continuous batching. ``--kv-cache dense`` (the default, as in JAX)
    keeps one dense cache row per slot and runs the synchronous host loop
    (``_loop``): a short prompt prefills in one call
    (``transformer.prefill_into_slot``), a long one in segments
    (``transformer.prefill_chunk_into_slot``, the flash kernel at the
    segment's global offset) between decode chunks, and each chunk is on
    the card the replays of one CUDA graph of the decode step per
    (window, mask_writes) (``serving_graphs.DenseChunkGraphs``, the
    counterpart of the jitted ``transformer.decode_chunk``).
    ``--kv-cache paged`` runs the paged KV cache with radix prefix reuse
    and the asynchronous double-buffered host loop (``_loop_paged``):
    admissions prefill in segments (``transformer.paged_prefill_segment``)
    and each decode chunk replays one graph per window
    (``serving_graphs.PagedDecodeGraphs``). With ``--speculate
    ngram|draft`` (paged only) a proposer guesses up to k tokens per row
    and one batched verify (``transformer.paged_verify_batch``, on the
    card the replay of one CUDA graph per (batch bucket, window),
    ``serving_graphs.PagedVerifyGraphs``) scores every speculating row's
    guesses; the longest greedily-matching prefix is accepted, so the
    tokens are those of ``--speculate off``.

``--quantize int8`` serves int8 layer matrices (W8A16,
``models/quantization.py``) on every one of these paths: each projection
is the hand-written dequantising kernel on the card, in the eager
prefills and inside the captured decode and verify graphs alike.

``--warmup=all`` runs every prefill shape and captures every decode
graph before ``/healthz`` flips ready (``warmstart/warmup.py``; its
``warmup_done`` record goes to ``--event-log``);
``--warmup=lazy`` (the default) captures a graph at its first chunk.
Once warmup succeeds, ``--health-log`` (default
``$HEALTH_CHECK_LOG_FILE``) gets JAX's ready line, ``tpu-serving ready
warmup_s=<s>``, which the serving manifests' startupProbe greps for.

Endpoints (the same JSON as the JAX server):
  GET  /healthz    200 once the warmup decode succeeded, 503 before,
                   500 if it failed; with role (--role) and replica
                   (--replica-id, when set); an engine adds queue_depth,
                   occupied_slots and max_slots, a paged one also
                   prefix_hit_ratio and free_blocks, one with
                   --tenant-classes also tenant_queues (queued rows
                   per class)
  GET  /metrics    Prometheus text: the request counters
                   (``ServingMetrics``) and the engine's or batcher's
                   registry, under the JAX server's families
                   (``tpu_serving_*``; ``--metrics-port`` serves it on a
                   port of its own too)
  POST /generate   {"tokens": [[...]], "max_new_tokens": N,
                    "temperature": 0.0, "top_k": 0, "top_p": 1.0,
                    "seed": 0, "deadline_s": D, "tenant": "...",
                    "traceparent": "00-..."}
                   (temperature 0 = greedy; deadline_s, tenant (else
                   the X-Tenant-Class header) and traceparent (else the
                   W3C traceparent header) reach an engine only)
                   → {"tokens": [[...]], "latency_s": ...,
                      "sampler": {"temperature", "top_k", "top_p"}}
                   → 429 {"error", "shed": reason[, "tenant"]} when an
                      engine sheds the request (queue_full, deadline,
                      quota, class_share); 500 on any other error
  POST /debug/flight  dump the flight recorder's bundle now
                   (``--flight-recorder``) → {"bundle": path}; 503
                   when it is off, 429 when its rate limit held it
  POST /kv/export  {"tokens": [...], "traceparent": "00-..."}
                   → {"frames": [...]}: the longest cached prefix of
                   the prompt as a handoff stream (``kvcache/handoff.py``,
                   the JAX wire), ``{"frames": []}`` on a miss or a
                   dense engine
  POST /kv/install {"frames": [...]} → the install summary
                   (installed_blocks, duplicate_blocks, n_tokens,
                   nbytes, traceparent); for both: 503 before ready, 409
                   on a desync, 503 on another handoff error, 501 for a
                   model with no engine, 502 on any other error

Sampler params snap to the JAX server's whitelist grids
(sanitize_sampler). Sampled requests draw from a ``torch.Generator``
seeded with the request's ``seed``: reproducible here, but not the
tokens the JAX server samples for the same seed.

The engine's overload and failure handling is the JAX engine's: a
bounded admission queue (``--max-queue``), per-request deadlines,
tenant classes (``--tenant-classes``: queue shares and token-rate
quotas), step retries with jittered backoff (``--step-retries``),
drains that migrate in-flight rows to fresh slots (``drain``,
``faults.reactor.ServingDrainer``), and an armed fault plan
(``--fault-plan``) whose faults fire before the prefill, chunk and
verify dispatches.

Observability, the JAX server's: the engine keeps its instruments
(steps, prefills, chunks, phase seconds, TTFT and TPOT histograms,
occupancy, KV blocks, prefix hits, speculation) on its registry and
``stats()`` reads them back; ``--event-log`` writes its structured
events (retired requests, sheds, retries, migrations) and the fault
plan's; ``--slo-ttft-ms``/``--slo-tpot-ms`` classify every retired or
shed request (``ServingSLO``); ``--chip-accounting`` attributes each
dispatch's host wall to the rows it served
(``obs.devicetime.DeviceTimeLedger``) and models the card's memory by
component (``obs.hbm.HbmModel``); ``--trace-out`` writes the request
and engine spans as a Chrome trace; ``--profile-dir`` brackets the
same run with ``torch.profiler`` (``utils.profiling``);
``--flight-recorder`` keeps a black box of recent snapshots and
``--alert-rules`` evaluates burn-rate rules over the registries. Each
costs one ``is None`` check per hook when its flag is off.

Cross-replica KV handoff, the JAX server's (``kv_export`` /
``kv_install``, ``--role``, ``--replica-id``): a prefill replica ships a
cached prompt's blocks, K/V bytes and radix entry, to a decode replica,
whose next admission of that prompt reuses them instead of prefilling.
The stream is JAX's byte for byte, so either package installs the
other's; the install writes the pools in place.

``--compile-cache-dir`` arms the persistent compile cache
(``warmstart/cache.py``) keyed as JAX keys it: the kernel builds land
there, so a replacement replica builds nothing. The fleet tier runs
port replicas: the port's copies of the router and the autoscaler
(``fleet/``) and its hermetic drills (``fleet/sim.py``,
``fleet/disagg.py``, ``faults/storm.py``).

Tensor-parallel serving, the JAX server's ``--tp``: the port runs one
process per GPU, so ``--tp N > 1`` is a world of N processes joined
through the worker-identity env contract (``join_tp_world``; ``--tp``
must equal the world's size). Every rank holds its Megatron shards
(``models/tp_serving.py``: attention at n_heads/N and n_kv_heads/N heads,
the caches at the rank's heads, one all-reduce of each row-parallel
product's f32 partials over NCCL; ``--overlap`` takes the ring collective
matmuls of ``parallel/overlap.py`` for a prefill where they apply).
Rank 0 serves HTTP. Under ``--continuous-batching`` its engine announces
every device call and every page-table mutation over the lockstep
engine link (``LockstepEngineLink``, a gloo group on the host), and the
other ranks replay them (``engine_follower_loop``); without it,
``LockstepModel`` broadcasts each request and ``follower_loop`` replays
it. ``--link-timeout-s`` bounds every link collective: a rank that
vanishes gives ``link_wedged`` on the engine's stream, rank 0 fails its
requests in flight and exits for its supervisor (``_wedge_abort``).
On one host (every rank under one name of the worker-identity
contract, JAX's one-process ``--tp``) the linked engine keeps what
JAX's does there: ``--speculate`` (rank 0 proposes, every rank replays
each verify round and the token its accept leaves), KV handoff on
JAX's wire (an export gathers every rank's heads to rank 0, an install
is verified there and each rank writes its own heads) and
``--step-retries`` (a fault before the dispatch's announce is retried;
one after is not). A world across hosts refuses all three, with JAX's
messages (``--speculate`` falls back to off). ``fleet/linksim.py``
drives the link's faults hermetically; ``fleet/flightdrill.py`` wedges
it and reads the flight recorder's bundle. A model with
experts (``n_experts > 0``) is served by ``Model``, ``BatchingModel``
and every engine, under ``--tp`` and ``--quantize int8`` too (its
attention projections int8, its experts in the model's dtype, as JAX's
``quantize_params``); as in JAX no flag builds one: it is reached
through ``Model(cfg)``. Its FFN routes per leading-dim group of each
program (``parallel/moe.moe_ffn``: a prefill's bucket, a segment, a
decode step's one token a row, a verify row), with capacity from that
group's padded length, as JAX's programs route.

  python -m container_engine_accelerators_tpu_torch.models.serve_cli \\
      --preset llama3-8b --port 8000
  python -m container_engine_accelerators_tpu_torch.models.serve_cli \\
      --preset llama3-8b --batch-window-ms 5
  python -m container_engine_accelerators_tpu_torch.models.serve_cli \\
      --preset llama3-8b --continuous-batching
  python -m container_engine_accelerators_tpu_torch.models.serve_cli \\
      --preset llama3-8b --continuous-batching --kv-cache paged
  python -m container_engine_accelerators_tpu_torch.models.serve_cli \\
      --preset llama3-8b --continuous-batching --kv-cache paged \\
      --speculate ngram
  python -m container_engine_accelerators_tpu_torch.models.serve_cli \\
      --preset llama3-8b --quantize int8 --continuous-batching
  # one of 8 processes (LOCAL_RANK 0..7, LOCAL_WORLD_SIZE=8, with
  # TPU_WORKER_ID and TPU_WORKER_HOSTNAMES set):
  python -m container_engine_accelerators_tpu_torch.models.serve_cli \\
      --preset llama3-8b --tp 8 --continuous-batching --link-timeout-s 30
"""

import argparse
import base64
import collections
import dataclasses
import functools
import itertools
import json
import logging
import math
import os
import queue
import random
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from container_engine_accelerators_tpu_torch import faults
from container_engine_accelerators_tpu_torch import spec as spec_pkg
from container_engine_accelerators_tpu_torch.fleet import (
    tenants as fleet_tenants,
)
from container_engine_accelerators_tpu_torch.kvcache import (
    handoff as kv_handoff,
)
from container_engine_accelerators_tpu_torch.kvcache.blockpool import (
    PoolExhausted,
)
from container_engine_accelerators_tpu_torch.kvcache.manager import (
    PagedKVManager,
)
from container_engine_accelerators_tpu_torch.models import quantization as q8
from container_engine_accelerators_tpu_torch.models import serving_graphs
from container_engine_accelerators_tpu_torch.models import tp_serving
from container_engine_accelerators_tpu_torch.models import transformer as tf
from container_engine_accelerators_tpu_torch.obs import alerts as obs_alerts
from container_engine_accelerators_tpu_torch.obs import (
    devicetime as obs_devicetime,
)
from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import flight as obs_flight
from container_engine_accelerators_tpu_torch.obs import hbm as obs_hbm
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics
from container_engine_accelerators_tpu_torch.obs import ports as obs_ports
from container_engine_accelerators_tpu_torch.obs import trace as obs_trace
from container_engine_accelerators_tpu_torch.ops import paged_attention as pa
from container_engine_accelerators_tpu_torch.parallel import (
    tensor_parallel as tpar,
)
from container_engine_accelerators_tpu_torch.utils import profiling
from container_engine_accelerators_tpu_torch.warmstart import (
    cache as ws_cache,
)
from container_engine_accelerators_tpu_torch.warmstart import (
    warmup as ws_warmup,
)

log = logging.getLogger("serve_cli")

READY_LINE = "tpu-serving ready"

# Continuous batching: default KV slots (concurrent requests), as in the
# JAX server.
MAX_BATCH = 8
# LockstepModel's shutdown broadcast (a batch of -1 rows).
_SHUTDOWN = -1
# --quantize's choices, the JAX server's.
QUANTIZE_MODES = ("none", "int8")
# The JAX server's histogram bucket bounds.
TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                30.0)
TPOT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0)
QUEUE_WAIT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                      30.0)
LATENCY_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


# Typed sheds, the JAX server's: the HTTP layer maps each to a 429
# carrying its ``reason``.
class ShedError(RuntimeError):
    """Typed load-shedding rejection: the server chose not to take the
    request (overload or expired deadline) — retriable by the client,
    categorically different from a failed decode. The HTTP layer maps it
    to 429; ``reason`` is the ``tpu_serving_requests_shed_total`` label."""

    reason = "shed"


class QueueFull(ShedError):
    """The bounded admission queue is at capacity (``max_queue``)."""

    reason = "queue_full"


class DeadlineExceeded(ShedError):
    """The request's deadline expired before it won a slot."""

    reason = "deadline"


class QuotaExceeded(ShedError):
    """The request's tenant class outran its token-rate quota
    (``--tenant-classes`` ``rate_tokens_per_s``): an admission-policy
    shed, not an overload signal. ``tenant`` names the shedding
    class."""

    reason = "quota"

    def __init__(self, message, tenant="default"):
        super().__init__(message)
        self.tenant = tenant


class ClassShareExceeded(ShedError):
    """The request's tenant class filled its weighted share of the
    bounded admission queue (``queue_share`` x ``--max-queue``): the
    burst sheds itself while other classes' headroom survives. Policy,
    not overload (see :class:`QuotaExceeded`)."""

    reason = "class_share"

    def __init__(self, message, tenant="default"):
        super().__init__(message)
        self.tenant = tenant


class LoopTimeout(TimeoutError):
    """A ``run_on_loop`` call the engine loop did not take up within its
    ``timeout_s``: it was withdrawn and never runs."""


def _wire_dtype(dtype):
    """A cache dtype's name on the handoff wire: numpy's, as JAX writes
    it (``"bfloat16"``, ``"float16"``, ``"float32"``), never
    ``"torch.bfloat16"``."""
    return str(dtype).removeprefix("torch.")


class ServingSLO:
    """Per-request SLO classification, the JAX server's: every retired
    request is judged against the TTFT and TPOT objectives, and every
    shed (queue full, expired deadline, tenant policy) counts against
    the error budget. Exposes
    ``tpu_serving_slo_requests_total{outcome,tenant_class}`` (outcomes
    ``good``, ``slow_ttft``, ``slow_tpot``, ``shed``; tenant_class a
    configured ``--tenant-classes`` name, else ``default``) and the
    ``tpu_serving_slo_goodput_ratio`` gauge over the trailing
    ``window`` requests, which the burn-rate alert rules read. An engine
    holds one only when ``--slo-ttft-ms`` or ``--slo-tpot-ms`` is set
    (``_make_slo``); ``slo=None`` costs the retire path one check."""

    def __init__(self, ttft_s=0.0, tpot_s=0.0, registry=None,
                 window=512):
        self.ttft_s = float(ttft_s)
        self.tpot_s = float(tpot_s)
        self.registry = registry if registry is not None \
            else obs_metrics.Registry()
        self.requests = obs_metrics.Counter(
            "tpu_serving_slo_requests_total",
            "Requests classified against the serving SLO (sheds and "
            "expired deadlines count against the budget), per tenant "
            "class (\"default\" when tenant admission is off)",
            ["outcome", "tenant_class"], registry=self.registry)
        self._ring = collections.deque(maxlen=window)
        self._lock = threading.Lock()
        obs_metrics.Gauge(
            "tpu_serving_slo_goodput_ratio",
            "Fraction of the trailing requests meeting the SLO "
            "(1.0 until the first request)", registry=self.registry,
        ).set_function(self.goodput_ratio)

    def goodput_ratio(self):
        with self._lock:
            if not self._ring:
                return 1.0
            return sum(self._ring) / len(self._ring)

    def _record(self, outcome, tenant_class):
        self.requests.labels(outcome, tenant_class or "default").inc()
        with self._lock:
            self._ring.append(1.0 if outcome == "good" else 0.0)
        return outcome

    def classify_retired(self, ttft_s, tpot_s, tenant_class="default"):
        """Outcome for one retired request (``tpot_s`` None when fewer
        than two tokens were generated: TPOT undefined, not violated)."""
        if self.ttft_s and ttft_s is not None and ttft_s > self.ttft_s:
            return self._record("slow_ttft", tenant_class)
        if self.tpot_s and tpot_s is not None and tpot_s > self.tpot_s:
            return self._record("slow_tpot", tenant_class)
        return self._record("good", tenant_class)

    def record_shed(self, reason, tenant_class="default"):
        del reason  # the shed counter carries it; the SLO label stays bounded
        return self._record("shed", tenant_class)


def _total(counter):
    """A labeled counter's sum over its series (0.0 before the first)."""
    return sum(child.value for _, child in counter._series())


# Sampler whitelists, copied from the JAX server so both snap client
# values to the same grids (values float32-exact).
def _f32_exact(values):
    return tuple(float(np.float32(v)) for v in values)


TEMPERATURE_BUCKETS = _f32_exact((0.0, 0.3, 0.5, 0.7, 1.0, 1.3, 1.7, 2.0))
TOP_P_BUCKETS = _f32_exact((0.8, 0.9, 0.95, 1.0))
TOP_K_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64)


def _snap(value, buckets):
    return min(buckets, key=lambda b: abs(b - value))


def sanitize_sampler(temperature, top_k, top_p, vocab_size):
    """Snap client sampler params to the whitelist grids; greedy
    (temperature 0) canonicalizes top_k/top_p."""
    temperature = _snap(float(temperature), TEMPERATURE_BUCKETS)
    if temperature == 0.0:
        return 0.0, 0, 1.0
    top_p = _snap(float(top_p), TOP_P_BUCKETS)
    k_buckets = tuple(b for b in TOP_K_BUCKETS if b <= vocab_size) or (0,)
    top_k = int(_snap(max(int(top_k), 0), k_buckets))
    return temperature, top_k, top_p


class Model:
    """The served model. Random weights from ``seed`` on ``device``
    (CUDA unless the caller asks for the CPU), or the given ``weights``
    (a ``transformer.Transformer``, e.g. bridged from JAX).
    ``quantize="int8"`` quantizes the layer matrices in place
    (``quantization.quantize_params``, W8A16) before anything is built
    on them, as the JAX ``Model`` does. Its decoder (``decode_graphs``)
    keeps a dense cache per recent batch size (at most
    ``serving_graphs.MAX_CACHED_ROWS`` rows in all) and, on CUDA, their
    decode steps' graphs per (batch, window); ``lock`` serialises the
    requests that use them.

    ``tp > 1`` serves Megatron-style tensor-parallel shards
    (``models/tp_serving.py``, JAX's ``Model(cfg, tp=...)``): over
    ``axes`` (``tensor_parallel.Axes``: ``Axes.of_mesh`` for this
    process's rank of a world of one process per GPU; default
    ``Axes.in_process(tp)``, every rank in this process). Each rank
    materialises only its own shard (``tp_serving.init_shards``; the
    merged shards are ``transformer.init_params(cfg, seed)``), or takes
    its piece of ``weights``; int8 quantizes the shards as the whole
    weight would be (``tp_serving.quantize_shards``). ``self.model`` is
    then a ``tp_serving.ShardedModel``, which every serving program
    takes."""

    def __init__(self, cfg, seed=0, device="cuda", weights=None,
                 quantize="none", tp=1, axes=None):
        if quantize not in QUANTIZE_MODES:
            raise ValueError(f"quantize must be one of {QUANTIZE_MODES}, "
                             f"got {quantize!r}")
        self.cfg = cfg
        if tp > 1:
            if axes is None:
                axes = tpar.Axes.in_process(tp=tp)
            if axes.tp.size != tp:
                raise ValueError(f"--tp={tp} needs {tp} devices, have "
                                 f"{axes.tp.size}")
            if weights is None:
                sharded = tp_serving.init_shards(cfg, axes, device=device,
                                                 seed=seed)
            else:
                sharded = tp_serving.split(weights, axes)
            if quantize == "int8":
                tp_serving.quantize_shards(sharded)
            weights = sharded
        else:
            if weights is None:
                weights = tf.init_params(cfg, device=device, seed=seed)
            if quantize == "int8":
                q8.quantize_params(weights)
        self.model = weights
        self.device = weights.device
        self.decode_graphs = serving_graphs.DenseDecodeGraphs(weights)
        self.lock = threading.Lock()

    def generate(self, tokens, max_new_tokens, temperature=0.0, top_k=0,
                 top_p=1.0, seed=0):
        temperature, top_k, top_p = sanitize_sampler(
            temperature, top_k, top_p, self.cfg.vocab_size
        )
        prompt = torch.as_tensor(tokens, dtype=torch.long,
                                 device=self.device)
        generator = None
        if temperature:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        with self.lock:
            out = tf.generate(
                self.model, prompt, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                generator=generator, decoder=self.decode_graphs,
            )
        return out.tolist()


class BatchingModel:
    """Dynamic micro-batching (``--batch-window-ms``), the port of the
    JAX ``BatchingModel``: concurrent compatible requests coalesce into
    one ``generate`` call of the wrapped model.

    A dispatcher thread drains a queue through a FIFO reorder buffer: a
    round starts from the oldest waiting request, scoops the buffered
    requests compatible with it (the same prompt length and
    ``max_new_tokens``, greedy), then waits up to ``window_ms`` for more,
    up to ``max_batch`` rows in all. An incompatible request is deferred
    to the buffer, where it seeds a later round, instead of closing the
    window. The output rows fan back to the waiting handler threads.
    Sampled requests carry their own seeds, so they run alone on the
    wrapped model; ragged rows are rejected before they are queued, so a
    malformed request fails alone. When a coalesced call fails, each
    waiter raises its own exception, chained from the call's.

    Its instruments are the JAX batcher's, on ``registry`` (a fresh
    ``obs.metrics.Registry`` when None): ``tpu_serving_batch_rows`` (the
    rows of the last coalesced call) and
    ``tpu_serving_batcher_queue_wait_seconds`` (enqueue to dispatch, per
    request); ``n_batches`` counts the coalesced calls made. Each call
    is a ``coalesced_batch`` span when tracing."""

    def __init__(self, model, window_ms=5.0, max_batch=MAX_BATCH,
                 registry=None):
        self.model = model
        self.cfg = model.cfg
        self.window_s = window_ms / 1e3
        self.max_batch = max_batch
        self.registry = registry if registry is not None \
            else obs_metrics.Registry()
        self._m_batch_rows = obs_metrics.Gauge(
            "tpu_serving_batch_rows",
            "Rows coalesced into the last shared device call",
            registry=self.registry)
        # Not the engine's tpu_serving_queue_wait_seconds: another wait,
        # and one scrape may render both registries.
        self._m_queue_wait = obs_metrics.Histogram(
            "tpu_serving_batcher_queue_wait_seconds",
            "Enqueue -> dispatch wait inside the micro-batcher",
            buckets=QUEUE_WAIT_BUCKETS, registry=self.registry)
        self.n_batches = 0
        self._q = queue.Queue()
        self._lock = threading.Lock()
        self._stopped = False
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()

    def generate(self, tokens, max_new_tokens, temperature=0.0, top_k=0,
                 top_p=1.0, seed=0):
        # Route on the snapped sampler: small temperatures snap to greedy.
        temperature, top_k, top_p = sanitize_sampler(
            temperature, top_k, top_p, self.cfg.vocab_size
        )
        if temperature != 0.0:
            return self.model.generate(
                tokens, max_new_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, seed=seed,
            )
        if not tokens or any(len(r) != len(tokens[0]) for r in tokens):
            raise ValueError(
                "tokens must be a non-empty rectangular list of rows"
            )
        item = {
            "tokens": [list(r) for r in tokens],
            "max_new": int(max_new_tokens),
            "event": threading.Event(),
            "out": None,
            "err": None,
            "t_enq": obs_trace.now(),
        }
        with self._lock:
            if self._stopped:
                raise RuntimeError("batcher is shut down")
            self._q.put(item)
        item["event"].wait()
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def shutdown(self):
        """Stop the dispatcher once it has run what is queued, then the
        wrapped model's own shutdown, where it has one."""
        with self._lock:
            self._stopped = True
            self._q.put(None)
        self._thread.join(60.0)
        inner = getattr(self.model, "shutdown", None)
        if inner is not None:
            inner()

    @staticmethod
    def _compatible(a, b):
        return (a["max_new"] == b["max_new"]
                and len(a["tokens"][0]) == len(b["tokens"][0]))

    def _dispatch(self):
        buf = collections.deque()
        stopping = False
        while buf or not stopping:
            if buf:
                batch = [buf.popleft()]
            else:
                first = self._q.get()
                if first is None:
                    stopping = True
                    continue
                batch = [first]
            rows = len(batch[0]["tokens"])
            # Buffered compatible requests first, in arrival order.
            kept = collections.deque()
            while buf:
                item = buf.popleft()
                if self._compatible(batch[0], item) and \
                        rows + len(item["tokens"]) <= self.max_batch:
                    batch.append(item)
                    rows += len(item["tokens"])
                else:
                    kept.append(item)
            buf = kept
            deadline = time.perf_counter() + self.window_s
            while rows < self.max_batch and not stopping:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    stopping = True
                elif self._compatible(batch[0], nxt) and \
                        rows + len(nxt["tokens"]) <= self.max_batch:
                    batch.append(nxt)
                    rows += len(nxt["tokens"])
                else:
                    buf.append(nxt)  # deferred: it seeds a later round
            self._run(batch)

    def _run(self, batch):
        all_rows = [r for item in batch for r in item["tokens"]]
        self._m_batch_rows.set(len(all_rows))
        now = obs_trace.now()
        for item in batch:
            self._m_queue_wait.observe(now - item["t_enq"])
        self.n_batches += 1
        try:
            with obs_trace.span("coalesced_batch", rows=len(all_rows),
                                requests=len(batch)):
                out = self.model.generate(all_rows, batch[0]["max_new"])
        except Exception as e:  # noqa: BLE001 - fan the error out
            for item in batch:
                # Each waiter raises its own exception object.
                item["err"] = RuntimeError(f"co-batched generate failed: {e}")
                item["err"].__cause__ = e
                item["event"].set()
            return
        i = 0
        for item in batch:
            n = len(item["tokens"])
            item["out"] = out[i:i + n]
            i += n
            item["event"].set()


def normalize_chunks(max_seq_len, prefill_chunk, chunk):
    """The engine's chunk normalization (the JAX ``normalize_chunks``):
    returns the ``(prefill_chunk, chunk)`` a :class:`ContinuousEngine`
    built with these arguments uses. Both round down to a power of two;
    the prefill chunk must divide ``max_seq_len`` (else the tail
    segment's padded write would run past the context end), so it
    shrinks to a dividing power of two of at least 64, or becomes
    ``max_seq_len`` (single-shot)."""
    if prefill_chunk < 1 or chunk < 1:
        raise ValueError(
            f"chunk ({chunk}) and prefill_chunk ({prefill_chunk}) "
            f"must be >= 1"
        )
    if chunk & (chunk - 1):
        chunk = 1 << (chunk.bit_length() - 1)
        log.warning("decode chunk rounded down to power of two: %d", chunk)
    if prefill_chunk & (prefill_chunk - 1):
        prefill_chunk = 1 << (prefill_chunk.bit_length() - 1)
        log.warning("prefill chunk rounded down to power of two: %d",
                    prefill_chunk)
    if max_seq_len % prefill_chunk:
        adjusted = prefill_chunk
        while adjusted >= 64 and max_seq_len % adjusted:
            adjusted //= 2
        if adjusted >= 64 and max_seq_len % adjusted == 0:
            log.warning("prefill chunk %d does not divide max_seq_len %d; "
                        "using %d", prefill_chunk, max_seq_len, adjusted)
            prefill_chunk = adjusted
        else:
            log.warning("max_seq_len %d has no usable power-of-two prefill "
                        "chunk; chunked prefill disabled (single-shot only)",
                        max_seq_len)
            prefill_chunk = max_seq_len
    return prefill_chunk, chunk


def verify_batch_sizes(max_slots):
    """The power-of-two (capped at ``max_slots``) batch sizes a batched
    speculative verify can dispatch: one derivation shared by the
    engine's dispatch bucketing and the warm plan (the JAX
    ``verify_batch_sizes``). Sizing the batch to the speculating-row
    count keeps a sparse round from paying for padding rows; the price is
    one graph per (batch bucket, window)."""
    out = set()
    b = 1
    while b < max_slots:
        out.add(b)
        b <<= 1
    out.add(max_slots)
    return sorted(out)


def speculate_grid(speculate_k, max_seq_len):
    """A speculating engine's (k_max, verify width) from
    ``--speculate-k`` (the JAX ``speculate_grid``): k_max is the
    power-of-two floor; the width is the bucket of k_max + 1 (the fed
    token plus the proposals)."""
    k_max = 1 << (max(int(speculate_k), 1).bit_length() - 1)
    return k_max, tf._length_bucket(k_max + 1, max_seq_len)


SPECULATE_MODES = ("off", "ngram", "draft")


# -- the lockstep engine link --------------------------------------------
#
# Tensor-parallel serving runs one process per GPU: rank 0's engine loop
# decides the schedule and announces every device call (and every page-table
# mutation of a paged engine) over the link, and the other ranks replay them
# in broadcast order, so every rank runs the same programs on the same
# operands and their per-layer collectives line up (the JAX server's
# multi-host engine link, serve_cli.py:490-1380). The announcements
# travel over a gloo group on the host (``join_tp_world``), apart from the
# NCCL group of the per-layer all-reduces, so a follower blocked on the
# link holds no CUDA stream.

# Engine-link opcodes, the JAX server's.
_OP_SHUTDOWN = 0
_OP_PREFILL = 1
_OP_PREFILL_SEG = 2
_OP_CHUNK = 3
_OP_RESET = 4
_OP_GENERATE = 5
# Bring-up handshake: the leader's config digest (LinkConfigMismatch on
# drift).
_OP_HELLO = 6
# A paged engine's manager mutations as page-table delta ops, in dispatch
# order, and its device dispatches.
_OP_KV_ADMIT = 7
_OP_KV_ENSURE = 8
_OP_KV_COW = 9
_OP_KV_RELEASE = 10
_OP_KV_FINISH = 11
_OP_KV_DROP = 12
_OP_KV_RESET = 13
_OP_PAGED_PREFILL = 14
_OP_PAGED_CHUNK = 15
# The port's one-host additions (JAX refuses all three under its link,
# which only a world across hosts has): a speculating engine's batched
# verify and the last token its accept leaves in ``last_dev``, and the
# two halves of a KV handoff (an export's gather of every rank's heads,
# an install's bytes).
_OP_PAGED_VERIFY = 16
_OP_SPEC_ACCEPT = 17
_OP_KV_EXPORT = 18
_OP_KV_INSTALL = 19

# The bounded op-name enum of the link ops counter's label.
_OP_NAMES = {
    _OP_SHUTDOWN: "shutdown", _OP_PREFILL: "prefill",
    _OP_PREFILL_SEG: "prefill_seg", _OP_CHUNK: "chunk",
    _OP_RESET: "reset", _OP_GENERATE: "generate", _OP_HELLO: "hello",
    _OP_KV_ADMIT: "kv_admit", _OP_KV_ENSURE: "kv_ensure",
    _OP_KV_COW: "kv_cow", _OP_KV_RELEASE: "kv_release",
    _OP_KV_FINISH: "kv_finish", _OP_KV_DROP: "kv_drop",
    _OP_KV_RESET: "kv_reset", _OP_PAGED_PREFILL: "paged_prefill",
    _OP_PAGED_CHUNK: "paged_chunk", _OP_PAGED_VERIFY: "paged_verify",
    _OP_SPEC_ACCEPT: "spec_accept", _OP_KV_EXPORT: "kv_export",
    _OP_KV_INSTALL: "kv_install",
}

# Header layout: [0] op, [1..7] its args, [8] op_seq (monotone: a dropped
# broadcast is a visible gap), [9] the payload digest (crc32 over op, args,
# floats and payload: a corrupted broadcast is a visible mismatch),
# [10..11] reserved.
_LINK_HEADER_INTS = 12

# Fault-injection site: one tick per announced op. ``drop`` (never
# broadcast: followers see a seq gap), ``delay`` (the collective stalls
# delay_s inside the watchdog window), ``corrupt_payload`` (delivered bytes
# differ from the digested ones), ``follower_vanish`` (a loopback rank stops
# consuming). A free no-op when disarmed.
LINK_FAULT_SITE = "serving.link"

# Wall seconds blocked inside one lockstep collective.
LINK_WAIT_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
                     5.0, 30.0)


class LinkError(RuntimeError):
    """Base of every lockstep-link failure (typed, so a supervisor tells
    a link fault from a device failure)."""


class LinkWedgedError(LinkError):
    """A collective did not complete within ``--link-timeout-s`` (or the
    transport lost a rank): the link already emitted ``link_wedged``."""


class LinkDesyncError(LinkError):
    """The op stream diverged between ranks (sequence gap, digest
    mismatch, KV replay divergence): the follower aborts before
    dispatching the divergent op."""


class LinkConfigMismatch(LinkError):
    """Bring-up handshake failure: the follower's engine config digest
    differs from the leader's."""


def link_config_digest(cfg, max_slots, prefill_chunk, chunk,
                       kv_cache="dense", kv_block_size=0, kv_blocks=0):
    """crc32 of the serving config the lockstep ranks must agree on (the
    transformer config, the slot and chunk geometry, the paged cache's
    settings), JAX's: each side computes it from its own engine's final
    settings."""
    import zlib

    desc = json.dumps({
        "cfg": {k: str(v)
                for k, v in sorted(dataclasses.asdict(cfg).items())},
        "max_slots": int(max_slots),
        "prefill_chunk": int(prefill_chunk),
        "chunk": int(chunk),
        "kv_cache": kv_cache,
        "kv_block_size": int(kv_block_size),
        "kv_blocks": int(kv_blocks),
    }, sort_keys=True)
    return zlib.crc32(desc.encode()) & 0x7FFFFFFF


def engine_link_digest(engine):
    """The handshake digest of ``engine``'s final settings."""
    kv = getattr(engine, "kv", None)
    return link_config_digest(
        engine.cfg, engine.max_slots, engine.prefill_chunk,
        engine.chunk, kv_cache=engine.kv_cache,
        kv_block_size=kv.block_size if kv is not None else 0,
        kv_blocks=kv.num_blocks if kv is not None else 0,
    )


def _host_broadcast(payload, group):
    """Rank 0's fixed-shape arrays on every rank of ``group`` (the
    counterpart of JAX's ``broadcast_one_to_all``): ``payload`` is a
    numpy array or a tuple of them, the values on rank 0 and buffers of
    the same shapes and dtypes elsewhere; returns the same structure."""
    import torch.distributed as dist

    single = not isinstance(payload, tuple)
    out = []
    for a in ((payload,) if single else payload):
        t = torch.from_numpy(np.array(a, copy=True))
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        out.append(t.numpy())
    return out[0] if single else tuple(out)


class LinkWatchdog:
    """Bounds each lockstep collective, JAX's: the link arms a deadline
    before every blocking broadcast and disarms on return; this daemon
    thread fires when a deadline expires with the collective still
    blocked, emitting ``link_wedged`` and calling the link's
    ``on_wedge``. No thread exists until the first arm, and a link with
    ``timeout_s == 0`` has no watchdog."""

    def __init__(self, link):
        self.link = link
        self._cond = threading.Condition()
        self._armed = None  # (gen, deadline, op, op_seq, t0)
        self._gen = 0
        self._thread = None

    def arm(self, op, op_seq, deadline_s):
        with self._cond:
            self._gen += 1
            now = time.monotonic()
            self._armed = (self._gen, now + deadline_s, op, op_seq, now)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="link-watchdog"
                )
                self._thread.start()
            self._cond.notify()
            return self._gen

    def disarm(self, gen):
        with self._cond:
            if self._armed is not None and self._armed[0] == gen:
                self._armed = None
                self._cond.notify()

    def _run(self):
        while True:
            with self._cond:
                while self._armed is None:
                    self._cond.wait()
                gen, deadline, op, op_seq, t0 = self._armed
                now = time.monotonic()
                if now < deadline:
                    self._cond.wait(deadline - now)
                    continue
                self._armed = None
                stalled = now - t0
            # An observer's self-report: the watchdog cannot name the
            # vanished rank, only that this rank's collective stalled.
            self.link._wedge(self.link.rank, op, op_seq, stalled,
                             culprit=False)


class LockstepEngineLink:
    """The broadcast channel between rank 0's ``ContinuousEngine`` and the
    follower replayers, the JAX server's: supervised, observable and
    fault-injectable.

    One fixed-shape payload per announcement: ints (12,) int32 carrying
    the opcode and every shape argument (bucket, window, steps,
    want_logits, mask_writes), the monotone ``op_seq`` and the payload
    digest; floats (2,) float32 (a solo generate's sampler); and an int32
    array holding the op's dense operand (a padded prompt row, a prefill
    segment, a chunk's host state, a page-table delta's tokens). Every
    announcement goes through one lock, so the followers run in exactly
    broadcast order.

    Supervision (off by default: ``timeout_s=0`` arms nothing):

      * ``timeout_s`` arms a :class:`LinkWatchdog` around every
        collective; a vanished rank gives ``link_wedged{rank, op_seq,
        stalled_s}``, ``tpu_serving_link_wedges_total`` and the
        ``on_wedge(rank, op_seq)`` callback instead of a silent hang; a
        broadcast that fails (the gloo transport lost a peer) is reported
        the same way and raises :class:`LinkWedgedError`;
      * every op carries a sequence number and a digest: a follower
        seeing a gap or a mismatch emits ``link_desync{rank, op_seq}``
        and raises :class:`LinkDesyncError` before dispatching;
      * ``transport`` replaces the broadcast over ``group`` (a gloo
        group of the world, ``join_tp_world``) with an in-process loopback
        (``fleet/linksim.py``), so multi-rank chaos drills run
        hermetically; ``rank_hosts`` (the TPU_WORKER_HOSTNAMES contract)
        lets link events name the culprit's node for the fleet reactor.
    """

    def __init__(self, cfg, max_slots, prefill_chunk=None,
                 transport=None, timeout_s=0.0, rank=0, rank_hosts=(),
                 events=None, registry=None, on_wedge=None, group=None):
        self.cfg = cfg
        self.max_slots = max_slots
        self.prefill_chunk = prefill_chunk
        # Reentrant: the leader holds it across announce and dispatch,
        # and announce takes it again.
        self.lock = threading.RLock()
        self.transport = transport
        self.group = group
        self.timeout_s = float(timeout_s)
        self.rank = int(rank)
        self.rank_hosts = list(rank_hosts)
        self.events = events
        self.on_wedge = on_wedge
        # Leader: the next op_seq to stamp. Follower: the next expected
        # (None until the first op: a (re)joining rank adopts the
        # leader's position).
        self._seq = 0
        self._expect = None
        # Follower: its own engine's digest, checked against every hello
        # (set by engine_follower_loop).
        self.local_digest = None
        # (op_seq, rank) pairs already reported wedged.
        self._wedged_ops = set()
        self._watchdog = LinkWatchdog(self) if self.timeout_s else None
        # Per thread: the ops this thread announced (a step retry asks
        # whether its failed attempt committed the followers to anything).
        self._announced = threading.local()
        self._m_ops = self._m_wedges = self._m_desyncs = None
        self._m_wait = None
        if registry is not None:
            self._m_ops = obs_metrics.get_or_create(
                obs_metrics.Counter, "tpu_serving_link_ops_total",
                "Lockstep engine-link ops announced/replayed, by op "
                "(bounded opcode enum)", labelnames=("op",),
                registry=registry)
            self._m_wedges = obs_metrics.get_or_create(
                obs_metrics.Counter, "tpu_serving_link_wedges_total",
                "Lockstep collectives that exceeded --link-timeout-s "
                "(a rank vanished or stalled)", registry=registry)
            self._m_desyncs = obs_metrics.get_or_create(
                obs_metrics.Counter, "tpu_serving_link_desyncs_total",
                "Op-stream divergences detected before dispatch "
                "(sequence gap, digest mismatch, or KV replay "
                "divergence)", registry=registry)
            self._m_wait = obs_metrics.get_or_create(
                obs_metrics.Histogram,
                "tpu_serving_link_op_wait_seconds",
                "Wall seconds blocked inside one lockstep collective "
                "(the watchdog bounds the tail)",
                buckets=LINK_WAIT_BUCKETS, registry=registry)

    def _bcast(self, payload):
        return _host_broadcast(payload, self.group)

    @property
    def spans_hosts(self):
        """Whether the world's ranks sit on more than one host: the
        port's counterpart of JAX's ``jax.process_count() > 1``, the one
        case where JAX builds its link and refuses speculation, KV
        handoff and step retries over it. On one host the port's linked
        world keeps all three, as JAX's one-process ``--tp`` does."""
        return len({h for h in self.rank_hosts if h}) > 1

    def announced_here(self):
        """How many ops the calling thread has announced so far."""
        return getattr(self._announced, "n", 0)

    def gather(self, tensor):
        """Every rank's ``tensor`` (one shape and dtype on every rank, on
        the host) on rank 0, in rank order; None on the other ranks: the
        collective of the op just announced (or received), over the gloo
        group under the same watchdog. An in-process transport carries
        broadcasts only."""
        import torch.distributed as dist

        if self.transport is not None:
            raise LinkError("the link's transport carries broadcasts only: "
                            "no gather for a KV export")
        op_seq = self._seq - 1 if self.rank == 0 else (self._expect or 0) - 1

        def call():
            out = None
            if self.rank == 0:
                out = [torch.empty_like(tensor) for _ in range(
                    dist.get_world_size(self.group))]
            dist.gather(tensor, out, dst=dist.get_global_rank(self.group, 0),
                        group=self.group)
            return out

        return self._supervised(_OP_KV_EXPORT, op_seq, None,
                                send=self.rank == 0, call=call)

    def _digest(self, header_i, header_f, a):
        """crc32 over the op, its args, the floats and the payload,
        computed alike on both sides from the values each uses."""
        import zlib

        d = zlib.crc32(header_i[:8].tobytes())
        d = zlib.crc32(header_f.tobytes(), d)
        if a is not None:
            d = zlib.crc32(a.tobytes(), d)
        return d & 0x7FFFFFFF

    def _node_of_rank(self, rank):
        if 0 <= rank < len(self.rank_hosts):
            return self.rank_hosts[rank]
        return ""

    def _wedge(self, rank, op, op_seq, stalled_s, culprit=True):
        """Report one wedged collective once per (op_seq, rank).
        ``culprit=False`` marks an observer's self-report (the watchdog,
        or a broadcast that failed without naming its peer): the event
        names the reporter, and the reactor drains without cordoning."""
        key = (op_seq, rank)
        if key in self._wedged_ops:
            return
        self._wedged_ops.add(key)
        if len(self._wedged_ops) > 1024:
            self._wedged_ops = {key}
        if self._m_wedges is not None:
            self._m_wedges.inc()
        if self.events is not None:
            self.events.emit(
                "link_wedged", severity="error", rank=rank,
                op_seq=op_seq, op=_OP_NAMES.get(op, str(op)),
                node=self._node_of_rank(rank),
                stalled_s=round(stalled_s, 6),
                culprit=bool(culprit),
            )
        log.error(
            "lockstep link wedged: rank %d did not complete op_seq %d "
            "(%s) within %.3fs", rank, op_seq,
            _OP_NAMES.get(op, str(op)), stalled_s,
        )
        obs_flight.trigger("link_wedged", rank=rank, op_seq=op_seq)
        if self.on_wedge is not None:
            try:
                self.on_wedge(rank, op_seq)
            except Exception:  # noqa: BLE001 - supervisor must not kill link
                log.exception("on_wedge callback failed")

    def desync(self, op_seq, reason):
        """Record one detected divergence and abort before anything
        divergent is dispatched."""
        if self._m_desyncs is not None:
            self._m_desyncs.inc()
        if self.events is not None:
            # The desyncing rank names itself: its replay diverged.
            self.events.emit(
                "link_desync", severity="error", rank=self.rank,
                op_seq=op_seq, reason=reason,
                node=self._node_of_rank(self.rank), culprit=True,
            )
        obs_flight.trigger("link_desync", op_seq=op_seq, reason=reason)
        raise LinkDesyncError(
            f"lockstep op stream diverged at op_seq {op_seq} "
            f"(rank {self.rank}): {reason}"
        )

    def _supervised(self, op, op_seq, payload, send, delay_s=0.0,
                    watch=True, call=None):
        """One blocking collective under the watchdog; ``send`` picks the
        leader's (True) or a follower's (False) side, which returns the
        received payload. ``watch=False`` (a follower waiting for the next
        op header, which an idle leader leaves it doing) arms nothing.
        ``call`` (a gather) replaces the broadcast of ``payload``. A
        collective over the gloo group that raises (a peer's process is
        gone) is reported as a wedge and raised as
        :class:`LinkWedgedError`."""
        t0 = time.perf_counter()
        gen = None
        if watch and self._watchdog is not None:
            # A timeout-capable transport names the culprit itself at
            # timeout_s (a send may block that long per dead rank): the
            # rank-blind watchdog backstops at 4x there.
            scale = 4.0 if getattr(
                self.transport, "handles_timeout", False) else 1.0
            gen = self._watchdog.arm(op, op_seq, self.timeout_s * scale)
        try:
            if delay_s:
                # An injected stall (the delay fault), inside the armed
                # window.
                time.sleep(delay_s)
            if self.transport is not None:
                if send:
                    for r in self.transport.send(
                        payload, self.timeout_s or None
                    ):
                        self._wedge(r, op, op_seq,
                                    time.perf_counter() - t0)
                    return None
                # A follower's mid-op payload waits 5x the timeout, past
                # the watchdog's 4x: link_wedged always fires first.
                return self.transport.recv(
                    payload,
                    self.timeout_s * 5.0
                    if (watch and self.timeout_s) else None,
                )
            try:
                return call() if call is not None else self._bcast(payload)
            except RuntimeError as err:
                self._wedge(self.rank, op, op_seq,
                            time.perf_counter() - t0, culprit=False)
                raise LinkWedgedError(
                    f"lockstep broadcast of op_seq {op_seq} "
                    f"({_OP_NAMES.get(op, str(op))}) failed on rank "
                    f"{self.rank}: {err}") from err
        finally:
            if gen is not None:
                self._watchdog.disarm(gen)
            if self._m_wait is not None:
                self._m_wait.observe(time.perf_counter() - t0)

    def _op_shape(self, op, ints):
        """The payload's shape for ``op``, which both sides derive from
        the header alone."""
        if op == _OP_PREFILL:
            return (1, int(ints[1]))           # the padded bucket row
        if op == _OP_PREFILL_SEG:
            return (1, int(self.prefill_chunk))
        if op == _OP_CHUNK:
            return (3, self.max_slots)         # last_tok/positions/active
        if op == _OP_GENERATE:
            return (int(ints[1]), int(ints[2]))
        if op in (_OP_KV_ADMIT, _OP_KV_FINISH):
            return (1, max(int(ints[2]), 1))   # the op's token list
        if op == _OP_PAGED_PREFILL:
            return (1, int(ints[3]))           # the padded segment
        if op == _OP_PAGED_CHUNK:
            return (2, self.max_slots)         # positions/active
        if op == _OP_PAGED_VERIFY:
            # segs, bids, offs and tables (B rows each), then positions.
            b = int(ints[1])
            return (4 * b + 1, max(b, int(ints[2]), int(ints[4])))
        if op == _OP_KV_EXPORT:
            return (1, max(int(ints[1]), 1))   # the prompt
        if op == _OP_KV_INSTALL:
            # The prefix, then each block's K and V bytes as int32 words.
            return (1 + int(ints[2]),
                    max(int(ints[1]), int(ints[3]), 1))
        return None                            # header-only ops

    def hello(self, digest):
        """The leader's bring-up (and rejoin) handshake: every follower
        checks ``digest`` against its own engine's."""
        self.announce(_OP_HELLO, ints=(int(digest),))

    def announce(self, op, ints=(), floats=(), arr_rows=()):
        """Rank 0: broadcast one op header, then its payload when the op
        carries one. Called with ``self.lock`` held across the device
        dispatch that follows, so the leader's dispatch order is its
        broadcast order (the followers dispatch in the latter)."""
        header_i = np.zeros(_LINK_HEADER_INTS, np.int32)
        header_f = np.zeros(2, np.float32)
        header_i[0] = op
        for idx, v in enumerate(ints):
            header_i[1 + idx] = int(v)
        for idx, v in enumerate(floats):
            header_f[idx] = float(v)
        with self.lock:
            shape = self._op_shape(op, header_i)
            a = None
            if shape is not None:
                a = np.zeros(shape, np.int32)
                for idx, row in enumerate(arr_rows):
                    row = np.asarray(row).reshape(-1)
                    a[idx, : row.shape[0]] = row
            op_seq = self._seq
            self._seq += 1
            self._announced.n = self.announced_here() + 1
            header_i[8] = op_seq
            header_i[9] = self._digest(header_i, header_f, a)
            if self._m_ops is not None:
                self._m_ops.labels(_OP_NAMES.get(op, "unknown")).inc()
            drop = False
            delay_s = 0.0
            a_send = a
            header_send = header_i
            for spec in faults.tick(LINK_FAULT_SITE):
                if spec.kind == "drop":
                    drop = True
                elif spec.kind == "delay":
                    delay_s += spec.delay_s
                elif spec.kind == "corrupt_payload":
                    # After the digest: the delivered bytes no longer
                    # match header[9]. A header-only op corrupts an arg.
                    if a_send is not None:
                        a_send = a_send.copy()
                        a_send.flat[0] = (int(a_send.flat[0]) + 1) % \
                            np.iinfo(np.int32).max
                    else:
                        header_send = header_i.copy()
                        header_send[1] += 1
                elif spec.kind == "follower_vanish" and hasattr(
                    self.transport, "kill"
                ):
                    self.transport.kill(int(spec.node or 0))
            if drop:
                # Never broadcast (the leader still runs the op): the
                # followers see the next op's seq as a gap.
                return
            self._supervised(op, op_seq, (header_send, header_f),
                             send=True, delay_s=delay_s)
            if a is not None:
                self._supervised(op, op_seq, a_send, send=True)

    def recv(self):
        """Followers: block for the next announcement → (ints, floats,
        payload or None). The op sequence and the payload digest are
        checked before the caller can dispatch anything
        (:class:`LinkDesyncError`; a mismatched handshake
        :class:`LinkConfigMismatch`)."""
        out = self._supervised(
            0, self._expect if self._expect is not None else -1,
            (np.zeros(_LINK_HEADER_INTS, np.int32),
             np.zeros(2, np.float32)),
            send=False, watch=False,
        )
        i, f = out
        i = np.asarray(i)
        f = np.asarray(f)
        op, op_seq = int(i[0]), int(i[8])
        if self._expect is not None and op_seq != self._expect:
            self.desync(
                op_seq,
                f"op_seq gap (expected {self._expect}): a broadcast "
                f"was dropped or reordered",
            )
        self._expect = op_seq + 1
        shape = self._op_shape(op, i)
        a = None
        if shape is not None:
            a = np.asarray(self._supervised(
                op, op_seq, np.zeros(shape, np.int32), send=False,
            ))
        if int(i[9]) != self._digest(i, f, a):
            self.desync(op_seq, "payload digest mismatch (corrupted "
                                "or divergent broadcast)")
        if op == _OP_HELLO and self.local_digest is not None and \
                int(i[1]) != int(self.local_digest):
            raise LinkConfigMismatch(
                f"leader config digest {int(i[1])} != this rank's "
                f"{int(self.local_digest)}: topology/transformer/"
                f"chunk/kv settings drifted between ranks"
            )
        if self._m_ops is not None:
            self._m_ops.labels(_OP_NAMES.get(op, "unknown")).inc()
        return i, f, a


class _LinkSnapshot(list):
    """A released slot's block snapshot on the leader, tagged with the id
    the followers key their replayed snapshot under."""

    snap_id = 0


class _LinkedKV:
    """The leader's ``PagedKVManager`` proxy, JAX's: every mutation is
    announced as a page-table delta op, in call (= dispatch) order,
    before the caller goes on; the followers replay it on their own
    manager, whose allocation and eviction are deterministic, so page
    tables, refcounts and radix index stay identical on every rank.
    Reads pass through; no-op calls (an ensure with full coverage, a COW
    with nothing shared) are not announced, as both sides skip them.
    Each announce carries a replay invariant the follower checks (admit's
    reused length, COW's fork count): a divergence is a
    ``link_desync``."""

    def __init__(self, kv, link):
        object.__setattr__(self, "_kv", kv)
        object.__setattr__(self, "_link", link)
        object.__setattr__(self, "_next_snap", 1)

    def __getattr__(self, name):
        return getattr(self._kv, name)

    def admit(self, slot, tokens):
        with self._link.lock:
            out = self._kv.admit(slot, tokens)
            self._link.announce(
                _OP_KV_ADMIT, ints=(slot, len(tokens), out[0]),
                arr_rows=[np.asarray(tokens, np.int32)],
            )
        return out

    def ensure_blocks(self, slot, upto_pos):
        with self._link.lock:
            # PoolExhausted propagates without an announce: the follower's
            # identical manager would raise too.
            fresh = self._kv.ensure_blocks(slot, upto_pos)
            if fresh:
                self._link.announce(
                    _OP_KV_ENSURE, ints=(slot, int(upto_pos))
                )
        return fresh

    def ensure_writable(self, slot, first_block, last_block):
        with self._link.lock:
            src, dst = self._kv.ensure_writable(
                slot, first_block, last_block
            )
            if src:
                self._link.announce(
                    _OP_KV_COW,
                    ints=(slot, first_block, last_block, len(src)),
                )
        return src, dst

    def release(self, slot):
        with self._link.lock:
            snap = _LinkSnapshot(self._kv.release(slot))
            snap.snap_id = self._next_snap
            object.__setattr__(self, "_next_snap", self._next_snap + 1)
            self._link.announce(
                _OP_KV_RELEASE, ints=(slot, snap.snap_id)
            )
        return snap

    def finish_release(self, blocks, tokens):
        with self._link.lock:
            self._kv.finish_release(blocks, tokens)
            self._link.announce(
                _OP_KV_FINISH,
                ints=(getattr(blocks, "snap_id", 0), len(tokens)),
                arr_rows=[np.asarray(tokens, np.int32)],
            )

    def drop(self, blocks):
        sid = getattr(blocks, "snap_id", 0)
        with self._link.lock:
            self._kv.drop(blocks)
            if sid:
                self._link.announce(_OP_KV_DROP, ints=(sid,))

    def reset(self):
        with self._link.lock:
            self._kv.reset()
            self._link.announce(_OP_KV_RESET)


class _LinkedSoloModel:
    """The engine's sampled fall-through under a link: a solo generate is
    announced through the same link (and lock) as the engine's op
    stream, so the followers replay everything in one order."""

    def __init__(self, model, link):
        self.solo = model
        self.link = link
        self.cfg = model.cfg
        self.device = model.device
        # The weights the engine's programs take.
        self.model = model.model

    def generate(self, tokens, max_new_tokens, temperature=0.0, top_k=0,
                 top_p=1.0, seed=0):
        arr = np.asarray(tokens, np.int32)
        if arr.ndim != 2 or arr.shape[0] > MAX_BATCH:
            raise ValueError(
                f"batch must be 2-D with <= {MAX_BATCH} rows, got "
                f"{arr.shape}"
            )
        temperature, top_k, top_p = sanitize_sampler(
            temperature, top_k, top_p, self.cfg.vocab_size
        )
        # The lock spans the announce and the whole solo decode: the
        # engine may not interleave chunks into it (the slow path).
        with self.link.lock:
            self.link.announce(
                _OP_GENERATE,
                ints=(arr.shape[0], arr.shape[1], max_new_tokens, top_k,
                      seed),
                floats=(temperature, top_p),
                arr_rows=list(arr),
            )
            return self.solo.generate(
                tokens, max_new_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, seed=seed,
            )

    def shutdown(self):
        self.link.announce(_OP_SHUTDOWN)


def _follower_kv_reset(engine, snapshots):
    """A follower's half of ``_OP_KV_RESET``: the manager reset, the
    pools and the device token vector zeroed in place (the graphs hold
    their addresses), the replayed snapshots forgotten."""
    engine.kv.reset()
    for pool in engine.cache.values():
        pool.zero_()
    engine.last_dev.zero_()
    snapshots.clear()


def _gather_kv_heads(link, pools, block_ids):
    """A linked world's KV export gather: every rank's heads of blocks
    ``block_ids`` on rank 0, which gets {block id: (K, V)}, host (L,
    Hkv, block_size, hd) tensors of every head in rank order (rank r
    holds heads r·Hkv/tp onwards); None on the other ranks."""
    ids = torch.tensor(block_ids, dtype=torch.long,
                       device=pools["k"].device)
    # (2, L, n, heads held, block_size, hd) on the host.
    local = torch.stack([pools["k"].index_select(1, ids),
                         pools["v"].index_select(1, ids)]).cpu().contiguous()
    parts = link.gather(local.view(torch.uint8).reshape(-1))
    if parts is None:
        return None
    whole = torch.cat([p.view(local.dtype).reshape(local.shape)
                       for p in parts], dim=3)
    return {int(bid): (whole[0, :, i], whole[1, :, i])
            for i, bid in enumerate(block_ids)}


def _follower_install(engine, ints, arr):
    """A follower's half of ``_OP_KV_INSTALL``: ``install_prefix``'s
    manager steps as rank 0 runs them (allocate, adopt into the radix
    index, drop the transfer's refs), then its own heads of the whole
    heads' bytes written into the fresh blocks."""
    n_tokens, n_blocks, words = int(ints[1]), int(ints[2]), int(ints[3])
    tokens = [int(t) for t in arr[0][:n_tokens]]
    kv = engine.kv
    fresh = kv._alloc(n_blocks)
    kv.radix.insert(tokens, fresh, kv.pool)
    kv.drop(fresh)
    if not n_blocks:
        return
    ref = engine.cache["k"]
    first, end = engine._kv_heads_held()
    shape = (2, ref.shape[0], engine.cfg.n_kv_heads) + tuple(ref.shape[3:])
    slabs = [torch.frombuffer(bytearray(arr[1 + i][:words].tobytes()),
                              dtype=torch.uint8).view(ref.dtype)
             .reshape(shape)[:, :, first:end] for i in range(n_blocks)]
    k = torch.stack([s[0] for s in slabs], dim=1)
    v = torch.stack([s[1] for s in slabs], dim=1)
    engine._write_blocks(engine.cache,
                         torch.tensor(list(fresh), dtype=torch.long), k, v)


def _follower_sync(tensor):
    """Wait for a replayed dispatch's result (a follower keeps pace with
    the leader one op at a time)."""
    if tensor is not None:
        tensor.cpu()


def engine_follower_loop(engine, link, warm=None):
    """Ranks other than 0: replay rank 0's engine-op broadcasts until the
    shutdown op, JAX's. The follower never schedules: it runs exactly the
    calls announced, on its own shards and caches, so every collective
    lines up; a paged follower also replays the page-table delta ops on
    its own manager (deterministic, so its tables, pool and radix index
    stay identical and the paged dispatches replay the same programs).
    ``warm()``, when given, runs once, right after the first handshake:
    the leader runs the same warm plan right after sending it
    (``--warmup=all``: every rank runs the same grid in the same order,
    before any announced op), so the warm pass's collectives line up too.

    A device failure on the follower is logged and the stream goes on
    (its values diverge until the rows retire; the leader's own failures
    arrive as announced resets). A link failure (sequence gap, digest
    mismatch, KV replay divergence, config mismatch) raises before the
    divergent op is dispatched. Returns 0 on shutdown."""
    link.prefill_chunk = engine.prefill_chunk
    link.max_slots = engine.max_slots
    link.local_digest = engine_link_digest(engine)
    model = engine.model.model
    to_dev = engine._to_device
    # snap_id -> this rank's replayed block snapshot.
    snapshots = {}
    with torch.inference_mode():
        while True:
            ints, floats, arr = link.recv()
            op = int(ints[0])
            if op == _OP_SHUTDOWN:
                log.info("engine follower: shutdown broadcast received")
                return 0
            if op == _OP_HELLO:
                # The digest was checked inside recv().
                if warm is not None:
                    warm()
                    warm = None
                continue
            try:
                if op == _OP_PREFILL:
                    plen, slot = int(ints[2]), int(ints[3])
                    _follower_sync(engine._prefill(
                        model, engine.cache, to_dev(arr), plen, slot))
                elif op == _OP_PREFILL_SEG:
                    slot, off, last_idx, window, want = (
                        int(ints[1]), int(ints[2]), int(ints[3]),
                        int(ints[4]), bool(int(ints[5])),
                    )
                    _follower_sync(engine._prefill_seg(
                        model, engine.cache, to_dev(arr), off, slot,
                        last_idx, window=window, want_logits=want))
                elif op == _OP_CHUNK:
                    steps, window, mask = (int(ints[1]), int(ints[2]),
                                           bool(int(ints[3])))
                    _follower_sync(engine._chunk(
                        arr[0].copy(), arr[1].copy(), arr[2].astype(bool),
                        steps=steps, window=window, mask_writes=mask))
                elif op == _OP_RESET:
                    for buf in engine.cache.values():
                        buf.zero_()
                elif op == _OP_GENERATE:
                    # Followers' engines wrap the raw model: the solo
                    # decode replays directly.
                    engine.model.generate(
                        arr.tolist(), int(ints[3]),
                        temperature=float(floats[0]), top_k=int(ints[4]),
                        top_p=float(floats[1]), seed=int(ints[5]),
                    )
                elif op == _OP_KV_ADMIT:
                    slot, n, claim = (int(ints[1]), int(ints[2]),
                                      int(ints[3]))
                    reused, _, _ = engine.kv.admit(
                        slot, [int(t) for t in arr[0][:n]]
                    )
                    if reused != claim:
                        link.desync(
                            int(ints[8]),
                            f"kv admit replay diverged: reused {reused} "
                            f"!= leader's {claim} (radix state drift)",
                        )
                elif op == _OP_KV_ENSURE:
                    engine.kv.ensure_blocks(int(ints[1]), int(ints[2]))
                elif op == _OP_KV_COW:
                    src, dst = engine.kv.ensure_writable(
                        int(ints[1]), int(ints[2]), int(ints[3])
                    )
                    if len(src) != int(ints[4]):
                        link.desync(
                            int(ints[8]),
                            f"kv COW replay diverged: {len(src)} forks "
                            f"!= leader's {int(ints[4])}",
                        )
                    if src:
                        engine._copy_blocks(engine.cache, to_dev(src),
                                            to_dev(dst))
                elif op == _OP_KV_RELEASE:
                    snapshots[int(ints[2])] = engine.kv.release(
                        int(ints[1])
                    )
                elif op == _OP_KV_FINISH:
                    n = int(ints[2])
                    engine.kv.finish_release(
                        snapshots.pop(int(ints[1]), []),
                        [int(t) for t in arr[0][:n]],
                    )
                elif op == _OP_KV_DROP:
                    engine.kv.drop(snapshots.pop(int(ints[1]), []))
                elif op == _OP_KV_RESET:
                    _follower_kv_reset(engine, snapshots)
                elif op == _OP_PAGED_PREFILL:
                    slot, off, C, last_idx, window, want = (
                        int(ints[1]), int(ints[2]), int(ints[3]),
                        int(ints[4]), int(ints[5]), bool(int(ints[6])),
                    )
                    seg_ids = engine.kv.segment_ids(slot, off, C)
                    _follower_sync(engine._paged_prefill(
                        model, engine.cache, to_dev(arr), off,
                        to_dev(seg_ids), to_dev(engine.kv.tables[slot]),
                        last_idx, engine.last_dev, slot, window=window,
                        want_logits=want))
                elif op == _OP_PAGED_CHUNK:
                    steps, window = int(ints[1]), int(ints[2])
                    _follower_sync(engine._paged_chunk(
                        engine.kv.tables, arr[0].copy(),
                        arr[1].astype(bool), steps=steps, window=window))
                elif op == _OP_PAGED_VERIFY:
                    B, W, window, T = (int(ints[1]), int(ints[2]),
                                       int(ints[3]), int(ints[4]))
                    a = arr.astype(np.int64)
                    _follower_sync(engine._paged_verify(
                        a[:B, :W], a[4 * B, :B], a[B:2 * B, :W],
                        a[2 * B:3 * B, :W], a[3 * B:4 * B, :T],
                        window=window))
                elif op == _OP_SPEC_ACCEPT:
                    engine.last_dev[int(ints[1])] = int(ints[2])
                elif op == _OP_KV_EXPORT:
                    n, claim = int(ints[1]), int(ints[2])
                    tokens = [int(t) for t in arr[0][:n]]
                    matched = engine.kv.radix.match(tokens)
                    if len(matched) != claim:
                        link.desync(
                            int(ints[8]),
                            f"kv export replay diverged: matched "
                            f"{len(matched)} blocks != leader's {claim}")
                    if matched:
                        _gather_kv_heads(link, engine.cache, matched)
                    # export_prefix's own lookup on rank 0: the same tick.
                    engine.kv.radix.match(tokens)
                elif op == _OP_KV_INSTALL:
                    _follower_install(engine, ints, arr)
                else:
                    log.error("engine follower: unknown op %d", op)
            except LinkError:
                raise  # never dispatch past a desync
            except Exception:  # noqa: BLE001 - mirror the leader's catch
                log.exception("engine follower op %d failed (mirrors "
                              "leader)", op)


class LockstepModel:
    """``--tp`` without ``--continuous-batching``, JAX's: every rank must
    run the same generate, but only rank 0 takes HTTP traffic. Rank 0
    broadcasts each request (a fixed-shape control and token buffer) over
    the link's gloo ``group`` before running it; the other ranks replay
    it from :func:`follower_loop`."""

    def __init__(self, model, group):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.group = group
        # Broadcast and generate are one atomic step per request, or two
        # handler threads could broadcast in one order and run in the
        # other.
        self._outer = threading.Lock()

    def _broadcast(self, control, fcontrol, buf):
        return _host_broadcast((control, fcontrol, buf), self.group)

    def generate(self, tokens, max_new_tokens, temperature=0.0, top_k=0,
                 top_p=1.0, seed=0):
        arr = np.asarray(tokens, np.int32)
        if arr.ndim != 2 or arr.shape[0] > MAX_BATCH:
            raise ValueError(
                f"batch must be 2-D with <= {MAX_BATCH} rows, got "
                f"{arr.shape}"
            )
        # Snapped before the broadcast, so the f32 sidecar round-trips
        # exactly and every rank runs the same sampler.
        temperature, top_k, top_p = sanitize_sampler(
            temperature, top_k, top_p, self.cfg.vocab_size
        )
        control = np.asarray(
            [arr.shape[0], arr.shape[1], max_new_tokens, top_k, seed],
            np.int32,
        )
        fcontrol = np.asarray([temperature, top_p], np.float32)
        buf = np.zeros((MAX_BATCH, self.cfg.max_seq_len), np.int32)
        buf[: arr.shape[0], : arr.shape[1]] = arr
        with self._outer:
            self._broadcast(control, fcontrol, buf)
            return self.model.generate(
                tokens, max_new_tokens,
                temperature=float(fcontrol[0]), top_k=top_k,
                top_p=float(fcontrol[1]), seed=seed,
            )

    def shutdown(self):
        with self._outer:
            self._broadcast(
                np.asarray([_SHUTDOWN, 0, 0, 0, 0], np.int32),
                np.zeros(2, np.float32),
                np.zeros((MAX_BATCH, self.cfg.max_seq_len), np.int32),
            )


def follower_loop(model, group):
    """Ranks other than 0 under :class:`LockstepModel`: replay rank 0's
    requests until the shutdown broadcast; returns 0."""
    zeros = (
        np.zeros(5, np.int32),
        np.zeros(2, np.float32),
        np.zeros((MAX_BATCH, model.cfg.max_seq_len), np.int32),
    )
    while True:
        control, fcontrol, buf = _host_broadcast(zeros, group)
        b, p, m = int(control[0]), int(control[1]), int(control[2])
        if b == _SHUTDOWN:
            log.info("follower: shutdown broadcast received")
            return 0
        try:
            model.generate(
                np.asarray(buf)[:b, :p].tolist(), m,
                temperature=float(fcontrol[0]), top_k=int(control[3]),
                top_p=float(fcontrol[1]), seed=int(control[4]),
            )
        except Exception:  # noqa: BLE001 - mirror rank 0's handler catch
            log.exception("follower generate failed (mirrors rank 0)")


class ContinuousEngine:
    """Slot-based continuous batching, the port of the JAX
    ``ContinuousEngine``: requests multiplex onto ``max_slots`` slots of
    one KV cache on the device (``self.cache``). ``kv_cache`` picks the
    cache and its host loop, as in JAX.

    ``kv_cache="dense"`` (the default): one dense cache row per slot
    (``transformer.init_kv_cache``, 8.6 GB for 8 slots of Llama-3-8B) and
    the synchronous host loop (``_loop``), one host sync per device call:

      * admission prefills a prompt of at most ``prefill_chunk`` tokens
        in one call at its length bucket (``self._prefill``,
        ``transformer.prefill_into_slot``); a longer one enters the slot
        prefilling and advances one segment of ``prefill_chunk`` tokens a
        loop iteration (``self._prefill_seg``,
        ``transformer.prefill_chunk_into_slot``, the flash kernel at the
        segment's global offset), between decode chunks;
      * decode: every decoding slot advances in one chunk of ``steps``
        greedy steps, ``steps`` the power-of-two floor of min(remaining,
        ``chunk``), so a finishing row retires on time. A chunk is
        ``steps`` replays of the captured decode step of its (window,
        mask_writes) (``self._chunk``, ``self.chunk_graphs``, a
        ``serving_graphs.DenseChunkGraphs``; the same step runs eagerly
        on the CPU), the counterpart of the jitted
        ``transformer.decode_chunk``; writes are masked while a slot is
        mid-prefill.

    ``kv_cache="paged"``: one block pool per layer, page-table rows per
    slot and the asynchronous double-buffered host loop (``_loop_paged``):

      * admission maps the longest cached prefix of the prompt (radix
        index, full blocks, at most len - 1 tokens) into a free slot's
        table; the suffix prefills in segments of at most
        ``prefill_chunk`` tokens (``transformer.paged_prefill_segment``),
        one segment per loop iteration, interleaved with decode chunks;
      * decode chunks as above, each ``steps`` replays of the captured
        step of its window (``self.decode_graphs``, a
        ``serving_graphs.PagedDecodeGraphs`` over the pools and
        ``last_dev``), the counterpart of the jitted
        ``transformer.paged_decode_chunk``;
      * retirement frees the slot at dispatch and, once its tokens have
        landed, caches the written extent in the radix index.

    The paged loop's iteration n dispatches its prefill segments and its
    chunk, then syncs iteration n - 1's results, which the device
    finished before anything of iteration n. Host state (positions,
    remaining, retirement) advances at dispatch; token values land at the
    sync. On CUDA, operands go to the device from pinned memory with
    ``non_blocking=True`` and results come back into pinned tensors
    behind a recorded event, so neither direction waits for the stream to
    drain.

    Speculation (``speculate="ngram"`` or ``"draft"``, paged only, the JAX
    engine's): a speculating row leaves the fused chunk and advances in
    verify rounds (``_spec_tick``): the proposer guesses up to k tokens,
    one batched verify per window group scores every speculating row
    (``self.verify_graphs``, a ``serving_graphs.PagedVerifyGraphs``), and
    the next iteration's sync accepts the longest greedily-matching
    prefix plus the correction token, 1..k+1 tokens a device step, the
    tokens of ``speculate="off"``. ``AdaptiveK`` backs a row off to the
    chunk on poor acceptance.

    The cache, ``last_dev`` and the graphs' static buffers keep their
    addresses for the engine's life (the captured graphs hold them). A
    device call that raises at dispatch is retried up to
    ``step_retries`` times with jittered backoff (the sleep on the loop
    thread, as in JAX), from the state it started from: page allocation
    and copy-on-write run once before the retries, host state advances
    only after a call succeeds, and a decode chunk is not retried once
    one of its steps was launched (each advances the step state in
    place). A call that still raises fails its rows and keeps the cache;
    a device error that surfaces at a sync fails the rows in flight and
    zeroes the cache in place, and is never retried.

    Overload and failure handling, the JAX engine's: ``max_queue``
    bounds the admission queue (0 = unbounded; beyond it ``generate``
    sheds with :class:`QueueFull`), ``deadline_s`` is the default
    per-request admission deadline (0 = none; a row still queued past it
    is shed with :class:`DeadlineExceeded` at admission, never once it
    has decode state), ``tenants`` (a ``fleet.tenants.TenantClasses``)
    makes the queue a stride-scheduled ``TenantQueue`` with per-class
    queue shares and token-rate quotas, and :meth:`drain` migrates
    in-flight rows off their slots to re-prefill their context on fresh
    ones. Control calls (:meth:`run_on_loop`) have a queue of their own,
    outside the bound and the tenant classes.

    Observability, the JAX engine's: every instrument lives on
    ``registry`` (a fresh ``obs.metrics.Registry`` when None) under the
    JAX engine's names, and :meth:`stats` is a view over it. ``events``
    (an ``obs.events.EventStream``) receives ``request_retired``,
    ``request_shed``, ``tenant_shed``, ``step_retry``,
    ``request_migrated`` and ``migration_replayed`` records. ``slo`` (a
    :class:`ServingSLO`) classifies every retired and shed row;
    ``devicetime`` (an ``obs.devicetime.DeviceTimeLedger``) attributes
    each dispatch's host wall, and on the paged loop the deferred sync's
    wait apart, to the rows it served, as JAX does; ``hbm`` (an
    ``obs.hbm.HbmModel``, attached by ``_attach_hbm``) models the card's
    memory. With the tracer on (``obs.trace.configure``) each request
    leaves ``queue``, ``admit``, ``prefill`` (one a segment),
    ``decode``, ``retire`` and ``request`` spans on its own track and
    the loop a ``decode_chunk`` span a chunk. Each of these costs one
    ``is None`` check a hook when off. TTFT and TPOT are observed when
    the first and last tokens land on the host (at the deferred sync on
    a paged engine). Beside the registry the engine keeps the port's
    split of the phase seconds (``t_*_dispatch_s``, ``t_*_wait_s``, and
    ``t_*_device_s`` timed by CUDA events between a chunk's or a
    verify's launch and its sync) and ``ttft_s``, the (prompt length,
    TTFT) of the latest 4096 requests.

    Greedy only: sampled requests go to the wrapped ``Model.generate``.
    """

    # Process-wide engine ordinal: each engine numbers its requests from
    # a block of its own, as in JAX.
    _engine_seq = itertools.count(0)

    def __init__(self, model, max_slots=MAX_BATCH, chunk=32,
                 prefill_chunk=512, start_loop=True, kv_cache="dense",
                 kv_block_size=16, kv_blocks=0, speculate="off",
                 speculate_k=8, spec_proposer=None, max_queue=0,
                 deadline_s=0.0, step_retries=0, retry_backoff_s=0.05,
                 registry=None, events=None, tenants=None, slo=None,
                 devicetime=None, link=None):
        if max_slots < 1 or chunk < 1 or prefill_chunk < 1:
            raise ValueError(
                f"max_slots ({max_slots}), chunk ({chunk}) and "
                f"prefill_chunk ({prefill_chunk}) must be >= 1"
            )
        if kv_cache not in ("dense", "paged"):
            raise ValueError(
                f"kv_cache must be 'dense' or 'paged', got {kv_cache!r}"
            )
        if speculate not in SPECULATE_MODES:
            raise ValueError(
                f"speculate must be 'off', 'ngram' or 'draft', got "
                f"{speculate!r}"
            )
        if speculate != "off" and kv_cache != "paged":
            raise ValueError(
                "speculative decoding requires kv_cache='paged' (the "
                "verify step is a paged program)"
            )
        if speculate != "off" and link is not None and link.spans_hosts:
            # JAX's refusal, where JAX has a link: a world across hosts.
            # On one host rank 0 proposes and announces each verify round
            # (_OP_PAGED_VERIFY, _OP_SPEC_ACCEPT).
            raise ValueError(
                "speculative decoding is single-host; multi-host "
                "engines serve paged WITHOUT --speculate"
            )
        if speculate == "draft" and spec_proposer is None and \
                getattr(model, "model", None) is None:
            raise ValueError(
                "speculate='draft' needs model params to derive a draft "
                "config (a caller without them must inject spec_proposer)"
            )
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        prefill_chunk, chunk = normalize_chunks(
            self.cfg.max_seq_len, prefill_chunk, chunk
        )
        self.max_slots = max_slots
        self.chunk = chunk
        self.prefill_chunk = prefill_chunk
        self.kv_cache = kv_cache
        self.kv = None
        # The lockstep engine link (tensor-parallel serving, one process
        # per GPU): every device call and page-table mutation is announced
        # to the follower ranks before it runs.
        self.link = link
        self.decode_graphs = self.chunk_graphs = None
        if kv_cache == "dense":
            self.cache = tf.init_kv_cache(
                self.cfg, max_slots, self.device,
                getattr(model.model, "kv_heads", None))
            self.chunk_graphs = serving_graphs.DenseChunkGraphs(
                model.model, self.cache, max_slots, self.chunk,
            )
            # The device seams (the calls the JAX package jits).
            self._prefill = tf.prefill_into_slot
            self._prefill_seg = tf.prefill_chunk_into_slot
            self._chunk = self.chunk_graphs
        else:
            self._init_paged(kv_block_size, kv_blocks)
            if link is not None:
                # Manager mutations ride the link as page-table delta ops.
                self.kv = _LinkedKV(self.kv, link)
        self.speculate = speculate
        self.spec_proposer = None
        self.verify_graphs = None
        if speculate != "off":
            self._init_verify(speculate_k)
            if spec_proposer is not None:
                self.spec_proposer = spec_proposer
            elif speculate == "ngram":
                self.spec_proposer = spec_pkg.NgramProposer()
            else:
                self.spec_proposer = spec_pkg.DraftProposer(
                    spec_pkg.draft_config(self.cfg), max_slots,
                    block_size=self.kv.block_size,
                    prefill_chunk=self.prefill_chunk,
                    width=self._spec_width, device=self.device,
                )
        # Host-side slot state (device state is the cache, and on a paged
        # engine last_dev).
        self.positions = np.zeros(max_slots, np.int32)
        self.last_tok = np.zeros(max_slots, np.int32)
        self.occupied = [None] * max_slots  # slot -> in-flight row dict
        self.tenants = tenants
        self._q = (fleet_tenants.TenantQueue(tenants) if tenants is not None
                   else queue.Queue())
        # Admission (the share and watermark checks, then the put) runs
        # under one lock, so concurrent handlers cannot all pass a check
        # before any of them queues: a burst of one class cannot overrun
        # its share and push another class's rows past max_queue.
        self._admit_lock = threading.Lock()
        # run_on_loop's calls: run by the loop before admission, never
        # counted against max_queue or a tenant class.
        self._calls = queue.Queue()
        self.max_queue = max_queue
        self.deadline_s = deadline_s
        self.step_retries = step_retries
        self.retry_backoff_s = retry_backoff_s
        # Private seeded RNG: backoff jitter must not consume the global
        # random stream.
        self._rng = random.Random(0)
        # drain() requests land here from any thread; the loop applies
        # them between iterations (slot state has one writer). The lock
        # also guards a control call's take-up against its withdrawal.
        self._drain_lock = threading.Lock()
        self._drain_requests = []
        # The handoff stream's ``src`` (``--replica-id``).
        self.replica_id = ""
        self._rid = itertools.count(
            1 + 1_000_000 * next(ContinuousEngine._engine_seq))
        self.events = events
        self.slo = slo
        self.devicetime = devicetime
        # Attached after construction by _attach_hbm (the model reads the
        # built engine's pools).
        self.hbm = None
        reg = registry if registry is not None else obs_metrics.Registry()
        self.registry = reg
        # The JAX engine's instruments (engine-loop writer; scrapes read
        # them from other threads). *_seconds_total: host wall around
        # each device call, its sync included (deferred on a paged
        # engine), and idle blocks; occupied_steps: token positions
        # advanced on the device.
        self._m_steps = obs_metrics.Counter(
            "tpu_serving_engine_steps_total",
            "Continuous engine decode-step clock", registry=reg)
        self._m_prefills = obs_metrics.Counter(
            "tpu_serving_engine_prefills_total",
            "Prefill device calls (single-shot or per segment)",
            registry=reg)
        self._m_chunks = obs_metrics.Counter(
            "tpu_serving_engine_chunks_total",
            "Fused decode-chunk device calls", registry=reg)
        self._m_t_prefill = obs_metrics.Counter(
            "tpu_serving_engine_prefill_seconds_total",
            "Wall seconds inside prefill device calls", registry=reg)
        self._m_t_chunk = obs_metrics.Counter(
            "tpu_serving_engine_chunk_seconds_total",
            "Wall seconds inside decode-chunk device calls", registry=reg)
        self._m_t_idle = obs_metrics.Counter(
            "tpu_serving_engine_idle_seconds_total",
            "Wall seconds blocked on an empty queue", registry=reg)
        self._m_occupied_steps = obs_metrics.Counter(
            "tpu_serving_engine_occupied_steps_total",
            "Token-positions advanced on device (steps x occupied rows)",
            registry=reg)
        obs_metrics.Gauge(
            "tpu_serving_engine_occupied_slots",
            "Continuous engine occupied KV slots", registry=reg,
        ).set_function(
            lambda: sum(r is not None for r in self.occupied))
        obs_metrics.Gauge(
            "tpu_serving_engine_queue_depth",
            "Requests waiting for a slot", registry=reg,
        ).set_function(self._q.qsize)
        self._m_batch = obs_metrics.Gauge(
            "tpu_serving_engine_batch_size",
            "Rows advanced by the last fused decode chunk", registry=reg)
        self._m_ttft = obs_metrics.Histogram(
            "tpu_serving_ttft_seconds",
            "Time to first token (enqueue -> prefill's first token)",
            buckets=TTFT_BUCKETS, registry=reg)
        self._m_tpot = obs_metrics.Histogram(
            "tpu_serving_tpot_seconds",
            "Per-output-token decode time (first token -> retire)",
            buckets=TPOT_BUCKETS, registry=reg)
        self._m_queue_wait = obs_metrics.Histogram(
            "tpu_serving_queue_wait_seconds",
            "Enqueue -> slot-admission wait", buckets=QUEUE_WAIT_BUCKETS,
            registry=reg)
        self._m_shed = obs_metrics.Counter(
            "tpu_serving_requests_shed_total",
            "Requests shed instead of served, by reason "
            "(queue_full: bounded admission queue at capacity; "
            "deadline: expired before winning a slot)",
            ["reason"], registry=reg)
        self._m_migrated = obs_metrics.Counter(
            "tpu_serving_requests_migrated_total",
            "In-flight requests drained off their slot and re-prefilled "
            "on a fresh one (chip went Unhealthy mid-serve)",
            registry=reg)
        self._m_retries = obs_metrics.Counter(
            "tpu_serving_step_retries_total",
            "Transient prefill/decode device failures retried with "
            "jittered backoff", registry=reg)
        if tenants is not None:
            self._m_tenant_shed = obs_metrics.Counter(
                "tpu_serving_tenant_shed_total",
                "Requests shed by per-tenant admission policy, by "
                "tenant class and reason (class_share: weighted queue "
                "slice exhausted; quota: token-rate bucket outrun)",
                ["tenant_class", "reason"], registry=reg)
        if self.kv is not None:
            # Paged only, as in JAX.
            self._m_prefix_hit = obs_metrics.Counter(
                "tpu_serving_prefix_cache_hit_tokens_total",
                "Prompt tokens served from the radix prefix cache "
                "(prefill skipped)", registry=reg)
            self._m_prefix_miss = obs_metrics.Counter(
                "tpu_serving_prefix_cache_miss_tokens_total",
                "Prompt tokens that had to prefill (no cached prefix)",
                registry=reg)
            self._m_cow = obs_metrics.Counter(
                "tpu_serving_kv_cow_copies_total",
                "Shared KV blocks forked copy-on-write before a write",
                registry=reg)
            obs_metrics.Gauge(
                "tpu_serving_kv_blocks_free",
                "Unallocated KV blocks in the paged pool",
                registry=reg,
            ).set_function(self.kv.free_blocks)
            obs_metrics.Gauge(
                "tpu_serving_kv_blocks_cached",
                "KV blocks held by the radix prefix index (reusable, "
                "evictable)", registry=reg,
            ).set_function(self.kv.cached_blocks)
            # Prefilled tokens, for reused_prefill_s's per-token cost.
            self._prefill_tokens = 0
        if self.spec_proposer is not None:
            # Speculating only, as in JAX.
            self._m_spec_proposed = obs_metrics.Counter(
                "tpu_serving_spec_proposed_tokens_total",
                "Speculative tokens proposed for verification, by "
                "proposal source", ["source"], registry=reg)
            self._m_spec_accepted = obs_metrics.Counter(
                "tpu_serving_spec_accepted_tokens_total",
                "Extra tokens emitted per verify step beyond the "
                "1-token baseline (each one a sequential device step "
                "saved), by proposal source", ["source"], registry=reg)
            self._m_spec_verifies = obs_metrics.Counter(
                "tpu_serving_spec_verify_steps_total",
                "Speculative verify device dispatches (one BATCH of "
                "scored width-k segments each — every speculating row "
                "of a window group advances per dispatch)",
                registry=reg)
            self._m_t_verify = obs_metrics.Counter(
                "tpu_serving_engine_verify_seconds_total",
                "Wall seconds inside speculative verify device calls",
                registry=reg)
            # The trailing rounds' (proposed, accepted): the loop
            # appends, scrapes read (the lock, as in JAX).
            self._spec_rounds = collections.deque(maxlen=256)
            self._spec_lock = threading.Lock()
            obs_metrics.Gauge(
                "tpu_serving_spec_acceptance_ratio",
                "Accepted/proposed over the trailing verify rounds "
                "(0 until the first round)", registry=reg,
            ).set_function(self._spec_acceptance)
        # The port's split of the phase seconds (engine-loop writer):
        # t_*_dispatch_s, host wall enqueueing the calls; t_*_wait_s, the
        # syncs' waits (deferred on a paged engine); t_*_device_s (CUDA
        # only), the event-timed span of each chunk or verify on the
        # card, read at its sync.
        self.t_prefill_dispatch_s = 0.0
        self.t_prefill_wait_s = 0.0
        self.t_chunk_dispatch_s = 0.0
        self.t_chunk_wait_s = 0.0
        self.t_chunk_device_s = 0.0
        self.t_verify_dispatch_s = 0.0
        self.t_verify_wait_s = 0.0
        self.t_verify_device_s = 0.0
        # Chunks and verifies on a CUDA engine that did not replay their
        # graph (a seam swapped for an eager call): 0 on the path.
        self.eager_chunks_on_cuda = 0
        self.eager_verifies_on_cuda = 0
        # Each retired row's accepted speculative tokens.
        self.retired_spec_accepted = collections.deque(maxlen=4096)
        # (prompt length, seconds from enqueue to the first token landing
        # on the host) per request, the latest 4096.
        self.ttft_s = collections.deque(maxlen=4096)
        self._stop = threading.Event()
        self._thread = None
        # rejoin_link's requests (the loop applies them) and the count
        # applied, which a supervisor polls.
        self._link_rejoins = 0
        self._link_rejoins_done = 0
        if link is not None:
            # The link sizes op payloads from the final (normalized)
            # chunks; then the handshake, which a follower built from
            # other flags fails by name (LinkConfigMismatch).
            link.prefill_chunk = self.prefill_chunk
            link.max_slots = max_slots
            link.hello(engine_link_digest(self))
        if start_loop:
            self._thread = threading.Thread(
                target=self._loop if self.kv is None else self._loop_paged,
                daemon=True,
            )
            self._thread.start()

    def _init_paged(self, kv_block_size, kv_blocks):
        """The paged engine's device state: the block-pool manager, the
        pools, ``last_dev``, the decode graphs and the device seams."""
        self.kv = PagedKVManager(
            self.cfg.max_seq_len, self.max_slots, block_size=kv_block_size,
            num_blocks=kv_blocks,
        )
        self.cache = pa.init_paged_kv_cache(
            self.cfg.n_layers, self.kv.num_blocks,
            getattr(self.model.model, "kv_heads", self.cfg.n_kv_heads),
            self.kv.block_size, self.cfg.head_dim, self.cfg.torch_dtype,
            self.device,
        )
        # Device-resident last tokens: a final prefill segment writes its
        # first token into its slot on the device, and decode chunks read
        # and advance the tensor in place without a host sync.
        self.last_dev = torch.zeros(self.max_slots, dtype=torch.long,
                                    device=self.device)
        self.decode_graphs = serving_graphs.PagedDecodeGraphs(
            self.model.model, self.cache, self.last_dev,
            self.kv.tables.shape, self.chunk, self.kv.block_size,
        )
        # The device seams (the calls the JAX package's fake engine swaps;
        # a speculating engine adds ``_paged_verify``).
        self._paged_prefill = functools.partial(
            tf.paged_prefill_segment, block_size=self.kv.block_size
        )
        self._paged_chunk = self.decode_graphs
        self._copy_blocks = pa.copy_blocks
        # A KV handoff install's device half.
        self._write_blocks = pa.write_blocks
        # Bumped by _reset_paged: sync records dispatched before a pool
        # rebuild must not touch the fresh pool.
        self._kv_epoch = 0
        # Prior-iteration sync records (engine-loop thread only); an
        # attribute so allocation-pressure paths can drain them early
        # (their retire snapshots pin blocks until synced).
        self._pending_syncs = []

    def _init_verify(self, speculate_k):
        """A speculating engine's verify grid and its graphs. A follower
        rank of a linked world calls it alone: it replays rank 0's verify
        rounds and runs no proposer."""
        # k moves on the power-of-two grid (one graph per width).
        self._spec_k_max, self._spec_width = speculate_grid(
            speculate_k, self.cfg.max_seq_len
        )
        # slot -> the row whose proposer state owns it (a deferred
        # retire sync must not release a successor's).
        self._spec_owner = {}
        # Batched verify records dispatched last iteration, synced by
        # the next _spec_tick: one per window group.
        self._spec_pending = []
        self.verify_graphs = serving_graphs.PagedVerifyGraphs(
            self.model.model, self.cache, self._spec_width,
            self.kv.blocks_per_seq, self.kv.block_size,
        )
        self._paged_verify = self.verify_graphs

    def _kv_heads_held(self):
        """(first, end) of the key/value heads this engine's pools hold:
        all of them, but on a rank of a linked world its own run."""
        axes = getattr(self.model.model, "axes", None)
        held = self.cache["k"].shape[2]
        if axes is None:
            return 0, held
        first = axes.tp_index(0) * (self.cfg.n_kv_heads // axes.tp.size)
        return first, first + held

    def _link_lock(self):
        """The announce + dispatch critical section (nothing without a
        link)."""
        import contextlib

        return self.link.lock if self.link else contextlib.nullcontext()

    def rejoin_link(self, reason="follower restart"):
        """Ask the loop to resynchronize a (re)joined follower rank (a
        paged engine under a link), JAX's: at its next iteration the
        leader announces a fresh handshake and a pool reset, so the new
        rank replays from a known-empty state; rows in flight fail (their
        state predates the reset). Without a link, or on a dense engine,
        the request completes at once (``_link_rejoins_done`` advances).
        Thread-safe."""
        del reason
        with self._drain_lock:
            if self.link is None or self.kv is None:
                self._link_rejoins_done += 1
                return
            self._link_rejoins += 1

    def _apply_link_rejoins(self):
        """The loop's half of :meth:`rejoin_link`."""
        if self.link is None or self.kv is None:
            return
        with self._drain_lock:
            n, self._link_rejoins = self._link_rejoins, 0
        if n:
            self.link.hello(engine_link_digest(self))
            self._reset_paged(RuntimeError("link rejoin"))
            with self._drain_lock:
                self._link_rejoins_done += n

    # -- public surface -------------------------------------------------------

    def _shed_tenant(self, exc, tenant_class, rows, trace_id=""):
        """Account one tenant-policy shed (quota / class share): the
        per-class counters and the SLO budget move and a ``tenant_shed``
        event lands on the stream, but no ``request_shed`` record (that
        one reports engine-wide overload only). Called after the
        admission lock is released."""
        self._m_shed.labels(exc.reason).inc(rows)
        self._m_tenant_shed.labels(tenant_class, exc.reason).inc(rows)
        if self.slo is not None:
            for _ in range(rows):
                self.slo.record_shed(exc.reason, tenant_class)
        if self.events is not None:
            self.events.emit(
                "tenant_shed", severity="warning",
                tenant_class=tenant_class, reason=exc.reason, rows=rows,
                trace_id=trace_id,
            )

    def _shed_queue_full(self, rows, tenant_class, queue_depth):
        """Account one ``queue_full`` shed of ``rows`` rows: the shed
        counter, the SLO budget and a ``request_shed`` record. Called
        after the admission lock is released."""
        self._m_shed.labels("queue_full").inc(rows)
        if self.slo is not None:
            for _ in range(rows):
                self.slo.record_shed("queue_full", tenant_class)
        if self.events is not None:
            self.events.emit(
                "request_shed", severity="warning",
                reason="queue_full", rows=rows, queue_depth=queue_depth,
            )

    def _admit_rows(self, tokens, max_new_tokens, deadline_s, tenant,
                    trace_id, trace_sampled):
        """Check and queue a request's rows under the admission lock;
        returns them, or accounts the shed once the lock is released and
        raises it."""
        shed = None
        with self._admit_lock:
            tcls = None
            if self.tenants is not None:
                tcls = self.tenants.resolve(tenant)
                # The class's share of the bounded queue first; the quota
                # last, so only work that passes every other gate consumes
                # bucket tokens.
                if self.max_queue:
                    bound = max(1, int(tcls.queue_share * self.max_queue))
                    depth = self._q.depth(tcls.name)
                    if depth + len(tokens) > bound:
                        shed = (ClassShareExceeded(
                            f"tenant class {tcls.name} queue share full "
                            f"({depth} waiting, share bound {bound}); "
                            f"retry with backoff", tenant=tcls.name,
                        ), None)
            # Exact among admissions (they hold the lock); the loop's
            # own re-queues (a drain's migrations) bypass it.
            if shed is None and self.max_queue and \
                    self._q.qsize() + len(tokens) > self.max_queue:
                depth = self._q.qsize()
                shed = (QueueFull(
                    f"admission queue full ({depth} waiting, bound "
                    f"{self.max_queue}); retry with backoff"
                ), depth)
            if shed is None and tcls is not None and \
                    not self.tenants.try_consume(
                        tcls.name, len(tokens) * int(max_new_tokens)):
                shed = (QuotaExceeded(
                    f"tenant class {tcls.name} outran its token-rate "
                    f"quota; retry with backoff", tenant=tcls.name,
                ), None)
            if shed is None:
                if deadline_s is None:
                    deadline_s = self.deadline_s
                t_enq = obs_trace.now()
                rows = [
                    {
                        "prompt": [int(t) for t in r],
                        "max_new": int(max_new_tokens),
                        "out": None,
                        "finish_step": None,
                        "event": threading.Event(),
                        "err": None,
                        "rid": next(self._rid),
                        "t_enq": t_enq,
                        "deadline": (t_enq + deadline_s) if deadline_s
                        else None,
                        "tenant": tcls.name if tcls is not None else None,
                        "trace_id": trace_id,
                        "trace_sampled": trace_sampled,
                    }
                    for r in tokens
                ]
                for row in rows:
                    self._q.put(row)
                return rows
        exc, queue_depth = shed
        tenant_class = tcls.name if tcls is not None else "default"
        if isinstance(exc, QueueFull):
            self._shed_queue_full(len(tokens), tenant_class, queue_depth)
        else:
            self._shed_tenant(exc, tenant_class, len(tokens),
                              trace_id=trace_id)
        raise exc

    def generate(self, tokens, max_new_tokens, temperature=0.0, top_k=0,
                 top_p=1.0, seed=0, deadline_s=None, tenant=None,
                 traceparent=None):
        """Greedy rows join the engine and block until they retire; a
        sampled request goes to the wrapped model on its own. Returns
        ``[prompt + generated]`` per row.

        Admission, in the JAX engine's order: the tenant class's queue
        share (:class:`ClassShareExceeded`), the ``max_queue`` watermark
        (:class:`QueueFull`), the class's token-rate quota
        (:class:`QuotaExceeded`); each sheds the whole request before
        any row is queued. ``deadline_s`` (else the engine's) sets the
        rows' admission deadline; ``tenant`` names their class;
        ``traceparent`` (W3C) names the trace their spans and events
        carry. The checks and the put hold the admission lock; a shed is
        accounted (counters, SLO, event stream, whose sink may write a
        file) after it is released, so a slow sink never holds up
        another admission."""
        temperature, top_k, top_p = sanitize_sampler(
            temperature, top_k, top_p, self.cfg.vocab_size
        )
        trace_id = ""
        trace_sampled = False
        if traceparent is not None:
            tctx = obs_trace.parse_traceparent(traceparent)
            if tctx is not None:
                trace_id, trace_sampled = tctx[0], tctx[2]
        if temperature != 0.0:
            return self.model.generate(
                tokens, max_new_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, seed=seed,
            )
        if not tokens or any(
            not r or len(r) + int(max_new_tokens) > self.cfg.max_seq_len
            for r in tokens
        ):
            raise ValueError(
                "each row needs 1 <= len(prompt) and len(prompt) + "
                f"max_new_tokens <= {self.cfg.max_seq_len}"
            )
        if self._stop.is_set():
            raise RuntimeError("engine is shut down")
        rows = self._admit_rows(tokens, max_new_tokens, deadline_s, tenant,
                                trace_id, trace_sampled)
        for row in rows:
            row["event"].wait()
        for row in rows:
            if row["err"] is not None:
                raise row["err"]
        return [row["prompt"] + row["out"] for row in rows]

    def stats(self):
        """Engine telemetry under the JAX engine's key set, a view over
        ``registry`` (the numbers ``/metrics`` exposes); a speculating
        engine adds ``spec_proposed``, ``spec_accepted``,
        ``spec_verifies`` and ``spec_acceptance`` (accepted over proposed
        in the trailing 256 rounds), read from the instruments the JAX
        engine keeps only when it speculates."""
        out = {
            "steps_done": int(self._m_steps.value),
            "n_prefills": int(self._m_prefills.value),
            "n_chunks": int(self._m_chunks.value),
            "occupied_slots": sum(r is not None for r in self.occupied),
            "queue_depth": self._q.qsize(),
            "t_prefill_s": self._m_t_prefill.value,
            "t_chunk_s": self._m_t_chunk.value,
            "t_idle_s": self._m_t_idle.value,
            "occupied_steps": int(self._m_occupied_steps.value),
            # Queued rows per tenant class ({} without tenant classes).
            "tenant_queues": (
                self._q.depths() if self.tenants is not None else {}
            ),
        }
        if self.spec_proposer is not None:
            out.update(spec_proposed=int(_total(self._m_spec_proposed)),
                       spec_accepted=int(_total(self._m_spec_accepted)),
                       spec_verifies=int(self._m_spec_verifies.value),
                       spec_acceptance=self._spec_acceptance())
        return out

    def kv_stats(self):
        """The paged cache's snapshot (the manager's ``stats()``); None on
        a dense engine, as in JAX."""
        if self.kv is None:
            return None
        return self.kv.stats()

    def chip_stats(self):
        """The device-time ledger's lifetime totals (seconds by phase and
        tenant class, bubbles); None without ``devicetime``, as in
        JAX."""
        if self.devicetime is None:
            return None
        return self.devicetime.snapshot()

    def graph_stats(self):
        """The decode graphs' counters (a dense engine's chunk graphs, a
        paged one's decode graphs): captures, replays, capture
        seconds, the bytes of their memory pool, and the chunks that ran
        eagerly on CUDA; a speculating engine adds its verify graphs'
        (``verify_graph_*``, ``eager_verifies_on_cuda``) and a draft
        proposer's ingest and propose-chunk graphs' (``draft_graph_*``)."""
        out = self._graph_counts(
            "", [(self.decode_graphs or self.chunk_graphs).graphs])
        out["eager_chunks_on_cuda"] = self.eager_chunks_on_cuda
        if self.verify_graphs is not None:
            out.update(self._graph_counts("verify_",
                                          [self.verify_graphs.graphs]))
            out["eager_verifies_on_cuda"] = self.eager_verifies_on_cuda
        drafter = self.spec_proposer
        if isinstance(drafter, spec_pkg.DraftProposer):
            out.update(self._graph_counts(
                "draft_", [drafter._ingest.graphs, drafter._chunk.graphs]))
        return out

    @staticmethod
    def _graph_counts(prefix, sets):
        return {
            f"{prefix}graph_captures": sum(g.captures for g in sets),
            f"{prefix}graph_replays": sum(g.replays for g in sets),
            f"{prefix}graph_capture_s": sum(g.capture_s for g in sets),
            f"{prefix}graph_pool_bytes": sum(g.pool_bytes() for g in sets),
        }

    def run_on_loop(self, fn, timeout_s=None):
        """Run ``fn()`` on the engine-loop thread between iterations
        (after the pending syncs) and return its result; captures and warm
        tasks go there, never beside the loop's own device calls. Runs it
        here when the engine has no loop thread, or this is it. The call
        waits in a queue of its own, which the loop serves before it
        admits requests (an idle loop wakes for it): it never counts
        against ``max_queue`` or a tenant class. ``timeout_s`` bounds the
        wait for the loop to take the call up: one still queued then is
        withdrawn and :class:`LoopTimeout` raised; one already running
        is waited for to its end."""
        if self._thread is None or self._thread is threading.current_thread():
            return fn()
        if self._stop.is_set():
            raise RuntimeError("engine is shut down")
        call = {"call": fn, "out": None, "err": None,
                "event": threading.Event(), "state": "queued"}
        self._calls.put(call)
        if timeout_s is not None and not call["event"].wait(timeout_s):
            with self._drain_lock:
                withdrawn = call["state"] == "queued"
                if withdrawn:
                    call["state"] = "withdrawn"
            if withdrawn:
                raise LoopTimeout(
                    f"the engine loop did not take the call up within "
                    f"{timeout_s:.3f}s (stalled or not running)"
                )
        call["event"].wait()
        if call["err"] is not None:
            raise call["err"]
        return call["out"]

    def drain(self, slots=None, reason="unhealthy"):
        """Migrate in-flight requests off their slots (every occupied
        slot, or those in ``slots``), the JAX engine's ``drain``: each
        occupant's decode state is abandoned, the row re-enters the
        admission queue, and its prompt + generated tokens re-prefill
        into a fresh slot where decoding continues. Thread-safe: the loop
        applies the drain at its next iteration (``_apply_drains``).
        Returns the occupied slots targeted now (advisory: a row may
        retire before the drain lands)."""
        targeted = sum(
            1 for i, r in enumerate(self.occupied)
            if r is not None and (slots is None or i in slots)
        )
        with self._drain_lock:
            self._drain_requests.append(
                (None if slots is None else set(slots), reason)
            )
        return targeted

    # -- cross-replica KV handoff (kvcache/handoff.py) ------------------------

    def kv_export(self, tokens, timeout_s=2.0, traceparent=None):
        """The longest cached prefix of ``tokens`` as a handoff stream
        (``kvcache/handoff.py``'s frames, each BLOCK carrying its K/V
        bytes), the JAX engine's ``kv_export``. Runs on the engine loop
        after its pending syncs (the radix index and the pools have one
        writer, and the blocks hold their tokens' bytes by then); raises
        ``HandoffTimeout`` when the loop does not take it up within
        ``timeout_s``, ``HandoffUnsupported`` on a dense engine or a
        miss."""
        if self.kv is None:
            raise kv_handoff.HandoffUnsupported(
                "dense engine: no paged KV manager to export from"
            )
        if self.link is not None and self.link.spans_hosts:
            # JAX's refusal across hosts: linked replicas there decline,
            # and the router re-prefills.
            raise kv_handoff.HandoffUnsupported(
                "multi-host paged engine: KV handoff not supported "
                "over the lockstep link"
            )
        tokens = [int(t) for t in tokens]
        return self._kv_handoff_op(
            "export", lambda: self._export_on_loop(tokens, traceparent),
            timeout_s)

    def kv_install(self, frames, timeout_s=2.0):
        """Verify and install a handoff stream (the receiving half, the
        JAX engine's ``kv_install``): the blocks join this engine's pool
        and radix index, so the next admission of the shipped prompt
        reuses them. Every block's bytes are decoded and checked before
        any lands (a bad one raises ``HandoffDesync`` and leaves the
        manager and the pools as they were), then all land in one copy
        per pool, in place. Same loop marshalling and failures as
        :meth:`kv_export`."""
        if self.kv is None:
            raise kv_handoff.HandoffUnsupported(
                "dense engine: no paged KV manager to install into"
            )
        if self.link is not None and self.link.spans_hosts:
            raise kv_handoff.HandoffUnsupported(
                "multi-host paged engine: KV handoff not supported "
                "over the lockstep link"
            )
        return self._kv_handoff_op(
            "install", lambda: self._install_on_loop(frames), timeout_s)

    def _kv_handoff_op(self, op, fn, timeout_s):
        try:
            return self.run_on_loop(fn, timeout_s=timeout_s)
        except LoopTimeout as e:
            raise kv_handoff.HandoffTimeout(
                f"kv {op} not applied within {timeout_s:.3f}s (engine "
                f"loop stalled or not running)"
            ) from e

    def _export_on_loop(self, tokens, traceparent):
        """The loop's half of :meth:`kv_export`. On a rank of a linked
        world the pools hold its own heads only: the export is announced
        (``_OP_KV_EXPORT``, the prompt and the blocks matched), every rank
        looks the prompt up in its own radix index (the same LRU ticks as
        rank 0's) and sends its heads of the matched blocks to rank 0,
        which frames the whole heads. The stream is JAX's, byte for byte."""
        slabs = None
        if self.link is not None:
            with self.link.lock:
                matched = self.kv.radix.match(tokens)
                self.link.announce(
                    _OP_KV_EXPORT, ints=(len(tokens), len(matched)),
                    arr_rows=[np.asarray(tokens, np.int32)])
                if matched:
                    slabs = _gather_kv_heads(self.link, self.cache, matched)
        return kv_handoff.export_prefix(
            self.kv, tokens, src=self.replica_id,
            block_bytes=functools.partial(self._kv_block_bytes, slabs=slabs),
            traceparent=traceparent)

    def _install_on_loop(self, frames):
        """The loop's half of :meth:`kv_install`. ``install_prefix``
        checks every frame, and every block's bytes are decoded, before
        anything lands (a bad one leaves the manager and the pools as they
        were). Under a link the install is then announced with the whole
        heads (``_OP_KV_INSTALL``), and the other ranks replay its manager
        steps and write their own heads. The radix index has adopted the
        blocks when their device copy runs: a failure there resets the
        pools and the index (``_reset_paged``, as a failed sync does) and
        is raised, so no adopted block goes unwritten."""
        staged = []

        def write(bid, kv):
            staged.append((bid, self._decode_kv_block(kv)))

        with self._link_lock():
            result = kv_handoff.install_prefix(self.kv, frames,
                                               write_block=write)
            if self.link is not None:
                tokens = [int(t) for f in frames
                          if f["op"] == kv_handoff.OP_BLOCK
                          for t in f["payload"]["tokens"]]
                # Each block's K then V bytes, as the op's int32 words.
                words = [np.concatenate([
                    t.contiguous().view(torch.uint8).numpy().reshape(-1)
                    for t in kv]).view(np.int32) for _, kv in staged]
                self.link.announce(
                    _OP_KV_INSTALL,
                    ints=(len(tokens), len(words),
                          len(words[0]) if words else 0),
                    arr_rows=[np.asarray(tokens, np.int32), *words])
        if staged:
            first, end = self._kv_heads_held()
            ids = torch.tensor([bid for bid, _ in staged], dtype=torch.long)
            k = torch.stack([kv[0][:, first:end] for _, kv in staged], dim=1)
            v = torch.stack([kv[1][:, first:end] for _, kv in staged], dim=1)
            try:
                self._write_blocks(self.cache, ids, k, v)
                event = self._timing_event()
                if event is not None:
                    event.synchronize()
            except Exception as e:  # noqa: BLE001 - reset, then raised
                log.exception("kv install: the device copy failed")
                self._reset_paged(e, phase="kv install")
                raise
        return result

    def _kv_block_bytes(self, bid, slabs=None):
        """One block's device bytes as a wire payload, the JAX engine's:
        the C-order (L, Hkv, block_size, hd) slabs of K and V of every
        head, little-endian, base64, and the dtype's numpy name. A bf16
        slab goes through its bytes (numpy has no bf16), never through
        f32. ``slabs`` (block id -> (K, V)) are a linked world's gathered
        heads; without them the pools hold every head."""
        def b64(slab):
            slab = slab.cpu().contiguous()
            return base64.b64encode(
                slab.view(torch.uint8).numpy().tobytes()).decode("ascii")

        bid = int(bid)
        k, v = slabs[bid] if slabs is not None else (
            self.cache["k"][:, bid], self.cache["v"][:, bid])
        return {"k": b64(k), "v": b64(v),
                "dtype": _wire_dtype(self.cache["k"].dtype)}

    def _decode_kv_block(self, kv):
        """Inverse of :meth:`_kv_block_bytes` against this engine's cache
        geometry: host (L, Hkv, block_size, hd) tensors of K and V, every
        head. A missing payload, another dtype or another byte size is a
        desync, never a reinterpretation (JAX installs a byte-less block
        unwritten; here its pages would decode garbage)."""
        ref = self.cache["k"]
        shape = (ref.shape[0], self.cfg.n_kv_heads) + tuple(ref.shape[3:])
        want = math.prod(shape) * ref.element_size()
        if not isinstance(kv, dict):
            raise kv_handoff.HandoffDesync(
                "BLOCK frame carries no KV bytes"
            )
        if kv.get("dtype") != _wire_dtype(ref.dtype):
            raise kv_handoff.HandoffDesync(
                f"KV dtype mismatch: stream {kv.get('dtype')}, "
                f"receiver {_wire_dtype(ref.dtype)}"
            )
        out = []
        for key in ("k", "v"):
            try:
                buf = base64.b64decode(kv.get(key) or "")
            except (TypeError, ValueError) as e:
                raise kv_handoff.HandoffDesync(
                    f"KV block {key!r} is not base64: {e}") from e
            if len(buf) != want:
                raise kv_handoff.HandoffDesync(
                    f"KV block byte-size mismatch on {key!r}: stream "
                    f"{len(buf)}, receiver wants {want} (model config "
                    f"drift between replicas)"
                )
            out.append(torch.frombuffer(bytearray(buf), dtype=torch.uint8)
                       .view(ref.dtype).reshape(shape))
        return out[0], out[1]

    def shutdown(self):
        """Stop the engine loop and fail whatever is still queued or in
        flight, so a caller can drop the engine and free its pools. With
        an event stream, the ledger's and the HBM model's lifetime
        records (``chip_accounting``, ``hbm_snapshot``) land on it
        first, as in JAX."""
        if self.events is not None:
            if self.devicetime is not None:
                self.devicetime.emit_snapshot(self.events)
            if self.hbm is not None:
                self.hbm.emit_snapshot(self.events)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(60.0)
            if self._thread.is_alive():
                raise RuntimeError("engine loop did not stop")
        cause = RuntimeError("engine shut down")
        fail_row = self._fail_row if self.kv is None else \
            self._fail_paged_row
        for i, row in enumerate(self.occupied):
            if row is not None:
                fail_row(row, i, cause, "serving")
        for q in (self._calls, self._q):
            while True:
                try:
                    row = q.get_nowait()
                except queue.Empty:
                    break
                row["err"] = cause
                row["event"].set()
        if self.link is not None:
            # The followers' replay loops end at the shutdown op.
            try:
                self.link.announce(_OP_SHUTDOWN)
            except LinkError:
                log.exception("shutdown broadcast failed")

    def fail_in_flight(self, cause):
        """Fail every row in flight or queued with ``cause``, from any
        thread, touching no device or manager state: the terminal path of
        a link wedge (the loop may be blocked inside the wedged
        collective, and the process exits next). The waiters' handlers
        answer with the error. A paged engine's rows whose last tokens
        wait on a deferred sync are failed too (their slots were freed at
        dispatch)."""
        rows = [row for row in list(self.occupied) if row is not None]
        for rec in list(getattr(self, "_pending_syncs", ())):
            rows.extend(rec["rows"].values() if "rows" in rec
                        else [rec["row"]])
        for row in rows:
            row["err"] = cause
            row["event"].set()
        while True:
            try:
                row = self._q.get_nowait()
            except queue.Empty:
                break
            row["err"] = cause
            row["event"].set()

    # -- host <-> device ------------------------------------------------------

    def _to_device(self, array):
        """A host array on the engine's device (int32 tables and positions
        as int64, the index dtype). On CUDA it is staged in pinned memory
        and copied with ``non_blocking=True``: a pageable copy would wait
        for the stream to drain. PyTorch's caching host allocator keeps
        the pinned block until its copy has run."""
        host = torch.from_numpy(np.asarray(array))
        if host.dtype == torch.int32:
            host = host.long()
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, tensor):
        """(host tensor, event): ``tensor`` copied into pinned memory
        behind the work queued so far, and a (timing) event recorded after
        the copy; the sync waits on that event alone. On the CPU the work
        has already run: a copy (the decode graphs' output buffer is
        rewritten by the next chunk before this one syncs), no event."""
        if self.device.type != "cuda":
            return tensor.clone(), None
        host = torch.empty(tensor.shape, dtype=tensor.dtype,
                           pin_memory=True)
        host.copy_(tensor, non_blocking=True)
        return host, self._timing_event()

    def _timing_event(self):
        """A recorded timing event on CUDA (the syncs wait on it, and a
        chunk's device span is read between two), else None."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    # -- engine internals -----------------------------------------------------

    def _free_slots(self):
        return [i for i, r in enumerate(self.occupied) if r is None]

    def _shed(self, row, exc):
        """Reject ``row`` with a typed shed (admission-time policy)."""
        self._m_shed.labels(exc.reason).inc()
        if self.slo is not None:
            self.slo.record_shed(exc.reason, row.get("tenant") or "default")
        if self.events is not None:
            self.events.emit(
                "request_shed", severity="warning", reason=exc.reason,
                rid=row["rid"],
            )
        if obs_trace.enabled():
            obs_trace.event("shed", obs_trace.now(), 0.0,
                            track=f"req-{row['rid']}", reason=exc.reason,
                            trace_id=row.get("trace_id", ""))
        row["err"] = exc
        row["event"].set()

    def _admission_open(self, row):
        """Admission's common head (the JAX ``_admit``'s): shed a row
        that waited out its deadline in the queue, unless it has decode
        state already (a migrated row: its work is paid for), observe a
        first admission's queue wait and, tracing, close the ``queue``
        span. Returns the admission's start (tracer time), or None when
        shed."""
        now = obs_trace.now()
        if row.get("deadline") is not None and "generated" not in row \
                and now > row["deadline"]:
            self._shed(row, DeadlineExceeded(
                f"deadline expired after {now - row['t_enq']:.3f}s in "
                f"queue"
            ))
            return None
        if "t_admit" not in row:
            self._m_queue_wait.observe(now - row["t_enq"])
            row["t_admit"] = now
        if obs_trace.enabled():
            obs_trace.event("queue", row["t_enq"], now - row["t_enq"],
                            track=f"req-{row['rid']}",
                            trace_id=row.get("trace_id", ""))
        return now

    def _backoff_delay(self, attempt):
        """Jittered exponential backoff between step retries (full
        jitter), the JAX engine's; returned so the ``step_retry`` event
        can carry it."""
        delay = self.retry_backoff_s * (2 ** attempt)
        return delay * (0.5 + self._rng.random() / 2)

    def _retrying(self, phase, call, launched=None, **attrs):
        """``call()`` with up to ``step_retries`` retries: each failed
        attempt bumps ``tpu_serving_step_retries_total``, emits
        ``step_retry`` (``phase``, ``attempt``, ``backoff_s`` and
        ``attrs``) and sleeps the backoff on the loop thread, as in JAX.
        ``launched()`` (optional) counts the call's launches: an attempt
        that raised after it moved left state advanced in place and is
        not retried (the port's pools are never donated: this is its form
        of JAX's guard against retrying once the donated cache is gone).
        Under a link, every fault site fires before the dispatch's
        announce (the announce moved after the fault point, rather than a
        retry op that recommits the followers): an attempt that raised
        before announcing left every rank as it was and is retried; one
        that announced committed the followers to its dispatch and is
        not. Across hosts nothing is retried, as in JAX. Returns (the
        result, the host time the successful attempt started: the
        dispatch envelope opens there, as in JAX); raises the last
        attempt's error."""
        link = self.link
        attempt = 0
        while True:
            mark = launched() if launched is not None else None
            sent = link.announced_here() if link is not None else 0
            t0 = time.perf_counter()
            try:
                return call(), t0
            except Exception as e:  # noqa: BLE001 - retried or re-raised
                if attempt >= self.step_retries \
                        or (launched is not None and launched() != mark) \
                        or (link is not None and (
                            link.spans_hosts
                            or link.announced_here() != sent)):
                    raise
                self._m_retries.inc()
                delay = self._backoff_delay(attempt)
                if self.events is not None:
                    self.events.emit(
                        "step_retry", severity="warning", phase=phase,
                        attempt=attempt + 1, error=str(e),
                        backoff_s=round(delay, 6), **attrs,
                    )
                time.sleep(delay)
                attempt += 1

    def _run_calls(self):
        """Run every queued ``run_on_loop`` call (loop thread)."""
        while True:
            try:
                call = self._calls.get_nowait()
            except queue.Empty:
                return
            self._run_call(call)

    def _apply_drains(self):
        """The loop's half of :meth:`drain`: free the targeted slots and
        re-queue their occupants for re-prefill of prompt + generated. A
        paged slot's blocks go back to the pool (no radix insert) and the
        row's bumped sync generation voids its records still in flight
        (a verify's, a retire marker's); its speculation state goes with
        the slot."""
        with self._drain_lock:
            requests, self._drain_requests = self._drain_requests, []
        for slots, reason in requests:
            for i, row in enumerate(self.occupied):
                if row is None or (slots is not None and i not in slots):
                    continue
                self.occupied[i] = None
                self.positions[i] = 0
                self.last_tok[i] = 0
                # A mid-flight chunked prefill restarts from offset 0 on
                # the new slot.
                row.pop("pending", None)
                row.pop("prefill_offset", None)
                row.pop("remaining", None)
                if self.kv is not None:
                    self.kv.drop(self.kv.release(i))
                    row["_sync_gen"] = row.get("_sync_gen", 0) + 1
                    row.pop("ctx", None)
                    row.pop("n_generated", None)
                    self._drop_spec(i, row)
                row["migrated_at"] = obs_trace.now()
                self._m_migrated.inc()
                if self.events is not None:
                    self.events.emit(
                        "request_migrated", severity="warning",
                        rid=row["rid"], slot=i, reason=reason,
                        generated=len(row.get("generated", [])),
                        trace_id=row.get("trace_id", ""),
                    )
                if obs_trace.enabled():
                    obs_trace.event(
                        "migrate", obs_trace.now(), 0.0,
                        track=f"req-{row['rid']}", slot=i, reason=reason,
                        trace_id=row.get("trace_id", ""))
                self._q.put(row)

    def _note_migration_replayed(self, row, slot):
        """A migrated row's re-prefill landed its first token: emit
        ``migration_replayed`` with the seconds since the drain
        (``lost_s``)."""
        if "migrated_at" not in row:
            return
        lost = obs_trace.now() - row.pop("migrated_at")
        if self.events is not None:
            self.events.emit("migration_replayed", rid=row["rid"],
                             slot=slot, lost_s=round(lost, 6))

    # -- dense engine: the synchronous host loop ------------------------------
    #
    # The JAX dense loop: every device call is followed by its host sync
    # before the next is scheduled (the paged loop's double buffering is a
    # paged-engine feature). Host state (positions, last tokens) advances
    # from what each sync reads back.

    def _dense_call(self, targets, phase, dispatch, step, chunk=False,
                    launched=None, devt=None, **attrs):
        """One device call of the dense loop and its sync. ``dispatch()``
        enqueues the call and returns the device tensor to read back, or
        None; ``chunk`` charges its time to the chunk timers, else to the
        prefill ones. The dispatch and its read-back are retried as
        ``step`` (``_retrying``, with ``launched`` and ``attrs``).
        ``devt`` ((ledger phase, [(row, weight), ...])) is what the
        device-time ledger books the envelope to: the successful
        attempt's dispatch and its sync, as in JAX. Returns (ok, the
        tensor's host values as a numpy array, or None, the envelope's
        seconds). A call that still raises at dispatch fails ``targets``
        ((slot, row) pairs) and keeps the cache: the rows' own cache
        entries are all it may have written. An error that surfaces at
        the sync resets the engine (``_reset_dense``), which fails them:
        the device may have written anything."""

        def call():
            out = dispatch()
            if out is None:
                return None, self._timing_event()
            return self._to_host(out)

        try:
            start = self._timing_event() if chunk else None
            (host, event), t0 = self._retrying(step, call, launched, **attrs)
        except Exception as e:  # noqa: BLE001 - fail the rows, keep serving
            log.exception("%s failed", phase)
            for slot, row in targets:
                self._fail_row(row, slot, e, phase)
            return False, None, 0.0
        t1 = time.perf_counter()
        try:
            if event is not None:
                event.synchronize()
            value = None if host is None else host.numpy()
        except Exception as e:  # noqa: BLE001 - an async device error
            log.exception("%s sync failed", phase)
            self._reset_dense(e, targets, f"{phase} sync")
            return False, None, 0.0
        t2 = time.perf_counter()
        if chunk:
            self.t_chunk_dispatch_s += t1 - t0
            self.t_chunk_wait_s += t2 - t1
            self._m_t_chunk.inc(t2 - t0)
            if start is not None:
                self.t_chunk_device_s += start.elapsed_time(event) / 1e3
        else:
            self.t_prefill_dispatch_s += t1 - t0
            self.t_prefill_wait_s += t2 - t1
            self._m_t_prefill.inc(t2 - t0)
        if self.devicetime is not None:
            self.devicetime.note_dispatch(t0)
            self.devicetime.attribute(devt[0], t2 - t0, devt[1])
            self.devicetime.note_dispatch_end(t2)
        return True, value, t2 - t0

    def _fail_row(self, row, slot, cause, phase):
        """Fail one in-flight dense row and free its slot."""
        row["err"] = RuntimeError(f"{phase} failed: {cause}")
        row["err"].__cause__ = cause
        if self.occupied[slot] is row:
            self._free_slot(slot)
        row["event"].set()

    def _free_slot(self, slot):
        # A free slot sits at position 0, so it cannot widen the attended
        # window of later chunks, and unmasked writes land where the next
        # occupant's prefill writes first.
        self.occupied[slot] = None
        self.positions[slot] = 0
        self.last_tok[slot] = 0

    def _reset_dense(self, cause, failed=(), phase=None):
        """The cache is in an unknown state after a device fault: zero it
        in place (the chunk graphs hold its address and stay valid), then
        fail ``failed`` ((slot, row) pairs, with ``phase``'s error) and
        every other occupant. The zeroing comes first: a failed row's
        waiter wakes to a cache the loop no longer writes."""
        for buf in self.cache.values():
            buf.zero_()
        if self.link:
            # The followers' caches went down with the same call (the op
            # stream is the same): they zero theirs in lockstep.
            self.link.announce(_OP_RESET)
        for slot, row in failed:
            self._fail_row(row, slot, cause, phase)
        for i, row in enumerate(self.occupied):
            if row is None:
                continue
            row["err"] = RuntimeError(
                f"engine cache lost to a failed device call: {cause}"
            )
            row["err"].__cause__ = cause
            self._free_slot(i)
            row["event"].set()

    def _admit(self, slot, row):
        """Dense admission: a context of at most ``prefill_chunk`` tokens
        prefills now, in one call at its length bucket; a longer one
        enters the slot prefilling (``remaining`` None), and the loop
        advances it one segment an iteration (``_advance_prefill``). The
        context is prompt + generated: a migrated row's re-prefill."""
        t_admit = self._admission_open(row)
        if t_admit is None:
            return
        tracing = obs_trace.enabled()
        track = f"req-{row['rid']}" if tracing else None
        tid = row.get("trace_id", "") if tracing else ""
        ctx = row["prompt"] + row.get("generated", [])
        if len(ctx) > self.prefill_chunk:
            row["pending"] = np.asarray(ctx, np.int64)
            row["prefill_offset"] = 0
            row["remaining"] = None
            self.positions[slot] = 0
            self.occupied[slot] = row
            if tracing:
                obs_trace.event("admit", t_admit, obs_trace.now() - t_admit,
                                track=track, slot=slot,
                                chunked=True,
                                trace_id=tid)
            return
        bucket = tf._length_bucket(len(ctx), self.cfg.max_seq_len)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(ctx)] = ctx
        self.occupied[slot] = row

        def dispatch():
            # The armed plan's fault fires before the dispatch, so it is
            # always retriable (a free None check when disarmed).
            faults.fire("serving.prefill", slot=slot)
            # The link lock spans the announce and the dispatch: the
            # followers dispatch in broadcast order.
            with self._link_lock():
                if self.link:
                    self.link.announce(
                        _OP_PREFILL, ints=(bucket, len(ctx), slot),
                        arr_rows=[padded[0]])
                return self._prefill(self.model.model, self.cache,
                                     self._to_device(padded), len(ctx),
                                     slot)

        t0_trace = obs_trace.now()
        if tracing:
            obs_trace.event("admit", t_admit, t0_trace - t_admit,
                            track=track, slot=slot,
                            trace_id=tid)
        ok, first, wall = self._dense_call(
            [(slot, row)], "prefill", dispatch, "prefill",
            devt=None if self.devicetime is None
            else ("prefill", [(row, len(ctx))]), rid=row["rid"])
        if not ok:
            return
        self._m_prefills.inc()
        t_first = obs_trace.now()
        if tracing:
            obs_trace.event("prefill", t0_trace, t_first - t0_trace,
                            track=track, slot=slot,
                            tokens=len(ctx),
                            trace_id=tid,
                            device_s=round(wall, 6))
        self._first_token(slot, row, len(ctx), int(first), t_first)

    def _advance_prefill(self, slot):
        """Dispatch and sync ONE segment of a chunked prefill: the
        ``prefill_chunk`` tokens from the row's offset, the last one
        right-padded, attending the slot's cache [0, window)."""
        row = self.occupied[slot]
        ctx = row["pending"]
        total = int(ctx.shape[0])
        off = row["prefill_offset"]
        C = self.prefill_chunk
        S = self.cfg.max_seq_len
        seg = np.zeros((1, C), np.int64)
        real = min(C, total - off)
        seg[0, :real] = ctx[off:off + real]
        last = off + C >= total
        window = tf._window_for(min(off + C, S), S)

        def dispatch():
            with self._link_lock():
                if self.link:
                    self.link.announce(
                        _OP_PREFILL_SEG,
                        ints=(slot, off, total - 1, window, int(last)),
                        arr_rows=[seg[0]])
                return self._prefill_seg(
                    self.model.model, self.cache, self._to_device(seg),
                    off, slot, total - 1, window=window, want_logits=last,
                )

        t0_trace = obs_trace.now()
        ok, tok, wall = self._dense_call(
            [(slot, row)], "chunked prefill", dispatch, "prefill",
            rid=row["rid"],
            devt=None if self.devicetime is None
            else ("chunk", [(row, real)]),
        )
        if not ok:
            return
        self._m_prefills.inc()
        t_seg_end = obs_trace.now()
        if obs_trace.enabled():
            obs_trace.event("prefill", t0_trace, t_seg_end - t0_trace,
                            track=f"req-{row['rid']}", slot=slot,
                            chunk=off // C, offset=off, tokens=C,
                            trace_id=row.get("trace_id", ""),
                            device_s=round(wall, 6))
        row["prefill_offset"] = off + C
        if last:
            del row["pending"]
            self._first_token(slot, row, total, int(tok), t_seg_end)

    def _first_token(self, slot, row, ctx_len, tok, t_first):
        """A prefill's first token has landed (at ``t_first``, tracer
        time): the slot decodes from ``ctx_len``, or retires when that
        token was the budget."""
        self.positions[slot] = ctx_len
        self.last_tok[slot] = tok
        self._note_migration_replayed(row, slot)
        row.setdefault("generated", []).append(tok)
        row["remaining"] = row["max_new"] - len(row["generated"])
        self._note_first_token(row, t_first)
        if row["remaining"] <= 0:
            self._retire(slot)

    def _note_first_token(self, row, t_first):
        """The row's first token EVER landed on the host at ``t_first``
        (a migrated row keeps its first TTFT): observe it."""
        if "t_first" in row:
            return
        row["t_first"] = t_first
        ttft = t_first - row["t_enq"]
        self._observe_ttft(row, ttft)
        self.ttft_s.append((len(row["prompt"]), ttft))

    def _observe_ttft(self, row, ttft):
        """The TTFT observation, the JAX engine's: it carries the row's
        trace id as an exemplar when the trace is sampled, or when the
        TTFT breaks the SLO (which marks the trace sampled)."""
        tid = row.get("trace_id")
        if tid and (row.get("trace_sampled")
                    or (self.slo is not None and self.slo.ttft_s
                        and ttft > self.slo.ttft_s)):
            row["trace_sampled"] = True
            self._m_ttft.observe(ttft, exemplar=tid)
        else:
            self._m_ttft.observe(ttft)

    def _observe_tpot(self, row, tpot):
        """The TPOT twin of :meth:`_observe_ttft`."""
        tid = row.get("trace_id")
        if tid and (row.get("trace_sampled")
                    or (self.slo is not None and self.slo.tpot_s
                        and tpot > self.slo.tpot_s)):
            row["trace_sampled"] = True
            self._m_tpot.observe(tpot, exemplar=tid)
        else:
            self._m_tpot.observe(tpot)

    def _run_chunk(self):
        """One decode chunk over the decoding slots, and its sync. Writes
        are masked while any slot is mid-prefill."""
        occupied = [
            i for i, r in enumerate(self.occupied)
            if r is not None and r.get("remaining") is not None
        ]
        if not occupied:
            return
        S = self.cfg.max_seq_len
        steps = min(min(self.occupied[i]["remaining"] for i in occupied),
                    self.chunk)
        steps = 1 << (steps.bit_length() - 1)
        active = np.zeros(self.max_slots, bool)
        active[occupied] = True
        max_pos = int(self.positions[occupied].max())
        window = tf._window_for(min(max_pos + steps + 1, S), S)
        prefilling = any(r is not None and r.get("remaining") is None
                         for r in self.occupied)
        graphs = self.chunk_graphs.graphs

        def dispatch():
            faults.fire("serving.chunk", rows=len(occupied))
            replays = graphs.replays
            with self._link_lock():
                if self.link:
                    self.link.announce(
                        _OP_CHUNK, ints=(steps, window, int(prefilling)),
                        arr_rows=[self.last_tok, self.positions,
                                  active.astype(np.int32)])
                toks = self._chunk(self.last_tok, self.positions, active,
                                   steps=steps, window=window,
                                   mask_writes=prefilling)
            if self.device.type == "cuda" and \
                    graphs.replays - replays != steps:
                self.eager_chunks_on_cuda += 1
            return toks

        self._m_batch.set(len(occupied))
        with obs_trace.span("decode_chunk", steps=steps, rows=len(occupied),
                            window=window):
            ok, toks, _ = self._dense_call(
                [(i, self.occupied[i]) for i in occupied], "decode chunk",
                dispatch, "decode_chunk", chunk=True,
                launched=lambda: self.chunk_graphs.launched,
                devt=None if self.devicetime is None
                else ("decode", [(self.occupied[i], steps)
                                 for i in occupied]),
                rows=len(occupied),
            )
        if not ok:
            return
        self._m_steps.inc(steps)
        self._m_chunks.inc()
        self._m_occupied_steps.inc(steps * len(occupied))
        for i in occupied:
            row = self.occupied[i]
            row["generated"].extend(int(t) for t in toks[:, i])
            self.last_tok[i] = toks[-1, i]
            self.positions[i] += steps
            row["remaining"] -= steps
            if row["remaining"] <= 0:
                self._retire(i)

    def _retire(self, slot):
        row = self.occupied[slot]
        self._free_slot(slot)
        self._retire_row(row, slot)

    def _loop(self):
        """The dense host loop: run the queued control calls and apply
        the drains, admit into free slots (blocking only when the engine
        is idle), advance every prefilling slot by one segment, then run
        one decode chunk."""
        with torch.inference_mode():
            while not self._stop.is_set():
                self._run_calls()
                # Drains first: the freed slots admit below, so a
                # migrated row re-prefills in the same iteration.
                self._apply_drains()
                free = self._free_slots()
                while free:
                    row = self._next_row(
                        block=len(self._free_slots()) == self.max_slots)
                    if row is None:
                        break
                    self._admit(free.pop(0), row)
                for i, r in enumerate(self.occupied):
                    if r is not None and r.get("remaining") is None:
                        self._advance_prefill(i)
                self._run_chunk()

    def _admit_paged(self, slot, row):
        """Paged admission: radix prefix match + page-table mapping. The
        matched full blocks skip prefill; the suffix prefills in segments
        from the reused offset (_advance_prefill_paged). The context is
        prompt + generated: a migrated row's re-prefill."""
        t_admit = self._admission_open(row)
        if t_admit is None:
            return
        ctx = row["prompt"] + row.get("generated", [])
        reused, hit, miss = self.kv.admit(slot, ctx)
        self._m_prefix_hit.inc(hit)
        self._m_prefix_miss.inc(miss)
        row["prefix_hit_tokens"] = row.get("prefix_hit_tokens", 0) + hit
        # Remembered so a pool-pressure back-out can un-count this
        # admission's reuse (the re-admission counts what it reuses).
        row["_admit_hit"] = hit
        row["ctx"] = np.asarray(ctx, np.int64)
        row["prefill_offset"] = reused
        row["n_generated"] = len(row.get("generated", []))
        row["remaining"] = None  # prefilling
        self.positions[slot] = 0
        self.occupied[slot] = row
        if obs_trace.enabled():
            obs_trace.event("admit", t_admit, obs_trace.now() - t_admit,
                            track=f"req-{row['rid']}", slot=slot,
                            reused_tokens=reused,
                            trace_id=row.get("trace_id", ""))

    def _fail_paged_row(self, row, slot, cause, phase):
        """Fail one in-flight paged row and free its slot and blocks."""
        row["err"] = RuntimeError(f"{phase} failed: {cause}")
        row["err"].__cause__ = cause
        if self.occupied[slot] is row:
            self.occupied[slot] = None
            self.positions[slot] = 0
            self.kv.drop(self.kv.release(slot))
        self._drop_spec(slot, row)
        row["event"].set()

    def _reset_paged(self, cause, failed=(), phase=None):
        """The pools are in an unknown state after a device fault: zero
        the pools and ``last_dev`` in place (the decode graphs hold their
        addresses and stay valid), fail ``failed`` ((slot, row) pairs,
        with ``phase``'s error) and every other occupant, reset page
        tables and radix index, and bump the KV epoch so stale sync
        records leave the fresh pool alone. The zeroing comes first: a
        failed row's waiter wakes to pools the loop no longer writes."""
        for pool in self.cache.values():
            pool.zero_()
        self.last_dev.zero_()
        for slot, row in failed:
            if self.occupied[slot] is row:
                self._fail_paged_row(row, slot, cause, phase)
            else:
                row["err"] = RuntimeError(f"{phase} failed: {cause}")
                row["err"].__cause__ = cause
                row["event"].set()
        for i, row in enumerate(self.occupied):
            if row is None:
                continue
            row["err"] = RuntimeError(
                f"engine cache lost to a failed device call: {cause}"
            )
            row["err"].__cause__ = cause
            self.occupied[i] = None
            self._drop_spec(i, row)
            row["event"].set()
        self.kv.reset()
        self.positions[:] = 0
        self.last_tok[:] = 0
        self._kv_epoch += 1

    def _drain_pending_syncs(self):
        """Sync (and clear) every prior-iteration record now: at the loop
        boundary, and early under allocation pressure (the records'
        retire snapshots hold block refs until synced)."""
        recs, self._pending_syncs = self._pending_syncs, []
        for rec in recs:
            self._sync_record(rec)

    def _ensure_blocks_or_drain(self, slot, upto_pos):
        """kv.ensure_blocks; on exhaustion drain the pending syncs (their
        retire snapshots then insert into the radix index and become
        evictable) and retry once. Re-raises PoolExhausted only when the
        pool is genuinely over-committed."""
        try:
            return self.kv.ensure_blocks(slot, upto_pos)
        except PoolExhausted:
            self._drain_pending_syncs()
            return self.kv.ensure_blocks(slot, upto_pos)

    def _cow_fork(self, slot, first_block, last_block):
        """ensure_writable + the device copy of every forked block.
        Returns the number of forked blocks (0 in the steady state:
        reused blocks precede every write offset)."""
        # Under a link the COW announce and the copy's dispatch are one
        # step (the followers dispatch their copy at the announce).
        with self._link_lock():
            src, dst = self.kv.ensure_writable(slot, first_block,
                                               last_block)
            if src:
                self._m_cow.inc(len(src))
                self._copy_blocks(self.cache, self._to_device(src),
                                  self._to_device(dst))
        return len(src)

    def _back_out(self, slot, row):
        """Pool pressure: un-admit a prefilling row and re-queue it; it
        restarts from its reuse offset on a later iteration, when retires
        have freed blocks. The bumped _sync_gen voids its in-flight
        records."""
        self.kv.drop(self.kv.release(slot))
        self.occupied[slot] = None
        self.positions[slot] = 0
        row["remaining"] = None
        row.pop("ctx", None)
        row.pop("n_generated", None)
        row["prefix_hit_tokens"] = (
            row.get("prefix_hit_tokens", 0) - row.pop("_admit_hit", 0)
        )
        row["_sync_gen"] = row.get("_sync_gen", 0) + 1
        self._q.put(row)

    def _advance_prefill_paged(self, slot):
        """Dispatch ONE suffix-prefill segment for ``slot`` (async: its
        result syncs one loop iteration later). Returns the sync record,
        or None when the dispatch failed or the admission was backed out
        under pool pressure."""
        row = self.occupied[slot]
        ctx = row["ctx"]
        total = int(ctx.shape[0])
        off = row["prefill_offset"]
        S = self.cfg.max_seq_len
        rem = total - off
        cap = min(self.prefill_chunk, S)
        last = rem <= cap
        seg_len = tf._length_bucket(rem, cap) if last else cap
        end = min(off + seg_len, S)
        window = tf._window_for(end, S)
        try:
            self._ensure_blocks_or_drain(slot, end)
        except PoolExhausted:
            self._back_out(slot, row)
            return None
        bs = self.kv.block_size
        self._cow_fork(slot, off // bs, (end - 1) // bs)
        seg = np.zeros((1, seg_len), np.int64)
        real = min(seg_len, rem)
        seg[0, :real] = ctx[off:off + real]
        seg_ids = self.kv.segment_ids(slot, off, seg_len)

        def call():
            # The segment rewrites its own blocks (and, the last one,
            # its slot of last_dev): a retry starts from the same state.
            faults.fire("serving.prefill", slot=slot)
            with self._link_lock():
                if self.link:
                    self.link.announce(
                        _OP_PAGED_PREFILL,
                        ints=(slot, off, seg_len, total - 1, window,
                              int(last)),
                        arr_rows=[seg[0]])
                tok = self._paged_prefill(
                    self.model.model, self.cache, self._to_device(seg), off,
                    self._to_device(seg_ids),
                    self._to_device(self.kv.tables[slot]),
                    total - 1, self.last_dev, slot, window=window,
                    want_logits=last,
                )
            if last:
                return self._to_host(tok)
            return None, self._timing_event()

        t0_trace = obs_trace.now()
        try:
            (tok_h, event), t0 = self._retrying("prefill", call,
                                                rid=row["rid"])
        except Exception as e:  # noqa: BLE001 - fail the row, keep serving
            log.exception("paged prefill failed")
            self._fail_paged_row(row, slot, e, "paged prefill")
            return None
        wall = time.perf_counter() - t0
        self._m_prefills.inc()
        self._m_t_prefill.inc(wall)
        self.t_prefill_dispatch_s += wall
        self._prefill_tokens += real
        if self.devicetime is not None:
            # One segment, one row; its deferred sync's wait goes to the
            # same row (the record's _devt).
            self.devicetime.note_dispatch(t0)
            self.devicetime.attribute("chunk", wall, [(row, real)])
            self.devicetime.note_dispatch_end(t0 + wall)
        if obs_trace.enabled():
            obs_trace.event("prefill", t0_trace, obs_trace.now() - t0_trace,
                            track=f"req-{row['rid']}", slot=slot,
                            offset=off, tokens=real,
                            trace_id=row.get("trace_id", ""),
                            device_s=round(wall, 6))
        row["prefill_offset"] = off + seg_len
        rec = {"kind": "seg", "row": row, "slot": slot, "tok": tok_h,
               "event": event, "epoch": self._kv_epoch,
               "gen": row.get("_sync_gen", 0)}
        if self.devicetime is not None:
            rec["_devt"] = ("chunk", [(row, real)])
        if last:
            self.positions[slot] = total
            row["n_generated"] += 1
            row["remaining"] = row["max_new"] - row["n_generated"]
            rec["kind"] = "first"
            if row["remaining"] <= 0:
                # Finished at prefill: free the slot now (stream order
                # protects the blocks: a new occupant's writes queue
                # behind this dispatch), retire at the sync.
                rec["blocks"] = self.kv.release(slot)
                self.occupied[slot] = None
                self.positions[slot] = 0
        return rec

    def _dispatch_chunk_paged(self):
        """Dispatch one fused paged decode chunk over the decoding slots
        (async). Host state (positions, remaining, retirement) advances
        at dispatch, fully determined by ``steps``; token values land at
        the next iteration's sync."""
        # Speculating rows advance in verify rounds instead (_spec_tick
        # stamps "hold" on rows with a verify in flight or a chunk
        # pipeline to drain); everyone else shares the fused chunk.
        occupied = [
            i for i, r in enumerate(self.occupied)
            if r is not None and r.get("remaining") is not None
            and not (r.get("_spec") or {}).get("hold")
        ]
        if not occupied:
            return None
        for i in occupied:
            st = self.occupied[i].get("_spec")
            if st is not None:
                st["inflight"] += 1
        S = self.cfg.max_seq_len
        bs = self.kv.block_size
        steps = min(min(self.occupied[i]["remaining"] for i in occupied),
                    self.chunk)
        steps = 1 << (steps.bit_length() - 1)
        active = np.zeros(self.max_slots, bool)
        active[occupied] = True
        max_pos = int(self.positions[occupied].max())
        window = tf._window_for(min(max_pos + steps + 1, S), S)
        try:
            for i in occupied:
                pos = int(self.positions[i])
                self._ensure_blocks_or_drain(i, min(pos + steps, S))
                self._cow_fork(i, pos // bs, (min(pos + steps, S) - 1) // bs)
        except Exception as e:  # noqa: BLE001 - never kill the loop
            # The capacity floor covers occupied slots once the pending
            # snapshots drain; reaching here is genuine over-commit.
            for i in occupied:
                if self.occupied[i] is not None:
                    self._fail_paged_row(self.occupied[i], i, e,
                                         "page allocation")
            return None
        def call():
            faults.fire("serving.chunk", rows=len(occupied))
            replays = self.decode_graphs.graphs.replays
            # Advances last_dev in place; toks is the graphs' output buffer.
            with self._link_lock():
                if self.link:
                    self.link.announce(
                        _OP_PAGED_CHUNK, ints=(steps, window),
                        arr_rows=[self.positions, active.astype(np.int32)])
                toks = self._paged_chunk(self.kv.tables, self.positions,
                                         active, steps=steps, window=window)
            if self.device.type == "cuda" and \
                    self.decode_graphs.graphs.replays - replays != steps:
                self.eager_chunks_on_cuda += 1
            return self._to_host(toks)

        self._m_batch.set(len(occupied))
        try:
            start = self._timing_event()
            # Allocation and copy-on-write above ran once; a retry holds
            # the same blocks. Once a step has advanced last_dev in place
            # the chunk is not retried.
            with obs_trace.span("decode_chunk", steps=steps,
                                rows=len(occupied), window=window):
                (toks_h, event), t0 = self._retrying(
                    "decode_chunk", call,
                    lambda: self.decode_graphs.launched, rows=len(occupied))
        except Exception as e:  # noqa: BLE001 - fail the rows, keep serving
            log.exception("paged decode chunk failed")
            for i in occupied:
                if self.occupied[i] is not None:
                    self._fail_paged_row(self.occupied[i], i, e,
                                         "decode chunk")
            return None
        wall = time.perf_counter() - t0
        self.t_chunk_dispatch_s += wall
        self._m_t_chunk.inc(wall)
        self._m_occupied_steps.inc(steps * len(occupied))
        if self.devicetime is not None:
            # The fused chunk advances every row by the same steps.
            self.devicetime.note_dispatch(t0)
            self.devicetime.attribute(
                "decode", wall, [(self.occupied[i], steps) for i in occupied])
            self.devicetime.note_dispatch_end(t0 + wall)
        self._m_steps.inc(steps)
        self._m_chunks.inc()
        rows, gens = {}, {}
        for i in occupied:
            row = self.occupied[i]
            rows[i] = row
            gens[i] = row.get("_sync_gen", 0)
            self.positions[i] += steps
            row["n_generated"] += steps
            row["remaining"] -= steps
            if row["remaining"] <= 0:
                row["_blocks"] = self.kv.release(i)
                # Generation-stamped: a voided stale record of this row
                # must not pop a marker its re-admitted incarnation
                # stamped.
                row["_blocks_gen"] = row.get("_sync_gen", 0)
                self.occupied[i] = None
                self.positions[i] = 0
        rec = {"kind": "chunk", "toks": toks_h, "event": event,
               "start": start, "rows": rows, "gens": gens,
               "steps": steps, "epoch": self._kv_epoch}
        if self.devicetime is not None:
            rec["_devt"] = ("decode", [(r, steps) for r in rows.values()])
        return rec

    def _sync_record(self, rec):
        """Sync one prior-iteration dispatch: wait for its event, append
        its tokens to the owning rows, stamp TTFT, and retire rows whose
        budget the dispatch exhausted. The device finished this work
        before anything dispatched in the current iteration, so the wait
        is (nearly) free: the point of the deferred sync."""
        t0 = time.perf_counter()
        try:
            if rec["event"] is not None:
                rec["event"].synchronize()
            if rec["kind"] == "chunk":
                toks = rec["toks"].numpy()
            elif rec["kind"] == "first":
                tok = int(rec["tok"])
        except Exception as e:  # noqa: BLE001 - an async device error
            log.exception("paged sync failed")
            self._fail_sync(rec, e)
            return
        wait = time.perf_counter() - t0
        fresh = rec["epoch"] == self._kv_epoch
        if rec["kind"] != "chunk":
            self.t_prefill_wait_s += wait
            self._m_t_prefill.inc(wait)
        else:
            self.t_chunk_wait_s += wait
            self._m_t_chunk.inc(wait)
            if rec["start"] is not None:
                self.t_chunk_device_s += \
                    rec["start"].elapsed_time(rec["event"]) / 1e3
        if self.devicetime is not None:
            # Device wall of the rows captured at dispatch, booked even
            # when the record is void below: the card did the work.
            devt = rec.get("_devt")
            if devt is not None:
                self.devicetime.attribute(devt[0], wait, devt[1])
            self.devicetime.note_dispatch_end(time.perf_counter())
        if rec["kind"] == "seg":
            return
        now = obs_trace.now()
        if rec["kind"] == "first":
            row, slot = rec["row"], rec["slot"]
            if rec["gen"] != row.get("_sync_gen", 0) or \
                    row["err"] is not None:
                if fresh and "blocks" in rec:
                    self.kv.drop(rec["blocks"])
                return
            self._note_migration_replayed(row, slot)
            row.setdefault("generated", []).append(tok)
            self._note_first_token(row, now)
            if "blocks" in rec:
                self._finish_retire_paged(row, slot, rec["blocks"], fresh)
            return
        for slot, row in rec["rows"].items():
            st = row.get("_spec")
            if st is not None and st["inflight"] > 0:
                st["inflight"] -= 1
            if rec["gens"][slot] != row.get("_sync_gen", 0) or \
                    row["err"] is not None:
                # A void record may only drop a retire marker its own
                # generation stamped.
                if fresh and "_blocks" in row and \
                        row.get("_blocks_gen") == rec["gens"][slot]:
                    self.kv.drop(row.pop("_blocks"))
                continue
            chunk_toks = [int(t) for t in toks[:rec["steps"], slot]]
            row["generated"].extend(chunk_toks)
            if st is not None and self._spec_owner.get(slot) is row:
                # Chunk output is confirmed context the proposer must
                # see, and each chunk round ticks a backed-off row's
                # cooldown toward its k=1 re-probe. Ownership-guarded: a
                # retire-at-dispatch row's deferred sync must not feed a
                # successor's proposer state.
                self.spec_proposer.observe(slot, chunk_toks)
                st["ak"].tick()
            # Retire only once every dispatched token has landed: an
            # earlier chunk's record of the same row may sync first.
            if "_blocks" in row and len(row["generated"]) >= row["max_new"]:
                row.pop("_blocks_gen", None)
                self._finish_retire_paged(row, slot, row.pop("_blocks"),
                                          fresh)

    def _finish_retire_paged(self, row, slot, blocks, fresh):
        """Retirement's sync half: cache the request's prefix in the radix
        index (unless the pool was rebuilt since dispatch), then the
        shared retire tail. Only the WRITTEN extent is cached: the last
        generated token was emitted but never fed back, so its K/V slot
        holds garbage; tokens[:-1] is exactly what prefill and decode
        wrote."""
        self._drop_spec(slot, row)
        if fresh:
            self.kv.finish_release(
                blocks, (row["prompt"] + row["generated"])[:-1]
            )
        self._retire_row(row, slot)

    def _reused_prefill_s(self, row):
        """The prefill seconds the radix reuse saved this row: its hit
        tokens times the engine's measured prefill seconds per prefilled
        token (0.0 on a dense engine), as in JAX."""
        hit = row.get("prefix_hit_tokens", 0)
        if not hit or self.kv is None or not self._prefill_tokens:
            return 0.0
        return hit * self._m_t_prefill.value / self._prefill_tokens

    def _retire_row(self, row, slot):
        """The retire tail (its slot is already free), the JAX engine's:
        publish the output, observe TPOT, close the request's spans,
        classify it against the SLO, emit ``request_retired`` and wake
        the handler thread."""
        row["out"] = row["generated"]
        row["finish_step"] = int(self._m_steps.value)
        t_ret = obs_trace.now()
        n_out = len(row["generated"])
        t_first = row.get("t_first")
        tpot = None
        if t_first is not None and n_out > 1:
            tpot = (t_ret - t_first) / (n_out - 1)
            self._observe_tpot(row, tpot)
        if obs_trace.enabled():
            track = f"req-{row['rid']}"
            tid = row.get("trace_id", "")
            if tpot is not None:
                dbp = row.get("device_by_phase") or {}
                obs_trace.event("decode", t_first, t_ret - t_first,
                                track=track, tokens=n_out - 1,
                                trace_id=tid,
                                device_s=round(dbp.get("decode", 0.0)
                                               + dbp.get("verify", 0.0), 6))
            obs_trace.event("retire", t_ret, 0.0, track=track, slot=slot,
                            trace_id=tid)
            obs_trace.event("request", row["t_enq"], t_ret - row["t_enq"],
                            track=track, rid=row["rid"], tokens=n_out,
                            prompt_len=len(row["prompt"]), trace_id=tid)
        slo_outcome = None
        if self.slo is not None:
            ttft = (t_first if t_first is not None else t_ret) - row["t_enq"]
            slo_outcome = self.slo.classify_retired(
                ttft, tpot, row.get("tenant") or "default")
        if self.events is not None:
            attrs = {} if slo_outcome is None else {"slo": slo_outcome}
            self.events.emit(
                "request_retired", rid=row["rid"], slot=slot,
                tokens=n_out, prompt_len=len(row["prompt"]),
                latency_s=round(t_ret - row["t_enq"], 6),
                prefix_hit_tokens=row.get("prefix_hit_tokens", 0),
                reused_prefill_s=round(self._reused_prefill_s(row), 6),
                spec_accepted_tokens=row.get("spec_accepted", 0),
                device_s=round(row.get("device_s", 0.0), 6),
                tenant_class=row.get("tenant") or "default",
                trace_id=row.get("trace_id", ""),
                **attrs,
            )
        if self.spec_proposer is not None:
            self.retired_spec_accepted.append(row.get("spec_accepted", 0))
        row["event"].set()

    def _fail_sync(self, rec, cause):
        """A device error surfaced at the deferred sync: drop the
        record's blocks, then reset, which fails its rows, since the
        pools may hold anything."""
        rows = (
            list(rec["rows"].items()) if rec["kind"] == "chunk"
            else [(rec["slot"], rec["row"])]
        )
        fresh = rec["epoch"] == self._kv_epoch
        failed = []
        for slot, row in rows:
            if row["err"] is not None or row["event"].is_set():
                continue
            gen = rec["gens"][slot] if rec["kind"] == "chunk" else rec["gen"]
            blocks = None
            if row.get("_blocks_gen") == gen:
                row.pop("_blocks_gen", None)
                blocks = row.pop("_blocks", None)
            blocks = blocks or rec.get("blocks")
            if fresh and blocks:
                self.kv.drop(blocks)
            failed.append((slot, row))
        self._reset_paged(cause, failed, "paged sync")

    # -- speculative decoding: the per-row (propose, verify) machine ---------
    #
    # A speculating row leaves the fused decode chunk and advances in
    # verify rounds: the proposer guesses up to k tokens, one batched
    # verify scores every speculating row of a window group (a width-W
    # segment per row through the same layers at the rows' own global
    # positions), and the next iteration's sync accepts the longest
    # greedily-matching prefix plus the correction token from the same
    # logits: 1..k+1 tokens a device step, the tokens of the plain decode.
    # AdaptiveK backs a row off to the chunk (k = 0) on poor acceptance,
    # so adversarial traffic pays at most the probing rounds, each of
    # which still emits one token.

    def _spec_acceptance(self):
        with self._spec_lock:
            rounds = list(self._spec_rounds)
        proposed = sum(p for p, _ in rounds)
        return sum(a for _, a in rounds) / proposed if proposed else 0.0

    def _drop_spec(self, slot, row):
        """Release a row's speculation state (retire, failure, reset): the
        proposer's slot structures go, and an in-flight verify record of
        the row is voided by its popped state (its tokens are never read).
        The proposer's slot is released only while ``row`` still owns it:
        a retire-at-dispatch row's deferred sync can land after a new
        occupant took the slot."""
        if self.spec_proposer is None:
            return
        if row.pop("_spec", None) is not None and \
                self._spec_owner.get(slot) is row:
            self.spec_proposer.release(slot)
            del self._spec_owner[slot]

    def _spec_tick(self):
        """One speculation round: sync last iteration's batched verifies,
        then collect every eligible row's proposal into per-window
        groups and dispatch one ``paged_verify_batch`` per group. Stamps
        ``st["hold"]``: holding rows stay out of this iteration's fused
        chunk (a verify in flight, or a chunk or first-token result still
        to land, so the host's tokens catch up with the device before the
        first verify)."""
        if self.spec_proposer is None:
            return
        pending, self._spec_pending = self._spec_pending, []
        for rec in pending:
            self._sync_verify_batch(rec)
        groups = {}
        for slot, row in enumerate(self.occupied):
            if row is None or row.get("remaining") is None:
                continue
            st = row.get("_spec")
            if st is None:
                st = row["_spec"] = {
                    "ak": spec_pkg.AdaptiveK(self._spec_k_max),
                    "inflight": 0, "hold": False,
                }
            st["hold"] = False
            pos = int(self.positions[slot])
            if st["ak"].k == 0 or \
                    pos + self._spec_width > self.cfg.max_seq_len:
                # Backed off (its cooldown ticks at chunk syncs) or too
                # close to the context end for a verify window: the row
                # rides the fused chunk.
                continue
            if st["inflight"] or len(row["prompt"]) + \
                    len(row.get("generated", ())) - 1 != pos:
                # Chunk results or the first token still in flight.
                st["hold"] = True
                continue
            if self._spec_owner.get(slot) is not row:
                # First tick with the whole context on the host: hand the
                # proposer all of it.
                self._spec_owner[slot] = row
                self.spec_proposer.admit(
                    slot, row["prompt"] + row["generated"]
                )
            entry = self._prepare_verify(slot, row, st)
            if entry is not None:
                st["hold"] = True
                groups.setdefault(entry["window"], []).append(entry)
        for window in sorted(groups):
            rec = self._dispatch_verify_batch(groups[window], window)
            if rec is not None:
                self._spec_pending.append(rec)

    def _prepare_verify(self, slot, row, st):
        """The host half of one row's verify round: propose, allocate
        blocks, copy-on-write fork shared pages, and build the row's
        segment and per-position write targets. Returns the batch entry,
        or None when the row rides the fused chunk this round."""
        S = self.cfg.max_seq_len
        pos = int(self.positions[slot])
        W = self._spec_width
        k_eff = min(st["ak"].k, W - 1, row["remaining"], S - pos - 1)
        if k_eff < 1:
            return None
        props = self.spec_proposer.propose(slot, k_eff)[:k_eff]
        if not props:
            # Nothing to offer: a failed round, so the controller backs
            # the row off to the chunk instead of stalling it here.
            st["ak"].update(0, 0)
            return None
        try:
            self._ensure_blocks_or_drain(slot, min(pos + W, S))
        except PoolExhausted as e:
            self._fail_paged_row(row, slot, e, "verify allocation")
            return None
        bs = self.kv.block_size
        self._cow_fork(slot, pos // bs, (min(pos + W, S) - 1) // bs)
        bids, offs = self.kv.position_targets(slot, pos, W)
        seg = np.zeros(W, np.int64)
        seg[0] = row["generated"][-1]
        seg[1:1 + len(props)] = props
        return {
            "row": row, "slot": slot, "props": props, "pos0": pos,
            "seg": seg, "bids": bids, "offs": offs,
            "window": tf._window_for(min(pos + W, S), S),
            "gen": row.get("_sync_gen", 0),
        }

    def _dispatch_verify_batch(self, entries, window):
        """Assemble and dispatch one batched verify for a window group
        (async; synced by the next _spec_tick). Rows pack into the
        smallest power-of-two batch bucket that holds the group, padding
        rows write only the null block. On CUDA the call is the replay of
        the (bucket, window) graph. The verify rewrites only its rows'
        positions, so a retry starts from the same state; a verify that
        still raises fails its rows and keeps the pools (only those rows'
        blocks were written). Returns the sync record, or None."""
        W = self._spec_width
        B = min(1 << (len(entries) - 1).bit_length(), self.max_slots)
        T = self.kv.blocks_per_seq
        segs = np.zeros((B, W), np.int64)
        poss = np.zeros(B, np.int64)
        bids = np.full((B, W), pa.NULL_BLOCK, np.int64)
        offs = np.zeros((B, W), np.int64)
        tables = np.full((B, T), pa.NULL_BLOCK, np.int64)
        for idx, e in enumerate(entries):
            segs[idx] = e["seg"]
            poss[idx] = e["pos0"]
            bids[idx] = e["bids"]
            offs[idx] = e["offs"]
            tables[idx] = self.kv.tables[e["slot"]]
        def call():
            faults.fire("serving.verify", rows=len(entries))
            replays = self.verify_graphs.graphs.replays
            with self._link_lock():
                if self.link:
                    self.link.announce(
                        _OP_PAGED_VERIFY, ints=(B, W, window, T),
                        arr_rows=[*segs, *bids, *offs, *tables, poss])
                greedy = self._paged_verify(segs, poss, bids, offs, tables,
                                            window=window)
            if self.device.type == "cuda" and \
                    self.verify_graphs.graphs.replays - replays != 1:
                self.eager_verifies_on_cuda += 1
            return self._to_host(greedy)

        try:
            start = self._timing_event()
            (greedy_h, event), t0 = self._retrying("verify", call,
                                                   rows=len(entries))
        except Exception as e:  # noqa: BLE001 - fail the rows, keep serving
            log.exception("speculative verify failed")
            for entry in entries:
                if self.occupied[entry["slot"]] is entry["row"]:
                    self._fail_paged_row(entry["row"], entry["slot"], e,
                                         "speculative verify")
            return None
        wall = time.perf_counter() - t0
        self.t_verify_dispatch_s += wall
        self._m_t_verify.inc(wall)
        self._m_spec_verifies.inc()
        self._m_spec_proposed.labels(self.speculate).inc(
            sum(len(e["props"]) for e in entries))
        rec = {"greedy": greedy_h, "event": event, "start": start,
               "entries": entries, "epoch": self._kv_epoch}
        if self.devicetime is not None:
            # Each row weighs the tokens the verify scored for it: its
            # proposals and the correction.
            parts = [(e["row"], len(e["props"]) + 1) for e in entries]
            self.devicetime.note_dispatch(t0)
            self.devicetime.attribute("verify", wall, parts)
            self.devicetime.note_dispatch_end(t0 + wall)
            rec["_devt"] = ("verify", parts)
        return rec

    def _sync_verify_batch(self, rec):
        """Sync one batched verify round: wait for its event, read the
        (B, W) greedy tokens once, then apply every row's accept/correct
        step. A device error here resets the pools, as a failed chunk
        sync does."""
        t0 = time.perf_counter()
        try:
            if rec["event"] is not None:
                rec["event"].synchronize()
            g = rec["greedy"].numpy()
        except Exception as e:  # noqa: BLE001 - an async device error
            log.exception("verify sync failed")
            self._reset_paged(
                e, [(entry["slot"], entry["row"]) for entry in rec["entries"]
                    if self.occupied[entry["slot"]] is entry["row"]],
                "verify sync")
            return
        wait = time.perf_counter() - t0
        self.t_verify_wait_s += wait
        self._m_t_verify.inc(wait)
        if rec["start"] is not None:
            self.t_verify_device_s += \
                rec["start"].elapsed_time(rec["event"]) / 1e3
        if self.devicetime is not None:
            self.devicetime.attribute("verify", wait, rec["_devt"][1])
            self.devicetime.note_dispatch_end(time.perf_counter())
        # One sequential device step advanced every row of the batch.
        self._m_steps.inc()
        for idx, entry in enumerate(rec["entries"]):
            # Entries sit at their compact batch index, not their slot.
            self._sync_verify_row(entry, g[idx], rec["epoch"])

    def _sync_verify_row(self, entry, g, epoch):
        """Apply one row's verify outcome: accept the longest greedily
        matching proposal prefix and the correction token, advance the
        row, feed the controller and the proposer, retire on an exhausted
        budget."""
        row, slot = entry["row"], entry["slot"]
        if entry["gen"] != row.get("_sync_gen", 0) or \
                epoch != self._kv_epoch or row["err"] is not None or \
                row.get("_spec") is None:
            return  # failed, reset or retired since dispatch: void
        props = entry["props"]
        a = 0
        while a < len(props) and props[a] == int(g[a]):
            a += 1
        # Accepted proposals are the plain decode's tokens; the correction
        # comes from the same logits. Truncated to the budget: the
        # overshoot's K/V lie past the final position.
        emitted = (props[:a] + [int(g[a])])[: row["remaining"]]
        st = row["_spec"]
        st["ak"].update(len(props), a)
        with self._spec_lock:
            self._spec_rounds.append((len(props), a))
        saved = len(emitted) - 1
        if saved:
            self._m_spec_accepted.labels(self.speculate).inc(saved)
        row["spec_accepted"] = row.get("spec_accepted", 0) + saved
        row["generated"].extend(emitted)
        row["n_generated"] += len(emitted)
        row["remaining"] -= len(emitted)
        self.positions[slot] += len(emitted)
        self._m_occupied_steps.inc(len(emitted))
        self.spec_proposer.observe(slot, emitted)
        # The chunk reads a row's token from last_dev: if this row falls
        # back to the chunk, it must find the last emitted token there. In
        # place: last_dev is a captured graph's buffer. Every rank's must.
        with self._link_lock():
            if self.link:
                self.link.announce(_OP_SPEC_ACCEPT,
                                   ints=(slot, emitted[-1]))
            self.last_dev[slot] = emitted[-1]
        if row["remaining"] <= 0:
            blocks = self.kv.release(slot)
            self.occupied[slot] = None
            self.positions[slot] = 0
            # The sync is immediate here, so the pool is fresh.
            self._finish_retire_paged(row, slot, blocks, True)

    def _next_row(self, block):
        """The next queued row, or None. ``block``: wait for one (the
        engine is idle), accruing idle time, until shutdown or a control
        call waits (the loop runs it at its next iteration)."""
        if not block:
            try:
                return self._q.get_nowait()
            except queue.Empty:
                return None
        t0 = time.perf_counter()
        row = None
        while not self._stop.is_set() and self._calls.empty() \
                and not self._link_rejoins:
            try:
                row = self._q.get(block=True, timeout=0.05)
                break
            except queue.Empty:
                now = time.perf_counter()
                self._m_t_idle.inc(now - t0)
                t0 = now
        self._m_t_idle.inc(time.perf_counter() - t0)
        if self.devicetime is not None:
            # The gap to the next dispatch is wait for work, not a bubble.
            self.devicetime.note_idle()
        return row

    def _run_call(self, call):
        with self._drain_lock:
            if call["state"] == "withdrawn":
                return
            call["state"] = "running"
        try:
            call["out"] = call["call"]()
        except Exception as e:  # noqa: BLE001 - raised in run_on_loop
            call["err"] = e
        finally:
            call["event"].set()

    def _loop_paged(self):
        """The asynchronous host loop: run the queued control calls and
        apply the drains (both after syncing the pending records), admit,
        dispatch one prefill segment per prefilling slot, the speculation
        round and one decode chunk, then sync the previous iteration's
        dispatches."""
        with torch.inference_mode():
            while not self._stop.is_set():
                if not self._calls.empty() or self._drain_requests or \
                        self._link_rejoins:
                    # Every migrated row's dispatched tokens land in it
                    # first, so its re-prefill regenerates none of them.
                    self._drain_pending_syncs()
                    self._run_calls()
                    self._apply_drains()
                    self._apply_link_rejoins()
                batch = []
                free = self._free_slots()
                while free:
                    idle = len(free) == self.max_slots and \
                        not self._pending_syncs
                    row = self._next_row(block=idle)
                    if row is None:
                        break
                    self._admit_paged(free.pop(0), row)
                for i, r in enumerate(self.occupied):
                    if r is not None and r.get("remaining") is None:
                        rec = self._advance_prefill_paged(i)
                        if rec is not None:
                            batch.append(rec)
                # Speculation: sync last iteration's verifies, dispatch
                # this iteration's (their rows then stay out of the
                # chunk).
                self._spec_tick()
                rec = self._dispatch_chunk_paged()
                if rec is not None:
                    batch.append(rec)
                self._drain_pending_syncs()
                self._pending_syncs = batch
            self._drain_pending_syncs()


class ServingMetrics:
    """The serving daemon's workload metrics, the JAX server's: the
    request counters live on ``registry`` (a fresh one when None), and
    the engine's or the micro-batcher's own registry (TTFT/TPOT/queue
    wait histograms, occupancy and batch gauges, phase counters, the
    SLO and chip accounting) renders into the same exposition. Served
    on ``GET /metrics`` and, with ``--metrics-port``, on a port of its
    own."""

    def __init__(self, model, registry=None):
        self.registry = registry if registry is not None \
            else obs_metrics.Registry()
        self.requests = obs_metrics.Counter(
            "tpu_serving_requests_total", "Completed /generate requests",
            ["outcome"], registry=self.registry)
        self.tokens = obs_metrics.Counter(
            "tpu_serving_generated_tokens_total",
            "Tokens generated (sum of max_new_tokens of successes)",
            registry=self.registry)
        self.latency = obs_metrics.Histogram(
            "tpu_serving_request_latency_seconds",
            "End-to-end /generate latency", buckets=LATENCY_BUCKETS,
            registry=self.registry)
        # The engine's or batcher's registry (and, behind a batcher, a
        # wrapped engine's), each rendered once.
        self._extra = []
        seen = {id(self.registry)}
        for m in (model, getattr(model, "model", None)):
            reg = getattr(m, "registry", None)
            if reg is not None and id(reg) not in seen:
                seen.add(id(reg))
                self._extra.append(reg)

    def observe(self, ok, latency_s, new_tokens, outcome=None):
        """``outcome`` overrides the label ("shed" for a typed shed,
        neither ok nor an error)."""
        self.requests.labels(outcome or ("ok" if ok else "error")).inc()
        if ok:
            self.tokens.inc(new_tokens)
            self.latency.observe(latency_s)

    def render(self):
        return b"".join(
            [self.registry.render()] + [r.render() for r in self._extra])


def make_handler(model, state, metrics=None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            log.debug(fmt, *args)

        def _send(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics" and metrics is not None:
                body = metrics.render()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path != "/healthz":
                self._send({"error": "not found"}, 404)
            elif state["ready"]:
                info = {"status": "ok"}
                # The fleet identity and serving role (--replica-id,
                # --role): a router's probe learns them.
                if state.get("replica_id"):
                    info["replica"] = state["replica_id"]
                if state.get("role"):
                    info["role"] = state["role"]
                if isinstance(model, ContinuousEngine):
                    # The cheap load snapshot a router probes: host-side
                    # integers only.
                    stats, kvs = model.stats(), model.kv_stats()
                    info["queue_depth"] = stats["queue_depth"]
                    info["occupied_slots"] = stats["occupied_slots"]
                    info["max_slots"] = model.max_slots
                    if model.tenants is not None:
                        info["tenant_queues"] = stats["tenant_queues"]
                    if kvs is not None:  # a paged engine
                        info["prefix_hit_ratio"] = kvs["prefix_hit_ratio"]
                        info["free_blocks"] = kvs["free_blocks"]
                self._send(info)
            elif state.get("error"):
                self._send({"status": "failed", "error": state["error"]},
                           500)
            else:
                self._send({"status": "warming up"}, 503)

        def _body(self):
            """The request's body, read whole. Every POST path reads it
            before replying: a body left unread when the connection
            closes makes the kernel reset it, dropping whatever of the
            reply it has not sent yet."""
            length = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(length)

        def _dump_flight(self):
            """POST /debug/flight: dump the flight recorder's bundle now
            (503 when it is off, 429 when its rate limit held it)."""
            rec = obs_flight.get()
            if rec is None:
                self._send({"error": "flight recorder disarmed "
                                     "(--flight-recorder)"}, 503)
                return
            path = rec.trigger("on_demand")
            if path is None:
                self._send({"error": "dump suppressed (rate limit / "
                                     "dedup window)"}, 429)
                return
            self._send({"bundle": path})

        def _kv_handoff(self):
            """POST /kv/export {tokens, traceparent} → {frames}; POST
            /kv/install {frames} → the install summary. The JAX server's
            status codes: a miss (or a dense engine) is an empty export,
            not an error, so the router re-prefills."""
            body = self._body()
            if not state["ready"]:
                self._send({"error": "not ready"}, 503)
                return
            try:
                req = json.loads(body or b"{}")
                if self.path == "/kv/export":
                    frames = model.kv_export(
                        [int(t) for t in (req.get("tokens") or [])],
                        traceparent=req.get("traceparent"))
                    self._send({"frames": frames})
                else:
                    self._send(model.kv_install(req.get("frames") or []))
            except kv_handoff.HandoffUnsupported:
                self._send({"frames": []})
            except kv_handoff.HandoffDesync as e:
                self._send({"error": f"desync: {e}"}, 409)
            except kv_handoff.HandoffError as e:
                self._send({"error": str(e)}, 503)
            except AttributeError:
                # A model with no engine has no kv_export / kv_install.
                self._send({"error": "no paged KV engine"}, 501)
            except Exception as e:  # noqa: BLE001 - serve errors as JSON
                log.exception("kv handoff endpoint failed")
                self._send({"error": str(e)}, 502)

        def do_POST(self):
            if self.path == "/debug/flight":
                self._body()
                self._dump_flight()
                return
            if self.path in ("/kv/export", "/kv/install"):
                self._kv_handoff()
                return
            if self.path != "/generate":
                self._body()
                self._send({"error": "not found"}, 404)
                return
            try:
                req = json.loads(self._body() or b"{}")
                tokens = req.get("tokens") or [[1, 2, 3]]
                max_new = int(req.get("max_new_tokens", 16))
                eff_t, eff_k, eff_p = sanitize_sampler(
                    float(req.get("temperature", 0.0)),
                    int(req.get("top_k", 0)),
                    float(req.get("top_p", 1.0)),
                    model.cfg.vocab_size,
                )
                # W3C trace context: body field, else the header.
                traceparent = req.get("traceparent") or \
                    self.headers.get("traceparent")
                extra = {}
                if isinstance(model, ContinuousEngine):
                    # An engine's admission deadline, tenant class (body
                    # field, else the header) and trace context; the
                    # other paths have no queue.
                    if req.get("deadline_s") is not None:
                        extra["deadline_s"] = float(req["deadline_s"])
                    tenant = req.get("tenant") or \
                        self.headers.get("X-Tenant-Class")
                    if tenant is not None:
                        extra["tenant"] = str(tenant)
                    if traceparent is not None:
                        extra["traceparent"] = str(traceparent)
                t0 = time.perf_counter()
                with obs_trace.span("generate", rows=len(tokens),
                                    max_new=max_new,
                                    traceparent=traceparent):
                    out = model.generate(
                        tokens, max_new, temperature=eff_t, top_k=eff_k,
                        top_p=eff_p, seed=int(req.get("seed", 0)),
                        **extra,
                    )
                dt = time.perf_counter() - t0
                # Counted before the write, so /metrics holds a request
                # once its client has the response.
                if metrics is not None:
                    metrics.observe(True, dt, len(tokens) * max_new)
                try:
                    self._send({
                        "tokens": out,
                        "latency_s": round(dt, 4),
                        "sampler": {
                            "temperature": round(eff_t, 6),
                            "top_k": eff_k,
                            "top_p": round(eff_p, 6),
                        },
                    })
                except OSError:
                    # The client hung up before the write: the generate
                    # succeeded, so this is no failure.
                    log.info("client disconnected before response write")
            except ShedError as e:
                # A typed shed: 429 with its reason (and the shedding
                # tenant class), so the client backs off.
                if metrics is not None:
                    metrics.observe(False, 0.0, 0, outcome="shed")
                log.warning("request shed (%s): %s", e.reason, e)
                body = {"error": str(e), "shed": e.reason}
                if getattr(e, "tenant", None):
                    body["tenant"] = e.tenant
                self._send(body, 429)
            except Exception as e:  # noqa: BLE001 - serve errors as JSON
                if metrics is not None:
                    metrics.observe(False, 0.0, 0)
                log.exception("generate failed")
                self._send({"error": str(e)}, 500)

    return Handler


def warmup(model, state, health_log, mode="lazy"):
    """Warm the model, then flip ready. ``mode="all"`` first runs a
    continuous engine's whole shape grid (``warmstart.warmup.warm_engine``:
    every prefill shape, every decode graph captured; its
    ``warmup_done`` record on the engine's event stream) and keeps its
    summary in ``state["warmup"]``; ``"lazy"`` leaves each decode graph's
    capture to its first chunk. Either way one short request
    then runs end to end (through the engine when ``model`` is one; it
    builds the CUDA kernels on first use). Once it succeeds, JAX's ready
    line is appended to ``health_log`` when set; a failed warmup writes
    nothing."""
    try:
        t0 = time.perf_counter()
        if mode == "all":
            if isinstance(model, ContinuousEngine):
                state["warmup"] = ws_warmup.warm_engine(
                    model, mode=mode, events=model.events)
            else:
                log.warning(
                    "--warmup=all needs --continuous-batching (only the "
                    "continuous engine has a shape grid to warm); falling "
                    "back to the single warmup request"
                )
        model.generate([[1, 2, 3, 4]], 4)
        dt = time.perf_counter() - t0
        state["ready"] = True
        log.info("warmup decode done in %.1fs; serving ready", dt)
        if health_log:
            # Append-only: the startupProbe greps for the ready line
            # (demo/serving/transformer-serving.yaml).
            with open(health_log, "a") as f:
                f.write(f"{READY_LINE} warmup_s={dt:.1f}\n")
    except Exception as e:  # noqa: BLE001 - must surface, thread dies silent
        log.exception("warmup failed")
        state["error"] = str(e)


class ServingHTTPServer(ThreadingHTTPServer):
    """The daemon's HTTP server, with a listen backlog for bursts of
    concurrent clients: past socketserver's default of 5 pending
    connections, a burst that arrives while the accept thread is behind
    is reset by the kernel, and those requests never reach admission."""

    request_queue_size = 128


def start_server(model, port=8000, host="0.0.0.0", warmup_mode="lazy",
                 metrics=None, replica_id="", role="", health_log=""):
    """Serve ``model`` on (host, port) from a daemon thread and warm it up
    in another (``warmup`` with ``warmup_mode``, writing the ready line to
    ``health_log`` when set). ``metrics`` (a
    :class:`ServingMetrics`, built for ``model`` when None) counts the
    requests and renders ``GET /metrics``; ``/healthz`` carries
    ``replica_id`` and ``role`` when set (the CLI sets ``--role``, whose
    default is "unified", as the JAX server does). Returns (server, state);
    ``state["ready"]`` flips once the warmup decode succeeded. ``port=0``
    picks a free port (``server.server_address[1]``)."""
    if metrics is None:
        metrics = ServingMetrics(model)
    state = {"ready": False, "replica_id": replica_id, "role": role}
    server = ServingHTTPServer((host, port),
                               make_handler(model, state, metrics))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    threading.Thread(target=warmup,
                     args=(model, state, health_log, warmup_mode),
                     daemon=True).start()
    return server, state


def post_generate(port, tokens, max_new_tokens, timeout=600, **sampler):
    """POST /generate to a local server; returns the decoded response."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"tokens": tokens, "max_new_tokens": max_new_tokens,
                         **sampler}).encode(),
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def wait_ready(state, timeout):
    """Block until warmup finished; raises if it failed or timed out."""
    deadline = time.monotonic() + timeout
    while not state["ready"]:
        if state.get("error"):
            raise RuntimeError(f"warmup failed: {state['error']}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"warmup did not finish in {timeout}s")
        time.sleep(0.05)


def config_from_args(args):
    """The served config, JAX's: the preset or the flags' widths, with
    ``--overlap`` riding the config so every serving path resolves the
    same mode."""
    if args.preset == "llama3-8b":
        cfg = tf.TransformerConfig.llama3_8b()
    else:
        cfg = tf.TransformerConfig(
            vocab_size=args.vocab_size,
            d_model=args.d_model,
            n_layers=args.n_layers,
            n_heads=args.n_heads,
            n_kv_heads=max(args.n_heads // 2, 1),
            d_ff=args.d_model * 3,
            max_seq_len=args.seq_len,
            dtype=args.dtype,
        )
    overlap = getattr(args, "overlap", cfg.overlap)
    if cfg.overlap != overlap:
        cfg = dataclasses.replace(cfg, overlap=overlap)
    return cfg


def build_parser():
    """The daemon's flags, the JAX server's names and defaults."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--vocab-size", type=int, default=1024)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float16", "float32"])
    p.add_argument("--preset", choices=["llama3-8b"], default=None,
                   help="named model config (overrides the shape flags)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain attention "
                        "(tests). Without a GPU the default fails.")
    p.add_argument("--once", action="store_true",
                   help="warm up, serve one request to self, exit (tests)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: >1 runs a world of that "
                        "many processes, one per GPU, joined through the "
                        "worker-identity env contract (TPU_WORKER_ID, "
                        "TPU_WORKER_HOSTNAMES, LOCAL_RANK, "
                        "LOCAL_WORLD_SIZE); rank 0 serves HTTP and "
                        "announces every device call over the lockstep "
                        "link, the others replay them. Must equal the "
                        "world's size")
    p.add_argument("--overlap", choices=["auto", "ring", "off"],
                   default="auto",
                   help="latency-hiding tensor parallelism: ring "
                        "collective-matmul decomposition for the tp-axis "
                        "collectives (parallel/overlap.py); rides "
                        "TransformerConfig so every engine path sees it; "
                        "shapes that cannot ring (incl. single-token "
                        "decode steps) take the exact fallback")
    p.add_argument("--link-timeout-s", type=float, default=0.0,
                   help="tensor-parallel continuous batching: bound every "
                        "lockstep-link collective with a watchdog; a "
                        "rank that vanishes mid-collective produces a "
                        "link_wedged event (badput) + "
                        "tpu_serving_link_wedges_total, rank 0 fails its "
                        "in-flight requests and the process exits for "
                        "its supervisor to restart the gang. 0 = "
                        "unbounded")
    p.add_argument("--health-log",
                   default=os.environ.get("HEALTH_CHECK_LOG_FILE", ""),
                   help="append the ready line (tpu-serving ready "
                        "warmup_s=<s>) here once warmup succeeds "
                        "(default: the HEALTH_CHECK_LOG_FILE env)")
    p.add_argument("--replica-id",
                   default=os.environ.get("TPU_REPLICA_ID", ""),
                   help="fleet identity this replica registers under: "
                        "stamped into /healthz (the router's probe), "
                        "the event stream's host identity and a KV "
                        "handoff stream's source (default: the "
                        "TPU_REPLICA_ID env)")
    p.add_argument("--role", choices=["unified", "prefill", "decode"],
                   default="unified",
                   help="serving role in a disaggregated fleet: "
                        "'prefill' replicas take new prompts and export "
                        "their KV blocks, 'decode' replicas install "
                        "handed-off blocks (POST /kv/export | "
                        "/kv/install) and run the decode batch, "
                        "'unified' does both. Advertised on /healthz; "
                        "the fleet router narrows dispatch by it")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="> 0 enables dynamic micro-batching: concurrent "
                        "compatible greedy requests coalesce into one "
                        "device call within this window")
    p.add_argument("--continuous-batching", action="store_true",
                   help="slot-based continuous batching: requests join "
                        "and leave the shared decode at chunk granularity "
                        "regardless of shape; supersedes "
                        "--batch-window-ms")
    p.add_argument("--kv-cache", choices=["dense", "paged"],
                   default="dense",
                   help="continuous batching: 'dense' keeps one cache row "
                        "per slot and a synchronous host loop; 'paged' "
                        "runs the block-pool KV cache with radix prefix "
                        "reuse (shared prompts skip prefill) and the "
                        "asynchronous double-buffered host loop")
    p.add_argument("--kv-block-size", type=int, default=16,
                   help="paged KV cache: tokens per block (power of two "
                        "<= 16, must divide --seq-len)")
    p.add_argument("--kv-blocks", type=int, default=0,
                   help="paged KV cache: total pool blocks (0 = auto: "
                        "full per-slot coverage + room for ~2 cached "
                        "contexts). Must be >= max_slots x "
                        "seq_len/block_size + 1 so decode can always "
                        "allocate")
    p.add_argument("--max-slots", type=int, default=MAX_BATCH,
                   help="continuous batching: KV slots / concurrent "
                        "requests")
    p.add_argument("--decode-chunk", type=int, default=32,
                   help="continuous batching: max fused decode steps "
                        "between admission points; rounded down to a "
                        "power of two")
    p.add_argument("--prefill-chunk", type=int, default=512,
                   help="continuous batching: prompts longer than this "
                        "prefill in segments of this size, interleaved "
                        "with decode chunks; power of two")
    p.add_argument("--speculate", choices=SPECULATE_MODES, default="off",
                   help="speculative decoding (paged continuous batching "
                        "only): propose k tokens per row and verify them "
                        "in one device call, accepting the longest "
                        "greedily-matching prefix: the tokens of 'off', "
                        "in fewer sequential device steps. 'ngram' "
                        "proposes the continuation that followed the "
                        "current suffix earlier in the request (host "
                        "side); 'draft' runs a small derived draft model "
                        "on its own paged slots. Per-row adaptive k backs "
                        "off to the fused chunk on low acceptance")
    p.add_argument("--speculate-k", type=int, default=8,
                   help="speculative decoding: max proposed tokens per "
                        "verify step (rounded down to a power of two)")
    p.add_argument("--quantize", choices=QUANTIZE_MODES, default="none",
                   help="weight-only int8 decode (W8A16): the seven layer "
                        "matrices per-channel int8, each product the "
                        "hand-written dequantising kernel on the card")
    p.add_argument("--max-queue", type=int, default=256,
                   help="continuous batching: bound on the admission "
                        "queue; beyond it requests are shed with a typed "
                        "429 (queue_full) instead of building an "
                        "unbounded backlog (0 = unbounded)")
    p.add_argument("--request-deadline-s", type=float, default=0.0,
                   help="continuous batching: default per-request "
                        "admission deadline; a request still queued past "
                        "it is shed (429, deadline). A request may set "
                        "its own with \"deadline_s\" in the POST body "
                        "(0 = none)")
    p.add_argument("--tenant-classes", default="",
                   help="continuous batching: per-tenant admission "
                        "config (a JSON object, inline or a file path; "
                        "fleet/tenants.py): each class names a priority, "
                        "a queue_share (its slice of --max-queue, and "
                        "its weight in the stride-scheduled dequeue) and "
                        "an optional rate_tokens_per_s quota. Requests "
                        "name their class in the POST body (\"tenant\") "
                        "or the X-Tenant-Class header; a class over its "
                        "share or quota is shed (429, class_share or "
                        "quota, the tenant named). Empty = off")
    p.add_argument("--step-retries", type=int, default=1,
                   help="continuous batching: retry a prefill, decode "
                        "chunk or verify that fails at dispatch this "
                        "many times with jittered backoff before failing "
                        "its requests")
    p.add_argument("--fault-plan", default="",
                   help="arm a fault-injection plan (faults/plan.py "
                        "JSON): faults fire at the scripted hits of the "
                        "serving.prefill, serving.chunk and "
                        "serving.verify sites")
    p.add_argument("--event-log", default="",
                   help="continuous batching: append the engine's "
                        "structured events (sheds, step retries, "
                        "migrations) and the fault plan's to this JSONL "
                        "file (obs/events.py schema)")
    p.add_argument("--compile-cache-dir", default="",
                   help="arm the persistent compile cache under this "
                        "stack-owned directory (warmstart/cache.py; keyed "
                        "by topology + transformer config + shape "
                        "buckets): the kernel builds (nvcc libraries, "
                        "Triton specialisations) land there, so a "
                        "replacement replica reuses them; hits/misses "
                        "land in tpu_compile_cache_{hits,misses}_total")
    p.add_argument("--warmup", choices=ws_warmup.WARMUP_MODES,
                   default="lazy",
                   help="'all' runs the continuous engine's whole shape "
                        "grid (every prefill shape, every decode graph "
                        "captured) BEFORE /healthz flips ready; 'lazy' "
                        "captures each decode graph at its first chunk "
                        "(default)")
    p.add_argument("--slo-ttft-ms", type=float, default=0.0,
                   help="serving SLO: time-to-first-token objective in "
                        "ms. Retired requests above it (and every "
                        "shed/deadline rejection) count as SLO "
                        "violations in tpu_serving_slo_requests_total"
                        "{outcome} and drag the rolling "
                        "tpu_serving_slo_goodput_ratio gauge the "
                        "burn-rate alerts watch. Engine paths only "
                        "(--continuous-batching); 0 = no TTFT "
                        "objective")
    p.add_argument("--slo-tpot-ms", type=float, default=0.0,
                   help="serving SLO: per-output-token decode-time "
                        "objective in ms (0 = no TPOT objective)")
    p.add_argument("--alert-rules", default="",
                   help="arm the multi-window burn-rate alert "
                        "evaluator (obs/alerts.py) with this JSON rule "
                        "file; alert_fired/alert_resolved events land "
                        "on the unified stream (and --alerts-out)")
    p.add_argument("--alerts-out", default="",
                   help="append alert_fired/alert_resolved events to "
                        "this JSONL file (with --alert-rules)")
    p.add_argument("--trace-out", default="",
                   help="write a Chrome trace-event JSON of the run's "
                        "request/engine spans here on exit (load in "
                        "Perfetto); a JSONL twin lands at <path>.jsonl")
    p.add_argument("--chip-accounting", action="store_true",
                   help="arm the chip-accounting tier (obs/devicetime"
                        ".py + obs/hbm.py): every device call's "
                        "measured wall is attributed pro-rata to the "
                        "rows it served (tpu_serving_device_seconds_"
                        "total{phase,tenant_class} + a device_s attr "
                        "on request_retired), host-loop bubbles become "
                        "first-class, the fairness share gauges the "
                        "tenant-share-drift rule watches go live, and "
                        "the modeled tpu_hbm_bytes{component} "
                        "occupancy gauges land in the engine registry. "
                        "Engine paths only (--continuous-batching); "
                        "zero cost when off")
    p.add_argument("--flight-recorder", action="store_true",
                   help="arm the always-on flight recorder (obs/"
                        "flight.py): a bounded ring of 250ms delta "
                        "snapshots over every serving registry, fused "
                        "with the event tail and recent trace spans; "
                        "an alert, crash, SIGUSR2 or POST /debug/flight "
                        "dumps a postmortem bundle. Recorder health on "
                        f":{obs_ports.FLIGHT_PORT}/metrics; zero cost "
                        "when off (one is-None check per hook site)")
    p.add_argument("--flight-window-s", type=float,
                   default=obs_flight.DEFAULT_WINDOW_S,
                   help="flight-recorder ring depth in seconds of "
                        "history retained (memory stays O(window))")
    p.add_argument("--flight-dir", default="/tmp/tpu-flight",
                   help="directory postmortem bundles are dumped into")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="ALSO serve the workload /metrics on this "
                        "dedicated port (convention: "
                        f"{obs_ports.WORKLOAD_METRICS_PORT}, see "
                        "obs/ports.py; 0 = main port only)")
    p.add_argument("--profile-dir", default="",
                   help="capture a torch.profiler trace (CPU and CUDA "
                        "activities) of the serving run into this "
                        "directory as Chrome trace JSON; align it with "
                        "--trace-out's spans through the span trace's "
                        "epoch metadata")
    return p


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    args = build_parser().parse_args(argv)
    if args.speculate != "off" and (
        not args.continuous_batching or args.kv_cache != "paged"
        or (args.tp > 1 and tp_world_spans_hosts())
    ):
        # Speculation rides the paged engine's verify and its host loop,
        # on one host (a --tp world there announces its verify rounds):
        # degrade loudly, keep serving (before the compile cache's key,
        # as in JAX).
        log.warning("--speculate=%s needs single-host --continuous-batching "
                    "with --kv-cache=paged; falling back to off",
                    args.speculate)
        args.speculate = "off"
    if args.fault_plan:
        plan = faults.arm_from_flag(args.fault_plan,
                                    sink_path=args.event_log)
        log.warning("fault plan armed from %s (seed %d, %d faults)",
                    args.fault_plan, plan.seed, len(plan.faults))
    tracer = obs_trace.configure() if args.trace_out else None
    try:
        # The profiler and the span tracer bracket the same region (the
        # whole run, warmup included); the span trace's metadata carries
        # its wall-clock epoch, which aligns the two timelines.
        with profiling.trace_or_null(args.profile_dir):
            return _serve(args)
    finally:
        if args.profile_dir:
            log.info("torch.profiler trace written to %s",
                     args.profile_dir)
        if tracer is not None:
            tracer.write_chrome(args.trace_out)
            tracer.write_jsonl(args.trace_out + ".jsonl")
            log.info("span trace written to %s (+ .jsonl)", args.trace_out)
        if args.compile_cache_dir:
            ws_cache.deactivate()


def _make_slo(args, registry):
    """A :class:`ServingSLO` on the engine's registry when an SLO flag
    is set; None otherwise (nothing registered, one check a retire)."""
    ttft_ms = getattr(args, "slo_ttft_ms", 0.0) or 0.0
    tpot_ms = getattr(args, "slo_tpot_ms", 0.0) or 0.0
    if not ttft_ms and not tpot_ms:
        return None
    return ServingSLO(ttft_s=ttft_ms / 1e3, tpot_s=tpot_ms / 1e3,
                      registry=registry)


def _make_devicetime(args, registry, tenants):
    """A ``DeviceTimeLedger`` on the engine's registry under
    ``--chip-accounting``; None otherwise (nothing registered, one check
    a dispatch hook)."""
    if not getattr(args, "chip_accounting", False):
        return None
    return obs_devicetime.DeviceTimeLedger(registry=registry,
                                           tenants=tenants)


def _attach_hbm(args, engine):
    """The ``HbmModel`` gauges on the built engine's registry under
    ``--chip-accounting``, kept on the engine for its shutdown record.
    Returns the model or None."""
    if not getattr(args, "chip_accounting", False):
        return None
    engine.hbm = obs_hbm.HbmModel(engine)
    return engine.hbm


def _wire_flight(args, model, metrics):
    """Arm the flight recorder over every registry and stream the daemon
    owns under ``--flight-recorder``; None otherwise (nothing created).
    Its state providers are /healthz's cheap snapshots: ``stats()`` and
    ``kv_stats()``."""
    if not getattr(args, "flight_recorder", False):
        return None
    registries = [("serving", metrics.registry)]
    for i, reg in enumerate(metrics._extra):
        registries.append((f"engine{i}" if i else "engine", reg))
    streams = []
    providers = []
    if isinstance(model, ContinuousEngine):
        if model.events is not None:
            streams.append(model.events)
        providers.append(("stats", model.stats))
        providers.append(("kv_stats", model.kv_stats))
    return obs_flight.wire_from_flags(
        True, args.flight_dir, registries=registries, streams=streams,
        tracer=obs_trace.get(), providers=providers,
        window_s=args.flight_window_s,
        host=getattr(args, "replica_id", "") or None,
    )


def build_serving(args, model, link_of=None):
    """What ``args`` serves over ``model`` (a :class:`Model`): a
    :class:`ContinuousEngine` with its SLO, device-time ledger, HBM model
    and event stream under ``--continuous-batching``, a
    :class:`BatchingModel` under ``--batch-window-ms``, else ``model``;
    then the request metrics, the alert evaluator and the flight
    recorder. ``link_of(events, registry)`` (rank 0 of a ``--tp``
    world) gives the engine's :class:`LockstepEngineLink` on its event
    stream and registry; the engine's sampled fall-through then goes
    through it (:class:`_LinkedSoloModel`). Returns (served, metrics,
    alerts, flight); the last two None when their flags are off."""
    if args.continuous_batching:
        tenants = fleet_tenants.TenantClasses.from_flag(args.tenant_classes)
        registry = obs_metrics.Registry()
        events = obs_events.EventStream(
            "serve", sink_path=args.event_log, registry=registry,
            host=getattr(args, "replica_id", "") or None,
        ) if args.event_log else None
        link = None
        if link_of is not None:
            link = link_of(events, registry)
            model = _LinkedSoloModel(model, link)
        model = ContinuousEngine(
            model, max_slots=args.max_slots, chunk=args.decode_chunk,
            prefill_chunk=args.prefill_chunk, kv_cache=args.kv_cache,
            kv_block_size=args.kv_block_size, kv_blocks=args.kv_blocks,
            speculate=args.speculate, speculate_k=args.speculate_k,
            max_queue=args.max_queue, deadline_s=args.request_deadline_s,
            step_retries=args.step_retries, tenants=tenants,
            registry=registry, events=events,
            slo=_make_slo(args, registry),
            devicetime=_make_devicetime(args, registry, tenants),
            link=link,
        )
        model.replica_id = getattr(args, "replica_id", "")
        _attach_hbm(args, model)
    elif args.batch_window_ms > 0:
        model = BatchingModel(model, window_ms=args.batch_window_ms)
    metrics = ServingMetrics(model)
    alerts = obs_alerts.wire_from_flags(
        [metrics.registry] + metrics._extra, args.alert_rules,
        alerts_out=args.alerts_out,
    )
    flight = _wire_flight(args, model, metrics)
    return model, metrics, alerts, flight


def _configure_compile_cache(args, cfg):
    """Arm ``--compile-cache-dir`` keyed as JAX's serve_cli keys it: the
    topology (``{n}x{platform}``: n the world's processes under ``--tp``,
    else the visible devices), the config (its ``overlap`` field the
    flag's, as in JAX) and the shape buckets of the chunks the engine
    will use (two spellings of one effective config share a directory),
    a speculating paged engine's verify widths, and its mode and
    k_max."""
    norm_prefill, norm_chunk = normalize_chunks(
        cfg.max_seq_len, args.prefill_chunk, args.decode_chunk)
    paged = args.kv_cache == "paged"
    spec_widths = None
    if args.speculate != "off" and paged:
        k_max, width = speculate_grid(args.speculate_k, cfg.max_seq_len)
        spec_widths = [width]
    buckets = tf.serving_shape_buckets(
        cfg, norm_prefill, norm_chunk,
        block_size=args.kv_block_size if paged else None,
        speculate_widths=spec_widths,
    )
    if spec_widths:
        buckets["speculate"] = [args.speculate, k_max]
    device = tf.resolve_device(args.device)
    platform = "gpu" if device.type == "cuda" else device.type
    if args.tp > 1:
        topology = f"{args.tp}x{platform}"
    elif device.type == "cuda":
        topology = f"{torch.cuda.device_count()}xgpu"
    else:
        topology = f"1x{device.type}"
    return ws_cache.configure_from_flag(
        args.compile_cache_dir,
        key=ws_cache.cache_key(
            topology=topology,
            cfg=dataclasses.asdict(cfg),
            buckets=sorted((k, tuple(v)) for k, v in buckets.items()),
        ),
        sink_path=args.event_log,
    )


# Seconds rank 0 gives its handlers to answer the failed requests after a
# link wedge, before it exits for its supervisor.
WEDGE_EXIT_GRACE_S = 1.0
# Rank 0's exit code after a link wedge (JAX's).
WEDGE_EXIT_CODE = 86


def _wedge_abort(engine_of):
    """Rank 0's link-watchdog reaction, JAX's ``_wedge_abort``: a wedged
    lockstep collective cannot be recovered in the process (a blocked
    broadcast is not interruptible), so once ``link_wedged`` is on the
    stream the requests in flight fail (``engine_of()``'s
    ``fail_in_flight``) and the process exits after
    ``WEDGE_EXIT_GRACE_S`` for its supervisor (the replica lifecycle) to
    restart the gang. Armed only with ``--link-timeout-s`` > 0."""

    def on_wedge(rank, op_seq):
        log.error(
            "lockstep link wedged (rank %d, op_seq %d): failing the "
            "requests in flight and exiting for supervisor restart",
            rank, op_seq,
        )
        engine = engine_of()
        if engine is not None:
            engine.fail_in_flight(LinkWedgedError(
                f"lockstep link wedged at op_seq {op_seq} (rank {rank})"))
        timer = threading.Timer(WEDGE_EXIT_GRACE_S, os._exit,
                                args=(WEDGE_EXIT_CODE,))
        timer.daemon = True
        timer.start()

    return on_wedge


def tp_world_spans_hosts(env=None):
    """Whether the worker-identity env contract names more than one host:
    the port's ``jax.process_count() > 1``, read before the world is
    joined."""
    from container_engine_accelerators_tpu_torch.parallel import bootstrap

    env = os.environ if env is None else env
    hosts = {h.strip() for h in env.get(
        bootstrap.WORKER_HOSTNAMES_ENV, "").split(",") if h.strip()}
    return len(hosts) > 1


def join_tp_world(args):
    """Join the ``--tp`` world: one process per GPU through the
    worker-identity env contract (``parallel/bootstrap.py``; NCCL on
    CUDA, gloo on the CPU). Refuses a world of any other size than
    ``--tp``, with JAX's wording; a process outside any world has one
    device. Returns (rank, device, the tp ``Axes`` of a ``{"tp": world}``
    mesh, the link's gloo group, the node of each rank). One eager
    all-reduce warms the communicator before any graph captures one."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import bootstrap
    from container_engine_accelerators_tpu_torch.parallel import (
        mesh as pmesh,
    )

    if os.environ.get(bootstrap.WORKER_ID_ENV) is None or \
            not os.environ.get(bootstrap.WORKER_HOSTNAMES_ENV):
        raise ValueError(f"--tp={args.tp} needs {args.tp} devices, have 1")
    opts = bootstrap.initialize_from_env(device=args.device)
    world = dist.get_world_size()
    if world != args.tp:
        raise ValueError(
            f"multi-host serving requires --tp == global device count "
            f"({world}), got --tp={args.tp}")
    device = torch.device(opts["device"])
    mesh = pmesh.make_mesh(pmesh.MeshPlan(("tp",), (world,)),
                           device_type=device.type)
    dist.all_reduce(torch.zeros(1, device=device), group=mesh.get_group("tp"))
    # The link's announcements travel on the host, over gloo, whatever
    # the backend of the per-layer collectives.
    group = dist.new_group(backend="gloo")
    hosts = [h.strip() for h in os.environ[
        bootstrap.WORKER_HOSTNAMES_ENV].split(",") if h.strip()]
    per_host = opts["local_world_size"]
    rank_hosts = [hosts[r // per_host] if r // per_host < len(hosts) else ""
                  for r in range(world)]
    return (opts["rank"], device, tpar.Axes.of_mesh(mesh), group,
            rank_hosts)


def _report_graphs(rank, engine):
    """A ``--tp`` rank's decode graphs as it stops: one JSON line on
    stdout (``{"rank", "graph_stats"}``), so a world's ranks can be read
    side by side (their all-reduces replay inside them)."""
    print(json.dumps({"rank": rank, "graph_stats": engine.graph_stats()}),
          flush=True)


def _follow(args, model, group, rank, rank_hosts):
    """A follower rank of a ``--tp`` world: no HTTP; replay rank 0's
    engine ops (``engine_follower_loop``, after the same warm plan under
    ``--warmup=all``) or its requests (``follower_loop``). Returns 0 on
    the shutdown broadcast."""
    if not args.continuous_batching:
        return follower_loop(model, group=group)
    events = obs_events.EventStream(
        "serve", sink_path=args.event_log,
        host=getattr(args, "replica_id", "") or None,
    ) if args.event_log else None
    link = LockstepEngineLink(
        model.cfg, args.max_slots, timeout_s=args.link_timeout_s,
        rank=rank, rank_hosts=rank_hosts, events=events, group=group,
    )
    engine = ContinuousEngine(
        model, max_slots=args.max_slots, chunk=args.decode_chunk,
        prefill_chunk=args.prefill_chunk, start_loop=False,
        kv_cache=args.kv_cache, kv_block_size=args.kv_block_size,
        kv_blocks=args.kv_blocks,
    )
    if args.speculate != "off":
        # Rank 0 proposes; this rank replays its verify rounds.
        engine._init_verify(args.speculate_k)
    warm = None
    if args.warmup == "all":
        def warm():
            ws_warmup.warm_engine(engine, mode="all", events=events)
    try:
        return engine_follower_loop(engine, link, warm=warm)
    finally:
        _report_graphs(rank, engine)
        engine.shutdown()


def _serve(args):
    """Build the model, what it serves (``build_serving``) and the
    server; serve until interrupted (``--once``: one request). Split
    from :func:`main` so ``--profile-dir`` and ``--trace-out`` bracket
    the whole run. Under ``--tp`` > 1 this process is one rank of a
    world of one process per GPU (:func:`join_tp_world`): rank 0 serves
    and announces (``LockstepModel``, or an engine over the lockstep
    link), the others follow (:func:`_follow`)."""
    cfg = config_from_args(args)
    device, axes, rank = args.device, None, 0
    group = rank_hosts = None
    if args.tp > 1:
        tp_serving.check_config(cfg, args.tp)
        rank, device, axes, group, rank_hosts = join_tp_world(args)
    if args.compile_cache_dir:
        _configure_compile_cache(args, cfg)
    model = Model(cfg, device=device, quantize=args.quantize, tp=args.tp,
                  axes=axes)
    if rank != 0:
        return _follow(args, model, group, rank, rank_hosts)
    link_of = None
    warmup_mode = args.warmup
    if args.tp > 1:
        if args.continuous_batching:
            served = []

            def link_of(events, registry):
                return LockstepEngineLink(
                    cfg, args.max_slots, timeout_s=args.link_timeout_s,
                    rank=0, rank_hosts=rank_hosts, events=events,
                    registry=registry, group=group,
                    on_wedge=_wedge_abort(
                        lambda: served[0] if served else None),
                )
        else:
            model = LockstepModel(model, group=group)
    model, metrics, alerts, flight = build_serving(args, model,
                                                   link_of=link_of)
    if link_of is not None:
        served.append(model)
        if warmup_mode == "all":
            # The followers run this plan right after the handshake, and
            # rank 0 runs it before it serves anything: every rank's warm
            # collectives come in the same order, before any announced op.
            ws_warmup.warm_engine(model, mode="all", events=model.events)
            warmup_mode = "lazy"
    server, state = start_server(model, port=args.port,
                                 warmup_mode=warmup_mode, metrics=metrics,
                                 replica_id=args.replica_id, role=args.role,
                                 health_log=args.health_log)
    log.info("listening on :%d", server.server_address[1])
    metrics_server = None
    try:
        if args.metrics_port:
            metrics_server = obs_metrics.serve(
                args.metrics_port, registry=metrics,
                owner="serving workload metrics (serve_cli --metrics-port)",
            )
            log.info("workload metrics on :%d/metrics", metrics_server.port)
        if args.once:
            try:
                wait_ready(state, timeout=3600)
            except (RuntimeError, TimeoutError) as e:
                log.error("%s", e)
                return 1
            print(json.dumps(
                post_generate(server.server_address[1], [[5, 6]], 2)
            ))
            return 0
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        return 0
    finally:
        server.shutdown()
        server.server_close()
        if metrics_server is not None:
            metrics_server.close()
        if alerts is not None:
            alerts.close()
        if flight is not None:
            flight.close()
            obs_flight.deactivate()
        if args.tp > 1 and isinstance(model, ContinuousEngine):
            _report_graphs(rank, model)
        if isinstance(model, (ContinuousEngine, BatchingModel,
                              LockstepModel)):
            # Under --tp this also broadcasts the followers' shutdown.
            model.shutdown()


if __name__ == "__main__":
    sys.exit(main())
