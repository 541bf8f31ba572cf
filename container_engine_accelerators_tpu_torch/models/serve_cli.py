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
graph before ``/healthz`` flips ready (``warmstart/warmup.py``);
``--warmup=lazy`` (the default) captures a graph at its first chunk.

Endpoints (the same JSON as the JAX server):
  GET  /healthz    200 once the warmup decode succeeded, 503 before,
                   500 if it failed; an engine adds queue_depth,
                   occupied_slots and max_slots, a paged one also
                   prefix_hit_ratio and free_blocks, one with
                   --tenant-classes also tenant_queues (queued rows
                   per class)
  POST /generate   {"tokens": [[...]], "max_new_tokens": N,
                    "temperature": 0.0, "top_k": 0, "top_p": 1.0,
                    "seed": 0, "deadline_s": D, "tenant": "..."}
                   (temperature 0 = greedy; deadline_s and tenant,
                   else the X-Tenant-Class header, reach an engine
                   only)
                   → {"tokens": [[...]], "latency_s": ...,
                      "sampler": {"temperature", "top_k", "top_p"}}
                   → 429 {"error", "shed": reason[, "tenant"]} when an
                      engine sheds the request (queue_full, deadline,
                      quota, class_share); 500 on any other error

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

Not ported yet (ROADMAP.md): KV handoff, the multi-host link, tensor
parallelism, the fleet reactor, and the obs surfaces (/metrics with
the serving SLO, traces, chip accounting). ``--event-log`` writes the
engine's structured events (sheds, retries, migrations) and the fault
plan's.

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
"""

import argparse
import collections
import functools
import itertools
import json
import logging
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
from container_engine_accelerators_tpu_torch.kvcache.blockpool import (
    PoolExhausted,
)
from container_engine_accelerators_tpu_torch.kvcache.manager import (
    PagedKVManager,
)
from container_engine_accelerators_tpu_torch.models import quantization as q8
from container_engine_accelerators_tpu_torch.models import serving_graphs
from container_engine_accelerators_tpu_torch.models import transformer as tf
from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics
from container_engine_accelerators_tpu_torch.ops import paged_attention as pa
from container_engine_accelerators_tpu_torch.warmstart import (
    warmup as ws_warmup,
)

log = logging.getLogger("serve_cli")

# Continuous batching: default KV slots (concurrent requests), as in the
# JAX server.
MAX_BATCH = 8
# --quantize's choices, the JAX server's.
QUANTIZE_MODES = ("none", "int8")
# The JAX server's bucket bounds of tpu_serving_queue_wait_seconds.
QUEUE_WAIT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                      30.0)


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
    requests that use them."""

    def __init__(self, cfg, seed=0, device="cuda", weights=None,
                 quantize="none"):
        if quantize not in QUANTIZE_MODES:
            raise ValueError(f"quantize must be one of {QUANTIZE_MODES}, "
                             f"got {quantize!r}")
        self.cfg = cfg
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

    Plain counters stand in for the JAX batcher's metrics: ``batch_rows``
    (the rows of the last coalesced call), ``queue_wait_s`` (enqueue to
    dispatch, per request, the latest 4096) and ``n_batches`` (coalesced
    calls made)."""

    def __init__(self, model, window_ms=5.0, max_batch=MAX_BATCH):
        self.model = model
        self.cfg = model.cfg
        self.window_s = window_ms / 1e3
        self.max_batch = max_batch
        self.batch_rows = 0
        self.queue_wait_s = collections.deque(maxlen=4096)
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
            "t_enq": time.perf_counter(),
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
        self.batch_rows = len(all_rows)
        now = time.perf_counter()
        self.queue_wait_s.extend(now - item["t_enq"] for item in batch)
        self.n_batches += 1
        try:
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
    ones. The sheds, retries, migrations and queue waits are instruments
    on ``registry`` (a fresh ``obs.metrics.Registry`` when None) under
    the JAX engine's names; ``events`` (an ``obs.events.EventStream``)
    receives ``request_shed``, ``tenant_shed``, ``step_retry``,
    ``request_migrated`` and ``migration_replayed`` records. Control
    calls (:meth:`run_on_loop`) have a queue of their own, outside the
    bound and the tenant classes.

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
                 registry=None, events=None, tenants=None):
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
        self.decode_graphs = self.chunk_graphs = None
        if kv_cache == "dense":
            self.cache = tf.init_kv_cache(self.cfg, max_slots, self.device)
            self.chunk_graphs = serving_graphs.DenseChunkGraphs(
                model.model, self.cache, max_slots, self.chunk,
            )
            # The device seams (the calls the JAX package jits).
            self._prefill = tf.prefill_into_slot
            self._prefill_seg = tf.prefill_chunk_into_slot
            self._chunk = self.chunk_graphs
        else:
            self._init_paged(kv_block_size, kv_blocks)
        self.speculate = speculate
        self.spec_proposer = None
        self.verify_graphs = None
        if speculate != "off":
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
                model.model, self.cache, self._spec_width,
                self.kv.blocks_per_seq, self.kv.block_size,
            )
            self._paged_verify = self.verify_graphs
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
        # them between iterations (slot state has one writer).
        self._drain_lock = threading.Lock()
        self._drain_requests = []
        self._rid = itertools.count(
            1 + 1_000_000 * next(ContinuousEngine._engine_seq))
        self.events = events
        reg = registry if registry is not None else obs_metrics.Registry()
        self.registry = reg
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
        # Plain counters in place of the rest of the JAX engine's
        # instruments (engine-loop writer; readers take GIL-atomic
        # snapshots).
        # t_*_dispatch_s: host wall inside the device calls (enqueueing
        # the work); t_*_wait_s: the syncs' waits (deferred on a paged
        # engine); t_chunk_device_s (CUDA only): event-timed device span
        # of each chunk, read at its sync.
        self.steps_done = 0
        self.n_prefills = 0
        self.n_chunks = 0
        self.occupied_steps = 0
        self.t_prefill_dispatch_s = 0.0
        self.t_prefill_wait_s = 0.0
        self.t_chunk_dispatch_s = 0.0
        self.t_chunk_wait_s = 0.0
        self.t_chunk_device_s = 0.0
        self.t_idle_s = 0.0
        # Chunks on a CUDA engine that did not replay their window's graph
        # once per step (a seam swapped for an eager call): 0 on the path.
        self.eager_chunks_on_cuda = 0
        # Speculation, in place of the JAX engine's spec metrics:
        # proposed tokens, accepted ones (emitted beyond the correction),
        # verify dispatches (one per window group), their host dispatch
        # and sync-wait seconds and their event-timed span on the card
        # (CUDA only), the trailing rounds' (proposed, accepted) for the
        # acceptance ratio, each retired row's accepted count, and
        # verifies on CUDA that did not replay their graph (0 on the
        # path).
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_verifies = 0
        self.t_verify_dispatch_s = 0.0
        self.t_verify_wait_s = 0.0
        self.t_verify_device_s = 0.0
        self._spec_rounds = collections.deque(maxlen=256)
        self.retired_spec_accepted = collections.deque(maxlen=4096)
        self.eager_verifies_on_cuda = 0
        # (prompt length, seconds from enqueue to the first token landing
        # on the host) per request: the stand-in for the JAX engine's
        # TTFT histogram.
        self.ttft_s = collections.deque(maxlen=4096)
        self._stop = threading.Event()
        self._thread = None
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
            self.cfg.n_layers, self.kv.num_blocks, self.cfg.n_kv_heads,
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
        # Bumped by _reset_paged: sync records dispatched before a pool
        # rebuild must not touch the fresh pool.
        self._kv_epoch = 0
        # Prior-iteration sync records (engine-loop thread only); an
        # attribute so allocation-pressure paths can drain them early
        # (their retire snapshots pin blocks until synced).
        self._pending_syncs = []

    # -- public surface -------------------------------------------------------

    def _shed_tenant(self, exc, tenant_class, rows):
        """Account one tenant-policy shed (quota / class share) and raise
        it: the per-class counters move and a ``tenant_shed`` event lands
        on the stream, but no ``request_shed`` record (that one reports
        engine-wide overload only)."""
        self._m_shed.labels(exc.reason).inc(rows)
        self._m_tenant_shed.labels(tenant_class, exc.reason).inc(rows)
        if self.events is not None:
            self.events.emit(
                "tenant_shed", severity="warning",
                tenant_class=tenant_class, reason=exc.reason, rows=rows,
            )
        raise exc

    def generate(self, tokens, max_new_tokens, temperature=0.0, top_k=0,
                 top_p=1.0, seed=0, deadline_s=None, tenant=None):
        """Greedy rows join the engine and block until they retire; a
        sampled request goes to the wrapped model on its own. Returns
        ``[prompt + generated]`` per row.

        Admission, in the JAX engine's order: the tenant class's queue
        share (:class:`ClassShareExceeded`), the ``max_queue`` watermark
        (:class:`QueueFull`), the class's token-rate quota
        (:class:`QuotaExceeded`); each sheds the whole request before
        any row is queued. ``deadline_s`` (else the engine's) sets the
        rows' admission deadline; ``tenant`` names their class."""
        temperature, top_k, top_p = sanitize_sampler(
            temperature, top_k, top_p, self.cfg.vocab_size
        )
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
        tcls = None
        if self.tenants is not None:
            tcls = self.tenants.resolve(tenant)
            # The class's share of the bounded queue first; the quota
            # last, so only work that passes every other gate consumes
            # bucket tokens.
            if self.max_queue:
                bound = max(1, int(tcls.queue_share * self.max_queue))
                if self._q.depth(tcls.name) + len(tokens) > bound:
                    self._shed_tenant(ClassShareExceeded(
                        f"tenant class {tcls.name} queue share full "
                        f"({self._q.depth(tcls.name)} waiting, share "
                        f"bound {bound}); retry with backoff",
                        tenant=tcls.name,
                    ), tcls.name, len(tokens))
        # A watermark, not an exact cap: qsize is approximate across
        # racing handlers.
        if self.max_queue and self._q.qsize() + len(tokens) > self.max_queue:
            self._m_shed.labels("queue_full").inc(len(tokens))
            if self.events is not None:
                self.events.emit(
                    "request_shed", severity="warning",
                    reason="queue_full", rows=len(tokens),
                    queue_depth=self._q.qsize(),
                )
            raise QueueFull(
                f"admission queue full ({self._q.qsize()} waiting, "
                f"bound {self.max_queue}); retry with backoff"
            )
        if tcls is not None and not self.tenants.try_consume(
            tcls.name, len(tokens) * int(max_new_tokens)
        ):
            self._shed_tenant(QuotaExceeded(
                f"tenant class {tcls.name} outran its token-rate "
                f"quota; retry with backoff", tenant=tcls.name,
            ), tcls.name, len(tokens))
        if deadline_s is None:
            deadline_s = self.deadline_s
        t_enq = time.perf_counter()
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
                "deadline": (t_enq + deadline_s) if deadline_s else None,
                "tenant": tcls.name if tcls is not None else None,
            }
            for r in tokens
        ]
        for row in rows:
            self._q.put(row)
        for row in rows:
            row["event"].wait()
        for row in rows:
            if row["err"] is not None:
                raise row["err"]
        return [row["prompt"] + row["out"] for row in rows]

    def stats(self):
        """Engine telemetry under the JAX engine's key set; a speculating
        engine adds ``spec_proposed``, ``spec_accepted``,
        ``spec_verifies`` and ``spec_acceptance`` (accepted over proposed
        in the trailing 256 rounds), the counters the JAX engine keeps as
        metrics only when it speculates."""
        out = {
            "steps_done": self.steps_done,
            "n_prefills": self.n_prefills,
            "n_chunks": self.n_chunks,
            "occupied_slots": sum(r is not None for r in self.occupied),
            "queue_depth": self._q.qsize(),
            "t_prefill_s": self.t_prefill_dispatch_s + self.t_prefill_wait_s,
            "t_chunk_s": self.t_chunk_dispatch_s + self.t_chunk_wait_s,
            "t_idle_s": self.t_idle_s,
            "occupied_steps": self.occupied_steps,
            # Queued rows per tenant class ({} without tenant classes).
            "tenant_queues": (
                self._q.depths() if self.tenants is not None else {}
            ),
        }
        if self.spec_proposer is not None:
            out.update(spec_proposed=self.spec_proposed,
                       spec_accepted=self.spec_accepted,
                       spec_verifies=self.spec_verifies,
                       spec_acceptance=self._spec_acceptance())
        return out

    def kv_stats(self):
        """The paged cache's snapshot (the manager's ``stats()``); None on
        a dense engine, as in JAX."""
        if self.kv is None:
            return None
        return self.kv.stats()

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

    def run_on_loop(self, fn):
        """Run ``fn()`` on the engine-loop thread between iterations
        (after the pending syncs) and return its result; captures and warm
        tasks go there, never beside the loop's own device calls. Runs it
        here when the engine has no loop thread, or this is it. The call
        waits in a queue of its own, which the loop serves before it
        admits requests: it never counts against ``max_queue`` or a
        tenant class."""
        if self._thread is None or self._thread is threading.current_thread():
            return fn()
        if self._stop.is_set():
            raise RuntimeError("engine is shut down")
        call = {"call": fn, "out": None, "err": None,
                "event": threading.Event()}
        self._calls.put(call)
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

    def shutdown(self):
        """Stop the engine loop and fail whatever is still queued or in
        flight, so a caller can drop the engine and free its pools."""
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
        if self.events is not None:
            self.events.emit(
                "request_shed", severity="warning", reason=exc.reason,
                rid=row["rid"],
            )
        row["err"] = exc
        row["event"].set()

    def _admission_open(self, row):
        """Admission's common head (the JAX ``_admit``'s): shed a row
        that waited out its deadline in the queue, unless it has decode
        state already (a migrated row: its work is paid for), and
        observe a first admission's queue wait. False when shed."""
        now = time.perf_counter()
        if row.get("deadline") is not None and "generated" not in row \
                and now > row["deadline"]:
            self._shed(row, DeadlineExceeded(
                f"deadline expired after {now - row['t_enq']:.3f}s in "
                f"queue"
            ))
            return False
        if "t_admit" not in row:
            self._m_queue_wait.observe(now - row["t_enq"])
            row["t_admit"] = now
        return True

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
        not retried. Raises the last attempt's error."""
        attempt = 0
        while True:
            mark = launched() if launched is not None else None
            try:
                return call()
            except Exception as e:  # noqa: BLE001 - retried or re-raised
                if attempt >= self.step_retries or (
                        launched is not None and launched() != mark):
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
                row["migrated_at"] = time.perf_counter()
                self._m_migrated.inc()
                if self.events is not None:
                    self.events.emit(
                        "request_migrated", severity="warning",
                        rid=row["rid"], slot=i, reason=reason,
                        generated=len(row.get("generated", [])),
                    )
                self._q.put(row)

    def _note_migration_replayed(self, row, slot):
        """A migrated row's re-prefill landed its first token: emit
        ``migration_replayed`` with the seconds since the drain
        (``lost_s``)."""
        if "migrated_at" not in row:
            return
        lost = time.perf_counter() - row.pop("migrated_at")
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
                    launched=None, **attrs):
        """One device call of the dense loop and its sync. ``dispatch()``
        enqueues the call and returns the device tensor to read back, or
        None; ``chunk`` charges its time to the chunk timers, else to the
        prefill ones. The dispatch and its read-back are retried as
        ``step`` (``_retrying``, with ``launched`` and ``attrs``).
        Returns (ok, the tensor's host values as a numpy array, or None).
        A call that still raises at dispatch fails ``targets`` ((slot,
        row) pairs) and keeps the cache: the rows' own cache entries are
        all it may have written. An error that surfaces at the sync resets the
        engine (``_reset_dense``), which fails them: the device may have
        written anything."""

        def call():
            out = dispatch()
            if out is None:
                return None, self._timing_event()
            return self._to_host(out)

        t0 = time.perf_counter()
        try:
            start = self._timing_event() if chunk else None
            host, event = self._retrying(step, call, launched, **attrs)
        except Exception as e:  # noqa: BLE001 - fail the rows, keep serving
            log.exception("%s failed", phase)
            for slot, row in targets:
                self._fail_row(row, slot, e, phase)
            return False, None
        t1 = time.perf_counter()
        try:
            if event is not None:
                event.synchronize()
            value = None if host is None else host.numpy()
        except Exception as e:  # noqa: BLE001 - an async device error
            log.exception("%s sync failed", phase)
            self._reset_dense(e, targets, f"{phase} sync")
            return False, None
        t2 = time.perf_counter()
        if chunk:
            self.t_chunk_dispatch_s += t1 - t0
            self.t_chunk_wait_s += t2 - t1
            if start is not None:
                self.t_chunk_device_s += start.elapsed_time(event) / 1e3
        else:
            self.t_prefill_dispatch_s += t1 - t0
            self.t_prefill_wait_s += t2 - t1
        return True, value

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
        if not self._admission_open(row):
            return
        ctx = row["prompt"] + row.get("generated", [])
        if len(ctx) > self.prefill_chunk:
            row["pending"] = np.asarray(ctx, np.int64)
            row["prefill_offset"] = 0
            row["remaining"] = None
            self.positions[slot] = 0
            self.occupied[slot] = row
            return
        bucket = tf._length_bucket(len(ctx), self.cfg.max_seq_len)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(ctx)] = ctx
        self.occupied[slot] = row

        def dispatch():
            # The armed plan's fault fires before the dispatch, so it is
            # always retriable (a free None check when disarmed).
            faults.fire("serving.prefill", slot=slot)
            return self._prefill(self.model.model, self.cache,
                                 self._to_device(padded), len(ctx), slot)

        ok, first = self._dense_call([(slot, row)], "prefill", dispatch,
                                     "prefill", rid=row["rid"])
        if ok:
            self.n_prefills += 1
            self._first_token(slot, row, len(ctx), int(first))

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
        ok, tok = self._dense_call(
            [(slot, row)], "chunked prefill",
            lambda: self._prefill_seg(
                self.model.model, self.cache, self._to_device(seg), off,
                slot, total - 1, window=window, want_logits=last,
            ), "prefill", rid=row["rid"],
        )
        if not ok:
            return
        self.n_prefills += 1
        row["prefill_offset"] = off + C
        if last:
            del row["pending"]
            self._first_token(slot, row, total, int(tok))

    def _first_token(self, slot, row, ctx_len, tok):
        """A prefill's first token has landed: the slot decodes from
        ``ctx_len``, or retires when that token was the budget."""
        self.positions[slot] = ctx_len
        self.last_tok[slot] = tok
        self._note_migration_replayed(row, slot)
        row.setdefault("generated", []).append(tok)
        row["remaining"] = row["max_new"] - len(row["generated"])
        if "t_first" not in row:
            row["t_first"] = time.perf_counter()
            self.ttft_s.append((len(row["prompt"]),
                                row["t_first"] - row["t_enq"]))
        if row["remaining"] <= 0:
            self._retire(slot)

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
            toks = self._chunk(self.last_tok, self.positions, active,
                               steps=steps, window=window,
                               mask_writes=prefilling)
            if self.device.type == "cuda" and \
                    graphs.replays - replays != steps:
                self.eager_chunks_on_cuda += 1
            return toks

        ok, toks = self._dense_call(
            [(i, self.occupied[i]) for i in occupied], "decode chunk",
            dispatch, "decode_chunk", chunk=True,
            launched=lambda: self.chunk_graphs.launched, rows=len(occupied),
        )
        if not ok:
            return
        self.steps_done += steps
        self.n_chunks += 1
        self.occupied_steps += steps * len(occupied)
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
        if not self._admission_open(row):
            return
        ctx = row["prompt"] + row.get("generated", [])
        reused, hit, _ = self.kv.admit(slot, ctx)
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
        src, dst = self.kv.ensure_writable(slot, first_block, last_block)
        if src:
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
            tok = self._paged_prefill(
                self.model.model, self.cache, self._to_device(seg), off,
                self._to_device(seg_ids), self._to_device(self.kv.tables[slot]),
                total - 1, self.last_dev, slot, window=window,
                want_logits=last,
            )
            if last:
                return self._to_host(tok)
            return None, self._timing_event()

        t0 = time.perf_counter()
        try:
            tok_h, event = self._retrying("prefill", call, rid=row["rid"])
        except Exception as e:  # noqa: BLE001 - fail the row, keep serving
            log.exception("paged prefill failed")
            self._fail_paged_row(row, slot, e, "paged prefill")
            return None
        self.n_prefills += 1
        self.t_prefill_dispatch_s += time.perf_counter() - t0
        row["prefill_offset"] = off + seg_len
        rec = {"kind": "seg", "row": row, "slot": slot, "tok": tok_h,
               "event": event, "epoch": self._kv_epoch,
               "gen": row.get("_sync_gen", 0)}
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
            toks = self._paged_chunk(self.kv.tables, self.positions, active,
                                     steps=steps, window=window)
            if self.device.type == "cuda" and \
                    self.decode_graphs.graphs.replays - replays != steps:
                self.eager_chunks_on_cuda += 1
            return self._to_host(toks)

        t0 = time.perf_counter()
        try:
            start = self._timing_event()
            # Allocation and copy-on-write above ran once; a retry holds
            # the same blocks. Once a step has advanced last_dev in place
            # the chunk is not retried.
            toks_h, event = self._retrying(
                "decode_chunk", call, lambda: self.decode_graphs.launched,
                rows=len(occupied))
        except Exception as e:  # noqa: BLE001 - fail the rows, keep serving
            log.exception("paged decode chunk failed")
            for i in occupied:
                if self.occupied[i] is not None:
                    self._fail_paged_row(self.occupied[i], i, e,
                                         "decode chunk")
            return None
        self.t_chunk_dispatch_s += time.perf_counter() - t0
        self.steps_done += steps
        self.n_chunks += 1
        self.occupied_steps += steps * len(occupied)
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
        return {"kind": "chunk", "toks": toks_h, "event": event,
                "start": start, "rows": rows, "gens": gens,
                "steps": steps, "epoch": self._kv_epoch}

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
        else:
            self.t_chunk_wait_s += wait
            if rec["start"] is not None:
                self.t_chunk_device_s += \
                    rec["start"].elapsed_time(rec["event"]) / 1e3
        if rec["kind"] == "seg":
            return
        now = time.perf_counter()
        if rec["kind"] == "first":
            row, slot = rec["row"], rec["slot"]
            if rec["gen"] != row.get("_sync_gen", 0) or \
                    row["err"] is not None:
                if fresh and "blocks" in rec:
                    self.kv.drop(rec["blocks"])
                return
            self._note_migration_replayed(row, slot)
            row.setdefault("generated", []).append(tok)
            if "t_first" not in row:
                row["t_first"] = now
                self.ttft_s.append((len(row["prompt"]), now - row["t_enq"]))
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

    def _retire_row(self, row, slot):
        """The retire tail (its slot is already free): publish the output
        and wake the handler thread."""
        del slot
        row["out"] = row["generated"]
        row["finish_step"] = self.steps_done
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
            greedy = self._paged_verify(segs, poss, bids, offs, tables,
                                        window=window)
            if self.device.type == "cuda" and \
                    self.verify_graphs.graphs.replays - replays != 1:
                self.eager_verifies_on_cuda += 1
            return self._to_host(greedy)

        t0 = time.perf_counter()
        try:
            start = self._timing_event()
            greedy_h, event = self._retrying("verify", call,
                                             rows=len(entries))
        except Exception as e:  # noqa: BLE001 - fail the rows, keep serving
            log.exception("speculative verify failed")
            for entry in entries:
                if self.occupied[entry["slot"]] is entry["row"]:
                    self._fail_paged_row(entry["row"], entry["slot"], e,
                                         "speculative verify")
            return None
        self.t_verify_dispatch_s += time.perf_counter() - t0
        self.spec_verifies += 1
        self.spec_proposed += sum(len(e["props"]) for e in entries)
        return {"greedy": greedy_h, "event": event, "start": start,
                "entries": entries, "epoch": self._kv_epoch}

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
        self.t_verify_wait_s += time.perf_counter() - t0
        if rec["start"] is not None:
            self.t_verify_device_s += \
                rec["start"].elapsed_time(rec["event"]) / 1e3
        # One sequential device step advanced every row of the batch.
        self.steps_done += 1
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
        self._spec_rounds.append((len(props), a))
        saved = len(emitted) - 1
        self.spec_accepted += saved
        row["spec_accepted"] = row.get("spec_accepted", 0) + saved
        row["generated"].extend(emitted)
        row["n_generated"] += len(emitted)
        row["remaining"] -= len(emitted)
        self.positions[slot] += len(emitted)
        self.occupied_steps += len(emitted)
        self.spec_proposer.observe(slot, emitted)
        # The chunk reads a row's token from last_dev: if this row falls
        # back to the chunk, it must find the last emitted token there. In
        # place: last_dev is a captured graph's buffer.
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
        while not self._stop.is_set() and self._calls.empty():
            try:
                row = self._q.get(block=True, timeout=0.05)
            except queue.Empty:
                now = time.perf_counter()
                self.t_idle_s += now - t0
                t0 = now
                continue
            self.t_idle_s += time.perf_counter() - t0
            return row
        self.t_idle_s += time.perf_counter() - t0
        return None

    @staticmethod
    def _run_call(call):
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
                if not self._calls.empty() or self._drain_requests:
                    # Every migrated row's dispatched tokens land in it
                    # first, so its re-prefill regenerates none of them.
                    self._drain_pending_syncs()
                    self._run_calls()
                    self._apply_drains()
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


def make_handler(model, state):
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
            if self.path != "/healthz":
                self._send({"error": "not found"}, 404)
            elif state["ready"]:
                info = {"status": "ok"}
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

        def do_POST(self):
            if self.path != "/generate":
                self._send({"error": "not found"}, 404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                tokens = req.get("tokens") or [[1, 2, 3]]
                max_new = int(req.get("max_new_tokens", 16))
                eff_t, eff_k, eff_p = sanitize_sampler(
                    float(req.get("temperature", 0.0)),
                    int(req.get("top_k", 0)),
                    float(req.get("top_p", 1.0)),
                    model.cfg.vocab_size,
                )
                extra = {}
                if isinstance(model, ContinuousEngine):
                    # An engine's admission deadline and tenant class
                    # (body field, else the header); the other paths
                    # have no queue.
                    if req.get("deadline_s") is not None:
                        extra["deadline_s"] = float(req["deadline_s"])
                    tenant = req.get("tenant") or \
                        self.headers.get("X-Tenant-Class")
                    if tenant is not None:
                        extra["tenant"] = str(tenant)
                t0 = time.perf_counter()
                out = model.generate(
                    tokens, max_new, temperature=eff_t, top_k=eff_k,
                    top_p=eff_p, seed=int(req.get("seed", 0)), **extra,
                )
                dt = time.perf_counter() - t0
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
                log.warning("request shed (%s): %s", e.reason, e)
                body = {"error": str(e), "shed": e.reason}
                if getattr(e, "tenant", None):
                    body["tenant"] = e.tenant
                self._send(body, 429)
            except Exception as e:  # noqa: BLE001 - serve errors as JSON
                log.exception("generate failed")
                self._send({"error": str(e)}, 500)

    return Handler


def warmup(model, state, mode="lazy"):
    """Warm the model, then flip ready. ``mode="all"`` first runs a
    continuous engine's whole shape grid (``warmstart.warmup.warm_engine``:
    every prefill shape, every decode graph captured) and keeps its
    summary in ``state["warmup"]``; ``"lazy"`` leaves each decode graph's
    capture to its first chunk. Either way one short request
    then runs end to end (through the engine when ``model`` is one; it
    builds the CUDA kernels on first use)."""
    try:
        t0 = time.perf_counter()
        if mode == "all":
            if isinstance(model, ContinuousEngine):
                state["warmup"] = ws_warmup.warm_engine(model, mode=mode)
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
    except Exception as e:  # noqa: BLE001 - must surface, thread dies silent
        log.exception("warmup failed")
        state["error"] = str(e)


def start_server(model, port=8000, host="0.0.0.0", warmup_mode="lazy"):
    """Serve ``model`` on (host, port) from a daemon thread and warm it up
    in another (``warmup`` with ``warmup_mode``). Returns (server, state);
    ``state["ready"]`` flips once the warmup decode succeeded. ``port=0``
    picks a free port (``server.server_address[1]``)."""
    state = {"ready": False}
    server = ThreadingHTTPServer((host, port), make_handler(model, state))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    threading.Thread(target=warmup, args=(model, state, warmup_mode),
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
    if args.preset == "llama3-8b":
        return tf.TransformerConfig.llama3_8b()
    return tf.TransformerConfig(
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        n_layers=args.n_layers,
        n_heads=args.n_heads,
        n_kv_heads=max(args.n_heads // 2, 1),
        d_ff=args.d_model * 3,
        max_seq_len=args.seq_len,
        dtype=args.dtype,
    )


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--vocab-size", type=int, default=1024)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--preset", choices=["llama3-8b"], default=None,
                   help="named model config (overrides the shape flags)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain attention "
                        "(tests). Without a GPU the default fails.")
    p.add_argument("--once", action="store_true",
                   help="warm up, serve one request to self, exit (tests)")
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
    p.add_argument("--warmup", choices=ws_warmup.WARMUP_MODES,
                   default="lazy",
                   help="'all' runs the continuous engine's whole shape "
                        "grid (every prefill shape, every decode graph "
                        "captured) BEFORE /healthz flips ready; 'lazy' "
                        "captures each decode graph at its first chunk "
                        "(default)")
    args = p.parse_args(argv)
    if args.speculate != "off" and (
        not args.continuous_batching or args.kv_cache != "paged"
    ):
        # Speculation rides the paged engine's verify and its host loop:
        # degrade loudly, keep serving.
        log.warning("--speculate=%s needs --continuous-batching with "
                    "--kv-cache=paged; falling back to off", args.speculate)
        args.speculate = "off"
    if args.fault_plan:
        plan = faults.arm_from_flag(args.fault_plan,
                                    sink_path=args.event_log)
        log.warning("fault plan armed from %s (seed %d, %d faults)",
                    args.fault_plan, plan.seed, len(plan.faults))
    tenants = fleet_tenants.TenantClasses.from_flag(args.tenant_classes)
    model = Model(config_from_args(args), device=args.device,
                  quantize=args.quantize)
    if args.continuous_batching:
        registry = obs_metrics.Registry()
        model = ContinuousEngine(
            model, max_slots=args.max_slots, chunk=args.decode_chunk,
            prefill_chunk=args.prefill_chunk, kv_cache=args.kv_cache,
            kv_block_size=args.kv_block_size, kv_blocks=args.kv_blocks,
            speculate=args.speculate, speculate_k=args.speculate_k,
            max_queue=args.max_queue, deadline_s=args.request_deadline_s,
            step_retries=args.step_retries, tenants=tenants,
            registry=registry,
            events=obs_events.EventStream(
                "serve", sink_path=args.event_log, registry=registry,
            ) if args.event_log else None,
        )
    elif args.batch_window_ms > 0:
        model = BatchingModel(model, window_ms=args.batch_window_ms)
    server, state = start_server(model, port=args.port,
                                 warmup_mode=args.warmup)
    log.info("listening on :%d", server.server_address[1])
    try:
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
        if isinstance(model, (ContinuousEngine, BatchingModel)):
            model.shutdown()


if __name__ == "__main__":
    sys.exit(main())
