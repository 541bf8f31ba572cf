# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Warmup: run the serving engine's shape grid before ready.

Port of ``container_engine_accelerators_tpu/warmstart/warmup.py``. A
``ContinuousEngine`` on CUDA captures a decode graph the first time a
chunk needs it (``serve_cli --warmup=lazy``): the capture (eager warm-up
iterations, a device synchronisation, the capture itself) lands inside
that request. :func:`warm_plan` enumerates the engine's grid from
``transformer.serving_shape_buckets`` and :func:`warm_engine` runs every
entry before ``/healthz`` flips ready (``--warmup=all``). A dense engine
(``kv_cache="dense"``):

  prefill/b{bucket}                     one single-shot prefill per
                                        length bucket, run eagerly into a
                                        free slot
  prefill_seg/w{window}/{mid|logits}    one chunked-prefill segment per
                                        segment window, run eagerly into a
                                        free slot
  decode/w{window}/m{mask}              the decode graph of each (window,
                                        mask_writes)
                                        (``DenseChunkGraphs.warm``)

A paged engine:

  pprefill/c{C}/w{window}/{logits|mid}  one paged prefill segment per
                                        (segment, window) pair, run
                                        eagerly (the segment is not
                                        captured); mid segments only at the
                                        full prefill chunk, as in JAX
  pdecode/w{window}                     the decode graph of each window
                                        (``PagedDecodeGraphs.warm``)
  verify/b{B}/c{C}/w{window}            a speculating engine's verify
                                        graph per (batch bucket, width,
                                        window) (``PagedVerifyGraphs.warm``)
  draft_prefill/..., draft_ingest/...,  a draft proposer's own grid
  draft_chunk/w{window}                 (group "draft",
                                        ``DraftProposer.warm_tasks``)

Deliberate differences from JAX:

  * one decode task per window (dense: per (window, mask)), not per
    (steps, window): the port captures one step and replays it ``steps``
    times (the draft's propose chunk likewise: ``draft_chunk/w{window}``);
  * no scratch caches: JAX runs the tasks on zeroed copies of the cache,
    and a copy of a full-width cache would double it on the card. A paged
    task writes only the null block: segments whose block ids and page
    table are all ``NULL_BLOCK``, decode graphs captured with every row
    inactive, verify graphs with every row's write targets and table
    null; first tokens land in a scratch vector, not the engine's
    ``last_dev``, and the manager's tables and radix index are not
    touched. A dense prefill task writes a free slot's rows, which its
    next occupant's prefill overwrites before anything reads them, and a
    dense decode capture restores what its warm-up iterations wrote;

``cache_hits``/``cache_misses`` are JAX's: the armed persistent compile
cache's deltas over the pass (``warmstart/cache.py``: kernel builds and
Triton compiles the tasks caused), 0 with nothing armed. The decode
graphs the pass captures are not persistent compiles; ``ContinuousEngine
.graph_stats()`` counts them.

The tasks run on the engine-loop thread (``ContinuousEngine.run_on_loop``),
where every capture of the engine's graphs happens; a follower rank's
engine of a ``--tp`` world has no loop, and its replay thread runs them
(``serve_cli.engine_follower_loop``, right after the link's handshake,
where rank 0 runs the same plan: every rank's warm collectives in one
order). ``max_tasks`` caps
the grid as JAX's does (the rest counted as ``dropped``), and the pass
ends with JAX's ``warmup_done`` record on the engine's event stream,
which the goodput ledger (``obs/goodput.py``) charges to ``compile``.
A follower rank runs the same plan as rank 0 and executes it: the port
has no ahead-of-time compile that would leave the collectives out, and
the handshake orders both passes before any announced op.
"""

import collections
import logging
import time

import torch

from container_engine_accelerators_tpu_torch.models import transformer as tf
from container_engine_accelerators_tpu_torch.ops import paged_attention as pa
from container_engine_accelerators_tpu_torch.warmstart import cache as ws_cache

log = logging.getLogger("warmstart.warmup")

WARMUP_MODES = ("all", "lazy")

# A task runs as fn(*args, **kwargs); ``group`` is the scratch group of
# the JAX plan: "engine" (the engine's own pools and graphs) or "draft" (a
# draft proposer's).
WarmTask = collections.namedtuple("WarmTask", "label fn args kwargs group",
                                  defaults=("engine",))


def warm_plan(engine):
    """Every warm task of ``engine``'s shape grid: a dense engine's
    (:func:`_warm_plan_dense`) or a paged one's
    (:func:`_warm_plan_paged`), by ``engine.kv``, as JAX dispatches."""
    if engine.kv is None:
        return _warm_plan_dense(engine)
    return _warm_plan_paged(engine)


def _in_free_slot(engine, fn, *args, **kwargs):
    """``fn(model, cache, ..., slot)`` on the engine's first free slot:
    a dense prefill task writes a slot's cache rows, which a slot in use
    must keep. Raises when every slot is in use."""
    free = engine._free_slots()
    if not free:
        raise RuntimeError("a dense prefill warm task needs a free slot")
    return fn(*args, free[0], **kwargs)


def _warm_plan_dense(engine):
    """The dense engine's grid, JAX's labels: a single-shot prefill per
    length bucket (``prefill/b{bucket}``), a chunked-prefill segment per
    (window, want_logits) (``prefill_seg/w{window}/{mid|logits}``, at the
    offset that fills the window), then the decode graph of every (window,
    mask_writes) (``decode/w{window}/m{mask}``; masked variants only where
    prefill is chunked, since writes are masked only while a slot is
    mid-prefill). JAX has one decode task per (steps, window, mask); the
    port captures one step and replays it ``steps`` times. The prefill
    tasks run eagerly into a free slot's cache rows, which its next
    occupant's prefill overwrites before anything reads them; the decode
    captures leave the cache as they found it
    (``DenseChunkGraphs.warm``). No task touches the host's positions or
    last tokens. Allocates the tasks' operands (zeros) on the engine's
    device."""
    cfg = engine.cfg
    buckets = tf.serving_shape_buckets(cfg, engine.prefill_chunk,
                                       engine.chunk)
    device = engine.device
    model = engine.model.model
    tasks = []
    for bucket in buckets["prefill"]:
        prompt = torch.zeros((1, bucket), dtype=torch.long, device=device)
        tasks.append(WarmTask(
            f"prefill/b{bucket}", _in_free_slot,
            (engine, engine._prefill, model, engine.cache, prompt, bucket),
            {},
        ))
    chunked = engine.prefill_chunk < cfg.max_seq_len
    if chunked:
        C = engine.prefill_chunk
        seg = torch.zeros((1, C), dtype=torch.long, device=device)
        for window in buckets["segment_windows"]:
            offset = window - C
            for want in (False, True):
                tasks.append(WarmTask(
                    f"prefill_seg/w{window}/{'logits' if want else 'mid'}",
                    _in_free_slot,
                    (engine, engine._prefill_seg, model, engine.cache, seg,
                     offset),
                    {"true_pos": window - 1, "window": window,
                     "want_logits": want},
                ))
    for window in buckets["windows"]:
        for mask in ((False, True) if chunked else (False,)):
            tasks.append(WarmTask(
                f"decode/w{window}/m{int(mask)}", engine.chunk_graphs.warm,
                (window, mask), {},
            ))
    return tasks


def _warm_plan_paged(engine):
    """The paged engine's grid: suffix-prefill segments per ``(segment,
    window, want_logits)`` (a segment may start at any block-aligned
    reused offset, so every window >= the segment is dispatchable; mid
    segments only ever run at the full ``prefill_chunk``), then one
    decode graph per window; a speculating engine adds its verify graph
    per (batch bucket, width, window), JAX's labels, and a draft
    proposer's own tasks (rank 0 of a linked world alone runs one). No dense program is enumerated: a paged engine
    never dispatches one. Allocates the tasks' operands (zeros, a few per
    segment length) on the engine's device."""
    cfg = engine.cfg
    bs = engine.kv.block_size
    # A follower rank of a linked world has the verify graphs and no
    # proposer.
    speculating = getattr(engine, "verify_graphs", None) is not None
    buckets = tf.serving_shape_buckets(
        cfg, engine.prefill_chunk, engine.chunk, block_size=bs,
        speculate_widths=[engine._spec_width] if speculating else None,
    )
    device = engine.device

    def null_ids(n):
        return torch.full((n,), pa.NULL_BLOCK, dtype=torch.long,
                          device=device)

    table_row = null_ids(engine.kv.blocks_per_seq)
    first_tokens = torch.zeros(engine.max_slots, dtype=torch.long,
                               device=device)
    chunked = engine.prefill_chunk < cfg.max_seq_len
    tasks = []
    for C, window in buckets["paged_prefill"]:
        wants = (
            (False, True) if (chunked and C == engine.prefill_chunk)
            else (True,)
        )
        seg = torch.zeros((1, C), dtype=torch.long, device=device)
        for want in wants:
            tasks.append(WarmTask(
                f"pprefill/c{C}/w{window}/{'logits' if want else 'mid'}",
                engine._paged_prefill,
                (engine.model.model, engine.cache, seg, 0, null_ids(C // bs),
                 table_row, C - 1, first_tokens, 0),
                {"window": window, "want_logits": want},
            ))
    for window in buckets["windows"]:
        tasks.append(WarmTask(f"pdecode/w{window}", engine.decode_graphs.warm,
                              (window,), {}))
    if speculating:
        # Every (width, window) pair a verify can reach (it starts at any
        # decode position), per power-of-two batch bucket of the rows
        # speculating in one round.
        from container_engine_accelerators_tpu_torch.models import serve_cli

        for B in serve_cli.verify_batch_sizes(engine.max_slots):
            for C, window in buckets["verify"]:
                tasks.append(WarmTask(
                    f"verify/b{B}/c{C}/w{window}", engine.verify_graphs.warm,
                    (B, window), {},
                ))
        warm = getattr(engine.spec_proposer, "warm_tasks", None)
        if warm is not None:
            tasks.extend(warm())
    return tasks


def build_summary(mode, tasks, compiled, skipped, dropped, dur_s,
                  snap0, snap1):
    """The warmup summary dict, the JAX ``build_summary``'s shape:
    ``compiled`` counts the tasks run, the cache counts are ``snap1``
    less ``snap0`` (``{"hits", "misses"}``)."""
    return {
        "mode": mode, "tasks": tasks, "compiled": compiled,
        "skipped": skipped, "dropped": dropped,
        "dur_s": round(dur_s, 6),
        "cache_hits": snap1["hits"] - snap0["hits"],
        "cache_misses": snap1["misses"] - snap0["misses"],
    }


def emit_done(events, summary):
    """Emit the ``warmup_done`` record with JAX's attrs (the goodput
    ledger charges it to ``compile``); no-op without an event stream."""
    if events is None:
        return
    events.emit(
        "warmup_done",
        tasks=summary["tasks"], compiled=summary["compiled"],
        skipped=summary["skipped"], dropped=summary["dropped"],
        dur_s=summary["dur_s"], cache_hits=summary["cache_hits"],
        cache_misses=summary["cache_misses"],
    )


def warm_engine(engine, mode="all", events=None, max_tasks=None):
    """Run the warmup pass on the engine-loop thread; returns the summary
    ``{mode, tasks, compiled, skipped, dropped, dur_s, cache_hits,
    cache_misses}``. ``mode="lazy"`` is the documented no-op.
    ``max_tasks`` bounds the grid: the tasks past it are dropped, counted
    and logged (their shapes capture on first use). ``events`` gets one
    ``warmup_done`` record. A task that raises fails the pass (the
    server then never reports ready)."""
    if mode not in WARMUP_MODES:
        raise ValueError(
            f"unknown warmup mode {mode!r}; known: {WARMUP_MODES}"
        )
    t0 = time.perf_counter()
    if mode != "all":
        zero = {"hits": 0, "misses": 0}
        return build_summary(mode, 0, 0, 0, 0, 0.0, zero, zero)
    tasks = warm_plan(engine)
    dropped = 0
    if max_tasks is not None and len(tasks) > max_tasks:
        dropped = len(tasks) - max_tasks
        log.warning(
            "warmup grid capped at %d of %d tasks (max_tasks); the "
            "dropped shapes capture on first use", max_tasks, len(tasks),
        )
        tasks = tasks[:max_tasks]
    snap0 = ws_cache.snapshot()

    def run():
        with torch.inference_mode():
            for task in tasks:
                task.fn(*task.args, **task.kwargs)
        if engine.device.type == "cuda":
            # dur_s covers the device work the tasks enqueued.
            torch.cuda.synchronize(engine.device)

    if engine._thread is None:
        # A follower rank's engine has no loop: its replay thread is the
        # only one that touches it.
        run()
    else:
        engine.run_on_loop(run)
    summary = build_summary(mode, len(tasks), len(tasks), 0, dropped,
                            time.perf_counter() - t0, snap0,
                            ws_cache.snapshot())
    emit_done(events, summary)
    log.info(
        "warmup (%s): %d task(s) run, %d dropped in %.2fs (compile cache "
        "hits %d / misses %d)", mode, summary["compiled"],
        summary["dropped"], summary["dur_s"], summary["cache_hits"],
        summary["cache_misses"],
    )
    return summary
