# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The serving decode as one device program per shape bucket: CUDA graphs.

The JAX package never runs its serving decode step by step from Python:
``paged_decode_chunk`` is one jitted ``lax.scan`` per (steps, window), and
the dense ``decode_many`` one per (steps, window, sampler) (JAX
``transformer._jitted_serving_fns``). PyTorch runs eagerly, and a step of
a full-width model enqueues about 40 small kernels a layer, so the host's
enqueue, not the card, would bound the decode. The counterpart of a
program compiled per shape bucket is a CUDA graph captured per bucket and
replayed:

  GraphSet            the capture machinery: eager warm-up iterations on a
                      side stream, then the capture into one private memory
                      pool shared by the set's graphs (they replay on one
                      stream and never overlap); counts captures, replays
                      and capture seconds
  PagedDecodeGraphs   one step of ``transformer.paged_decode_chunk`` per
                      window bucket over static buffers; a chunk of
                      ``steps`` steps replays its window's graph ``steps``
                      times (one graph per window, not per (steps,
                      window) as JAX compiles: a replay costs the host
                      microseconds against milliseconds of device work a
                      step). ``serve_cli.ContinuousEngine``'s decode.
  DenseChunkGraphs    one step of ``transformer.decode_chunk`` per (window,
                      mask_writes) over static buffers and the engine's
                      dense cache, replayed ``steps`` times a chunk; a
                      capture leaves every slot's cache as it found it.
                      The dense ``ContinuousEngine``'s decode.
  PagedVerifyGraphs   speculation's batched verify
                      (``transformer.paged_verify_batch``) per (batch
                      bucket, window) over static buffers per batch
                      bucket; the flash forward reads its per-row bases
                      from device memory, so one graph serves every
                      decode position. The engine's verify and the draft
                      proposer's ingest.
  DenseDecodeGraphs   one ``transformer.decode_logits`` step per (batch,
                      window) over a dense cache kept per batch size (at
                      most ``MAX_CACHED_ROWS`` rows of them, least
                      recently used evicted); ``transformer.generate``'s
                      decoder (the sampler runs eagerly after each
                      replay).

On the CPU the same step functions run eagerly over the same buffers:
the caller asked for the CPU, which has no graphs. On CUDA there is no
eager path: a capture or a replay that fails raises.
"""

import collections
import threading
import time

import numpy as np
import torch

from container_engine_accelerators_tpu_torch.models import transformer as tf
from container_engine_accelerators_tpu_torch.ops import int8_matmul

# Eager iterations of a step on a side stream before it is captured, as
# PyTorch asks: lazy set-up (cuBLAS handles and workspaces, kernel
# attributes) must not happen inside a capture.
WARMUP_ITERS = 2

# Rows of dense cache ``DenseDecodeGraphs`` keeps across requests by
# default: 8.6 GB for Llama-3-8B, the rows of one full batch of the
# server's slots (``serve_cli.MAX_BATCH``).
MAX_CACHED_ROWS = 8

# One capture at a time in the process. ``torch.cuda.graph`` empties the
# caching allocator's cache when a capture starts, which the allocator
# refuses while another capture is underway, and the allocator is shared
# by every thread: the engine loop's paged captures and a handler
# thread's dense ones (a sampled request) would otherwise collide.
_capture_lock = threading.Lock()


class GraphSet:
    """CUDA graphs keyed by shape bucket, captured into one private
    memory pool (a fresh one after a failed capture, which leaves its pool
    unable to take another). ``captures``, ``replays`` and ``capture_s``
    (wall seconds of the warm-up iterations and the captures) count its
    work since it was made, dropped graphs included."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._graphs = {}
        self._pools = []
        self.pool = None
        if self.device.type == "cuda":
            self._new_pool()
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def __contains__(self, key):
        return key in self._graphs

    def __len__(self):
        return len(self._graphs)

    def drop(self, key):
        """Forget graph ``key`` (if captured), before the buffers it
        reads are freed: its blocks in the pool go back to the pool's
        later captures."""
        self._graphs.pop(key, None)

    def capture(self, key, step, reset=None):
        """Run ``step()`` eagerly ``WARMUP_ITERS`` times on a side stream,
        then capture one call of it as graph ``key``. The warm-up
        iterations execute, so ``step`` must leave the state as it found
        it or rewrite what it wrote; ``reset()``, when given, runs before
        each of them (a step that bumps a row counter into an output of
        ``chunk`` rows would otherwise run past its end when ``chunk`` is
        below ``WARMUP_ITERS``). The warm-up iterations' int8 products
        are not counted in ``int8_mm_launches``. One capture runs at a
        time in the process; other threads go on launching work
        meanwhile (``thread_local``)."""
        t0 = time.perf_counter()
        with _capture_lock, torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side), int8_matmul.uncounted():
                for _ in range(WARMUP_ITERS):
                    if reset is not None:
                        reset()
                    step()
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self.pool,
                                      capture_error_mode="thread_local"):
                    step()
            except BaseException:
                self._abandon_capture(current)
                raise
        self._graphs[key] = graph
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def _new_pool(self):
        self.pool = torch.cuda.graph_pool_handle()
        self._pools.append(tuple(self.pool))

    def _abandon_capture(self, stream):
        """Undo what a failed capture leaves behind. When the capture was
        invalidated (a host sync inside it), ``torch.cuda.graph``'s exit
        raises in ``cudaStreamEndCapture`` before it restores the thread's
        stream and before the caching allocator stops routing the
        capture's allocations to the pool, and the pool refuses any later
        capture ("already recording to mempool_id", PyTorch 2.11, even
        once the routing is ended): restore the stream, end the routing,
        and capture into a fresh pool from now on."""
        torch.cuda.set_stream(stream)
        try:
            torch._C._cuda_endAllocateToPool(stream.device_index, self.pool)
        except RuntimeError:
            pass  # the capture ended cleanly (its step raised in Python)
        self._new_pool()

    def replay(self, key):
        self._graphs[key].replay()
        self.replays += 1

    def pool_bytes(self):
        """Bytes the caching allocator holds in this set's pools (their
        segments in ``torch.cuda.memory_snapshot()``); 0 off CUDA."""
        if not self._pools:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in self._pools)


def _stage(dst, array):
    """Copy a host array into the device buffer ``dst`` in place. On CUDA
    it goes through a pinned copy with ``non_blocking=True``: a pageable
    copy would wait for the stream to drain, and PyTorch's caching host
    allocator keeps the pinned block until the copy has run."""
    host = torch.from_numpy(np.asarray(array)).to(dst.dtype)
    if dst.device.type == "cuda":
        host = host.pin_memory()
    dst.copy_(host, non_blocking=True)


class PagedDecodeGraphs:
    """The paged decode chunk as replays of one captured step per window.

    ``model`` (a ``transformer.Transformer``) and ``pools`` ({"k", "v"}
    block pools) are the engine's; ``tokens`` is its device vector of
    last tokens (``last_dev``), which every step reads and advances in
    place: a final prefill segment writes a slot's first token into it,
    and the next chunk reads it there. The static buffers are allocated
    once and never reassigned, since captured graphs hold their
    addresses: ``tables`` (``tables_shape``: slots × blocks a context),
    ``positions``, ``active``, ``out`` (``chunk`` × slots tokens, one row
    a step) and ``counter`` (the next row of ``out``). The captured step
    computes one iteration of ``transformer.paged_decode_chunk``
    (``paged_decode_step``), writes the next tokens and positions back
    into their buffers, the tokens into ``out[counter]``, and bumps the
    counter.

    Calling it runs a chunk: it stages the host arrays into the buffers,
    zeroes the counter, and replays (on the CPU: runs) the window's step
    ``steps`` times. A window without a graph is captured first, with
    every row inactive, so the capture's warm-up iterations write only
    the null block and leave the tokens as they are."""

    def __init__(self, model, pools, tokens, tables_shape, chunk,
                 block_size):
        device = tokens.device
        slots = tables_shape[0]
        self.model = model
        self.pools = pools
        self.tokens = tokens
        self.block_size = block_size
        self.tables = torch.zeros(tables_shape, dtype=torch.long,
                                  device=device)
        self.positions = torch.zeros(slots, dtype=torch.long, device=device)
        self.active = torch.zeros(slots, dtype=torch.bool, device=device)
        self.out = torch.zeros(chunk, slots, dtype=torch.long, device=device)
        self.counter = torch.zeros(1, dtype=torch.long, device=device)
        self.graphs = GraphSet(device)
        # Steps launched by calls (replayed on CUDA, run on the CPU),
        # counted before each launch: the engine retries a failed chunk
        # only while this has not moved, since every step advances the
        # step state in place.
        self.launched = 0

    @property
    def on_cuda(self):
        return self.tokens.device.type == "cuda"

    def _step(self, window):
        _, nxt, pos = tf.paged_decode_step(
            self.model, self.pools, self.tables, self.tokens, self.positions,
            self.active, window, self.block_size,
        )
        self.tokens.copy_(nxt)
        self.positions.copy_(pos)
        self.out.index_copy_(0, self.counter, nxt[None])
        self.counter.add_(1)

    def _neutral(self):
        """Every row inactive, all pages the null block."""
        self.active.zero_()
        self.tables.zero_()
        self.positions.zero_()
        self.counter.zero_()

    @torch.inference_mode()
    def warm(self, window):
        """Make ``window``'s graph ready before traffic needs it: True if
        it was captured already, False if this call captured it. On the
        CPU one neutral step runs eagerly; returns None."""
        if not self.on_cuda:
            self._neutral()
            self._step(window)
            return None
        if window in self.graphs:
            return True
        self._neutral()
        self.graphs.capture(window, lambda: self._step(window),
                            reset=self.counter.zero_)
        return False

    @torch.inference_mode()
    def __call__(self, tables, positions, active, steps, window):
        """``steps`` greedy steps at ``window`` from the host arrays
        ``tables`` (slots × blocks), ``positions`` and ``active`` (slots)
        → the (steps, slots) tokens, a view of ``out`` valid until the
        next call (read it, or copy it behind the stream, first). The
        last tokens stay in ``tokens``, the last positions in
        ``positions``."""
        if not 1 <= steps <= self.out.shape[0]:
            raise ValueError(f"steps ({steps}) must be in [1, "
                             f"{self.out.shape[0]}]")
        if self.on_cuda and window not in self.graphs:
            self.warm(window)
        _stage(self.tables, tables)
        _stage(self.positions, positions)
        _stage(self.active, active)
        self.counter.zero_()
        for _ in range(steps):
            self.launched += 1
            if self.on_cuda:
                self.graphs.replay(window)
            else:
                self._step(window)
        return self.out[:steps]


class DenseChunkGraphs:
    """The dense decode chunk as replays of one captured step per
    (window, mask_writes).

    ``model`` and ``cache`` ({"k", "v"}: (L, slots, Hkv, S, hd)) are the
    engine's. The static buffers are allocated once and never reassigned,
    since captured graphs hold their addresses: ``tokens``,
    ``positions`` and ``active`` (slots), ``out`` (``chunk`` × slots
    tokens, one row a step) and ``counter`` (the next row of ``out``).
    The captured step computes one iteration of
    ``transformer.decode_chunk`` (``dense_decode_step``), writes the next
    tokens and positions back into their buffers, the tokens into
    ``out[counter]``, and bumps the counter.

    Calling it runs a chunk: it stages the host arrays into the buffers,
    zeroes the counter, and replays (on the CPU: runs) the step of
    (window, mask_writes) ``steps`` times. A step without a graph is
    captured first, with every row inactive at position 0. The dense
    cache has no null block, and the capture's warm-up iterations
    execute: a masked step writes each row's own values back, but an
    unmasked one writes K/V at position 0 of every slot, live or not. So
    every capture saves the cache's position-0 column (L × slots × Hkv ×
    hd per tensor, 0.5 MB for Llama-3-8B at 8 slots) and restores it
    after: a capture leaves every slot's cache as it found it, also when
    it comes mid-traffic (``--warmup=lazy``)."""

    def __init__(self, model, cache, slots, chunk):
        device = cache["k"].device
        self.model = model
        self.cache = cache
        self.tokens = torch.zeros(slots, dtype=torch.long, device=device)
        self.positions = torch.zeros(slots, dtype=torch.long, device=device)
        self.active = torch.zeros(slots, dtype=torch.bool, device=device)
        self.out = torch.zeros(chunk, slots, dtype=torch.long, device=device)
        self.counter = torch.zeros(1, dtype=torch.long, device=device)
        self.graphs = GraphSet(device)
        # Steps launched by calls (replayed on CUDA, run on the CPU),
        # counted before each launch: the engine retries a failed chunk
        # only while this has not moved, since every step advances the
        # step state in place.
        self.launched = 0

    @property
    def on_cuda(self):
        return self.tokens.device.type == "cuda"

    def _step(self, window, mask_writes):
        _, nxt, pos = tf.dense_decode_step(
            self.model, self.cache, self.tokens, self.positions, self.active,
            window, mask_writes,
        )
        self.tokens.copy_(nxt)
        self.positions.copy_(pos)
        self.out.index_copy_(0, self.counter, nxt[None])
        self.counter.add_(1)

    def _neutral_step(self, run):
        """Every row inactive at position 0, then ``run()``, with the
        cache's position-0 column restored after it."""
        for buf in (self.tokens, self.positions, self.active, self.counter):
            buf.zero_()
        saved = {n: c[:, :, :, :1].clone() for n, c in self.cache.items()}
        try:
            run()
        finally:
            for name, col in saved.items():
                self.cache[name][:, :, :, :1].copy_(col)

    @torch.inference_mode()
    def warm(self, window, mask_writes):
        """Make the graph of (``window``, ``mask_writes``) ready before
        traffic needs it: True if it was captured already, False if this
        call captured it. On the CPU one neutral step runs eagerly (the
        cache left as it was); returns None."""
        key = (window, bool(mask_writes))
        if not self.on_cuda:
            self._neutral_step(lambda: self._step(*key))
            return None
        if key in self.graphs:
            return True
        self._neutral_step(lambda: self.graphs.capture(
            key, lambda: self._step(*key), reset=self.counter.zero_))
        return False

    @torch.inference_mode()
    def __call__(self, tokens, positions, active, steps, window,
                 mask_writes=False):
        """``steps`` greedy steps at ``window`` from the host arrays
        ``tokens``, ``positions`` and ``active`` (slots) → the (steps,
        slots) tokens, a view of ``out`` valid until the next call. The
        last tokens stay in ``tokens``, the last positions in
        ``positions``; the cache is written in place."""
        if not 1 <= steps <= self.out.shape[0]:
            raise ValueError(f"steps ({steps}) must be in [1, "
                             f"{self.out.shape[0]}]")
        key = (window, bool(mask_writes))
        if self.on_cuda and key not in self.graphs:
            self.warm(*key)
        _stage(self.tokens, tokens)
        _stage(self.positions, positions)
        _stage(self.active, active)
        self.counter.zero_()
        for _ in range(steps):
            self.launched += 1
            if self.on_cuda:
                self.graphs.replay(key)
            else:
                self._step(*key)
        return self.out[:steps]


class PagedVerifyGraphs:
    """Speculation's batched verify as replays of one captured call per
    (batch, window).

    ``model`` and ``pools`` are the engine's (or a draft proposer's).
    Per batch bucket B, static buffers are allocated once, at its first
    use, and never reassigned (its graphs hold their addresses): ``segs``
    (B, ``width``), ``poss`` (B,), ``bids`` and ``offs`` (B, width),
    ``tables`` (B, ``table_blocks``) and the ``greedy`` output (B,
    width). A graph per (B, window) captures one
    ``transformer.paged_verify_batch`` over them and copies its tokens
    into ``greedy``. A (B, window) without a graph is captured first,
    with every row pointed at the null block (zero positions, null write
    targets and tables), so the capture's warm-up iterations write only
    the null block. On the CPU the same call runs eagerly over the same
    buffers."""

    def __init__(self, model, pools, width, table_blocks, block_size):
        self.model = model
        self.pools = pools
        self.width = width
        self.table_blocks = table_blocks
        self.block_size = block_size
        self.device = model.device
        self._buffers = {}
        self.graphs = GraphSet(self.device)

    @property
    def on_cuda(self):
        return self.device.type == "cuda"

    def buffers(self, batch):
        """The static buffers of batch bucket ``batch`` (made at first
        use): a dict of ``segs``, ``poss``, ``bids``, ``offs``, ``tables``
        and ``greedy``."""
        if batch not in self._buffers:
            def zeros(*shape):
                return torch.zeros(shape, dtype=torch.long,
                                   device=self.device)

            w = self.width
            self._buffers[batch] = {
                "segs": zeros(batch, w), "poss": zeros(batch),
                "bids": zeros(batch, w), "offs": zeros(batch, w),
                "tables": zeros(batch, self.table_blocks),
                "greedy": zeros(batch, w),
            }
        return self._buffers[batch]

    def _run(self, batch, window):
        buf = self.buffers(batch)
        greedy = tf.paged_verify_batch(
            self.model, self.pools, buf["segs"], buf["poss"], buf["bids"],
            buf["offs"], buf["tables"], window, self.block_size,
        )
        buf["greedy"].copy_(greedy)

    def _neutral(self, batch):
        """Every row at position 0 with null write targets and tables."""
        for buf in self.buffers(batch).values():
            buf.zero_()

    @torch.inference_mode()
    def warm(self, batch, window):
        """Make the graph of (``batch``, ``window``) ready: True if it was
        captured already, False if this call captured it. On the CPU one
        neutral call runs eagerly; returns None."""
        if not self.on_cuda:
            self._neutral(batch)
            self._run(batch, window)
            return None
        if (batch, window) in self.graphs:
            return True
        self._neutral(batch)
        self.graphs.capture((batch, window),
                            lambda: self._run(batch, window))
        return False

    @torch.inference_mode()
    def __call__(self, segs, poss, bids, offs, tables, window):
        """The verify of the host arrays ``segs``, ``bids`` and ``offs``
        (B × width), ``poss`` (B) and ``tables`` (B × table_blocks), B a
        batch bucket, at ``window`` → the (B, width) greedy tokens: the
        bucket's ``greedy`` buffer, valid until the next verify of the
        same B (read it, or copy it behind the stream, first). The pools
        are written in place."""
        batch = len(segs)
        if self.on_cuda and (batch, window) not in self.graphs:
            self.warm(batch, window)
        buf = self.buffers(batch)
        for name, array in (("segs", segs), ("poss", poss), ("bids", bids),
                            ("offs", offs), ("tables", tables)):
            _stage(buf[name], array)
        if self.on_cuda:
            self.graphs.replay((batch, window))
        else:
            self._run(batch, window)
        return buf["greedy"]


class DenseDecodeGraphs:
    """The dense decode step as replays of one captured step per (batch,
    window), for ``transformer.generate``.

    Keeps a dense cache per batch size (``cache(batch)``; 1.07 GB a row
    for Llama-3-8B at 8192), which the prefill writes into and the
    captured steps read and write in place, and per batch size the static
    inputs of a step: the tokens and the position (a device scalar). The
    caches kept hold at most ``max_rows`` rows between them: a batch size
    not kept evicts the least recently used ones (their caches, inputs
    and graphs) until it fits; a batch of more rows than that evicts
    every other and is itself evicted by the next other size. A graph
    captures ``decode_logits`` only; sampling runs eagerly on its output,
    so a sampled request keeps its ``torch.Generator``. One caller at a
    time (``serve_cli.Model`` holds its lock around ``generate``)."""

    def __init__(self, model, max_rows=MAX_CACHED_ROWS):
        if max_rows < 1:
            raise ValueError(f"max_rows ({max_rows}) must be >= 1")
        self.model = model
        self.max_rows = max_rows
        self.graphs = GraphSet(model.device)
        # batch -> (cache, tokens, position), least recently used first.
        self._batches = collections.OrderedDict()
        self._logits = {}
        self.evictions = 0

    @property
    def cached_batches(self):
        """The batch sizes whose caches are kept, least recently used
        first."""
        return tuple(self._batches)

    @property
    def cached_rows(self):
        return sum(self._batches)

    def cached_bytes(self):
        """Bytes of the dense caches kept now."""
        return sum(t.nbytes for cache, _, _ in self._batches.values()
                   for t in cache.values())

    def cache(self, batch):
        """The dense cache of ``batch`` rows (zeroed when first made)."""
        if batch in self._batches:
            self._batches.move_to_end(batch)
        else:
            while self._batches and self.cached_rows + batch > self.max_rows:
                self._evict(next(iter(self._batches)))
            device = self.model.device
            self._batches[batch] = (
                tf.init_kv_cache(self.model.cfg, batch, device),
                torch.zeros(batch, dtype=torch.long, device=device),
                torch.zeros(1, dtype=torch.long, device=device),
            )
        return self._batches[batch][0]

    def _evict(self, batch):
        # The graphs first: they hold the addresses of the buffers freed.
        for key in [k for k in self._logits if k[0] == batch]:
            self.graphs.drop(key)
            del self._logits[key]
        del self._batches[batch]
        self.evictions += 1

    @torch.inference_mode()
    def step(self, tokens, position):
        """One decode step of ``tokens`` (B,) at ``position`` (an int)
        over ``cache(B)`` → (B, V) f32 logits. On CUDA the graph's output
        buffer, valid until the next step at the same (B, window)."""
        batch = tokens.shape[0]
        cache = self.cache(batch)
        _, tok, pos = self._batches[batch]
        window = tf._window_for(position + 1, self.model.cfg.max_seq_len)
        tok.copy_(tokens)
        pos.fill_(position)
        if self.model.device.type != "cuda":
            return tf.decode_logits(self.model, cache, tok, pos, window)
        key = (batch, window)
        if key not in self.graphs:
            def run():
                # Writes this position's K/V, the same values each time.
                self._logits[key] = tf.decode_logits(self.model, cache, tok,
                                                     pos, window)

            self.graphs.capture(key, run)
        self.graphs.replay(key)
        return self._logits[key]
