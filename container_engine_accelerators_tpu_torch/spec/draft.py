# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Draft-model proposer: a small transformer guessing for a big one.

Port of ``container_engine_accelerators_tpu/spec/draft.py``. A draft
model a few times smaller than the target (same vocabulary and heads, so
token ids and rope positions line up) greedily decodes k tokens ahead,
and the target verifies all k in one call. The draft runs its OWN paged
slots (its own ``PagedKVManager`` and pools) through the same device
programs as the engine: ``paged_prefill_segment`` for bulk context
ingestion, the verify (``serving_graphs.PagedVerifyGraphs`` at one row,
greedy outputs ignored) as the forced-token ingest of each round's
catch-up, and the decode step (its own ``PagedDecodeGraphs``) for the k
sequential draft steps. On the card the ingest and the draft steps are
CUDA-graph replays, as the engine's verify and decode are; the bulk
prefill runs eagerly, as the engine's does.

Cache discipline mirrors the target's garbage contract: the draft writes
K/V speculatively for its own proposals; whatever verification rejects is
overwritten by the next round's catch-up ingest before anything attends
it, and the accepted prefix is skipped (the draft is deterministic, so
re-feeding the same confirmed context would write the same values).

Draft quality only moves the acceptance rate; output tokens are pinned by
the target's verify regardless.
"""

import dataclasses
import functools

import numpy as np
import torch

from container_engine_accelerators_tpu_torch.kvcache.manager import (
    PagedKVManager,
)
from container_engine_accelerators_tpu_torch.models import serving_graphs
from container_engine_accelerators_tpu_torch.models import transformer as tf
from container_engine_accelerators_tpu_torch.ops import paged_attention as pa
from container_engine_accelerators_tpu_torch.spec.proposer import Proposer


def draft_config(cfg, shrink=4):
    """A draft ``TransformerConfig`` derived from the target: same vocab,
    heads and context (token ids and rope positions line up), width and
    depth shrunk ``shrink``x on the head dim so every divisibility
    constraint the target satisfied still holds."""
    hd = max(cfg.head_dim // shrink, 4)
    d = cfg.n_heads * hd
    return dataclasses.replace(
        cfg, d_model=d, d_ff=d * 3,
        n_layers=max(cfg.n_layers // shrink, 1),
    )


class DraftProposer(Proposer):
    """The draft proposer over ``draft_cfg`` for ``max_slots`` engine
    slots. ``params`` is a ``transformer.Transformer`` of ``draft_cfg``
    (the tests bridge JAX's with ``weights.params_from_jax``); without
    it the weights are random from ``init_params(seed=seed)`` on
    ``device``. ``width`` is the engine's verify width, the ingest's."""

    source = "draft"

    def __init__(self, draft_cfg, max_slots, block_size=16,
                 prefill_chunk=512, width=16, seed=1, params=None,
                 device="cuda"):
        self.cfg = draft_cfg
        self.max_slots = max_slots
        self.width = width
        # The draft never caches prefixes (no finish_release), so its
        # pool floor + the default spare headroom can never exhaust.
        self.kv = PagedKVManager(
            draft_cfg.max_seq_len, max_slots, block_size=block_size
        )
        # Bulk-ingest segment size: a dividing power of two (the same
        # constraint the engine's normalize_chunks enforces).
        S = draft_cfg.max_seq_len
        c = prefill_chunk
        if c & (c - 1):
            c = 1 << (c.bit_length() - 1)
        while c > 16 and S % c:
            c //= 2
        self.prefill_chunk = min(c, S)
        self.params = (params if params is not None
                       else tf.init_params(draft_cfg, device=device,
                                           seed=seed))
        self.device = self.params.device
        self.pools = pa.init_paged_kv_cache(
            draft_cfg.n_layers, self.kv.num_blocks, draft_cfg.n_kv_heads,
            block_size, draft_cfg.head_dim, draft_cfg.torch_dtype,
            self.device,
        )
        self._prefill = functools.partial(
            tf.paged_prefill_segment, block_size=block_size
        )
        self._ingest = serving_graphs.PagedVerifyGraphs(
            self.params, self.pools, width, self.kv.blocks_per_seq,
            block_size,
        )
        # The propose chunk's device tokens: row ``slot`` holds the fed
        # token, every other row is inactive.
        self._tokens = torch.zeros(max_slots, dtype=torch.long,
                                   device=self.device)
        self._chunk = serving_graphs.PagedDecodeGraphs(
            self.params, self.pools, self._tokens, self.kv.tables.shape,
            self.k_grid_max(), block_size,
        )
        # A final segment's first-token target the bulk prefill never
        # writes (want_logits=False).
        self._scratch_tok = torch.zeros(max_slots, dtype=torch.long,
                                        device=self.device)
        # slot -> {"tokens": confirmed context, "pos": written-K/V
        # count, "tail": speculative tokens written past pos by the
        # last propose (skipped on catch-up when confirmed)}.
        self._state = {}

    # -- lifecycle ------------------------------------------------------------

    def admit(self, slot, ctx):
        self.release(slot)
        self._state[slot] = {"tokens": list(ctx), "pos": 0, "tail": []}

    def observe(self, slot, tokens):
        st = self._state.get(slot)
        if st is not None:
            st["tokens"].extend(int(t) for t in tokens)

    def release(self, slot):
        if self._state.pop(slot, None) is not None:
            self.kv.drop(self.kv.release(slot))

    # -- device plumbing ------------------------------------------------------

    def _to_device(self, array):
        host = torch.from_numpy(np.asarray(array, np.int64))
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def _catch_up(self, slot, st):
        """Write draft K/V for every confirmed token except the last
        (the last is fed by the propose chunk itself)."""
        S = self.cfg.max_seq_len
        toks = st["tokens"]
        target = min(len(toks) - 1, S)
        # Skip the prefix the last propose wrote speculatively and
        # verification then confirmed: the same values by determinism.
        tail = st["tail"]
        i = 0
        while (
            i < len(tail) and st["pos"] < target
            and toks[st["pos"]] == tail[i]
        ):
            st["pos"] += 1
            i += 1
        st["tail"] = []
        bs = self.kv.block_size
        # Bulk path (admit / long confirmed gaps): block-aligned prefill
        # segments, padding overwritten before it is attended.
        while st["pos"] % bs == 0 and target - st["pos"] >= bs:
            off = st["pos"]
            rem = target - off
            cap = min(self.prefill_chunk, S)
            C = tf._length_bucket(rem, cap) if rem <= cap else cap
            window = tf._window_for(min(off + C, S), S)
            self.kv.ensure_blocks(slot, min(off + C, S))
            seg = np.zeros((1, C), np.int64)
            real = min(C, rem)
            seg[0, :real] = toks[off:off + real]
            seg_ids = self.kv.segment_ids(slot, off, C)
            self._prefill(
                self.params, self.pools, self._to_device(seg), off,
                self._to_device(seg_ids),
                self._to_device(self.kv.tables[slot]), 0,
                self._scratch_tok, 0, window=window, want_logits=False,
            )
            st["pos"] = off + real
        # Per-round remainder (arbitrary offset, <= width tokens per
        # slice): the forced-token ingest, greedy outputs ignored.
        W = self.width
        while st["pos"] < target:
            off = st["pos"]
            n = min(W, target - off)
            self.kv.ensure_blocks(slot, min(off + W, S))
            bids, offs = self.kv.position_targets(slot, off, W)
            # Padding past the real slice must not scribble on mapped
            # blocks it does not own yet: null-redirect it.
            bids[n:] = pa.NULL_BLOCK
            seg = np.zeros((1, W), np.int64)
            seg[0, :n] = toks[off:off + n]
            window = tf._window_for(min(off + W, S), S)
            self._ingest(seg, [off], bids[None], offs[None],
                         self.kv.tables[slot][None], window)
            st["pos"] = off + n

    def propose(self, slot, k):
        st = self._state.get(slot)
        if st is None or k < 1:
            return []
        S = self.cfg.max_seq_len
        pos_t = len(st["tokens"]) - 1  # the feed position of t0
        room = S - 1 - pos_t
        if room < 1:
            return []
        k = min(k, room)
        steps = k if k & (k - 1) == 0 else 1 << k.bit_length()
        if steps > room:
            steps = 1 << (room.bit_length() - 1)
            k = min(k, steps)
        self._catch_up(slot, st)
        self.kv.ensure_blocks(slot, min(pos_t + steps + 1, S))
        window = tf._window_for(min(pos_t + steps + 1, S), S)
        self._tokens[slot] = st["tokens"][-1]
        positions = np.zeros(self.max_slots, np.int64)
        positions[slot] = pos_t
        active = np.zeros(self.max_slots, bool)
        active[slot] = True
        toks = self._chunk(self.kv.tables, positions, active, steps=steps,
                           window=window)
        out = toks[:, slot].tolist()  # host sync: the proposals are needed
        props = [int(t) for t in out[:k]]
        # The chunk wrote t0's K/V (confirmed) plus the proposals'
        # (speculative: all but the last step's output were fed).
        st["pos"] = pos_t + 1
        st["tail"] = props[: max(steps - 1, 0)]
        return props

    # -- warmup ---------------------------------------------------------------

    def warm_tasks(self):
        """The draft's own grid (``warmstart/warmup.py`` group "draft"):
        bulk-prefill (segment, window) pairs run eagerly, the ingest's
        verify graph per window, and the propose chunk's decode graph per
        window (one step per window, replayed ``steps`` times, as the
        engine's decode): everything :meth:`propose` and
        :meth:`_catch_up` can dispatch. Every task writes only the null
        block of the draft's pools."""
        from container_engine_accelerators_tpu_torch.warmstart.warmup import (
            WarmTask,
        )

        cfg = self.cfg
        bs = self.kv.block_size
        buckets = tf.serving_shape_buckets(
            cfg, self.prefill_chunk, self.k_grid_max(), block_size=bs,
            speculate_widths=[self.width],
        )

        def null_ids(n):
            return torch.full((n,), pa.NULL_BLOCK, dtype=torch.long,
                              device=self.device)

        table_row = null_ids(self.kv.blocks_per_seq)
        tasks = []
        for C, window in buckets["paged_prefill"]:
            seg = torch.zeros((1, C), dtype=torch.long, device=self.device)
            tasks.append(WarmTask(
                f"draft_prefill/c{C}/w{window}", self._prefill,
                (self.params, self.pools, seg, 0, null_ids(C // bs),
                 table_row, C - 1, self._scratch_tok, 0),
                {"window": window, "want_logits": False}, "draft",
            ))
        for C, window in buckets["verify"]:
            tasks.append(WarmTask(
                f"draft_ingest/c{C}/w{window}", self._ingest.warm,
                (1, window), {}, "draft",
            ))
        for window in buckets["windows"]:
            tasks.append(WarmTask(
                f"draft_chunk/w{window}", self._chunk.warm, (window,), {},
                "draft",
            ))
        return tasks

    def k_grid_max(self):
        """Largest propose-chunk step count :meth:`propose` can use: the
        width bucket minus the fed token, rounded up to the power-of-two
        step grid."""
        k = self.width - 1
        return k if k & (k - 1) == 0 else 1 << k.bit_length()
