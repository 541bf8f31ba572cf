# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Cross-replica KV block handoff: ship a cached prefix, don't recompute.

Copy of ``container_engine_accelerators_tpu/kvcache/handoff.py`` (the
port imports nothing of the JAX package): the wire format, the verify
and the failure taxonomy are JAX's line for line, so a stream one
package exports installs in the other. ``faults.tick`` is the port's
fault plan and ``PoolExhausted`` the port's block pool's. The engine
half (the device bytes) is ``ContinuousEngine.kv_export`` /
``kv_install`` in ``models/serve_cli.py``.

The disaggregated-serving transfer path (DistServe/Splitwise shape): a
prefill replica that has already paid for a prompt's KV blocks
serializes them — the ref-counted block list plus the radix snapshot
entry that makes them matchable — and a decode replica installs them
into its own :class:`~container_engine_accelerators_tpu_torch.kvcache
.blockpool.BlockPool` / :class:`~container_engine_accelerators_tpu_torch
.kvcache.manager.PagedKVManager`, so the next ``admit`` of that prompt
hits the radix tree and skips prefill entirely.

Wire format — the supervised-link framing (the JAX server's
``LockstepEngineLink``) applied to a one-shot stream: the prefix
travels as an ordered list of **delta-op frames**, each carrying a
contiguous ``op_seq`` and a CRC32 ``digest`` over its canonical
payload. A receiver replays them strictly in order:

  * ``HELLO``  — stream header: wire version, block size, block/token
    counts, source replica. A config mismatch (block size) refuses the
    stream before any allocation.
  * ``BLOCK``  — one full block: its index, its ``block_size`` token
    span, a ``kv_digest`` over that span, and — when the exporting
    endpoint supplies a ``block_bytes`` mover — a ``kv`` field
    carrying the block's actual device bytes (base64 K/V slabs). The
    manager-level hermetic transports move page-table + radix state
    only; the ENGINE endpoints attach the device bytes, because an
    installed prefix whose cache pages were never written would decode
    garbage. The per-frame digest covers the bytes for free.
  * ``COMMIT`` — trailer: block count + a digest chained over every
    BLOCK digest. A stream without its COMMIT is torn, never partially
    installed.

Failure taxonomy mirrors the link's wedge/desync semantics:
:class:`HandoffDesync` for sequence gaps / digest mismatches (the
stream is corrupt — discard it, the blocks were never installed),
:class:`HandoffTimeout` for a transfer exceeding its budget (the wedge
analogue), :class:`HandoffUnsupported` for a dense/linkless endpoint.
Every failure path leaves the receiving manager untouched: install is
verify-everything-then-allocate, so the caller's fallback is always a
plain re-prefill.

Fault injection: :func:`perturb_frames` ticks the ``serving.handoff``
site of the armed fault plan (``corrupt_payload`` flips a BLOCK
digest, ``drop`` removes a mid-stream frame, ``delay`` stalls past the
transfer budget) — the chaos drills prove the fallback matrix without
a real flaky network.
"""

import copy
import json
import time
import zlib

HANDOFF_FAULT_SITE = "serving.handoff"

WIRE_VERSION = 1

OP_HELLO = "HELLO"
OP_BLOCK = "BLOCK"
OP_COMMIT = "COMMIT"


class HandoffError(RuntimeError):
    """Base class: a KV handoff failed; the request falls back to
    re-prefill (never lost)."""


class HandoffDesync(HandoffError):
    """The stream is unreplayable: an op_seq gap, a digest mismatch,
    or a torn/missing COMMIT. Nothing was installed."""


class HandoffTimeout(HandoffError):
    """The transfer exceeded its budget (the link-wedge analogue)."""


class HandoffUnsupported(HandoffError):
    """The endpoint cannot take part (dense engine, no paged manager,
    or nothing cached to export)."""


def _digest(op_seq, op, payload):
    """CRC32 over the frame's canonical JSON — the same cheap integrity
    check the supervised link stamps on every broadcast."""
    blob = json.dumps(
        [int(op_seq), op, payload], sort_keys=True, separators=(",", ":")
    ).encode()
    return zlib.crc32(blob) & 0xFFFFFFFF


def _frame(op_seq, op, payload):
    return {
        "op_seq": int(op_seq),
        "op": op,
        "payload": payload,
        "digest": _digest(op_seq, op, payload),
    }


def export_prefix(manager, tokens, src="", block_bytes=None,
                  traceparent=None):
    """Serialize the longest cached prefix of ``tokens`` from
    ``manager`` into a framed delta-op stream.

    ``block_bytes`` (optional) maps a block id to a JSON-serializable
    device-bytes payload; when provided, each BLOCK frame carries it
    as ``kv`` (the engine endpoints pass their cache slab reader —
    without it the stream moves page-table/radix state only, which is
    enough for the hermetic fakes but NOT for a real model).

    Read-only apart from the radix LRU tick — call from the manager's
    single-writer thread (the engine loop marshals this via
    ``ContinuousEngine.kv_export``). Raises
    :class:`HandoffUnsupported` when nothing is cached (there is no
    prefix to ship — the caller re-prefills)."""
    tokens = [int(t) for t in tokens]
    matched = manager.radix.match(tokens)
    if not matched:
        raise HandoffUnsupported(
            "no cached prefix to export for this prompt"
        )
    bs = manager.block_size
    n_tokens = len(matched) * bs
    hello = {
        "version": WIRE_VERSION,
        "block_size": bs,
        "n_blocks": len(matched),
        "n_tokens": n_tokens,
        "src": src,
    }
    if traceparent is not None:
        # Distributed-trace context rides the stream header (covered
        # by the HELLO digest like every other field), so the install
        # side can stitch the transfer into the request's journey.
        hello["traceparent"] = str(traceparent)
    frames = [_frame(0, OP_HELLO, hello)]
    chain = 0
    for i, bid in enumerate(matched):
        span = tokens[i * bs:(i + 1) * bs]
        # Stand-in for the block's device bytes: a digest of the token
        # span that wrote it (deterministic, so a corrupted frame is
        # detectable end-to-end even without a device-bytes mover).
        kv_digest = zlib.crc32(
            json.dumps(span, separators=(",", ":")).encode()
        ) & 0xFFFFFFFF
        payload = {
            "index": i,
            "block": int(bid),
            "tokens": span,
            "kv_digest": kv_digest,
        }
        if block_bytes is not None:
            kv = block_bytes(int(bid))
            if kv is not None:
                payload["kv"] = kv
        frames.append(_frame(1 + i, OP_BLOCK, payload))
        chain = zlib.crc32(
            frames[-1]["digest"].to_bytes(4, "big"),
            chain,
        ) & 0xFFFFFFFF
    frames.append(_frame(1 + len(matched), OP_COMMIT, {
        "n_blocks": len(matched),
        "chain_digest": chain,
    }))
    return frames


def frames_nbytes(frames):
    """The stream's on-the-wire size (canonical JSON encoding) — what
    ``tpu_serving_handoff_bytes_total`` counts."""
    return sum(
        len(json.dumps(f, sort_keys=True, separators=(",", ":")))
        for f in frames
    )


def verify_frames(frames, block_size=None):
    """Replay-validate a framed stream: contiguous op_seq from 0, a
    HELLO head, a COMMIT trailer whose chained digest matches, and a
    per-frame digest check. Returns ``(tokens, n_blocks)``. Raises
    :class:`HandoffDesync` on any violation — the wedge/desync contract
    inherited from the supervised link."""
    tokens, blocks = _verify(frames, block_size)
    return tokens, len(blocks)


def _verify(frames, block_size=None):
    """:func:`verify_frames` plus the raw BLOCK payloads (install
    needs their ``kv`` device bytes)."""
    if not frames:
        raise HandoffDesync("empty handoff stream")
    hello = None
    chain = 0
    blocks = []
    commit = None
    for want_seq, f in enumerate(frames):
        try:
            op_seq = int(f["op_seq"])
            op = f["op"]
            payload = f["payload"]
            digest = int(f["digest"])
        except (KeyError, TypeError, ValueError) as e:
            raise HandoffDesync(f"malformed frame: {e}") from e
        if op_seq != want_seq:
            raise HandoffDesync(
                f"op_seq gap: got {op_seq}, expected {want_seq} "
                f"(a frame was dropped or reordered)"
            )
        if digest != _digest(op_seq, op, payload):
            raise HandoffDesync(
                f"digest mismatch on op_seq {op_seq} ({op}): the "
                f"frame was corrupted in flight"
            )
        if op == OP_HELLO:
            if want_seq != 0:
                raise HandoffDesync("HELLO not at stream head")
            hello = payload
        elif op == OP_BLOCK:
            blocks.append(payload)
            chain = zlib.crc32(
                digest.to_bytes(4, "big"), chain,
            ) & 0xFFFFFFFF
        elif op == OP_COMMIT:
            commit = payload
        else:
            raise HandoffDesync(f"unknown op {op!r}")
    if hello is None:
        raise HandoffDesync("stream has no HELLO header")
    if hello.get("version") != WIRE_VERSION:
        raise HandoffDesync(
            f"wire version {hello.get('version')} != {WIRE_VERSION}"
        )
    if commit is None:
        raise HandoffDesync(
            "stream has no COMMIT trailer (torn transfer)"
        )
    if commit.get("n_blocks") != len(blocks) \
            or hello.get("n_blocks") != len(blocks):
        raise HandoffDesync(
            f"block count mismatch: HELLO {hello.get('n_blocks')}, "
            f"COMMIT {commit.get('n_blocks')}, stream {len(blocks)}"
        )
    if commit.get("chain_digest") != chain:
        raise HandoffDesync("COMMIT chain digest mismatch")
    if block_size is not None and hello.get("block_size") != block_size:
        raise HandoffDesync(
            f"block_size mismatch: stream {hello.get('block_size')}, "
            f"receiver {block_size} (config mismatch — refuse before "
            f"allocating)"
        )
    tokens = []
    for i, b in enumerate(blocks):
        if b.get("index") != i:
            raise HandoffDesync(
                f"BLOCK index {b.get('index')} out of order at {i}"
            )
        span = b.get("tokens") or []
        if len(span) != hello["block_size"]:
            raise HandoffDesync(
                f"BLOCK {i} carries {len(span)} tokens, expected "
                f"{hello['block_size']}"
            )
        want = zlib.crc32(
            json.dumps([int(t) for t in span],
                       separators=(",", ":")).encode()
        ) & 0xFFFFFFFF
        if b.get("kv_digest") != want:
            raise HandoffDesync(
                f"BLOCK {i} kv_digest mismatch (device bytes would "
                f"not match the page-table state)"
            )
        tokens.extend(int(t) for t in span)
    return tokens, blocks


def install_prefix(manager, frames, write_block=None):
    """Verify a framed stream, then install its prefix into
    ``manager``: allocate fresh blocks, hand them to the radix tree
    (which takes its own refs), and drop the transfer's temporary refs
    — exactly the ref choreography of a local retire
    (:meth:`PagedKVManager.finish_release`). Spans the receiver already
    caches are deduplicated by the radix insert (the duplicate blocks
    free straight back to the pool).

    ``write_block`` (optional) receives ``(block_id, kv_payload)`` for
    every freshly allocated block BEFORE the radix adopts it — the
    engine endpoints use it to land the stream's ``kv`` device bytes
    in their cache pages (``kv_payload`` is None for byte-less
    streams). A failing write rolls the allocation back.

    Verify-everything-THEN-allocate: a stream that fails any check
    leaves the manager byte-identical to before the call. Call from
    the manager's single-writer thread. Returns a summary dict."""
    from container_engine_accelerators_tpu_torch.kvcache.blockpool import (
        PoolExhausted,
    )

    tokens, blocks = _verify(frames, block_size=manager.block_size)
    hello = frames[0]["payload"]
    n_blocks = len(blocks)
    try:
        fresh = manager._alloc(n_blocks)
    except PoolExhausted as e:
        raise HandoffError(
            f"receiver pool exhausted installing {n_blocks} blocks: {e}"
        ) from e
    if write_block is not None:
        try:
            for b, bid in zip(blocks, fresh):
                write_block(int(bid), b.get("kv"))
        except Exception:
            manager.drop(fresh)
            raise
    adopted = manager.radix.insert(tokens, fresh, manager.pool)
    manager.drop(fresh)
    return {
        "installed_blocks": adopted,
        "duplicate_blocks": n_blocks - adopted,
        "n_tokens": len(tokens),
        "nbytes": frames_nbytes(frames),
        # Surfaced (not enforced) so the receiving engine can adopt
        # the sender's trace context for its install-side span.
        "traceparent": hello.get("traceparent", ""),
    }


def perturb_frames(frames, timeout_s=None):
    """Tick the ``serving.handoff`` fault site and apply any scripted
    fault to the in-flight stream: ``corrupt_payload`` flips one BLOCK
    frame's digest, ``drop`` removes a mid-stream frame (an op_seq
    gap), ``delay`` sleeps ``delay_s`` — and raises
    :class:`HandoffTimeout` when that blows the ``timeout_s`` budget.
    Returns the (possibly perturbed) frames; the receiver's verify
    turns a corruption into :class:`HandoffDesync`."""
    from container_engine_accelerators_tpu_torch import faults

    out = frames
    for spec in faults.tick(HANDOFF_FAULT_SITE):
        if spec.kind == "corrupt_payload":
            out = copy.deepcopy(out)
            victim = out[len(out) // 2]
            victim["digest"] = (int(victim["digest"]) + 1) & 0xFFFFFFFF
        elif spec.kind == "drop":
            out = list(out)
            del out[len(out) // 2]
        elif spec.kind in ("delay", "collective_timeout"):
            delay = getattr(spec, "delay_s", 0.0) or 0.0
            if timeout_s is not None and delay > timeout_s:
                raise HandoffTimeout(
                    f"handoff stalled {delay:.3f}s, budget "
                    f"{timeout_s:.3f}s"
                )
            time.sleep(min(delay, 0.05))
    return out


class LoopbackHandoffTransport:
    """In-process handoff wire for hermetic tests: moves a framed
    stream from an export callable to an install callable through the
    same perturbation point a real transport would traverse. Mirrors
    ``fleet/linksim.LoopbackTransport``'s role for the supervised link
    — the transport is swappable, the framing/verify semantics are
    the product code under test."""

    def __init__(self, timeout_s=2.0):
        self.timeout_s = timeout_s
        self.sent_streams = 0
        self.sent_bytes = 0

    def send(self, frames, install, timeout_s=None):
        """Deliver ``frames`` to ``install`` (e.g. a peer engine's
        ``kv_install``) through the fault site. Raises the handoff
        failure taxonomy; on success returns the install summary."""
        budget = self.timeout_s if timeout_s is None else timeout_s
        t0 = time.perf_counter()
        frames = perturb_frames(frames, timeout_s=budget)
        if time.perf_counter() - t0 > budget:
            raise HandoffTimeout(
                f"handoff exceeded its {budget:.3f}s budget"
            )
        out = install(frames)
        self.sent_streams += 1
        self.sent_bytes += frames_nbytes(frames)
        return out


__all__ = [
    "HANDOFF_FAULT_SITE",
    "HandoffError",
    "HandoffDesync",
    "HandoffTimeout",
    "HandoffUnsupported",
    "LoopbackHandoffTransport",
    "export_prefix",
    "frames_nbytes",
    "install_prefix",
    "perturb_frames",
    "verify_frames",
]
