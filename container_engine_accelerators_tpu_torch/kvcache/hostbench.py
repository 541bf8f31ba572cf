# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Host-loop microbench: the engine's host overhead per retired token.

Port of ``container_engine_accelerators_tpu/kvcache/hostbench.py``. A
REAL port ``ContinuousEngine`` (paged or dense) whose device seams are
replaced by vectorized numpy fakes that cost microseconds, driven by a
seeded request storm with shared prefixes. With the device effectively
free, wall-clock per retired token IS the host loop: admission, radix
matching, page allocation, scheduling, dispatch bookkeeping and
retirement. The engine runs on the CPU by the bench's own choice: it
measures the host, never a card.

The fakes follow the port's seam contracts (``serve_cli.ContinuousEngine``):
dense ``_prefill``, ``_prefill_seg`` and ``_chunk`` (the chunk graphs'
call: host arrays in, the (steps, slots) tokens out); paged
``_paged_prefill`` (a final segment writes its first token into the
slot of ``last_dev``), ``_paged_chunk`` (reads and advances ``last_dev``
in place), ``_copy_blocks`` and ``_paged_verify`` (the batched verify's
(B, width) greedy tokens). Each fake emits the token after the last one
plus 1 (mod the vocabulary), so every output is known in advance
(:func:`expected`) and checked byte for byte.

``--budget-us`` fails the run (rc 1) over a host overhead per token, and
``tests/test_torch_hostbench.py`` runs the same check, so a host-loop
regression (a sync on the hot path, a per-token allocation) fails fast.
JAX's ``--fingerprint-out`` is not ported (``obs/baseline.py`` is not).

CLI::

    python -m container_engine_accelerators_tpu_torch.kvcache.hostbench \\
        --requests 64 --max-new 32 --budget-us 1500 --json out.json
"""

import argparse
import json
import logging
import sys
import threading
import time
import types

import numpy as np
import torch

log = logging.getLogger(__name__)

SIM_VOCAB = 32


def _fake_engine(kv_cache, max_slots, chunk, seq_len, speculate="off"):
    """A port ContinuousEngine on the CPU with near-zero-cost vectorized
    fake device calls — the measured residue is the host loop itself."""
    from container_engine_accelerators_tpu_torch.models import serve_cli
    from container_engine_accelerators_tpu_torch.models import (
        transformer as tf,
    )

    cfg = tf.TransformerConfig(
        vocab_size=SIM_VOCAB, d_model=16, n_layers=1, n_heads=2,
        n_kv_heads=1, d_ff=32, max_seq_len=seq_len, dtype="float32",
    )
    device = torch.device("cpu")

    class _Stub:
        """What the engine reads of a ``serve_cli.Model``: no weights,
        the graphs keep ``model`` and never call it (the seams are
        fakes)."""

        def __init__(self):
            self.cfg = cfg
            self.device = device
            self.model = types.SimpleNamespace(device=device)

    eng = serve_cli.ContinuousEngine(
        _Stub(), max_slots=max_slots, chunk=chunk,
        prefill_chunk=seq_len, start_loop=False, kv_cache=kv_cache,
        **(dict(kv_block_size=4, speculate=speculate)
           if kv_cache == "paged" else {}),
    )
    V = cfg.vocab_size

    def tokens_after(last, active, steps):
        incr = np.arange(1, steps + 1)[:, None]
        toks = np.where(active[None, :], (last[None, :] + incr) % V, 0)
        return torch.from_numpy(toks), np.where(active, (last + steps) % V,
                                                last)

    def fake_prefill(model, cache, padded, plen, slot):
        return torch.tensor((int(padded[0, int(plen) - 1]) + 1) % V)

    def fake_prefill_seg(model, cache, seg, offset, slot, true_pos,
                         window, want_logits):
        if not want_logits:
            return torch.zeros(())
        return torch.tensor((int(seg[0, int(true_pos) - int(offset)]) + 1)
                            % V)

    def fake_chunk(last_tok, positions, active, steps, window,
                   mask_writes):
        toks, _ = tokens_after(np.asarray(last_tok), np.asarray(active),
                               steps)
        return toks

    def fake_paged_prefill(model, cache, seg, offset, seg_ids, table_row,
                           true_pos, last_dev, slot, window, want_logits):
        if not want_logits:
            return None
        tok = (int(seg[0, int(true_pos) - int(offset)]) + 1) % V
        last_dev[int(slot)] = tok
        return torch.tensor(tok)

    def fake_paged_chunk(tables, positions, active, steps, window):
        toks, last = tokens_after(eng.last_dev.numpy(), np.asarray(active),
                                  steps)
        eng.last_dev.copy_(torch.from_numpy(last))
        return toks

    def fake_paged_verify(segs, poss, bids, offs, tables, window):
        # (B, W): the batched verify contract.
        return torch.from_numpy((np.asarray(segs) + 1) % V)

    if kv_cache == "paged":
        eng._paged_prefill = fake_paged_prefill
        eng._paged_chunk = fake_paged_chunk
        eng._copy_blocks = lambda cache, src, dst: cache
        if speculate != "off":
            eng._paged_verify = fake_paged_verify
        loop = eng._loop_paged
    else:
        eng._prefill = fake_prefill
        eng._prefill_seg = fake_prefill_seg
        eng._chunk = fake_chunk
        loop = eng._loop
    # As the engine's own loop thread, so shutdown() stops it.
    eng._thread = threading.Thread(target=loop, daemon=True)
    eng._thread.start()
    return eng


def expected(prompt, max_new, vocab=SIM_VOCAB):
    out = list(prompt)
    for _ in range(max_new):
        out.append((out[-1] + 1) % vocab)
    return out


def run_hostbench(requests=64, max_new=32, max_slots=8, chunk=8,
                  seq_len=256, shared_prefix=16, shared_frac=0.5,
                  kv_cache="paged", seed=0, workers=8,
                  speculate="off"):
    """Drive the storm, verify every output byte-exact, and return the
    result dict (``host_us_per_token`` is the pinned number; with
    ``speculate`` also ``device_steps_per_token`` — the sequential
    device steps the loop dispatched per retired token, the metric
    speculation exists to shrink)."""
    if speculate != "off" and kv_cache != "paged":
        raise ValueError(
            "--speculate requires --kv-cache=paged (the verify step "
            "is a paged program)"
        )
    rng = np.random.RandomState(seed)
    prefix = (rng.randint(0, SIM_VOCAB, shared_prefix)).tolist()
    cases = []
    for i in range(requests):
        if speculate != "off":
            # Repetitive-suffix drill traffic: the prompt ends mid-way
            # through a repeat of an earlier ascending run, so the
            # n-gram proposer's continuation matches the fake +1 decode
            # rule — the traffic shape speculation is built for.
            start = rng.randint(SIM_VOCAB)
            run = [(start + j) % SIM_VOCAB
                   for j in range(min(2 * max_new + 8, seq_len // 2))]
            cases.append(run + run[:2 + i % 4])
        elif i < requests * shared_frac:
            tail = rng.randint(0, SIM_VOCAB, 1 + i % 4).tolist()
            cases.append(prefix + tail)
        else:
            cases.append(
                rng.randint(0, SIM_VOCAB, 4 + i % 9).tolist()
            )
    eng = _fake_engine(kv_cache, max_slots, chunk, seq_len,
                       speculate=speculate)
    try:
        return _storm(eng, cases, requests, max_new, workers, kv_cache,
                      speculate, seed)
    finally:
        eng.shutdown()


def _storm(eng, cases, requests, max_new, workers, kv_cache, speculate,
           seed):
    # A warm lap outside the timed window (thread starts, first-touch
    # allocations), then the timed lap on the same engine: its radix
    # cache is warm, so the hit ratio reflects steady-state serving.
    outcomes = [None] * requests

    def worker(ids):
        for i in ids:
            outcomes[i] = eng.generate([cases[i]], max_new)[0]

    def lap():
        threads = [
            threading.Thread(
                target=worker, args=(range(w, requests, workers),),
                daemon=True,
            )
            for w in range(workers)
        ]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a hostbench worker did not finish in 120 s")
        return time.perf_counter() - t0

    lap()
    base = eng.stats()
    base_verifies = (
        int(eng._m_spec_verifies.value) if speculate != "off" else 0
    )
    wall = lap()
    cur = eng.stats()
    for i, out in enumerate(outcomes):
        if out != expected(cases[i], max_new):
            raise AssertionError(
                f"corrupted output for case {i} (seed={seed})"
            )
    tokens = requests * max_new
    kvs = eng.kv_stats() or {}
    result = {
        "kv_cache": kv_cache,
        "requests": requests,
        "tokens": tokens,
        "wall_s": round(wall, 6),
        "host_us_per_token": round(wall / tokens * 1e6, 3),
        "device_calls": (
            cur["n_prefills"] - base["n_prefills"]
            + cur["n_chunks"] - base["n_chunks"]
        ),
        "prefix_hit_ratio": kvs.get("prefix_hit_ratio", 0.0),
        "free_blocks": kvs.get("free_blocks"),
        "seed": seed,
    }
    if speculate != "off":
        # The decode-step clock counts every sequential model forward:
        # one per fused-chunk step, one per verify call however many
        # tokens it emitted, so this ratio IS sequential device steps per
        # generated token (1.0 = the non-speculative baseline; decode
        # tokens only, the prefill token arrives without a decode step).
        steps = cur["steps_done"] - base["steps_done"]
        decode_tokens = requests * (max_new - 1)
        result.update(
            speculate=speculate,
            verify_steps=(
                int(eng._m_spec_verifies.value) - base_verifies
            ),
            acceptance_ratio=round(eng._spec_acceptance(), 6),
            device_steps_per_token=round(
                steps / max(decode_tokens, 1), 6
            ),
        )
    return result


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--requests", type=int, default=64,
                   help="storm size (client requests)")
    p.add_argument("--max-new", type=int, default=32,
                   help="tokens decoded per request")
    p.add_argument("--max-slots", type=int, default=8,
                   help="engine KV slots")
    p.add_argument("--kv-cache", choices=["dense", "paged"],
                   default="paged",
                   help="engine mode under test")
    p.add_argument("--seed", type=int, default=0,
                   help="workload seed (deterministic storm)")
    p.add_argument("--speculate", choices=["off", "ngram"],
                   default="off",
                   help="run the engine with speculative decoding on "
                        "repetitive-suffix drill traffic; the result "
                        "gains device_steps_per_token (sequential "
                        "device steps per generated token — the "
                        "number speculation shrinks) and the verify/"
                        "acceptance counters")
    p.add_argument("--budget-us", type=float, default=0.0,
                   help="fail (rc 1) when host overhead per retired "
                        "token exceeds this many microseconds "
                        "(0 = report only)")
    p.add_argument("--max-steps-per-token", type=float, default=0.0,
                   help="with --speculate: fail (rc 1) when the "
                        "sequential device steps per generated token "
                        "exceed this bound (the step-reduction gate; "
                        "0 = report only)")
    p.add_argument("--json", default="",
                   help="write the machine-readable result here")
    args = p.parse_args(argv)
    if args.speculate != "off" and args.kv_cache != "paged":
        p.error("--speculate requires --kv-cache=paged")
    result = run_hostbench(
        requests=args.requests, max_new=args.max_new,
        max_slots=args.max_slots, kv_cache=args.kv_cache,
        seed=args.seed, speculate=args.speculate,
    )
    out = json.dumps(result, indent=2, sort_keys=True)
    print(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out + "\n")
    if args.budget_us and result["host_us_per_token"] > args.budget_us:
        log.error(
            "host overhead %.1f us/token exceeds the %.1f budget",
            result["host_us_per_token"], args.budget_us,
        )
        return 1
    if args.max_steps_per_token and result.get(
        "device_steps_per_token", 0.0
    ) > args.max_steps_per_token:
        log.error(
            "%.3f device steps/token exceeds the %.3f bound",
            result["device_steps_per_token"], args.max_steps_per_token,
        )
        return 1
    log.info(
        "host overhead %.1f us/token (%d tokens in %.3fs, %d device "
        "calls, prefix hit ratio %.2f)",
        result["host_us_per_token"], result["tokens"],
        result["wall_s"], result["device_calls"],
        result["prefix_hit_ratio"],
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
