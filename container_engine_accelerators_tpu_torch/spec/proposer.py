# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Proposal sources + the per-row adaptive-k controller.

A copy of ``container_engine_accelerators_tpu/spec/proposer.py`` (which
imports nothing): the port imports nothing of the JAX package, so it
keeps its own. ``tests/test_torch_spec.py`` holds the two step for step.

The proposer contract (duck-typed; :class:`DraftProposer` in
``spec/draft.py`` implements the same surface over a real model):

  * ``admit(slot, ctx)`` — a request enters speculation on ``slot``
    with confirmed context ``ctx`` (prompt + everything generated);
  * ``observe(slot, tokens)`` — more tokens were CONFIRMED for the
    slot (accepted proposals, corrections, or fused-chunk output while
    backed off);
  * ``propose(slot, k)`` — up to ``k`` guessed continuation tokens
    (may return fewer, or ``[]`` when the source has nothing);
  * ``release(slot)`` — the request retired/drained/failed; drop every
    per-slot structure.

Proposals are GUESSES: correctness never depends on them (the verify
step accepts only greedily-matching prefixes), so a proposer may be
arbitrarily wrong — only throughput suffers, and :class:`AdaptiveK`
caps even that by backing the row off to the fused-chunk path.
"""


class Proposer:
    """Interface base (see module docstring). Subclasses override all
    four methods; the base is deliberately inert so a fake harness can
    stub exactly the surface the engine calls."""

    source = "none"

    def admit(self, slot, ctx):
        raise NotImplementedError

    def observe(self, slot, tokens):
        raise NotImplementedError

    def propose(self, slot, k):
        raise NotImplementedError

    def release(self, slot):
        raise NotImplementedError


class _NgramSlot:
    __slots__ = ("tokens", "last", "second")

    def __init__(self):
        self.tokens = []
        # (n, *gram) -> end position of its latest / second-latest
        # occurrence. Both are needed: the current suffix's own
        # registration is always the latest, so lookups fall back to
        # ``second`` to find the most recent EARLIER occurrence.
        self.last = {}
        self.second = {}


class NgramProposer(Proposer):
    """Suffix-match proposer: propose the continuation that followed
    the current suffix EARLIER in this request's own prompt +
    generation.

    The poor man's suffix automaton: for every n in [min_n, max_n] an
    incremental hash of each n-gram's latest (and second-latest) end
    position, O(max_n) per observed token and O(max_n) per proposal —
    zero device memory, zero device time. Strong exactly where decode
    is most wasteful: repetitive and structured traffic (code, JSON,
    multi-turn transcripts quoting earlier turns)."""

    source = "ngram"

    def __init__(self, min_n=2, max_n=4):
        if not 1 <= min_n <= max_n:
            raise ValueError(
                f"need 1 <= min_n ({min_n}) <= max_n ({max_n})"
            )
        self.min_n = min_n
        self.max_n = max_n
        self._slots = {}

    def admit(self, slot, ctx):
        self._slots[slot] = _NgramSlot()
        self.observe(slot, ctx)

    def observe(self, slot, tokens):
        st = self._slots.get(slot)
        if st is None:
            return
        for t in tokens:
            st.tokens.append(int(t))
            L = len(st.tokens)
            for n in range(self.min_n, self.max_n + 1):
                if L < n:
                    break
                key = (n, *st.tokens[L - n:])
                prev = st.last.get(key)
                if prev is not None:
                    st.second[key] = prev
                st.last[key] = L

    def propose(self, slot, k):
        st = self._slots.get(slot)
        if st is None or k < 1:
            return []
        L = len(st.tokens)
        # Longest-suffix-first: a deeper match is a stronger predictor.
        for n in range(self.max_n, self.min_n - 1, -1):
            if L < n:
                continue
            key = (n, *st.tokens[L - n:])
            j = st.last.get(key)
            if j == L:
                j = st.second.get(key)
            if j is None:
                continue
            return list(st.tokens[j:j + k])
        return []

    def release(self, slot):
        self._slots.pop(slot, None)


class AdaptiveK:
    """Per-row speculation depth controller.

    ``k`` moves on the power-of-two grid {k_max, ..., 2, 1, 0}: full
    acceptance doubles it back toward ``k_max``, acceptance under half
    halves it, and below 1 the row switches OFF (``k == 0`` — it
    rejoins the fused decode chunk, the exact 1-token-per-step
    baseline) for ``cooldown`` chunk rounds before re-probing at
    ``k = 1``. The off state is what bounds the regression on
    adversarial (zero-acceptance) traffic: at most
    ``log2(k_max) + 1`` probing verifies — each of which still emits
    its correction token, so even the probes never fall below one
    token per sequential step."""

    def __init__(self, k_max=8, cooldown=8):
        if k_max < 1:
            raise ValueError(f"k_max ({k_max}) must be >= 1")
        # Power-of-two floor: k values index a compiled-width grid.
        self.k_max = 1 << (int(k_max).bit_length() - 1)
        self.k = self.k_max
        self.cooldown = cooldown
        self._cool = 0

    def update(self, proposed, accepted):
        """Feed one verify round's outcome (``proposed == 0`` records
        a round where the source had nothing to offer)."""
        if proposed >= self.k and accepted >= proposed:
            self.k = min(self.k * 2, self.k_max)
        elif proposed > 0 and accepted * 2 >= proposed:
            return
        else:
            self.k //= 2
            if self.k < 1:
                self.k = 0
                self._cool = self.cooldown

    def tick(self):
        """One fused-chunk round completed while backed off; re-probe
        at ``k = 1`` once the cooldown is spent."""
        if self.k == 0:
            self._cool -= 1
            if self._cool <= 0:
                self.k = 1
