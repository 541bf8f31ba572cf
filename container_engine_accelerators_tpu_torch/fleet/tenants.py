# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Per-tenant admission: priority classes, weighted queue shares, quotas.

Copy of ``container_engine_accelerators_tpu/fleet/tenants.py``, its imports
rewritten to the port's package; the contracts are the same.

The serving-tier analog of the reference stack's time-sharing / MPS
multi-tenancy (PAPER.md L1/L2): accelerator time is shared between
tenant *classes*, and the sharing contract is enforced at admission so
one class's burst degrades *itself* instead of the fleet. Three
mechanisms, all driven by one JSON config (``--tenant-classes`` on
serve_cli and the fleet router):

  * **priority** — the shed order. Lower number = more important; when
    capacity runs out, the highest-numbered (least important) classes
    shed first, simply because their queue share and quota are what a
    burst exhausts. Priority also breaks dequeue ties.
  * **queue share** — each class may occupy at most ``share`` of the
    engine's bounded admission queue (``--max-queue``) and, on the
    router, ``share`` of fleet capacity in flight. Shares are weights:
    the dequeue order is stride-scheduled by share, so under contention
    every class drains proportionally to its share instead of FIFO
    head-of-line.
  * **token-rate quota** — a per-class token bucket over *requested*
    tokens (rows x max_new). A class that outruns its refill rate is
    shed with a typed 429 (reason ``quota``) before it ever queues.

Config shape (a JSON object, path or inline)::

    {"premium":  {"priority": 0, "queue_share": 0.5},
     "standard": {"priority": 1, "queue_share": 0.3,
                  "rate_tokens_per_s": 2000},
     "batch":    {"priority": 2, "queue_share": 0.2,
                  "rate_tokens_per_s": 500, "default": true}}

Unknown / absent tenant names resolve to the class marked ``default``
(else the lowest-priority class), so the label set stays BOUNDED — the
cardinality lint's contract: ``tenant_class`` is always one of the
configured class names, never a request-supplied string.
"""

import collections
import json
import os
import threading
import time

# Hard ceiling on configured classes: tenant_class is a metric label,
# and the cardinality lint's live-series ceiling assumes a small,
# operator-authored enum.
MAX_CLASSES = 16


class TenantClass:
    """One configured class (immutable after parse)."""

    __slots__ = ("name", "priority", "queue_share", "rate", "burst",
                 "default")

    def __init__(self, name, priority=0, queue_share=1.0, rate=0.0,
                 burst=None, default=False):
        self.name = name
        self.priority = int(priority)
        self.queue_share = float(queue_share)
        self.rate = float(rate)          # tokens per second; 0 = none
        self.burst = float(burst) if burst is not None else max(
            self.rate, 1.0
        )
        self.default = bool(default)


class TenantClasses:
    """Parsed ``--tenant-classes`` config + per-class token buckets.

    Thread-safe; the token buckets run on an injectable ``clock`` so
    the synthetic-day drill scripts quota refills deterministically."""

    def __init__(self, classes, clock=time.monotonic):
        if not classes:
            raise ValueError("tenant-classes config must name at least "
                             "one class")
        if len(classes) > MAX_CLASSES:
            raise ValueError(
                f"{len(classes)} tenant classes configured; the "
                f"bounded-label contract caps the enum at {MAX_CLASSES}"
            )
        self.classes = {c.name: c for c in classes}
        total_share = sum(c.queue_share for c in classes)
        if total_share > 1.0 + 1e-9:
            raise ValueError(
                f"queue shares sum to {total_share:.3f} > 1.0; shares "
                f"partition one bounded queue"
            )
        for c in classes:
            if c.queue_share <= 0:
                raise ValueError(
                    f"class {c.name!r}: queue_share must be > 0"
                )
        defaults = [c for c in classes if c.default]
        if len(defaults) > 1:
            raise ValueError(
                "at most one tenant class may be marked default"
            )
        # Unknown tenants land in the explicit default, else the least
        # important (highest-numbered) class: an unauthenticated burst
        # must never outrank a configured tenant.
        self._default = defaults[0] if defaults else max(
            classes, key=lambda c: c.priority
        )
        self._clock = clock
        self._lock = threading.Lock()
        # Token buckets: {name: [tokens, last_refill_ts]}.
        self._buckets = {
            c.name: [c.burst, clock()] for c in classes if c.rate > 0
        }

    @classmethod
    def from_dict(cls, obj, clock=time.monotonic):
        classes = []
        for name, spec in obj.items():
            if not isinstance(spec, dict):
                raise ValueError(
                    f"class {name!r}: spec must be an object"
                )
            unknown = set(spec) - {
                "priority", "queue_share", "rate_tokens_per_s",
                "burst_tokens", "default",
            }
            if unknown:
                raise ValueError(
                    f"class {name!r}: unknown keys {sorted(unknown)}"
                )
            classes.append(TenantClass(
                name,
                priority=spec.get("priority", 0),
                queue_share=spec.get("queue_share", 1.0 / len(obj)),
                rate=spec.get("rate_tokens_per_s", 0.0),
                burst=spec.get("burst_tokens"),
                default=spec.get("default", False),
            ))
        return cls(classes, clock=clock)

    @classmethod
    def from_flag(cls, value, clock=time.monotonic):
        """Parse the CLI flag: a JSON file path, or inline JSON; empty
        returns None (tenant admission off)."""
        if not value:
            return None
        if os.path.exists(value):
            with open(value) as f:
                obj = json.load(f)
        else:
            obj = json.loads(value)
        return cls.from_dict(obj, clock=clock)

    def resolve(self, tenant):
        """The :class:`TenantClass` a request's tenant string maps to
        (the bounded-enum guarantee: unknown names map to the default
        class, never into a label)."""
        cls = self.classes.get(tenant) if tenant else None
        return cls if cls is not None else self._default

    def names(self):
        return sorted(self.classes)

    def try_consume(self, name, tokens):
        """Take ``tokens`` from the class's token bucket; False when
        the quota is exhausted (the caller sheds with reason
        ``quota``). Classes without a rate always admit."""
        c = self.classes[name]
        if c.rate <= 0:
            return True
        now = self._clock()
        with self._lock:
            bucket = self._buckets[name]
            level, last = bucket
            level = min(c.burst, level + (now - last) * c.rate)
            bucket[1] = now
            if level < tokens:
                bucket[0] = level
                return False
            bucket[0] = level - tokens
            return True

    def quota_level(self, name):
        """Current bucket level (for tests / the day drill's
        assertions); inf for unlimited classes."""
        c = self.classes[name]
        if c.rate <= 0:
            return float("inf")
        now = self._clock()
        with self._lock:
            level, last = self._buckets[name]
            return min(c.burst, level + (now - last) * c.rate)


class TenantQueue:
    """A drop-in for the engine's ``queue.Queue`` that drains classes
    by weighted stride scheduling.

    Each class carries a virtual "pass" value; a pop takes the head of
    the non-empty class with the smallest pass (priority breaks ties)
    and advances that class's pass by ``1 / queue_share``. Under
    contention every class therefore drains proportionally to its
    share; an idle class never accumulates credit (its pass is clamped
    forward on its next arrival), so a quiet tenant cannot starve the
    fleet with a saved-up burst.

    Implements exactly the surface ``ContinuousEngine`` uses:
    ``put``/``get``/``get_nowait``/``qsize`` — plus ``depths()`` for
    the per-class /healthz snapshot."""

    def __init__(self, tenants):
        self.tenants = tenants
        self._cond = threading.Condition()
        self._queues = {
            name: collections.deque() for name in tenants.classes
        }
        self._pass = dict.fromkeys(tenants.classes, 0.0)
        self._clockv = 0.0  # global virtual time (max pass consumed)

    def class_of(self, row):
        return self.tenants.resolve(
            row.get("tenant") if isinstance(row, dict) else None
        ).name

    def put(self, row):
        name = self.class_of(row)
        with self._cond:
            q = self._queues[name]
            if not q:
                # Re-entering class: no banked credit from idle time.
                self._pass[name] = max(self._pass[name], self._clockv)
            q.append(row)
            self._cond.notify()

    def _pick(self):
        best = None
        for name, q in self._queues.items():
            if not q:
                continue
            key = (self._pass[name],
                   self.tenants.classes[name].priority)
            if best is None or key < best[0]:
                best = (key, name)
        return best[1] if best else None

    def _pop(self):
        name = self._pick()
        if name is None:
            raise IndexError("empty")
        row = self._queues[name].popleft()
        stride = 1.0 / self.tenants.classes[name].queue_share
        self._pass[name] += stride
        self._clockv = max(self._clockv, self._pass[name])
        return row

    def get(self, block=True, timeout=None):
        import queue as _queue

        with self._cond:
            if not block:
                if not any(self._queues.values()):
                    raise _queue.Empty
                return self._pop()
            if not self._cond.wait_for(
                lambda: any(self._queues.values()), timeout=timeout
            ):
                raise _queue.Empty
            return self._pop()

    def get_nowait(self):
        return self.get(block=False)

    def qsize(self):
        with self._cond:
            return sum(len(q) for q in self._queues.values())

    def depth(self, name):
        with self._cond:
            return len(self._queues[name])

    def depths(self):
        """{class: queued rows} — the /healthz per-class snapshot."""
        with self._cond:
            return {n: len(q) for n, q in self._queues.items()}
