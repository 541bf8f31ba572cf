# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Stack-owned persistent compile cache, port.

Port of ``container_engine_accelerators_tpu/warmstart/cache.py``, with
JAX's public surface and names: :func:`cache_key`, :class:`CompileCache`
(``memo``, ``memo_names``, ``snapshot``, ``record_hit``,
``record_miss``), the ``tpu_compile_cache_hits_total`` /
``tpu_compile_cache_misses_total`` counters, :func:`configure`,
:func:`configure_from_flag`, :func:`arm`, :func:`active`,
:func:`deactivate`, :func:`snapshot` and the
``compile_cache_configured`` event.

JAX's cache holds XLA executables. The port's compiles are its kernel
builds, so :func:`configure` points those at ``<base_dir>/<key>/``:

  * ``torch_ext/`` — the nvcc libraries of ``ops/_ext.py``, named by a
    hash of the source, the shared headers and the flags (an edited
    source never loads a stale library). While a cache is armed,
    ``_ext.build`` records one hit per library it finds and one miss per
    ``nvcc`` it runs; with none armed it counts nothing, as JAX does.
    A library this process loaded before :func:`configure` stays loaded
    from where it was built and is counted neither way, as a jit that
    JAX already holds in memory never reaches its disk cache.
  * ``triton/`` — Triton's cache (``TRITON_CACHE_DIR``), for the stream
    kernels of ``ops/stream.py``. A launch that compiles a new
    specialisation in this process is a miss when it adds an entry to
    the directory and a hit when Triton found it there
    (:func:`count_triton`). Triton reads the variable at each compile,
    but a kernel already compiled in this process stays in memory: a
    :func:`configure` after a stream kernel compiled cannot move it, and
    the event's ``runtime_cache`` is then False (with a warning).

``runtime_cache`` is True when the build hooks were pointed at the
directory. On the CPU nothing is built, and the layout, the memos and
the counters work as on the card. CUDA graph captures are not
persistent and are not compiles in this sense (``ContinuousEngine
.graph_stats()`` counts them).

:meth:`CompileCache.memo` is JAX's marker-file memo for compiles no
build hook sees: the hermetic drills (``faults/storm.py``,
``fleet/sim.py``) route their simulated compiles through it.

Arming is process-global (:func:`configure`/:func:`active`), the
``faults.arm`` pattern. :func:`deactivate` also puts the nvcc build
directory back to its default (JAX leaves its runtime cache directory
set).
"""

import dataclasses
import hashlib
import json
import logging
import os
import re
import threading

from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger("warmstart.cache")

EVENT_SOURCE = "warmstart"

HITS_NAME = "tpu_compile_cache_hits_total"
MISSES_NAME = "tpu_compile_cache_misses_total"

# Subdirectories of a configured cache, one per build hook.
EXT_SUBDIR = "torch_ext"
TRITON_SUBDIR = "triton"
TRITON_ENV = "TRITON_CACHE_DIR"


def cache_key(topology="", cfg=None, buckets=()):
    """Stable 12-hex key over ``(topology, config, shape buckets)``,
    JAX's: the same inputs give JAX's key.

    ``topology`` is the device view (e.g. ``"1xgpu"``), ``cfg`` a
    transformer config dataclass / dict / None, ``buckets`` the static
    shape grid (``transformer.serving_shape_buckets``)."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        cfg = dataclasses.asdict(cfg)
    payload = json.dumps(
        {"topology": topology, "cfg": cfg, "buckets": list(buckets)},
        sort_keys=True, default=str,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:12]


class CompileCache:
    """One configured cache directory plus its accounting.

    Thread-safe without a lock of its own: counter bumps ride
    ``obs_metrics.Counter``'s internal lock and concurrent ``memo``
    first-callers race through O_EXCL create."""

    def __init__(self, base_dir, key="", registry=None, events=None):
        self.base_dir = os.path.abspath(base_dir)
        self.key = key
        self.dir = (
            os.path.join(self.base_dir, key) if key else self.base_dir
        )
        os.makedirs(self.dir, exist_ok=True)
        self.events = events
        # Entries in triton_dir after the last counted compile
        # (count_triton), read at the first launch.
        self.triton_entries = None
        reg = registry if registry is not None else obs_metrics.REGISTRY
        self.registry = reg
        self._m_hits = obs_metrics.get_or_create(
            obs_metrics.Counter, HITS_NAME,
            "Persistent compilation cache hits (a compile replayed "
            "from disk instead of re-paid)", registry=reg,
        )
        self._m_misses = obs_metrics.get_or_create(
            obs_metrics.Counter, MISSES_NAME,
            "Persistent compilation cache misses (a compile paid and "
            "written back for the next restart)", registry=reg,
        )

    @property
    def ext_dir(self):
        """Where ``ops/_ext.py`` builds its libraries under this cache."""
        return os.path.join(self.dir, EXT_SUBDIR)

    @property
    def triton_dir(self):
        """Triton's cache directory under this cache."""
        return os.path.join(self.dir, TRITON_SUBDIR)

    def record_hit(self):
        self._m_hits.inc()

    def record_miss(self):
        self._m_misses.inc()

    def snapshot(self):
        """``{"hits": n, "misses": n}`` — monotonic process totals;
        diff two snapshots to attribute a phase (an attempt, a warmup
        pass)."""
        return {
            "hits": int(self._m_hits.value),
            "misses": int(self._m_misses.value),
        }

    def memo(self, name):
        """Marker-file memo: True (hit) when ``name`` was already
        compiled into this cache by anyone, else records the miss and
        stamps it. O_EXCL create makes concurrent first callers race
        safely — exactly one records the miss."""
        stamp = os.path.join(
            self.dir,
            "stamp-" + re.sub(r"[^A-Za-z0-9._-]", "_", name),
        )
        try:
            fd = os.open(stamp, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            self.record_hit()
            return True
        try:
            os.write(fd, name.encode())
        finally:
            os.close(fd)
        self.record_miss()
        return False

    def memo_names(self):
        """Names stamped into this cache so far (sorted) — what a
        replacement replica should warm before taking traffic. A stamp
        caught between create and write yields its sanitized filename
        instead of the raw name (still a warmable label)."""
        out = []
        try:
            files = os.listdir(self.dir)
        except OSError:
            return []
        for fn in files:
            if not fn.startswith("stamp-"):
                continue
            try:
                with open(os.path.join(self.dir, fn)) as f:
                    name = f.read()
            except OSError:
                name = ""
            out.append(name or fn[len("stamp-"):])
        return sorted(out)


# -- process-global armed cache (the faults.arm pattern) ----------------------

_CACHE = None
_cache_lock = threading.Lock()


def _point_builds(cache):
    """Point the port's build hooks at ``cache``: the nvcc libraries'
    directory and Triton's. Returns True when both now build there,
    False when a stream kernel already compiled in this process (its
    specialisations stay where Triton first put them)."""
    from container_engine_accelerators_tpu_torch.ops import _ext
    from container_engine_accelerators_tpu_torch.ops import stream

    _ext.set_build_dir(cache.ext_dir)
    os.makedirs(cache.triton_dir, exist_ok=True)
    os.environ[TRITON_ENV] = cache.triton_dir
    compiled = stream.compiled_specialisations()
    if compiled:
        log.warning(
            "%d Triton specialisation(s) compiled in this process before "
            "the compile cache was configured; they stay in Triton's "
            "earlier cache, later ones go to %s", compiled,
            cache.triton_dir,
        )
        return False
    return True


def configure(base_dir, key="", registry=None, events=None):
    """Arm the process-wide persistent compile cache under
    ``base_dir[/key]`` and return the :class:`CompileCache` handle.
    Re-configuring replaces the armed handle (counters keep
    accumulating in the target registry)."""
    global _CACHE
    cache = CompileCache(base_dir, key=key, registry=registry,
                         events=events)
    runtime_armed = _point_builds(cache)
    with _cache_lock:
        _CACHE = cache
    if cache.events is not None:
        cache.events.emit(
            "compile_cache_configured", dir=cache.dir, key=key,
            runtime_cache=runtime_armed,
        )
    log.info("persistent compile cache armed at %s (runtime cache %s)",
             cache.dir, "on" if runtime_armed else
             "partly: Triton compiled before it")
    return cache


def configure_from_flag(base_dir, key="", registry=None, sink_path=""):
    """CLI wiring for ``--compile-cache-dir``: arm the cache with its
    counters in the process-default registry and its events on the
    CLI's ``--event-log`` sink (pass it as ``sink_path``)."""
    return configure(
        base_dir, key=key,
        registry=registry if registry is not None else obs_metrics.REGISTRY,
        events=obs_events.EventStream(
            EVENT_SOURCE, sink_path=sink_path,
            registry=registry if registry is not None
            else obs_metrics.REGISTRY,
        ),
    )


def arm(cache):
    """Install an existing :class:`CompileCache` as the process-global
    handle WITHOUT pointing the build hooks at it — the hermetic drills
    (``faults/storm.py``) route simulated compiles through
    :meth:`CompileCache.memo` and must not move the real builds into a
    temp dir. Returns the cache."""
    global _CACHE
    with _cache_lock:
        _CACHE = cache
    return cache


def active():
    """The armed cache handle, or None."""
    return _CACHE


def deactivate():
    """Detach the armed cache and put the nvcc build directory back to
    its default (``.torch_ext/`` at the checkout root). Triton's
    variable is left as set: a process that compiled into a cache keeps
    finding its kernels there."""
    global _CACHE
    with _cache_lock:
        was, _CACHE = _CACHE, None
    if was is not None:
        from container_engine_accelerators_tpu_torch.ops import _ext

        _ext.set_build_dir(None)


def snapshot():
    """Armed-cache counters, or zeros when nothing is armed (callers
    stamp telemetry unconditionally; see supervisor restart events)."""
    cache = _CACHE
    if cache is None:
        return {"hits": 0, "misses": 0}
    return cache.snapshot()


def count_triton(compiled, launch):
    """Run ``launch()`` (one Triton launch) and, while a cache is armed,
    count it: a launch that compiled a new specialisation in this
    process (``compiled()``, the kernel's in-memory specialisation
    count, grew) is a miss when Triton's cache directory gained an
    entry since the last such launch, and a hit when it did not. A
    launch of a specialisation already in memory counts neither way.
    With no cache armed this is one ``is None`` check; armed, two reads
    of the in-memory count, and a listing of the directory only around
    a compile."""
    cache = _CACHE
    if cache is None:
        return launch()
    if cache.triton_entries is None:
        cache.triton_entries = _entries(cache.triton_dir)
    n0 = compiled()
    out = launch()
    if compiled() > n0:
        entries = _entries(cache.triton_dir)
        if entries > cache.triton_entries:
            cache.record_miss()
        else:
            cache.record_hit()
        cache.triton_entries = entries
    return out


def _entries(path):
    try:
        return len(os.listdir(path))
    except OSError:
        return 0
