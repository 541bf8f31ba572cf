# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Chip accounting: the static+live HBM occupancy model.

Adapted from ``container_engine_accelerators_tpu/obs/hbm.py``: item sizes
come from the port config's ``torch_dtype`` (``np.dtype("bfloat16")``
needs the JAX package's ``ml_dtypes``), imports are the port's, and every
formula and gauge is the JAX module's. As there, ``weights`` counts the
layer matrices at ``cfg.dtype`` under ``--quantize int8`` too.

The reference stack's per-container GPU layer attributes *device
memory* to the containers holding it; this module is the serving
engine's analog — a byte-accurate model of what the serving program
keeps resident in HBM, exposed as one gauge family:

    tpu_hbm_bytes{component}   component ∈ weights | kv_pool | scratch
                                           | kv_used | kv_watermark
                                           | total

``weights`` is computed from the transformer config's parameter
shapes × dtype itemsize (the exact ``init_params`` pytree, MoE
included — the router is float32 by construction); ``kv_pool`` is the
block pool's device reservation (paged) or the per-slot slab (dense);
``scratch`` is a documented *estimate* of transient working-set bytes
(the widest dispatch's activations + the float32 logits row), not a
measurement. ``kv_used``/``kv_watermark`` are live: blocks currently
allocated and the pool's lifetime allocation peak (the denominator
the int8-KV ROADMAP item will be judged against).

Per-tenant-class block occupancy lands in

    tpu_hbm_kv_blocks{tenant_class}

blocks held by each class's live rows (by page-table mapping), with
radix-cached blocks attributed to the bounded ``shared`` class and
unallocated blocks to ``free``. A block can be both mapped by a row
and cached in the radix index — the view is by-holder, not a
partition of the pool.

All live reads are ``set_function`` gauges (scrape-time lazy): the
model costs nothing between scrapes and nothing at all when not
constructed (`--chip-accounting` off).
"""

from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics


def weights_bytes(cfg):
    """Exact parameter bytes of ``init_params(cfg)``.

    Mirrors models/transformer.py shape-for-shape: embed + per-layer
    norms/attention/FFN (+ MoE experts with the float32 router) +
    final norm. Kept adjacent to the init so a shape change here is a
    one-line diff review away from the pytree it models.
    """
    d, hq, hkv, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    hd, layers = cfg.head_dim, cfg.n_layers
    dt = cfg.torch_dtype.itemsize
    params = cfg.vocab_size * d          # embed
    params += d                          # ln_f
    per_layer = 2 * d                    # ln1 + ln2
    per_layer += d * hq * hd             # wq
    per_layer += 2 * d * hkv * hd        # wk + wv
    per_layer += hq * hd * d             # wo
    total = (params + layers * per_layer) * dt
    if cfg.n_experts:
        e = cfg.n_experts
        total += layers * d * e * 4      # moe_router (float32)
        total += layers * e * 2 * d * f * dt  # moe_w1 + moe_w2
    else:
        total += layers * 3 * d * f * dt      # w1 + w3 + w2
    return total


def weights_params(cfg):
    """Parameter count of ``init_params(cfg)`` (MFU numerator)."""
    d, hq, hkv, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    hd, layers = cfg.head_dim, cfg.n_layers
    n = cfg.vocab_size * d + d
    n += layers * (2 * d + d * hq * hd + 2 * d * hkv * hd + hq * hd * d)
    if cfg.n_experts:
        n += layers * (d * cfg.n_experts
                       + cfg.n_experts * 2 * d * f)
    else:
        n += layers * 3 * d * f
    return n


def kv_pool_bytes(cfg, num_blocks, block_size):
    """Device bytes of the paged KV pool (k and v planes)."""
    dt = cfg.torch_dtype.itemsize
    return (cfg.n_layers * num_blocks * 2 * cfg.n_kv_heads
            * block_size * cfg.head_dim * dt)


def dense_kv_bytes(cfg, max_slots):
    """Device bytes of the dense per-slot KV slab (k and v planes)."""
    dt = cfg.torch_dtype.itemsize
    return (cfg.n_layers * max_slots * 2 * cfg.n_kv_heads
            * cfg.max_seq_len * cfg.head_dim * dt)


def scratch_bytes(cfg, max_slots, prefill_chunk):
    """ESTIMATE of transient working-set bytes per dispatch: the
    widest call's activation rows (hidden + FFN intermediates, double-
    buffered) plus the float32 logits row per slot. An XLA allocator
    bound, not a measurement — documented as such everywhere it
    renders."""
    dt = cfg.torch_dtype.itemsize
    tokens = max(int(prefill_chunk), int(max_slots))
    acts = tokens * (2 * cfg.d_model + 2 * cfg.d_ff) * dt
    logits = max_slots * cfg.vocab_size * 4
    return acts + logits


class HbmModel:
    """Attach the HBM gauge family to a built engine's registry.

    Reads only host-side engine state at scrape time (occupied rows,
    page-table mappings, pool counters) — never device arrays — so a
    scrape cannot perturb the dispatch loop.
    """

    def __init__(self, engine, registry=None):
        self.engine = engine
        cfg = engine.cfg
        reg = registry if registry is not None else engine.registry
        self.registry = reg
        self.weights = weights_bytes(cfg)
        self.params = weights_params(cfg)
        kv = getattr(engine, "kv", None)
        if kv is not None:
            self.kv_pool = kv_pool_bytes(cfg, kv.num_blocks,
                                         kv.block_size)
            self._block_bytes = self.kv_pool // max(kv.num_blocks, 1)
        else:
            self.kv_pool = dense_kv_bytes(cfg, engine.max_slots)
            self._block_bytes = 0
        self.scratch = scratch_bytes(cfg, engine.max_slots,
                                     engine.prefill_chunk)
        self._m_bytes = obs_metrics.get_or_create(
            obs_metrics.Gauge, "tpu_hbm_bytes",
            "Modeled HBM occupancy by component: weights (exact, from "
            "config dtypes), kv_pool (device reservation), scratch "
            "(dispatch working-set ESTIMATE), kv_used/kv_watermark "
            "(live allocated blocks and their lifetime peak)",
            registry=reg, labelnames=["component"])
        for comp, val in (("weights", self.weights),
                          ("kv_pool", self.kv_pool),
                          ("scratch", self.scratch),
                          ("total", self.weights + self.kv_pool
                           + self.scratch)):
            self._m_bytes.labels(component=comp).set(val)
        self._m_bytes.labels(component="kv_used").set_function(
            self.kv_used_bytes)
        self._m_bytes.labels(component="kv_watermark").set_function(
            self.kv_watermark_bytes)
        self._m_blocks = obs_metrics.get_or_create(
            obs_metrics.Gauge, "tpu_hbm_kv_blocks",
            "Paged KV blocks by holder: live rows per tenant class, "
            "radix-cached blocks as 'shared', unallocated as 'free' "
            "(by-holder view — a block can be both mapped and cached)",
            registry=reg, labelnames=["tenant_class"])
        classes = sorted(getattr(getattr(engine, "tenants", None),
                                 "classes", None) or ())
        for name in classes + ["default", "shared", "free"]:
            self._m_blocks.labels(tenant_class=name).set_function(
                lambda n=name: float(self.block_occupancy().get(n, 0)))

    # -- live reads ---------------------------------------------------

    def _pool(self):
        kv = getattr(self.engine, "kv", None)
        return getattr(kv, "pool", None)

    def kv_used_blocks(self):
        kv = getattr(self.engine, "kv", None)
        if kv is None:
            return 0
        return (kv.num_blocks - 1) - kv.free_blocks()

    def kv_used_bytes(self):
        return self.kv_used_blocks() * self._block_bytes

    def kv_watermark_blocks(self):
        pool = self._pool()
        return getattr(pool, "watermark", 0) if pool is not None else 0

    def kv_watermark_bytes(self):
        return self.kv_watermark_blocks() * self._block_bytes

    def block_occupancy(self):
        """{holder: blocks} — live rows keyed by tenant class, plus
        ``shared`` (radix-cached) and ``free``. Snapshot reads of
        engine-loop-owned lists (GIL-atomic per element); an occupancy
        that is one admission stale is fine for a scrape."""
        kv = getattr(self.engine, "kv", None)
        if kv is None:
            return {}
        occ = {}
        occupied = self.engine.occupied
        mapped = getattr(kv, "mapped", None) or ()
        for slot, row in enumerate(occupied):
            if row is None:
                continue
            try:
                blocks = len(mapped[slot])
            except (IndexError, TypeError):
                blocks = 0
            tenant = str(row.get("tenant") or "default")
            occ[tenant] = occ.get(tenant, 0) + blocks
        occ["shared"] = kv.cached_blocks()
        occ["free"] = kv.free_blocks()
        return occ

    # -- event-log feed -----------------------------------------------

    def emit_snapshot(self, events):
        """Book one ``hbm_snapshot`` event (capacity-report feed)."""
        if events is None:
            return None
        return events.emit(
            "hbm_snapshot",
            weights_bytes=self.weights,
            weights_params=self.params,
            kv_pool_bytes=self.kv_pool,
            scratch_bytes=self.scratch,
            kv_used_bytes=self.kv_used_bytes(),
            kv_watermark_bytes=self.kv_watermark_bytes(),
            kv_blocks_by_class=self.block_occupancy(),
        )
