# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Paged KV-cache subsystem: block pool, radix prefix index, manager,
handoff wire, host-loop bench.

Copies of the JAX package's pure-Python ``kvcache`` modules (whose
package pulls in jax through ``ops.paged_attention``), with the null
block taken from the port's ``ops.paged_attention``:

  * :mod:`.blockpool` — fixed-size token blocks, ref-counted with a
    reserved null block and copy-on-write forking;
  * :mod:`.radix` — block-granular radix tree over cached prefixes
    with LRU eviction of unreferenced blocks;
  * :mod:`.manager` — per-slot page tables gluing the two to the
    engine: admission prefix matching, block allocation/coverage,
    retirement insertion, drain release;
  * :mod:`.handoff` — the cross-replica KV handoff stream (JAX's wire:
    framed JSON, CRC32 digests, verify-everything-then-allocate
    install); the engine half is ``ContinuousEngine.kv_export`` /
    ``kv_install``;
  * :mod:`.hostbench` — the host-loop microbench, ported: a port
    engine with fake device seams, host overhead per retired token.

The device half (gathers, scatters, copy-on-write copies, a handoff's
block writes) lives in ``ops/paged_attention.py`` and
``models/transformer.py`` (``paged_decode_chunk`` /
``paged_prefill_segment``).
"""

from container_engine_accelerators_tpu_torch.kvcache import (  # noqa: F401
    handoff,
)
from container_engine_accelerators_tpu_torch.kvcache.blockpool import (  # noqa: F401
    BlockPool,
    PoolExhausted,
)
from container_engine_accelerators_tpu_torch.kvcache.manager import (  # noqa: F401
    PagedKVManager,
)
from container_engine_accelerators_tpu_torch.kvcache.radix import (  # noqa: F401
    RadixIndex,
)
