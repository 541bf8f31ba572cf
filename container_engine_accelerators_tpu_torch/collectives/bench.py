# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Collective microbenchmarks over ``torch.distributed``, the port of
``container_engine_accelerators_tpu/collectives/bench.py``.

The nccl-tests analogue (all_gather_perf / all_reduce_perf sweeps,
reference gpudirect-tcpx/nccl-config.yaml:17-63): sweeps message sizes
for psum / all-gather / reduce-scatter / ppermute over one axis of a
``DeviceMesh`` (one process per GPU, NCCL; gloo on the CPU) and reports
algorithmic and bus bandwidth. Bus-bandwidth conversion follows the
standard nccl-tests convention, as in JAX:

  all-reduce:      busbw = algbw * 2 * (n-1) / n
  all-gather:      busbw = algbw * (n-1) / n      (algbw over the full tensor)
  reduce-scatter:  busbw = algbw * (n-1) / n
  ppermute (ring): busbw = algbw

Where JAX runs one program over a mesh of devices, every rank here runs
the same calls on its own shard: ``mesh`` is a ``DeviceMesh`` over the
world (default the 1-D mesh ``("x",)`` of every rank,
``parallel/mesh.make_mesh``) and ``axis`` one of its dim names
(``"dcn"`` on a ``make_hybrid_mesh`` one). Inputs, byte accounting and
busbw factors are JAX's to the letter: rank r of the mesh holds block r
of JAX's global bf16 ``arange`` (``_sharded_input``). Each collective's
op comes from one builder (``*_op``) that the bench times and the tests
hold to JAX's ``shard_map`` op. Times are this rank's (the CLI reports
rank 0's).

On a world of one (one GPU) every collective is its identity: the
all-reduce, all-gather and reduce-scatter run over a group of one, the
ring shift is a copy (JAX's one-device ``ppermute``), and the collective
matmul degrades to the plain product with no transfer, as JAX's does on
one device.
"""

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from container_engine_accelerators_tpu_torch.obs import (
    collective as obs_collective,
)

# The tensor all-gather's and reduce-scatter's spellings:
# ``all_gather_single`` and ``reduce_scatter_single`` where PyTorch has
# them (2.13 deprecates ``all_gather_into_tensor`` and
# ``reduce_scatter_tensor`` in their favour), the older names on the
# releases before. Same arguments.
_all_gather_tensor = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)
_reduce_scatter_tensor = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


@dataclasses.dataclass
class CollectiveResult:
    collective: str
    msg_bytes: int          # per-device shard bytes moved into the collective
    n_devices: int
    mean_s: float
    algbw_gbps: float       # algorithmic bandwidth, GB/s
    busbw_gbps: float       # bus bandwidth, GB/s (nccl-tests convention)
    detail: dict = None     # extra per-bench numbers (collective_matmul)

    def __post_init__(self):
        # Every measured result also lands on the collective-tier
        # instruments (latency histogram + achieved-bandwidth gauges,
        # tagged host/slice) — free no-op until obs.collective is
        # configured (the CLI's --metrics-port does).
        obs_collective.record(
            self.collective, self.mean_s, msg_bytes=self.msg_bytes,
            algbw_gbps=self.algbw_gbps, busbw_gbps=self.busbw_gbps,
        )

    def to_json(self):
        d = dataclasses.asdict(self)
        if d.get("detail") is None:
            d.pop("detail", None)
        return d


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn, *args, warmup=2, iters=10):
    """Median-of-iters wall seconds of ``fn(*args)`` after ``warmup``
    calls, the device synchronized before and after each timed call
    (JAX's ``block_until_ready``); the device is the first argument's.
    gloo's ops return complete on the CPU."""
    device = args[0].device
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    times = []
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def mesh_device(mesh):
    """The device this rank's tensors live on: its current CUDA device
    for a ``cuda`` mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _mesh_1d(axis="x"):
    """JAX's ``_mesh_1d``: every rank of the world on one axis."""
    from container_engine_accelerators_tpu_torch.parallel import (
        mesh as pmesh,
    )

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    plan = pmesh.plan_mesh(dist.get_world_size(), {axis: -1})
    return pmesh.make_mesh(plan, device_type)


def axis_size(mesh, axis):
    return mesh.size(mesh.mesh_dim_names.index(axis))


def flat_index(mesh):
    """This rank's position in the mesh's row-major order: the block of
    a global array sharded over every mesh axis that it holds (JAX's
    ``_dim0_spec(mesh)``)."""
    return mesh.mesh.flatten().tolist().index(dist.get_rank())


def arange_block(start, elems, dtype, device):
    """JAX's ``jnp.arange(..., dtype=float32).astype(dtype)`` at
    [start, start + elems): f32 values rounded once to ``dtype``."""
    return torch.arange(start, start + elems, dtype=torch.float32,
                        device=device).to(dtype)


def _sharded_input(mesh, per_device_elems, dtype):
    """This rank's block of JAX's global ``arange`` of every device's
    ``per_device_elems``, sharded over all the mesh's axes."""
    return arange_block(flat_index(mesh) * per_device_elems,
                        per_device_elems, dtype, mesh_device(mesh))


# -- the ops: one builder each, timed by the bench and held by the tests ------

def psum_op(mesh, axis):
    """JAX's ``psum(shard, axis)``: ``op(x)`` all-reduces x in place over
    the axis's group and returns it."""
    group = mesh.get_group(axis)

    def op(x):
        dist.all_reduce(x, group=group)
        return x
    return op


def all_gather_op(mesh, axis):
    """JAX's tiled ``all_gather(shard, axis)``: ``op(shard, out)`` fills
    ``out`` (axis size × the shard) with the group's shards in axis
    order."""
    group = mesh.get_group(axis)

    def op(shard, out):
        _all_gather_tensor(out, shard, group=group)
        return out
    return op


def reduce_scatter_op(mesh, axis):
    """JAX's tiled ``psum_scatter(full, axis)``: ``op(full, out)`` fills
    ``out`` with block (this rank's axis index) of the group's sum."""
    group = mesh.get_group(axis)

    def op(full, out):
        _reduce_scatter_tensor(out, full, group=group)
        return out
    return op


def ppermute_op(mesh, axis):
    """JAX's ``ppermute(shard, axis, [(i, (i + 1) % n)])``: ``op(shard,
    out)`` sends the shard to the next rank of the axis and receives the
    previous rank's into ``out`` (one ``batch_isend_irecv``); a copy on
    an axis of one."""
    from container_engine_accelerators_tpu_torch.parallel.ring_attention \
        import ring_of

    ring = ring_of(mesh, axis)
    if ring.size == 1:
        return lambda shard, out: out.copy_(shard)

    def op(shard, out):
        ops = [dist.P2POp(dist.isend, shard, ring.next, group=ring.group),
               dist.P2POp(dist.irecv, out, ring.prev, group=ring.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out
    return op


def collective_matmul_op(mesh, axis):
    """JAX's ``tp_allgather_matmul`` on this rank: ``op(x_shard,
    w_shard)`` → this rank's columns of the gathered x @ w, the row
    gather run as ``parallel/overlap.py``'s ring (every hop overlapping
    the previous chunk's product). It is the ring that port's
    ``tp_allgather_matmul`` runs, without that wrapper's final gather of
    the output columns: JAX's output stays column-sharded. A ring of one
    is the plain product."""
    from container_engine_accelerators_tpu_torch.parallel import overlap
    from container_engine_accelerators_tpu_torch.parallel.ring_attention \
        import P2P, ring_of

    transport = P2P(ring_of(mesh, axis))

    def op(x_shard, w_shard):
        return overlap.allgather_matmul([x_shard], [w_shard], transport)[0]
    return op


# -- the benches ----------------------------------------------------------------

def bench_psum(per_device_bytes, mesh=None, dtype=torch.bfloat16, iters=10,
               axis="x"):
    """All-reduce over ``axis``: each device contributes per_device_bytes.

    On a hybrid mesh (make_hybrid_mesh), axis="dcn" benches the
    inter-slice tier with every rank striping its own transfer."""
    mesh = mesh or _mesh_1d()
    n = axis_size(mesh, axis)
    itemsize = _itemsize(dtype)
    elems = max(1, per_device_bytes // itemsize)
    x = _sharded_input(mesh, elems, dtype)
    mean_s = _time_fn(psum_op(mesh, axis), x, iters=iters)
    moved = elems * itemsize
    algbw = moved / mean_s / 1e9
    busbw = algbw * 2 * (n - 1) / n
    return CollectiveResult("psum", moved, n, mean_s, algbw, busbw)


def bench_all_gather(per_device_bytes, mesh=None, dtype=torch.bfloat16,
                     iters=10, axis="x"):
    mesh = mesh or _mesh_1d()
    n = axis_size(mesh, axis)
    itemsize = _itemsize(dtype)
    elems = max(1, per_device_bytes // itemsize)
    x = _sharded_input(mesh, elems, dtype)
    out = torch.empty(n * elems, dtype=dtype, device=x.device)
    mean_s = _time_fn(all_gather_op(mesh, axis), x, out, iters=iters)
    total = n * elems * itemsize
    algbw = total / mean_s / 1e9
    busbw = algbw * (n - 1) / n
    return CollectiveResult("all_gather", total, n, mean_s, algbw, busbw)


def reduce_scatter_input(mesh, axis, elems_out, dtype):
    """JAX's reduce-scatter input on this rank: the global ``arange(n ·
    elems_out)`` tiled over the other axes and sharded over them, of
    which every rank holds one whole tile."""
    n = axis_size(mesh, axis)
    return arange_block(0, n * elems_out, dtype, mesh_device(mesh))


def bench_reduce_scatter(per_device_bytes, mesh=None, dtype=torch.bfloat16,
                         iters=10, axis="x"):
    mesh = mesh or _mesh_1d()
    n = axis_size(mesh, axis)
    itemsize = _itemsize(dtype)
    elems_out = max(1, per_device_bytes // itemsize)
    full = reduce_scatter_input(mesh, axis, elems_out, dtype)
    out = torch.empty(elems_out, dtype=dtype, device=full.device)
    mean_s = _time_fn(reduce_scatter_op(mesh, axis), full, out, iters=iters)
    total = n * elems_out * itemsize
    algbw = total / mean_s / 1e9
    busbw = algbw * (n - 1) / n
    return CollectiveResult("reduce_scatter", total, n, mean_s, algbw, busbw)


def bench_ppermute(per_device_bytes, mesh=None, dtype=torch.bfloat16,
                   iters=10, axis="x"):
    """Ring shift — the primitive under ring attention / pipelining."""
    mesh = mesh or _mesh_1d()
    n = axis_size(mesh, axis)
    itemsize = _itemsize(dtype)
    elems = max(1, per_device_bytes // itemsize)
    x = _sharded_input(mesh, elems, dtype)
    out = torch.empty_like(x)
    mean_s = _time_fn(ppermute_op(mesh, axis), x, out, iters=iters)
    moved = elems * itemsize
    algbw = moved / mean_s / 1e9
    return CollectiveResult("ppermute", moved, n, mean_s, algbw, algbw)


# Fixed contraction/output widths for the collective-matmul bench: the
# swept byte size scales the gathered rows (the realistic axis — activation
# rows grow with batch×seq while weight blocks stay fixed).
_CM_K = 512
_CM_N = 512


def collective_matmul_inputs(mesh, axis, per_device_bytes, dtype):
    """(m, the whole x (m, K), w (K, N)): standard normal from seed 0 on
    this rank's device, the same on every rank (JAX's are drawn from
    ``PRNGKey(0)``; only their shapes matter to the timing)."""
    n = axis_size(mesh, axis)
    m = max(1, per_device_bytes // (_CM_K * _itemsize(dtype))) * n
    device = mesh_device(mesh)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(m, _CM_K, generator=gen, device=device).to(dtype)
    w = torch.randn(_CM_K, _CM_N, generator=gen, device=device).to(dtype)
    return m, x, w


def bench_collective_matmul(per_device_bytes, mesh=None,
                            dtype=torch.bfloat16, iters=10, axis="x"):
    """Ring collective-matmul overlap efficiency (parallel/overlap.py).

    Times the decomposed all-gather matmul — x (M, K) row-sharded over
    ``axis``, w (K, N) column-sharded, every hop overlapping the previous
    chunk's matmul — against its two un-overlapped halves on the same
    mesh:

      * ``matmul_s``:     the pure compute (pre-gathered x @ w_local,
                          no collective), and
      * ``collective_s``: the pure transfer (plain tiled all-gather of x).

    ``overlap_vs_max``  = max(matmul, collective) / measured — 1.0 means
    the slower resource fully hides the faster (perfect overlap; > 1 is
    measurement noise). ``overlap_vs_sum`` = (matmul + collective) /
    measured — the speedup over the serialized gather-then-matmul
    schedule.

    ``per_device_bytes`` sizes this device's x shard; on one device the
    ring degrades to the plain matmul (no collective) and the ratios are
    reported against a zero-cost transfer."""
    mesh = mesh or _mesh_1d()
    n = axis_size(mesh, axis)
    index = mesh.get_local_rank(axis)
    m, x, w = collective_matmul_inputs(mesh, axis, per_device_bytes, dtype)
    x_shard = x.chunk(n, dim=0)[index].contiguous()
    w_shard = w.chunk(n, dim=1)[index].contiguous()

    mean_ring = _time_fn(collective_matmul_op(mesh, axis), x_shard, w_shard,
                         iters=iters)
    # JAX's pure_matmul: a plain product (no Pallas kernel in JAX either).
    mean_mm = _time_fn(torch.mm, x, w_shard, iters=iters)
    if n > 1:
        gathered = torch.empty_like(x)
        mean_ag = _time_fn(all_gather_op(mesh, axis), x_shard.flatten(),
                           gathered.view(-1), iters=iters)
    else:
        mean_ag = 0.0

    gathered_bytes = m * _CM_K * _itemsize(dtype)
    algbw = gathered_bytes / mean_ring / 1e9
    return CollectiveResult(
        "collective_matmul", gathered_bytes, n, mean_ring, algbw,
        algbw * (n - 1) / n,
        detail={
            "m": m, "k": _CM_K, "n_cols": _CM_N,
            "matmul_s": mean_mm,
            "collective_s": mean_ag,
            "overlap_vs_max": round(
                max(mean_mm, mean_ag) / mean_ring, 4
            ),
            "overlap_vs_sum": round(
                (mean_mm + mean_ag) / mean_ring, 4
            ),
        },
    )


BENCHES = {
    "psum": bench_psum,
    "all_gather": bench_all_gather,
    "reduce_scatter": bench_reduce_scatter,
    "ppermute": bench_ppermute,
    "collective_matmul": bench_collective_matmul,
}


def sweep(collective="psum", min_bytes=1 << 20, max_bytes=1 << 28, factor=2,
          mesh=None, iters=10, axis="x"):
    """Size sweep, nccl-tests style (-b/-e/-f; reference
    gpudirect-tcpx/nccl-config.yaml:17 uses 1M→512M, factor 2)."""
    fn = BENCHES[collective]
    out = []
    size = min_bytes
    while size <= max_bytes:
        out.append(fn(size, mesh=mesh, iters=iters, axis=axis))
        size *= factor
    return out
