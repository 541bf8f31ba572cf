# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Synthetic-data training CLI, the PyTorch port of
``container_engine_accelerators_tpu/models/train_cli.py`` on one device.

Every ``--model`` of the JAX CLI, with its flags, defaults and result
keys: ``mnist`` (the default; the f32 CNN, SGD with momentum), ``resnet``
(``resnet18_ish`` at ``--image-size``, flax's BatchNorm, Nesterov SGD),
``bert`` (MLM, AdamW; unmasked attention through the non-causal flash
kernels on CUDA) and ``transformer`` (the decoder, AdamW, per-layer
remat, the flash kernels on CUDA; ``--n-experts`` for MoE FFNs). Each
step's batch is drawn from a numpy generator seeded with ``seed + 1 +
step`` (the JAX CLI draws from ``jax.random``), so a resumed run sees the
batches a straight one does. The run prints one JSON line with the JAX
CLI's result keys for the same flags.

The training loop's recovery and observability surfaces are JAX's:
``--checkpoint-dir``/``--checkpoint-every`` (``utils/checkpointing.py``:
resume from the newest readable step, a corrupt one quarantined),
``--watchdog-s``/``--max-restarts``/``--restart-backoff-*``
(``models/supervisor.py``), ``--fault-plan`` (``faults.fire("train.step",
step=N)`` before each step), ``--metrics-port`` (the ``tpu_training_*``
families), ``--trace-out`` (``init_state``, ``restore``, ``step`` and
``checkpoint`` spans), ``--event-log`` (``train_step``, the supervisor's
``train_recovery``, ``checkpoint_fallback``, and the ``goodput`` block of
the result), ``--alert-rules``, ``--flight-recorder`` and
``--profile-dir`` (``torch.profiler``). A run started in-process leaves
nothing armed behind: the fault plan, the span tracer, the flight
recorder and the metrics server it started end with it.

  python -m container_engine_accelerators_tpu_torch.models.train_cli \\
      --model bert --steps 5
  python -m container_engine_accelerators_tpu_torch.models.train_cli \\
      --model mnist --steps 3 --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given (the kernels' plain
versions; the tests run so).

Multi-process training (JAX's ``--distributed`` and ``--sp``): one
process per device joins the world from the stack's env contract
(``parallel/bootstrap.py``: ``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``,
``TPU_COORDINATOR_PORT``, and torchrun's ``LOCAL_RANK`` /
``LOCAL_WORLD_SIZE``; ``TPU_WORKER_ID`` in the env implies
``--distributed``), NCCL on ``cuda:{LOCAL_RANK}``, gloo under ``--device
cpu``. ``build_mesh`` lays a ``{"dp": -1, "sp": sp, "tp": tp}`` mesh
over the world. Every model trains data-parallel: every rank draws the
same global batch (JAX's default size scaled by dp), runs its rows, and
the gradients are summed over the world once a step after
``backward()``; parameters and optimizer state stay replicated. ``--sp``
shards the transformer's sequence: RoPE at global positions and ring
attention over the sp axis (``parallel/ring_attention.py``). mnist,
resnet and BERT batches shard over dp alone, as JAX's do, so their sp
ranks are replicas: the batch is replicated over sp, the gradients and
the loss are summed over dp only (``data_parallel.BATCH_AXES``) and
every rank prints the same loss. Rank
0 writes the checkpoints; on resume it restores the newest and every
rank takes that step and state from it, so a directory local to rank
0's host is enough.

  TPU_WORKER_ID=0 TPU_WORKER_HOSTNAMES=localhost torchrun \\
      --nproc-per-node 2 -m \\
      container_engine_accelerators_tpu_torch.models.train_cli \\
      --model transformer --sp 2

``--compile-cache-dir`` arms the persistent compile cache
(``warmstart/cache.py``) under a subdirectory keyed as JAX keys it, by
the topology (``{n}x{platform}``, n the world's devices) and the same 14
args: the kernel builds go there, a resumed or re-launched run builds
nothing, and the supervisor's recovery events carry each attempt's
hits and misses.

``--pp N`` (the transformer; exclusive with ``--sp/--tp/--ep``) trains
the decoder pipeline-parallel (``models/pipeline_lm.py``: the 1F1B
schedule of ``parallel/pipeline.py`` over point-to-point transfers on a
"pp" mesh): one stage a rank, so it needs a ``--distributed`` world of
exactly N ranks (a world of one is refused as JAX refuses too few
devices). A step is M = ``--microbatches`` (default 2·N) microbatches
of ``--batch-size`` (default 2) sequences. Checkpoints are per stage:
rank i writes ``<dir>/stage_<i>/step_<N>/state.pt`` (its layers, its
copy of the embedding and final norm, its optimizer); on resume every
rank restores its newest readable step and the world takes the oldest
of them, so the stages resume at one step.

  TPU_WORKER_ID=0 TPU_WORKER_HOSTNAMES=localhost torchrun \\
      --nproc-per-node 4 -m \\
      container_engine_accelerators_tpu_torch.models.train_cli \\
      --model transformer --pp 4 --n-layers 8

``--tp N`` and ``--ep N`` add JAX's "tp" and "ep" axes to the mesh
(``build_mesh``; the batch is replicated over both). The transformer
trains tensor-parallel (``models/tp_lm.py``: Megatron shards, the ring
collective matmuls of ``parallel/overlap.py`` where JAX's
``resolve_overlap`` gives "ring", one all-reduce after each row-parallel
product where it gives "off", attention on the flash kernels at the
rank's n_heads/tp heads, the sp ring on them under ``--sp``) and its
``--n-experts`` MoE FFN expert-parallel over ep (``parallel/moe.py``);
``--model bert`` trains tensor-parallel on its Megatron shards; mnist and
resnet replicate their parameters and batch over tp and ep, as JAX does,
so those ranks are replicas. A part whose dims tp does not divide (the
attention where tp does not divide the heads or KV heads, the
vocabulary) is held whole on every tp rank and computed there alike, as
GSPMD computes it where its shards cut through a head
(``tp_lm.whole_parts``); a d_ff or head width tp does not divide is
refused, as JAX's ``device_put`` fails on it. ``--n-experts`` trains under every axis:
routing is per sequence, and under ``--sp`` each sequence is routed
whole across its sp ranks, which exchange their hit counts and run the
experts on their own tokens (``parallel/moe.py``). Checkpoints under a tp or ep
axis are per shard: the ranks of dp (and sp) index 0 write
``<dir>/tp_<t>_ep_<e>/step_<N>/state.pt`` (their shards and AdamW
state); on resume those ranks restore their newest readable step, the
world takes the oldest of them, and each broadcasts its state over its
dp and sp groups.

  TPU_WORKER_ID=0 TPU_WORKER_HOSTNAMES=localhost torchrun \\
      --nproc-per-node 4 -m \\
      container_engine_accelerators_tpu_torch.models.train_cli \\
      --model transformer --tp 4 --n-heads 32
"""

import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from container_engine_accelerators_tpu_torch import faults
from container_engine_accelerators_tpu_torch.collectives import device_bench
from container_engine_accelerators_tpu_torch.models import supervisor
from container_engine_accelerators_tpu_torch.models import transformer as tf
from container_engine_accelerators_tpu_torch.obs import alerts as obs_alerts
from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import flight as obs_flight
from container_engine_accelerators_tpu_torch.obs import goodput as obs_goodput
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics
from container_engine_accelerators_tpu_torch.obs import ports as obs_ports
from container_engine_accelerators_tpu_torch.obs import trace as obs_trace
from container_engine_accelerators_tpu_torch.parallel import (
    bootstrap,
    data_parallel,
)
from container_engine_accelerators_tpu_torch.parallel import mesh as pmesh
from container_engine_accelerators_tpu_torch.utils import (
    checkpointing,
    profiling,
)
from container_engine_accelerators_tpu_torch.warmstart import cache as ws_cache

log = logging.getLogger("train_cli")

# Step-time histogram bounds: a CPU smoke step (~10ms) up to a
# first step that builds the kernels.
STEP_SECONDS_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                        5.0, 10.0, 30.0, 120.0)


def _count_params(state):
    """Parameter count for the MFU estimate: the model's (element 0 of
    the (model, optimizer) state), not the optimizer's moments nor
    ResNet's running statistics."""
    model = state[0] if isinstance(state, (tuple, list)) else state
    return sum(p.numel() for p in model.parameters())


def peak_flops(device):
    """The card's dense bf16 peak in FLOP/s from the card table
    (``collectives.device_bench.detect_generation``, as the JAX
    ``calibrate`` reads its generation's): 0 on the CPU and on a card the
    table lacks, so est_mfu is 0 there."""
    card = device_bench.detect_generation(device)
    return card.bf16_tflops * 1e12 if card else 0.0


class TrainMetrics:
    """The training run's workload registry, JAX's families: per-step
    timings plus throughput/MFU gauges. One instance per run;
    --metrics-port serves it, the result JSON quotes the headline numbers
    either way."""

    def __init__(self, units_per_step, unit_name, registry=None):
        self.units_per_step = units_per_step
        self.unit_name = unit_name
        self.registry = registry if registry is not None \
            else obs_metrics.Registry()
        self.steps = obs_metrics.Counter(
            "tpu_training_steps_total", "Optimizer steps completed",
            registry=self.registry)
        self.step_seconds = obs_metrics.Histogram(
            "tpu_training_step_seconds",
            "Wall seconds per train step (device-synchronized)",
            buckets=STEP_SECONDS_BUCKETS, registry=self.registry)
        self.units_per_s = obs_metrics.Gauge(
            "tpu_training_units_per_second",
            f"Training throughput over the last step ({unit_name}/s)",
            registry=self.registry)
        self.est_mfu = obs_metrics.Gauge(
            "tpu_training_estimated_mfu",
            "Estimated model FLOPs utilization (6*N*tokens per step vs "
            "the card's nominal bf16 peak; 0 when the peak is unknown, "
            "e.g. on CPU)", registry=self.registry)
        self.loss = obs_metrics.Gauge(
            "tpu_training_loss", "Loss of the last completed step",
            registry=self.registry)
        # 6*N*D: the dense-transformer FLOPs/token estimate; only
        # meaningful when units are tokens.
        self._n_params = 0
        self._peak_flops = 0.0

    def calibrate(self, state, device, n_devices=1, n_params=None):
        """The parameter count (``n_params``, else the state's model's)
        and the world's peak: the card's times ``n_devices``, as JAX
        multiplies its generation's by the device count."""
        self._n_params = n_params or _count_params(state)
        self._peak_flops = peak_flops(device) * n_devices

    def observe_step(self, dt_s, loss):
        self.steps.inc()
        self.step_seconds.observe(dt_s)
        self.units_per_s.set(self.units_per_step / dt_s)
        self.loss.set(loss)
        if self._peak_flops and self._n_params and self.unit_name == "tok":
            flops = 6.0 * self._n_params * self.units_per_step
            self.est_mfu.set(flops / dt_s / self._peak_flops)

    def summary(self):
        """Headline numbers for the run's result JSON."""
        n = self.step_seconds.count
        return {
            "units_per_s": round(self.units_per_s.value, 2),
            "mean_step_s": round(
                self.step_seconds.sum / n, 5) if n else None,
            "est_mfu": round(self.est_mfu.value, 5),
        }


def build_mesh(n_devices, sp, tp, ep=1, device_type="cuda"):
    """JAX's ``build_mesh``: a ``{"dp": -1, "sp": sp, "tp": tp}`` (and
    ``"ep"`` above 1) DeviceMesh over the initialized world of
    ``n_devices`` ranks."""
    axes = {"dp": -1, "sp": sp, "tp": tp}
    if ep > 1:
        axes["ep"] = ep
    return pmesh.make_mesh(pmesh.plan_mesh(n_devices, axes), device_type)


def _dp(mesh):
    """The data-parallel degree: the mesh's dp axis (1 without one)."""
    return data_parallel.axis(mesh, "dp")[1]


def _is_leader():
    """Rank 0 of the world, or the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def _train_loop(args, init_state, train_step, make_batch, units_per_step,
                unit_name, device, n_devices=1, per_rank=False,
                n_params=None, shard_mesh=None):
    """Shared step loop: init (or resume from --checkpoint-dir), run to
    --steps with periodic checkpoints, return the result dict. Every
    step is a trace span and an observation into the run's TrainMetrics
    registry. ``per_rank``: the ranks hold different states (pipeline
    stages), each checkpointed in its own ``stage_<rank>`` directory.
    ``shard_mesh``: the ranks hold the shards of ``shard_mesh``'s tp and
    ep coordinates, checkpointed per shard (``_shard_dir``). ``n_params``:
    the model's parameter count for the MFU estimate when the state
    holds only part of it."""
    obs = TrainMetrics(units_per_step, unit_name)
    server = None
    if args.metrics_port:
        server = obs_metrics.serve(
            args.metrics_port, registry=obs.registry,
            owner="training workload metrics (train_cli --metrics-port)",
        )
        log.info("workload metrics on :%d/metrics", args.metrics_port)
    ev_stream = None
    if args.event_log:
        ev_stream = obs_events.EventStream(
            "train", sink_path=args.event_log, registry=obs.registry,
        )
    alert_ev = obs_alerts.wire_from_flags(
        [obs.registry], args.alert_rules, alerts_out=args.alerts_out,
    )
    recorder = obs_flight.wire_from_flags(
        args.flight_recorder, args.flight_dir,
        registries=[("train", obs.registry)],
        streams=[ev_stream] if ev_stream is not None else (),
        tracer=obs_trace.get(), window_s=args.flight_window_s,
    )
    try:
        return _train_steps(args, init_state, train_step, make_batch,
                            units_per_step, unit_name, obs, ev_stream,
                            device, n_devices, per_rank, n_params,
                            shard_mesh)
    finally:
        if alert_ev is not None:
            alert_ev.close()
        if recorder is not None:
            recorder.close()
            obs_flight.deactivate()
        if server is not None:
            server.close()


def _restore(ckpt_dir, state, ev_stream, device):
    """Resume → (state, step or None). Rank 0 (or the only process)
    restores the newest readable step of its ``--checkpoint-dir`` (it
    alone quarantines an unreadable one), and every rank takes that step
    and state from rank 0, so the ranks resume alike and meet the same
    collectives whether they share the directory or each host has its
    own."""
    restored, step = state, None
    if _is_leader() and checkpointing.list_steps(ckpt_dir):
        with obs_trace.span("restore") as sp:
            got, step = checkpointing.restore_latest(
                ckpt_dir, state, events=ev_stream,
            )
            if step is not None:
                sp.set(step=step)
                restored = got
    return checkpointing.broadcast(restored, step, device)


def _rank():
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _restore_per_rank(ckpt_dir, state, ev_stream, device, init):
    """Resume when every rank holds its own state → (state, step or
    None): each rank restores the newest readable step of its own
    directory (quarantining an unreadable one), the world takes the
    oldest of those steps, and a rank ahead of it restores that step
    instead; where some rank has none, every rank starts afresh
    (``init()`` on a rank that had restored in place)."""
    import torch.distributed as dist

    restored, step = state, None
    if checkpointing.list_steps(ckpt_dir):
        with obs_trace.span("restore") as sp:
            got, step = checkpointing.restore_latest(
                ckpt_dir, state, events=ev_stream,
            )
            if step is not None:
                sp.set(step=step)
                restored = got
    agreed = torch.tensor([-1 if step is None else step], device=device)
    dist.all_reduce(agreed, op=dist.ReduceOp.MIN)
    agreed = int(agreed.item())
    if agreed < 0:
        return (init() if step is not None else state), None
    if agreed != step:
        restored = checkpointing.restore(ckpt_dir, agreed, restored)
    return restored, agreed


def _shard_dir(ckpt_dir, mesh):
    """(this rank's shard directory, whether it writes): ``tp_<t>_ep_<e>``
    under ``ckpt_dir`` by the rank's mesh coordinates; the ranks of dp and
    sp index 0 write."""
    tp_index = data_parallel.axis(mesh, "tp")[0]
    ep_index = data_parallel.axis(mesh, "ep")[0]
    writer = all(data_parallel.axis(mesh, name)[0] == 0
                 for name in data_parallel.DATA_AXES)
    return os.path.join(ckpt_dir, f"tp_{tp_index}_ep_{ep_index}"), writer


def _restore_sharded(ckpt_dir, state, ev_stream, device, mesh, writer,
                     init):
    """Resume when the ranks hold shards → (state, step or None): each
    writer restores the newest readable step of its shard directory, the
    world takes the oldest of the writers' steps (a writer ahead of it
    restores that step instead; where a writer has none, every rank
    starts afresh), and each writer's state goes to its dp and sp
    groups."""
    import torch.distributed as dist

    restored, step = state, None
    if writer and checkpointing.list_steps(ckpt_dir):
        with obs_trace.span("restore") as sp:
            got, step = checkpointing.restore_latest(
                ckpt_dir, state, events=ev_stream,
            )
            if step is not None:
                sp.set(step=step)
                restored = got
    mine = (-1 if step is None else step) if writer else 2 ** 62
    agreed = torch.tensor([mine], device=device)
    dist.all_reduce(agreed, op=dist.ReduceOp.MIN)
    agreed = int(agreed.item())
    if agreed < 0:
        return (init() if step is not None else state), None
    if writer and agreed != step:
        restored = checkpointing.restore(ckpt_dir, agreed, restored)
    for group in data_parallel.data_groups(mesh):
        restored, _ = checkpointing.broadcast(restored, agreed, device,
                                              group=group)
    return restored, agreed


def _train_steps(args, init_state, train_step, make_batch,
                 units_per_step, unit_name, obs, ev_stream, device,
                 n_devices=1, per_rank=False, n_params=None,
                 shard_mesh=None):
    """The step loop proper. Each step's time is host wall clock from
    before the fault hook to the loss read, which waits for the
    device."""
    with obs_trace.span("init_state"):
        state = init_state(args.seed)
    obs.calibrate(state, device, n_devices, n_params)
    start = 0
    ckpt_dir = args.checkpoint_dir
    writer = per_rank or _is_leader()
    if ckpt_dir and per_rank:
        ckpt_dir = os.path.join(ckpt_dir, f"stage_{_rank()}")
    if ckpt_dir and shard_mesh is not None:
        ckpt_dir, writer = _shard_dir(ckpt_dir, shard_mesh)
    if ckpt_dir:
        # Crash-safe resume: newest readable step wins; an unreadable
        # one is quarantined (checkpoint_fallback event) and the walk
        # falls back — never a crash loop.
        if per_rank:
            restored, step = _restore_per_rank(
                ckpt_dir, state, ev_stream, device,
                lambda: init_state(args.seed))
        elif shard_mesh is not None:
            restored, step = _restore_sharded(
                ckpt_dir, state, ev_stream, device, shard_mesh, writer,
                lambda: init_state(args.seed))
        else:
            restored, step = _restore(ckpt_dir, state, ev_stream, device)
        if step is not None:
            state = restored
            start = step
            log.info("resumed from %s step %d", ckpt_dir, step)
    losses = []
    for step in range(start, args.steps):
        batch = make_batch(step)
        t0 = time.perf_counter()
        # Armed-plan injection point (free no-op when disarmed): a
        # straggler sleeps here, a wedge/preemption raises out of the
        # loop into the supervisor's restart path.
        faults.fire("train.step", step=step)
        with obs_trace.span("step", step=step) as sp:
            state, loss = train_step(state, batch)
            losses.append(float(loss))
            sp.set(loss=losses[-1])
        dt = time.perf_counter() - t0
        obs.observe_step(dt, losses[-1])
        supervisor.beat(step)
        if ev_stream is not None:
            ev_stream.emit(
                "train_step", step=step, dur_s=round(dt, 6),
                loss=losses[-1],
            )
        log.info("step %d loss %.4f (%.0f %s/s)", step, losses[-1],
                 units_per_step / dt, unit_name)
        done = step + 1
        if ckpt_dir and (
            done % args.checkpoint_every == 0 or done == args.steps
        ):
            # Every rank holds the same state: rank 0 writes it (each
            # rank its own, per rank; each shard's dp and sp index 0
            # rank its shard's), and no rank steps on before the step
            # directory is whole.
            if writer:
                with obs_trace.span("checkpoint", step=done):
                    checkpointing.save(ckpt_dir, done, state)
            _barrier()
    return {
        "loss": losses[-1] if losses else None,
        "start_step": start,
        "steps_run": len(losses),
        **obs.summary(),
    }


def _world(mesh):
    return 1 if mesh is None else mesh.size()


def run_mnist(args, device, mesh=None):
    from container_engine_accelerators_tpu_torch.models import mnist

    init_state, train_step = mnist.make_train_step(device=device, mesh=mesh)
    batch_size = args.batch_size or 64 * _dp(mesh)

    def make_batch(step):
        return mnist.synthetic_batch(
            np.random.default_rng(args.seed + 1 + step), batch_size,
            device=device)

    result = _train_loop(args, init_state, train_step, make_batch,
                         batch_size, "ex", device, _world(mesh))
    return {**result, "batch_size": batch_size}


def run_resnet(args, device, mesh=None):
    from container_engine_accelerators_tpu_torch.models import resnet

    image_size = args.image_size
    init_state, train_step = resnet.make_train_step(
        lambda: resnet.resnet18_ish(device=device), mesh=mesh)
    batch_size = args.batch_size or 8 * _dp(mesh)

    def make_batch(step):
        rng = np.random.default_rng(args.seed + 1 + step)
        images = rng.standard_normal(
            (batch_size, image_size, image_size, 3), dtype="float32")
        return {"images": torch.as_tensor(images, device=device),
                "labels": torch.as_tensor(rng.integers(0, 10, batch_size),
                                          device=device)}

    result = _train_loop(args, init_state, train_step, make_batch,
                         batch_size, "im", device, _world(mesh))
    return {**result, "batch_size": batch_size}


def config_from_args(args):
    return tf.TransformerConfig(
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        n_layers=args.n_layers,
        n_heads=args.n_heads,
        n_kv_heads=max(args.n_heads // 2, 1),
        d_ff=args.d_model * 3,
        max_seq_len=args.seq_len,
        dtype=args.dtype,
        n_experts=args.n_experts,
    )


def _sharded(mesh):
    """``mesh`` when it has a tp or ep axis above 1 (the ranks then hold
    shards), else None."""
    sizes = tf.axis_sizes(mesh)
    return mesh if sizes.get("tp", 1) > 1 or sizes.get("ep", 1) > 1 \
        else None


def run_transformer(args, device, mesh=None):
    from container_engine_accelerators_tpu_torch.models import tp_lm

    cfg = config_from_args(args)
    if args.pp > 1:
        return _run_transformer_pp(args, device, mesh, cfg)
    init_state, train_step = tf.make_train_step(cfg, device=device,
                                                mesh=mesh)
    batch_size = args.batch_size or 2 * _dp(mesh)

    def make_batch(step):
        rng = np.random.default_rng(args.seed + 1 + step)
        tokens = rng.integers(0, cfg.vocab_size,
                              (batch_size, args.seq_len + 1))
        return {"tokens": torch.as_tensor(tokens, device=device)}

    result = _train_loop(args, init_state, train_step, make_batch,
                         batch_size * args.seq_len, "tok", device,
                         _world(mesh), n_params=tp_lm.n_params(cfg),
                         shard_mesh=_sharded(mesh))
    return {**result, "batch_size": batch_size}


def _run_transformer_pp(args, device, mesh, cfg):
    """Pipeline-parallel transformer training (1F1B,
    ``models/pipeline_lm.py``) over the world's "pp" mesh, this rank's
    stage moving activations and cotangents point to point. The batch is
    M microbatches of ``--batch-size`` sequences (M = ``--microbatches``,
    default 2·pp so the bubble stays at most 1/3, as in JAX)."""
    from container_engine_accelerators_tpu_torch.models import pipeline_lm
    from container_engine_accelerators_tpu_torch.parallel import (
        ring_attention,
    )

    transport = ring_attention.P2P(ring_attention.ring_of(mesh, "pp"))
    init_state, train_step = pipeline_lm.make_pp_train_step(
        cfg, transport, device=device)
    num_micro = args.microbatches or 2 * args.pp
    mb = args.batch_size or 2
    per_layer = sum(p.numel() for p in tf.DecoderLayer(cfg, "meta")
                    .parameters())
    n_params = cfg.n_layers * per_layer + (cfg.vocab_size + 1) * cfg.d_model

    def make_batch(step):
        rng = np.random.default_rng(args.seed + 1 + step)
        tokens = rng.integers(0, cfg.vocab_size,
                              (num_micro, mb, args.seq_len + 1))
        return {"tokens": torch.as_tensor(tokens, device=device)}

    result = _train_loop(args, init_state, train_step, make_batch,
                         num_micro * mb * args.seq_len, "tok", device,
                         _world(mesh), per_rank=True, n_params=n_params)
    return {**result, "microbatches": num_micro, "microbatch_size": mb}


def run_bert(args, device, mesh=None):
    from container_engine_accelerators_tpu_torch.models import bert

    cfg = bert.BertConfig(
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        n_layers=args.n_layers,
        n_heads=args.n_heads,
        d_ff=args.d_model * 4,
        max_seq_len=args.seq_len,
        dtype=args.dtype,
    )
    init_state, train_step = bert.make_train_step(cfg, device=device,
                                                  mesh=mesh)
    batch_size = args.batch_size or 2 * _dp(mesh)

    def make_batch(step):
        return bert.synthetic_mlm_batch(
            np.random.default_rng(args.seed + 1 + step), batch_size, cfg,
            device=device)

    result = _train_loop(args, init_state, train_step, make_batch,
                         batch_size * cfg.max_seq_len, "tok", device,
                         _world(mesh), n_params=sum(
                             p.numel() for p in
                             bert.Bert(cfg, "meta").parameters()),
                         shard_mesh=_sharded(mesh))
    return {**result, "batch_size": batch_size}


RUNNERS = {
    "mnist": run_mnist,
    "resnet": run_resnet,
    "transformer": run_transformer,
    "bert": run_bert,
}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", choices=sorted(RUNNERS), default="mnist")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=0,
                   help="global batch; 0 = the JAX CLI's default per dp "
                        "rank (mnist 64, resnet 8, bert and transformer "
                        "2) times the mesh's dp size")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel axis size (transformer and bert "
                        "shard over it; mnist and resnet replicate)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel axis size (the transformer's "
                        "--n-experts shard over it)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stage count (transformer only; "
                        "1F1B schedule, n_layers must divide over it; "
                        "exclusive with --sp/--tp/--ep; one stage a rank "
                        "of a --distributed world of this size)")
    p.add_argument("--microbatches", type=int, default=0,
                   help="pipeline microbatch count M (0 = 2*pp)")
    p.add_argument("--n-experts", type=int, default=0,
                   help="transformer: replace dense FFNs with an MoE of "
                        "this many experts (sharded over --ep)")
    p.add_argument("--distributed", action="store_true",
                   help="join the world from the TPU_WORKER_* env, one "
                        "process per device (LOCAL_RANK / "
                        "LOCAL_WORLD_SIZE); implied when TPU_WORKER_ID "
                        "is set")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--vocab-size", type=int, default=1024)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float16", "float32"])
    p.add_argument("--checkpoint-dir", default="",
                   help="save/resume train state here (step_<N>/ "
                        "directories of torch.save'd state_dicts); on "
                        "start, the newest readable step is restored and "
                        "training continues from it")
    p.add_argument("--checkpoint-every", type=int, default=50,
                   help="checkpoint period in steps (the final step is "
                        "always saved when --checkpoint-dir is set)")
    p.add_argument("--watchdog-s", type=float, default=0.0,
                   help="step watchdog: no step within this many seconds "
                        "restarts the run from the latest checkpoint "
                        "(supervisor.py; 0 = off)")
    p.add_argument("--max-restarts", type=int, default=0,
                   help="restart a crashed/wedged run up to this many "
                        "times with escalating jittered backoff, resuming "
                        "from --checkpoint-dir")
    p.add_argument("--restart-backoff-s", type=float, default=1.0,
                   help="base of the escalating restart backoff")
    p.add_argument("--restart-backoff-reset-steps", type=int, default=50,
                   help="reset the backoff exponent after an attempt "
                        "sustains this many healthy steps (0 = never)")
    p.add_argument("--compile-cache-dir", default="",
                   help="arm the persistent compile cache under this "
                        "stack-owned directory (warmstart/cache.py; "
                        "keyed by topology + model config): the kernel "
                        "builds (nvcc libraries, Triton specialisations) "
                        "land there, so a supervisor resume or a "
                        "re-launched run reuses them instead of "
                        "rebuilding; hits/misses land in "
                        "tpu_compile_cache_{hits,misses}_total")
    p.add_argument("--fault-plan", default="",
                   help="arm a fault-injection plan (faults/plan.py JSON) "
                        "whose faults fire at the scripted train.step hits")
    p.add_argument("--profile-dir", default="",
                   help="capture a torch.profiler trace of the run into "
                        "this directory (utils/profiling.py)")
    p.add_argument("--trace-out", default="",
                   help="write a Chrome trace-event JSON of per-step host "
                        "spans here; JSONL twin at <path>.jsonl")
    p.add_argument("--event-log", default="",
                   help="append one structured JSONL event per train step "
                        "to this file (obs/events.py schema); also adds "
                        "the goodput summary (obs/goodput.py) to the "
                        "result JSON")
    p.add_argument("--alert-rules", default="",
                   help="arm the burn-rate alert evaluator (obs/alerts.py) "
                        "with this JSON rule file over the run's registry")
    p.add_argument("--alerts-out", default="",
                   help="append alert_fired/alert_resolved events to this "
                        "JSONL file (with --alert-rules)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve the training workload /metrics on this port "
                        f"(convention: {obs_ports.WORKLOAD_METRICS_PORT}; "
                        "0 = off)")
    p.add_argument("--flight-recorder", action="store_true",
                   help="arm the flight recorder (obs/flight.py) over the "
                        "run's registry and event stream: a watchdog "
                        "fire or supervisor restart dumps a postmortem "
                        "bundle")
    p.add_argument("--flight-window-s", type=float,
                   default=obs_flight.DEFAULT_WINDOW_S,
                   help="flight-recorder ring depth in seconds")
    p.add_argument("--flight-dir", default="/tmp/tpu-flight",
                   help="directory postmortem bundles are dumped into")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions (tests). Without a GPU the default fails.")
    return p


def _check_pp(parser, args):
    """JAX's checks of ``--pp`` before any world is joined."""
    if args.pp > 1:
        if args.sp > 1 or args.tp > 1 or args.ep > 1:
            parser.error("--pp is exclusive with --sp/--tp/--ep")
        if args.model != "transformer":
            parser.error("--pp supports --model transformer only")


def _check_pp_world(parser, args, world):
    """``--pp`` against the world: JAX's error for too few devices; the
    port runs one stage a rank, so a larger world is refused too (JAX
    would take its first N devices)."""
    if args.pp > world:
        parser.error(f"--pp={args.pp} needs {args.pp} devices, have {world}")
    if args.pp > 1 and args.pp != world:
        parser.error(f"--pp={args.pp} runs one stage a rank: it needs a "
                     f"world of {args.pp} ranks, have {world}")


def _join(args, parser):
    """(device, mesh): without ``--distributed`` (or TPU_WORKER_ID) the
    requested device and no mesh, the sizes checked against a world of
    one as JAX's ``plan_mesh`` checks them; with it the world joined
    from the env contract and its ``build_mesh`` over every rank (a
    "pp" mesh under ``--pp``)."""
    if not (args.distributed or os.environ.get(bootstrap.WORKER_ID_ENV)):
        _check_pp_world(parser, args, 1)
        axes = {"dp": -1, "sp": args.sp, "tp": args.tp}
        if args.ep > 1:
            axes["ep"] = args.ep
        pmesh.plan_mesh(1, axes)
        return tf.resolve_device(args.device), None
    opts = bootstrap.initialize_from_env(device=args.device)
    log.info("process group initialized: %s", opts)
    device = torch.device(opts["device"])
    world = opts["world_size"]
    _check_pp_world(parser, args, world)
    if args.pp > 1:
        return device, pmesh.make_mesh(pmesh.plan_mesh(world, {"pp": world}),
                                       device.type)
    return device, build_mesh(world, args.sp, args.tp, args.ep,
                              device_type=device.type)


# The args JAX's train_cli keys its compile cache by.
CACHE_KEY_ARGS = ("model", "batch_size", "seq_len", "d_model", "n_layers",
                  "n_heads", "vocab_size", "dtype", "sp", "tp", "ep", "pp",
                  "n_experts", "image_size")


def _configure_compile_cache(args, device, mesh):
    """Arm ``--compile-cache-dir`` keyed as JAX's train_cli keys it:
    ``{n}x{platform}`` over the world's devices and the 14 args."""
    platform = "gpu" if device.type == "cuda" else device.type
    key = ws_cache.cache_key(
        topology=f"{_world(mesh)}x{platform}",
        cfg={k: getattr(args, k) for k in CACHE_KEY_ARGS},
    )
    return ws_cache.configure_from_flag(
        args.compile_cache_dir, key=key, sink_path=args.event_log,
    )


def _goodput(event_log):
    """The JAX CLI's end-of-run goodput block over the run's own event
    log (telemetry only: never fails the run)."""
    try:
        summary, _ = obs_goodput.report_files([event_log])
    except Exception as err:  # noqa: BLE001 - telemetry only
        log.warning("goodput summary skipped: %s", err, exc_info=True)
        return None
    return {
        "ratio": summary["total"]["goodput_ratio"],
        "badput_s": {
            c: v for c, v in summary["total"]["seconds"].items()
            if c != "productive" and v > 0
        },
    }


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    parser = build_parser()
    args = parser.parse_args(argv)
    _check_pp(parser, args)
    device, mesh = _join(args, parser)
    log.info("device=%s mesh=%s", device,
             dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
             if mesh is not None else None)
    armed = tracer = None
    try:
        if args.compile_cache_dir:
            _configure_compile_cache(args, device, mesh)
        if args.fault_plan:
            armed = faults.arm_from_flag(args.fault_plan,
                                         sink_path=args.event_log)
            log.warning("fault plan armed from %s (seed %d, %d faults)",
                        args.fault_plan, armed.seed, len(armed.faults))
        if args.trace_out:
            tracer = obs_trace.configure()
        t0 = time.perf_counter()
        with profiling.trace_or_null(args.profile_dir):
            if args.watchdog_s or args.max_restarts:
                # Supervised run: each restart re-enters the runner,
                # whose loop resumes from the latest --checkpoint-dir
                # step (without one a restart re-runs from step 0).
                if not args.checkpoint_dir:
                    log.warning(
                        "supervised run without --checkpoint-dir: "
                        "restarts re-run from step 0")
                sup_events = obs_events.EventStream(
                    supervisor.EVENT_SOURCE, sink_path=args.event_log)
                result = supervisor.supervise(
                    lambda: RUNNERS[args.model](args, device, mesh),
                    watchdog_s=args.watchdog_s,
                    max_restarts=args.max_restarts,
                    backoff_base_s=args.restart_backoff_s,
                    backoff_reset_steps=args.restart_backoff_reset_steps,
                    seed=args.seed, events=sup_events,
                )
            else:
                result = RUNNERS[args.model](args, device, mesh)
    finally:
        if tracer is not None:
            tracer.write_chrome(args.trace_out)
            tracer.write_jsonl(args.trace_out + ".jsonl")
            obs_trace.configure(enabled=False)
            log.info("span trace written to %s (+ .jsonl)", args.trace_out)
        if armed is not None:
            faults.disarm()
        if args.compile_cache_dir:
            ws_cache.deactivate()
        if mesh is not None:
            # An in-process run leaves no process group behind.
            import torch.distributed as dist

            dist.destroy_process_group()
    result.update(
        model=args.model,
        steps=args.steps,
        n_devices=_world(mesh),
        wall_s=round(time.perf_counter() - t0, 2),
    )
    if args.event_log:
        goodput = _goodput(args.event_log)
        if goodput is not None:
            result["goodput"] = goodput
    if args.profile_dir:
        result["profile_dir"] = args.profile_dir
    if args.trace_out:
        result["trace_out"] = args.trace_out
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
