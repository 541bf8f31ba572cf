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
versions; the tests run so). Not ported yet (ROADMAP.md): multi-GPU
training (``--sp``, ``--tp``, ``--ep``, ``--pp``, ``--microbatches``
above 1 and ``--distributed`` raise) and ``--compile-cache-dir`` (the
port has no compile cache).
"""

import argparse
import json
import logging
import sys
import time

import numpy as np
import torch

from container_engine_accelerators_tpu_torch import faults
from container_engine_accelerators_tpu_torch.models import supervisor
from container_engine_accelerators_tpu_torch.models import transformer as tf
from container_engine_accelerators_tpu_torch.obs import alerts as obs_alerts
from container_engine_accelerators_tpu_torch.obs import events as obs_events
from container_engine_accelerators_tpu_torch.obs import flight as obs_flight
from container_engine_accelerators_tpu_torch.obs import goodput as obs_goodput
from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics
from container_engine_accelerators_tpu_torch.obs import ports as obs_ports
from container_engine_accelerators_tpu_torch.obs import trace as obs_trace
from container_engine_accelerators_tpu_torch.utils import (
    checkpointing,
    profiling,
)

log = logging.getLogger("train_cli")

# The card the port targets and its dense bf16 tensor-core peak (NVIDIA's
# H100 SXM data sheet); est_mfu is 0 on any other card and on the CPU.
PEAK_CARD = "NVIDIA H100 80GB HBM3"
PEAK_BF16_FLOPS = 989e12

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
    """The card's dense bf16 peak: PEAK_BF16_FLOPS on PEAK_CARD, else 0."""
    if device.type == "cuda" and \
            torch.cuda.get_device_name(device) == PEAK_CARD:
        return PEAK_BF16_FLOPS
    return 0.0


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

    def calibrate(self, state, device):
        self._n_params = _count_params(state)
        self._peak_flops = peak_flops(device)

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


def _train_loop(args, init_state, train_step, make_batch, units_per_step,
                unit_name, device):
    """Shared step loop: init (or resume from --checkpoint-dir), run to
    --steps with periodic checkpoints, return the result dict. Every
    step is a trace span and an observation into the run's TrainMetrics
    registry."""
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
                            device)
    finally:
        if alert_ev is not None:
            alert_ev.close()
        if recorder is not None:
            recorder.close()
            obs_flight.deactivate()
        if server is not None:
            server.close()


def _train_steps(args, init_state, train_step, make_batch,
                 units_per_step, unit_name, obs, ev_stream, device):
    """The step loop proper. Each step's time is host wall clock from
    before the fault hook to the loss read, which waits for the
    device."""
    with obs_trace.span("init_state"):
        state = init_state(args.seed)
    obs.calibrate(state, device)
    start = 0
    ckpt_dir = args.checkpoint_dir
    if ckpt_dir and checkpointing.list_steps(ckpt_dir):
        # Crash-safe resume: newest readable step wins; an unreadable
        # one is quarantined (checkpoint_fallback event) and the walk
        # falls back — never a crash loop.
        with obs_trace.span("restore") as sp:
            restored, step = checkpointing.restore_latest(
                ckpt_dir, state, events=ev_stream,
            )
            if step is not None:
                sp.set(step=step)
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
            with obs_trace.span("checkpoint", step=done):
                checkpointing.save(ckpt_dir, done, state)
    return {
        "loss": losses[-1] if losses else None,
        "start_step": start,
        "steps_run": len(losses),
        **obs.summary(),
    }


def run_mnist(args, device):
    from container_engine_accelerators_tpu_torch.models import mnist

    init_state, train_step = mnist.make_train_step(device=device)
    batch_size = args.batch_size or 64

    def make_batch(step):
        return mnist.synthetic_batch(
            np.random.default_rng(args.seed + 1 + step), batch_size,
            device=device)

    result = _train_loop(args, init_state, train_step, make_batch,
                         batch_size, "ex", device)
    return {**result, "batch_size": batch_size}


def run_resnet(args, device):
    from container_engine_accelerators_tpu_torch.models import resnet

    image_size = args.image_size
    init_state, train_step = resnet.make_train_step(
        lambda: resnet.resnet18_ish(device=device))
    batch_size = args.batch_size or 8

    def make_batch(step):
        rng = np.random.default_rng(args.seed + 1 + step)
        images = rng.standard_normal(
            (batch_size, image_size, image_size, 3), dtype="float32")
        return {"images": torch.as_tensor(images, device=device),
                "labels": torch.as_tensor(rng.integers(0, 10, batch_size),
                                          device=device)}

    result = _train_loop(args, init_state, train_step, make_batch,
                         batch_size, "im", device)
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


def run_transformer(args, device):
    cfg = config_from_args(args)
    init_state, train_step = tf.make_train_step(cfg, device=device)
    batch_size = args.batch_size or 2

    def make_batch(step):
        rng = np.random.default_rng(args.seed + 1 + step)
        tokens = rng.integers(0, cfg.vocab_size,
                              (batch_size, args.seq_len + 1))
        return {"tokens": torch.as_tensor(tokens, device=device)}

    result = _train_loop(args, init_state, train_step, make_batch,
                         batch_size * args.seq_len, "tok", device)
    return {**result, "batch_size": batch_size}


def run_bert(args, device):
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
    init_state, train_step = bert.make_train_step(cfg, device=device)
    batch_size = args.batch_size or 2

    def make_batch(step):
        return bert.synthetic_mlm_batch(
            np.random.default_rng(args.seed + 1 + step), batch_size, cfg,
            device=device)

    result = _train_loop(args, init_state, train_step, make_batch,
                         batch_size * cfg.max_seq_len, "tok", device)
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
                   help="global batch; 0 = the JAX CLI's default on one "
                        "device (mnist 64, resnet 8, bert and transformer "
                        "2)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--ep", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--microbatches", type=int, default=0)
    p.add_argument("--n-experts", type=int, default=0,
                   help="transformer: replace dense FFNs with an MoE of "
                        "this many experts (all on the one device)")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--vocab-size", type=int, default=1024)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
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


def _refuse_multi_gpu(args):
    parallel = {"--sp": args.sp, "--tp": args.tp, "--ep": args.ep,
                "--pp": args.pp, "--microbatches": args.microbatches}
    asked = [f"{flag} {n}" for flag, n in parallel.items() if n > 1]
    if args.distributed:
        asked.append("--distributed")
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: not ported yet (multi-GPU); the port "
            f"trains on one device (ROADMAP.md)")


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
    args = build_parser().parse_args(argv)
    _refuse_multi_gpu(args)
    device = tf.resolve_device(args.device)
    log.info("device=%s", device)
    armed = tracer = None
    if args.fault_plan:
        armed = faults.arm_from_flag(args.fault_plan,
                                     sink_path=args.event_log)
        log.warning("fault plan armed from %s (seed %d, %d faults)",
                    args.fault_plan, armed.seed, len(armed.faults))
    if args.trace_out:
        tracer = obs_trace.configure()
    t0 = time.perf_counter()
    try:
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
                    lambda: RUNNERS[args.model](args, device),
                    watchdog_s=args.watchdog_s,
                    max_restarts=args.max_restarts,
                    backoff_base_s=args.restart_backoff_s,
                    backoff_reset_steps=args.restart_backoff_reset_steps,
                    seed=args.seed, events=sup_events,
                )
            else:
                result = RUNNERS[args.model](args, device)
    finally:
        if tracer is not None:
            tracer.write_chrome(args.trace_out)
            tracer.write_jsonl(args.trace_out + ".jsonl")
            obs_trace.configure(enabled=False)
            log.info("span trace written to %s (+ .jsonl)", args.trace_out)
        if armed is not None:
            faults.disarm()
    result.update(
        model=args.model,
        steps=args.steps,
        n_devices=1,
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
