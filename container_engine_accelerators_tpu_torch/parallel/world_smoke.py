# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Ring attention, the sharded train step and the pipeline-parallel
step in a real world of N processes, one per device, held to one
device.

    python -m container_engine_accelerators_tpu_torch.parallel.world_smoke \\
        --world 4
    python -m container_engine_accelerators_tpu_torch.parallel.world_smoke \\
        --world 2 --device cpu --seq 256 --heads 4 2 --head-dim 32 \\
        --train-seq 64 --train-d-model 64

Starts ``--world`` ranks of itself, each joining through the stack's env
contract (``parallel/bootstrap.py``: ``TPU_WORKER_ID`` 0,
``TPU_WORKER_HOSTNAMES`` localhost, a free ``TPU_COORDINATOR_PORT``,
``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``): NCCL on ``cuda:{LOCAL_RANK}``,
gloo under ``--device cpu``. Then, on every rank:

  ring   the flash ring (``RingFlash``, what ``ring_attention`` runs)
         over an sp ring of all the ranks at Llama-3-8B's attention
         widths (B 1, 32/8 heads, D 128, bf16, causal, S 32768 by
         default): each rank's shard of q, k, v and the cotangent from
         one seed, the forward and the backward timed with the
         transport, the output, lse and q/k/v gradients gathered on rank
         0 and held to the whole-sequence flash kernels there by
         :func:`ring_errors` under ``RING_TOL``;
  train  the transformer's train step (f32, AdamW, remat) under each
         mesh the world factors into (sp = world; dp 2 × sp world / 2
         where it divides), two steps on the global batches, losses and
         rank 0's parameters held to the same steps on one device (rank
         0, no mesh), every rank's parameters equal;
  pp     the pipeline-parallel step (``models/pipeline_lm.py``: 1F1B
         over point-to-point transfers on a "pp" mesh of all the ranks,
         one stage a rank, 2 layers a stage, 2 × world microbatches of
         one sequence, f32) against the unsplit ``make_train_step`` on
         one device on the same weights and the flattened batch: the
         loss, and every gradient of each rank's stage and of the
         embedding and final norm (each rank holds its own against the
         unsplit step run on its device); two steps of each timed.

Rank 0 prints one JSON line per check, with the card's name and power
limit on CUDA, then ``{"ok": true, ...}``; any miss exits non-zero.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

# The assembled bf16 flash ring against the whole-sequence flash kernels,
# here over N processes and in chip_smoke.py's ring phase on one card
# (both through ring_errors): out elementwise and lse as a bf16 flash
# kernel is held to its plain version (1e-2 + 1e-2 |out|; 1e-4); out,
# dq, dk and dv also by relative L2 and worst row at twice the bf16
# backward kernels' limits (5e-3, 1e-2): the ring rounds each of its N
# block results to bf16 before the f32 combine or sum, N + 1 roundings
# where the whole sequence makes one.
RING_TOL = {"out_atol": 1e-2, "out_rtol": 1e-2, "lse_atol": 1e-4,
            "rel_l2": 1e-2, "row": 2e-2}
# The sharded train step against one device, both f32: losses to 1e-5
# (the CPU parity tests' bound); after AdamW steps a parameter moves by
# about lr · sign(m / sqrt(v)) a step, so an entry whose gradient is near
# eps may move differently: 2 · lr.
TRAIN_LOSS_ATOL = 1e-5
TRAIN_PARAM_ATOL = 2 * 3e-4
TRAIN_STEPS = 2
# The pp step's gradients against the unsplit step's, both f32 and
# summed in other orders (per microbatch, then over the microbatches):
# each gradient's largest error within 1e-4 of its largest entry.
PP_GRAD_RTOL = 1e-4


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, power = [s.strip() for s in out.split(",", 1)]
    return {"gpu": name, "power_limit": power}


def _emit(rank, obj):
    if rank == 0:
        print(json.dumps(obj), flush=True)


def _timed(torch, device, fn):
    """(result, ms) of fn(), device-synchronized."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def _gather(dist, torch, t, world):
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=2)


def rel_errors(got, ref):
    """(largest |got - ref|, ||got - ref|| / ||ref||, worst row). Rows lie
    along the last axis; the worst row is the largest ||got_r - ref_r|| /
    (||ref_r|| + m), m the median norm of the nonzero rows of ref, so a
    row is held to its own scale and a row that cancels to about 0 to
    the typical one."""
    got, ref = got.float(), ref.float()
    diff = got - ref
    rel_l2 = (diff.norm() / ref.norm().clamp_min(1e-30)).item()
    rows = ref.norm(dim=-1)
    nonzero = rows[rows > 0]
    typical = nonzero.median() if nonzero.numel() else rows.new_zeros(())
    worst = (diff.norm(dim=-1) / (rows + typical).clamp_min(1e-30)).max()
    return diff.abs().max().item(), rel_l2, worst.item()


def ring_errors(got, want):
    """The assembled ring's out, lse, dq, dk and dv (``got``, a dict of
    whole-sequence tensors) against the whole sequence's (``want``) →
    (errors, whether all are within RING_TOL)."""
    tol = RING_TOL
    ref = want["out"].float()
    diff = (got["out"].float() - ref).abs()
    ok = bool((diff <= tol["out_atol"] + tol["out_rtol"] * ref.abs()).all())
    errs = {"lse_max_abs_err": (got["lse"] - want["lse"]).abs().max().item()}
    ok = ok and errs["lse_max_abs_err"] <= tol["lse_atol"]
    for name in ("out", "dq", "dk", "dv"):
        max_abs, rel_l2, row = rel_errors(got[name], want[name])
        errs.update({f"{name}_max_abs_err": max_abs,
                     f"{name}_rel_l2": rel_l2, f"{name}_worst_row": row})
        ok = ok and rel_l2 <= tol["rel_l2"] and row <= tol["row"]
    return errs, ok


def check_ring(args, torch, dist, device, rank, world, card):
    """The flash ring over all the ranks against the whole sequence."""
    from container_engine_accelerators_tpu_torch.models import train_cli
    from container_engine_accelerators_tpu_torch.ops import attention
    from container_engine_accelerators_tpu_torch.parallel import (
        ring_attention,
    )

    hq, hkv = args.heads
    seq, d = args.seq, args.head_dim
    mesh = train_cli.build_mesh(world, world, 1, device_type=device.type)
    ring = ring_attention.ring_of(mesh, "sp")
    gen = torch.Generator(device=device).manual_seed(16)

    def rand(h):
        return torch.randn(1, h, seq, d, generator=gen,
                           device=device).to(torch.bfloat16)

    q, k, v, g = rand(hq), rand(hkv), rand(hkv), rand(hq)
    sl = seq // world
    shards = [x[:, :, rank * sl:(rank + 1) * sl].contiguous()
              .requires_grad_() for x in (q, k, v)]
    g_local = g[:, :, rank * sl:(rank + 1) * sl].contiguous()
    fwd_ms, bwd_ms = [], []
    for _ in range(args.repeats + 1):
        for x in shards:
            x.grad = None
        dist.barrier()
        (out, lse), ms = _timed(
            torch, device, lambda: ring_attention.RingFlash.apply(
                *shards, ring, True, d ** -0.5))
        fwd_ms.append(ms)
        dist.barrier()
        _, ms = _timed(torch, device, lambda: out.backward(g_local))
        bwd_ms.append(ms)
    got = {"out": _gather(dist, torch, out.detach(), world),
           "lse": _gather(dist, torch, lse, world),
           **{name: _gather(dist, torch, x.grad, world)
              for name, x in zip(("dq", "dk", "dv"), shards)}}
    # Each rank's median of the timed runs (the first builds and warms):
    # a rank waits only for the transfers it receives, so the ring's wall
    # is the slowest rank's.
    mine = torch.tensor([sorted(fwd_ms[1:])[len(fwd_ms[1:]) // 2],
                         sorted(bwd_ms[1:])[len(bwd_ms[1:]) // 2]],
                        dtype=torch.float64, device=device)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    by_rank = torch.stack(every).tolist()
    row = {"check": "ring", **card, "world": world, "seq": seq,
           "heads": [hq, hkv], "d": d, "dtype": "bfloat16",
           "backend": dist.get_backend(),
           "ring_fwd_ms_by_rank": [t[0] for t in by_rank],
           "ring_bwd_ms_by_rank": [t[1] for t in by_rank],
           "ring_fwd_ms": max(t[0] for t in by_rank),
           "ring_bwd_ms": max(t[1] for t in by_rank)}
    ok = True
    if rank == 0:
        kw = dict(causal=True, sm_scale=d ** -0.5)
        (out_w, lse_w), whole_fwd = _timed(
            torch, device, lambda: attention.flash_fwd(q, k, v, **kw))
        grads_w, whole_bwd = _timed(torch, device, lambda: attention.flash_bwd(
            q, k, v, out_w, lse_w, g, **kw))
        errs, ok = ring_errors(got, {"out": out_w, "lse": lse_w,
                                     **dict(zip(("dq", "dk", "dv"),
                                                grads_w))})
        row.update(whole_fwd_ms=whole_fwd, whole_bwd_ms=whole_bwd,
                   tol=RING_TOL, **errs)
        row["ok"] = ok
    _emit(rank, row)
    flag = torch.tensor([0.0 if ok else 1.0], device=device)
    dist.all_reduce(flag)
    return flag.item() == 0


def _train_meshes(world):
    """The (sp, dp) meshes a world factors into: all ranks on the sp
    ring, and dp 2 × sp world / 2 where it divides (a 2×2 dp×sp mesh at
    4)."""
    meshes = [world]
    if world % 2 == 0 and world > 2:
        meshes.append(world // 2)
    return meshes


def check_train(args, torch, dist, device, rank, world, card):
    """The transformer's sharded train step against one device."""
    import numpy as np

    from container_engine_accelerators_tpu_torch.models import train_cli
    from container_engine_accelerators_tpu_torch.models import (
        transformer as tf,
    )

    cfg = tf.TransformerConfig(
        vocab_size=1024, d_model=args.train_d_model, n_layers=2,
        n_heads=8, n_kv_heads=4, d_ff=3 * args.train_d_model,
        max_seq_len=args.train_seq, dtype="float32")
    ok = True
    for sp in _train_meshes(world):
        dp = world // sp
        mesh = train_cli.build_mesh(world, sp, 1, device_type=device.type)
        rng = np.random.default_rng(7)
        batches = [{"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (2 * dp, args.train_seq + 1)),
            device=device)} for _ in range(TRAIN_STEPS)]
        init, step = tf.make_train_step(cfg, device=device, mesh=mesh)
        state = init(seed=0)
        losses, step_ms = [], []
        for batch in batches:
            dist.barrier()
            (state, loss), ms = _timed(torch, device,
                                       lambda: step(state, batch))
            losses.append(loss.item())
            step_ms.append(ms)
        flat = torch.cat([p.detach().reshape(-1) for p in
                          state[0].parameters()])
        every = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(every, flat)
        same = all(torch.equal(every[0], other) for other in every[1:])
        row = {"check": "train", **card, "world": world, "dp": dp, "sp": sp,
               "seq": args.train_seq, "d_model": cfg.d_model,
               "losses": losses, "step_ms": step_ms,
               "replicated": same}
        good = same
        if rank == 0:
            init1, step1 = tf.make_train_step(cfg, device=device)
            ref = init1(seed=0)
            ref_losses = []
            for batch in batches:
                ref, loss = step1(ref, batch)
                ref_losses.append(loss.item())
            ref_flat = torch.cat([p.detach().reshape(-1) for p in
                                  ref[0].parameters()])
            loss_err = max(abs(a - b) for a, b in zip(losses, ref_losses))
            param_err = (flat - ref_flat).abs().max().item()
            row.update(one_device_losses=ref_losses, loss_max_abs_err=loss_err,
                       param_max_abs_err=param_err,
                       tol={"loss": TRAIN_LOSS_ATOL,
                            "param": TRAIN_PARAM_ATOL})
            good = good and loss_err <= TRAIN_LOSS_ATOL and \
                param_err <= TRAIN_PARAM_ATOL
        row["ok"] = good
        _emit(rank, row)
        ok = ok and good
    flag = torch.tensor([0.0 if ok else 1.0], device=device)
    dist.all_reduce(flag)
    return flag.item() == 0


def _pp_grad_error(state, model, rank, world):
    """The worst gradient of this rank's pp stage and of the embedding
    and final norm against the unsplit model's: largest error over the
    largest |gradient|."""
    held, loss_params, _ = state
    per = len(model.layers) // world
    pairs = [(p, q) for layer, ref_layer in zip(
        held[0], model.layers[rank * per:(rank + 1) * per])
        for p, q in zip(layer.parameters(), ref_layer.parameters())]
    pairs += [(loss_params["embed"], model.embed),
              (loss_params["ln_f"], model.ln_f.weight)]
    return max((p.grad - q.grad).abs().max().item()
               / max(q.grad.abs().max().item(), 1e-30) for p, q in pairs)


def check_pp(args, torch, dist, device, rank, world, card):
    """The pipeline-parallel step over all the ranks against one
    device's unsplit step."""
    import numpy as np

    from container_engine_accelerators_tpu_torch.models import pipeline_lm
    from container_engine_accelerators_tpu_torch.models import (
        transformer as tf,
    )
    from container_engine_accelerators_tpu_torch.parallel import (
        mesh as pmesh,
        ring_attention,
    )

    cfg = tf.TransformerConfig(
        vocab_size=1024, d_model=args.train_d_model, n_layers=2 * world,
        n_heads=8, n_kv_heads=4, d_ff=3 * args.train_d_model,
        max_seq_len=args.train_seq, dtype="float32")
    mesh = pmesh.make_mesh(pmesh.plan_mesh(world, {"pp": world}),
                           device.type)
    transport = ring_attention.P2P(ring_attention.ring_of(mesh, "pp"))
    tokens = torch.as_tensor(np.random.default_rng(18).integers(
        0, cfg.vocab_size, (2 * world, 1, args.train_seq + 1)),
        device=device)
    init, step = pipeline_lm.make_pp_train_step(cfg, transport,
                                                device=device)
    state = init(seed=0)
    # The unsplit step on this rank's device, from the same seed.
    init1, step1 = tf.make_train_step(cfg, device=device)
    ref = init1(seed=0)
    batch = {"tokens": tokens}
    flat = {"tokens": tokens.reshape(-1, args.train_seq + 1)}
    pp_ms, unsplit_ms, losses, unsplit_losses = [], [], [], []
    for k in range(2):
        dist.barrier()
        (state, loss), ms = _timed(torch, device, lambda: step(state, batch))
        pp_ms.append(ms)
        (ref, ref_loss), ms = _timed(torch, device, lambda: step1(ref, flat))
        unsplit_ms.append(ms)
        losses.append(loss.item())
        unsplit_losses.append(ref_loss.item())
        if k == 0:
            loss_err = abs(losses[0] - unsplit_losses[0])
            worst = _pp_grad_error(state, ref[0], rank, world)
    mine = torch.tensor([worst, *pp_ms], dtype=torch.float64, device=device)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    by_rank = torch.stack(every).tolist()
    ok = loss_err <= TRAIN_LOSS_ATOL and \
        max(t[0] for t in by_rank) <= PP_GRAD_RTOL
    n = world
    m = tokens.shape[0]
    _emit(rank, {"check": "pp", **card, "world": world,
                 "stages": world, "layers_per_stage": cfg.n_layers // world,
                 "microbatches": m, "seq": args.train_seq,
                 "d_model": cfg.d_model, "dtype": "float32",
                 "backend": dist.get_backend(), "losses": losses,
                 "unsplit_losses": unsplit_losses,
                 "loss_max_abs_err": loss_err,
                 "grad_worst_rel_err_by_rank": [t[0] for t in by_rank],
                 "pp_step_ms_by_rank": [t[1:] for t in by_rank],
                 "pp_step_ms": [max(t[1 + k] for t in by_rank)
                                for k in range(2)],
                 "unsplit_step_ms": unsplit_ms,
                 "timing": "two steps each; the first builds NCCL's "
                           "pair communicators and warms the kernels",
                 "bubble": (2 * n - 2) / (m + 2 * n - 2),
                 "tol": {"loss": TRAIN_LOSS_ATOL, "grad_rel": PP_GRAD_RTOL},
                 "ok": ok})
    flag = torch.tensor([0.0 if ok else 1.0], device=device)
    dist.all_reduce(flag)
    return flag.item() == 0


def run_rank(args):
    """One rank: join, run the checks, leave. Returns the exit code."""
    import torch
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import bootstrap

    if args.device == "cpu":
        torch.set_num_threads(1)
    else:
        # Plain versions and the f32 step without TF32, as the kernels.
        torch.backends.cuda.matmul.allow_tf32 = False
    opts = bootstrap.initialize_from_env(device=args.device)
    device = torch.device(opts["device"])
    rank, world = opts["rank"], opts["world_size"]
    card = _card() if device.type == "cuda" else {}
    try:
        ok = check_ring(args, torch, dist, device, rank, world, card)
        ok = check_train(args, torch, dist, device, rank, world, card) and ok
        ok = check_pp(args, torch, dist, device, rank, world, card) and ok
    finally:
        dist.destroy_process_group()
    _emit(rank, {"ok": ok, "world": world, "backend": opts["backend"],
                 "device": opts["device"], **card})
    return 0 if ok else 1


def launch(args, argv):
    """Start ``--world`` ranks of this module through the env contract
    and wait for them; returns the worst exit code."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "MEGASCALE_", "LOCAL_"))}
    env.update(TPU_WORKER_ID="0", TPU_WORKER_HOSTNAMES="localhost",
               TPU_COORDINATOR_PORT=str(_free_port()),
               LOCAL_WORLD_SIZE=str(args.world))
    procs = [subprocess.Popen(
        [sys.executable, "-m", __spec__.name, *argv, "--rank-process"],
        env={**env, "LOCAL_RANK": str(rank)}) for rank in range(args.world)]
    deadline = time.monotonic() + args.timeout_s
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return max(proc.returncode for proc in procs)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seq", type=int, default=32768)
    p.add_argument("--heads", type=int, nargs=2, default=[32, 8],
                   metavar=("HQ", "HKV"))
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--repeats", type=int, default=3,
                   help="timed ring forward/backward runs after the first")
    p.add_argument("--train-seq", type=int, default=2048)
    p.add_argument("--train-d-model", type=int, default=256)
    p.add_argument("--timeout-s", type=float, default=600.0)
    p.add_argument("--rank-process", action="store_true",
                   help=argparse.SUPPRESS)
    return p


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    if args.rank_process:
        return run_rank(args)
    return launch(args, argv)


if __name__ == "__main__":
    sys.exit(main())
