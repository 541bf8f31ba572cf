# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Ring attention, the sharded train step, the pipeline-parallel step
and the tensor- and expert-parallel steps in a real world of N
processes, one per device, held to one device.

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
         unsplit step run on its device); two steps of each timed;
  tp     the tensor-parallel step (``models/tp_lm.py``, f32, 2 layers,
         8/4 heads) on a tp mesh of all the ranks, its ring path and its
         off path, and at 4 ranks the ring on a dp 2 × tp 2 mesh: the
         loss and every gradient merged from the shards (gathered over
         the tp group) against the unsplit step on each rank's device;
         with ``--full-width`` (the default on CUDA) then both paths at
         Llama-3-8B's widths (d 4096, 32/8 heads, d_ff 14336, vocab
         128256; 4 layers, B 1 × S 4096, bf16), three steps each, held
         to the unsplit step by ``wide_verdict`` and timed beside it;
  ep     the expert-parallel MoE step (2 layers, 2 experts a rank,
         top-2) on an ep mesh of all the ranks against the unsplit MoE
         step the same way; with ``--full-width`` then at Mixtral-8x7B's
         widths (8 experts, top-2, vocab 32000, 2 layers) in bf16 as the
         tp step is.

Not run unless named in ``--checks``:

  collectives  every op of ``collectives/bench.py`` over the world's
         1-D mesh and its dcn 2 × x hybrid mesh, each rank's output held
         to its plain expectation on the device (``_op_errors``); then
         the launcher runs the collectives CLI as ``--world`` processes:
         every collective from ``--collective-min`` to
         ``--collective-max`` (1M to 256M, factor 2, JAX's defaults), 10
         iterations, psum again under the ``low-latency`` profile, one
         ``--dcn --slices 2`` sweep, busbw beside ``nvidia-smi topo -m``'s
         link types;
  serve_moe_tp  ``serve_cli.Model(tp=world)`` of Mixtral-8x7B's widths
         at 8 layers over a tp mesh of all the ranks, rank 0's greedy
         streams held to one GPU's ``Model.generate`` by the margin
         rule;
  serve_tp  (the launcher's) real ``serve_cli --tp`` worlds, below;
  moe_sp the MoE step with its sequences over sp, each routed whole
         across the sp ranks (``parallel/moe.py``), at sp world and sp
         world / 2 × ep 2: the small f32 step, then with
         ``--full-width`` at Mixtral-8x7B's widths (2 layers, S 8192,
         bf16) held by ``wide_verdict``'s MoE rule, the first forward's
         routing of both steps read by ``router_ties``;
  tp_whole  tp over dims it does not divide, each such part whole on
         every rank (``tp_lm.whole_parts``): the small f32 step with
         world / 2 KV heads, then with ``--full-width`` Qwen2-1.5B's
         widths (12/2 heads: at tp 4 the attention whole; 4 layers, S
         4096, bf16) held by ``wide_verdict``.

The small f32 steps check the shards' arithmetic (a step of d 256 is
bound by latency, so their times say nothing of the transport); the
full-width bf16 steps are the ones whose times mean something.

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
# The tp and ep steps' merged gradients against the unsplit step's, f32,
# summed in other orders (ring chunks, per-rank partials, the
# vocab-parallel cross entropy): the same bound as the pp step's.
SHARDED_GRAD_RTOL = 1e-4
# The full-width steps (here on N cards, and chip_smoke.py's
# tensor_parallel and expert_parallel phases on one) are held three ways:
#  - in f32, the sharded step's gradients from the same weights widened
#    against the unsplit step's, each within SHARDED_GRAD_RTOL of its
#    largest entry: the sharding's arithmetic, up to the order of f32 sums;
#  - in bf16, each path is as close to those f32 gradients as the unsplit
#    bf16 step is (worst parameter's relative L2, within F32_ANCHOR of the
#    unsplit step's): it rounds no more;
#  - in bf16 against the unsplit bf16 step (the loss, and a dense model's
#    gradients by relative L2 and largest error over the largest
#    |gradient|: chip_smoke.py's TRAIN_GRAD_TOL; the two round at other
#    places, about one bf16 step an element, carried through the layers'
#    backward). An MoE model's gradients are not held so: a rounding
#    difference in a layer's input flips some tokens' top-k experts, and
#    at Mixtral's widths the two bf16 steps then differ by 0.02-0.06
#    (seeds 19, 20, 24, 25) while each is 0.12-0.18 from f32.
WIDE_GRAD_TOL = {"rel_l2": 3e-2, "max_rel": 1e-1, "loss_abs": 1e-2}
F32_ANCHOR = 1.25
WIDE_STEPS = 3
# The full-width steps' depth (of Llama-3-8B's 32 layers and Mixtral's 32,
# as chip_smoke.py's tensor_parallel and expert_parallel phases) and
# sequence.
WIDE_TP_LAYERS = 4
WIDE_EP_LAYERS = 2
WIDE_SEQ = 4096
# The moe_sp check's full-width sequence: long-context MoE is what sp is
# for.
MOE_SP_SEQ = 8192


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


def _release(torch, device):
    """Return the last check's memory to the card before the next."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


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
                ring_attention.P2P(ring), True, d ** -0.5, 1, *shards))
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


def _grad_readings(torch, grads, ref):
    """Per parameter of ``ref`` (gradients by name) against ``grads``:
    the worst relative L2 error, the worst largest error over the largest
    |gradient| (both in f32), and the parameter with the worst L2."""
    worst_l2, worst_max, worst_name = 0.0, 0.0, None
    for name, r in ref.items():
        g, r = grads[name].float(), r.float()
        rel_l2 = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
        max_rel = ((g - r).abs().max()
                   / r.abs().max().clamp_min(1e-30)).item()
        if not torch.isfinite(g).all():
            rel_l2 = max_rel = float("inf")
        if rel_l2 > worst_l2:
            worst_l2, worst_name = rel_l2, name
        worst_max = max(worst_max, max_rel)
    return worst_l2, worst_max, worst_name


def widened(torch, tf, model):
    """``model`` in f32, each weight widened exactly."""
    import dataclasses

    wide = tf.Transformer(dataclasses.replace(model.cfg, dtype="float32"),
                          model.device)
    with torch.no_grad():
        for p, q in zip(wide.parameters(), model.parameters()):
            p.copy_(q.float())
    return wide


def unsplit_f32_grads(torch, tf, model, batch):
    """The unsplit step's gradients by name in f32 from ``model``'s
    weights widened (one ``loss_fn`` with remat; no optimizer step)."""
    wide = widened(torch, tf, model)
    tf.loss_fn(wide, batch, remat=True).backward()
    return {n: p.grad for n, p in wide.named_parameters()}


def sharded_f32_grads(torch, tf, tp_lm, model, axes, batch, mesh=None,
                      overlap=None):
    """The sharded step's gradients by name in f32 from ``model``'s
    weights widened, merged from the ranks' shards (``tp_lm.backward``;
    no optimizer step)."""
    shards = tp_lm.split_params(widened(torch, tf, model), axes)
    tp_lm.backward(shards, batch, axes, mesh=mesh, overlap=overlap)
    return tp_lm.merged(list(shards), axes, "grads")


def wide_verdict(torch, moe, loss_err, bf16, unsplit, f32, unsplit_f32):
    """The three holds of a full-width step (see ``WIDE_GRAD_TOL``):
    ``bf16``/``unsplit`` the path's and the unsplit step's gradients by
    name, ``f32``/``unsplit_f32`` the same in f32. Returns (readings,
    ok)."""
    l2, max_rel, name = _grad_readings(torch, bf16, unsplit)
    path_f32, _, path_name = _grad_readings(torch, bf16, unsplit_f32)
    floor, _, floor_name = _grad_readings(torch, unsplit, unsplit_f32)
    f32_l2, f32_max, f32_name = _grad_readings(torch, f32, unsplit_f32)
    readings = {
        "loss_abs_err": loss_err,
        "bf16_vs_unsplit": {"worst_rel_l2": l2, "worst_rel_l2_param": name,
                            "worst_max_rel": max_rel},
        "bf16_vs_f32": {"path": path_f32, "path_param": path_name,
                        "unsplit": floor, "unsplit_param": floor_name},
        "f32_vs_unsplit_f32": {"worst_max_rel": f32_max,
                               "worst_rel_l2": f32_l2,
                               "worst_rel_l2_param": f32_name}}
    ok = loss_err <= WIDE_GRAD_TOL["loss_abs"] and \
        f32_max <= SHARDED_GRAD_RTOL and path_f32 <= F32_ANCHOR * floor
    if not moe:
        ok = ok and l2 <= WIDE_GRAD_TOL["rel_l2"] and \
            max_rel <= WIDE_GRAD_TOL["max_rel"]
    return readings, ok


def _step_grads(tf, tp_lm, model_or_shards, axes):
    """The gradients by name after a step: the shards' merged, or a
    whole model's (an sp mesh without tp or ep: summed over sp)."""
    if isinstance(model_or_shards, tf.Transformer):
        return {n: p.grad.clone()
                for n, p in model_or_shards.named_parameters()}
    return tp_lm.merged(list(model_or_shards), axes, "grads")


def _sharded_row(args, torch, dist, device, rank, world, card, cfg, check,
                 dp, tp, ep, overlap, wide=False, sp=1):
    """One sharded step against the unsplit step on this rank's device:
    (the row, ok). ``wide``: a bf16 model at published widths, B dp × S
    ``cfg.max_seq_len``, ``WIDE_STEPS`` steps, held by ``wide_verdict``;
    otherwise the small f32 step, B 2 dp × S ``--train-seq``, two steps,
    the f32 bounds. ``sp`` splits the sequence too; an MoE model's row
    then also reads the two steps' routing with :func:`router_ties`."""
    import numpy as np

    from container_engine_accelerators_tpu_torch.models import (
        tp_lm,
        train_cli,
    )
    from container_engine_accelerators_tpu_torch.models import (
        transformer as tf,
    )
    from container_engine_accelerators_tpu_torch.parallel import (
        tensor_parallel,
    )

    mesh = train_cli.build_mesh(world, sp, tp, ep, device_type=device.type)
    axes = tensor_parallel.Axes.of_mesh(mesh)
    rows, seq = (dp, cfg.max_seq_len) if wide else (2 * dp, args.train_seq)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(19).integers(
        0, cfg.vocab_size, (rows, seq + 1)), device=device)}
    init, step = tf.make_train_step(cfg, device=device, mesh=mesh,
                                    overlap=overlap)
    state = init(seed=0)
    init1, step1 = tf.make_train_step(cfg, device=device)
    ref = init1(seed=0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step_ms, unsplit_ms, losses, unsplit_losses = [], [], [], []
    read_routes = sp > 1 and bool(cfg.n_experts)
    for k in range(WIDE_STEPS if wide else 2):
        dist.barrier()
        with recorded_routes(torch, read_routes and k == 0) as seen:
            (state, loss), ms = _timed(torch, device,
                                       lambda: step(state, batch))
        step_ms.append(ms)
        with recorded_routes(torch, read_routes and k == 0) as seen_ref:
            (ref, ref_loss), ms = _timed(torch, device,
                                         lambda: step1(ref, batch))
        unsplit_ms.append(ms)
        losses.append(loss.item())
        unsplit_losses.append(ref_loss.item())
        if k == 0:
            grads = _step_grads(tf, tp_lm, state[0], axes)
            ref_grads = {n: p.grad for n, p in ref[0].named_parameters()}
            if read_routes:
                ties = _sp_router_ties(torch, dist, mesh, world, seen,
                                       seen_ref, cfg.n_layers)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9 \
        if device.type == "cuda" else None
    loss_err = abs(losses[0] - unsplit_losses[0])
    del state, ref
    _release(torch, device)
    if wide:
        model = tf.init_params(cfg, device=device, seed=0)
        unsplit32 = unsplit_f32_grads(torch, tf, model, batch)
        _release(torch, device)
        got32 = sharded_f32_grads(torch, tf, tp_lm, model, axes, batch,
                                  mesh=mesh, overlap=overlap)
        del model
        readings, ok = wide_verdict(torch, bool(cfg.n_experts), loss_err,
                                    grads, ref_grads, got32, unsplit32)
        del unsplit32, got32
        worst, worst_l2 = readings["bf16_vs_unsplit"]["worst_max_rel"], \
            readings["bf16_vs_unsplit"]["worst_rel_l2"]
        tol = {**WIDE_GRAD_TOL, "f32_grad_rel": SHARDED_GRAD_RTOL,
               "f32_anchor": F32_ANCHOR}
    else:
        worst_l2, worst, _ = _grad_readings(torch, grads, ref_grads)
        ok = loss_err <= TRAIN_LOSS_ATOL and worst <= SHARDED_GRAD_RTOL
        readings = {}
        tol = {"loss": TRAIN_LOSS_ATOL, "grad_rel": SHARDED_GRAD_RTOL}
    del grads, ref_grads
    mine = torch.tensor([worst, worst_l2, 0.0 if ok else 1.0, *step_ms],
                        dtype=torch.float64, device=device)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    by_rank = torch.stack(every).tolist()
    ok = all(t[2] == 0 for t in by_rank)
    path = tp_lm.resolve(cfg, axes, mesh, rows, seq, overlap)
    if read_routes:
        # Bf16 MoE steps part where rounding swaps a near tie; a parting
        # that is no tie fails.
        readings["router"] = ties
        ok = ok and (ties["first_layer"] is None or ties["router_tie"])
    row = {"check": check, **card, "world": world, "dp": dp, "sp": sp,
           "tp": tp, "ep": ep, "path": path,
           "whole_parts": sorted(tp_lm.whole_parts(cfg, tp)),
           "seq": seq, "batch": rows,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_experts": cfg.n_experts, "dtype": cfg.dtype,
           "backend": dist.get_backend(), "losses": losses,
           "unsplit_losses": unsplit_losses, "loss_max_abs_err": loss_err,
           "grad_worst_rel_err_by_rank": [t[0] for t in by_rank],
           "grad_worst_rel_l2_by_rank": [t[1] for t in by_rank],
           **readings,
           "step_ms_by_rank": [t[3:] for t in by_rank],
           "step_ms": [max(t[3 + k] for t in by_rank)
                       for k in range(len(step_ms))],
           "unsplit_step_ms": unsplit_ms,
           "timing": "each step's slowest rank; the first builds the "
                     "communicators and warms the kernels"}
    if peak_gb is not None:
        row["max_memory_allocated_gb"] = peak_gb
    return {**row, "tol": tol, "ok": ok}, ok


def _sp_router_ties(torch, dist, mesh, world, seen, seen_ref, n_layers):
    """``router_ties`` of the sp step's first forward against the unsplit
    step's (``recorded_routes``): every layer's router probabilities of
    batch row 0, the sp ranks' (at dp, tp and ep index 0) gathered in sp
    order, on every rank."""
    mine = torch.stack([p[0] for p, _ in seen[:n_layers]]).contiguous()
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    ranks = mesh.mesh[tuple(slice(None) if name == "sp" else 0
                            for name in mesh.mesh_dim_names)].tolist()
    got = torch.cat([every[r] for r in ranks], dim=1)  # (L, S, E)
    return router_ties([(g, k) for g, (_, k) in zip(got, seen)],
                       [(p[0], k) for p, k in seen_ref[:n_layers]])


def _shrunk(cfg, shrink):
    """``cfg`` with its widths, vocabulary and sequence divided by
    ``shrink`` (heads kept), a CPU rehearsal of the full-width steps."""
    import dataclasses

    if shrink == 1:
        return cfg
    return dataclasses.replace(
        cfg, d_model=cfg.d_model // shrink, d_ff=cfg.d_ff // shrink,
        vocab_size=cfg.vocab_size // shrink,
        max_seq_len=cfg.max_seq_len // shrink)


def wide_configs(args):
    """(the tp check's Llama-3-8B config, the ep check's Mixtral-8x7B
    config) at ``WIDE_*`` depth and sequence, bf16, shrunk by
    ``--wide-shrink``."""
    import dataclasses

    from container_engine_accelerators_tpu_torch.models import (
        transformer as tf,
    )

    llama = dataclasses.replace(tf.TransformerConfig.llama3_8b(),
                                n_layers=WIDE_TP_LAYERS, max_seq_len=WIDE_SEQ)
    mixtral = tf.TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=WIDE_EP_LAYERS,
        n_heads=32, n_kv_heads=8, d_ff=14336, max_seq_len=WIDE_SEQ,
        rope_theta=1e6, n_experts=8, expert_top_k=2)
    return (_shrunk(llama, args.wide_shrink),
            _shrunk(mixtral, args.wide_shrink))


def _full_width(args, device):
    return device.type == "cuda" if args.full_width is None \
        else args.full_width


def check_tp(args, torch, dist, device, rank, world, card):
    """The tensor-parallel step (ring and off, and dp 2 × tp at 4 ranks)
    against one device's unsplit step."""
    from container_engine_accelerators_tpu_torch.models import (
        transformer as tf,
    )

    cfg = tf.TransformerConfig(
        vocab_size=1024, d_model=args.train_d_model, n_layers=2,
        n_heads=8, n_kv_heads=4, d_ff=3 * args.train_d_model,
        max_seq_len=args.train_seq, dtype="float32")
    cases = [(cfg, 1, world, "ring", False), (cfg, 1, world, "off", False)]
    if world % 2 == 0 and world > 2:
        cases.append((cfg, 2, world // 2, "ring", False))
    if _full_width(args, device):
        wide = wide_configs(args)[0]
        cases += [(wide, 1, world, "ring", True), (wide, 1, world, "off", True)]
    ok = True
    for case_cfg, dp, tp, overlap, wide in cases:
        row, good = _sharded_row(args, torch, dist, device, rank, world,
                                 card, case_cfg, "tp", dp, tp, 1, overlap,
                                 wide=wide)
        _emit(rank, row)
        ok = ok and good
        _release(torch, device)
    return ok


def check_ep(args, torch, dist, device, rank, world, card):
    """The expert-parallel MoE step against one device's unsplit step."""
    from container_engine_accelerators_tpu_torch.models import (
        transformer as tf,
    )

    cfg = tf.TransformerConfig(
        vocab_size=1024, d_model=args.train_d_model, n_layers=2,
        n_heads=8, n_kv_heads=4, d_ff=3 * args.train_d_model,
        max_seq_len=args.train_seq, dtype="float32", n_experts=2 * world)
    row, ok = _sharded_row(args, torch, dist, device, rank, world, card,
                           cfg, "ep", 1, 1, world, None)
    _emit(rank, row)
    if _full_width(args, device):
        _release(torch, device)
        row, good = _sharded_row(args, torch, dist, device, rank, world,
                                 card, wide_configs(args)[1], "ep", 1, 1,
                                 world, None, wide=True)
        _emit(rank, row)
        ok = ok and good
    return ok


def qwen2_config(n_layers=WIDE_TP_LAYERS, seq=WIDE_SEQ):
    """Qwen2-1.5B's published widths (Hugging Face ``Qwen/Qwen2-1.5B``:
    d 1536, 12 heads, 2 KV heads, head dim 128, d_ff 8960, vocabulary
    151936, rope theta 1e6, tied embeddings) on the repo's Llama-style
    block (Qwen2's q/k/v biases are not in the model), bf16."""
    from container_engine_accelerators_tpu_torch.models import (
        transformer as tf,
    )

    return tf.TransformerConfig(
        vocab_size=151936, d_model=1536, n_layers=n_layers, n_heads=12,
        n_kv_heads=2, d_ff=8960, max_seq_len=seq, rope_theta=1e6)


def _sp_meshes(world):
    """(sp, ep) of the moe_sp check: every rank on sp, and sp world / 2
    × ep 2 where the world divides so."""
    meshes = [(world, 1)]
    if world % 2 == 0 and world > 2:
        meshes.append((world // 2, 2))
    return meshes


def check_moe_sp(args, torch, dist, device, rank, world, card):
    """The MoE step with its sequences over sp (each routed whole across
    the sp ranks; sp world, and sp world / 2 × ep 2) against one device's
    unsplit step: the small f32 step, then with ``--full-width`` at
    Mixtral-8x7B's widths, 2 layers, S ``MOE_SP_SEQ``, bf16, held by
    ``wide_verdict``'s MoE rule, the two steps' routing read by
    ``router_ties``."""
    import dataclasses

    from container_engine_accelerators_tpu_torch.models import (
        transformer as tf,
    )

    small = tf.TransformerConfig(
        vocab_size=1024, d_model=args.train_d_model, n_layers=2,
        n_heads=8, n_kv_heads=4, d_ff=3 * args.train_d_model,
        max_seq_len=args.train_seq, dtype="float32", n_experts=4)
    cases = [(small, sp, ep, False) for sp, ep in _sp_meshes(world)]
    if _full_width(args, device):
        mixtral = dataclasses.replace(
            wide_configs(args)[1],
            max_seq_len=MOE_SP_SEQ // args.wide_shrink)
        cases += [(mixtral, sp, ep, True) for sp, ep in _sp_meshes(world)]
    ok = True
    for cfg, sp, ep, wide in cases:
        row, good = _sharded_row(args, torch, dist, device, rank, world,
                                 card, cfg, "moe_sp", 1, 1, ep, None,
                                 wide=wide, sp=sp)
        _emit(rank, row)
        ok = ok and good
        _release(torch, device)
    return ok


def check_tp_whole(args, torch, dist, device, rank, world, card):
    """tp over dims it does not divide (each such part whole on every
    rank): the small f32 step with 2 KV heads, then with
    ``--full-width`` Qwen2-1.5B's widths (``qwen2_config``: at tp 4 the
    attention whole, the FFN and the vocabulary split), 4 layers, S
    4096, bf16, against one device's unsplit step."""
    from container_engine_accelerators_tpu_torch.models import (
        transformer as tf,
    )

    small = tf.TransformerConfig(
        vocab_size=1026, d_model=args.train_d_model, n_layers=2,
        n_heads=8, n_kv_heads=world // 2 or 1, d_ff=3 * args.train_d_model,
        max_seq_len=args.train_seq, dtype="float32")
    cases = [(small, False)]
    if _full_width(args, device):
        cases.append((_shrunk(qwen2_config(), args.wide_shrink), True))
    ok = True
    for cfg, wide in cases:
        row, good = _sharded_row(args, torch, dist, device, rank, world,
                                 card, cfg, "tp_whole", 1, world, 1, None,
                                 wide=wide)
        _emit(rank, row)
        ok = ok and good
        _release(torch, device)
    return ok


# -- serve_tp: real serve_cli --tp worlds --------------------------------

# The served config's width and traffic: full-width Llama-3-8B on CUDA
# (every layer unless --serve-layers cuts it), a 2-layer f32 model of
# context 64 on the CPU (the tier-1 rehearsal over gloo).
SERVE_CPU_FLAGS = ["--seq-len", "64", "--d-model", "64", "--n-layers", "2",
                   "--n-heads", "16", "--vocab-size", "128",
                   "--dtype", "float32"]
SERVE_ENGINE_FLAGS = ["--continuous-batching", "--kv-cache", "paged",
                      "--max-slots", "8"]
# Greedy streams may part from one GPU's only where its top-2 logit margin
# is under this (chip_smoke.py's serve_spec rule, SERVE_LOGITS_ATOL).
SERVE_MARGIN = 0.25
SERVE_LINK_TIMEOUT_S = 5.0
# Seconds past the link timeout within which rank 0 must have reported
# the wedge after a follower is killed.
SERVE_WEDGE_SLACK_S = 10.0
# Seconds into the long decode before the follower is killed: its first
# token is out by then (a 1500-token prefill on the card; the tiny CPU
# model's).
SERVE_KILL_AFTER_S = {"cuda": 3.0, "cpu": 0.5}


def _serve_argv(args, device):
    flags = ["--device", device.type]
    if device.type == "cuda":
        flags += ["--preset", "llama3-8b"]
    else:
        flags += SERVE_CPU_FLAGS
    return flags + SERVE_ENGINE_FLAGS + ["--warmup", "all"]


def _serve_cfg(args, device, serve_cli):
    parsed = serve_cli.build_parser().parse_args(_serve_argv(args, device))
    return serve_cli.config_from_args(parsed)


def _serve_prompts(np, cfg):
    """serve_paged's traffic (a shared prefix, six requests sharing it, a
    long prompt), scaled to the context on the CPU; a TTFT prompt and a
    decode prompt of their own."""
    rng = np.random.default_rng(5)
    short = cfg.max_seq_len < 4096
    n_prefix, n_suffix, n_long, n_ttft = \
        (16, 4, 40, 24) if short else (1024, 64, 3000, 1500)
    max_new = 6 if short else 32

    def draw(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    prefix = draw(n_prefix)
    prompts = {"ttft": (draw(n_ttft), 1),
               "decode": (draw(n_ttft), max_new + 1 if short else 65),
               "prefix": (prefix, max_new)}
    for i in range(6):
        prompts[f"shared_{i}"] = (prefix + draw(n_suffix), max_new)
    prompts["long"] = (draw(n_long), max_new)
    return prompts


def _drive(serve_cli, port, prompts, post_timeout):
    """The traffic against a server on ``port``: the TTFT and decode
    requests alone, then the prefix, the six shared requests at once and
    the long one. Returns ({name: tokens}, {name: seconds})."""
    import concurrent.futures

    tokens, wall = {}, {}

    def post(name):
        prompt, max_new = prompts[name]
        t0 = time.perf_counter()
        out = serve_cli.post_generate(port, [prompt], max_new,
                                      timeout=post_timeout)
        wall[name] = time.perf_counter() - t0
        tokens[name] = out["tokens"][0]

    for name in ("ttft", "decode", "prefix"):
        post(name)
    rest = [n for n in prompts if n.startswith("shared_")] + ["long"]
    with concurrent.futures.ThreadPoolExecutor(len(rest)) as pool:
        for f in [pool.submit(post, n) for n in rest]:
            f.result()
    rest = [n for n in prompts if n not in tokens]
    if rest:
        with concurrent.futures.ThreadPoolExecutor(len(rest)) as pool:
            for f in [pool.submit(post, n) for n in rest]:
                f.result()
    return tokens, wall


def _spec_prompts(np, cfg, prompts):
    """``prompts`` and two requests of a pattern repeated (chip_smoke.py's
    serve_spec traffic, scaled to the context on the CPU), so the ngram
    proposer proposes whatever the random weights generate."""
    rng = np.random.default_rng(7)
    short = cfg.max_seq_len < 4096
    period, length, max_new = (4, 16, 8) if short else (32, 512, 64)
    out = dict(prompts)
    for i in range(2):
        pattern = rng.integers(0, cfg.vocab_size, period)
        out[f"pattern_{i}"] = (np.tile(pattern, length // period).tolist(),
                               max_new)
    return out


def _post_json(port, path, body, timeout):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _metric(port, name):
    """One unlabelled sample of rank 0's ``/metrics`` (0.0 when absent)."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        for line in r.read().decode().splitlines():
            if line.startswith(name + " "):
                return float(line.split()[1])
    return 0.0


def _handoff_round_trip(args, serve_cli, cfg, device, port, prompts, got):
    """A KV handoff round trip between the world (rank 0's HTTP
    ``/kv/export`` and ``/kv/install``) and one GPU's unsplit engine in
    this process, on JAX's wire: the world exports a prompt it served and
    the engine serves it from the installed blocks; the engine exports
    one it served and the world serves it from the installed blocks.
    Returns {direction: (the taker's stream, the donor's, its prompt, the
    row)}."""
    model = serve_cli.Model(cfg, seed=0, device=str(device))
    engine = serve_cli.ContinuousEngine(
        model, max_slots=8, chunk=32, prefill_chunk=512, kv_cache="paged")
    out = {}
    try:
        # The shared prefix (1024 tokens, 64 blocks of Llama-3-8B's 32
        # layers: about 130 MB of K/V, JSON over HTTP), and the same
        # reversed, which the world has not served.
        prompt, max_new = prompts["prefix"]
        frames = _post_json(port, "/kv/export", {"tokens": prompt},
                            args.timeout_s)["frames"]
        hit0 = engine.kv_stats()["prefix_hit_tokens"]
        installed = engine.kv_install(frames, timeout_s=args.timeout_s) \
            if frames else {"installed_blocks": 0}
        mine = engine.generate([prompt], max_new)[0]
        out["world_to_one_gpu"] = (mine, got["prefix"], prompt, {
            "frames": len(frames), "installed": installed,
            "prefix_hit_tokens":
                engine.kv_stats()["prefix_hit_tokens"] - hit0})
        prompt = prompt[::-1]
        donor = engine.generate([prompt], max_new)[0]
        frames = engine.kv_export(prompt, timeout_s=args.timeout_s)
        installed = _post_json(port, "/kv/install", {"frames": frames},
                               args.timeout_s)
        theirs = serve_cli.post_generate(port, [prompt], max_new,
                                         timeout=args.timeout_s)
        out["one_gpu_to_world"] = (theirs["tokens"][0], donor, prompt, {
            "frames": len(frames), "installed": installed})
    finally:
        engine.shutdown()
        del engine, model
    return out


def _latency(prompts, wall):
    """TTFT (the one-token request's wall) and ms a decode step (the
    decode request's wall past it, over its extra tokens)."""
    steps = prompts["decode"][1] - 1
    return {"ttft_ms": wall["ttft"] * 1e3,
            "decode_ms_per_step": (wall["decode"] - wall["ttft"]) * 1e3
            / steps}


def _start_world(args, tp, argv_of, log_dir, tag,
                 module="container_engine_accelerators_tpu_torch.models."
                        "serve_cli", env_extra=None):
    """``tp`` processes of ``module`` (serve_cli by default) through the
    env contract, rank r with ``argv_of(r)`` and ``env_extra`` in its
    environment, each writing ``<log_dir>/<tag>_rank<r>.log``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "MEGASCALE_", "LOCAL_"))}
    env.update(TPU_WORKER_ID="0", TPU_WORKER_HOSTNAMES="localhost",
               TPU_COORDINATOR_PORT=str(_free_port()),
               LOCAL_WORLD_SIZE=str(tp), **(env_extra or {}))
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    for rank in range(tp):
        path = os.path.join(log_dir, f"{tag}_rank{rank}.log")
        logs.append(path)
        with open(path, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv_of(rank)],
                env={**env, "LOCAL_RANK": str(rank)}, stdout=out,
                stderr=subprocess.STDOUT))
    return procs, logs


def _stop(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _wait_ready(port, procs, timeout_s):
    import urllib.request

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if any(p.poll() is not None for p in procs):
            return False
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                if r.status == 200:
                    return True
        except OSError:
            pass
        time.sleep(0.5)
    return False


def _graph_stats(path):
    """The ``{"rank", "graph_stats"}`` line a ``--tp`` rank prints as it
    stops, or None."""
    with open(path) as f:
        for line in f:
            if line.startswith('{"rank"'):
                return json.loads(line)["graph_stats"]
    return None


def _tail(path, n=3000):
    with open(path) as f:
        return f.read()[-n:]


def _partings(torch, tf, model, prompts, got, want):
    """Where each stream parts from one GPU's and that GPU's top-2 logit
    margin there (chip_smoke.py's ``_divergences``)."""
    rows = []
    for name, (prompt, _) in prompts.items():
        a, b = got[name], want[name]
        if a == b:
            continue
        pos = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]),
                   min(len(a), len(b)))
        if pos >= len(b):
            rows.append({"request": name, "margin": 0.0,
                         "error": "lengths differ"})
            continue
        with torch.inference_mode():
            logits = tf.forward(
                model.model, torch.as_tensor([b[:pos]],
                                             device=model.device),
                logits_at="last")[0, 0].float()
        top2 = logits.topk(2).values
        rows.append({"request": name, "generated_index": pos - len(prompt),
                     "want_token": b[pos], "got_token": a[pos],
                     "margin": (top2[0] - top2[1]).item()})
    return rows


# An MoE model's streams may also part where the reference's top-2 logit
# margin is SERVE_MARGIN or more: two paths whose layer inputs differ by
# a rounding can swap a router's k-th and (k+1)-th experts for a token,
# and the swapped expert moves that token's output, and what attends to
# it later, by far more than a rounding. Such a parting is held by the
# routing of the context it parts at (``router_ties``): at the first
# layer where the two paths route any token apart, before any swap can
# have spread, their router probabilities must agree within ROUTER_ATOL
# for every token, so every swap there is a tie broken by rounding.
ROUTER_ATOL = 0.02


class recorded_routes:
    """Records every MoE routing's router probabilities while entered
    (``moe._route_sharded``'s groups or shards, which every routing
    runs), in call order: a list of (f32 (N, G, E) probabilities, k), one
    a call and rank held (empty, and nothing wrapped, when ``on`` is
    false)."""

    def __init__(self, torch, on=True):
        self.torch, self.on = torch, on
        self.seen = []

    def __enter__(self):
        from container_engine_accelerators_tpu_torch.parallel import moe

        torch, seen = self.torch, self.seen
        if not self.on:
            return seen
        self.sharded = moe._route_sharded

        def sharded(xs, routers, k, capacity_factor, axes):
            with torch.no_grad():
                seen.extend((torch.softmax(x.float() @ r, dim=-1), k)
                            for x, r in zip(xs, routers))
            return self.sharded(xs, routers, k, capacity_factor, axes)

        moe._route_sharded = sharded
        return seen

    def __exit__(self, *exc):
        from container_engine_accelerators_tpu_torch.parallel import moe

        if self.on:
            moe._route_sharded = self.sharded
        return False


def routing(torch, tf, model, tokens, context=None):
    """Every MoE layer's router probabilities (G, E) for the tokens of
    one prefill of ``tokens`` on ``model`` (a ``serve_cli.Model``: whole,
    or tp shards, whose ranks route alike), under ``context`` (e.g.
    chip_smoke.py's ``plain_attention``), and the layer's k: [(probs,
    k)], a layer each."""
    import contextlib

    with recorded_routes(torch) as seen, context or \
            contextlib.nullcontext(), torch.inference_mode():
        tf.prefill(model.model, torch.as_tensor([tokens],
                                                device=model.device),
                   return_logits=True)
    return [(p[0], k) for p, k in seen[::model.model.tp]]


def router_ties(got, want):
    """Two routings of one context (``routing``) → the first layer at
    which some token's top-k experts differ, the tokens that differ
    there, the largest router-probability difference over all tokens
    there, the reference's k-th/(k+1)-th gaps of the swapped tokens, and
    whether the swaps there are ties (the difference within
    ROUTER_ATOL)."""
    from container_engine_accelerators_tpu_torch.parallel import moe

    for layer, ((p, k), (q, _)) in enumerate(zip(got, want)):
        experts = moe.sorted_top_k(p, k)[1].sort(dim=-1).values
        ref_vals, ref = moe.sorted_top_k(q, k + 1)
        diff = (experts != ref[:, :k].sort(dim=-1).values).any(dim=-1)
        if diff.any():
            gaps = (ref_vals[:, k - 1] - ref_vals[:, k])[diff]
            worst = (p - q).abs().max().item()
            return {"first_layer": layer, "tokens_swapped": int(diff.sum()),
                    "max_prob_diff": worst,
                    "swap_gaps": [gaps.min().item(), gaps.max().item()],
                    "router_tie": worst <= ROUTER_ATOL}
    return {"first_layer": None, "router_tie": False}


def _one_gpu(args, torch, np, cfg, device, prompts):
    """The unsplit engine on one device on the same weights (seed 0) and
    flags: its streams, TTFT and decode ms, and the model for the
    margins."""
    from container_engine_accelerators_tpu_torch.models import serve_cli

    model = serve_cli.Model(cfg, seed=0, device=str(device))
    engine = serve_cli.ContinuousEngine(
        model, max_slots=8, chunk=32, prefill_chunk=512, kv_cache="paged")
    server, state = serve_cli.start_server(
        engine, port=0, host="127.0.0.1", warmup_mode="all")
    try:
        serve_cli.wait_ready(state, timeout=args.timeout_s)
        tokens, wall = _drive(serve_cli, server.server_address[1], prompts,
                              args.timeout_s)
    finally:
        server.shutdown()
        engine.shutdown()
    return model, tokens, _latency(prompts, wall)


def _kill_drill(args, tp, base_argv, log_dir, serve_cli, prompts):
    """``--link-timeout-s`` with a follower SIGKILLed mid-decode: rank 0
    reports ``link_wedged`` within the timeout (plus slack), the request
    in flight (and any that follows) comes back instead of hanging, and
    rank 0 exits for its supervisor."""
    import signal
    import threading
    import urllib.error

    port = _free_port()
    events = os.path.join(log_dir, f"kill_tp{tp}_events.jsonl")

    def argv_of(rank):
        extra = ["--event-log", events] if rank == 0 else []
        return [*base_argv, "--tp", str(tp), "--port", str(port),
                "--link-timeout-s", str(SERVE_LINK_TIMEOUT_S), *extra]

    procs, logs = _start_world(args, tp, argv_of, log_dir, f"kill_tp{tp}")
    row = {"check": "serve_tp_kill", "tp": tp,
           "link_timeout_s": SERVE_LINK_TIMEOUT_S}
    try:
        if not _wait_ready(port, procs, args.timeout_s):
            row["error"] = "not ready: " + _tail(logs[0])
            return row, False
        prompt, _ = prompts["decode"]
        cfg = _serve_cfg(args, _device_of(args), serve_cli)
        n_new = min(2048, cfg.max_seq_len - len(prompt) - 1)
        outcome = {}

        def long_request():
            t0 = time.perf_counter()
            try:
                serve_cli.post_generate(port, [prompt], n_new, timeout=120)
                outcome["result"] = "completed"
            except urllib.error.HTTPError as e:
                outcome["result"] = f"http {e.code}"
            except OSError as e:
                outcome["result"] = f"{type(e).__name__}"
            outcome["s"] = time.perf_counter() - t0

        thread = threading.Thread(target=long_request, daemon=True)
        thread.start()
        time.sleep(SERVE_KILL_AFTER_S[args.device])
        victim = procs[-1]
        t_kill = time.monotonic()
        victim.send_signal(signal.SIGKILL)
        wedged_s = None
        probes = 0
        deadline = t_kill + SERVE_LINK_TIMEOUT_S + SERVE_WEDGE_SLACK_S
        while time.monotonic() < deadline and wedged_s is None:
            if os.path.exists(events):
                with open(events) as f:
                    if any('"link_wedged"' in line for line in f):
                        wedged_s = time.monotonic() - t_kill
                        break
            if not thread.is_alive() and procs[0].poll() is None \
                    and probes < 3:
                # The request failed before an announce met the dead
                # rank (its collective raised first): the next request's
                # announce must report the wedge.
                probes += 1
                try:
                    serve_cli.post_generate(port, [[1, 2, 3]], 2,
                                            timeout=30)
                except OSError:
                    pass
            time.sleep(0.05)
        thread.join(60)
        try:
            rc0 = procs[0].wait(timeout=30)
        except subprocess.TimeoutExpired:
            rc0 = None
        # On the card the decode outlasts the kill by far, so the row was
        # in flight and must have failed; on the CPU it may have finished.
        in_flight = args.device == "cuda"
        row.update(wedged_after_s=wedged_s, request=outcome,
                   request_returned=not thread.is_alive(), probes=probes,
                   rank0_exit=rc0, new_tokens=n_new)
        ok = (wedged_s is not None and not thread.is_alive()
              and not (in_flight and outcome.get("result") == "completed")
              and rc0 not in (None, 0))
        if not ok:
            row["rank0_log"] = _tail(logs[0])
        return row, ok
    finally:
        _stop(procs)


def _spec_world(args, torch, np, tf, serve_cli, cfg, device, card,
                base_argv, log_dir, prompts, model, want):
    """The world at ``--world`` under ``--speculate ngram`` (rank 0
    proposes, every rank replays the verify rounds): the traffic and two
    pattern requests held to one GPU's streams (``want``, speculation
    off) by the margin rule, every rank's verify rounds replays of its
    captured graphs on CUDA; then a KV handoff round trip with one GPU's
    engine (``_handoff_round_trip``), each continuation held to its
    donor's stream by the same rule. Prints the ``serve_tp_spec`` and
    ``serve_tp_handoff`` rows; returns ok."""
    import signal

    tp = args.world
    spec_prompts = _spec_prompts(np, cfg, prompts)
    port = _free_port()
    procs, logs = _start_world(
        args, tp, lambda r: [*base_argv, "--tp", str(tp), "--port",
                             str(port), "--speculate", "ngram"],
        log_dir, f"tp{tp}_spec")
    row = {"check": "serve_tp_spec", "tp": tp, "speculate": "ngram",
           "n_layers": cfg.n_layers, **card}
    trips = {}
    try:
        if not _wait_ready(port, procs, args.timeout_s):
            row["error"] = "not ready: " + _tail(logs[0])
            print(json.dumps(row), flush=True)
            return False
        tokens, wall = _drive(serve_cli, port, spec_prompts, args.timeout_s)
        row["verifies"] = _metric(port, "tpu_serving_spec_verify_steps_total")
        trips = _handoff_round_trip(args, serve_cli, cfg, device, port,
                                    prompts, tokens)
        procs[0].send_signal(signal.SIGINT)
        rcs = []
        for proc in procs:
            try:
                rcs.append(proc.wait(timeout=120))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        _stop(procs)
    stats = [_graph_stats(p) for p in logs]
    if device.type == "cuda":
        verified = all(s is not None and s.get("verify_graph_replays", 0) > 0
                       and s.get("eager_verifies_on_cuda") == 0
                       for s in stats)
    else:
        verified = all(s is not None for s in stats)
    partings = _partings(torch, tf, model, spec_prompts, tokens, want)
    good = verified and rcs == [0] * tp and row["verifies"] > 0 and \
        all(r["margin"] < SERVE_MARGIN for r in partings)
    row.update(requests=len(spec_prompts), exit_codes=rcs,
               graph_stats=stats, verify_replayed=verified,
               partings=partings, margin_limit=SERVE_MARGIN, ok=good)
    if not good:
        row["rank0_log"] = _tail(logs[0])
    print(json.dumps(row), flush=True)
    trip_rows, trips_good = {}, True
    for name, (got, donor, prompt, info) in trips.items():
        rows = _partings(torch, tf, model, {name: (prompt, 0)},
                         {name: got}, {name: donor})
        trip_good = info["frames"] > 0 and \
            info["installed"].get("installed_blocks", 0) > 0 and \
            all(r["margin"] < SERVE_MARGIN for r in rows)
        trip_rows[name] = {**info, "partings": rows, "ok": trip_good}
        trips_good = trips_good and trip_good
    trips_good = trips_good and len(trips) == 2
    print(json.dumps({"check": "serve_tp_handoff", "tp": tp,
                      "directions": trip_rows, "ok": trips_good, **card}),
          flush=True)
    return good and trips_good


def _device_of(args):
    import torch

    return torch.device("cuda" if args.device == "cuda" else "cpu")


def check_serve_tp(args):
    """serve_cli --tp worlds (``--world`` under ``--overlap auto`` and
    ``off``, then 2 where the world is larger), paged continuous batching
    at Llama-3-8B's full width on CUDA: rank 0 answers HTTP /generate, the others replay the lockstep
    link. Each world's greedy streams are held to one GPU's unsplit
    engine on the same weights (they may part only where its top-2
    margin is under SERVE_MARGIN), every rank's decode chunks replay
    their captured graphs (the per-layer all-reduces inside them), and
    TTFT and ms a decode step are timed beside one GPU's. Then at
    ``--world``: ``--link-timeout-s`` with a follower SIGKILLed
    mid-decode (``_kill_drill``). Then at ``--world``, on one host:
    ``--speculate ngram`` and a KV handoff round trip with one GPU's
    engine (``_spec_world``). Rank 0's lines are printed by this
    launcher. Returns ok."""
    import signal
    import tempfile

    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.models import serve_cli
    from container_engine_accelerators_tpu_torch.models import (
        transformer as tf,
    )

    device = _device_of(args)
    card = _card() if device.type == "cuda" else {}
    cfg = _serve_cfg(args, device, serve_cli)
    base_argv = _serve_argv(args, device)
    prompts = _serve_prompts(np, cfg)
    worlds = [args.world] + ([2] if args.world > 2 else [])
    log_dir = tempfile.mkdtemp(prefix="world_smoke_serve_tp-",
                               dir=args.log_dir or None)
    ok = True
    runs = {}
    # The largest world runs twice: under --overlap auto (the ring
    # prefill where the bucket divides by tp, as JAX picks it) and off,
    # so the prefill's two paths are timed across cards side by side.
    cases = [(tp, overlap) for tp in worlds
             for overlap in (("auto", "off") if tp == args.world
                             else ("auto",))]
    for tp, overlap in cases:
        port = _free_port()
        procs, logs = _start_world(
            args, tp, lambda r: [*base_argv, "--tp", str(tp), "--port",
                                 str(port), "--overlap", overlap],
            log_dir, f"tp{tp}_{overlap}")
        row = {"check": "serve_tp", "tp": tp, "overlap": overlap,
               "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "dtype": cfg.dtype, **card}
        try:
            t0 = time.perf_counter()
            if not _wait_ready(port, procs, args.timeout_s):
                row["error"] = "not ready: " + _tail(logs[0])
                print(json.dumps(row), flush=True)
                ok = False
                continue
            row["ready_s"] = time.perf_counter() - t0
            tokens, wall = _drive(serve_cli, port, prompts, args.timeout_s)
            procs[0].send_signal(signal.SIGINT)
            rcs = []
            for proc in procs:
                try:
                    rcs.append(proc.wait(timeout=120))
                except subprocess.TimeoutExpired:
                    rcs.append(None)
        finally:
            _stop(procs)
        stats = [_graph_stats(p) for p in logs]
        # On CUDA every decode step of every rank is a replay (its
        # all-reduces captured in the graph); the CPU has no graphs.
        replayed = all(
            s is not None and (device.type == "cpu" or (
                s["graph_replays"] > 0 and s["eager_chunks_on_cuda"] == 0))
            for s in stats)
        runs[tp, overlap] = tokens
        row.update(latency=_latency(prompts, wall), exit_codes=rcs,
                   graph_stats=stats, graphs_replayed=replayed)
        good = replayed and rcs == [0] * tp
        if not good:
            row["rank0_log"] = _tail(logs[0])
        print(json.dumps(row), flush=True)
        ok = ok and good
    if not runs:
        return False
    model, want, one_gpu = _one_gpu(args, torch, np, cfg, device,
                                    _spec_prompts(np, cfg, prompts))
    for (tp, overlap), got in runs.items():
        partings = _partings(torch, tf, model, prompts, got, want)
        good = all(r["margin"] < SERVE_MARGIN for r in partings)
        print(json.dumps({"check": "serve_tp_tokens", "tp": tp,
                          "overlap": overlap,
                          "requests": len(prompts), "partings": partings,
                          "margin_limit": SERVE_MARGIN, "ok": good,
                          "one_gpu": one_gpu, **card}), flush=True)
        ok = ok and good
    spec = _spec_world(args, torch, np, tf, serve_cli, cfg, device, card,
                       base_argv, log_dir, prompts, model, want)
    ok = ok and spec
    del model
    _release(torch, device)
    row, good = _kill_drill(args, args.world, base_argv, log_dir,
                            serve_cli, prompts)
    print(json.dumps({**row, **card}), flush=True)
    return ok and good


# -- collectives: the collective sweep over the world ---------------------------

# Each op's output on the card against its plain expectation: data moves
# exactly; a bf16 sum over n ranks rounds each partial sum once, so
# within n bf16 steps of the f32 sum (relative); the ring matmul's chunk
# products against the whole product by one bf16 step.
COLLECTIVE_SUM_RTOL = 2.0 ** -8
COLLECTIVE_MM_RTOL = 2.0 ** -7
# The op checks' per-device elements: an f32-exact bf16 size (sums below
# 256) and a 1 MiB one.
COLLECTIVE_CHECK_ELEMS = (16, 1 << 19)


def _op_errors(torch, bench, mesh, axis, elems, device):
    """This rank's output of each collective op at ``elems`` per device
    against its plain f32 expectation → {op: (max relative error, ok)}."""
    n = bench.axis_size(mesh, axis)
    index = mesh.get_local_rank(axis)
    flat = bench.flat_index(mesh)
    dim = mesh.mesh_dim_names.index(axis)
    coord = list(mesh.get_coordinate())
    peers = []
    for j in range(n):
        coord[dim] = j
        peers.append(int(mesh.mesh[tuple(coord)]))
    order = mesh.mesh.flatten().tolist()
    blocks = [bench.arange_block(order.index(r) * elems, elems,
                                 torch.bfloat16, device).float()
              for r in peers]
    bf16 = torch.bfloat16
    x = bench._sharded_input(mesh, elems, bf16)
    out = {}

    def hold(name, got, want, rtol):
        err = ((got.float() - want).abs()
               / want.abs().clamp_min(1.0)).max().item()
        out[name] = (err, err <= rtol)

    hold("psum", bench.psum_op(mesh, axis)(x.clone()), sum(blocks),
         n * COLLECTIVE_SUM_RTOL)
    hold("all_gather", bench.all_gather_op(mesh, axis)(
        x, torch.empty(n * elems, dtype=bf16, device=device)),
        torch.cat(blocks), 0.0)
    full = bench.reduce_scatter_input(mesh, axis, elems, bf16)
    hold("reduce_scatter", bench.reduce_scatter_op(mesh, axis)(
        full, torch.empty(elems, dtype=bf16, device=device)),
        n * full.float()[index * elems:(index + 1) * elems],
        n * COLLECTIVE_SUM_RTOL)
    hold("ppermute", bench.ppermute_op(mesh, axis)(x, torch.empty_like(x)),
         blocks[(index - 1) % n], 0.0)
    _, xm, wm = bench.collective_matmul_inputs(mesh, axis, 1 << 16, bf16)
    xs = xm.chunk(n, dim=0)[index].contiguous()
    ws = wm.chunk(n, dim=1)[index].contiguous()
    hold("collective_matmul", bench.collective_matmul_op(mesh, axis)(xs, ws),
         torch.mm(xm, ws).float(), COLLECTIVE_MM_RTOL)
    return out


def check_collectives(args, torch, dist, device, rank, world, card):
    """Every op of ``collectives/bench.py`` over the world's 1-D mesh and
    its dcn 2 × x hybrid mesh, each rank's output against its plain
    expectation on the device (``_op_errors``)."""
    from container_engine_accelerators_tpu_torch.collectives import (
        bench as cb,
    )
    from container_engine_accelerators_tpu_torch.parallel import (
        mesh as pmesh,
    )

    meshes = [("x", pmesh.make_mesh(pmesh.plan_mesh(world, {"x": -1}),
                                    device.type))]
    if world % 2 == 0:
        meshes.append(("dcn", pmesh.make_hybrid_mesh(
            {"dcn": 2}, {"x": -1}, 2, device_type=device.type)))
    ok, rows = True, {}
    for axis, mesh in meshes:
        for elems in COLLECTIVE_CHECK_ELEMS:
            errs = _op_errors(torch, cb, mesh, axis, elems, device)
            every = [None] * world
            dist.all_gather_object(every, errs)
            rows[f"{axis}_{elems}"] = {
                op: max(e[op][0] for e in every) for op in errs}
            ok = ok and all(e[op][1] for e in every for op in e)
    _emit(rank, {"check": "collectives_ops", "world": world,
                 "max_rel_err": rows,
                 "tol": {"sum_rtol": COLLECTIVE_SUM_RTOL,
                         "matmul_rtol": COLLECTIVE_MM_RTOL},
                 "ok": ok, **card})
    return ok


def _topology():
    """How the cards are linked: ``nvidia-smi topo -m``'s link type
    between each pair ({"links": {"GPU0-GPU1": "NV18", ...}}). Where this
    machine's ``nvidia-smi`` cannot print the matrix: its message, each
    card's NVLink links and their rates from ``nvidia-smi nvlink
    --status``, and whether each pair has peer access."""
    proc = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True)
    if proc.returncode == 0:
        rows = [line.split() for line in proc.stdout.splitlines()
                if line.startswith("GPU")]
        return {"links": {f"{row[0]}-GPU{j}": kind
                          for row in rows
                          for j, kind in enumerate(row[1:len(rows) + 1])
                          if kind != "X"}}
    import re

    import torch

    out = {"topo_error": (proc.stdout + proc.stderr).strip()[:300]}
    proc = subprocess.run(["nvidia-smi", "nvlink", "--status"],
                          capture_output=True, text=True)
    nvlink, card = {}, None
    for line in proc.stdout.splitlines():
        if line.startswith("GPU "):
            card = "GPU" + line.split()[1].rstrip(":")
            nvlink[card] = []
        elif card and re.search(r"[0-9.]+ GB/s", line):
            nvlink[card].append(float(
                re.search(r"([0-9.]+) GB/s", line).group(1)))
    out["nvlink_gbps"] = nvlink or (proc.stdout + proc.stderr).strip()[:300]
    n = torch.cuda.device_count()
    out["peer_access"] = {f"GPU{i}-GPU{j}":
                          torch.cuda.can_device_access_peer(i, j)
                          for i in range(n) for j in range(n) if i != j}
    return out


def _collectives_world(args, env_extra, argv, log_dir, tag):
    """``--world`` processes of the collectives CLI through the env
    contract → (exit codes, rank 0's JSON lines, the logs)."""
    procs, logs = _start_world(
        args, args.world,
        lambda r: ["--device", args.device, "--json", *argv], log_dir, tag,
        module="container_engine_accelerators_tpu_torch.collectives",
        env_extra=env_extra)
    rcs = []
    try:
        for proc in procs:
            rcs.append(proc.wait(timeout=args.timeout_s))
    finally:
        _stop(procs)
    with open(logs[0]) as f:
        lines = [json.loads(line) for line in f if line.startswith("{")]
    return rcs, lines, logs


def check_collectives_sweep(args):
    """The collectives CLI as ``--world`` processes (one a GPU, NCCL):
    every collective from 1M to 256M bytes by factor 2, 10 iterations
    (JAX's defaults); psum again under the ``low-latency`` profile; one
    ``--dcn --slices 2`` sweep; busbw against the card's link ceiling,
    beside the cards' link types (``nvidia-smi topo -m``). Returns ok."""
    import tempfile

    from container_engine_accelerators_tpu_torch.collectives import (
        env_profiles,
    )

    card = _card() if args.device == "cuda" else {}
    links = _topology() if args.device == "cuda" else {}
    log_dir = tempfile.mkdtemp(prefix="world_smoke_collectives-",
                               dir=args.log_dir or None)
    sweep = ["--min-bytes", args.collective_min, "--max-bytes",
             args.collective_max, "--iters", "10"]
    runs = [("all", {}, ["--collective", "all", *sweep]),
            ("psum_low_latency", env_profiles.profile_env("low-latency"),
             ["--collective", "psum", *sweep]),
            ("dcn", {}, ["--dcn", "--slices", "2", "--collective", "all",
                         *sweep])]
    ok = True
    for tag, env_extra, argv in runs:
        rcs, lines, logs = _collectives_world(args, env_extra, argv, log_dir,
                                              tag)
        results = [r for r in lines if "collective" in r]
        summary = lines[-1] if lines else {}
        good = rcs == [0] * args.world and "metric" in summary and \
            results and all(r["busbw_gbps"] > 0 for r in results)
        row = {"check": "collectives_sweep", "run": tag, "world": args.world,
               "env": env_extra, "summary": summary,
               "busbw_gbps": {f"{r['collective']}@{r['msg_bytes']}":
                              r["busbw_gbps"] for r in results},
               "links": links, "exit_codes": rcs, "ok": good, **card}
        cm = [r["detail"] for r in results
              if r["collective"] == "collective_matmul"]
        if cm:
            row["collective_matmul"] = cm
        if not good:
            row["rank0_log"] = _tail(logs[0])
        print(json.dumps(row), flush=True)
        ok = ok and good
    return ok


# -- serve_moe_tp: an MoE model over tp ranks against one GPU -------------------

SERVE_MOE_TP_LAYERS = 8


def _moe_serve_cfg(args, device):
    """Mixtral-8x7B's widths at 8 of its 32 layers (bf16) on CUDA; on the
    CPU the same shape shrunk by ``--wide-shrink`` to 2 layers in f32."""
    import dataclasses

    from container_engine_accelerators_tpu_torch.models import (
        transformer as tf,
    )

    cfg = tf.TransformerConfig(
        vocab_size=32000, d_model=4096, n_layers=SERVE_MOE_TP_LAYERS,
        n_heads=32, n_kv_heads=8, d_ff=14336, max_seq_len=WIDE_SEQ,
        rope_theta=1e6, n_experts=8, expert_top_k=2)
    if device.type == "cuda":
        return cfg
    return dataclasses.replace(_shrunk(cfg, args.wide_shrink), n_layers=2,
                               dtype="float32")


def check_serve_moe_tp(args, torch, dist, device, rank, world, card):
    """``serve_cli.Model(tp=world)`` of an MoE model (Mixtral's widths,
    8 layers) over a tp mesh of all the ranks, every rank generating the
    same greedy requests (serve_paged's prompts): rank 0's streams held
    to one GPU's ``Model.generate`` on the same weights (seed 0) by the
    margin rule (SERVE_MARGIN), a parting past it by the router rule
    (``router_ties``), times beside it."""
    import numpy as np

    from container_engine_accelerators_tpu_torch.models import serve_cli
    from container_engine_accelerators_tpu_torch.models import (
        transformer as tf,
    )
    from container_engine_accelerators_tpu_torch.parallel import (
        mesh as pmesh,
    )
    from container_engine_accelerators_tpu_torch.parallel import (
        tensor_parallel as tpar,
    )

    cfg = _moe_serve_cfg(args, device)
    mesh = pmesh.make_mesh(pmesh.plan_mesh(world, {"tp": world}),
                           device.type)
    model = serve_cli.Model(cfg, seed=0, device=str(device), tp=world,
                            axes=tpar.Axes.of_mesh(mesh))
    prompts = {n: p for n, p in _serve_prompts(np, cfg).items()
               if n in ("ttft", "prefix", "long")}

    def run(m):
        tokens, wall = {}, {}
        for name, (prompt, max_new) in prompts.items():
            t0 = time.perf_counter()
            tokens[name] = m.generate([prompt], max_new)[0]
            wall[name] = time.perf_counter() - t0
        return tokens, wall

    got, wall = run(model)
    every = [None] * world
    dist.all_gather_object(every, got)
    del model
    _release(torch, device)
    ok = all(e == got for e in every)
    row = {"check": "serve_moe_tp", "tp": world, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_experts": cfg.n_experts,
           "dtype": cfg.dtype, "ranks_agree": ok, "wall_s": wall, **card}
    if rank == 0:
        one = serve_cli.Model(cfg, seed=0, device=str(device))
        want, one_wall = run(one)
        partings = _partings(torch, tf, one,
                             {n: (p, m) for n, (p, m) in prompts.items()},
                             got, want)
        for r in partings:
            if r["margin"] >= SERVE_MARGIN:
                # The world's shards are gone: the same split in this
                # process routes as they did.
                context = want[r["request"]][:len(prompts[r["request"]][0])
                                             + r["generated_index"]]
                r["router"] = router_ties(
                    routing(torch, tf, serve_cli.Model(
                        cfg, weights=one.model, tp=world), context),
                    routing(torch, tf, one, context))
        good = all(r["margin"] < SERVE_MARGIN or r["router"]["router_tie"]
                   for r in partings)
        row.update(one_gpu_wall_s=one_wall, partings=partings,
                   margin_limit=SERVE_MARGIN, ok=ok and good)
        ok = ok and good
        del one
        _release(torch, device)
    _emit(rank, row)
    dist.barrier()
    flags = [None] * world
    dist.all_gather_object(flags, ok)
    return all(flags)


CHECKS = {"ring": check_ring, "train": check_train, "pp": check_pp,
          "tp": check_tp, "ep": check_ep, "collectives": check_collectives,
          "serve_moe_tp": check_serve_moe_tp, "moe_sp": check_moe_sp,
          "tp_whole": check_tp_whole}
# The checks run when --checks is not given.
DEFAULT_CHECKS = ["ring", "train", "pp", "tp", "ep"]
# Checks the launcher runs itself: their worlds are serve_cli or
# collectives CLI processes. "collectives" is both: the ranks hold the
# ops' outputs, then the launcher runs the CLI's sweeps.
LAUNCHER_CHECKS = {"serve_tp": check_serve_tp,
                   "collectives": check_collectives_sweep}


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
        ok = True
        for name in args.checks:
            if name in CHECKS:
                ok = CHECKS[name](args, torch, dist, device, rank, world,
                                  card) and ok
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
    p.add_argument("--full-width", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="also run the tp and ep checks at published widths "
                        "in bf16 (default: on CUDA)")
    p.add_argument("--wide-shrink", type=int, default=1,
                   help="divide the full-width steps' widths, vocabulary "
                        "and sequence by this (a CPU rehearsal)")
    p.add_argument("--timeout-s", type=float, default=600.0)
    p.add_argument("--checks", nargs="+",
                   choices=sorted({**CHECKS, **LAUNCHER_CHECKS}),
                   default=DEFAULT_CHECKS,
                   help="the checks to run, in this order (default: "
                        f"{' '.join(DEFAULT_CHECKS)})")
    p.add_argument("--collective-min", default="1M",
                   help="collectives: the sweep's smallest message")
    p.add_argument("--collective-max", default="256M",
                   help="collectives: the sweep's largest message")
    p.add_argument("--log-dir", default="",
                   help="serve_tp: where the ranks' logs go (default a "
                        "temporary directory)")
    p.add_argument("--rank-process", action="store_true",
                   help=argparse.SUPPRESS)
    return p


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    if args.rank_process:
        return run_rank(args)
    rc = 0
    if any(name in CHECKS for name in args.checks):
        rc = launch(args, argv)
    for name in args.checks:
        if name in LAUNCHER_CHECKS:
            ok = LAUNCHER_CHECKS[name](args)
            print(json.dumps({"ok": ok, "launcher_checks": [name],
                              "world": args.world}), flush=True)
            rc = max(rc, 0 if ok else 1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
