# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""One rank of a multi-process gloo world for the port's parallel tests.

    python tests/torch_dist_worker.py <scenario> <rank> <world> <dir>

Joins a gloo world through a ``file://`` store in ``<dir>`` (a test's own
``tmp_path``, so concurrent tests never share a rendezvous), runs the
scenario on meshes of ``train_cli.build_mesh`` and writes
``<dir>/<scenario>_rank<rank>.pkl``:

  ring    every case of ``RING_CASES[world]``, on the ``{"dp": dp, "sp":
          world / dp}`` mesh of its dp: this rank's shard of the output
          and of dq, dk, dv for the cotangent ``g`` (``ring_inputs``)
  train   every case of ``<dir>/train_in.pkl`` (JAX's initial weights
          and batches, written by the test) on the mesh of its sp: the
          port's train step, a step per batch; the losses, the final
          weights and, for the AdamW models, the moments
  tp_train  every case of ``<dir>/tp_in.pkl`` on the mesh of its sp, tp
          and ep: one tensor- or expert-parallel step; the loss and the
          merged gradients at JAX's weights
  overlap the ring collective matmuls over a "tp" mesh of the world,
          uni- and bidirectional, forward and gradients
  serve_tp  ``serve_cli.main(argv)`` of ``<dir>/serve_tp_in.pkl`` on JAX's
          weights, in a world the process joins itself through the env
          contract (``serve_world`` sets it; no ``file://`` store): its
          exit code and the JSON lines it printed
  collectives  every op of ``collectives/bench.py`` (``COLLECTIVE_CASES``)
          on the world's 1-D ``("x",)`` mesh and its ``dcn`` 2 × ``x``
          hybrid mesh: this rank's inputs and outputs; then every bench
          and a sweep at ``iters=1``: their results' JSON
  moe_tp  ``serve_cli.Model(tp=world)`` over a "tp" mesh of the world on
          the MoE weights of ``<dir>/moe_tp_in.pkl`` (JAX's tree): the
          greedy streams of its cases
  collectives_cli  ``collectives.__main__.main(argv)`` of
          ``<dir>/collectives_cli_in.pkl`` in a world joined through the
          env contract (``serve_world`` sets it): its exit code, the lines
          it printed, and the port and exposition of each
          ``--metrics-port`` endpoint it served (a fake ``serve``)
  serve_link  the phases of ``<dir>/serve_link_in.pkl`` on a linked
          ``--tp 2`` world joined the same way: each a fresh engine over
          the lockstep link (``_lead_phase``) and its replay
          (``serve_cli._follow``); rank 0's tokens, handoff results and
          replicated state, the followers' replicated state

Imports torch and the port only: the tests import this module for its
inputs and compare against the JAX package themselves.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, dp, impl, causal, B, Hq, Hkv, S, D) per world size: GQA
# everywhere but "mha"; dp 2 of a world of 4 is the 2×2 dp×sp mesh.
RING_CASES = {
    2: [("flash_causal", 1, "flash", True, 2, 4, 2, 64, 16),
        ("flash_full", 1, "flash", False, 2, 4, 2, 64, 16),
        ("plain_causal", 1, "plain", True, 2, 4, 2, 64, 16),
        ("plain_full", 1, "plain", False, 2, 4, 2, 64, 16),
        ("flash_mha", 1, "flash", True, 1, 2, 2, 64, 16)],
    4: [("flash_causal", 1, "flash", True, 2, 4, 2, 64, 16),
        ("flash_full", 1, "flash", False, 2, 4, 2, 64, 16),
        ("plain_causal", 1, "plain", True, 2, 4, 2, 64, 16),
        ("dpxsp_flash_causal", 2, "flash", True, 2, 4, 2, 64, 16),
        ("dpxsp_plain_causal", 2, "plain", True, 2, 4, 2, 64, 16)],
}


def ring_inputs(case):
    """The global q, k, v and cotangent g of a ring case, f32, from a
    numpy generator seeded by the case's shape."""
    b, hq, hkv, s, d = case[4:]
    rng = np.random.default_rng(hq * 1000 + hkv * 100 + s + b)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    return (normal(b, hq, s, d), normal(b, hkv, s, d), normal(b, hkv, s, d),
            normal(b, hq, s, d))


def shard(x, dp_index, dp, sp_index, sp):
    """A rank's block of a (B, H, S, D) array: its rows and positions."""
    rows, seq = x.shape[0] // dp, x.shape[2] // sp
    return x[dp_index * rows:(dp_index + 1) * rows, :,
             sp_index * seq:(sp_index + 1) * seq]


def _ring(world):
    import torch

    from container_engine_accelerators_tpu_torch.models import train_cli
    from container_engine_accelerators_tpu_torch.parallel import (
        data_parallel,
        ring_attention,
    )

    meshes = {}
    out = {}
    for case in RING_CASES[world]:
        name, dp, impl, causal = case[:4]
        if dp not in meshes:
            meshes[dp] = train_cli.build_mesh(world, world // dp, 1,
                                              device_type="cpu")
        mesh = meshes[dp]
        dp_index = data_parallel.axis(mesh, "dp")[0]
        sp_index, sp = data_parallel.axis(mesh, "sp")
        q, k, v, g = (torch.tensor(shard(x, dp_index, dp, sp_index, sp),
                                   requires_grad=True)
                      for x in ring_inputs(case))
        o = ring_attention.ring_attention(q, k, v, mesh, "sp",
                                          causal=causal, impl=impl)
        o.backward(g.detach())
        out[name] = {"out": o.detach().numpy(), "dq": q.grad.numpy(),
                     "dk": k.grad.numpy(), "dv": v.grad.numpy()}
    return out


def _moments(model, opt, grads_to_jax):
    """AdamW's first and second moments (optax's ``mu`` and ``nu``) as
    JAX-layout trees, read through the gradient reader: each parameter's
    ``.grad`` set to the moment in turn."""
    out = {}
    for key, name in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        for p in model.parameters():
            p.grad = opt.state[p][key]
        out[name] = grads_to_jax(model)
    return out


def _train(world, workdir):
    import torch

    from container_engine_accelerators_tpu_torch.models import (
        bert,
        mnist,
        resnet,
        train_cli,
        transformer,
        weights,
    )

    with open(os.path.join(workdir, "train_in.pkl"), "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, case in cases.items():
        model_kind = case["model"]
        mesh = train_cli.build_mesh(world, case["sp"], 1, device_type="cpu")
        if model_kind == "transformer":
            cfg = transformer.TransformerConfig(**case["cfg"])
            model = weights.params_from_jax(case["params"], cfg,
                                            device="cpu")
            init, step = transformer.make_train_step(cfg, device="cpu",
                                                     mesh=mesh)
        elif model_kind == "mnist":
            model = weights.load_jax_tree(mnist.Mnist("cpu"), case["params"])
            init, step = mnist.make_train_step(device="cpu", mesh=mesh)
        elif model_kind == "bert":
            cfg = bert.BertConfig(**case["cfg"])
            model = weights.load_jax_tree(bert.Bert(cfg, "cpu"),
                                          case["params"])
            init, step = bert.make_train_step(cfg, device="cpu", mesh=mesh)
        else:
            model = resnet.ResNet([1, 1], 10, torch.float32, "cpu")
            weights.load_jax_tree(model, case["params"])
            weights.load_jax_tree(model, case["batch_stats"])
            init, step = resnet.make_train_step(None, mesh=mesh)
        state = init(model=model)
        losses = []
        for batch in case["batches"]:
            state, loss = step(state, batch)
            losses.append(float(loss))
        result = {"losses": losses}
        if model_kind == "transformer":
            result["params"] = weights.params_to_jax(model)
            result.update(_moments(model, state[1], weights.grads_to_jax))
        else:
            result["params"] = weights.jax_tree(model)
        if model_kind == "bert":
            result.update(_moments(model, state[1],
                                   lambda m: weights.jax_tree(m, "grads")))
        if model_kind == "resnet":
            result["batch_stats"] = weights.jax_tree(model, "buffers")
        out[name] = result
    return out


# -- the pipeline schedules (tests/test_torch_pipeline.py) --------------------

def pipeline_inputs(n_stages, n_micro, mb=2, dim=16):
    """(W (N, dim, dim), b (N, dim), x (M, mb, dim), targets, the loss's
    per-feature scale), f32, from a numpy generator seeded by the
    shape."""
    rng = np.random.default_rng(100 * n_stages + n_micro)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return (normal(n_stages, dim, dim, scale=0.3),
            normal(n_stages, dim, scale=0.1), normal(n_micro, mb, dim),
            normal(n_micro, mb, dim, scale=0.5),
            1.0 + normal(dim, scale=0.1))


def stage(params, x):
    """``tests/test_pipeline.py``'s tanh-linear stage."""
    import torch

    w, b = params
    return torch.tanh(x @ w + b)


def pipeline_loss(y, tgt, lp):
    return ((y * lp["scale"] - tgt) ** 2).mean()


def _pipeline_run(inputs, transport, held):
    """``pipeline_train_1f1b`` (loss params, dx) over ``transport``,
    which holds the stages ``held``."""
    import torch

    from container_engine_accelerators_tpu_torch.parallel import pipeline

    ws, bs, x, tgt, scale = (torch.tensor(a) for a in inputs)
    return pipeline.pipeline_train_1f1b(
        stage, pipeline_loss, [(ws[i], bs[i]) for i in held], x, tgt,
        transport, loss_params={"scale": scale}, return_dx=True)


def pipeline_in_process(inputs):
    from container_engine_accelerators_tpu_torch.parallel import (
        ring_attention,
    )

    n = inputs[0].shape[0]
    return _pipeline_run(inputs, ring_attention.InProcess(n), range(n))


def _apply_run(inputs, transport, held):
    """``pipeline_apply`` with loss sum(out²): (out, each held stage's
    dW)."""
    import torch

    from container_engine_accelerators_tpu_torch.parallel import pipeline

    ws, bs, x = (torch.tensor(a) for a in inputs[:3])
    w_leaves = [ws[i].clone().requires_grad_(True) for i in held]
    out = pipeline.pipeline_apply(
        stage, [(w, bs[i]) for w, i in zip(w_leaves, held)], x, transport)
    (out * out).sum().backward()
    return out.detach().numpy(), [w.grad.numpy() for w in w_leaves]


def pipeline_apply_in_process(inputs):
    from container_engine_accelerators_tpu_torch.parallel import (
        ring_attention,
    )

    n = inputs[0].shape[0]
    return _apply_run(inputs, ring_attention.InProcess(n), range(n))


def _pipeline(world, workdir):
    """Every case of ``<dir>/pipeline_in.pkl`` ({name: (N, M)}, N the
    world) over the ``P2P`` transport of this rank's stage."""
    from container_engine_accelerators_tpu_torch.parallel import (
        mesh as pmesh,
        ring_attention,
    )

    with open(os.path.join(workdir, "pipeline_in.pkl"), "rb") as f:
        cases = pickle.load(f)
    mesh = pmesh.make_mesh(pmesh.plan_mesh(world, {"pp": world}), "cpu")
    ring = ring_attention.ring_of(mesh, "pp")
    transport = ring_attention.P2P(ring)
    out = {}
    for name, (n, m) in cases.items():
        inputs = pipeline_inputs(n, m)
        if ring.index != 0:
            # Only stage 0 reads the inputs.
            inputs = (*inputs[:2], np.full_like(inputs[2], np.nan),
                      *inputs[3:])
        loss, (grads,), lpg, dx = _pipeline_run(inputs, transport,
                                                [ring.index])
        apply_out, (apply_dw,) = _apply_run(inputs, transport, [ring.index])
        out[name] = {"loss": float(loss), "dw": grads[0].numpy(),
                     "db": grads[1].numpy(),
                     "dscale": lpg["scale"].numpy(), "dx": dx.numpy(),
                     "apply_out": apply_out, "apply_dw": apply_dw}
    return out


# -- tensor- and expert-parallel steps (test_torch_tp_train.py, _moe_ep.py) ---

def _tp_train(world, workdir):
    """Every case of ``<dir>/tp_in.pkl`` (JAX's initial weights and one
    global batch, written by the test) on ``build_mesh(world, sp, tp,
    ep)``: one step of the port's train step from those weights; the
    loss and the whole model's gradients at the initial weights (merged
    from every rank's shards), JAX-layout."""
    from container_engine_accelerators_tpu_torch.models import (
        bert,
        train_cli,
        transformer,
        weights,
    )
    from container_engine_accelerators_tpu_torch.parallel import (
        tensor_parallel,
    )

    with open(os.path.join(workdir, "tp_in.pkl"), "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, case in cases.items():
        mesh = train_cli.build_mesh(world, case["sp"], case["tp"],
                                    case["ep"], device_type="cpu")
        sharded = case["tp"] > 1 or case["ep"] > 1
        if case["model"] == "bert":
            cfg = bert.BertConfig(**case["cfg"])
            model = weights.load_jax_tree(bert.Bert(cfg, "cpu"),
                                          case["params"])
            init, step = bert.make_train_step(cfg, device="cpu", mesh=mesh)
        else:
            cfg = transformer.TransformerConfig(**case["cfg"])
            model = weights.params_from_jax(case["params"], cfg,
                                            device="cpu")
            init, step = transformer.make_train_step(
                cfg, device="cpu", mesh=mesh, overlap=case["overlap"])
        state = init(model=model)
        state, loss = step(state, case["batch"])
        if sharded:
            axes = tensor_parallel.Axes.of_mesh(mesh)
            grads = (weights.bert_tp_to_jax if case["model"] == "bert"
                     else weights.tp_to_jax)(list(state[0]), axes, "grads")
        elif case["model"] == "bert":
            grads = weights.jax_tree(state[0], "grads")
        else:
            grads = weights.grads_to_jax(state[0])
        out[name] = {"loss": float(loss), "grads": grads}
    return out


# -- the ring collective matmuls (tests/test_torch_overlap.py) -----------------

def overlap_inputs():
    """x (2, 16, 24) and two weights for the gathering ring, xr (2, 16,
    32) and wr (32, 8) for the scattering one, f32."""
    rng = np.random.default_rng(21)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    return (normal(2, 16, 24), normal(24, 8), normal(24, 12),
            normal(2, 16, 32), normal(32, 8))


def _overlap_run(transport, held, n):
    """Both rings over ``transport`` (ranks ``held`` of n), forward and
    backward with fixed cotangents, uni- and bidirectional: per
    direction a dict of per-rank numpy results (lists over ``held``)."""
    import torch

    from container_engine_accelerators_tpu_torch.parallel import overlap

    x, w1, w2, xr, wr = (torch.as_tensor(a) for a in overlap_inputs())
    out = {}
    for bidir in (False, True):
        xs = [c.clone().requires_grad_() for c in x.chunk(n, dim=-2)]
        w1s = [c.clone().requires_grad_() for c in w1.chunk(n, dim=-1)]
        w2s = [c.clone().requires_grad_() for c in w2.chunk(n, dim=-1)]
        ag = overlap.allgather_matmul(
            [xs[r] for r in held], [(w1s[r], w2s[r]) for r in held],
            transport, bidirectional=bidir)
        xrs = [c.clone().requires_grad_() for c in xr.chunk(n, dim=-1)]
        wrs = [c.clone().requires_grad_() for c in wr.chunk(n, dim=0)]
        rs = overlap.matmul_reducescatter(
            [xrs[r] for r in held], [wrs[r] for r in held], transport,
            bidirectional=bidir)
        loss = sum((a.square().sum() + 2 * b.sum()) for a, b in ag) + \
            sum((o * o).sum() for o in rs)
        loss.backward()
        res = {"ag0": [a.detach().numpy() for a, _ in ag],
               "ag1": [b.detach().numpy() for _, b in ag],
               "rs": [o.detach().numpy() for o in rs]}
        for name, group in (("dx", xs), ("dw1", w1s), ("dw2", w2s),
                            ("dxr", xrs), ("dwr", wrs)):
            res[name] = [group[r].grad.numpy() for r in held]
        out[bidir] = res
    return out


def overlap_in_process(n):
    """Every rank of the rings in this process (``InProcess``)."""
    from container_engine_accelerators_tpu_torch.parallel.ring_attention \
        import InProcess

    return _overlap_run(InProcess(n), list(range(n)), n)


def _overlap(world):
    """This rank's results of the rings over P2P on a "tp" mesh of the
    world (each result its own, not a list)."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import mesh as pm
    from container_engine_accelerators_tpu_torch.parallel import (
        ring_attention,
    )

    mesh = pm.make_mesh(pm.plan_mesh(world, {"tp": world}), "cpu")
    ring = ring_attention.ring_of(mesh, "tp")
    res = _overlap_run(ring_attention.P2P(ring), [dist.get_rank()], world)
    return {bidir: {k: v[0] for k, v in r.items()}
            for bidir, r in res.items()}


# -- train_cli worlds through the env contract -------------------------------

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_world(argv, workdir, tag, world=2, timeout=240):
    """``world`` train_cli processes joined through the env contract
    (``argv`` a list, or a function of the rank giving each its own);
    returns [(rc, result or None, log)] in rank order and the markers'
    text."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "MEGASCALE_", "LOCAL_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO, TPU_WORKER_ID="0",
               TPU_WORKER_HOSTNAMES="127.0.0.1",
               TPU_COORDINATOR_PORT=str(port),
               LOCAL_WORLD_SIZE=str(world))
    procs = []
    for rank in range(world):
        marker = os.path.join(workdir, f"{tag}_health{rank}.log")
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "container_engine_accelerators_tpu_torch.models.train_cli",
             *(argv(rank) if callable(argv) else argv)],
            env={**env, "LOCAL_RANK": str(rank),
                 "TPU_HEALTH_CHECK_LOG_FILE": marker},
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    runs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=timeout)
            lines = out.strip().splitlines()
            runs.append((proc.returncode,
                         json.loads(lines[-1]) if lines else None, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    markers = []
    for rank in range(world):
        path = os.path.join(workdir, f"{tag}_health{rank}.log")
        markers.append(open(path).read() if os.path.exists(path) else "")
    return runs, markers


def _serve_tp(rank, workdir):
    """One rank of ``serve_cli --tp``: the served model's weights are
    JAX's (``weights.params_from_jax`` of the input's tree), so rank 0's
    tokens can be held to the JAX server's."""
    import contextlib
    import io

    from container_engine_accelerators_tpu_torch.models import serve_cli
    from container_engine_accelerators_tpu_torch.models import transformer
    from container_engine_accelerators_tpu_torch.models import weights

    with open(os.path.join(workdir, "serve_tp_in.pkl"), "rb") as f:
        given = pickle.load(f)
    cfg = transformer.TransformerConfig(**given["cfg"])
    whole = weights.params_from_jax(given["tree"], cfg, device="cpu")

    class JaxWeightsModel(serve_cli.Model):
        def __init__(self, cfg, **kwargs):
            super().__init__(cfg, weights=whole, **kwargs)

    serve_cli.Model = JaxWeightsModel
    argv = given.get("argv_of", {}).get(rank, given["argv"])
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = serve_cli.main(argv)
        err = ""
    except Exception as e:  # noqa: BLE001 - the test reads it
        rc, err = 1, f"{type(e).__name__}: {e}"
    lines = [json.loads(line) for line in out.getvalue().splitlines()
             if line.startswith("{")]
    return {"rc": rc, "lines": lines, "error": err}


def _mirror(engine):
    """A paged engine's replicated state: page tables, free blocks,
    radix size and the device token vector (equal on every rank of a
    linked world)."""
    kv = engine.kv
    return {"tables": [list(map(int, r)) for r in kv.tables],
            "free": kv.free_blocks(), "radix": kv.cached_blocks(),
            "last_dev": [int(t) for t in engine.last_dev]}


def _lead_phase(serve_cli, args, model, group, rank_hosts, phase):
    """Rank 0 of one phase of ``serve_link``: the engine serve_cli builds
    over the link (``build_serving``), its warm plan under
    ``--warmup=all``, the phase's requests (under its fault plan), then
    its export, corrupt install and install with the continuation."""
    from container_engine_accelerators_tpu_torch import faults
    from container_engine_accelerators_tpu_torch.kvcache import handoff
    from container_engine_accelerators_tpu_torch.warmstart import warmup

    def link_of(events, registry):
        return serve_cli.LockstepEngineLink(
            model.cfg, args.max_slots, timeout_s=args.link_timeout_s,
            rank=0, rank_hosts=rank_hosts, events=events,
            registry=registry, group=group)

    engine, _, _, _ = serve_cli.build_serving(args, model, link_of=link_of)
    if args.warmup == "all":
        warmup.warm_engine(engine, mode="all", events=engine.events)
    res = {}
    try:
        if phase.get("plan"):
            faults.arm(faults.FaultPlan(phase["plan"]))
        try:
            res["tokens"] = [engine.generate([p], m)[0]
                             for p, m in phase["cases"]]
        finally:
            faults.disarm()
        res["stats"] = {k: v for k, v in engine.stats().items()
                        if k.startswith("spec_")}
        res["retries"] = int(engine._m_retries.value)
        if phase.get("export"):
            res["frames"] = engine.kv_export(phase["export"])
        if phase.get("corrupt"):
            seq, before = engine.link._seq, _mirror(engine)
            try:
                engine.kv_install(phase["corrupt"])
                res["corrupt"] = "installed"
            except handoff.HandoffDesync as e:
                res["corrupt"] = f"HandoffDesync: {e}"
            res["corrupt_unchanged"] = (engine.link._seq == seq
                                        and _mirror(engine) == before)
        if phase.get("install"):
            res["installed"] = engine.kv_install(phase["install"])
            prompt, max_new = phase["continue"]
            hit0 = engine.kv_stats()["prefix_hit_tokens"]
            res["continued"] = engine.generate([prompt], max_new)[0]
            res["hit"] = engine.kv_stats()["prefix_hit_tokens"] - hit0
        res["state"] = _mirror(engine)
    finally:
        engine.shutdown()
    return res


def _serve_link(rank, workdir):
    """One rank of a linked ``serve_cli --tp`` world on one host, driven
    through serve_cli's own builders phase by phase (each phase a fresh
    engine on rank 0 and ``_follow`` on the others, over one model and
    one link group): rank 0 reports each phase's tokens, handoff results
    and replicated state, the followers their replicated state as each
    phase's replay ends."""
    from container_engine_accelerators_tpu_torch.models import serve_cli
    from container_engine_accelerators_tpu_torch.models import transformer
    from container_engine_accelerators_tpu_torch.models import weights

    with open(os.path.join(workdir, "serve_link_in.pkl"), "rb") as f:
        given = pickle.load(f)
    cfg = transformer.TransformerConfig(**given["cfg"])
    whole = weights.params_from_jax(given["tree"], cfg, device="cpu")
    base = ["--tp", "2", "--device", "cpu", "--port", "0", *given["flags"]]
    parse = serve_cli.build_parser().parse_args
    rank_, device, axes, group, rank_hosts = serve_cli.join_tp_world(
        parse(base))
    model = serve_cli.Model(cfg, device=device, tp=2, axes=axes,
                            weights=whole)
    states = []
    replay = serve_cli.engine_follower_loop

    def recorded(engine, link, warm=None):
        try:
            return replay(engine, link, warm=warm)
        finally:
            states.append(_mirror(engine))

    serve_cli.engine_follower_loop = recorded
    phases = []
    for phase in given["phases"]:
        args = parse(base + phase["argv"])
        if rank_:
            serve_cli._follow(args, model, group, rank_, rank_hosts)
        else:
            phases.append(_lead_phase(serve_cli, args, model, group,
                                      rank_hosts, phase))
    return {"phases": phases, "states": states}


# (op, per-device elements, the matmul's per-device rows): sizes whose
# bf16 sums stay exact integers (below 256 at 4 ranks), so an output is
# the same whatever order a backend sums in; the data moves also at a
# size whose arange values bf16 rounds.
COLLECTIVE_CASES = (("psum", 16), ("all_gather", 16), ("all_gather", 4096),
                    ("reduce_scatter", 16), ("ppermute", 16),
                    ("ppermute", 4096), ("collective_matmul", 4))


def collective_matmul_inputs(rows, n):
    """Integer-valued f32 x (rows · n, K) and w (K, N) in [-1, 1] from
    one seed: their products' f32 sums are exact, so the ring's output
    does not depend on the order it accumulates in."""
    from container_engine_accelerators_tpu_torch.collectives import bench

    rng = np.random.default_rng(17)
    x = rng.integers(-1, 2, (rows * n, bench._CM_K)).astype(np.float32)
    w = rng.integers(-1, 2, (bench._CM_K, bench._CM_N)).astype(np.float32)
    return x, w


def _collective_case(bench, torch, mesh, axis, name, elems):
    """One op of ``bench`` on this rank: (its input, its output)."""
    n = bench.axis_size(mesh, axis)
    bf16 = torch.bfloat16
    if name == "psum":
        x = bench._sharded_input(mesh, elems, bf16)
        return x.clone(), bench.psum_op(mesh, axis)(x)
    if name in ("all_gather", "ppermute"):
        x = bench._sharded_input(mesh, elems, bf16)
        out = torch.empty(n * elems if name == "all_gather" else elems,
                          dtype=bf16)
        op = (bench.all_gather_op if name == "all_gather"
              else bench.ppermute_op)(mesh, axis)
        return x, op(x, out)
    if name == "reduce_scatter":
        full = bench.reduce_scatter_input(mesh, axis, elems, bf16)
        out = torch.empty(elems, dtype=bf16)
        return full, bench.reduce_scatter_op(mesh, axis)(full, out)
    x, w = collective_matmul_inputs(elems, n)
    i = mesh.get_local_rank(axis)
    xs = torch.from_numpy(x).to(bf16).chunk(n, dim=0)[i].contiguous()
    ws = torch.from_numpy(w).to(bf16).chunk(n, dim=1)[i].contiguous()
    return xs, bench.collective_matmul_op(mesh, axis)(xs, ws)


def _collectives(world):
    import torch

    from container_engine_accelerators_tpu_torch.collectives import bench
    from container_engine_accelerators_tpu_torch.parallel import mesh as pm

    meshes = {"x": (pm.make_mesh(pm.plan_mesh(world, {"x": -1}), "cpu"),
                    "x"),
              "dcn": (pm.make_hybrid_mesh({"dcn": 2}, {"x": -1}, 2,
                                          device_type="cpu"), "dcn")}
    ops, results = {}, {}
    for tier, (mesh, axis) in meshes.items():
        for name, elems in COLLECTIVE_CASES:
            x, y = _collective_case(bench, torch, mesh, axis, name, elems)
            ops[tier, name, elems] = (x.float().numpy(), y.float().numpy())
        for name, fn in bench.BENCHES.items():
            results[tier, name] = fn(1 << 12, mesh=mesh, iters=1,
                                     axis=axis).to_json()
    sweep = [r.msg_bytes for r in bench.sweep(
        "ppermute", min_bytes=1 << 12, max_bytes=1 << 14, factor=2,
        mesh=meshes["x"][0], iters=1)]
    return {"ops": ops, "results": results, "sweep": sweep}


def _moe_tp(world, workdir):
    from container_engine_accelerators_tpu_torch.models import serve_cli
    from container_engine_accelerators_tpu_torch.models import weights
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerConfig,
    )
    from container_engine_accelerators_tpu_torch.parallel import mesh as pm
    from container_engine_accelerators_tpu_torch.parallel import (
        tensor_parallel as tpar,
    )

    with open(os.path.join(workdir, "moe_tp_in.pkl"), "rb") as f:
        given = pickle.load(f)
    cfg = TransformerConfig(**given["cfg"])
    whole = weights.params_from_jax(given["tree"], cfg, device="cpu")
    mesh = pm.make_mesh(pm.plan_mesh(world, {"tp": world}), "cpu")
    model = serve_cli.Model(cfg, device="cpu", tp=world, weights=whole,
                            axes=tpar.Axes.of_mesh(mesh))
    return [model.generate([p], n) for p, n in given["cases"]]


def _collectives_cli(rank, workdir):
    """One rank of the collectives CLI in a world it joins itself."""
    import contextlib
    import io

    from container_engine_accelerators_tpu_torch.collectives import (
        __main__ as cli,
    )
    from container_engine_accelerators_tpu_torch.obs import (
        metrics as obs_metrics,
    )

    with open(os.path.join(workdir, "collectives_cli_in.pkl"), "rb") as f:
        given = pickle.load(f)
    served = []

    def fake_serve(port, registry=None, owner=""):
        served.append((port, registry))

    obs_metrics.serve = fake_serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(given["argv"])
    return {"rc": rc, "lines": out.getvalue().splitlines(),
            "served": [(port, reg.render().decode())
                       for port, reg in served]}


def main(argv):
    scenario, rank, world, workdir = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, REPO)
    if scenario in ("serve_tp", "serve_link", "collectives_cli"):
        out = {"serve_tp": _serve_tp, "serve_link": _serve_link,
               "collectives_cli": _collectives_cli}[scenario](rank, workdir)
        with open(os.path.join(workdir, f"{scenario}_rank{rank}.pkl"),
                  "wb") as f:
            pickle.dump(out, f)
        return
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rdv')}",
        rank=rank, world_size=world)
    try:
        if scenario == "ring":
            out = _ring(world)
        elif scenario == "train":
            out = _train(world, workdir)
        elif scenario == "pipeline":
            out = _pipeline(world, workdir)
        elif scenario == "overlap":
            out = _overlap(world)
        elif scenario == "tp_train":
            out = _tp_train(world, workdir)
        elif scenario == "collectives":
            out = _collectives(world)
        elif scenario == "moe_tp":
            out = _moe_tp(world, workdir)
        else:
            raise ValueError(f"unknown scenario {scenario!r}")
    finally:
        dist.destroy_process_group()
    path = os.path.join(workdir, f"{scenario}_rank{rank}.pkl")
    with open(path, "wb") as f:
        pickle.dump(out, f)


def serve_world(given, workdir, world=2, timeout=240, scenario="serve_tp"):
    """``world`` ranks of ``scenario`` (``serve_tp``, or ``serve_link``)
    joined through the
    env contract (one host, ``LOCAL_RANK`` 0..world-1, a free coordinator
    port) on ``given`` ({"cfg", "tree", "argv"}, and "argv_of": {rank:
    argv} for ranks that take other flags); returns [(returncode, the
    rank's output or None, its log)] in rank order. A world that outlives
    ``timeout`` is killed."""
    with open(os.path.join(workdir, f"{scenario}_in.pkl"), "wb") as f:
        pickle.dump(given, f)
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "MEGASCALE_", "LOCAL_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO, TPU_WORKER_ID="0",
               TPU_WORKER_HOSTNAMES="127.0.0.1",
               TPU_COORDINATOR_PORT=str(port), LOCAL_WORLD_SIZE=str(world))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(rank),
         str(world), str(workdir)],
        env={**env, "LOCAL_RANK": str(rank)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    runs = []
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        path = os.path.join(workdir, f"{scenario}_rank{rank}.pkl")
        out = None
        if os.path.exists(path):
            with open(path, "rb") as f:
                out = pickle.load(f)
            os.remove(path)
        runs.append((proc.returncode, out, log))
    return runs


def spawn(scenario, world, workdir, timeout=300):
    """Run ``scenario`` in a gloo world of ``world`` processes of this
    script (one thread each, so the ranks do not oversubscribe the
    cores); returns each rank's output in rank order. A rank that fails
    or a world that outlives ``timeout`` kills the rest and raises with
    every rank's log."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "MEGASCALE_", "LOCAL_"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(rank),
         str(world), str(workdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError(
            f"ranks {failed} of the {scenario} world failed:\n"
            + "\n".join(f"--- rank {r}\n{log}" for r, log in enumerate(logs)))
    outs = []
    for rank in range(world):
        with open(os.path.join(workdir, f"{scenario}_rank{rank}.pkl"),
                  "rb") as f:
            outs.append(pickle.load(f))
    return outs


if __name__ == "__main__":
    main(sys.argv[1:])
