# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's bootstrap, mesh plans and ring attention against the JAX
package's.

Bootstrap: the env parsing, its errors, the multislice arithmetic and the
health marker on the envs of ``tests/test_bootstrap.py``, each package's
answer (options or error text) equal; then the port's own one-process-
per-device mapping (``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``) and a real
gloo world of one. Mesh: ``plan_mesh`` and ``plan_hybrid_mesh`` on the
cases of ``tests/test_parallel.py``. Ring: 2- and 4-process gloo worlds
(``tests/torch_dist_worker.py``; a ``file://`` rendezvous in the test's
own ``tmp_path``) run ``ring_attention`` with ``impl="flash"`` (the
kernels' plain versions on the CPU) and ``"plain"``, causal and not,
GQA and MHA, on an sp ring and on a 2×2 dp×sp mesh; each rank's output
and q/k/v gradient shards, put together, are held to JAX's
``ring_attention`` on ``Mesh(jax.devices()[:N])`` with the same
cotangent, in f32: its Pallas flash ring in interpret mode for both
impls (its XLA block ring gives the same numbers and takes 40-70 s a
case to compile here; JAX's own ``tests/test_ring_attention.py`` holds
the two together).
"""

import functools
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import torch_dist_worker as worker  # noqa: E402
from container_engine_accelerators_tpu.parallel import bootstrap as jboot  # noqa: E402
from container_engine_accelerators_tpu.parallel import mesh as jmesh  # noqa: E402
from container_engine_accelerators_tpu.parallel.ring_attention import (  # noqa: E402
    ring_attention as jax_ring_attention,
)
from container_engine_accelerators_tpu_torch.parallel import bootstrap  # noqa: E402
from container_engine_accelerators_tpu_torch.parallel import mesh  # noqa: E402

# f32 on both sides, the blocks summed and combined in other orders:
# outputs (of unit size) to 2e-5, gradients to 1e-4 (sums over up to 64
# keys of products of unit-size terms).
OUT_ATOL = 2e-5
GRAD_ATOL = 1e-4


# -- bootstrap -----------------------------------------------------------------

def _gang(rank="1", hosts="h0,h1", **extra):
    return {"TPU_WORKER_ID": rank, "TPU_WORKER_HOSTNAMES": hosts, **extra}


MS = {"MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1",
      "MEGASCALE_COORDINATOR_ADDRESS": "s0h0"}

# The envs of tests/test_bootstrap.py, plus a few malformed neighbours.
ENVS = {
    "complete": _gang("2", "host-a,host-b,host-c"),
    "custom_port": _gang("0", "h0,h1", TPU_COORDINATOR_PORT="9999"),
    "empty": {},
    "no_hostnames": {"TPU_WORKER_ID": "0"},
    "id_not_int": _gang("x", "a"),
    "id_out_of_range": _gang("5", "a,b"),
    "hostnames_blank": _gang("0", " , "),
    "port_not_int": _gang("0", "h0", TPU_COORDINATOR_PORT="p"),
    "multislice": {**_gang("1", "s1h0,s1h1"), **MS},
    "multislice_explicit_port": {
        **_gang("0", "s1h0"), **MS,
        "MEGASCALE_COORDINATOR_ADDRESS": "c:9999"},
    "multislice_megascale_port": {
        **_gang("0", "s1h0"), **MS, "MEGASCALE_PORT": "9000",
        "TPU_COORDINATOR_PORT": "8500"},
    "multislice_partial": {**_gang("0", "h0"), "MEGASCALE_NUM_SLICES": "2"},
    "multislice_one_slice": {**_gang("0", "h0"), **MS,
                             "MEGASCALE_NUM_SLICES": "1",
                             "MEGASCALE_SLICE_ID": "0"},
    "multislice_id_out_of_range": {**_gang("0", "h0"), **MS,
                                   "MEGASCALE_SLICE_ID": "2"},
    "multislice_not_int": {**_gang("0", "h0"), **MS,
                           "MEGASCALE_SLICE_ID": "one"},
    "multislice_bad_megascale_port": {
        **_gang("0", "h0"), **MS, "MEGASCALE_PORT": "x"},
}


def _answer(fn, env):
    try:
        return ("ok", fn(env))
    except Exception as err:  # noqa: BLE001 - the answer is compared
        return (type(err).__name__, str(err))


@pytest.mark.parametrize("name", sorted(ENVS))
@pytest.mark.parametrize("fn", ["distributed_options", "multislice_options",
                                "global_distributed_options"])
def test_env_contract_answers_as_jax_does(fn, name):
    env = ENVS[name]
    assert _answer(getattr(bootstrap, fn), env) == _answer(
        getattr(jboot, fn), env)


def test_contract_constants_are_jax_s():
    for const in ("WORKER_ID_ENV", "WORKER_HOSTNAMES_ENV",
                  "COORDINATOR_PORT_ENV", "DEFAULT_COORDINATOR_PORT",
                  "HEALTH_LOG_ENV", "HEALTH_LOG_MARKER",
                  "MEGASCALE_COORDINATOR_ENV", "MEGASCALE_NUM_SLICES_ENV",
                  "MEGASCALE_SLICE_ID_ENV", "MEGASCALE_PORT_ENV",
                  "DEFAULT_MEGASCALE_PORT"):
        assert getattr(bootstrap, const) == getattr(jboot, const), const


@pytest.mark.parametrize("env,rank,world", [
    (_gang("1", "h0,h1"), 1, 2),
    (_gang("1", "h0,h1", LOCAL_RANK="3", LOCAL_WORLD_SIZE="8"), 11, 16),
    (_gang("0", "h0", LOCAL_RANK="1", LOCAL_WORLD_SIZE="2"), 1, 2),
    # Slice 1 of 2, host 1 of 2, device 2 of 4: per_slice = 2 × 4.
    ({**_gang("1", "s1h0,s1h1"), **MS, "LOCAL_RANK": "2",
      "LOCAL_WORLD_SIZE": "4"}, 1 * 8 + 1 * 4 + 2, 16),
])
def test_one_process_per_device_mapping(env, rank, world):
    opts = bootstrap.process_options(env)
    glob = jboot.global_distributed_options(env)
    assert opts["rank"] == rank and opts["world_size"] == world
    assert opts["coordinator_address"] == glob["coordinator_address"]
    assert opts["process_id"] == glob["process_id"]
    per_slice = world // int(env.get("MEGASCALE_NUM_SLICES", 1))
    slice_id = int(env.get("MEGASCALE_SLICE_ID", 0))
    assert slice_id * per_slice <= rank < (slice_id + 1) * per_slice


@pytest.mark.parametrize("local,match", [
    ({"LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "2"}, "LOCAL_RANK=2 out of"),
    ({"LOCAL_RANK": "a"}, "LOCAL_RANK='a' is not an integer"),
    ({"LOCAL_WORLD_SIZE": "0"}, "LOCAL_WORLD_SIZE=0"),
])
def test_local_env_fails_loud(local, match):
    with pytest.raises(bootstrap.BootstrapError, match=match):
        bootstrap.process_options({**_gang("0", "h0"), **local})


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_world_of_one_writes_the_marker_after_truncating(tmp_path):
    """A real gloo world of one from the env contract: the stale marker
    of an earlier incarnation is gone and this one's line is JAX's."""
    import torch.distributed as dist

    log_file = tmp_path / "health.log"
    log_file.write_text("TPU_BOOTSTRAP_OK rank=7 world=9\n")
    env = {**_gang("0", "127.0.0.1"),
           "TPU_COORDINATOR_PORT": str(_free_port()),
           "TPU_HEALTH_CHECK_LOG_FILE": str(log_file)}
    opts = bootstrap.initialize_from_env(env, device="cpu")
    try:
        assert dist.get_rank() == 0 and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        assert opts["backend"] == "gloo" and opts["device"] == "cpu"
        assert opts["rank"] == 0 and opts["world_size"] == 1
        assert log_file.read_text() == "TPU_BOOTSTRAP_OK rank=0 world=1\n"
    finally:
        dist.destroy_process_group()


def test_failed_rendezvous_raises_bootstrap_error_and_writes_no_marker(
        tmp_path):
    """Rank 0 of a world of two whose other rank never comes: the
    rendezvous times out as a BootstrapError naming the variables, and
    the marker file stays empty."""
    log_file = tmp_path / "health.log"
    log_file.write_text("stale\n")
    env = {**_gang("0", "127.0.0.1,127.0.0.1"),
           "TPU_COORDINATOR_PORT": str(_free_port()),
           "TPU_HEALTH_CHECK_LOG_FILE": str(log_file)}
    with pytest.raises(bootstrap.BootstrapError,
                       match="TPU_WORKER_HOSTNAMES.*TPU_COORDINATOR_PORT"):
        bootstrap.initialize_from_env(env, device="cpu", timeout_s=2)
    assert log_file.read_text() == ""


def test_cuda_without_a_card_raises_before_the_rendezvous(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bootstrap.initialize_from_env(_gang("0", "127.0.0.1"))


# -- mesh plans ----------------------------------------------------------------

@pytest.mark.parametrize("n,axes", [
    (8, {"dp": 2, "tp": 4}),
    (8, {"dp": -1, "tp": 2}),
    (8, {"dp": -1, "sp": 2, "tp": 2}),
    (4, {"dp": -1, "sp": 4, "tp": 1}),
    (1, {"dp": -1, "sp": 1, "tp": 1}),
    (8, {"dp": 3, "tp": 2}),
    (8, {"dp": -1, "tp": -1}),
    (8, {"dp": -1, "tp": 3}),
    (8, {"dp": 0, "tp": 8}),
    (1, {"dp": -1, "sp": 2, "tp": 1}),
])
def test_plan_mesh_is_jax_s(n, axes):
    def port(_):
        plan = mesh.plan_mesh(n, axes)
        return plan.axis_names, plan.axis_sizes, plan.size

    def ref(_):
        plan = jmesh.plan_mesh(n, axes)
        return plan.axis_names, plan.axis_sizes, plan.size
    assert _answer(port, None) == _answer(ref, None)


@pytest.mark.parametrize("n,slices,dcn,ici", [
    (8, 2, {"dp": -1}, {"fsdp": -1, "tp": 2}),
    (8, 2, {"dp": 2}, {"tp": 4}),
    (8, 4, {"dp": -1}, {"sp": 2}),
    (8, 3, {"dp": -1}, {"tp": 2}),
    (8, 2, {"dp": 4}, {"tp": 4}),
])
def test_plan_hybrid_mesh_is_jax_s(n, slices, dcn, ici):
    def port(_):
        plan = mesh.plan_hybrid_mesh(n, slices, dcn, ici)
        return plan.axis_names, plan.axis_sizes

    def ref(_):
        plan = jmesh.plan_hybrid_mesh(n, slices, dcn, ici)
        return plan.axis_names, plan.axis_sizes
    assert _answer(port, None) == _answer(ref, None)


def test_slice_groups_are_contiguous_rank_ranges():
    assert mesh.slice_groups(8, 2) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.slice_groups(4) == [[0, 1, 2, 3]]
    with pytest.raises(ValueError, match="cannot chunk 6 ranks into 4"):
        mesh.slice_groups(6, 4)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialized process group"):
        mesh.make_mesh(mesh.plan_mesh(1, {"dp": -1}), "cpu")


# -- ring attention ------------------------------------------------------------

@pytest.fixture(scope="module")
def ring_worlds(tmp_path_factory):
    """Each world's per-rank outputs (one spawn per world size)."""
    return {n: worker.spawn("ring", n, str(tmp_path_factory.mktemp(f"w{n}")))
            for n in (2, 4)}


def _assemble(outs, key, shape, dp, sp):
    """Put the ranks' shards of ``key`` back into the global array: rank
    r holds rows of dp index r // sp and positions of sp index r % sp
    (the row-major (dp, sp) mesh)."""
    full = np.zeros(shape, np.float32)
    rows, seq = shape[0] // dp, shape[2] // sp
    for rank, out in enumerate(outs):
        i, j = divmod(rank, sp)
        full[i * rows:(i + 1) * rows, :, j * seq:(j + 1) * seq] = out[key]
    return full


@functools.lru_cache(maxsize=None)
def _jax_ring(case, n):
    dp, causal = case[1], case[3]
    q, k, v, g = worker.ring_inputs(case)
    devices = np.asarray(jax.devices()[:n])
    if dp == 1:
        jm, spec = Mesh(devices, ("sp",)), None
    else:
        jm = Mesh(devices.reshape(dp, n // dp), ("dp", "sp"))
        spec = P("dp", None, "sp", None)

    def fn(q, k, v):
        return jax_ring_attention(q, k, v, jm, causal=causal, q_spec=spec,
                                  impl="flash")
    out, vjp = jax.vjp(fn, q, k, v)
    return {"out": out, **dict(zip(("dq", "dk", "dv"), vjp(g)))}


@pytest.mark.parametrize("n,case", [
    (n, case) for n, cases in worker.RING_CASES.items() for case in cases
], ids=lambda x: x[0] if isinstance(x, tuple) else str(x))
def test_ring_matches_jax_forward_and_grads(ring_worlds, n, case):
    outs = [rank_out[case[0]] for rank_out in ring_worlds[n]]
    dp = case[1]
    ref = _jax_ring(case, n)
    q, k, _, _ = worker.ring_inputs(case)
    shapes = {"out": q.shape, "dq": q.shape, "dk": k.shape, "dv": k.shape}
    for key, shape in shapes.items():
        got = _assemble(outs, key, shape, dp, n // dp)
        np.testing.assert_allclose(
            got, np.asarray(ref[key]), rtol=0,
            atol=OUT_ATOL if key == "out" else GRAD_ATOL,
            err_msg=f"{case[0]} on {n} ranks: {key}")


IN_PROCESS_CASES = [(n, case) for n, cases in worker.RING_CASES.items()
                     for case in cases if case[1] == 1 and case[2] == "flash"]


@pytest.mark.parametrize("n,case", IN_PROCESS_CASES,
                         ids=lambda x: x[0] if isinstance(x, tuple) else str(x))
def test_in_process_ring_is_the_process_ring(ring_worlds, n, case):
    """The flash ring's loops over the ``InProcess`` transport (every
    rank in one process, as chip_smoke's ring phase runs them on one
    card) give each rank exactly what the gloo world's ranks computed
    through ``P2P``, and so JAX's ring within the f32 tolerances."""
    from container_engine_accelerators_tpu_torch.parallel import (
        ring_attention as ra,
    )

    causal = case[3]
    q, k, v, g = (torch.tensor(x) for x in worker.ring_inputs(case))
    qs, ks, vs, gs = ([t.contiguous() for t in x.chunk(n, dim=2)]
                      for x in (q, k, v, g))
    transport = ra.InProcess(n)
    sm_scale = q.shape[-1] ** -0.5
    outs, lses = ra.ring_flash_forward(qs, ks, vs, transport, causal,
                                       sm_scale)
    dqs, dks, dvs = ra.ring_flash_backward(qs, ks, vs, outs, lses, gs,
                                           transport, causal, sm_scale)
    got = {"out": outs, "dq": dqs, "dk": dks, "dv": dvs}
    ref = _jax_ring(case, n)
    for key, shards in got.items():
        for rank, shard in enumerate(shards):
            np.testing.assert_array_equal(
                shard.numpy(), ring_worlds[n][rank][case[0]][key],
                err_msg=f"{case[0]} rank {rank} of {n}: {key}")
        np.testing.assert_allclose(
            torch.cat(shards, dim=2).numpy(), np.asarray(ref[key]), rtol=0,
            atol=OUT_ATOL if key == "out" else GRAD_ATOL,
            err_msg=f"{case[0]} in one process, {n} ranks: {key}")


def test_ring_of_one_device_is_flash_attention():
    """No mesh: the flash impl is ``flash_attention``, the plain impl
    the one-block ring; both equal the oracle."""
    from container_engine_accelerators_tpu_torch.ops import attention
    from container_engine_accelerators_tpu_torch.parallel import (
        ring_attention,
    )

    case = worker.RING_CASES[2][0]
    q, k, v, _ = (torch.tensor(x) for x in worker.ring_inputs(case))
    ref = attention.mha_reference(q, k, v, causal=True)
    for impl in ("flash", "plain", "auto"):
        got = ring_attention.ring_attention(q, k, v, None, impl=impl)
        torch.testing.assert_close(got, ref, atol=OUT_ATOL, rtol=0)
    with pytest.raises(ValueError, match="unknown ring impl"):
        ring_attention.ring_attention(q, k, v, None, impl="xla")


def test_ring_steps_fold_a_wholly_future_shard_with_weight_zero():
    """fwd_step / bwd_step, the functions chip_smoke drives per (rank,
    step): a K/V shard wholly in the queries' future leaves (out, lse)
    as they were and adds nothing to dq, dk, dv."""
    from container_engine_accelerators_tpu_torch.parallel import (
        ring_attention as ra,
    )

    rng = np.random.default_rng(3)
    q, k, v, g = (torch.tensor(rng.standard_normal((1, 4, 16, 8),
                                                   dtype=np.float32))
                  for _ in range(4))
    k, v = k[:, :2].contiguous(), v[:, :2].contiguous()
    kw = dict(causal=True, sm_scale=8 ** -0.5)
    out, lse = ra.fwd_step(q, k, v, torch.zeros(q.shape),
                           torch.full(q.shape[:3], ra.NEG_INF),
                           q_base=16, k_base=0, **kw)
    out2, lse2 = ra.fwd_step(q, k, v, out, lse, q_base=16, k_base=32, **kw)
    torch.testing.assert_close(out2, out, atol=0, rtol=0)
    torch.testing.assert_close(lse2, lse, atol=1e-6, rtol=0)
    delta = (out * g).sum(-1)
    grads = [torch.zeros(q.shape), torch.zeros(k.shape), torch.zeros(k.shape)]
    ra.bwd_step(q, k, v, out, lse, g, delta, *grads, q_base=16, k_base=32,
                **kw)
    assert all(not t.any() for t in grads)


def test_ring_processes_leave_no_rendezvous_behind(ring_worlds, tmp_path):
    """Every world ran in its own tmp dir and every rank wrote its
    output: nothing in this process joined a group."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert all(len(outs) == n for n, outs in ring_worlds.items())
    assert not os.listdir(tmp_path)


def test_world_smoke_full_width_steps_rehearse_on_two_gloo_ranks():
    """The tp and ep checks' full-width bf16 steps (the four-card call's
    Llama-3-8B and Mixtral-8x7B steps) on the CPU with their widths,
    vocabularies and sequence divided by 32: the rows, their paths and
    dtype, and each held to the unsplit step within ``WIDE_GRAD_TOL``."""
    import json
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.parallel.world_smoke",
         "--world", "2", "--device", "cpu", "--checks", "tp", "ep",
         "--train-seq", "32", "--train-d-model", "64", "--full-width",
         "--wide-shrink", "32", "--timeout-s", "240"],
        cwd=worker.REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r.get("check") for r in rows] == ["tp", "tp", "tp", "tp", "ep",
                                              "ep", None]
    assert all(r["ok"] for r in rows)
    wide = [r for r in rows[:-1] if r["dtype"] == "bfloat16"]
    assert [(r["check"], r["path"], r["n_layers"], r["seq"], r["d_model"])
            for r in wide] == [("tp", "ring", 4, 128, 128),
                               ("tp", "off", 4, 128, 128),
                               ("ep", "off", 2, 128, 128)]
    assert all(len(r["step_ms"]) == 3 and r["tol"]["rel_l2"] == 3e-2
               for r in wide)
    assert wide[-1]["n_experts"] == 8
    # In f32 the sharding is the unsplit arithmetic up to the order of
    # f32 sums; in bf16 each path is as close to f32 as the unsplit step.
    for r in wide:
        assert r["f32_vs_unsplit_f32"]["worst_max_rel"] <= 1e-4
        assert r["bf16_vs_f32"]["path"] <= 1.25 * r["bf16_vs_f32"]["unsplit"]


def test_world_smoke_moe_sp_and_tp_whole_rehearse_on_two_gloo_ranks():
    """The ``moe_sp`` and ``tp_whole`` checks (the four-card call's
    Mixtral-8x7B steps over sp and Qwen2-1.5B's over tp), their widths,
    vocabularies and sequence divided by 32 on the CPU: each row held to
    the unsplit step; at two ranks the small tp step's one KV head is
    whole, and the MoE rows read the routing with ``router_ties``."""
    import json
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.parallel.world_smoke",
         "--world", "2", "--device", "cpu", "--checks", "moe_sp",
         "tp_whole", "--train-seq", "32", "--train-d-model", "64",
         "--full-width", "--wide-shrink", "32", "--timeout-s", "240"],
        cwd=worker.REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [(r.get("check"), r.get("dtype")) for r in rows] == [
        ("moe_sp", "float32"), ("moe_sp", "bfloat16"),
        ("tp_whole", "float32"), ("tp_whole", "bfloat16"), (None, None)]
    assert all(r["ok"] for r in rows)
    assert [(r["sp"], r["ep"], r["n_experts"]) for r in rows[:2]] == [
        (2, 1, 4), (2, 1, 8)]
    assert all("first_layer" in r["router"] for r in rows[:2])
    assert rows[2]["whole_parts"] == ["attn"] and rows[2]["tp"] == 2
    assert rows[1]["seq"] == 256 and rows[3]["seq"] == 128


def test_world_smoke_on_two_gloo_ranks():
    """``parallel/world_smoke.py`` (the multi-GPU check) end to end on
    the CPU: two ranks through the env contract, the ring against the
    whole sequence, and the sp-sharded train step, the pp step, the tp
    step (ring and off) and the ep step against one device."""
    import json
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.parallel.world_smoke",
         "--world", "2", "--device", "cpu", "--seq", "128", "--heads", "4",
         "2", "--head-dim", "16", "--repeats", "1", "--train-seq", "32",
         "--train-d-model", "64", "--timeout-s", "240"],
        cwd=worker.REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r.get("check") for r in rows] == ["ring", "train", "pp", "tp",
                                              "tp", "ep", None]
    assert all(r["ok"] for r in rows) and rows[-1]["world"] == 2
    assert rows[1]["sp"] == 2 and rows[1]["replicated"]
    assert rows[2]["stages"] == 2 and rows[2]["microbatches"] == 4
    assert [(r["tp"], r["ep"], r["path"]) for r in rows[3:6]] == [
        (2, 1, "ring"), (2, 1, "off"), (1, 2, "off")]
