# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's tensor-parallel serving vs the JAX package (CPU, f32).

JAX serves ``--tp`` on its 8-device CPU mesh (``tests/conftest.py``); the
port splits the same weights (bridged with ``weights.params_from_jax``)
into per-rank shards (``models/tp_serving.py``) and runs them every rank
in one process (``Axes.in_process``) or one rank a process over gloo
(``serve_cli --tp`` through the env contract, ``tests/torch_dist_worker.py``
scenario ``serve_tp``):

  * twins of ``tests/test_tp_serving.py``: tp generate equals the single
    device at tp 2 and 4, the sharded init equals the whole one, the
    "tp=3" check, ``Model(tp=2)`` end to end;
  * the dense and paged ``ContinuousEngine`` over tp shards against the
    JAX server's ``Model(tp=2)`` (greedy tokens equal), and the serving
    programs' f32 logits against JAX's within ``LOGITS_ATOL``, the ring
    and the off prefill alike;
  * int8 under tp against JAX's ``Model(tp=2, quantize="int8")``;
  * two gloo ranks of ``serve_cli --tp 2 --once`` (dense and paged):
    both exit 0 and rank 0's tokens are JAX's; the world-size refusal and
    the handshake's ``LinkConfigMismatch``.
"""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu_torch.fleet import linksim, sim  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    quantization as q8,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serve_cli as tserve,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    tp_serving,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as ttf,
)
from container_engine_accelerators_tpu_torch.models import weights  # noqa: E402
from container_engine_accelerators_tpu_torch.models.serving_graphs import (  # noqa: E402
    DenseDecodeGraphs,
)
from container_engine_accelerators_tpu_torch.parallel import (  # noqa: E402
    tensor_parallel as tpar,
)
from container_engine_accelerators_tpu_torch.warmstart import (  # noqa: E402
    warmup as ws_warmup,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as worker  # noqa: E402

# tests/test_tp_serving.py's config: f32, 8 q heads, 4 kv heads.
SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=8,
             n_kv_heads=4, d_ff=128, max_seq_len=64, dtype="float32")
CFG = ttf.TransformerConfig(**SHAPE)
JCFG = jtf.TransformerConfig(**SHAPE)
# f32 logits of the two packages (other summation orders, the all-reduce
# of partial sums).
LOGITS_ATOL = 1e-4
ENGINE = dict(max_slots=2, chunk=4, prefill_chunk=16)
# serve_cli's flags of the gloo worlds: 16 q heads, 8 kv heads, d_ff 192.
CLI_FLAGS = ["--seq-len", "64", "--d-model", "64", "--n-layers", "2",
             "--n-heads", "16", "--vocab-size", "128", "--dtype", "float32"]
CLI_SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=16,
                 n_kv_heads=8, d_ff=192, max_seq_len=64, dtype="float32")


def _mesh(tp):
    return Mesh(np.asarray(jax.devices()[:tp]), ("tp",))


@pytest.fixture(scope="module")
def jparams():
    return jtf.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def whole(jparams):
    return weights.params_from_jax(jax.device_get(jparams), CFG,
                                   device="cpu")


def _sharded(whole, tp, overlap="auto"):
    model = tp_serving.split(whole, tpar.Axes.in_process(tp=tp))
    model.cfg = dataclasses.replace(CFG, overlap=overlap)
    return model


def _cases(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 128, n).tolist(), m)
            for n, m in ((4, 6), (9, 3), (23, 5), (17, 4), (5, 1))]


# -- twins of tests/test_tp_serving.py ---------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_tp_generate_matches_single_device(whole, jparams, tp):
    prompt = torch.tensor([[5, 7, 11, 13], [2, 3, 4, 5]])
    want = np.asarray(jtf.generate(
        jparams, jnp.asarray(prompt.numpy(), jnp.int32), JCFG,
        max_new_tokens=8))
    single = ttf.generate(whole, prompt, max_new_tokens=8,
                          decoder=DenseDecodeGraphs(whole))
    model = _sharded(whole, tp)
    got = ttf.generate(model, prompt, max_new_tokens=8,
                       decoder=DenseDecodeGraphs(model))
    np.testing.assert_array_equal(got.numpy(), single.numpy())
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_init_matches_host_init(tp):
    host = ttf.init_params(CFG, device="cpu", seed=3)
    model = tp_serving.init_shards(CFG, tpar.Axes.in_process(tp=tp),
                                   device="cpu", seed=3)
    merged = tpar.merged(model.shards, model.axes, tpar.TRANSFORMER_TP)
    for name, p in host.named_parameters():
        torch.testing.assert_close(merged[name], p.detach(), rtol=0, atol=0)
    # Each rank holds its own piece only.
    assert model.shards[1].layers[0].attn.wq.shape == (64, 64 // tp)
    assert model.shards[1].layers[0].ffn.w2.shape == (128 // tp, 64)


def test_serving_shardings_validates_divisibility():
    with pytest.raises(ValueError, match="tp=3"):
        tp_serving.check_config(CFG, 3)
    with pytest.raises(ValueError, match="tp=3"):
        tserve.Model(CFG, device="cpu", tp=3)
    with pytest.raises(ValueError, match="tp=3"):
        jtf.serving_shardings(JCFG, _mesh(3))


def test_serve_cli_model_tp_end_to_end():
    model = tserve.Model(CFG, device="cpu", tp=2)
    out = model.generate([[1, 2, 3]], 4)
    assert len(out) == 1 and len(out[0]) == 7
    assert isinstance(model.model, tp_serving.ShardedModel)
    assert model.model.kv_heads == CFG.n_kv_heads


# -- the serving programs' logits against JAX's -------------------------------

@pytest.mark.parametrize("overlap", ["ring", "off"])
@pytest.mark.parametrize("tp", [2, 4])
def test_prefill_and_decode_logits_match_jax(whole, jparams, tp, overlap):
    mesh = _mesh(tp)
    shardings, _ = jtf.serving_shardings(JCFG, mesh)
    sharded = jax.device_put(jparams, shardings)
    rng = np.random.default_rng(tp)
    prompt = rng.integers(1, 128, (2, 16))
    jlogits, jcache = jtf.prefill(
        sharded, jnp.asarray(prompt, jnp.int32), JCFG, return_logits=True,
        mesh=mesh, overlap=overlap)
    model = _sharded(whole, tp, overlap)
    logits, cache = ttf.prefill(model, torch.as_tensor(prompt),
                                return_logits=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGITS_ATOL, rtol=0)
    tokens = logits.argmax(-1)
    positions = torch.tensor([16, 16])
    got = ttf.decode_logits_multi(model, cache, tokens, positions)
    want, _ = jtf.decode_logits_multi(
        sharded, jcache, jnp.asarray(tokens.numpy(), jnp.int32),
        jnp.asarray(positions.numpy(), jnp.int32), JCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_ATOL, rtol=0)


def test_ring_and_off_prefill_agree(whole):
    prompt = torch.as_tensor(np.random.default_rng(5).integers(1, 128,
                                                              (1, 32)))
    out = {}
    for overlap in ("ring", "off"):
        model = _sharded(whole, 4, overlap)
        cache = ttf.init_kv_cache(CFG, 2, "cpu", model.kv_heads)
        first = ttf.prefill_into_slot(model, cache, prompt, 30, 1)
        logits, (ks, vs) = ttf._prefill_forward(model, prompt, 29)
        out[overlap] = (int(first), logits, ks, vs, cache)
    assert out["ring"][0] == out["off"][0]
    for a, b in zip(out["ring"][1:4], out["off"][1:4]):
        torch.testing.assert_close(a, b, atol=LOGITS_ATOL, rtol=0)
    for key in ("k", "v"):
        torch.testing.assert_close(out["ring"][4][key], out["off"][4][key],
                                   atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("tp", [2, 4])
def test_segments_over_shards_match_the_unsplit_model(whole, tp):
    """The chunked dense segment and the paged segment on tp shards (each
    rank's heads in its run of the caches) against the unsplit model,
    which tests/test_torch_dense.py and test_torch_paged.py hold to
    JAX."""
    model = _sharded(whole, tp)
    rng = np.random.default_rng(7)
    seg = torch.as_tensor(rng.integers(1, 128, (1, 16)))
    outs = []
    for m in (whole, model):
        cache = ttf.init_kv_cache(CFG, 2, "cpu", m.kv_heads)
        ttf.prefill_chunk_into_slot(m, cache, seg, 0, 1, 15, 16)
        tok, logits = ttf.prefill_chunk_into_slot(
            m, cache, seg, 16, 1, 27, 32, want_logits=True,
            return_logits=True)
        pools = {k: torch.zeros(CFG.n_layers, 12, CFG.n_kv_heads, 4,
                                CFG.head_dim) for k in ("k", "v")}
        table = torch.arange(1, 9)
        last = torch.zeros(2, dtype=torch.long)
        ptok, plogits = ttf.paged_prefill_segment(
            m, pools, seg, 0, table[:4], table, 13, last, 0, 16, 4,
            want_logits=True, return_logits=True)
        outs.append((int(tok), logits, cache, int(ptok), plogits, pools))
    (a, b) = outs
    assert a[0] == b[0] and a[3] == b[3]
    torch.testing.assert_close(a[1], b[1], atol=LOGITS_ATOL, rtol=0)
    torch.testing.assert_close(a[4], b[4], atol=LOGITS_ATOL, rtol=0)
    for key in ("k", "v"):
        torch.testing.assert_close(a[2][key], b[2][key], atol=LOGITS_ATOL,
                                   rtol=0)
        torch.testing.assert_close(a[5][key], b[5][key], atol=LOGITS_ATOL,
                                   rtol=0)


# -- the engines over tp shards against the JAX server's Model(tp=2) ---------

@pytest.fixture(scope="module")
def jax_tp_model():
    return jserve.Model(JCFG, tp=2)


@pytest.fixture(scope="module")
def tp_model(jax_tp_model):
    tree = jax.device_get(jax_tp_model.params)
    return tserve.Model(CFG, device="cpu", tp=2,
                        weights=weights.params_from_jax(tree, CFG,
                                                        device="cpu"))


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_engine_over_tp_shards_matches_the_jax_tp_server(jax_tp_model,
                                                         tp_model, kv_cache):
    engine = tserve.ContinuousEngine(
        tp_model, kv_cache=kv_cache,
        **(dict(kv_block_size=4) if kv_cache == "paged" else {}), **ENGINE)
    try:
        for prompt, max_new in _cases():
            got = engine.generate([prompt], max_new)
            assert got == jax_tp_model.generate([prompt], max_new), prompt
        assert engine.cache["k"].shape[2] == CFG.n_kv_heads
    finally:
        engine.shutdown()


def test_int8_under_tp_matches_the_jax_int8_tp_server(jax_tp_model, whole):
    jmodel = jserve.Model(JCFG, tp=2, quantize="int8")
    tree = jax.device_get(jax_tp_model.params)
    model = tserve.Model(CFG, device="cpu", tp=2, quantize="int8",
                         weights=weights.params_from_jax(tree, CFG,
                                                         device="cpu"))
    for prompt, max_new in _cases(1)[:3]:
        assert model.generate([prompt], max_new) == \
            jmodel.generate([prompt], max_new), prompt


@pytest.mark.parametrize("tp", [2, 4])
def test_int8_shards_are_the_whole_weight_quantized_and_split(whole, tp):
    """Column shards keep their own scales; a row shard (wo, w2) takes
    the whole weight's, the max over tp: every rank's int8 shard is the
    whole weight's quantized, then split."""
    model = tp_serving.quantize_shards(_sharded(whole, tp))
    for key, owner, dim in (("wq", "attn", 0), ("wo", "attn", 1),
                            ("w1", "ffn", 0), ("w2", "ffn", 1)):
        w = getattr(getattr(whole.layers[1], owner), key).detach()
        qw = q8.quantize_weight(w)
        want_q = qw["q"].T.contiguous()          # (dout, din)
        pieces = [getattr(getattr(s.layers[1], owner), key)
                  for s in model.shards]
        q = torch.cat([p.q for p in pieces], dim=dim)
        assert torch.equal(q, want_q), key
        scale = pieces[0].scale if dim == 1 else torch.cat(
            [p.scale for p in pieces], dim=1)
        assert torch.equal(scale, qw["scale"]), key
        if dim == 1:
            assert all(torch.equal(p.scale, pieces[0].scale)
                       for p in pieces)


def test_engine_refuses_speculation_under_a_link():
    """A link whose ranks span hosts refuses speculation, as JAX's link
    (which only a multi-host world has) does; on one host the linked
    engine speculates: it builds its proposer and its verify graphs
    (tests/test_torch_tp_link.py serves through them)."""
    across = tserve.LockstepEngineLink(
        sim._sim_cfg(), 2, transport=linksim.LoopbackTransport(1),
        rank_hosts=["host-a", "host-b"])
    with pytest.raises(ValueError, match="single-host"):
        tserve.ContinuousEngine(sim._StubModel(sim._sim_cfg()),
                                kv_cache="paged", speculate="ngram",
                                link=across, start_loop=False)
    one = tserve.LockstepEngineLink(
        sim._sim_cfg(), 2, transport=linksim.LoopbackTransport(1),
        rank_hosts=["host-a", "host-a"])
    eng = tserve.ContinuousEngine(sim._StubModel(sim._sim_cfg()),
                                  kv_cache="paged", speculate="ngram",
                                  link=one, start_loop=False)
    assert eng.spec_proposer is not None and eng.verify_graphs is not None


def test_follower_warms_the_same_plan_right_after_the_handshake():
    """``--warmup=all`` under tp: every rank runs the same warm plan in
    the same order, before any announced op. The follower runs it right
    after the leader's handshake (``engine_follower_loop(warm=...)``),
    where rank 0 runs its own, then replays the stream."""
    transport = linksim.LoopbackTransport(1)
    follower = sim.make_fake_engine(kv_cache="paged", max_slots=2,
                                    start_loop=False)
    flink = tserve.LockstepEngineLink(follower.cfg, 2,
                                      transport=transport.follower_view(1),
                                      rank=1)
    order = []

    def warm():
        # The fake engines' device seams are fakes and their decode graphs
        # have no model to capture: the plan is recorded, not run.
        order.append(("warm", flink._expect,
                      [t.label for t in ws_warmup.warm_plan(follower)]))

    done = threading.Event()
    threading.Thread(target=lambda: (
        tserve.engine_follower_loop(follower, flink, warm=warm),
        done.set()), daemon=True).start()
    link = tserve.LockstepEngineLink(follower.cfg, 2, transport=transport,
                                     rank=0)
    leader = sim.make_fake_engine(kv_cache="paged", max_slots=2, link=link)
    plan = [t.label for t in ws_warmup.warm_plan(leader)]
    try:
        assert leader.generate([[3, 4, 5]], 4) == \
            [sim.expected_output([3, 4, 5], 4)]
    finally:
        leader.shutdown()
    assert done.wait(10)
    # Warmed once, on rank 0's plan, after the hello (op 0) and before
    # op 1.
    assert plan and order == [("warm", 1, plan)]


# -- serve_cli --tp over two gloo ranks ---------------------------------------

@pytest.fixture(scope="module")
def cli_jax():
    """JAX's weights for the CLI's config and the JAX server's tp=2
    tokens for the --once request ([[5, 6]], 2 new tokens)."""
    jcfg = jtf.TransformerConfig(**CLI_SHAPE)
    jmodel = jserve.Model(jcfg, tp=2)
    return jax.device_get(jmodel.params), jmodel.generate([[5, 6]], 2)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_two_rank_serve_cli_tp_once_matches_jax(tmp_path, cli_jax, mode):
    tree, want = cli_jax
    argv = ["--tp", "2", "--once", "--device", "cpu", "--port", "0",
            *CLI_FLAGS]
    if mode == "paged":
        argv += ["--continuous-batching", "--kv-cache", "paged",
                 "--warmup", "all", "--link-timeout-s", "30"]
    runs = worker.serve_world({"cfg": CLI_SHAPE, "tree": tree,
                               "argv": argv}, str(tmp_path))
    for rank, (rc, out, log) in enumerate(runs):
        assert rc == 0 and out is not None and out["rc"] == 0, \
            f"rank {rank}:\n{log[-3000:]}"
    replies = [[line for line in out["lines"] if "tokens" in line]
               for _, out, _ in runs]
    assert replies[0][-1]["tokens"] == want and replies[1] == []
    if mode == "paged":
        # Each rank's engine reports its decode graphs as it stops.
        assert [[line["rank"] for line in out["lines"] if "rank" in line]
                for _, out, _ in runs] == [[0], [1]]


def test_serve_cli_tp_refuses_another_world_size(tmp_path, cli_jax):
    tree, _ = cli_jax
    argv = ["--tp", "2", "--once", "--device", "cpu", "--port", "0",
            *CLI_FLAGS]
    (rc, out, log), = worker.serve_world(
        {"cfg": CLI_SHAPE, "tree": tree, "argv": argv}, str(tmp_path),
        world=1)
    assert out is not None and out["rc"] != 0, log[-3000:]
    assert "--tp == global device count (1), got --tp=2" in out["error"]
    with pytest.raises(ValueError, match="--tp=2 needs 2 devices, have 1"):
        tserve.join_tp_world(tserve.build_parser().parse_args(argv))


def test_serve_cli_tp_handshake_mismatch_fails_by_name(tmp_path, cli_jax):
    tree, _ = cli_jax
    argv = ["--tp", "2", "--once", "--device", "cpu", "--port", "0",
            "--continuous-batching", "--link-timeout-s", "5", *CLI_FLAGS]
    runs = worker.serve_world(
        {"cfg": CLI_SHAPE, "tree": tree, "argv": argv,
         "argv_of": {1: argv + ["--max-slots", "4"]}}, str(tmp_path))
    rc, out, log = runs[1]
    assert out is not None and out["rc"] != 0, log[-3000:]
    assert out["error"].startswith("LinkConfigMismatch"), out
    # Rank 0 does not hang on the lost follower: it exits.
    assert runs[0][0] is not None


def test_world_smoke_serve_tp_on_two_gloo_ranks(tmp_path):
    """``parallel/world_smoke.py --checks serve_tp`` (the four-card check)
    at a tiny width over two gloo ranks: the world's greedy streams equal
    one process's unsplit engine, also under ``--speculate ngram`` and
    across a KV handoff round trip, and with ``--link-timeout-s`` a
    killed follower makes rank 0 report ``link_wedged`` and exit instead
    of hanging."""
    import json
    import subprocess

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "MEGASCALE_", "LOCAL_"))}
    env.update(PYTHONPATH=worker.REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.parallel.world_smoke",
         "--world", "2", "--device", "cpu", "--checks", "serve_tp",
         "--timeout-s", "120",
         "--log-dir", str(tmp_path)],
        cwd=worker.REPO, env=env, capture_output=True, text=True,
        timeout=300)
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    by = {r.get("check"): r for r in rows}
    assert by["serve_tp"]["exit_codes"] == [0, 0]
    assert by["serve_tp_tokens"]["partings"] == []
    # One host: the world speculates (rank 0 proposes, every rank replays
    # the verify rounds) and hands KV off both ways with one process's
    # unsplit engine, every stream within the margin rule.
    spec = by["serve_tp_spec"]
    assert spec["ok"] and spec["exit_codes"] == [0, 0], spec
    handoff = by["serve_tp_handoff"]
    assert handoff["ok"] and set(handoff["directions"]) == {
        "world_to_one_gpu", "one_gpu_to_world"}, handoff
    kill = by["serve_tp_kill"]
    assert kill["wedged_after_s"] is not None and kill["request_returned"]
    assert kill["rank0_exit"] == tserve.WEDGE_EXIT_CODE
    assert rows[-1] == {"ok": True, "launcher_checks": ["serve_tp"],
                        "world": 2}
