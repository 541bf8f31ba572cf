# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Port serve_cli (CPU) vs the JAX server, import hygiene, device rules."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serve_cli as tserve,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as ttf,
)
from container_engine_accelerators_tpu_torch.models import weights  # noqa: E402

import chip_smoke  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_FLAGS = ["--n-layers", "1", "--d-model", "64", "--n-heads", "2",
              "--seq-len", "64", "--vocab-size", "256"]
SHAPE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=192, max_seq_len=64, dtype="float32")


@pytest.fixture(scope="module")
def servers():
    """The JAX Model and a port server on the same (bridged) weights."""
    jmodel = jserve.Model(jtf.TransformerConfig(**SHAPE), seed=0)
    cfg = ttf.TransformerConfig(**SHAPE)
    tmodel = tserve.Model(cfg, weights=weights.params_from_jax(
        jax.tree.map(np.asarray, jmodel.params), cfg, device="cpu"))
    server, state = tserve.start_server(tmodel, port=0, host="127.0.0.1")
    try:
        tserve.wait_ready(state, timeout=120)
        yield jmodel, server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("tokens,max_new", [
    ([[5, 6, 7]], 6),
    ([[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]], 5),
])
def test_generate_endpoint_matches_jax_model(servers, tokens, max_new):
    jmodel, port = servers
    resp = tserve.post_generate(port, tokens, max_new)
    assert resp["tokens"] == jmodel.generate(tokens, max_new)
    assert resp["sampler"] == {"temperature": 0.0, "top_k": 0, "top_p": 1.0}


def test_sampled_request_is_seeded_and_snapped(servers):
    _, port = servers
    a = tserve.post_generate(port, [[1, 2]], 5, temperature=1.5, top_k=100,
                             seed=7)
    b = tserve.post_generate(port, [[1, 2]], 5, temperature=1.5, top_k=100,
                             seed=7)
    assert a["tokens"] == b["tokens"]
    assert a["sampler"] == {"temperature": 1.3, "top_k": 64, "top_p": 1.0}


def test_healthz_and_unknown_paths(servers):
    import urllib.error
    import urllib.request

    _, port = servers
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
        assert json.loads(r.read()) == {"status": "ok"}
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
    assert e.value.code == 404


@pytest.mark.parametrize("args", [(0.0, 5, 0.5), (1.5, 100, 0.93),
                                  (0.9, 3, 2.0)])
def test_sanitize_sampler_matches_jax(args):
    assert tserve.sanitize_sampler(*args, 256) == \
        jserve.sanitize_sampler(*args, 256)


def test_serve_cli_once_on_cpu_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.models.serve_cli",
         "--once", "--device", "cpu", "--port", "0", *TINY_FLAGS],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["tokens"][0]) == 4 and out["tokens"][0][:2] == [5, 6]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke's helpers, import in a
    fresh interpreter without pulling in jax or the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import container_engine_accelerators_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "assert len(names) >= 7, names\n"
        "want = {'models.bert', 'models.mnist', 'models.resnet', "
        "'parallel.moe', 'utils.checkpointing', 'models.supervisor', "
        "'obs.goodput', 'obs.fleet', 'collectives.device_bench', "
        "'collectives.cards', 'obs.collective', 'ops.stream', "
        "'warmstart.cache', 'fleet.router', 'fleet.autoscaler', "
        "'fleet.lifecycle', 'fleet.sim', 'fleet.disagg', 'faults.storm', "
        "'scheduler.gang', 'scheduler.incremental', 'scheduler.k8s', "
        "'topology.labels', 'topology.slice', 'topology.placement', "
        "'parallel.pipeline', 'models.pipeline_lm', 'fleet.journeydrill', "
        "'obs.journey', 'parallel.overlap', 'parallel.tensor_parallel', "
        "'models.tp_lm', 'models.tp_serving', 'fleet.linksim', "
        "'faults.reactor', 'testing.kubeapi'}\n"
        "assert {p.__name__ + '.' + w for w in want} <= set(names), names\n"
        "[importlib.import_module(n) for n in names]\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'container_engine_accelerators_tpu'"
        " or m.startswith('container_engine_accelerators_tpu.')]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is a valid default")
    cfg = ttf.TransformerConfig(**SHAPE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttf.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.Model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--once", "--port", "0", *TINY_FLAGS])
    assert chip_smoke.main() == 1


@pytest.mark.parametrize("seq_q,seq_k,causal,q_base,k_base,kv_len", [
    (64, 64, True, 0, 0, None),
    (32, 96, True, 64, 0, None),
    (40, 40, True, 0, 30, None),
    (30, 50, False, 0, 0, 33),
    (70, 50, True, 0, 0, 45),
])
def test_chip_smoke_counts_the_pairs_the_masks_leave(seq_q, seq_k, causal,
                                                     q_base, k_base, kv_len):
    from container_engine_accelerators_tpu_torch.ops.attention import (
        _visible,
    )

    vis = _visible(seq_q, seq_k, causal, q_base, k_base, kv_len, "cpu")
    assert chip_smoke.attended_pairs(
        seq_q, seq_k, causal, q_base, k_base, kv_len
    ) == int(vis.expand(seq_q, seq_k).sum())


def test_chip_smoke_bound_picks_the_larger_time():
    # Llama-3-8B prefill at 2048: 4 * 128 * 32 * 2048 * 2049 / 2 FLOPs
    # outweigh its ~42 MB of q/k/v/out/lse at the H100's rates.
    ms, by = chip_smoke.flash_bound(1, 32, 8, 2048, 2048, 128, "bfloat16",
                                    True)
    flops = 4 * 128 * 32 * 2048 * 2049 // 2
    assert by == "operations"
    assert ms == pytest.approx(flops / chip_smoke.PEAK_BF16_FLOPS * 1e3)
    # One query row against 16 keys moves more than it computes.
    assert chip_smoke.flash_bound(1, 1, 1, 1, 16, 64, "bfloat16",
                                  False)[1] == "bytes"


@pytest.mark.parametrize("kind,seq_k,causal,q_base,kv_len,keys", [
    # A paged prefill segment: 16 rows at q_base 1040 over a 2048-key
    # window read keys [0, 1056) only.
    ("fwd", 2048, True, 1040, None, 1056),
    ("dq", 4096, True, 2000, None, 2016),
    ("fwd", 1000, False, 0, 777, 777),
    # dk and dv are written over every key, seen or not.
    ("dkv", 2048, True, 1040, None, 1056),
])
def test_chip_smoke_bound_reads_only_the_keys_the_masks_leave(
        kind, seq_k, causal, q_base, kv_len, keys):
    bound = functools.partial(chip_smoke.flash_bound, 1, 32, 8, 16,
                              d=128, dtype="bfloat16", causal=causal,
                              q_base=q_base, kind=kind)
    whole, cut = bound(seq_k=seq_k, kv_len=kv_len), bound(seq_k=keys)
    assert whole[1] == cut[1] == "bytes"
    if kind == "dkv":
        assert whole[0] > cut[0]
    else:
        assert whole[0] == pytest.approx(cut[0])


@pytest.mark.parametrize("kind,outputs", [
    # out (Sq × D bf16) and lse (Sq f32) per q head; dq; dk and dv over
    # every key of each kv head; all three.
    ("fwd", 32 * 8192 * (128 * 2 + 4)), ("dq", 32 * 8192 * 128 * 2),
    ("dkv", 2 * 8 * 8192 * 128 * 2),
    ("bwd", (32 + 2 * 8) * 8192 * 128 * 2),
])
def test_chip_smoke_bound_of_a_wholly_future_shard_counts_its_outputs(
        kind, outputs):
    """A ring's shard in the queries' future: no key is visible, the
    kernels read no input, and the bound is the outputs' bytes."""
    ms, by = chip_smoke.flash_bound(1, 32, 8, 8192, 8192, 128, "bfloat16",
                                    True, q_base=0, k_base=8192, kind=kind)
    assert by == "bytes"
    assert ms == pytest.approx(outputs / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_chip_smoke_grad_check_sees_a_wrong_tile_of_small_rows():
    """A backward that is 30 % wrong on a 64-row tile of small late rows
    passes a check against the largest |gradient| but fails the
    bwd_kernel row measure; bf16 rounding of the output passes both
    measures, and so do rows that are zero on both sides."""
    gen = torch.Generator().manual_seed(0)
    ref = torch.randn(1, 4, 1024, 64, generator=gen) * 0.05
    ref[:, :, :16] *= 400.0  # the first rows' large gradients
    ref[:, :, 1000:] = 0.0  # keys past kv_len
    tol = chip_smoke.BWD_TOL["bfloat16"]
    wrong = ref.clone()
    wrong[:, :, 512:576] *= 1.3
    _, max_rel = chip_smoke._rel_err(wrong, ref)
    assert max_rel < 1e-2
    _, rel_l2, worst_row = chip_smoke.grad_errors(wrong, ref)
    assert worst_row > 10 * tol["row"]
    rounded = ref.to(torch.bfloat16)
    _, rel_l2, worst_row = chip_smoke.grad_errors(rounded, ref)
    assert rel_l2 <= tol["rel_l2"] and worst_row <= tol["row"]
