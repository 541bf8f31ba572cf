# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Cross-replica KV handoff on the port (CPU): ``kvcache/handoff.py`` and
``ContinuousEngine.kv_export`` / ``kv_install`` against the JAX package.

  * the manager-level cases of tests/test_disagg.py (round trip,
    idempotent install, a miss, corrupt, dropped, torn, block-size
    mismatch, the loopback transport), each on both packages' handoff
    and manager, and the two runs of one case equal: frames as
    canonical JSON, summaries, errors and manager states;
  * the engine, port to port: a tiny f32 paged engine (block 4) exports,
    a second one installs (the pools keep their addresses) and serves
    the sender's radix-hit tokens; the installed bytes are the exported
    ones;
  * across the packages, on JAX's weights: the port exports and JAX's
    engine installs, JAX exports and the port installs, tokens equal
    both ways; the two exporters' bytes agree within POOL_ATOL; the
    port's frames for a pool are byte for byte those JAX's
    ``export_prefix`` and ``_kv_block_bytes`` write for it, in f32 and
    bf16, and JAX decodes the port's bf16 payload to the pool's bits;
  * the failure taxonomy on the engine (corrupt, drop, torn, dtype and
    size mismatch, a block without bytes: ``HandoffDesync``, the
    receiver unchanged; a dense engine: ``HandoffUnsupported``; a
    stalled loop: ``HandoffTimeout``); a failed device copy takes the
    reset path;
  * speculating receivers (ngram, draft) serve the off engine's tokens;
  * HTTP: ``/kv/export`` and ``/kv/install`` with JAX's status codes,
    ``/healthz``'s ``role`` and ``replica``;
  * JAX's ``fleet/router.ReplicaRouter(handoff=True)`` in front of two
    port replicas (prefill, decode) over HTTP.
"""

import base64
import copy
import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
import zlib
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from container_engine_accelerators_tpu import faults as jfaults  # noqa: E402
from container_engine_accelerators_tpu.fleet import router as jrouter  # noqa: E402
from container_engine_accelerators_tpu.kvcache import handoff as jhandoff  # noqa: E402
from container_engine_accelerators_tpu.kvcache.manager import (  # noqa: E402
    PagedKVManager as JManager,
)
from container_engine_accelerators_tpu.models import serve_cli as jserve  # noqa: E402
from container_engine_accelerators_tpu.models import transformer as jtf  # noqa: E402
from container_engine_accelerators_tpu.obs import metrics as jmetrics  # noqa: E402
from container_engine_accelerators_tpu_torch import faults  # noqa: E402
from container_engine_accelerators_tpu_torch.kvcache import (  # noqa: E402
    handoff,
)
from container_engine_accelerators_tpu_torch.kvcache.manager import (  # noqa: E402
    PagedKVManager,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    serve_cli as tserve,
)
from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    transformer as ttf,
)
from container_engine_accelerators_tpu_torch.models import weights  # noqa: E402

SEED = int(os.environ.get("CHAOS_SEED", "0"))
SHAPE = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=192, max_seq_len=64, dtype="float32")
ENGINE = dict(max_slots=2, chunk=4, prefill_chunk=16, kv_block_size=4,
              kv_cache="paged")
# 22 tokens: 5 full blocks of 4 reach the receiver, which prefills the
# last 2 over them, as the sender's second serving does.
PROMPT = [((7 * j) % 251) + 3 for j in range(22)]
NEW = 6
# f32 pools from two frameworks: the same arithmetic summed in other
# orders (one f32 ulp at these magnitudes is ~1e-7), as
# tests/test_torch_spec.py holds them.
POOL_ATOL = 1e-5
TIMEOUT_S = 120
# (handoff module, manager class, fault-plan package) per package.
PKGS = {"jax": (jhandoff, JManager, jfaults),
        "torch": (handoff, PagedKVManager, faults)}


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    jfaults.disarm()
    yield
    faults.disarm()
    jfaults.disarm()


def _canon(obj):
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)


# -- manager level: tests/test_disagg.py's cases on both packages ------------

def _mgr(M, **kw):
    return M(32, 2, block_size=4, **kw)


def _warm(mgr, tokens):
    """Retire a request so its prefix is cached: the engine's API path."""
    mgr.ensure_blocks(0, len(tokens))
    blocks = mgr.release(0)
    mgr.finish_release(blocks, tokens)


def _state(mgr):
    """Everything a manager holds: stats, the free list in order, the
    refcounts, the page tables and the radix tree with its LRU clocks."""
    def walk(node, path):
        out = []
        for key, child in sorted(node.children.items()):
            out.append([path + [list(key)], child.block, child.last_use])
            out += walk(child, path + [list(key)])
        return out

    return {"stats": mgr.stats(), "free": list(mgr.pool._free),
            "refs": list(mgr.pool._refs), "tables": mgr.tables.tolist(),
            "mapped": list(mgr.mapped), "clock": mgr.radix._clock,
            "radix": walk(mgr.radix._root, [])}


def _raises(h_exc, fn):
    with pytest.raises(h_exc) as err:
        fn()
    return [type(err.value).__name__, str(err.value)]


def case_round_trip(h, M, F):
    src, dst = _mgr(M), _mgr(M)
    tokens = list(range(1, 13))  # 3 full blocks
    _warm(src, tokens)
    frames = h.export_prefix(src, tokens, src="replica-0",
                             traceparent="00-" + "a" * 32 + "-" + "b" * 16
                             + "-01")
    assert frames[0]["op"] == h.OP_HELLO and frames[-1]["op"] == h.OP_COMMIT
    result = h.install_prefix(dst, frames)
    assert result["installed_blocks"] == 3
    assert result["duplicate_blocks"] == 0
    assert result["n_tokens"] == 12
    assert result["nbytes"] == h.frames_nbytes(frames)
    assert result["traceparent"].startswith("00-aaaa")
    state = _state(dst)
    admitted = dst.admit(0, tokens)
    assert admitted == (8, 8, 4)
    dst.drop(dst.release(0))
    return {"frames": frames, "result": result, "state": state,
            "after": _state(dst), "verify": h.verify_frames(frames)}


def case_idempotent(h, M, F):
    src, dst = _mgr(M), _mgr(M)
    tokens = list(range(1, 9))
    _warm(src, tokens)
    frames = h.export_prefix(src, tokens)
    first = h.install_prefix(dst, frames)
    assert first["installed_blocks"] == 2
    free = dst.pool.free_count()
    second = h.install_prefix(dst, frames)
    assert second["installed_blocks"] == 0
    assert second["duplicate_blocks"] == 2
    assert dst.pool.free_count() == free
    return {"frames": frames, "first": first, "second": second,
            "state": _state(dst)}


def case_miss_is_unsupported(h, M, F):
    mgr = _mgr(M)
    err = _raises(h.HandoffUnsupported,
                  lambda: h.export_prefix(mgr, list(range(1, 9))))
    return {"err": err, "state": _state(mgr)}


def case_corrupt(h, M, F):
    src, dst = _mgr(M), _mgr(M)
    tokens = list(range(1, 13))
    _warm(src, tokens)
    frames = h.export_prefix(src, tokens)
    frames[1]["payload"]["tokens"][0] = 99
    before = _state(dst)
    err = _raises(h.HandoffDesync, lambda: h.install_prefix(dst, frames))
    assert "digest mismatch" in err[1]
    assert _state(dst) == before  # verify-then-allocate
    assert dst.admit(0, tokens)[0] == 0
    dst.drop(dst.release(0))
    return {"frames": frames, "err": err, "state": _state(dst)}


def case_dropped(h, M, F):
    src = _mgr(M)
    tokens = list(range(1, 13))
    _warm(src, tokens)
    frames = h.export_prefix(src, tokens)
    del frames[2]
    err = _raises(h.HandoffDesync, lambda: h.verify_frames(frames))
    assert "op_seq gap" in err[1]
    return {"frames": frames, "err": err}


def case_torn(h, M, F):
    src = _mgr(M)
    tokens = list(range(1, 9))
    _warm(src, tokens)
    frames = h.export_prefix(src, tokens)
    torn = _raises(h.HandoffDesync, lambda: h.verify_frames(frames[:-1]))
    empty = _raises(h.HandoffDesync, lambda: h.verify_frames([]))
    assert "empty" in empty[1]
    return {"frames": frames, "torn": torn, "empty": empty}


def case_block_size_mismatch(h, M, F):
    src = _mgr(M)
    tokens = list(range(1, 9))
    _warm(src, tokens)
    frames = h.export_prefix(src, tokens)
    dst = M(32, 2, block_size=8)
    before = _state(dst)
    err = _raises(h.HandoffDesync, lambda: h.install_prefix(dst, frames))
    assert "block_size" in err[1]
    assert _state(dst) == before
    return {"frames": frames, "err": err}


def case_loopback(h, M, F):
    src, dst = _mgr(M), _mgr(M)
    tokens = list(range(1, 9))
    _warm(src, tokens)
    frames = h.export_prefix(src, tokens)
    wire = h.LoopbackHandoffTransport(timeout_s=0.5)
    out = wire.send(frames, lambda fr: h.install_prefix(dst, fr))
    assert out["installed_blocks"] == 2
    assert wire.sent_streams == 1
    assert wire.sent_bytes == h.frames_nbytes(frames)
    F.arm(F.FaultPlan([
        {"kind": "delay", "site": h.HANDOFF_FAULT_SITE,
         "at": 0, "count": 1, "delay_s": 9.0},
    ], seed=SEED))
    err = _raises(h.HandoffTimeout, lambda: wire.send(
        frames, lambda fr: h.install_prefix(dst, fr)))
    F.disarm()
    # corrupt_payload and drop at the same site: the receiver's verify
    # turns both into a desync.
    faulted = []
    for kind in ("corrupt_payload", "drop"):
        F.arm(F.FaultPlan([{"kind": kind, "site": h.HANDOFF_FAULT_SITE,
                            "at": 0, "count": 1}], seed=SEED))
        faulted.append(_raises(h.HandoffDesync, lambda: wire.send(
            frames, lambda fr: h.install_prefix(dst, fr))))
        F.disarm()
    return {"frames": frames, "out": out, "err": err, "faulted": faulted,
            "sent": [wire.sent_streams, wire.sent_bytes],
            "state": _state(dst)}


CASES = {name[len("case_"):]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_manager_case(case, pkg):
    CASES[case](*PKGS[pkg])


@pytest.mark.parametrize("case", sorted(CASES))
def test_manager_case_equals_jax(case):
    """The port's run of each case equals JAX's: the frames as canonical
    JSON, the summaries, the errors and the manager states."""
    assert _canon(CASES[case](*PKGS["torch"])) == \
        _canon(CASES[case](*PKGS["jax"]))


# -- engine level ------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """(JAX Model, port Model) on identical weights."""
    jmodel = jserve.Model(jtf.TransformerConfig(**SHAPE), seed=0)
    cfg = ttf.TransformerConfig(**SHAPE)
    tmodel = tserve.Model(cfg, weights=weights.params_from_jax(
        jax.tree.map(np.asarray, jmodel.params), cfg, device="cpu"))
    return jmodel, tmodel


@pytest.fixture(scope="module")
def cold(models):
    """JAX ``Model.generate``'s greedy row of PROMPT: the cold reference."""
    return models[0].generate([PROMPT], NEW)[0]


@pytest.fixture
def engine(models):
    engines = []

    def make(model=None, **kwargs):
        eng = tserve.ContinuousEngine(model or models[1],
                                      **{**ENGINE, **kwargs})
        engines.append(eng)
        return eng

    yield make
    for eng in engines:
        eng.shutdown()


def _sender(engine, **kw):
    """A paged engine that served PROMPT twice: (engine, its second,
    radix-hit, tokens)."""
    eng = engine(**kw)
    eng.generate([PROMPT], NEW)
    return eng, eng.generate([PROMPT], NEW)[0]


def _ptrs(eng):
    return {name: pool.data_ptr() for name, pool in eng.cache.items()}


def _snapshot(eng):
    """A receiver's state: kv_stats, the free blocks, the radix size and a
    clone of the pools."""
    return {"kv": eng.kv_stats(), "free": sorted(eng.kv.pool._free),
            "radix": len(eng.kv.radix),
            "pools": {n: p.clone() for n, p in eng.cache.items()}}


def _same(a, b):
    assert a["kv"] == b["kv"] and a["free"] == b["free"]
    assert a["radix"] == b["radix"]
    for name in a["pools"]:
        assert torch.equal(a["pools"][name], b["pools"][name]), name


def _block_ids(frames):
    return [f["payload"]["block"] for f in frames if f["op"] == "BLOCK"]


def _decoded(frames, dtype=np.float32):
    """Each BLOCK's (k, v) bytes as arrays."""
    return [tuple(np.frombuffer(base64.b64decode(f["payload"]["kv"][key]),
                                dtype) for key in ("k", "v"))
            for f in frames if f["op"] == "BLOCK"]


def test_engine_port_to_port_serves_the_senders_hit_tokens(engine, cold):
    a, want = _sender(engine)
    b = engine()
    b.generate([[9, 8, 7, 6, 5, 4]], 3)  # the receiver holds other state
    ptrs, hit0 = _ptrs(b), b.kv_stats()["prefix_hit_tokens"]
    frames = a.kv_export(PROMPT)
    assert len(frames) == 5 + 2 and frames[0]["payload"]["n_tokens"] == 20
    result = b.kv_install(frames)
    assert result["installed_blocks"] == 5
    assert result["nbytes"] == handoff.frames_nbytes(frames)
    assert _ptrs(b) == ptrs  # installed in place, never rebound
    # The receiver's pool holds the sender's bytes at the installed ids.
    got_ids = torch.tensor(b.kv.radix.match(PROMPT))
    sent_ids = torch.tensor(_block_ids(frames))
    for name in ("k", "v"):
        assert torch.equal(b.cache[name][:, got_ids],
                           a.cache[name][:, sent_ids])
    got = b.generate([PROMPT], NEW)[0]
    assert got == want == cold
    assert b.kv_stats()["prefix_hit_tokens"] - hit0 >= 20
    assert _ptrs(b) == ptrs


def _jax_engine(jmodel):
    """JAX's paged engine with its device calls made synchronous through
    their seams (JAX's paged engine gives other greedy tokens from run to
    run on the CPU otherwise: see tests/test_torch_recovery.py), its loop
    on a daemon thread."""
    jeng = jserve.ContinuousEngine(jmodel, start_loop=False, **ENGINE)
    for seam in ("_paged_prefill", "_paged_chunk", "_copy_blocks"):
        fn = getattr(jeng, seam)
        setattr(jeng, seam, lambda *a, _fn=fn, **k:
                jax.block_until_ready(_fn(*a, **k)))
    threading.Thread(target=jeng._loop_paged, daemon=True).start()
    return jeng


def test_port_exports_jax_installs_tokens_equal(models, engine, cold):
    a, want = _sender(engine)
    frames = a.kv_export(PROMPT)
    jeng = _jax_engine(models[0])
    result = jeng.kv_install(frames, timeout_s=TIMEOUT_S)
    assert result["installed_blocks"] == 5
    before = jeng.kv_stats()["prefix_hit_tokens"]
    got = jeng.generate([PROMPT], NEW)[0]
    assert got == want == cold
    assert jeng.kv_stats()["prefix_hit_tokens"] - before >= 20


def test_jax_exports_port_installs_tokens_equal(models, engine, cold):
    jeng = _jax_engine(models[0])
    jeng.generate([PROMPT], NEW)
    jframes = jeng.kv_export(PROMPT, timeout_s=TIMEOUT_S)
    b = engine()
    ptrs = _ptrs(b)
    assert b.kv_install(jframes)["installed_blocks"] == 5
    assert _ptrs(b) == ptrs
    hit0 = b.kv_stats()["prefix_hit_tokens"]
    assert b.generate([PROMPT], NEW)[0] == cold
    assert b.kv_stats()["prefix_hit_tokens"] - hit0 >= 20
    # The two exporters' bytes for the same prompt: the same K/V up to
    # the frameworks' summation order; the same stamps and sizes.
    a, _ = _sender(engine)
    tframes = a.kv_export(PROMPT)
    for (jk, jv), (tk, tv) in zip(_decoded(jframes), _decoded(tframes)):
        np.testing.assert_allclose(tk, jk, rtol=0, atol=POOL_ATOL)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=POOL_ATOL)
    for jf, tf_ in zip(jframes, tframes):
        if jf["op"] == "BLOCK":
            jkv, tkv = jf["payload"]["kv"], tf_["payload"]["kv"]
            assert jkv["dtype"] == tkv["dtype"] == "float32"
            assert len(jkv["k"]) == len(tkv["k"])
            assert len(jkv["v"]) == len(tkv["v"])


def _jax_view(eng):
    """A stand-in JAX engine whose cache is ``eng``'s pools as jnp arrays
    (bf16 through its bits): what JAX's ``_kv_block_bytes`` and
    ``_decode_kv_block`` read."""
    def arr(pool):
        if pool.dtype == torch.bfloat16:
            return jnp.asarray(pool.view(torch.int16).numpy()
                               .view(ml_dtypes.bfloat16))
        return jnp.asarray(pool.numpy())

    return types.SimpleNamespace(
        cache={n: arr(p) for n, p in eng.cache.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_frames_are_jax_frames_byte_for_byte(models, engine, dtype):
    """For the same manager and pools, the port's stream equals the one
    JAX's ``export_prefix`` writes with JAX's ``_kv_block_bytes`` (as
    canonical JSON, dtype stamp and byte counts included), and JAX's
    ``_decode_kv_block`` reads the port's payload back to the pools'
    bits; a bf16 port engine installs its own stream bit for bit."""
    model = models[1]
    if dtype == "bfloat16":
        model = tserve.Model(ttf.TransformerConfig(
            **dict(SHAPE, dtype=dtype)), device="cpu")
    a, _ = _sender(engine, model=model)
    a.replica_id = "p0"
    frames = a.kv_export(PROMPT, traceparent="00-" + "1" * 32 + "-"
                         + "2" * 16 + "-01")
    view = _jax_view(a)
    want = jhandoff.export_prefix(
        copy.deepcopy(a.kv), PROMPT, src="p0",
        block_bytes=lambda bid: jserve.ContinuousEngine._kv_block_bytes(
            view, bid),
        traceparent="00-" + "1" * 32 + "-" + "2" * 16 + "-01")
    assert _canon(frames) == _canon(want)
    L, _, H, bs, hd = a.cache["k"].shape
    for f, bid in zip(frames[1:-1], _block_ids(frames)):
        kv = f["payload"]["kv"]
        assert kv["dtype"] == dtype
        k, v = jserve.ContinuousEngine._decode_kv_block(view, kv)
        assert k.nbytes == L * H * bs * hd * a.cache["k"].element_size()
        for got, pool in ((k, a.cache["k"]), (v, a.cache["v"])):
            assert got.tobytes() == \
                pool[:, bid].contiguous().view(torch.uint8).numpy().tobytes()
    b = engine(model=model)
    assert b.kv_install(frames)["installed_blocks"] == 5
    ids = torch.tensor(b.kv.radix.match(PROMPT))
    sent = torch.tensor(_block_ids(frames))
    for name in ("k", "v"):
        assert torch.equal(b.cache[name][:, ids].view(torch.uint8),
                           a.cache[name][:, sent].view(torch.uint8))


def _reframe(frames, mutate):
    """``frames`` with the middle BLOCK's payload mutated and every digest
    (and the COMMIT chain) recomputed: a stream that verifies, whose
    bytes the engine must refuse."""
    out = [frames[0]]
    chain = 0
    blocks = frames[1:-1]
    for i, f in enumerate(blocks):
        payload = copy.deepcopy(f["payload"])
        if i == len(blocks) // 2:
            mutate(payload)
        out.append(handoff._frame(f["op_seq"], handoff.OP_BLOCK, payload))
        chain = zlib.crc32(out[-1]["digest"].to_bytes(4, "big"),
                           chain) & 0xFFFFFFFF
    out.append(handoff._frame(frames[-1]["op_seq"], handoff.OP_COMMIT, {
        "n_blocks": len(blocks), "chain_digest": chain}))
    handoff.verify_frames(out)
    return out


def _armed(kind):
    def perturb(frames):
        faults.arm(faults.FaultPlan([{
            "kind": kind, "site": handoff.HANDOFF_FAULT_SITE, "at": 0,
            "count": 1}], seed=SEED))
        try:
            return handoff.perturb_frames(frames)
        finally:
            faults.disarm()
    return perturb


def _short(payload):
    payload["kv"]["k"] = base64.b64encode(
        base64.b64decode(payload["kv"]["k"])[:-4]).decode("ascii")


FAILURES = {
    "corrupt": (_armed("corrupt_payload"), "digest mismatch"),
    "drop": (_armed("drop"), "op_seq gap"),
    "torn": (lambda fr: fr[:-1], "COMMIT"),
    "dtype": (lambda fr: _reframe(
        fr, lambda p: p["kv"].update(dtype="bfloat16")), "dtype mismatch"),
    "size": (lambda fr: _reframe(fr, _short), "byte-size mismatch"),
    "no_bytes": (lambda fr: _reframe(fr, lambda p: p.pop("kv")),
                 "no KV bytes"),
}


@pytest.mark.parametrize("failure", sorted(FAILURES))
def test_engine_install_failure_is_a_desync_and_changes_nothing(
        engine, cold, failure):
    perturb, match = FAILURES[failure]
    a, _ = _sender(engine)
    frames = perturb(a.kv_export(PROMPT))
    b = engine()
    b.generate([[9, 8, 7, 6, 5, 4]], 3)
    before = _snapshot(b)
    with pytest.raises(handoff.HandoffDesync, match=match):
        b.kv_install(frames)
    _same(_snapshot(b), before)
    # The request falls back to a plain prefill on the receiver.
    assert b.generate([PROMPT], NEW)[0] == cold


def test_failed_device_copy_resets_the_pools_and_raises(engine, cold):
    """The radix index has adopted the blocks when their device copy
    runs: a failure there zeroes the pools in place and forgets the
    index (``_reset_paged``), so no admission reads unwritten blocks."""
    a, _ = _sender(engine)
    frames = a.kv_export(PROMPT)
    b = engine()
    b.generate([PROMPT[:9]], 3)
    ptrs = _ptrs(b)

    def broken(*args):
        raise RuntimeError("injected device copy failure")

    b._write_blocks = broken
    with pytest.raises(RuntimeError, match="injected device copy"):
        b.kv_install(frames)
    kv = b.kv_stats()
    assert kv["cached_blocks"] == 0 and kv["free_blocks"] == \
        kv["total_blocks"]
    assert all(not p.any() for p in b.cache.values())
    assert _ptrs(b) == ptrs
    assert b.generate([PROMPT], NEW)[0] == cold


def test_dense_engine_is_unsupported(engine):
    eng = engine(kv_cache="dense", kv_block_size=16)
    with pytest.raises(handoff.HandoffUnsupported):
        eng.kv_export(PROMPT)
    with pytest.raises(handoff.HandoffUnsupported):
        eng.kv_install([])


def _hold_loop(eng):
    """Occupy the engine loop with a control call until the returned event
    is set."""
    release, running = threading.Event(), threading.Event()

    def hold():
        running.set()
        release.wait(TIMEOUT_S)

    threading.Thread(target=lambda: eng.run_on_loop(hold),
                     daemon=True).start()
    running.wait(TIMEOUT_S)
    return release


def test_stalled_loop_times_out_and_withdraws_the_call(engine):
    a, _ = _sender(engine)
    release = _hold_loop(a)
    try:
        with pytest.raises(handoff.HandoffTimeout, match="not applied"):
            a.kv_export(PROMPT, timeout_s=0.05)
        b = engine()
        b_release = _hold_loop(b)
        try:
            with pytest.raises(handoff.HandoffTimeout):
                b.kv_install([], timeout_s=0.05)
        finally:
            b_release.set()
    finally:
        release.set()
    # The withdrawn calls never ran; the loops serve on.
    assert len(a.kv_export(PROMPT)) == 7


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_speculating_receiver_serves_the_off_tokens(engine, cold, mode):
    a, want = _sender(engine)
    frames = a.kv_export(PROMPT)
    b = engine(speculate=mode)
    assert b.kv_install(frames)["installed_blocks"] == 5
    hit0 = b.kv_stats()["prefix_hit_tokens"]
    assert b.generate([PROMPT], NEW)[0] == want == cold
    assert b.kv_stats()["prefix_hit_tokens"] - hit0 >= 20


# -- HTTP --------------------------------------------------------------------

def _post(port, path, body):
    """POST ``body`` (bytes, or an object sent as JSON): (status, JSON)."""
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=TIMEOUT_S) as resp:
        return json.loads(resp.read())


@pytest.fixture
def server():
    servers = []

    def start(model, **kw):
        srv, state = tserve.start_server(model, port=0, host="127.0.0.1",
                                         **kw)
        servers.append(srv)
        tserve.wait_ready(state, timeout=TIMEOUT_S)
        return srv.server_address[1]

    yield start
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def test_http_export_install_and_healthz(engine, server, cold):
    a, want = _sender(engine)
    b = engine()
    pa_, pb = server(a, replica_id="p0", role="prefill"), \
        server(b, replica_id="d0", role="decode")
    health = _get(pb, "/healthz")
    assert (health["role"], health["replica"]) == ("decode", "d0")
    assert _get(pa_, "/healthz")["role"] == "prefill"
    code, out = _post(pa_, "/kv/export", {"tokens": PROMPT,
                                          "traceparent": "00-" + "3" * 32
                                          + "-" + "4" * 16 + "-01"})
    assert code == 200 and len(out["frames"]) == 7
    assert out["frames"][0]["payload"]["traceparent"].startswith("00-333")
    code, summary = _post(pb, "/kv/install", {"frames": out["frames"]})
    assert code == 200 and summary["installed_blocks"] == 5
    assert summary["nbytes"] == handoff.frames_nbytes(out["frames"])
    code, body = _post(pb, "/generate", {"tokens": [PROMPT],
                                         "max_new_tokens": NEW})
    assert code == 200 and body["tokens"] == [want] == [cold]
    # A miss: an empty export, not an error.
    assert _post(pa_, "/kv/export", {"tokens": [250, 251, 252, 253, 254]}) == \
        (200, {"frames": []})
    # A desync: 409; the receiver unchanged.
    free = b.kv_stats()["free_blocks"]
    bad = copy.deepcopy(out["frames"])
    bad[2]["digest"] += 1
    code, err = _post(pb, "/kv/install", {"frames": bad})
    assert code == 409 and err["error"].startswith("desync:")
    assert b.kv_stats()["free_blocks"] == free
    # Any other error: 502.
    code, err = _post(pb, "/kv/install", b"{not json")
    assert code == 502 and "error" in err
    # A server started without them reports neither.
    plain = server(engine())
    health = _get(plain, "/healthz")
    assert "role" not in health and "replica" not in health


def test_http_handoff_status_codes(models, engine, server):
    # A dense engine: an empty export (the router re-prefills).
    dense = server(engine(kv_cache="dense", kv_block_size=16))
    assert _post(dense, "/kv/export", {"tokens": PROMPT}) == \
        (200, {"frames": []})
    # A model with no engine: 501.
    plain = server(models[1])
    assert _post(plain, "/kv/export", {"tokens": PROMPT})[0] == 501
    assert _post(plain, "/kv/install", {"frames": []})[0] == 501
    # Another handoff error (a stalled loop: HandoffTimeout): 503.
    eng = engine()
    port = server(eng)
    release = _hold_loop(eng)
    try:
        code, err = _post(port, "/kv/export", {"tokens": PROMPT})
    finally:
        release.set()
    assert code == 503 and "not applied" in err["error"]
    # Not ready: 503.
    state = {"ready": False}
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              tserve.make_handler(eng, state))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        assert _post(srv.server_address[1], "/kv/install",
                     {"frames": []}) == (503, {"error": "not ready"})
    finally:
        srv.shutdown()
        srv.server_close()


def test_jax_router_splits_a_request_over_port_replicas(engine, server,
                                                        cold):
    """JAX's router with ``handoff=True`` in front of a port prefill
    replica and a port decode replica, over HTTP: the prefill leg runs on
    p0, its blocks travel to d0 through /kv/export and /kv/install, and
    d0 serves the request off its radix tree, with a unified engine's
    tokens."""
    want = engine().generate([PROMPT], NEW)[0]
    p0, d0 = engine(), engine()
    urls = {}
    for rid, eng, role in (("p0", p0, "prefill"), ("d0", d0, "decode")):
        port = server(eng, replica_id=rid, role=role)
        urls[rid] = f"http://127.0.0.1:{port}"
    registry = jmetrics.Registry()
    rt = jrouter.ReplicaRouter(registry=registry, handoff=True)
    for rid, url in urls.items():
        probe = jrouter.http_probe(url)
        rt.register(jrouter.ReplicaHandle(
            rid, jrouter.http_transport(url), probe=probe,
            kv_export=jrouter.http_kv_export(url),
            kv_install=jrouter.http_kv_install(url)))
        rt.observe_probe(rid, ok=True, info=probe())
    hit0 = d0.kv_stats()["prefix_hit_tokens"]
    out = rt.submit({"tokens": [PROMPT], "max_new_tokens": NEW})
    assert out["tokens"] == [want] == [cold]
    assert p0.stats()["n_prefills"] >= 1
    assert d0.kv_stats()["prefix_hit_tokens"] - hit0 >= 20
    assert rt.prefix_holder(PROMPT) == "d0"
    text = registry.render().decode()
    assert 'tpu_serving_handoffs_total{outcome="ok"} 1' in text, text


def test_replica_id_and_role_flags():
    args = tserve.build_parser().parse_args(
        ["--replica-id", "d0", "--role", "decode"])
    assert (args.replica_id, args.role) == ("d0", "decode")
    assert tserve.build_parser().parse_args([]).role == "unified"
    with pytest.raises(SystemExit):
        tserve.build_parser().parse_args(["--role", "router"])


def test_build_serving_stamps_the_replica_id(models):
    args = tserve.build_parser().parse_args(
        ["--continuous-batching", "--kv-cache", "paged", "--kv-block-size",
         "4", "--max-slots", "2", "--decode-chunk", "4", "--prefill-chunk",
         "16", "--replica-id", "p7", "--role", "prefill"])
    eng, *_ = tserve.build_serving(args, models[1])
    try:
        eng.generate([PROMPT], 2)
        assert eng.kv_export(PROMPT)[0]["payload"]["src"] == "p7"
    finally:
        eng.shutdown()


def test_timeout_is_the_take_up_not_the_work(engine):
    """``timeout_s`` bounds the wait for the loop to take the call up: a
    call that runs past it once started is waited for."""
    eng = engine()
    started = time.perf_counter()
    assert eng.run_on_loop(lambda: time.sleep(2.5) or 5,
                           timeout_s=2.0) == 5
    assert time.perf_counter() - started >= 2.5


def test_cli_once_with_role_and_replica_id():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.models.serve_cli",
         "--once", "--device", "cpu", "--port", "0", "--n-layers", "1",
         "--d-model", "64", "--n-heads", "2", "--seq-len", "64",
         "--vocab-size", "256", "--continuous-batching", "--kv-cache",
         "paged", "--kv-block-size", "4", "--role", "decode",
         "--replica-id", "d9"],
        cwd=repo, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["tokens"][0][:2] == [5, 6]
