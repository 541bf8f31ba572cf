# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's collective sweep (``collectives/bench.py``, its CLI and the
NCCL environment profiles) against the JAX package, on the CPU.

Each op runs on 2- and 4-rank gloo worlds (``tests/torch_dist_worker.py``
scenario ``collectives``) over the world's 1-D mesh and its dcn 2 × x
hybrid mesh; JAX runs the bench's own ``shard_map`` op on a 2- or
4-device sub-mesh of the 8-device CPU mesh (``tests/conftest.py``) on
the same bf16 ``arange`` input, and every rank's output equals its
device's exactly (``COLLECTIVE_CASES`` keep the sums exact integers, so
no summation order can change a bit). The collective matmul takes
integer-valued inputs for the same reason. The results' fields other
than times, ``sweep``'s sizes and the CLI's summary, refusals, metrics
families and traces are JAX's.
"""

import functools
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from container_engine_accelerators_tpu.collectives import (  # noqa: E402
    __main__ as jcli,
)
from container_engine_accelerators_tpu.collectives import (  # noqa: E402
    bench as jbench,
)
from container_engine_accelerators_tpu.collectives import (  # noqa: E402
    env_profiles as jprofiles,
)
from container_engine_accelerators_tpu.obs import (  # noqa: E402
    collective as jobs_collective,
)
from container_engine_accelerators_tpu.obs import (  # noqa: E402
    metrics as jobs_metrics,
)
from container_engine_accelerators_tpu.parallel import (  # noqa: E402
    make_hybrid_mesh,
)
from container_engine_accelerators_tpu.parallel import (  # noqa: E402
    overlap as jov,
)
from container_engine_accelerators_tpu.utils.compat import (  # noqa: E402
    shard_map,
)
from container_engine_accelerators_tpu_torch.collectives import (  # noqa: E402
    __main__ as cli,
)
from container_engine_accelerators_tpu_torch.collectives import (  # noqa: E402
    cards,
    env_profiles,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as worker  # noqa: E402

BF16 = jnp.bfloat16


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    """The ``collectives`` scenario's outputs on every rank of a world."""
    n = request.param
    outs = worker.spawn("collectives", n,
                        str(tmp_path_factory.mktemp(f"coll{n}")))
    return n, outs


def _jax_mesh(n, tier):
    devices = jax.devices()[:n]
    if tier == "x":
        return Mesh(np.asarray(devices), ("x",)), "x"
    return make_hybrid_mesh({"dcn": 2}, {"x": -1}, devices=devices,
                            n_slices=2), "dcn"


def _per_device(out, mesh):
    """Each mesh device's local block of ``out``, in the mesh's flat
    (rank) order."""
    local = {s.device: np.asarray(s.data, dtype=np.float32)
             for s in out.addressable_shards}
    return [local[d] for d in mesh.devices.flat]


def jax_op(mesh, axis, name, elems):
    """The JAX bench's op for ``name`` on ``mesh``, its output by
    device: the same input, specs and collective as
    ``collectives/bench.py``'s ``bench_<name>``."""
    spec = jbench._dim0_spec(mesh)
    n = mesh.shape[axis]
    if name == "reduce_scatter":
        full = jnp.tile(jnp.arange(n * elems, dtype=jnp.float32).astype(
            BF16), mesh.devices.size // n)
        full = jax.device_put(full, NamedSharding(
            mesh, jbench._dim0_spec(mesh, exclude=(axis,))))
        fn = shard_map(lambda f: jax.lax.psum_scatter(f, axis, tiled=True),
                       mesh=mesh,
                       in_specs=jbench._dim0_spec(mesh, exclude=(axis,)),
                       out_specs=spec, check_vma=False)
        return _per_device(jax.jit(fn)(full), mesh)
    if name == "collective_matmul":
        x, w = worker.collective_matmul_inputs(elems, n)
        x = jax.device_put(jnp.asarray(x, BF16),
                           NamedSharding(mesh, P(axis, None)))
        w = jax.device_put(jnp.asarray(w, BF16),
                           NamedSharding(mesh, P(None, axis)))
        out = jax.jit(functools.partial(
            jov.tp_allgather_matmul, mesh=mesh, axis_name=axis))(x, w)
        return _per_device(out, mesh)
    x = jbench._sharded_input(mesh, elems, BF16)
    if name == "psum":
        body, out_spec = (lambda s: jax.lax.psum(s, axis)), spec
    elif name == "all_gather":
        body = functools.partial(jax.lax.all_gather, axis_name=axis,
                                 tiled=True)
        out_spec = jbench._dim0_spec(mesh, exclude=(axis,))
    else:
        perm = [(i, (i + 1) % n) for i in range(n)]
        body, out_spec = (lambda s: jax.lax.ppermute(s, axis, perm)), spec
    fn = shard_map(body, mesh=mesh, in_specs=spec, out_specs=out_spec,
                   check_vma=False)
    return _per_device(jax.jit(fn)(x), mesh)


@pytest.mark.parametrize("tier", ["x", "dcn"])
@pytest.mark.parametrize("case", worker.COLLECTIVE_CASES,
                         ids=[f"{c}_{e}" for c, e in
                              worker.COLLECTIVE_CASES])
def test_ops_equal_jax(world, tier, case):
    n, outs = world
    mesh, axis = _jax_mesh(n, tier)
    want = jax_op(mesh, axis, *case)
    for rank, out in enumerate(outs):
        _, got = out["ops"][(tier, *case)]
        np.testing.assert_array_equal(got.reshape(want[rank].shape),
                                      want[rank], err_msg=f"rank {rank}")


def test_psum_is_the_reckoned_sum(world):
    """psum of the ranks' arange shards: n × the shard plus the rank
    offsets (JAX's ``test_dcn_psum_is_correct`` reckoning)."""
    n, outs = world
    elems = 16
    want = n * np.arange(elems) + elems * n * (n - 1) / 2
    for out in outs:
        np.testing.assert_array_equal(out["ops"]["x", "psum", elems][1],
                                      want)


@pytest.mark.parametrize("tier", ["x", "dcn"])
@pytest.mark.parametrize("name", sorted(jbench.BENCHES))
def test_results_equal_jax_but_times(world, tier, name):
    n, outs = world
    mesh, axis = _jax_mesh(n, tier)
    want = jbench.BENCHES[name](1 << 12, mesh=mesh, iters=1,
                                axis=axis).to_json()
    for out in outs:
        got = out["results"][tier, name]
        assert set(got) == set(want)
        for key in ("collective", "msg_bytes", "n_devices"):
            assert got[key] == want[key], key
        assert got["mean_s"] > 0 and got["algbw_gbps"] > 0
        assert got["busbw_gbps"] / got["algbw_gbps"] == pytest.approx(
            want["busbw_gbps"] / want["algbw_gbps"], rel=1e-9)
        if name == "collective_matmul":
            assert set(got["detail"]) == set(want["detail"])
            for key in ("m", "k", "n_cols"):
                assert got["detail"][key] == want["detail"][key]


def test_sweep_sizes(world):
    n, outs = world
    mesh, _ = _jax_mesh(n, "x")
    want = [r.msg_bytes for r in jbench.sweep(
        "ppermute", min_bytes=1 << 12, max_bytes=1 << 14, factor=2,
        mesh=mesh, iters=1)]
    assert want == [1 << 12, 1 << 13, 1 << 14]
    for out in outs:
        assert out["sweep"] == want


# -- the CLI ------------------------------------------------------------------

def _cli_world(tmp_path, argv, world=2):
    argv = ["--device", "cpu", "--iters", "1", *argv]
    runs = worker.serve_world({"argv": argv}, str(tmp_path), world=world,
                              timeout=120, scenario="collectives_cli")
    for rank, (rc, out, log) in enumerate(runs):
        assert out is not None, f"rank {rank}:\n{log[-3000:]}"
    return [out for _, out, _ in runs]


def _jax_cli(capsys, argv):
    rc = jcli.main(argv)
    return rc, capsys.readouterr().out.splitlines()


def test_cli_summary_and_table_on_rank_0(tmp_path, capsys):
    outs = _cli_world(tmp_path, ["--collective", "all", "--min-bytes",
                                 "4K", "--max-bytes", "8K"])
    assert [o["rc"] for o in outs] == [0, 0]
    assert outs[1]["lines"] == []
    lines = outs[0]["lines"]
    summary = json.loads(lines[-1])
    _, jlines = _jax_cli(capsys, ["--collective", "all", "--min-bytes",
                                  "4K", "--max-bytes", "8K", "--iters",
                                  "1"])
    want = json.loads(jlines[-1])
    assert set(summary) == set(want)
    assert summary["n_devices"] == 2 and summary["unit"] == want["unit"]
    assert summary["metric"].startswith("ici_")
    assert summary["value"] > 0 and summary["vs_peak"] == 0.0
    # The table: a header, the column names, 2 sizes of each collective.
    assert lines[0].startswith("# devices: 2  generation: ?  tier: ici")
    assert lines[1].split() == jlines[1].split()
    assert len(lines) == 2 + 2 * len(jbench.BENCHES) + 1


def test_cli_dcn_sweep(tmp_path, capsys):
    argv = ["--dcn", "--slices", "2", "--collective", "psum",
            "--min-bytes", "4K", "--max-bytes", "4K", "--json"]
    outs = _cli_world(tmp_path, argv)
    assert [o["rc"] for o in outs] == [0, 0]
    got = [json.loads(line) for line in outs[0]["lines"]]
    _, jlines = _jax_cli(capsys, argv + ["--iters", "1"])
    want = [json.loads(line) for line in jlines]
    assert [set(g) for g in got] == [set(w) for w in want]
    assert got[-1]["metric"] == want[-1]["metric"] == "dcn_psum_busbw"
    assert got[0]["n_devices"] == want[0]["n_devices"] == 2


def test_cli_refuses_one_rank_as_jax(monkeypatch, capsys):
    """No world joined: one device, refused in JAX's words."""
    for name in list(os.environ):
        if name.startswith(("TPU_", "MEGASCALE_", "LOCAL_")):
            monkeypatch.delenv(name)
    assert cli.main(["--device", "cpu", "--json"]) == 1
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a: one)
    rc, jlines = _jax_cli(capsys, ["--json"])
    assert rc == 1
    assert got == json.loads(jlines[-1]) == {
        "error": "need >= 2 devices for collectives", "n_devices": 1}


def test_cli_dcn_refusals_as_jax(tmp_path, capsys):
    one_slice, uneven = _cli_world(tmp_path, ["--dcn", "--json"]), None
    rc, jlines = _jax_cli(capsys, ["--dcn", "--collective", "psum",
                                   "--json"])
    assert rc == 1 and [o["rc"] for o in one_slice] == [1, 1]
    assert json.loads(one_slice[0]["lines"][-1]) == json.loads(jlines[-1])
    assert one_slice[1]["lines"] == []
    uneven = _cli_world(tmp_path, ["--dcn", "--slices", "3", "--json"])
    rc, jlines = _jax_cli(capsys, ["--dcn", "--slices", "3", "--json"])
    want = json.loads(jlines[-1])
    got = json.loads(uneven[0]["lines"][-1])
    assert rc == 1 and [o["rc"] for o in uneven] == [1, 1]
    assert got == {**want, "n_devices": 2,
                   "error": want["error"].replace("8 devices", "2 devices")}


@pytest.mark.parametrize("env", [{"MEGASCALE_NUM_SLICES": "2"},
                                 {"MEGASCALE_SLICE_ID": "1"}])
def test_cli_partial_multislice_env_fails_loud(monkeypatch, capsys, env):
    for name in list(os.environ):
        if name.startswith(("TPU_", "MEGASCALE_", "LOCAL_")):
            monkeypatch.delenv(name)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert cli.main(["--device", "cpu", "--collective", "psum",
                     "--json"]) == 1
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    rc, jlines = _jax_cli(capsys, ["--collective", "psum", "--json"])
    assert rc == 1
    assert got == json.loads(jlines[-1])
    assert got["error"].startswith("distributed bootstrap: partial")


def _families(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE")}


def test_cli_metrics_port_exposes_jax_families(tmp_path):
    outs = _cli_world(tmp_path, ["--metrics-port", "9123", "--collective",
                                 "psum", "--min-bytes", "1K",
                                 "--max-bytes", "1K", "--json"])
    assert [o["rc"] for o in outs] == [0, 0]
    # One endpoint a host: local rank 0 serves it.
    (port, text), = outs[0]["served"]
    assert port == 9123 and outs[1]["served"] == []
    served = {}

    def fake_serve(port, registry=None, owner=""):
        served["registry"] = registry

    real = jobs_metrics.serve
    jobs_metrics.serve = fake_serve
    try:
        assert jcli.main(["--metrics-port", "9123", "--collective", "psum",
                          "--min-bytes", "1K", "--max-bytes", "1K",
                          "--iters", "1", "--json"]) == 0
    finally:
        jobs_metrics.serve = real
        jobs_collective.configure(enabled=False)
    want = served["registry"].render().decode()
    assert _families(text) == _families(want)
    assert 'tpu_collective_latency_seconds_count{collective="psum"' in text


def test_cli_profile_dir_writes_a_trace_a_rank(tmp_path):
    prof = tmp_path / "trace"
    outs = _cli_world(tmp_path, ["--collective", "ppermute", "--min-bytes",
                                 "4K", "--max-bytes", "4K", "--json",
                                 "--profile-dir", str(prof)])
    assert [o["rc"] for o in outs] == [0, 0]
    assert len(list(prof.glob("*.pt.trace.json"))) == 2


def test_cli_flags_are_jax_s_and_device():
    """JAX's flags with their defaults, and the port's ``--device``."""
    import argparse

    def flags(parser):
        return {a.dest: a.default for a in parser._actions
                if not isinstance(a, argparse._HelpAction)}

    captured = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        captured["parser"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            jcli.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    theirs = flags(captured["parser"])
    ours = flags(cli.build_parser())
    assert ours.pop("device") == "cuda"
    assert ours == theirs


# -- the environment profiles and the link ceiling ------------------------------

def test_env_profiles_names_and_configmap():
    assert sorted(env_profiles.PROFILES) == sorted(jprofiles.PROFILES)
    for name in env_profiles.PROFILES:
        env = env_profiles.profile_env(name)
        assert env and all(k.startswith(("NCCL_", "TORCH_")) for k in env)
        assert all(isinstance(v, str) and v for v in env.values())
    with pytest.raises(KeyError) as theirs:
        jprofiles.profile_env("nope")
    with pytest.raises(KeyError) as ours:
        env_profiles.profile_env("nope")
    assert str(ours.value) == str(theirs.value)
    doc = yaml.safe_load(env_profiles.render_configmap("p", "ns"))
    want = yaml.safe_load(jprofiles.render_configmap("p", "ns"))
    assert {k: v for k, v in doc.items() if k != "data"} == \
        {k: v for k, v in want.items() if k != "data"}
    assert set(doc["data"]) == set(want["data"])
    for name, body in doc["data"].items():
        lines = dict(line.split("=", 1) for line in body.splitlines())
        assert lines == env_profiles.PROFILES[name[:-len(".env")]]


def test_card_link_ceiling():
    assert cards.H100_SXM.link_gbps == 450.0
    assert cards.Card("x", 1.0, 1.0, 1.0, 1.0).link_gbps == 0.0


def test_world_smoke_collectives_and_moe_tp_on_two_gloo_ranks():
    """``parallel/world_smoke.py --checks collectives serve_moe_tp`` (the
    four-card call's checks) on two gloo ranks: every op's output held to
    its plain expectation on the 1-D and the dcn mesh, the CLI's three
    sweeps (all, psum under ``low-latency``, ``--dcn --slices 2``), and
    the MoE model over tp 2 held to one device's."""
    import subprocess

    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.parallel.world_smoke",
         "--world", "2", "--device", "cpu", "--checks", "collectives",
         "serve_moe_tp", "--wide-shrink", "32", "--collective-min", "4K",
         "--collective-max", "8K", "--timeout-s", "240"],
        cwd=worker.REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    assert [r.get("check", r.get("run")) for r in rows] == [
        "collectives_ops", "serve_moe_tp", None, "collectives_sweep",
        "collectives_sweep", "collectives_sweep", None]
    assert all(r["ok"] for r in rows)
    ops = rows[0]["max_rel_err"]
    assert set(ops) == {"x_16", "x_524288", "dcn_16", "dcn_524288"}
    assert all(set(v) == set(jbench.BENCHES) for v in ops.values())
    assert rows[1]["tp"] == 2 and rows[1]["ranks_agree"]
    assert [r["run"] for r in rows[3:6]] == ["all", "psum_low_latency",
                                             "dcn"]
    assert rows[4]["env"] == env_profiles.profile_env("low-latency")
    assert rows[5]["summary"]["metric"].startswith("dcn_")
