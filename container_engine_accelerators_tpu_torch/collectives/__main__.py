# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Collectives benchmark CLI — the nccl-tests binary analogue, the port
of ``container_engine_accelerators_tpu/collectives/__main__.py``.

    torchrun --nproc-per-node 4 \\
        -m container_engine_accelerators_tpu_torch.collectives \\
        --collective psum --min-bytes 1M --max-bytes 512M --factor 2

(or any launcher that sets the stack's env contract,
``parallel/bootstrap.py``: ``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``). JAX's flags, and ``--device``:
NCCL on ``cuda:{LOCAL_RANK}`` (the default), gloo under ``--device
cpu``. Prints an nccl-tests-style table plus one JSON summary line.

One process per GPU, so a process that joins no world sees one device
and is refused as JAX refuses fewer than 2 devices; one card is such a
world. Where JAX prints once a host (one process a host), here rank 0
prints the table and the summary and the other ranks print nothing; the
times are rank 0's medians. ``--metrics-port`` is served by each host's
local rank 0 (one endpoint a host, as JAX has; every rank records into
its own instruments), and ``--profile-dir`` writes one
``torch.profiler`` trace a rank.
"""

import argparse
import json


def parse_size(s):
    s = s.strip()
    for suffix, mult in (("G", 1 << 30), ("M", 1 << 20), ("K", 1 << 10)):
        if s.upper().endswith(suffix):
            return int(float(s[:-1]) * mult)
    return int(s)


def _joins(env):
    """Whether the env carries the identity contract (JAX's test)."""
    from container_engine_accelerators_tpu_torch.parallel import bootstrap

    return (bootstrap.WORKER_ID_ENV in env
            or bootstrap.MEGASCALE_NUM_SLICES_ENV in env
            or bootstrap.MEGASCALE_SLICE_ID_ENV in env
            or bootstrap.MEGASCALE_COORDINATOR_ENV in env)


def _n_slices(args):
    """``--slices``, else the multislice contract's slice count (JAX
    reads the devices' ``slice_index``), else one slice."""
    if args.slices:
        return args.slices
    from container_engine_accelerators_tpu_torch.parallel import bootstrap

    ms = bootstrap.multislice_options()
    return ms["num_slices"] if ms else 1


def build_parser():
    p = argparse.ArgumentParser(prog="tpu-collectives-bench")
    p.add_argument("--collective", default="psum",
                   choices=["psum", "all_gather", "reduce_scatter",
                            "ppermute", "collective_matmul", "all"])
    p.add_argument("--min-bytes", default="1M")
    p.add_argument("--max-bytes", default="256M")
    p.add_argument("--factor", type=int, default=2)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--json", action="store_true", help="JSON lines only")
    p.add_argument("--dcn", action="store_true",
                   help="bench the inter-slice (DCN) tier of a hybrid mesh "
                        "instead of the intra-slice ICI tier")
    p.add_argument("--slices", type=int, default=0,
                   help="simulate this many slices when the job carries "
                        "no multislice contract (hermetic CPU runs)")
    p.add_argument("--profile-dir", default="",
                   help="capture a torch.profiler trace of the sweep into "
                        "this directory (one a rank; collective overlap "
                        "inspection)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve the collective-tier instruments (latency "
                        "histograms + achieved-bandwidth gauges, tagged "
                        "host/slice) on this port while the sweep runs "
                        "(local rank 0 of each host; 0 = off)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="NCCL on the rank's GPU, or gloo on the CPU")
    return p


def main(argv=None):
    import os

    args = build_parser().parse_args(argv)

    from container_engine_accelerators_tpu_torch.parallel import bootstrap

    # Multi-process runs (the dcn-bench-test.yaml path): join the world
    # through the env contract before touching a device. A process that
    # carries none of the identity envs joins nothing. Misconfigured
    # identity (partial MEGASCALE_*, bad rank) fails loud as JSON.
    opts = None
    try:
        local_rank = bootstrap.local_options()[0]
        if _joins(os.environ):
            opts = bootstrap.process_options()
            if opts["world_size"] > 1:
                opts = bootstrap.initialize_from_env(device=args.device)
            else:
                opts = None
    except bootstrap.BootstrapError as e:
        print(json.dumps({"error": f"distributed bootstrap: {e}"}))
        return 1
    try:
        return _run(args, opts, local_rank)
    finally:
        if opts is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, opts, local_rank):
    n = opts["world_size"] if opts else 1
    rank = opts["rank"] if opts else 0

    def say(line):
        if rank == 0:
            print(line, flush=True)

    if n < 2:
        say(json.dumps({"error": "need >= 2 devices for collectives",
                        "n_devices": n}))
        return 1

    if args.metrics_port:
        from container_engine_accelerators_tpu_torch.obs import (
            collective as obs_collective,
        )
        from container_engine_accelerators_tpu_torch.obs import (
            metrics as obs_metrics,
        )

        cobs = obs_collective.configure()
        if local_rank == 0:
            obs_metrics.serve(
                args.metrics_port, registry=cobs.registry,
                owner="collective bench metrics "
                      "(collectives --metrics-port)",
            )

    import torch

    from container_engine_accelerators_tpu_torch.collectives import (
        bench as cb,
    )
    from container_engine_accelerators_tpu_torch.collectives.device_bench \
        import detect_generation
    from container_engine_accelerators_tpu_torch.parallel import (
        mesh as pmesh,
    )

    device_type = torch.device(opts["device"]).type
    axis = "x"
    tier = "ici"
    if args.dcn:
        n_slices = _n_slices(args)
        if n_slices < 2:
            say(json.dumps({
                "error": "DCN bench needs >= 2 slices (multislice job or "
                         "--slices N)",
                "n_slices": n_slices,
            }))
            return 1
        if n % n_slices:
            say(json.dumps({
                "error": f"cannot chunk {n} devices into {n_slices} slices",
                "n_slices": n_slices, "n_devices": n}))
            return 1
        mesh = pmesh.make_hybrid_mesh({"dcn": n_slices}, {"x": -1},
                                      n_slices=n_slices,
                                      device_type=device_type)
        axis = "dcn"
        tier = "dcn"
    else:
        mesh = pmesh.make_mesh(pmesh.plan_mesh(n, {"x": -1}), device_type)

    gen = detect_generation(torch.device(opts["device"]))
    peak = gen.link_gbps if gen else 0.0
    if args.dcn:
        peak = 0.0  # the network's ceiling is fabric-dependent: raw busbw
    names = (
        sorted(cb.BENCHES) if args.collective == "all" else [args.collective]
    )
    if not args.json:
        extra = f"  slices: {n_slices}" if args.dcn else ""
        say(f"# devices: {n}  generation: {gen.name if gen else '?'}  "
            f"tier: {tier}{extra}  "
            f"nominal busbw ceiling: {peak or 'n/a'} GB/s")
        say(f"{'collective':<15}{'bytes':>12}{'time(us)':>12}"
            f"{'algbw GB/s':>12}{'busbw GB/s':>12}")
    from container_engine_accelerators_tpu_torch.utils.profiling import (
        trace_or_null,
    )

    best = None
    with trace_or_null(args.profile_dir):
        for name in names:
            results = cb.sweep(
                name,
                min_bytes=parse_size(args.min_bytes),
                max_bytes=parse_size(args.max_bytes),
                factor=args.factor,
                iters=args.iters,
                mesh=mesh,
                axis=axis,
            )
            for r in results:
                if args.json:
                    say(json.dumps(r.to_json()))
                else:
                    say(f"{r.collective:<15}{r.msg_bytes:>12}"
                        f"{r.mean_s * 1e6:>12.1f}{r.algbw_gbps:>12.2f}"
                        f"{r.busbw_gbps:>12.2f}")
                if best is None or r.busbw_gbps > best.busbw_gbps:
                    best = r
    if best is None:
        say(json.dumps({
            "error": "empty sweep (check --min-bytes <= --max-bytes)",
        }))
        return 1
    # Round to significant digits, not fixed decimals: hermetic CPU runs
    # measure busbw in the 1e-3 GB/s range and fixed 2-decimal rounding
    # would collapse them to 0.0.
    summary = {
        "metric": f"{tier}_{best.collective}_busbw",
        "value": float(f"{best.busbw_gbps:.4g}"),
        "unit": "GB/s",
        "n_devices": n,
        "vs_peak": round(best.busbw_gbps / peak, 4) if peak else 0.0,
    }
    say(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
