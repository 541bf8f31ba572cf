# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Multi-process bootstrap from the stack's worker-identity contract.

Port of ``container_engine_accelerators_tpu/parallel/bootstrap.py``. The
gang scheduler stamps every bound gang member with rank, world size and
the rank-ordered hostname list; the pod's downward API and ``tpu-run``
turn them into environment variables. This module turns that contract
into a ``torch.distributed.init_process_group`` call.

Env contract (JAX's, copied whole):

  TPU_WORKER_ID          this host's rank (gang completion index)
  TPU_WORKER_HOSTNAMES   comma-separated hostnames in rank order
  TPU_COORDINATOR_PORT   optional, default 8476
  MEGASCALE_*            the multislice contract (``multislice_options``)
  TPU_HEALTH_CHECK_LOG_FILE
                         optional: truncated before the rendezvous, and
                         ``TPU_BOOTSTRAP_OK rank=<r> world=<n>`` appended
                         once the world is joined (the training
                         manifests' startupProbe greps for it)

One process per GPU. JAX runs one process per host, which owns all the
host's chips, so ``TPU_WORKER_ID`` numbers hosts. The port runs one
process per device, started by a launcher such as ``torchrun``, which
sets ``LOCAL_RANK`` (this process's device on the host, default 0) and
``LOCAL_WORLD_SIZE`` (processes on the host, default 1). The contract
maps as

  rank  = process_id × local_world + local_rank
  world = num_processes × local_world

where ``process_id`` and ``num_processes`` are JAX's (multislice
included), so the multislice arithmetic holds with per_slice = hosts ×
local_world: slice ``s`` holds ranks ``[s × per_slice, (s+1) ×
per_slice)``. The device is ``cuda:{local_rank}`` and the backend NCCL;
on the CPU the backend is gloo. A CUDA run never falls back to gloo.
The marker reports the global rank and world.
"""

import datetime
import os

WORKER_ID_ENV = "TPU_WORKER_ID"
WORKER_HOSTNAMES_ENV = "TPU_WORKER_HOSTNAMES"
COORDINATOR_PORT_ENV = "TPU_COORDINATOR_PORT"
DEFAULT_COORDINATOR_PORT = 8476
HEALTH_LOG_ENV = "TPU_HEALTH_CHECK_LOG_FILE"
HEALTH_LOG_MARKER = "TPU_BOOTSTRAP_OK"
# torchrun's per-host identity of one process (one process per device).
LOCAL_RANK_ENV = "LOCAL_RANK"
LOCAL_WORLD_ENV = "LOCAL_WORLD_SIZE"
# How long the rendezvous waits for every rank (JAX's coordination
# service waits 300 s by default).
DEFAULT_TIMEOUT_S = 300.0


class BootstrapError(RuntimeError):
    pass


def distributed_options(env=None):
    """The per-host options from the env contract: a dict with
    coordinator_address, num_processes, process_id — or raises
    BootstrapError naming exactly which variable is missing or
    malformed (so a mis-wired manifest fails loud, not with a hang at
    barrier time)."""
    env = os.environ if env is None else env
    worker_id = env.get(WORKER_ID_ENV)
    if worker_id is None:
        raise BootstrapError(f"{WORKER_ID_ENV} is not set")
    try:
        process_id = int(worker_id)
    except ValueError:
        raise BootstrapError(
            f"{WORKER_ID_ENV}={worker_id!r} is not an integer"
        )
    hostnames_raw = env.get(WORKER_HOSTNAMES_ENV)
    if not hostnames_raw:
        raise BootstrapError(f"{WORKER_HOSTNAMES_ENV} is not set")
    hostnames = [h.strip() for h in hostnames_raw.split(",") if h.strip()]
    if not hostnames:
        raise BootstrapError(f"{WORKER_HOSTNAMES_ENV}={hostnames_raw!r} empty")
    if not 0 <= process_id < len(hostnames):
        raise BootstrapError(
            f"{WORKER_ID_ENV}={process_id} out of range for "
            f"{len(hostnames)} hostnames"
        )
    port = env.get(COORDINATOR_PORT_ENV, str(DEFAULT_COORDINATOR_PORT))
    try:
        port_num = int(port)
    except ValueError:
        raise BootstrapError(f"{COORDINATOR_PORT_ENV}={port!r} not an integer")
    return {
        "coordinator_address": f"{hostnames[0]}:{port_num}",
        "num_processes": len(hostnames),
        "process_id": process_id,
    }


def local_options(env=None):
    """(local_rank, local_world) from torchrun's ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` (defaults 0 and 1); BootstrapError names the
    variable that is malformed."""
    env = os.environ if env is None else env
    values = {}
    for name, default in ((LOCAL_RANK_ENV, 0), (LOCAL_WORLD_ENV, 1)):
        raw = env.get(name, str(default))
        try:
            values[name] = int(raw)
        except ValueError:
            raise BootstrapError(f"{name}={raw!r} is not an integer")
    local_rank, local_world = values[LOCAL_RANK_ENV], values[LOCAL_WORLD_ENV]
    if local_world < 1:
        raise BootstrapError(f"{LOCAL_WORLD_ENV}={local_world} (needs >= 1)")
    if not 0 <= local_rank < local_world:
        raise BootstrapError(
            f"{LOCAL_RANK_ENV}={local_rank} out of range for "
            f"{LOCAL_WORLD_ENV}={local_world}"
        )
    return local_rank, local_world


def process_options(env=None, **overrides):
    """This process's place in the world: JAX's global options
    (:func:`global_distributed_options`, ``overrides`` replacing its
    coordinator_address, num_processes or process_id) with ``rank``,
    ``world_size``, ``local_rank`` and ``local_world_size`` added, rank =
    process_id × local_world + local_rank."""
    opts = global_distributed_options(env)
    opts.update(overrides)
    local_rank, local_world = local_options(env)
    opts.update(
        rank=opts["process_id"] * local_world + local_rank,
        world_size=opts["num_processes"] * local_world,
        local_rank=local_rank, local_world_size=local_world,
    )
    return opts


def initialize_from_env(env=None, device="cuda",
                        timeout_s=DEFAULT_TIMEOUT_S, **overrides):
    """``torch.distributed.init_process_group`` from the env contract;
    returns the options dict (:func:`process_options`, with ``device``
    and ``backend``).

    ``device="cuda"`` joins over NCCL on ``cuda:{local_rank}`` (and makes
    it the current device); ``"cpu"`` over gloo. The marker file is
    truncated first and gets its line once the world is joined. A
    rendezvous that fails raises BootstrapError naming the variables
    that address it."""
    import torch
    import torch.distributed as dist

    _reset_health_marker(env)
    opts = process_options(env, **overrides)
    local_rank = opts["local_rank"]
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to join "
                "over gloo on the CPU")
        torch.cuda.set_device(local_rank)
        opts.update(device=f"cuda:{local_rank}", backend="nccl")
    elif kind == "cpu":
        opts.update(device="cpu", backend="gloo")
    else:
        raise ValueError(f"device {device!r}: expected cuda or cpu")
    # NCCL binds the group to this process's device (no guessing it from
    # the rank).
    bind = {"device_id": torch.device(opts["device"])} if kind == "cuda" \
        else {}
    try:
        dist.init_process_group(
            opts["backend"],
            init_method=f"tcp://{opts['coordinator_address']}",
            rank=opts["rank"], world_size=opts["world_size"],
            timeout=datetime.timedelta(seconds=timeout_s), **bind,
        )
    except (RuntimeError, ValueError) as err:
        raise BootstrapError(
            f"rendezvous at {opts['coordinator_address']} (the first of "
            f"{WORKER_HOSTNAMES_ENV}, port {COORDINATOR_PORT_ENV}) as rank "
            f"{opts['rank']} of {opts['world_size']} failed: {err}"
        ) from err
    _write_health_marker(env, {"process_id": opts["rank"],
                               "num_processes": opts["world_size"]})
    return opts


def _health_log_path(env):
    env = os.environ if env is None else env
    return env.get(HEALTH_LOG_ENV)


def _reset_health_marker(env):
    """Truncate the marker file before attempting the rendezvous: the
    probe must gate on THIS incarnation joining, not a stale marker left
    on the (restart-surviving) emptyDir by a previous container."""
    path = _health_log_path(env)
    if not path:
        return
    try:
        with open(path, "w"):
            pass
    except OSError:
        pass


def _write_health_marker(env, opts):
    """Append the startup-probe marker once the world is joined (no-op
    unless TPU_HEALTH_CHECK_LOG_FILE is set; never raises)."""
    path = _health_log_path(env)
    if not path:
        return
    try:
        with open(path, "a") as f:
            f.write(
                f"{HEALTH_LOG_MARKER} rank={opts['process_id']} "
                f"world={opts['num_processes']}\n"
            )
    except OSError:
        pass


# -- multislice (DCN-spanning) bootstrap ---------------------------------------
#
# A multislice job runs one gang per slice. The MEGASCALE_* variables are
# the contract GKE's multislice operator sets; the stack's scheduler and
# manifests set the same ones.

MEGASCALE_COORDINATOR_ENV = "MEGASCALE_COORDINATOR_ADDRESS"
MEGASCALE_NUM_SLICES_ENV = "MEGASCALE_NUM_SLICES"
MEGASCALE_SLICE_ID_ENV = "MEGASCALE_SLICE_ID"
MEGASCALE_PORT_ENV = "MEGASCALE_PORT"
DEFAULT_MEGASCALE_PORT = 8081


def multislice_options(env=None):
    """Parse the MEGASCALE_* multislice contract.

    Returns None when the job is single-slice (no MEGASCALE vars set);
    otherwise a dict {num_slices, slice_id, coordinator_address} —
    raising BootstrapError on a half-configured contract so a mis-wired
    manifest fails loud.
    """
    env = os.environ if env is None else env
    raw_n = env.get(MEGASCALE_NUM_SLICES_ENV)
    raw_id = env.get(MEGASCALE_SLICE_ID_ENV)
    raw_coord = env.get(MEGASCALE_COORDINATOR_ENV)
    if raw_n is None and raw_id is None and raw_coord is None:
        return None
    if raw_n is None or raw_id is None or raw_coord is None:
        missing = [
            name for name, v in (
                (MEGASCALE_NUM_SLICES_ENV, raw_n),
                (MEGASCALE_SLICE_ID_ENV, raw_id),
                (MEGASCALE_COORDINATOR_ENV, raw_coord),
            ) if v is None
        ]
        raise BootstrapError(
            f"partial multislice config: missing {', '.join(missing)}"
        )
    try:
        num_slices = int(raw_n)
        slice_id = int(raw_id)
    except ValueError:
        raise BootstrapError(
            f"{MEGASCALE_NUM_SLICES_ENV}={raw_n!r} / "
            f"{MEGASCALE_SLICE_ID_ENV}={raw_id!r} must be integers"
        )
    if num_slices < 2:
        raise BootstrapError(
            f"{MEGASCALE_NUM_SLICES_ENV}={num_slices} (multislice needs >= 2)"
        )
    if not 0 <= slice_id < num_slices:
        raise BootstrapError(
            f"{MEGASCALE_SLICE_ID_ENV}={slice_id} out of range for "
            f"{num_slices} slices"
        )
    coord = raw_coord
    if ":" not in coord:
        raw_port = env.get(MEGASCALE_PORT_ENV, str(DEFAULT_MEGASCALE_PORT))
        try:
            ms_port = int(raw_port)
        except ValueError:
            raise BootstrapError(
                f"{MEGASCALE_PORT_ENV}={raw_port!r} not an integer"
            )
        coord = f"{coord}:{ms_port}"
    return {
        "num_slices": num_slices,
        "slice_id": slice_id,
        "coordinator_address": coord,
    }


def global_distributed_options(env=None):
    """Combine the per-slice gang contract with the multislice contract.

    Within slice s, host r (of W per-slice hosts) gets global process_id
    s*W + r. The rendezvous runs on the multislice coordinator HOST
    (slice 0's rank-0) at TPU_COORDINATOR_PORT (default 8476), not on the
    MEGASCALE port, which another service owns. Single-slice jobs fall
    through to ``distributed_options`` unchanged.
    """
    env = os.environ if env is None else env
    ms = multislice_options(env)
    opts = distributed_options(env)
    if ms is None:
        return opts
    host = ms["coordinator_address"].rsplit(":", 1)[0]
    raw_port = env.get(COORDINATOR_PORT_ENV, str(DEFAULT_COORDINATOR_PORT))
    try:
        port = int(raw_port)
    except ValueError:
        raise BootstrapError(
            f"{COORDINATOR_PORT_ENV}={raw_port!r} not an integer"
        )
    per_slice = opts["num_processes"]
    return {
        "coordinator_address": f"{host}:{port}",
        "num_processes": ms["num_slices"] * per_slice,
        "process_id": ms["slice_id"] * per_slice + opts["process_id"],
    }
