# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""TPU generation and slice topology model.

This is the TPU replacement for the reference's PCI/NUMA-centric hardware
model (reference pkg/gpu/nvidia/nvmlutil/nvmlutil.go:88-151) and for its
rack/host topology labels (gke-topology-scheduler/label-nodes-daemon.py:26-57):
a TPU node's physical locality is its (x, y, z) ICI coordinate inside a slice,
not a rack path, and collective performance is set by the ICI mesh/torus shape.

Nominal per-chip hardware figures follow the public "How to Scale Your Model"
tables; they feed benchmark ``vs_peak`` reporting and scheduler scoring, not
any correctness path.

Copy of ``container_engine_accelerators_tpu/topology/slice.py``: the
fleet's gang placement reads a slice's host grid from it.
"""

import dataclasses
import math
import re


@dataclasses.dataclass(frozen=True)
class TpuGeneration:
    """Per-generation invariants."""

    name: str
    # Number of TensorCores per chip (2 for megacore generations).
    cores_per_chip: int
    # ICI mesh dimensionality: 2 (v5e/v6e 2D mesh) or 3 (v4/v5p 3D torus).
    ici_dims: int
    # ICI links per chip (2*ici_dims for a full torus/mesh interior).
    ici_links: int
    # Nominal per-link, per-direction ICI bandwidth in GB/s.
    ici_link_gbps: float
    # Nominal HBM bandwidth per chip, GB/s.
    hbm_gbps: float
    # HBM capacity per chip, GiB.
    hbm_gib: float
    # Nominal peak bf16 TFLOP/s per chip.
    bf16_tflops: float
    # Does the accelerator_type count TensorCores (v2-v4, v5p) or chips
    # (v5e, v6e)?
    type_counts_cores: bool
    # Default chips per host (one TPU VM / K8s node).
    chips_per_host: int
    # Host shape inside the slice, as an ici_dims-length tuple.
    host_bounds: tuple

    @property
    def ici_bisection_gbps_per_chip(self) -> float:
        """Nominal per-chip all-reduce bus bandwidth ceiling over ICI."""
        return self.ici_links * self.ici_link_gbps


# Nominal per-chip figures (public scaling-book numbers, rounded).
GENERATIONS = {
    "v2": TpuGeneration("v2", 2, 2, 4, 50.0, 700.0, 16, 46.0, True, 4, (2, 2)),
    "v3": TpuGeneration("v3", 2, 2, 4, 70.0, 900.0, 32, 123.0, True, 4, (2, 2)),
    "v4": TpuGeneration("v4", 2, 3, 6, 45.0, 1228.0, 32, 275.0, True, 4, (2, 2, 1)),
    "v5e": TpuGeneration("v5e", 1, 2, 4, 45.0, 819.0, 16, 197.0, False, 4, (2, 2)),
    "v5p": TpuGeneration("v5p", 2, 3, 6, 90.0, 2765.0, 95, 459.0, True, 4, (2, 2, 1)),
    "v6e": TpuGeneration("v6e", 1, 2, 4, 90.0, 1640.0, 32, 918.0, False, 4, (2, 2)),
}

# Aliases as they appear in accelerator_type strings / GCE metadata.
_GEN_ALIASES = {
    "v2": "v2",
    "v3": "v3",
    "v4": "v4",
    "v5litepod": "v5e",
    "v5e": "v5e",
    "v5p": "v5p",
    "v6e": "v6e",
}

# Standard 2D slice shapes for v5e/v6e (chips). Non-listed sizes fall back to
# balanced factorization.
_SHAPES_2D = {
    1: (1, 1),
    4: (2, 2),
    8: (2, 4),
    16: (4, 4),
    32: (4, 8),
    64: (8, 8),
    128: (8, 16),
    256: (16, 16),
}

_TYPE_RE = re.compile(r"^(v\d+[a-z]*|v5litepod)-(\d+)$")


def _balanced_shape(n, dims):
    """Factor n into `dims` factors as close to cubic/square as possible."""
    shape = [1] * dims
    remaining = n
    for i in range(dims - 1):
        target = round(remaining ** (1.0 / (dims - i)))
        f = 1
        for cand in range(target, 0, -1):
            if remaining % cand == 0:
                f = cand
                break
        shape[i] = f
        remaining //= f
    shape[-1] = remaining
    return tuple(sorted(shape))


@dataclasses.dataclass(frozen=True)
class SliceSpec:
    """A concrete TPU slice: generation + chip-mesh shape + host layout."""

    generation: TpuGeneration
    accelerator_type: str
    num_chips: int
    # Chip-mesh shape, e.g. (4, 4) for v5e-16, (2, 2, 2) for v4-16.
    topology: tuple

    @property
    def num_cores(self) -> int:
        return self.num_chips * self.generation.cores_per_chip

    @property
    def num_hosts(self) -> int:
        return max(1, self.num_chips // self.generation.chips_per_host)

    @property
    def chips_per_host_bounds(self) -> tuple:
        """Shape of one host's chips inside the chip mesh (TPU_CHIPS_PER_HOST_BOUNDS)."""
        if self.num_hosts == 1:
            return self.topology
        return self.generation.host_bounds

    @property
    def host_bounds(self) -> tuple:
        """Host grid shape (TPU_HOST_BOUNDS)."""
        cb = self.chips_per_host_bounds
        return tuple(t // c for t, c in zip(self.topology, cb))

    def host_coords(self, worker_id: int) -> tuple:
        """ICI host coordinate for a worker index (row-major over host_bounds)."""
        hb = self.host_bounds
        coords = []
        rem = worker_id
        for dim in reversed(hb):
            coords.append(rem % dim)
            rem //= dim
        if rem:
            raise ValueError(
                f"worker_id {worker_id} out of range for host bounds {hb}"
            )
        return tuple(reversed(coords))

    def worker_id(self, host_coords: tuple) -> int:
        hb = self.host_bounds
        wid = 0
        for c, dim in zip(host_coords, hb):
            if not 0 <= c < dim:
                raise ValueError(f"host coord {host_coords} out of bounds {hb}")
            wid = wid * dim + c
        return wid

    def env(self, worker_id=None):
        """The TPU_* environment contract for a workload on this slice.

        Mirrors what the Allocate response materializes (the TPU analogue of
        the reference's CUDA_MPS_* envs, pkg/gpu/nvidia/manager.go:333-346).
        """
        e = {
            "TPU_ACCELERATOR_TYPE": self.accelerator_type,
            "TPU_CHIPS_PER_HOST_BOUNDS": ",".join(
                str(c) for c in self.chips_per_host_bounds
            ),
            "TPU_HOST_BOUNDS": ",".join(str(c) for c in self.host_bounds),
            "TPU_SKIP_MDS_QUERY": "true",
        }
        if worker_id is not None:
            e["TPU_WORKER_ID"] = str(worker_id)
        return e


def parse_accelerator_type(accelerator_type: str) -> SliceSpec:
    """Parse e.g. "v5litepod-16", "v5e-256", "v4-8", "v5p-128".

    For core-counted generations (v2-v4, v5p) the suffix is TensorCores; for
    chip-counted ones (v5e, v6e) it is chips.
    """
    m = _TYPE_RE.match(accelerator_type.strip())
    if not m:
        raise ValueError(f"unparseable accelerator_type: {accelerator_type!r}")
    alias, count = m.group(1), int(m.group(2))
    gen_name = _GEN_ALIASES.get(alias)
    if gen_name is None:
        raise ValueError(f"unknown TPU generation in {accelerator_type!r}")
    gen = GENERATIONS[gen_name]
    if gen.type_counts_cores:
        if count % gen.cores_per_chip:
            raise ValueError(
                f"{accelerator_type}: core count {count} not divisible by "
                f"cores/chip {gen.cores_per_chip}"
            )
        num_chips = count // gen.cores_per_chip
    else:
        num_chips = count
    if gen.ici_dims == 2:
        topo = _SHAPES_2D.get(num_chips) or _balanced_shape(num_chips, 2)
    else:
        topo = _balanced_shape(num_chips, 3)
    return SliceSpec(gen, accelerator_type, num_chips, topo)


def parse_topology_env(topology: str) -> tuple:
    """Parse a "4x4" / "2x2x2"-style TPU topology string."""
    parts = topology.lower().split("x")
    if not all(p.isdigit() for p in parts):
        raise ValueError(f"bad topology string: {topology!r}")
    return tuple(int(p) for p in parts)


def ici_allreduce_peak_gbps(spec: SliceSpec) -> float:
    """Nominal per-chip all-reduce bus-bandwidth ceiling for a slice.

    For a ring over a torus axis, each chip sends and receives on its axis
    links; the classic busbw ceiling per chip is link_bw * links_used. Axes of
    extent 1 contribute nothing; wraparound (torus) doubles usable bandwidth
    per axis vs. an open mesh for extents > 2 — we report the conservative
    mesh figure.
    """
    gen = spec.generation
    links_used = sum(2 if d > 2 else (1 if d == 2 else 0) for d in spec.topology)
    links_used = min(links_used, gen.ici_links)
    return links_used * gen.ici_link_gbps


def slice_hbm_total_gib(spec: SliceSpec) -> float:
    return spec.num_chips * spec.generation.hbm_gib


def min_hosts_for_chips(gen: TpuGeneration, chips: int) -> int:
    return max(1, math.ceil(chips / gen.chips_per_host))
