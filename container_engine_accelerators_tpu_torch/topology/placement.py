# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Contiguous sub-mesh placement over a TPU slice's host grid.

The reference's gang scheduler brute-forces pod→node assignments over all
node combinations, minimizing pairwise rack distance
(schedule-daemon.py:500-544) — O(C(nodes, pods)) and a known scaling cliff.
TPU slices are regular grids, so placement is *structured*: a gang of n hosts
should occupy an axis-aligned contiguous sub-grid (all ICI hops stay inside
the gang, no stragglers off-mesh). We enumerate sub-grid shapes whose volume
is n and positions where every host is free — polynomial, exact, and
topology-optimal by construction.

Rank order: hosts of the chosen sub-grid are returned in row-major order of
their coordinates; callers map job-completion-index i → i-th host so JAX
worker IDs line up with ICI coordinates (SURVEY.md §7 hard part (b)).

Port: a subset of ``container_engine_accelerators_tpu/topology/placement.py``,
the sub-mesh search ``find_submesh`` / ``find_submesh_matching`` and what
they call, on the pure-Python path: JAX's copy loads an optional native
scanner through ctypes, which this one leaves out (both give the same
sub-mesh). The DCN-compact node pick is not copied.
"""

import dataclasses
import itertools
import logging

log = logging.getLogger(__name__)

@dataclasses.dataclass(frozen=True)
class Submesh:
    origin: tuple
    shape: tuple
    # Host coordinates in row-major order (the gang rank order).
    hosts: tuple

    @property
    def size(self):
        return len(self.hosts)


def _factorizations(n, dims):
    """All ordered factorizations of n into `dims` positive factors."""
    if dims == 1:
        yield (n,)
        return
    for f in range(1, n + 1):
        if n % f == 0:
            for rest in _factorizations(n // f, dims - 1):
                yield (f,) + rest


def _surface(shape):
    """Surface area of the sub-grid (sum over dims of 2·volume/s_i) — smaller
    means more balanced/compact, which maximizes interior ICI links."""
    volume = 1
    for s in shape:
        volume *= s
    return sum(2 * volume // s for s in shape)


def enumerate_submeshes(grid_shape, n_hosts):
    """All contiguous axis-aligned sub-grids of volume n_hosts inside
    grid_shape, most compact shapes first."""
    for shape in _submesh_shapes(grid_shape, n_hosts):
        origin_ranges = [
            range(g - s + 1) for g, s in zip(grid_shape, shape)
        ]
        for origin in itertools.product(*origin_ranges):
            yield _submesh_at(origin, shape)


def _submesh_shapes(grid_shape, n_hosts):
    return sorted(
        {
            s
            for s in _factorizations(n_hosts, len(grid_shape))
            if all(a <= b for a, b in zip(s, grid_shape))
        },
        key=_surface,
    )


def _submesh_at(origin, shape):
    hosts = tuple(
        tuple(o + d for o, d in zip(origin, delta))
        for delta in itertools.product(*[range(s) for s in shape])
    )
    return Submesh(tuple(origin), tuple(shape), hosts)


def pack_score(sub, free, grid_shape):
    """Wall/occupied adjacency of a candidate sub-grid: the number of
    face-neighbor cells that are outside the grid or occupied (in-grid
    but not free). Maximizing it packs gangs against slice walls and
    each other — the anti-fragmentation placement policy: free space
    stays contiguous instead of being split by mid-grid placements."""
    in_sub = set(sub.hosts)
    score = 0
    for host in sub.hosts:
        for d in range(len(grid_shape)):
            for delta in (-1, 1):
                nb = list(host)
                nb[d] += delta
                nb = tuple(nb)
                if not 0 <= nb[d] < grid_shape[d]:
                    score += 1
                elif nb not in in_sub and nb not in free:
                    score += 1
    return score


def find_submesh(grid_shape, free_hosts, n_hosts, pack=False):
    """Most compact contiguous sub-grid of n free hosts; None if none fits.

    free_hosts: iterable of coordinate tuples currently available.

    ``pack=True`` keeps the shape preference (most compact first) but,
    within the first shape that fits anywhere, picks the position with
    the highest :func:`pack_score` (earliest position on ties) instead
    of the first fit — the defragmentation-friendly placement mode
    (docs/scheduler-scale.md). First-fit and pack are both fully
    deterministic; they just optimize different things.
    """
    free = set(free_hosts)
    if n_hosts <= 0 or len(free) < n_hosts:
        return None
    if pack:
        return _find_submesh_pack(
            grid_shape, free, n_hosts, fits=None
        )
    return find_submesh_matching(
        grid_shape, free, n_hosts, fits=lambda i, h: True
    )


def _find_submesh_pack(grid_shape, free, n_hosts, fits=None):
    for shape in _submesh_shapes(grid_shape, n_hosts):
        best, best_score = None, -1
        origin_ranges = [
            range(g - s + 1) for g, s in zip(grid_shape, shape)
        ]
        for origin in itertools.product(*origin_ranges):
            sub = _submesh_at(origin, shape)
            if not all(h in free for h in sub.hosts):
                continue
            if fits is not None and not all(
                fits(i, h) for i, h in enumerate(sub.hosts)
            ):
                continue
            score = pack_score(sub, free, grid_shape)
            if score > best_score:
                best, best_score = sub, score
        if best is not None:
            return best
    return None


def find_submesh_matching(grid_shape, free_hosts, n_hosts, fits, pack=False):
    """Most compact contiguous sub-grid whose i-th host (row-major, i.e.
    gang-rank order) satisfies ``fits(i, coords)``; None if none does.

    The heterogeneous-gang variant of ``find_submesh``: rank i is pinned to
    the i-th host of the sub-grid, so per-rank resource requests must be
    checked positionally, not just for membership in the free set.
    ``pack`` selects the anti-fragmentation position policy exactly as in
    :func:`find_submesh`.
    """
    free = set(free_hosts)
    if n_hosts <= 0 or len(free) < n_hosts:
        return None
    if pack:
        return _find_submesh_pack(grid_shape, free, n_hosts, fits=fits)
    for sub in enumerate_submeshes(grid_shape, n_hosts):
        if all(h in free for h in sub.hosts) and all(
            fits(i, h) for i, h in enumerate(sub.hosts)
        ):
            return sub
    return None
