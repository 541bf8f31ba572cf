# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Device meshes over the process group's ranks.

Port of ``container_engine_accelerators_tpu/parallel/mesh.py``.
``plan_mesh`` and ``plan_hybrid_mesh`` are JAX's arithmetic, copied:
they factor a device count over named logical axes. ``make_mesh``
realizes a plan as a ``torch.distributed.device_mesh.DeviceMesh`` over
the world (one process per device, ``parallel/bootstrap.py``), laid out
row-major with the plan's axis names as its dim names, so trailing axes
(sp, tp) vary fastest and land on neighbouring ranks.

Multislice: under the bootstrap's rank formula slice ``s`` holds ranks
``[s × per_slice, (s+1) × per_slice)``, so ``slice_groups`` groups the
ranks by slice and ``make_hybrid_mesh`` puts the DCN axes outermost:
only they span slices.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    axis_names: tuple
    axis_sizes: tuple

    @property
    def size(self):
        out = 1
        for s in self.axis_sizes:
            out *= s
        return out


def plan_mesh(n_devices, axes):
    """Factor n_devices over logical axes.

    ``axes`` is a dict {name: size} where at most one size may be -1
    (absorbs the remaining devices). Sizes must multiply to n_devices.
    """
    names = tuple(axes)
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    known = 1
    for s in sizes:
        if s != -1:
            if s <= 0:
                raise ValueError(f"axis sizes must be positive, got {sizes}")
            known *= s
    if -1 in sizes:
        if n_devices % known:
            raise ValueError(
                f"cannot factor {n_devices} devices over fixed axes {axes}"
            )
        sizes[sizes.index(-1)] = n_devices // known
    else:
        if known != n_devices:
            raise ValueError(
                f"axis sizes {axes} multiply to {known}, need {n_devices}"
            )
    return MeshPlan(names, tuple(sizes))


def make_mesh(plan, device_type="cuda"):
    """Realize a MeshPlan as a DeviceMesh over the initialized world,
    ranks row-major over ``plan.axis_sizes``. Every rank calls it (the
    mesh builds one process group per axis slice)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group "
            "(parallel/bootstrap.initialize_from_env)")
    world = dist.get_world_size()
    if world != plan.size:
        raise ValueError(
            f"mesh plan needs {plan.size} devices, have {world}"
        )
    return init_device_mesh(device_type, plan.axis_sizes,
                            mesh_dim_names=plan.axis_names)


# -- multislice (ICI × DCN hybrid) meshes --------------------------------------
#
# Only gradient-sync-style axes (dp/fsdp) cross slices; tp/sp/pp stay
# inside a slice. The DCN axes are the OUTERMOST (slowest-varying) mesh
# dims.


def slice_groups(world_size, n_slices=1):
    """The ranks of each slice, in slice order: the bootstrap's rank
    formula gives slice ``s`` the contiguous ranks ``[s × per_slice,
    (s+1) × per_slice)``."""
    if n_slices <= 0 or world_size % n_slices:
        raise ValueError(
            f"cannot chunk {world_size} ranks into {n_slices} slices"
        )
    per = world_size // n_slices
    return [list(range(s * per, (s + 1) * per)) for s in range(n_slices)]


def plan_hybrid_mesh(n_devices, n_slices, dcn_axes, ici_axes):
    """Factor a multislice job over DCN axes (across slices) and ICI axes
    (within a slice). ``dcn_axes`` sizes multiply to n_slices, ``ici_axes``
    to n_devices // n_slices; each dict may use one -1 wildcard."""
    if n_slices <= 0 or n_devices % n_slices:
        raise ValueError(
            f"{n_devices} devices do not split into {n_slices} slices"
        )
    dcn = plan_mesh(n_slices, dcn_axes)
    ici = plan_mesh(n_devices // n_slices, ici_axes)
    return MeshPlan(dcn.axis_names + ici.axis_names,
                    dcn.axis_sizes + ici.axis_sizes)


def make_hybrid_mesh(dcn_axes, ici_axes, n_slices, device_type="cuda"):
    """A DeviceMesh with the DCN axes outermost: the ranks ordered slice
    by slice (:func:`slice_groups`), so only the DCN axes span slices."""
    import torch.distributed as dist

    world = dist.get_world_size()
    slice_groups(world, n_slices)  # raises on an uneven split
    plan = plan_hybrid_mesh(world, n_slices, dcn_axes, ici_axes)
    return make_mesh(plan, device_type)
