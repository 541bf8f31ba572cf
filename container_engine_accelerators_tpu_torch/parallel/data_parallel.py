# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Data-parallel training over a DeviceMesh: the port's counterpart of
the JAX train steps' dp-sharded batch.

In JAX a train step takes the GLOBAL batch, sharded over the mesh's
"dp" axis, and XLA reduces the gradients; parameters and optimizer state
are replicated (or fsdp-sharded, the same numbers). Here every rank
builds the same global batch and :func:`train_step` runs one step on
this rank's part of it: the loss function scales its local loss so that
the ranks' losses sum to the global loss, ``backward()`` runs, the
gradients are summed over the mesh's data axes (dp, then sp: the axes
that split the batch's tokens) once, in one flat f32 buffer a group, and
the optimizer steps on every rank alike. A model whose batch shards over
dp alone (mnist, resnet and BERT, whose JAX batches shard over dp only)
holds replicas along sp, so its steps sum over :data:`BATCH_AXES`, dp
alone. A tp or ep axis replicates the batch, so its ranks are not summed
here: a model whose ranks along it
are replicas (mnist, resnet under ``--tp``) holds the whole gradient on
each already, and the tensor- and expert-parallel models reduce what
their tp ranks hold parts of themselves
(``parallel/tensor_parallel.reduce_grads``). Nothing reduces inside the
backward (no ``DistributedDataParallel`` bucket hooks), so collectives
never interleave with the ring attention's transfers, which every rank
must issue in the same order.
"""

import torch
import torch.distributed as dist


def axis(mesh, name):
    """(this rank's index, size) along ``name`` of ``mesh``; (0, 1) for
    no mesh or an axis the mesh lacks."""
    names = () if mesh is None else (mesh.mesh_dim_names or ())
    if name not in names:
        return 0, 1
    return mesh.get_local_rank(name), mesh.shape[names.index(name)]


def shard_rows(x, mesh, name="dp"):
    """This rank's rows (dim 0) of a global batch array, split evenly
    over the ``name`` axis."""
    index, size = axis(mesh, name)
    if size == 1:
        return x
    rows = x.shape[0]
    if rows % size:
        raise ValueError(
            f"global batch of {rows} rows does not divide over {name}={size}")
    per = rows // size
    return x[index * per:(index + 1) * per]


def shard_batch(batch, mesh, device):
    """This rank's rows of every array of a global batch dict, as tensors
    on ``device``."""
    return {k: shard_rows(torch.as_tensor(v, device=device), mesh)
            for k, v in batch.items() if v is not None}


def mean_loss_share(loss_fn, model, batch, mesh):
    """This rank's share of a global batch's mean loss: ``loss_fn`` over
    its rows scaled by its rows over the global rows, so the ranks'
    shares sum to the global mean. No mesh: ``loss_fn(model, batch)``."""
    if mesh is None:
        return loss_fn(model, batch)
    local = shard_batch(batch, mesh, model.device)
    rows = len(next(iter(local.values())))
    return loss_fn(model, local) * (rows / len(next(iter(batch.values()))))


# The mesh axes that split a global batch's tokens, in reduction order:
# the transformer's (its sequences split over sp), and a model's whose
# batch splits over dp alone (its sp ranks are replicas).
DATA_AXES = ("dp", "sp")
BATCH_AXES = ("dp",)


def data_groups(mesh, axes=DATA_AXES):
    """The process groups of ``mesh``'s data axes ``axes`` above size 1
    (none for no mesh): a sum over each in turn is the sum over every
    rank that holds other tokens of the batch."""
    return [mesh.get_group(name) for name in axes
            if axis(mesh, name)[1] > 1]


def sync_grads(params, group=None):
    """Sum every parameter's gradient over ``group`` (default the world)
    in one flat f32 buffer (a parameter without one contributes zeros and
    gets the sum), then write the sums back in each gradient's dtype."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    flat = torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p))
        .reshape(-1).float() for p in params
    ])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in params:
        n = p.numel()
        total = flat[offset:offset + n].view_as(p).to(p.dtype)
        if p.grad is None:
            p.grad = total
        else:
            p.grad.copy_(total)
        offset += n


def train_step(model, opt, local_loss, mesh, axes=DATA_AXES):
    """One optimizer step → the detached loss. ``local_loss()`` returns
    this rank's share of the global loss (the shares sum to it). Under a
    mesh the gradients and the loss are summed over its data axes
    ``axes`` after ``backward()`` (:func:`data_groups`); without one this
    is the single-device step."""
    opt.zero_grad(set_to_none=True)
    loss = local_loss()
    loss.backward()
    loss = loss.detach()
    if mesh is not None:
        for group in data_groups(mesh, axes):
            sync_grads(model.parameters(), group=group)
        loss = sum_loss(loss, mesh, axes)
    opt.step()
    return loss


def sum_loss(loss, mesh, axes=DATA_AXES):
    """A rank's share of the global loss summed over the mesh's data
    axes ``axes``: the global loss, f32, on every rank."""
    loss = loss.detach().float()
    for group in data_groups(mesh, axes):
        dist.all_reduce(loss, group=group)
    return loss
