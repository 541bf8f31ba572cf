# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Workload checkpoint/resume, the PyTorch port of
``container_engine_accelerators_tpu/utils/checkpointing.py``.

JAX's contract on a torch-native format. Layout: ``<dir>/step_<N>/``
holding ``state.pt``, one ``torch.save`` of the train state with every
module and optimizer replaced by its ``state_dict`` (ResNet's running
statistics are module buffers, so they ride along). A state is a tuple,
list or dict of modules, optimizers, tensors and plain values, e.g. the
``(model, optimizer)`` of the port's ``make_train_step``s. Restore loads
into the live state it is given (``load_state_dict`` in place; tensors
come back on the given one's device and dtype) and returns it. The port
does not read the JAX package's orbax checkpoints, nor they its. In a
world of processes rank 0 restores and :func:`broadcast` hands its step
and state to the others.

A save is written into a temporary sibling ``step_<N>.tmp-<pid>-<ns>``
(fsynced), then renamed to ``step_<N>``: the counterpart of orbax's
temporary sibling, and an in-flight (or crashed) save's sibling masks
``step_<N>`` in ``list_steps``.

Crash safety (the JAX package's contract):

  * :func:`restore_latest` walks ``list_steps`` newest-to-oldest; an
    unreadable step is **quarantined** (renamed ``step_N.corrupt``) with
    a ``checkpoint_fallback`` event + ``tpu_checkpoint_fallbacks_total``
    bump, and the walk falls back to the prior step.
  * :func:`save` prunes only after the new step is *visible* in
    ``list_steps``, never prunes a step another thread is mid-restore
    from, and logs (instead of swallowing) ``rmtree`` failures.
  * ``keep_last=0`` disables pruning entirely (keep every step).
"""

import logging
import os
import re
import shutil
import threading
import time

import torch

from container_engine_accelerators_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger("checkpointing")

_STEP_RE = re.compile(r"^step_(\d+)$")
KEEP_LAST = 3
STATE_FILE = "state.pt"
# step_<N> + TMP_MARK + <pid>-<ns>: a save in flight.
TMP_MARK = ".tmp-"

FALLBACK_COUNTER = "tpu_checkpoint_fallbacks_total"

# Steps currently being restored ({(abs ckpt_dir, step)}): save()'s
# prune must never delete a checkpoint out from under a reader (a
# supervisor restart restoring step N while the zombie attempt's last
# save is still pruning).
_protect_lock = threading.Lock()
_RESTORING = set()


def _step_dir(ckpt_dir, step):
    return os.path.join(ckpt_dir, f"step_{step}")


def list_steps(ckpt_dir):
    """Sorted step numbers with a complete checkpoint present
    (quarantined ``step_N.corrupt`` dirs never match, and a step with a
    temporary sibling is a save in flight)."""
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    in_flight = {n.split(TMP_MARK)[0] for n in names if TMP_MARK in n}
    steps = []
    for name in names:
        m = _STEP_RE.match(name)
        if m and name not in in_flight:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir):
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _snapshot(state):
    """The state with each module and optimizer as its state_dict."""
    if hasattr(state, "state_dict"):
        return state.state_dict()
    if isinstance(state, dict):
        return {k: _snapshot(v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return [_snapshot(v) for v in state]
    return state


def _apply(like, saved):
    """``saved`` loaded into the live ``like``: in place for modules and
    optimizers, to ``like``'s device and dtype for tensors."""
    if hasattr(like, "load_state_dict"):
        like.load_state_dict(saved)
        return like
    if isinstance(like, dict):
        if set(like) != set(saved):
            raise ValueError(f"checkpoint keys {sorted(saved)} differ from "
                             f"the state's {sorted(like)}")
        return {k: _apply(v, saved[k]) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        if len(like) != len(saved):
            raise ValueError(f"checkpoint holds {len(saved)} items, the "
                             f"state {len(like)}")
        return type(like)(_apply(a, b) for a, b in zip(like, saved))
    if torch.is_tensor(like):
        if tuple(saved.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint tensor {tuple(saved.shape)}, "
                             f"state {tuple(like.shape)}")
        return saved.to(device=like.device, dtype=like.dtype)
    return saved


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir, step, state, keep_last=KEEP_LAST):
    """Write ``state`` at ``step`` (a temporary sibling, fsynced, then
    renamed into place; an existing ``step_<N>`` is replaced) and prune
    old steps.

    Prune safety: nothing is deleted unless the step just saved is
    visible in ``list_steps`` (a save that silently failed to land must
    not cost the history that still works); steps mid-restore elsewhere
    in the process are skipped; ``keep_last=0`` keeps everything."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _step_dir(ckpt_dir, step)
    tmp = f"{path}{TMP_MARK}{os.getpid()}-{time.time_ns()}"
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        torch.save(_snapshot(state), f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        _rmtree(path)
    os.rename(tmp, path)
    _fsync_dir(ckpt_dir)
    if keep_last:
        visible = list_steps(ckpt_dir)
        if step not in visible:
            log.error(
                "checkpoint step %d not visible in %s after save; "
                "skipping prune (nothing deleted)", step, ckpt_dir,
            )
        else:
            with _protect_lock:
                protected = {
                    s for d, s in _RESTORING
                    if d == os.path.abspath(ckpt_dir)
                }
            for old in visible[:-keep_last]:
                if old == step or old in protected:
                    continue
                _rmtree(_step_dir(ckpt_dir, old))
    log.info("checkpoint saved: %s", path)


def restore(ckpt_dir, step, like):
    """Restore step ``step`` into the live state ``like`` (see the module
    docstring) and return it. The step is protected from concurrent
    pruning for the duration. The file is read whole, with
    ``weights_only`` unpickling, before anything is loaded, so a corrupt
    file leaves ``like`` as it was."""
    key = (os.path.abspath(ckpt_dir), step)
    with _protect_lock:
        _RESTORING.add(key)
    try:
        saved = torch.load(
            os.path.join(_step_dir(ckpt_dir, step), STATE_FILE),
            map_location="cpu", weights_only=True,
        )
        return _apply(like, saved)
    finally:
        with _protect_lock:
            _RESTORING.discard(key)


class _Slot(int):
    """A tensor's place in a broadcast state's skeleton."""


def broadcast(state, step, device, group=None):
    """Rank 0's resume to every rank of the initialized world (of
    ``group``: its first rank's): that rank passes the step it restored
    (or None) and its live ``state``; every rank returns (state, step)
    with its values loaded into its own live ``state``, whatever its own
    checkpoint directory holds (each host may mount one of its own).
    Tensors travel on ``device`` (the backend's: a card under NCCL) and
    land where the live state keeps them. Without a world (group) of
    more than one: (state, step) as given."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return state, step
    src = 0 if group is None else dist.get_global_rank(group, 0)
    leader = dist.get_rank() == src
    tensors, metas = [], []

    def strip(x):
        if torch.is_tensor(x):
            tensors.append(x)
            metas.append((tuple(x.shape), x.dtype, x.device.type == "cpu"))
            return _Slot(len(tensors) - 1)
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(strip(v) for v in x)
        return x

    head = [step, None, None]
    if leader and step is not None:
        head[1:] = strip(_snapshot(state)), metas
    dist.broadcast_object_list(head, src=src, group=group, device=device)
    step, skeleton, metas = head
    if step is None:
        return state, None
    received = []
    for i, (shape, dtype, on_cpu) in enumerate(metas):
        buf = (tensors[i].to(device) if leader
               else torch.empty(shape, dtype=dtype, device=device))
        dist.broadcast(buf, src=src, group=group)
        received.append(buf.cpu() if on_cpu else buf)
    if leader:
        return state, step

    def fill(x):
        if isinstance(x, _Slot):
            return received[x]
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(fill(v) for v in x)
        return x

    return _apply(state, fill(skeleton)), step


def quarantine(ckpt_dir, step):
    """Move an unreadable step dir aside (``step_N.corrupt``) so the
    next ``list_steps`` walk skips it; returns the quarantine path (""
    when even the rename failed — the walk still skips it next time
    because restore keeps failing, but the operator should look)."""
    src = _step_dir(ckpt_dir, step)
    dst = src + ".corrupt"
    # A repeat corruption of the same step number must not block the
    # rename: suffix a counter instead of clobbering forensic state.
    n = 1
    while os.path.exists(dst):
        dst = f"{src}.corrupt.{n}"
        n += 1
    try:
        os.rename(src, dst)
    except OSError as err:
        log.error("could not quarantine %s: %s", src, err)
        return ""
    return dst


def _fallback_counter(events):
    registry = getattr(events, "registry", None) if events is not None \
        else None
    return obs_metrics.get_or_create(
        obs_metrics.Counter, FALLBACK_COUNTER,
        "Unreadable checkpoint steps quarantined during restore "
        "(resume fell back to the prior step)",
        registry=registry if registry is not None else obs_metrics.REGISTRY,
    )


def restore_latest(ckpt_dir, like, events=None, max_fallbacks=1):
    """Crash-safe resume: restore the newest readable step.

    Walks ``list_steps`` newest-to-oldest; an unreadable step dir is
    quarantined (renamed ``step_N.corrupt``) with a
    ``checkpoint_fallback`` event + counter instead of crash-looping
    the caller, and the walk continues with the prior step. Returns
    ``(state, step)``; ``(None, None)`` when no readable checkpoint
    exists.

    ``max_fallbacks`` bounds the quarantine walk: a crash mid-save
    corrupts at most the NEWEST step, so after that many quarantines a
    further failure is systematic — a changed model config, a storage
    outage — and quarantining the whole history would silently retrain
    from scratch. The walk re-raises that restore error instead, leaving
    the remaining steps untouched on disk."""
    fallbacks = 0
    for step in reversed(list_steps(ckpt_dir)):
        t0 = time.monotonic()
        try:
            return restore(ckpt_dir, step, like), step
        except Exception as err:  # noqa: BLE001 - fall back, don't loop
            if fallbacks >= max_fallbacks:
                log.error(
                    "checkpoint step %d also unreadable after %d "
                    "quarantine(s) — systematic restore failure (config "
                    "mismatch? storage outage?), refusing to quarantine "
                    "the remaining history: %s", step, fallbacks, err,
                )
                raise
            fallbacks += 1
            dur = time.monotonic() - t0
            moved = quarantine(ckpt_dir, step)
            _fallback_counter(events).inc()
            if events is not None:
                events.emit(
                    "checkpoint_fallback", severity="error", step=step,
                    error=str(err), quarantined=moved,
                    dur_s=round(dur, 6),
                )
            log.error(
                "checkpoint step %d unreadable (%s); quarantined to %s,"
                " falling back to the prior step", step, err,
                moved or "<rename failed>",
            )
    return None, None


def _rmtree(path):
    """Prune one step dir; failures are LOGGED, never swallowed
    silently — a half-deleted ``step_<N>`` dir that still matches
    ``list_steps`` would be restored from and fail. Returns True on a
    clean removal."""
    errors = []

    def _onerror(_fn, p, exc_info):
        errors.append((p, exc_info[1]))

    shutil.rmtree(path, onerror=_onerror)
    if errors:
        p, err = errors[0]
        log.warning(
            "checkpoint prune of %s left partial state (%d failure(s); "
            "first: %s: %s) — the dir may now be unreadable and will "
            "be quarantined if restore ever reaches it", path,
            len(errors), p, err,
        )
        return False
    return True
