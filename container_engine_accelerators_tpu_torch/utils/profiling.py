# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Trace capture for ``--profile-dir``, the port of the JAX package's
``utils/profiling.py``.

``trace_or_null(profile_dir)`` brackets a region with
``torch.profiler.profile`` (CPU activities, and CUDA ones when a card is
present) and writes one Chrome trace into ``profile_dir`` when the
region ends, however it ends; with no directory it is a null context.
The trace names every kernel the region launched (the hand-written
ones as ``flash_fwd_sm90_kernel``, ``int8_mm_sm90_kernel``, ...). A
caller that also writes a span trace (``--trace-out``) brackets the
same region with both: the span trace's metadata carries its
wall-clock epoch, and the profiler's events carry wall-clock
timestamps, so the two timelines line up afterwards.
"""

import contextlib
import os
import time

TRACE_SUFFIX = ".pt.trace.json"


def trace_or_null(profile_dir):
    """A ``torch.profiler`` trace of the region into ``profile_dir``, or
    a null context when ``profile_dir`` is falsy."""
    if not profile_dir:
        return contextlib.nullcontext()
    return _trace(profile_dir)


@contextlib.contextmanager
def _trace(profile_dir):
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(
            profile_dir, f"{os.getpid()}.{time.time_ns()}{TRACE_SUFFIX}"))
