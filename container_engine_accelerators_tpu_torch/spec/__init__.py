# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Speculative decoding under the byte-exact contract, PyTorch port.

Port of ``container_engine_accelerators_tpu/spec``. A *proposer* guesses
the next k tokens of a row; one ``transformer.paged_verify_batch`` call
scores every speculating row's guesses at once, and the longest
greedily-matching prefix is accepted, so every emitted token is the one
the plain decode would have produced (Leviathan et al., "Fast Inference
from Transformers via Speculative Decoding", 2023).

  * :class:`NgramProposer`: host-side suffix matching over the request's
    own prompt and generation (no device memory);
  * :class:`DraftProposer`: a small derived transformer
    (:func:`draft_config`) on its own paged slots, through the same paged
    programs and CUDA graphs as the engine;
  * :class:`AdaptiveK`: backs a row off to the fused decode chunk when
    acceptance is poor.

The engine's propose/verify state machine lives in
``models/serve_cli.py`` (``ContinuousEngine._spec_tick``).
"""

from container_engine_accelerators_tpu_torch.spec.draft import (
    DraftProposer,
    draft_config,
)
from container_engine_accelerators_tpu_torch.spec.proposer import (
    AdaptiveK,
    NgramProposer,
    Proposer,
)

__all__ = [
    "AdaptiveK",
    "DraftProposer",
    "NgramProposer",
    "Proposer",
    "draft_config",
]
