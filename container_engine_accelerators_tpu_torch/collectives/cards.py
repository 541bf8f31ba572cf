# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Nominal peaks of the cards the port knows, by the name CUDA gives them.

The counterpart of the JAX package's ``topology/slice.GENERATIONS`` with
only what the qualification rows divide by. ``device_bench``'s
``detect_generation`` maps a device to its entry; an unknown card has a
peak of 0, as an unknown TPU generation has there.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class Card:
    name: str            # torch.cuda.get_device_name()
    bf16_tflops: float   # dense tensor-core rate
    int8_tops: float     # dense tensor-core rate
    hbm_gbps: float      # device memory, GB/s (10^9 bytes)
    hbm_gib: float
    # The busbw ceiling of the collective sweep (the counterpart of the
    # TPU generations' ``ici_bisection_gbps_per_chip``): GB/s a card
    # moves over its GPU-to-GPU links in ONE direction. nccl-tests'
    # busbw counts the bytes each rank sends (equally, receives), so it
    # is held to one direction's rate, not to the sum of both.
    link_gbps: float = 0.0


# NVIDIA's H100 data sheet, SXM5 part, dense rates at its 700 W limit;
# NVLink 4: 900 GB/s in all (18 links), 450 GB/s each way. With NVLink
# SHARP (NVSwitch multicast) an all-reduce's busbw can read above the
# link's rate, since the switch does part of the reduction: the sweep
# reports that share as it is.
H100_SXM = Card("NVIDIA H100 80GB HBM3", bf16_tflops=989.0,
                int8_tops=1979.0, hbm_gbps=3350.0, hbm_gib=80.0,
                link_gbps=450.0)

CARDS = {card.name: card for card in (H100_SXM,)}
