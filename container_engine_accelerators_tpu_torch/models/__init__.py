# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Workloads of the port: the Llama-style transformer (served and
trained, also pipeline-parallel), BERT, MNIST and ResNet (trained), the
weight bridge from the JAX package's parameter trees, the decode as
CUDA graphs, the HTTP daemon, the training CLI and its supervisor."""
