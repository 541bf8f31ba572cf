# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Serving workload of the port: the Llama-style transformer, its weight
bridge from the JAX package's parameter pytree, its decode as CUDA graphs,
and the HTTP daemon."""
