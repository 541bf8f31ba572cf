# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""Transformer serving daemon, PyTorch port (dense KV cache).

Port of the dense path of ``container_engine_accelerators_tpu/models/
serve_cli.py``: one request at a time through ``transformer.generate``
(bucketed batched prefill through the flash kernel, then decode steps).

Endpoints (the same JSON as the JAX server):
  GET  /healthz    200 once the warmup decode succeeded, 503 before,
                   500 if it failed
  POST /generate   {"tokens": [[...]], "max_new_tokens": N,
                    "temperature": 0.0, "top_k": 0, "top_p": 1.0,
                    "seed": 0}   (temperature 0 = greedy)
                   → {"tokens": [[...]], "latency_s": ...,
                      "sampler": {"temperature", "top_k", "top_p"}}

Sampler params snap to the JAX server's whitelist grids
(sanitize_sampler). Sampled requests draw from a ``torch.Generator``
seeded with the request's ``seed``: reproducible here, but not the
tokens the JAX server samples for the same seed.

Not ported yet (ROADMAP.md): continuous batching, the paged KV cache,
speculation, tensor parallelism, int8 weights, tenant classes, fault
plans and the obs surfaces (/metrics, traces, event logs).

  python -m container_engine_accelerators_tpu_torch.models.serve_cli \\
      --preset llama3-8b --port 8000
"""

import argparse
import json
import logging
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from container_engine_accelerators_tpu_torch.models import transformer as tf

log = logging.getLogger("serve_cli")


# Sampler whitelists, copied from the JAX server so both snap client
# values to the same grids (values float32-exact).
def _f32_exact(values):
    return tuple(float(np.float32(v)) for v in values)


TEMPERATURE_BUCKETS = _f32_exact((0.0, 0.3, 0.5, 0.7, 1.0, 1.3, 1.7, 2.0))
TOP_P_BUCKETS = _f32_exact((0.8, 0.9, 0.95, 1.0))
TOP_K_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64)


def _snap(value, buckets):
    return min(buckets, key=lambda b: abs(b - value))


def sanitize_sampler(temperature, top_k, top_p, vocab_size):
    """Snap client sampler params to the whitelist grids; greedy
    (temperature 0) canonicalizes top_k/top_p."""
    temperature = _snap(float(temperature), TEMPERATURE_BUCKETS)
    if temperature == 0.0:
        return 0.0, 0, 1.0
    top_p = _snap(float(top_p), TOP_P_BUCKETS)
    k_buckets = tuple(b for b in TOP_K_BUCKETS if b <= vocab_size) or (0,)
    top_k = int(_snap(max(int(top_k), 0), k_buckets))
    return temperature, top_k, top_p


class Model:
    """The served model. Random weights from ``seed`` on ``device``
    (CUDA unless the caller asks for the CPU), or the given ``weights``
    (a ``transformer.Transformer``, e.g. bridged from JAX)."""

    def __init__(self, cfg, seed=0, device="cuda", weights=None):
        self.cfg = cfg
        if weights is None:
            weights = tf.init_params(cfg, device=device, seed=seed)
        self.model = weights
        self.device = weights.device
        self.lock = threading.Lock()

    def generate(self, tokens, max_new_tokens, temperature=0.0, top_k=0,
                 top_p=1.0, seed=0):
        temperature, top_k, top_p = sanitize_sampler(
            temperature, top_k, top_p, self.cfg.vocab_size
        )
        prompt = torch.as_tensor(tokens, dtype=torch.long,
                                 device=self.device)
        generator = None
        if temperature:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        with self.lock:
            out = tf.generate(
                self.model, prompt, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                generator=generator,
            )
        return out.tolist()


def make_handler(model, state):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            log.debug(fmt, *args)

        def _send(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self._send({"error": "not found"}, 404)
            elif state["ready"]:
                self._send({"status": "ok"})
            elif state.get("error"):
                self._send({"status": "failed", "error": state["error"]},
                           500)
            else:
                self._send({"status": "warming up"}, 503)

        def do_POST(self):
            if self.path != "/generate":
                self._send({"error": "not found"}, 404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                tokens = req.get("tokens") or [[1, 2, 3]]
                max_new = int(req.get("max_new_tokens", 16))
                eff_t, eff_k, eff_p = sanitize_sampler(
                    float(req.get("temperature", 0.0)),
                    int(req.get("top_k", 0)),
                    float(req.get("top_p", 1.0)),
                    model.cfg.vocab_size,
                )
                t0 = time.perf_counter()
                out = model.generate(
                    tokens, max_new, temperature=eff_t, top_k=eff_k,
                    top_p=eff_p, seed=int(req.get("seed", 0)),
                )
                dt = time.perf_counter() - t0
                self._send({
                    "tokens": out,
                    "latency_s": round(dt, 4),
                    "sampler": {
                        "temperature": round(eff_t, 6),
                        "top_k": eff_k,
                        "top_p": round(eff_p, 6),
                    },
                })
            except Exception as e:  # noqa: BLE001 - serve errors as JSON
                log.exception("generate failed")
                self._send({"error": str(e)}, 500)

    return Handler


def warmup(model, state):
    """One short decode end to end (builds the CUDA kernel on first use),
    then flip ready."""
    try:
        t0 = time.perf_counter()
        model.generate([[1, 2, 3, 4]], 4)
        dt = time.perf_counter() - t0
        state["ready"] = True
        log.info("warmup decode done in %.1fs; serving ready", dt)
    except Exception as e:  # noqa: BLE001 - must surface, thread dies silent
        log.exception("warmup failed")
        state["error"] = str(e)


def start_server(model, port=8000, host="0.0.0.0"):
    """Serve ``model`` on (host, port) from a daemon thread and warm it up
    in another. Returns (server, state); ``state["ready"]`` flips once the
    warmup decode succeeded. ``port=0`` picks a free port
    (``server.server_address[1]``)."""
    state = {"ready": False}
    server = ThreadingHTTPServer((host, port), make_handler(model, state))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    threading.Thread(target=warmup, args=(model, state), daemon=True).start()
    return server, state


def post_generate(port, tokens, max_new_tokens, timeout=600, **sampler):
    """POST /generate to a local server; returns the decoded response."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"tokens": tokens, "max_new_tokens": max_new_tokens,
                         **sampler}).encode(),
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def wait_ready(state, timeout):
    """Block until warmup finished; raises if it failed or timed out."""
    deadline = time.monotonic() + timeout
    while not state["ready"]:
        if state.get("error"):
            raise RuntimeError(f"warmup failed: {state['error']}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"warmup did not finish in {timeout}s")
        time.sleep(0.05)


def config_from_args(args):
    if args.preset == "llama3-8b":
        return tf.TransformerConfig.llama3_8b()
    return tf.TransformerConfig(
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        n_layers=args.n_layers,
        n_heads=args.n_heads,
        n_kv_heads=max(args.n_heads // 2, 1),
        d_ff=args.d_model * 3,
        max_seq_len=args.seq_len,
        dtype=args.dtype,
    )


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--vocab-size", type=int, default=1024)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--preset", choices=["llama3-8b"], default=None,
                   help="named model config (overrides the shape flags)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain attention "
                        "(tests). Without a GPU the default fails.")
    p.add_argument("--once", action="store_true",
                   help="warm up, serve one request to self, exit (tests)")
    args = p.parse_args(argv)
    model = Model(config_from_args(args), device=args.device)
    server, state = start_server(model, port=args.port)
    log.info("listening on :%d", server.server_address[1])
    try:
        if args.once:
            try:
                wait_ready(state, timeout=3600)
            except (RuntimeError, TimeoutError) as e:
                log.error("%s", e)
                return 1
            print(json.dumps(
                post_generate(server.server_address[1], [[5, 6]], 2)
            ))
            return 0
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        return 0
    finally:
        server.shutdown()


if __name__ == "__main__":
    sys.exit(main())
