"""Batched serving driver (the counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --requests 8 --prompt-len 1024 --new-tokens 32 --max-len 1056

Instantiates a (reduced or full) model with random fp32 parameters from
``--seed`` on ``--device`` (``cuda:0`` by default; ``--device cpu`` runs
the kernels' plain versions on the host), spins up the slot-based
:class:`BatchServer`, pushes a stream of synthetic requests through it and
reports latency/throughput — the serving-side end-to-end example.  On the
card the server prefills through one captured CUDA graph a (batch,
prompt) shape and decodes through one a batch shape; the launcher prints
each capture's time and the graph's size once.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.serve import BatchServer, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.input_mode == "embeddings":
        print("vlm serving uses the embedding frontend stub; "
              "pick a token arch")
        return 1
    device = T.default_device(args.device)
    params = T.init_params(cfg, device=device, dtype=torch.float32,
                           seed=args.seed)
    print(f"serving {cfg.name}: {cfg.param_count/1e6:.1f}M params, "
          f"{args.slots} slots")

    server = BatchServer(params, cfg, n_slots=args.slots,
                         max_len=args.max_len, device=device)
    rng = np.random.default_rng(args.seed)
    t0 = time.monotonic()
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size,
                              size=args.prompt_len).astype(np.int32)
        server.submit(Request(request_id=f"req-{i}", prompt=prompt,
                              max_new_tokens=args.new_tokens))
    done = server.run(max_requests=args.requests, idle_timeout_s=1.0)
    wall = time.monotonic() - t0

    lat_first = [r.t_first_token - r.t_submit for r in done
                 if r.t_first_token]
    lat_total = [r.t_done - r.t_submit for r in done if r.t_done]
    n_tok = sum(len(r.result_tokens) for r in done)
    print(f"completed {len(done)}/{args.requests} requests, "
          f"{n_tok} tokens in {wall:.2f}s "
          f"({n_tok / max(wall, 1e-9):,.1f} tok/s)")
    if lat_first:
        print(f"first-token latency: mean {np.mean(lat_first)*1e3:.1f} ms, "
              f"p95 {np.percentile(lat_first, 95)*1e3:.1f} ms")
        print(f"request latency:     mean {np.mean(lat_total)*1e3:.1f} ms, "
              f"p95 {np.percentile(lat_total, 95)*1e3:.1f} ms")
    for name, fn in (("prefill", server.prefill_fn),
                     ("decode", server.decode_fn)):
        for g in fn.graphs.values():
            print(f"{name} graph: captured in {g.capture_s * 1e3:.1f} ms, "
                  f"{g.nodes} nodes ({g.kernels} kernels)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
