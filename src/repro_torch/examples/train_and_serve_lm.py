"""End-to-end LM program on the port, as ``examples/train_and_serve_lm.py``
runs it on the reference package: train a transformer with the full
substrate stack (data pipeline → train step → checkpointing), then serve
it with batched requests — the LM-substrate counterpart of the paper's
edge-to-cloud flow, with the ParameterService carrying weights from the
trainer to the server as the paper's Redis parameter server carries
model updates.

On the card the server's default ``impl="kernel"`` sends internlm2's GQA
attention through the flash-attention kernel.  Defaults are small; pass
``--params 100`` for the ~100M-parameter variant (12 layers × 768).

    PYTHONPATH=src python -m repro_torch.examples.train_and_serve_lm \\
        [--params 100] [--steps 300] [--device cpu]

Everything runs on ``device``, which defaults to the CUDA card and raises
without one.  :func:`main` prints the reference script's report and
returns it as a dict.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core import ParameterService
from repro_torch.launch.train import train_loop
from repro_torch.models import transformer as T
from repro_torch.serve import BatchServer, Request
from repro_torch.train import step as TS


def sized_config(target_m: float):
    """internlm2-family config scaled to ~target_m million params."""
    base = get_arch("internlm2-1.8b")
    if target_m >= 100:
        # ~103M backbone: 12L x 768, vocab 8k
        return dataclasses.replace(
            base, name=f"internlm2-{target_m:.0f}m", n_layers=12,
            d_model=768, n_heads=12, n_kv_heads=4, d_head=64, d_ff=2048,
            vocab_size=8192, remat=False)
    return dataclasses.replace(
        base, name="internlm2-mini", n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=2, d_head=64, d_ff=512, vocab_size=2048, remat=False)


def main(device=None, params_m: float = 10, steps: int = 60, batch: int = 8,
         seq: int = 128, requests: int = 8, new_tokens: int = 16) -> dict:
    device = T.default_device(device)
    cfg = sized_config(params_m)
    print(f"config {cfg.name}: {cfg.param_count/1e6:.1f}M params")

    tc = TS.TrainConfig(lr=1e-3, warmup=max(10, steps // 10),
                        total_steps=steps)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        params, state, history = train_loop(
            cfg, tc, steps=steps, batch=batch, seq_len=seq,
            ckpt_dir=ckpt_dir, ckpt_every=max(20, steps // 3),
            device=device)
    print(f"train: loss {history[0]['loss']:.3f} -> "
          f"{history[-1]['loss']:.3f}")
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError("loss must fall")

    # --- hand the weights to the server via the parameter service ---
    ps = ParameterService()
    ps.publish("lm", params)
    version, served_params = ps.place("lm", device)
    print(f"published weights v{version} to the parameter service")

    server = BatchServer(served_params, cfg, n_slots=4, max_len=256,
                         device=device)
    rng = np.random.default_rng(0)
    for i in range(requests):
        server.submit(Request(
            request_id=f"r{i}",
            prompt=rng.integers(1, cfg.vocab_size, 32).astype(np.int32),
            max_new_tokens=new_tokens))
    done = server.run(max_requests=requests, idle_timeout_s=1.0)
    n_tok = sum(len(r.result_tokens) for r in done)
    print(f"served {len(done)} requests, {n_tok} tokens "
          f"({server.metrics['decoded_tokens']} batched decode tokens)")
    return {"config": cfg.name, "param_count": cfg.param_count,
            "history": history, "version": version,
            "served": len(done), "tokens": n_tok,
            "decoded_tokens": server.metrics["decoded_tokens"],
            "results": {r.request_id: list(r.result_tokens) for r in done},
            "waves": server.waves}


def _cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--params", type=float, default=10,
                    help="target size in millions (100 => ~100M)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    main(device=args.device, params_m=args.params, steps=args.steps,
         batch=args.batch, seq=args.seq, requests=args.requests)


if __name__ == "__main__":
    _cli()
