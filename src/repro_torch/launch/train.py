"""End-to-end training driver (the counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --steps 200 --batch 4 --seq 1024 --ckpt-dir build/ckpt

Wires config → data pipeline → train step → checkpoint manager →
metrics, on ``--device`` (``cuda:0`` by default; ``--device cpu`` runs on
the host, ``--reduced`` gives the tiny same-family config for that).

Fault tolerance: resumes from the latest checkpoint in ``--ckpt-dir`` if
one exists and replays the data stream to that step, so a resumed run sees
the batches a straight run would.  Checkpoints are written in the
reference's layout (blocks stacked, :mod:`repro_torch.models.convert`),
so a run resumes across the two packages.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch
from torch.utils import _pytree as pytree

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import make_batch_iterator
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train import step as TS


def train_loop(cfg, tc: TS.TrainConfig, *, steps: int, batch: int,
               seq_len: int, ckpt_dir=None, ckpt_every: int = 100,
               seed: int = 0, log_every: int = 10, dtype=torch.float32,
               device=None, log=print):
    """Returns (params, state, history).  The step is
    :func:`train.step.make_train_fn` (a CUDA graph on the card, the eager
    step on the host).  The host reads the loss back only at log steps
    (``float(loss)``), as the reference does."""
    device = T.default_device(device)
    params, state = TS.init_train_state(cfg, tc, seed=seed, device=device,
                                        dtype=dtype)
    start_step = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3)
        like = {"params": params, "state": state}
        meta = pytree.tree_map(lambda t: t.to("meta"), like)
        got = mgr.restore_latest(convert.stack_blocks(meta), device=device)
        if got[0] is not None:
            start_step = got[0]
            tree = convert.unstack_blocks(got[1], like)
            params, state = tree["params"], tree["state"]
            log(f"resumed from step {start_step}")

    it = make_batch_iterator(cfg, batch, seq_len, seed=seed, device=device)
    # deterministic resume: replay the stream to the restored step so a
    # resumed run sees exactly the batches a straight run would have seen
    for _ in range(start_step):
        next(it)
    # the reference's jitted step: one CUDA graph on the card, which
    # updates params and state in place; the host draws batch i + 1
    # while the card runs step i
    step_fn = TS.make_train_fn(cfg, tc)

    def checkpoint(step):
        mgr.save(step, convert.stack_blocks(
            {"params": params, "state": state}, device="cpu"))

    history = []
    t0 = time.time()
    for i in range(start_step, steps):
        batch_data = next(it)
        params, state, metrics = step_fn(params, state, batch_data)
        if (i + 1) % log_every == 0 or i == start_step:
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            dt = time.time() - t0
            tok_s = (i + 1 - start_step) * batch * seq_len / max(dt, 1e-9)
            history.append({"step": i + 1, "loss": loss,
                            "grad_norm": gnorm, "tok_per_s": tok_s})
            log(f"step {i+1:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                f"{tok_s:,.0f} tok/s")
        if mgr and (i + 1) % ckpt_every == 0:
            checkpoint(i + 1)
    if mgr:
        checkpoint(steps)
        mgr.wait()
    return params, state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tc = TS.TrainConfig(lr=args.lr, microbatches=args.micro,
                        total_steps=args.steps,
                        warmup=max(10, args.steps // 20))
    print(f"training {cfg.name}: {cfg.param_count/1e6:.1f}M params "
          f"({cfg.active_param_count/1e6:.1f}M active), "
          f"batch={args.batch} seq={args.seq} on {args.device}")
    _, _, history = train_loop(
        cfg, tc, steps=args.steps, batch=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, seed=args.seed,
        device=args.device)
    if history:
        first, last = history[0], history[-1]
        print(f"loss {first['loss']:.4f} -> {last['loss']:.4f} over "
              f"{last['step'] - first['step']} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
