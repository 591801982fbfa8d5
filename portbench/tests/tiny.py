"""Tiny forms of the benchmark's cells for the CPU tests: the port's
``reduced()`` configuration of the cell's model and a traffic of the same
kind at a size the host runs in seconds."""
from __future__ import annotations

import dataclasses

from portbench import harness

TRAFFIC = {
    "backlog": {"queued": 4, "prompt_len": {"32": 1.0}, "new_tokens": 6,
                "server": {"n_slots": 2, "max_len": 48}},
    "train_steps": {"batch": 2, "seq": 32},
}


def config_of(arch) -> dict:
    """The configuration dict of a port ``ArchConfig``."""
    cfg = {"name": arch.name, "port_arch": arch.name,
           "n_layers": arch.n_layers, "d_model": arch.d_model,
           "n_heads": arch.n_heads, "n_kv_heads": arch.n_kv_heads,
           "d_head": arch.head_dim, "d_ff": arch.d_ff,
           "ffn_kind": arch.ffn_kind, "vocab_size": arch.vocab_size,
           "padded_vocab_size": arch.padded_vocab_size,
           "block": arch.attn_kind, "rope_theta": arch.rope_theta,
           "norm_eps": arch.norm_eps, "sliding_window": arch.sliding_window,
           "tie_embeddings": arch.tie_embeddings}
    if arch.ssm is not None:
        cfg["ssm"] = dataclasses.asdict(arch.ssm)
    return cfg


def cell(name: str, bench_dir=harness.BENCH):
    """(cell, port arch) of ``name`` cut to the tiny size; the tiny
    configuration keeps the full one's ``impl`` and ``reference``."""
    from repro_torch.configs import get_arch
    full = harness.load_cell(name, bench_dir)
    arch = get_arch(full.config["port_arch"]).reduced()
    cfg = dict(config_of(arch), impl=full.config["impl"],
               reference=full.config["reference"])
    traffic = dict(full.traffic, **TRAFFIC[full.traffic["kind"]])
    return dataclasses.replace(full, config=cfg, traffic=traffic), arch
