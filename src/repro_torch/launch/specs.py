"""Meta-tensor stand-ins for every model input, ported from
``repro.launch.specs``: shapes and types, no memory (``device="meta"``,
the counterpart of the reference's ``ShapeDtypeStruct``), and their
partition specs as tuples.  Modality frontends are stubs, as in the
reference: qwen2-vl gets precomputed patch embeddings + M-RoPE position
ids; musicgen gets EnCodec codebook ids.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer as T


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, shape: ShapeConfig,
                      dtype=torch.bfloat16):
    b, s = shape.global_batch, shape.seq_len
    if cfg.input_mode == "embeddings":
        return {"embeds": _meta((b, s, cfg.d_model), dtype),
                "positions": _meta((3, b, s), torch.int32),
                "labels": _meta((b, s), torch.int32)}
    if cfg.n_codebooks > 1:
        return {"tokens": _meta((b, s, cfg.n_codebooks), torch.int32),
                "labels": _meta((b, s, cfg.n_codebooks), torch.int32)}
    return {"tokens": _meta((b, s), torch.int32),
            "labels": _meta((b, s), torch.int32)}


def prefill_input_specs(cfg: ArchConfig, shape: ShapeConfig,
                        dtype=torch.bfloat16):
    spec = train_input_specs(cfg, shape, dtype)
    spec.pop("labels")
    return spec


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig,
                       dtype=torch.bfloat16):
    """serve_step inputs: one new token + a KV/SSM cache of seq_len."""
    b, s = shape.global_batch, shape.seq_len
    cache = T.init_cache(cfg, b, s, dtype, device="meta")
    if cfg.input_mode == "embeddings":
        inp = {"embeds": _meta((b, 1, cfg.d_model), dtype),
               "positions": _meta((3, b, 1), torch.int32)}
    elif cfg.n_codebooks > 1:
        inp = {"tokens": _meta((b, 1, cfg.n_codebooks), torch.int32)}
    else:
        inp = {"tokens": _meta((b, 1), torch.int32)}
    inp["length"] = _meta((), torch.int32)
    return inp, cache


def input_specs(cfg: ArchConfig, shape: ShapeConfig, dtype=torch.bfloat16):
    """Dispatch by shape kind. Returns (inputs,) or (inputs, cache)."""
    if shape.kind == "train":
        return (train_input_specs(cfg, shape, dtype),)
    if shape.kind == "prefill":
        return (prefill_input_specs(cfg, shape, dtype),)
    if shape.kind == "decode":
        return decode_input_specs(cfg, shape, dtype)
    raise ValueError(shape.kind)


def input_pspecs(cfg: ArchConfig, rules: T.ShardRules):
    """Partition specs matching train/prefill input structure."""
    b = rules.batch
    if cfg.input_mode == "embeddings":
        return {"embeds": T.P(b, None, None),
                "positions": T.P(None, b, None), "labels": T.P(b, None)}
    if cfg.n_codebooks > 1:
        return {"tokens": T.P(b, None, None), "labels": T.P(b, None, None)}
    return {"tokens": T.P(b, None), "labels": T.P(b, None)}
