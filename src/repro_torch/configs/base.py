"""Configuration system for the repro framework.

Every assigned architecture is expressed as an :class:`ArchConfig`. Configs are
pure data (frozen dataclasses) so they can be hashed into jit caches and
serialized into checkpoints. ``reduced()`` derives the CPU-smoke-test variant
of any config; the full configs are only ever lowered (never allocated) by the
dry-run.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    dense_residual: bool = False  # arctic: parallel dense FFN path
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    # one card's share of an expert-parallel deployment: it holds experts
    # 0 .. experts_held - 1 (0: all of them); the router keeps every
    # expert, and what it sends to an absent one adds nothing here
    experts_held: int = 0
    # capacity = the call's tokens, so no routed token is ever dropped
    dropless: bool = False

    @property
    def held(self) -> int:
        """The experts this layer holds and computes."""
        return self.experts_held or self.n_experts


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD state-space mixer config."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256              # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 => d_model // n_heads
    ffn_kind: str = "swiglu"       # swiglu | relu2 | gelu | none
    attn_kind: str = "gqa"         # gqa | mla | none | hybrid | pattern
    pos_kind: str = "rope"         # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: tuple = (16, 24, 24)   # qwen2-vl (t, h, w) per-head-dim halves
    sliding_window: Optional[int] = None   # hymba local attention
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    n_codebooks: int = 1           # musicgen: 4 parallel EnCodec codebooks
    input_mode: str = "tokens"     # tokens | embeddings (vlm stub frontend)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # granitemoehybrid (granite-4.0-h): attn_kind "pattern" takes each
    # layer's mixer from layer_types, "attention" (GQA at pos_kind's
    # positions) or "mamba" (the Mamba2 mixer), as its config.json names
    # them; every layer is followed by the FFN / MoE
    layer_types: tuple = ()
    # attention's score scale (None: 1/sqrt(head_dim)); the embedding's
    # output times embedding_multiplier; each block's two branch outputs
    # times residual_multiplier before their residual adds; the logits
    # divided by logits_scaling.  The defaults change nothing
    attention_multiplier: Optional[float] = None
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    # training knobs
    optimizer: str = "adamw"       # adamw | adafactor (huge archs)
    remat: bool = True
    # which shapes this arch supports (subset of SHAPES keys)
    skip_shapes: tuple = ()
    notes: str = ""

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    def mixer(self, layer: int) -> str:
        """Layer ``layer``'s mixer as an ``attn_kind``: a pattern's
        "attention" layers ``gqa`` and its "mamba" layers ``none``; every
        layer of any other configuration ``attn_kind``."""
        if self.attn_kind != "pattern":
            return self.attn_kind
        kind = self.layer_types[layer]
        if kind not in _PATTERN_KINDS:
            raise ValueError(f"layer {layer}: no mixer {kind!r}; known: "
                             f"{sorted(_PATTERN_KINDS)}")
        return _PATTERN_KINDS[kind]

    def state_index(self, layer: int) -> int:
        """Where layer ``layer``'s state lies on the leading axis of its
        cache entries: among the layers of its own mixer, in order (the
        layer itself where every layer has one mixer)."""
        if self.attn_kind != "pattern":
            return layer
        kind = self.mixer(layer)
        return sum(self.mixer(i) == kind for i in range(layer))

    def n_mixers(self, *kinds: str) -> int:
        """How many layers have a mixer among ``kinds``."""
        return sum(self.mixer(i) in kinds for i in range(self.n_layers))

    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to 128 so the vocab-sharded embedding/head divide
        evenly on any mesh axis up to 128 (standard production practice:
        pad rows are zero-init and masked out of the loss)."""
        return -(-self.vocab_size // 128) * 128

    @property
    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.n_layers
        n = self.vocab_size * d * self.n_codebooks          # embedding
        if not self.tie_embeddings:
            n += d * self.vocab_size * self.n_codebooks     # lm head
        n += d                                              # final norm
        n += sum(self._block_params(self.mixer(i)) for i in range(L))
        return n

    @property
    def active_param_count(self) -> int:
        """Params active per token (MoE: only routed experts count; of
        held experts, the top_k · held / n_experts a token meets on
        average)."""
        if self.moe is None:
            return self.param_count
        m = self.moe
        per_expert = 3 * self.d_model * m.d_expert
        used = m.top_k * m.held // m.n_experts
        inactive = (m.held - used) * per_expert * self.n_layers
        return self.param_count - inactive

    def _block_params(self, kind: str) -> int:
        """Parameters of one block whose mixer is ``kind`` (an
        ``attn_kind``)."""
        d = self.d_model
        n = 2 * d  # two rms norms
        # --- attention ---
        if kind == "gqa" or kind == "hybrid":
            hd = self.head_dim
            n += d * self.n_heads * hd            # wq
            n += 2 * d * self.n_kv_heads * hd     # wk, wv
            n += self.n_heads * hd * d            # wo
        elif kind == "mla":
            m = self.mla
            qk = m.qk_nope_dim + m.qk_rope_dim
            n += d * m.q_lora_rank + m.q_lora_rank               # wq_a + norm
            n += m.q_lora_rank * self.n_heads * qk               # wq_b
            n += d * (m.kv_lora_rank + m.qk_rope_dim) + m.kv_lora_rank
            n += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            n += self.n_heads * m.v_head_dim * d                 # wo
        # --- ssm (mamba2 / hybrid) ---
        if self.ssm is not None and kind in ("none", "hybrid"):
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            n += d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)  # in_proj
            n += conv_dim * s.d_conv + conv_dim                    # conv + bias
            n += 3 * nh                                            # A_log, D, dt_bias
            n += d_in                                              # gated norm
            n += d_in * d                                          # out_proj
        # --- ffn / moe ---
        mults = {"swiglu": 3, "relu2": 2, "gelu": 2, "none": 0}
        if self.moe is not None:
            n += d * self.moe.n_experts                            # router
            n += self.moe.held * 3 * d * self.moe.d_expert         # swiglu experts
            if self.moe.dense_residual:
                n += mults[self.ffn_kind] * d * self.d_ff
        elif self.d_ff:
            n += mults[self.ffn_kind] * d * self.d_ff
        return n

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=2,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_head=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            name=self.name + "-smoke",
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2), d_expert=32,
                # fewer held than experts, where the full config holds fewer
                experts_held=min(self.moe.experts_held, 2))
        if self.attn_kind == "pattern":
            kw["layer_types"] = ("mamba", "attention")
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=32)
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
            kw["d_head"] = 0
        if self.sliding_window is not None:
            kw["sliding_window"] = 16
        if self.pos_kind == "mrope":
            kw["mrope_sections"] = (2, 3, 3)    # sums to head_dim//2 == 8
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}

_PATTERN_KINDS = {"attention": "gqa", "mamba": "none"}

_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # late import registers everything
        from repro_torch import configs as _c  # noqa: F401
        import importlib
        importlib.import_module("repro_torch.configs.all")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    """The zoo: the architectures of the reference's registry
    (``configs.all.ALL_ARCHS``), each with its dry-run cells.  A served
    configuration the reference has no counterpart of is left out;
    :func:`get_arch` finds it by name."""
    from repro_torch.configs import all as _all
    return sorted(_all.ALL_ARCHS)


def cells(arch: ArchConfig):
    """All (arch, shape) dry-run cells for this arch, with skip annotations."""
    out = []
    for s in SHAPES.values():
        skipped = s.name in arch.skip_shapes
        out.append((s, skipped))
    return out
