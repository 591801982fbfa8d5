"""All assigned architecture configs (exact published dims) + paper workloads.

Each arch also lives in its own module (``repro_torch.configs.<id>``) per the
required layout; those modules import from here so there is a single source
of truth.
"""
from repro_torch.configs.base import (ArchConfig, MLAConfig, MoEConfig, SSMConfig,
                                register)

# Pure-full-attention archs skip the 524k decode cell (sub-quadratic required).
_FULL_ATTN_SKIP = ("long_500k",)

NEMOTRON_4_340B = register(ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_head=192,
    d_ff=73728, vocab_size=256000,
    ffn_kind="relu2", attn_kind="gqa", pos_kind="rope",
    optimizer="adafactor", skip_shapes=_FULL_ATTN_SKIP,
    notes="GQA kv=8, squared-ReLU FFN [arXiv:2402.16819]",
))

INTERNLM2_1_8B = register(ArchConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=92544,
    ffn_kind="swiglu", attn_kind="gqa", pos_kind="rope", rope_theta=1e6,
    skip_shapes=_FULL_ATTN_SKIP,
    notes="GQA [arXiv:2403.17297]",
))

MINICPM3_4B = register(ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    ffn_kind="swiglu", attn_kind="mla", pos_kind="rope",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
    skip_shapes=_FULL_ATTN_SKIP,
    notes="Multi-head Latent Attention [hf:openbmb/MiniCPM3-4B]",
))

MISTRAL_NEMO_12B = register(ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=131072,
    ffn_kind="swiglu", attn_kind="gqa", pos_kind="rope", rope_theta=1e6,
    skip_shapes=_FULL_ATTN_SKIP,
    notes="128k ctx [hf:mistralai/Mistral-Nemo-Base-2407]",
))

MUSICGEN_MEDIUM = register(ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    ffn_kind="gelu", attn_kind="gqa", pos_kind="rope",
    n_codebooks=4,
    skip_shapes=_FULL_ATTN_SKIP,
    notes=("decoder-only over 4 EnCodec codebooks; frontend stubbed to "
           "codebook token ids [arXiv:2306.05284]"),
))

QWEN2_VL_2B = register(ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
    d_ff=8960, vocab_size=151936,
    ffn_kind="swiglu", attn_kind="gqa", pos_kind="mrope", rope_theta=1e6,
    mrope_sections=(16, 24, 24), input_mode="embeddings",
    skip_shapes=_FULL_ATTN_SKIP,
    notes=("M-RoPE, dynamic resolution; vision frontend stubbed to "
           "precomputed patch embeddings [arXiv:2409.12191]"),
))

MAMBA2_130M = register(ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ffn_kind="none", attn_kind="none", pos_kind="none",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    tie_embeddings=True,
    notes="SSD (state-space duality) [arXiv:2405.21060]; long_500k runs",
))

HYMBA_1_5B = register(ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
    d_ff=5504, vocab_size=32001,
    ffn_kind="swiglu", attn_kind="hybrid", pos_kind="rope",
    sliding_window=2048,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    notes=("parallel attn+mamba heads [arXiv:2411.13676]; SWA + SSM => "
           "sub-quadratic, long_500k runs"),
))

ARCTIC_480B = register(ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=4864, vocab_size=32000,
    ffn_kind="swiglu", attn_kind="gqa", pos_kind="rope",
    moe=MoEConfig(n_experts=128, top_k=2, d_expert=4864, dense_residual=True),
    optimizer="adafactor", skip_shapes=_FULL_ATTN_SKIP,
    notes="128 experts top-2 + parallel dense residual [hf:Snowflake/snowflake-arctic-base]",
))

QWEN3_MOE_235B = register(ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=0, vocab_size=151936,
    ffn_kind="none", attn_kind="gqa", pos_kind="rope", rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536, dense_residual=False),
    optimizer="adafactor", skip_shapes=_FULL_ATTN_SKIP,
    notes="128 experts top-8 [hf:Qwen/Qwen3-30B-A3B scaled family]",
))

# granitemoehybrid: 36 Mamba2 and 4 NoPE GQA layers, each followed by 72
# SwiGLU experts (top-10) and a shared SwiGLU; served as one card's share of
# an 8-way expert-parallel deployment (experts 0-8 of each layer), the rest
# whole.  Not in ALL_ARCHS: the reference's zoo has no counterpart
GRANITE_4_0_H_SMALL = register(ArchConfig(
    name="granite-4.0-h-small", family="hybrid",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=1536, vocab_size=100352,
    ffn_kind="swiglu", attn_kind="pattern", pos_kind="none",
    layer_types=tuple("attention" if i in (5, 15, 25, 35) else "mamba"
                      for i in range(40)),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    moe=MoEConfig(n_experts=72, top_k=10, d_expert=768, dense_residual=True,
                  experts_held=9, dropless=True),
    attention_multiplier=0.0078125, embedding_multiplier=12.0,
    residual_multiplier=0.22, logits_scaling=16.0,
    tie_embeddings=True, skip_shapes=_FULL_ATTN_SKIP,
    notes=("Mamba2 + NoPE GQA by layer, 72 experts top-10 + a shared "
           "expert, muP-style multipliers [hf:ibm-granite/"
           "granite-4.0-h-small]; this card holds experts 0-8 of 72"),
))

ALL_ARCHS = [
    "nemotron-4-340b", "internlm2-1.8b", "minicpm3-4b", "mistral-nemo-12b",
    "musicgen-medium", "qwen2-vl-2b", "mamba2-130m", "hymba-1.5b",
    "arctic-480b", "qwen3-moe-235b-a22b",
]
